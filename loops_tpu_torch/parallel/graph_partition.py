"""Edge-balanced graph partitioning for multi-device execution.

The port of ``loops_tpu/parallel/graph_partition.py``, array for array.
A CSR adjacency is cut into P contiguous row (destination-node) ranges
balanced by **rows + edges**: the merge-path diagonal cut
(``layout.merge_path``) that the kernels make across their blocks, made
here across ranks.

Each partition gets static-shape local arrays (rows and nnz padded to the
per-rank maxima), stacked along a leading axis P: every rank builds the
same plan from the same inputs and stages only its own slice ``[p]``.
Column indices stay global; the distributed ops combine them with an
all-gathered (or halo-exchanged) feature table.

The plan also gives **halo statistics**: for each rank, which remote
nodes its edges touch, the input of the targeted exchange
(``parallel/halo.py``).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from loops_tpu_torch.formats import CSR
from loops_tpu_torch.formats.base import INDEX_DTYPE
from loops_tpu_torch.layout.merge_path import merge_path_partition


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclass
class EdgePartition:
    num_devices: int
    num_nodes: int
    row_starts: np.ndarray      # [P+1] global row range per rank
    rows_per_dev: int           # padded local row count
    nnz_per_dev: int            # padded local nnz
    # stacked arrays (leading axis P):
    offsets: np.ndarray         # [P, rows_per_dev+1] local row offsets
    indices: np.ndarray         # [P, nnz_per_dev] global col ids (0-pad)
    vals: np.ndarray            # [P, nnz_per_dev] (0-pad)
    row_valid: np.ndarray       # [P, rows_per_dev] bool

    @classmethod
    def build(cls, csr: CSR, num_devices: int,
              pad_rows_to: int = 8) -> "EdgePartition":
        P = int(num_devices)
        t, _ = merge_path_partition(csr.offsets, P)
        row_starts = t.astype(np.int64)
        row_starts[0], row_starts[-1] = 0, csr.shape[0]
        counts = np.diff(row_starts)
        nnzs = (csr.offsets[row_starts[1:]] -
                csr.offsets[row_starts[:-1]]).astype(np.int64)
        rows_pd = _round_up(max(int(counts.max(initial=1)), 1), pad_rows_to)
        nnz_pd = max(int(nnzs.max(initial=1)), 1)

        offsets = np.zeros((P, rows_pd + 1), dtype=INDEX_DTYPE)
        indices = np.zeros((P, nnz_pd), dtype=INDEX_DTYPE)
        vals = np.zeros((P, nnz_pd), dtype=csr.vals.dtype)
        row_valid = np.zeros((P, rows_pd), dtype=bool)
        for p in range(P):
            r0, r1 = row_starts[p], row_starts[p + 1]
            a0, a1 = csr.offsets[r0], csr.offsets[r1]
            local_off = csr.offsets[r0:r1 + 1] - a0
            offsets[p, : r1 - r0 + 1] = local_off
            offsets[p, r1 - r0 + 1:] = local_off[-1]
            indices[p, : a1 - a0] = csr.indices[a0:a1]
            vals[p, : a1 - a0] = csr.vals[a0:a1]
            row_valid[p, : r1 - r0] = True
        return cls(P, csr.shape[0], row_starts.astype(INDEX_DTYPE),
                   rows_pd, nnz_pd, offsets, indices, vals, row_valid)

    @classmethod
    def from_shards(cls, sharded, chips_per_shard: int,
                    pad_rows_to: int = 8) -> "EdgePartition":
        """The partition of an out-of-core ``io.shards.ShardedCSR``
        without a global CSR in memory: shard h (one host's slice) is
        read from its memmapped files, merge-path-cut across the host's
        ``chips_per_shard`` ranks, and released before the next one. Use
        it with ``make_mesh_hier(sharded.num_shards, chips_per_shard)``
        and ``HierHaloPlan`` so the shard boundaries fall on the host
        axis."""
        hosts = int(sharded.num_shards)
        C = int(chips_per_shard)
        P = hosts * C

        # pass 1: row cuts per shard (chip subdivision) + maxima
        row_starts = np.zeros(P + 1, dtype=np.int64)
        dev_rows = np.zeros(P, dtype=np.int64)
        dev_nnzs = np.zeros(P, dtype=np.int64)
        shard_starts = sharded.row_starts.astype(np.int64)
        cuts_per_shard = []
        for h in range(hosts):
            sh = sharded.shard(h)
            offs = np.asarray(sh["offsets"], dtype=np.int64)
            t, _ = merge_path_partition(offs, C)
            t = t.astype(np.int64)
            t[0], t[-1] = 0, len(offs) - 1
            cuts_per_shard.append(t)
            for c in range(C):
                p = h * C + c
                row_starts[p] = shard_starts[h] + t[c]
                dev_rows[p] = t[c + 1] - t[c]
                dev_nnzs[p] = offs[t[c + 1]] - offs[t[c]]
        row_starts[P] = shard_starts[hosts]
        rows_pd = _round_up(max(int(dev_rows.max(initial=1)), 1),
                            pad_rows_to)
        nnz_pd = max(int(dev_nnzs.max(initial=1)), 1)

        offsets = np.zeros((P, rows_pd + 1), dtype=INDEX_DTYPE)
        indices = np.zeros((P, nnz_pd), dtype=INDEX_DTYPE)
        vals = np.zeros((P, nnz_pd), dtype=np.float32)
        row_valid = np.zeros((P, rows_pd), dtype=bool)
        # pass 2: per-shard staging (one shard resident at a time)
        for h in range(hosts):
            sh = sharded.shard(h)
            offs = np.asarray(sh["offsets"], dtype=np.int64)
            gather = np.asarray(sh["gather"])
            t = cuts_per_shard[h]
            for c in range(C):
                p = h * C + c
                r0, r1 = int(t[c]), int(t[c + 1])
                a0, a1 = int(offs[r0]), int(offs[r1])
                local_off = offs[r0:r1 + 1] - a0
                offsets[p, : r1 - r0 + 1] = local_off
                offsets[p, r1 - r0 + 1:] = local_off[-1]
                # shard cols are locally remapped; lift to global ids
                indices[p, : a1 - a0] = gather[
                    np.asarray(sh["indices"][a0:a1])]
                vals[p, : a1 - a0] = np.asarray(sh["vals"][a0:a1])
                row_valid[p, : r1 - r0] = True
        return cls(P, int(shard_starts[hosts]),
                   row_starts.astype(INDEX_DTYPE), rows_pd, nnz_pd,
                   offsets, indices, vals, row_valid)

    # ---------------------------------------------------------- halo info
    def owner_of(self, nodes: np.ndarray) -> np.ndarray:
        """Owning rank of each (destination-partitioned) node id."""
        return (np.searchsorted(self.row_starts, nodes, side="right") - 1
                ).astype(INDEX_DTYPE)

    def halo_stats(self) -> dict:
        """Per-rank remote-touch statistics: how many distinct nodes each
        rank's edges reference, per owning rank (the communication matrix
        the targeted exchange works from)."""
        P = self.num_devices
        comm = np.zeros((P, P), dtype=np.int64)
        halo_nodes = []
        for p in range(P):
            nnz = int(self.offsets[p, -1])
            touched = np.unique(self.indices[p, :nnz])
            owners = self.owner_of(touched)
            remote = touched[owners != p]
            halo_nodes.append(remote)
            for q, cnt in zip(*np.unique(owners, return_counts=True)):
                comm[p, q] = cnt
        return {"comm_matrix": comm, "halo_nodes": halo_nodes,
                "max_halo": max((len(h) for h in halo_nodes), default=0)}

    # ------------------------------------------- padded coordinate space
    def global_to_padded(self, ids: np.ndarray) -> np.ndarray:
        """Global node ids in the padded stacked space
        ``p * rows_per_dev + local``, the rows of an all-gathered
        [P*rows_per_dev, F] feature table."""
        owners = self.owner_of(ids)
        return (owners.astype(np.int64) * self.rows_per_dev
                + (ids - self.row_starts[owners])).astype(INDEX_DTYPE)

    @property
    def indices_padded(self) -> np.ndarray:
        """[P, nnz_per_dev] column ids in padded coordinates (cached)."""
        cached = getattr(self, "_indices_padded", None)
        if cached is None:
            cached = self.global_to_padded(self.indices.ravel()).reshape(
                self.indices.shape)
            self._indices_padded = cached
        return cached

    def pad_features(self, X: np.ndarray) -> np.ndarray:
        """[num_nodes, F] -> stacked [P, rows_per_dev, F] (zero-padded)."""
        F = X.shape[1]
        out = np.zeros((self.num_devices, self.rows_per_dev, F), X.dtype)
        for p in range(self.num_devices):
            r0, r1 = self.row_starts[p], self.row_starts[p + 1]
            out[p, : r1 - r0] = X[r0:r1]
        return out

    def local_features(self, X: np.ndarray, p: int) -> np.ndarray:
        """Rank ``p``'s [rows_per_dev, ...] slice of ``pad_features(X)``
        for an [N, ...] array (features, labels, a mask), zero-padded;
        of ``X`` it reads rank p's rows only (a memmap stays on disk)."""
        r0, r1 = int(self.row_starts[p]), int(self.row_starts[p + 1])
        out = np.zeros((self.rows_per_dev,) + X.shape[1:], X.dtype)
        out[: r1 - r0] = X[r0:r1]
        return out

    # ------------------------------------------------- reconstruction
    def unpad_output(self, stacked: np.ndarray) -> np.ndarray:
        """[P, rows_per_dev, ...] rank outputs -> [num_nodes, ...]."""
        parts = []
        for p in range(self.num_devices):
            n = int(self.row_starts[p + 1] - self.row_starts[p])
            parts.append(stacked[p, :n])
        return np.concatenate(parts, axis=0)

    def local_csr(self, p: int, cols: np.ndarray, width: int) -> CSR:
        """Rank ``p``'s [rows_per_dev, width] CSR of its live edges, with
        column ids ``cols`` ([P, nnz_per_dev], in the rank's own column
        space): the padding past its nnz is dropped, not stored."""
        nnz = int(self.offsets[p, -1])
        return CSR((self.rows_per_dev, width), self.offsets[p],
                   cols[p, :nnz], self.vals[p, :nnz])
