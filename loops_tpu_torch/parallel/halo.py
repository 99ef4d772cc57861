"""Targeted halo exchange: an all-to-all of the boundary features only.

The port of ``loops_tpu/parallel/halo.py``; the plan is the JAX
package's, array for array. The all-gather of ``parallel/dist_ops.py``
moves the whole N x F feature table to every rank each layer: simple,
and O(N) per rank. The scalable protocol exchanges only **halo nodes**,
the features a rank's edges reference remotely.

The graph is static, so the whole exchange is planned on the host:

  * ``send_idx[q, p, :]``: the *owner-local* rows rank q ships to rank p;
    the runtime is then one gather, one ``all_to_all`` and one concat;
  * column indices are remapped at plan time into each rank's
    ``[local rows | halo slots]`` column space, so the local reduction is
    the single-device SpMM: the halo is just more rows.

Per-layer volume drops from N*F to P*H*F (H = the largest pairwise halo).

``DistSpMMHalo`` runs rank p's part: the send package goes through
``ops/segment.Gather`` (its backward a sorted segment sum), the exchange
is one ``all_to_all_single`` of the [P*H, F] package, and the local
reduction is an ``SpMMOperator`` over the rank's own CSR (K4 on a card,
its plain version on the CPU) with the transposed-plan backward of
``models/message_passing.py``. No ``index_add_``, no float atomics.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from loops_tpu_torch.formats import CSR
from loops_tpu_torch.formats.base import INDEX_DTYPE
from loops_tpu_torch.ops.segment import Gather
from loops_tpu_torch.parallel.graph_partition import EdgePartition
from loops_tpu_torch.parallel.mesh import (
    all_to_all,
    all_to_all_start,
    axis_group,
    axis_rank,
    axis_size,
    mesh_device,
)


class RemoteRefs(NamedTuple):
    """Every rank's live edges, flattened in rank order, and the unique
    remote references among them: the step both halo plans share."""
    live: np.ndarray    # [P, nnz_pd] bool: entry is a live edge
    cols: np.ndarray    # flat global column of each live edge
    owners: np.ndarray  # flat owning rank of each live edge's column
    remote: np.ndarray  # flat bool: the column lives on another rank
    inv: np.ndarray     # remote edge -> its unique (rank, col) reference
    up: np.ndarray      # unique reference: the rank that needs it
    ucol: np.ndarray    # unique reference: the global row it reads
    uq: np.ndarray      # unique reference: the rank that owns the row

    def remap(self, part: EdgePartition, remote_cols: np.ndarray):
        """``[P, nnz_pd]`` edge columns in a rank's ``[local | halo]``
        space: a local column ``c`` of rank p becomes
        ``c - row_starts[p]``, remote edges take ``remote_cols``."""
        out = np.where(self.remote, 0, self.cols
                       - part.row_starts[self.owners]).astype(np.int64)
        out[self.remote] = remote_cols
        indices_local = np.zeros_like(part.indices)
        indices_local[self.live] = out
        return indices_local


def remote_refs(part: EdgePartition) -> RemoteRefs:
    """The unique ``(rank, global col)`` pairs among every rank's remote
    references, sorted by ``(p, col)`` (int64 keys ``p * N + col``), so
    that each ``(p, owner)`` group is contiguous: ownership ranges are
    contiguous in col."""
    P = part.num_devices
    N = int(part.num_nodes)
    nnzs = part.offsets[:, -1].astype(np.int64)            # [P]
    dev = np.repeat(np.arange(P, dtype=np.int64), nnzs)
    pos = np.arange(part.indices.shape[1], dtype=np.int64)
    live = pos[None, :] < nnzs[:, None]                    # [P, E]
    cols = part.indices[live].astype(np.int64)             # flat, by p
    owners = part.owner_of(cols).astype(np.int64)
    remote = owners != dev
    ukey, inv = np.unique(dev[remote] * N + cols[remote],
                          return_inverse=True)
    ucol = ukey % N
    return RemoteRefs(live, cols, owners, remote, inv, ukey // N, ucol,
                      part.owner_of(ucol).astype(np.int64))


@dataclass
class HaloPlan:
    part: EdgePartition
    H: int                    # padded per-pair halo size
    send_idx: np.ndarray      # [P, P, H] owner-local rows: [q, p] = q->p
    send_valid: np.ndarray    # [P, P, H] bool
    indices_local: np.ndarray  # [P, nnz_pd] edge cols in local+halo space

    # -------------------------------------------- interior/boundary split
    def split_edges(self):
        """Split each rank's edges into interior (local columns) and
        boundary (halo columns) sets with separate padded arrays: the
        structure that lets the exchange overlap the interior reduction.

        Returns a dict of [P, E_int/E_bnd] arrays: int_vals, int_cols,
        int_rows, bnd_vals, bnd_cols (halo-space), bnd_rows; padded
        entries have row ``rows_per_dev`` (a dropped segment).
        """
        part = self.part
        P = part.num_devices
        R = part.rows_per_dev
        per_int, per_bnd = [], []
        for p in range(P):
            nnz = int(part.offsets[p, -1])
            cols = self.indices_local[p, :nnz]
            rows = np.searchsorted(part.offsets[p, 1:-1],
                                   np.arange(nnz), side="right")
            interior = cols < R
            per_int.append((part.vals[p, :nnz][interior], cols[interior],
                            rows[interior]))
            b = ~interior
            per_bnd.append((part.vals[p, :nnz][b], cols[b] - R, rows[b]))
        E_int = max(max((len(v) for v, _, _ in per_int), default=1), 1)
        E_bnd = max(max((len(v) for v, _, _ in per_bnd), default=1), 1)

        def stack(per, E):
            vals = np.zeros((P, E), np.float32)
            cols = np.zeros((P, E), INDEX_DTYPE)
            rows = np.full((P, E), R, INDEX_DTYPE)  # pad -> dropped seg
            for p, (v, c, r) in enumerate(per):
                vals[p, : len(v)] = v
                cols[p, : len(v)] = c
                rows[p, : len(v)] = r
            return vals, cols, rows

        iv, ic, ir = stack(per_int, E_int)
        bv, bc, br = stack(per_bnd, E_bnd)
        return dict(int_vals=iv, int_cols=ic, int_rows=ir,
                    bnd_vals=bv, bnd_cols=bc, bnd_rows=br)

    @classmethod
    def build(cls, part: EdgePartition) -> "HaloPlan":
        """Vectorized plan build: one global sort instead of P^2 Python
        loops with per-rank np.unique, O(E log E) in all, so P = 64-256
        costs what P = 8 does."""
        P = part.num_devices
        R = part.rows_per_dev
        refs = remote_refs(part)
        inv, up, ucol, uq = refs.inv, refs.up, refs.ucol, refs.uq

        # group (p, q) boundaries and within-group slots
        gkey = up * P + uq
        new_group = np.r_[True, np.diff(gkey) != 0]
        gstart = np.flatnonzero(new_group)
        gid = np.cumsum(new_group) - 1
        slot = np.arange(len(up)) - gstart[gid]
        gsizes = np.diff(np.r_[gstart, len(up)])
        H = max(int(gsizes.max(initial=1)), 1)

        send_idx = np.zeros((P, P, H), dtype=INDEX_DTYPE)
        send_valid = np.zeros((P, P, H), dtype=bool)
        send_idx[uq, up, slot] = ucol - part.row_starts[uq]
        send_valid[uq, up, slot] = True

        # remap edge columns into [local | halo] space:
        #   local col c (owner p):            c - row_starts[p]
        #   remote col c (owner q, slot s):   R + q*H + s
        indices_local = refs.remap(part, R + uq[inv] * H + slot[inv])
        return cls(part, H, send_idx, send_valid, indices_local)


def edges_csr(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
              num_rows: int, width: int) -> CSR:
    """The [num_rows, width] CSR of padded row-sorted edge arrays
    (``split_edges``' form): entries of row ``num_rows`` are padding and
    are dropped."""
    keep = rows < num_rows
    rows, cols, vals = rows[keep], cols[keep], vals[keep]
    if np.any(np.diff(rows) < 0):
        raise ValueError("edge rows must be sorted")
    offsets = np.zeros(num_rows + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=num_rows), out=offsets[1:])
    return CSR((num_rows, width), offsets, cols, vals)


def local_operator(csr: CSR, device):
    """The differentiable local reduction ``h -> csr @ h`` of a rank: K4
    (``merge_path``/``pallas``), its plain version on the CPU, with the
    transposed-plan backward."""
    from loops_tpu_torch.models.message_passing import propagate_operator

    return propagate_operator(csr, "merge_path", "pallas", device=device)


def send_gather(idx: np.ndarray, valid: np.ndarray, num_rows: int, device):
    """``h -> h[idx] * valid`` over flattened package slots, with a
    sorted segment-sum backward that only the valid slots feed."""
    idx, valid = idx.reshape(-1), valid.reshape(-1)
    gather = Gather(idx, num_rows, device, keep=valid)
    mask = torch.from_numpy(valid.astype(np.float32))[:, None].to(device)
    return lambda h: gather(h) * mask


def as_rows(h, device) -> torch.Tensor:
    """A rank's [rows, F] features as a float32 tensor on ``device``."""
    if not isinstance(h, torch.Tensor):
        h = torch.from_numpy(np.asarray(h))
    return h.to(device, torch.float32)


class DistSpMMHalo:
    """Distributed SpMM with the targeted halo exchange, rank p's part.

    ``op(h) : [rows_per_dev, F] -> [rows_per_dev, F]`` on every rank of
    the mesh's ``graph`` axis, the rank's slice of the stacked interface
    of ``loops_tpu``. ``overlap=True`` splits the edges into interior
    (local columns) and boundary (halo columns) at plan time: the
    exchange is started asynchronously, the interior reduction runs, and
    the boundary reduction waits for the exchange; a rank with no
    boundary edge returns the interior result as it is.
    """

    def __init__(self, plan: HaloPlan, mesh, overlap: bool = False):
        self.plan = plan
        self.mesh = mesh
        self.overlap = overlap
        part = plan.part
        P, R, H = part.num_devices, part.rows_per_dev, plan.H
        if axis_size(mesh, "graph") != P:
            raise ValueError(f"the plan has {P} partitions, the mesh's "
                             f"graph axis {axis_size(mesh, 'graph')} ranks")
        self.device = mesh_device(mesh)
        self.group = axis_group(mesh, "graph")
        self.p = p = axis_rank(mesh, "graph")
        self.send = send_gather(plan.send_idx[p], plan.send_valid[p], R,
                                self.device)
        if overlap:
            s = plan.split_edges()
            self.interior = local_operator(edges_csr(
                s["int_rows"][p], s["int_cols"][p], s["int_vals"][p], R, R),
                self.device)
            bnd = edges_csr(s["bnd_rows"][p], s["bnd_cols"][p],
                            s["bnd_vals"][p], R, P * H)
            self.boundary = local_operator(bnd, self.device)
            self.boundary_empty = bnd.nnz == 0
            self.operators = [self.interior, self.boundary]
        else:
            self.local = local_operator(
                part.local_csr(p, plan.indices_local, R + P * H),
                self.device)
            self.operators = [self.local]

    def __call__(self, h) -> torch.Tensor:
        h = as_rows(h, self.device)
        package = self.send(h)
        if not self.overlap:
            halo = all_to_all(package, self.group)
            return self.local._fn(torch.cat([h, halo]))
        halo, work = all_to_all_start(package, self.group)
        interior = self.interior._fn(h)
        work.wait()
        if self.boundary_empty:
            return _Tied.apply(interior, halo)
        return interior + self.boundary._fn(halo)


class _Tied(torch.autograd.Function):
    """``out``, with ``halo`` kept in the autograd graph (its gradient
    zero): a rank whose edges read no halo row skips the boundary
    reduction, and its backward still issues the exchange's all-to-all,
    as every other rank's does."""

    @staticmethod
    def forward(ctx, out, halo):
        ctx.halo = (halo.shape, halo.dtype, halo.device)
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device = ctx.halo
        return g, torch.zeros(shape, dtype=dtype, device=device)
