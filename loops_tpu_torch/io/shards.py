"""Out-of-core sharded CSR: the papers100M-scale staging tier
(``loops_tpu/io/shards.py``).

At ogbn-papers100M scale (111M nodes, 1.6B edges, 57 GB of f32 features
at F = 128) neither the feature table nor a whole-graph plan fits the
card: plan arrays must never be built for the whole graph. The answer is
**partition-then-plan**:

1. ``ShardedCSR.build`` cuts the graph into P row shards balanced by
   rows + edges (the merge-path diagonal cut of
   ``layout.merge_path.merge_path_partition``, the same cut the kernels
   make inside a matrix) and writes each shard as ``.npy`` files that are
   read back memory-mapped: local offsets, *locally remapped* column ids,
   the shard's sorted distinct global columns (its gather set, from
   ``native.unique_remap``) and values. The files and ``meta.json`` are
   the JAX package's, array for array.
2. Each shard is opened lazily and planned on its own (``plan(p,
   schedule)``): plan arrays exist only for the shard in flight.
3. ``StreamedSpMM`` pads every shard to the store's common shape, so one
   set of device buffers serves all P shards, then streams them one
   after another: the host gathers the shard's feature rows from ``X`` (an
   array or a memmap) into one pinned buffer, the card runs the shard's
   SpMM, and the rows come back into ``out`` (which may be a memmap).

``schedule="merge_path"`` runs K4 (``ops/kernels/spmm_flat.py``, CUDA
``csrc/spmm.cu``), every shard staged with the store-wide
``pad_groups``/``pad_R`` so the staged buffers have one shape;
``"row_mapped"`` a sorted ``torch.segment_reduce`` over the padded shard
(no ``index_add_``). On a CPU device both run their plain versions; a
CUDA request without a card raises.
"""
from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from loops_tpu_torch.formats import CSR
from loops_tpu_torch.formats.base import INDEX_DTYPE
from loops_tpu_torch.layout.merge_path import merge_path_partition
from loops_tpu_torch.utils.platform import ensure_platform

__all__ = ["ShardedCSR", "StreamedSpMM", "merge_path_extent"]

PARTS = ("stage", "gather", "upload", "kernel", "download")


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class ShardedCSR:
    """Directory-backed row-sharded CSR with per-shard gather sets."""

    META = "meta.json"

    def __init__(self, path: str, meta: dict):
        self.path = path
        self.meta = meta
        self.num_shards = int(meta["num_shards"])
        self.shape = tuple(meta["shape"])
        self.row_starts = np.asarray(meta["row_starts"], dtype=np.int64)
        self._cache = {}

    @classmethod
    def build(cls, csr: CSR, num_shards: int, path: str) -> "ShardedCSR":
        """Cut ``csr`` into edge-balanced row shards under ``path``.

        Peak memory is one shard's arrays, not P of them (the input CSR
        itself may be memmap-backed).
        """
        from loops_tpu_torch.native.convert import unique_remap

        os.makedirs(path, exist_ok=True)
        P = int(num_shards)
        t, _ = merge_path_partition(csr.offsets, P)
        row_starts = t.astype(np.int64)
        row_starts[0], row_starts[-1] = 0, csr.shape[0]
        nnzs = []
        for p in range(P):
            r0, r1 = row_starts[p], row_starts[p + 1]
            a0, a1 = int(csr.offsets[r0]), int(csr.offsets[r1])
            nnzs.append(a1 - a0)
            cols = np.asarray(csr.indices[a0:a1])
            # the native O(nnz + n_cols) rank-array remap; numpy's sort
            # where the library is missing
            nat = unique_remap(np.ascontiguousarray(cols, np.int32),
                               csr.shape[1])
            if nat is not None:
                uniq, local = nat
            else:
                uniq, local = np.unique(cols, return_inverse=True)
            np.save(f"{path}/offsets_{p}.npy",
                    (np.asarray(csr.offsets[r0:r1 + 1]) - a0
                     ).astype(INDEX_DTYPE))
            np.save(f"{path}/indices_{p}.npy", local.astype(INDEX_DTYPE))
            np.save(f"{path}/gather_{p}.npy", uniq.astype(INDEX_DTYPE))
            np.save(f"{path}/vals_{p}.npy", np.asarray(csr.vals[a0:a1]))
        meta = dict(num_shards=P, shape=list(csr.shape),
                    row_starts=row_starts.tolist(), nnzs=nnzs,
                    val_dtype=str(csr.vals.dtype))
        with open(f"{path}/{cls.META}", "w") as f:
            json.dump(meta, f)
        return cls(path, meta)

    @classmethod
    def open(cls, path: str) -> "ShardedCSR":
        with open(f"{path}/{cls.META}") as f:
            return cls(path, json.load(f))

    def _load(self, name: str, p: int):
        return np.load(f"{self.path}/{name}_{p}.npy", mmap_mode="r")

    def shard(self, p: int) -> dict:
        """Lazy shard view: local CSR arrays + its gather (halo) set."""
        if p not in self._cache:
            r0, r1 = self.row_starts[p], self.row_starts[p + 1]
            self._cache[p] = dict(
                rows=int(r1 - r0), row0=int(r0),
                offsets=self._load("offsets", p),
                indices=self._load("indices", p),
                gather=self._load("gather", p),
                vals=self._load("vals", p),
            )
        return self._cache[p]

    def shard_csr(self, p: int) -> CSR:
        """Shard p as a CSR over its *local* column space."""
        s = self.shard(p)
        return CSR((s["rows"], len(s["gather"])),
                   np.asarray(s["offsets"]), np.asarray(s["indices"]),
                   np.asarray(s["vals"]))

    def plan(self, p: int, schedule: str = "group_mapped", **kw):
        """Partition-then-plan: plan arrays for one shard only."""
        from loops_tpu_torch.layout import CsrLayout
        from loops_tpu_torch.schedule.plans import make_plan

        return make_plan(CsrLayout.from_csr(self.shard_csr(p)),
                         schedule, **kw)

    @property
    def max_rows(self) -> int:
        return int(np.diff(self.row_starts).max(initial=1))

    @property
    def max_nnz(self) -> int:
        return max(int(n) for n in self.meta["nnzs"]) or 1

    @property
    def max_gather(self) -> int:
        return max((len(self.shard(p)["gather"])
                    for p in range(self.num_shards)), default=1) or 1


def merge_path_extent(offsets, block_work: int) -> tuple:
    """``(groups, R)`` that ``flat_spmm`` records unpadded for
    ``FlatBlockPlan.merge_path`` over ``offsets``, without staging the
    plan: its block count, and the most rows a block's atoms span."""
    offsets = np.asarray(offsets, dtype=np.int64)
    rows, nnz = len(offsets) - 1, int(offsets[-1])
    K = int(block_work)
    nb = max(-(-(rows + nnz) // K), 1)
    if nnz == 0:
        return nb, 1
    t, a = merge_path_partition(offsets, nb, K)
    t, a = t.astype(np.int64), a.astype(np.int64)
    has = a[1:] > a[:-1]
    last_row = np.searchsorted(offsets, a[1:][has] - 1, side="right") - 1
    return nb, int(max((last_row - t[:-1][has]).max(initial=0), 0)) + 1


class StreamedSpMM:
    """``adj @ X`` streamed shard by shard over a ShardedCSR on one device.

    Every shard is padded to the store-wide maxima (rows to
    ``rows_pd``, gathered columns to ``gat_pd``, and for ``merge_path``
    K4's staged blocks to ``groups``), so one set of device buffers
    serves every shard. ``times`` holds, after a call, each part's
    seconds for each shard: ``stage`` (host plan and staging of the
    shard), ``gather`` (host gather of its feature rows into the pinned
    buffer), ``upload`` (staged buffers and features to the device),
    ``kernel`` (the SpMM: CUDA events on a card) and ``download`` (its
    rows back into ``out``).
    """

    def __init__(self, sharded: ShardedCSR, schedule: str = "row_mapped",
                 block_work: int = 512, dtype=None, device="cuda"):
        from loops_tpu_torch.ops.kernels import spmm_flat

        if schedule not in ("row_mapped", "merge_path"):
            raise ValueError(
                "StreamedSpMM supports schedule='row_mapped' or "
                "'merge_path'")
        if dtype not in (None, spmm_flat.BF16):
            raise ValueError(f"dtype={dtype!r}: None (f32) or "
                             f"{spmm_flat.BF16!r}")
        if dtype is not None and schedule == "row_mapped":
            raise ValueError("dtype= is K4's bf16 mode (schedule="
                             "'merge_path'); row_mapped sums in f32")
        self.device = ensure_platform(device)
        self.sharded = sharded
        self.schedule = schedule
        self.block_work = int(block_work)
        self.dtype = dtype
        self.rows_pd = _round_up(sharded.max_rows, 8)
        self.nnz_pd = _round_up(sharded.max_nnz, 128)
        self.gat_pd = _round_up(sharded.max_gather, 8)
        self.groups = self.R = None
        if schedule == "merge_path":
            # host-only first pass: the store-wide staging maxima, from
            # each padded shard's offsets alone
            ext = [merge_path_extent(self._padded_offsets(p), block_work)
                   for p in range(sharded.num_shards)]
            self.groups = max(g for g, _ in ext)
            self.R = max(r for _, r in ext)
            if self.device.type == "cuda":
                from loops_tpu_torch.ops.kernels import _build

                # built here, or the first shard's K4 time holds nvcc's
                _build.load_library()
        self.times = {k: [] for k in PARTS}
        self._bufs = None      # the device buffers every shard reuses
        self._pinned = {}      # F -> (features, rows) host buffers

    def _padded_offsets(self, p: int) -> np.ndarray:
        off = np.asarray(self.sharded.shard(p)["offsets"], dtype=np.int64)
        off_pd = np.full(self.rows_pd + 1, off[-1], dtype=np.int64)
        off_pd[: len(off)] = off
        return off_pd

    def _padded_shard_csr(self, p: int) -> CSR:
        """Shard p over the common (rows_pd, gat_pd) padded space."""
        s = self.sharded.shard(p)
        return CSR((self.rows_pd, self.gat_pd), self._padded_offsets(p),
                   np.asarray(s["indices"]), np.asarray(s["vals"]))

    def stage(self, p: int) -> dict:
        """Shard p's staged host arrays, of one shape for every shard."""
        if self.schedule == "merge_path":
            from loops_tpu_torch.layout import CsrLayout
            from loops_tpu_torch.ops.kernels.spmm_flat import flat_spmm
            from loops_tpu_torch.schedule.plans import FlatBlockPlan

            csr_p = self._padded_shard_csr(p)
            plan = FlatBlockPlan.merge_path(CsrLayout.from_csr(csr_p),
                                            block_work=self.block_work)
            bufs, fn = flat_spmm(csr_p, plan, dtype=self.dtype, device="cpu",
                                 pad_groups=self.groups, pad_R=self.R)
            if (fn.meta["groups"], fn.meta["R"]) != (self.groups, self.R):
                raise RuntimeError(
                    f"shard {p} staged {fn.meta['groups']} blocks, R "
                    f"{fn.meta['R']}, past the store's {self.groups}, "
                    f"{self.R}")
            return bufs
        s = self.sharded.shard(p)
        nnz = len(s["indices"])
        idx = np.zeros(self.nnz_pd, INDEX_DTYPE)
        idx[:nnz] = s["indices"]
        vals = np.zeros(self.nnz_pd, np.float32)
        vals[:nnz] = s["vals"]
        # padding atoms (value 0) are parked on the last row
        lengths = np.zeros(self.rows_pd, np.int64)
        lengths[: s["rows"]] = np.diff(np.asarray(s["offsets"], np.int64))
        lengths[-1] += self.nnz_pd - nnz
        return dict(indices=torch.from_numpy(idx),
                    vals=torch.from_numpy(vals),
                    lengths=torch.from_numpy(lengths))

    def _host_buffers(self, F: int):
        if F not in self._pinned:
            pin = self.device.type == "cuda"
            self._pinned = {F: (
                torch.zeros(self.gat_pd, F, pin_memory=pin),
                torch.empty(self.rows_pd, F, pin_memory=pin))}
        return self._pinned[F]

    def _run(self, b: dict, xg: torch.Tensor) -> torch.Tensor:
        if self.schedule == "merge_path":
            from loops_tpu_torch.ops.kernels.spmm_flat import flat_spmm_apply
            return flat_spmm_apply(b, xg, (self.rows_pd, self.gat_pd),
                                   self.dtype)
        prod = b["vals"][:, None] * torch.index_select(xg, 0, b["indices"])
        return torch.segment_reduce(prod, "sum", lengths=b["lengths"],
                                    axis=0, unsafe=True)

    def __call__(self, X, out=None):
        """``adj @ X`` streamed shard by shard; ``out`` may be a memmap."""
        F = X.shape[1]
        if X.shape[0] != self.sharded.shape[1]:
            raise ValueError(f"X has {X.shape[0]} rows, the graph "
                             f"{self.sharded.shape[1]} columns")
        if out is None:
            out = np.empty((self.sharded.shape[0], F), np.float32)
        cuda = self.device.type == "cuda"
        xg_host, y_host = self._host_buffers(F)
        xg_np, y_np = xg_host.numpy(), y_host.numpy()
        xg = torch.empty(self.gat_pd, F, device=self.device)
        self.times = {k: [] for k in PARTS}
        clock = [time.perf_counter()]

        def lap(part):
            if cuda:
                torch.cuda.synchronize(self.device)
            now = time.perf_counter()
            self.times[part].append(now - clock[0])
            clock[0] = now

        for p in range(self.sharded.num_shards):
            staged = self.stage(p)
            s = self.sharded.shard(p)
            lap("stage")
            gather = np.asarray(s["gather"])
            n = len(gather)
            if X.dtype == np.float32:
                np.take(X, gather, axis=0, out=xg_np[:n])
            else:
                xg_np[:n] = X[gather]
            xg_np[n:] = 0.0
            lap("gather")
            if self._bufs is None:
                self._bufs = {k: torch.empty_like(v, device=self.device)
                              for k, v in staged.items()}
            for k, v in staged.items():
                self._bufs[k].copy_(v, non_blocking=True)
            xg.copy_(xg_host, non_blocking=True)
            lap("upload")
            if cuda:
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
            y = self._run(self._bufs, xg)
            if cuda:
                ev[1].record()
            lap("kernel")
            if cuda:
                self.times["kernel"][-1] = ev[0].elapsed_time(ev[1]) / 1e3
            rows = s["rows"]
            y_host[:rows].copy_(y[:rows])
            out[s["row0"]: s["row0"] + rows] = y_np[:rows]
            lap("download")
        return out
