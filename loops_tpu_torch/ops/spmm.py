"""SpMM — sparse matrix x dense matrix, CSR: the GNN aggregation primitive.

The port of ``loops_tpu/ops/spmm.py`` for CSR. Schedule -> execution:

* ``row_mapped`` (and ``merge_path``/``work_oriented`` with
  ``impl='xla'``, which ``loops_tpu`` lowers to the same path) —
  gather-multiply-segment: ``C = segsum(vals * B[cols])``, a sorted segment
  reduction over the CSR offsets (``torch.segment_reduce``: each row is
  summed in order, so it is deterministic on the card, where
  ``index_add_``'s float atomics are not).
* ``group_mapped`` — the degree-class planes: a dense masked
  [rows_b, pitch_b, F] reduction per bucket, stored to its rows, with the
  hub-dense split: rows of at least ``hub_dense_min`` nonzeros (default
  ``max(cols // 16, 1024)``) become dense rows and one ``torch.matmul``
  with B (in f32; PyTorch leaves TF32 off for it by default).
* ``merge_path`` with ``impl='pallas'`` — kernel K4
  (``ops/kernels/spmm_flat.py``, ``csrc/spmm.cu``).
* ``auto`` — ``choose_schedule``'s pick, mapped as ``loops_tpu`` maps it:
  the skew and sorted picks to ``group_mapped``, the rest to
  ``row_mapped``.

``dtype="bfloat16"`` on every path: vals and B rounded to bf16, each
product rounded to bf16, sums in f32, output f32; the hub-dense product
stays f32, as in ``loops_tpu``.

K4 runs when the operator lives on a CUDA device; on the CPU its wrapper
takes the plain PyTorch version. float64 values with ``impl='pallas'``
raise ``ValueError`` on a CUDA device (K4 stages f32) and, on the CPU,
warn and take the torch path, as ``loops_tpu`` does. ``impl_used`` names
the path the build took and ``launches`` counts this operator's kernel
launches. COO, ELL and BCSR raise ``NotImplementedError`` naming their
ROADMAP item.
"""
from __future__ import annotations

import time
import warnings

import numpy as np
import torch

from loops_tpu_torch.formats import CSR
from loops_tpu_torch.layout import CsrLayout
from loops_tpu_torch.ops.kernels import _build, spmm_flat
from loops_tpu_torch.ops.kernels.spmm_flat import BF16, products
from loops_tpu_torch.schedule.plans import SCHEDULES, choose_schedule, make_plan
from loops_tpu_torch.tuning.launch_box import launch_params
from loops_tpu_torch.utils.platform import ensure_platform

__all__ = ["spmm", "SpMMOperator"]

_NOT_PORTED = {"COO": "A8", "ELL": "A8", "BCSR": "A6/A8"}


def _dtype_mode(dtype):
    if dtype not in (None, BF16):
        raise ValueError(f"SpMM dtype={dtype!r}: expected None or "
                         f"{BF16!r}")
    return dtype


class SpMMOperator:
    """An SpMM bound to one CSR matrix on one device: ``op(B) -> C``.

    Plan once on the host, execute many times; ``C`` is float32 for f32
    or bf16 mode (float64 for float64 values on the torch paths).
    """

    def __init__(self, mat, schedule: str = "row_mapped",
                 impl: str = "xla", block_f: int | None = None, dtype=None,
                 hub_dense_min: int | None = None, block: int = 512,
                 device="cpu"):
        if not isinstance(mat, CSR):
            name = type(mat).__name__
            raise NotImplementedError(
                f"{name} SpMM is not ported to loops_tpu_torch yet (ROADMAP "
                f"{_NOT_PORTED.get(name, 'A6/A8')})")
        if schedule not in SCHEDULES + ("auto",):
            raise ValueError(f"unknown schedule {schedule!r}; expected one "
                             f"of {SCHEDULES + ('auto',)}")
        if impl not in ("xla", "pallas"):
            raise ValueError(f"csr SpMM implements impl 'xla' or 'pallas', "
                             f"got {impl!r}")
        self.device = ensure_platform(device)
        self.mat = mat
        self.rows, self.cols = mat.shape
        self.schedule = schedule
        self.impl = impl
        self.block = block
        self.block_f = (launch_params(self.device).spmm_block_f
                        if block_f is None else block_f)
        self.dtype = _dtype_mode(dtype)
        self.hub_dense_min = hub_dense_min
        self._vals_dtype = torch.from_numpy(mat.vals[:0]).dtype
        # "torch" for the torch-op executors, else the kernel's name
        self.impl_used = "torch"
        self.launches = 0
        self.meta = {}
        self._bufs, self._raw = self._build_csr(mat, schedule, impl)
        self._kernel = (self.impl_used if self.impl_used in _build.LAUNCHES
                        else None)
        self.meta.update(getattr(self._raw, "meta", {}) or {})

    def stage(self, B) -> torch.Tensor:
        """``B`` as a contiguous [cols, F] tensor of the matrix's value
        type on the operator's device (a no-op when already staged)."""
        if not isinstance(B, torch.Tensor):
            B = torch.from_numpy(np.asarray(B))
        if B.dim() != 2 or B.shape[0] != self.cols:
            raise ValueError(f"B has shape {tuple(B.shape)}, expected "
                             f"[{self.cols}, F]")
        return B.to(self.device, self._vals_dtype).contiguous()

    def __call__(self, B):
        B = self.stage(B)
        if self._kernel is None:
            return self._raw(self._bufs, B)
        before = _build.LAUNCHES[self._kernel]
        C = self._raw(self._bufs, B)
        self.launches += _build.LAUNCHES[self._kernel] - before
        return C

    def _to(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # ------------------------------------------------------------- CSR
    def _build_csr(self, csr: CSR, schedule, impl):
        if schedule == "auto":
            pick = choose_schedule(CsrLayout.from_csr(csr))
            # SpMM has no sorted_flat analog; the skew/sorted picks map to
            # the degree-class planes, the rest to the gather-segment path
            schedule = self.schedule = (
                "group_mapped" if pick in ("group_mapped", "sorted_flat")
                else "row_mapped")
        if impl == "pallas" and schedule != "merge_path":
            raise ValueError(
                "csr SpMM implements impl='pallas' only with "
                f"schedule='merge_path'; got schedule={schedule!r}")
        if impl == "pallas" and np.dtype(csr.vals.dtype) == np.float64:
            reason = ("impl='pallas' stages float32 (K4), and the values "
                      "are float64")
            if self.device.type == "cuda":
                raise ValueError(f"{reason}; pass impl='xla' for the torch "
                                 "path")
            warnings.warn(f"{reason}; falling back to the torch path",
                          stacklevel=3)
            impl = "xla"
        if schedule == "group_mapped":
            return self._group_mapped(csr)
        if impl == "pallas":
            t0 = time.perf_counter()
            plan = make_plan(CsrLayout.from_csr(csr), "merge_path",
                             block_work=self.block)
            self.meta["plan_ms"] = (time.perf_counter() - t0) * 1e3
            self.impl_used = "flat_spmm"
            return spmm_flat.flat_spmm(csr, plan, block_f=self.block_f,
                                       dtype=self.dtype, device=self.device)
        return self._row_segments(csr)

    def _row_segments(self, csr: CSR):
        """Gather-multiply-segment: one sorted segment sum per row."""
        bufs = dict(vals=self._to(csr.vals), cols=self._to(csr.indices).long(),
                    offsets=self._to(csr.offsets.astype(np.int64)))
        dtype = self.dtype

        def fn(b, B):
            prod = products(b["vals"], B, b["cols"], dtype)
            return torch.segment_reduce(prod, "sum", offsets=b["offsets"],
                                        axis=0, unsafe=True)
        return bufs, fn

    def _group_mapped(self, csr: CSR):
        """Degree-class planes with the hub-dense split."""
        rows, cols = self.rows, self.cols
        plan = make_plan(CsrLayout.from_csr(csr), "group_mapped")
        hub_min = (self.hub_dense_min if self.hub_dense_min is not None
                   else max(cols // 16, 1024))
        hub_tiles, plane_buckets = [], []
        budget = 64 << 20  # cap the dense payload at 64M elements
        for bk in plan.buckets:
            pitch = bk["atom_slots"].shape[1]
            h = len(bk["tiles"])
            if pitch >= hub_min and (len(hub_tiles) + h) * cols <= budget:
                hub_tiles.extend(bk["tiles"].tolist())
            else:
                plane_buckets.append(bk)
        bufs = dict(buckets=[
            (self._to(bk["tiles"]).long(),
             self._to(csr.indices[bk["atom_slots"]]).long(),
             self._to(np.where(bk["valid"], csr.vals[bk["atom_slots"]],
                               0).astype(csr.vals.dtype)))
            for bk in plane_buckets])
        if hub_tiles:
            hub_tiles = np.asarray(hub_tiles, dtype=np.int64)
            dense = np.zeros((len(hub_tiles), cols), csr.vals.dtype)
            for i, t in enumerate(hub_tiles):
                a0, a1 = csr.offsets[t], csr.offsets[t + 1]
                dense[i, csr.indices[a0:a1]] = csr.vals[a0:a1]
            bufs["hub_tiles"] = self._to(hub_tiles)
            bufs["hub_rows"] = self._to(dense)
        dtype = self.dtype
        out_dtype = torch.float32 if dtype else self._vals_dtype

        def fn(b, B):
            C = torch.zeros(rows, B.shape[1], dtype=out_dtype,
                            device=B.device)
            for tiles, idx, v in b["buckets"]:
                n, pitch = idx.shape
                s = products(v.reshape(-1), B, idx.reshape(-1), dtype)
                # each row sits in exactly one bucket: a plain store
                C[tiles] = s.reshape(n, pitch, -1).sum(dim=1).to(out_dtype)
            if "hub_rows" in b:
                C[b["hub_tiles"]] = torch.matmul(b["hub_rows"], B).to(
                    out_dtype)
            return C
        return bufs, fn


def _op_cache(mat) -> dict:
    cache = getattr(mat, "_spmm_ops", None)
    if cache is None:
        cache = {}
        object.__setattr__(mat, "_spmm_ops", cache)
    return cache


def spmm(mat, B, schedule: str = "row_mapped", impl: str = "xla",
         block_f: int | None = None, dtype=None, block: int = 512,
         device="cpu"):
    """One-shot SpMM with operator caching on the container."""
    key = (schedule, impl, block_f, str(dtype), block,
           str(torch.device(device)))
    cache = _op_cache(mat)
    if key not in cache:
        cache[key] = SpMMOperator(mat, schedule, impl, block_f, dtype,
                                  block=block, device=device)
    return cache[key](B)
