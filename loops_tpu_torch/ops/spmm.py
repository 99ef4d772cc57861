"""SpMM — sparse matrix x dense matrix: the GNN aggregation primitive and
the block-sparse product.

The port of ``loops_tpu/ops/spmm.py``. CSR, schedule -> execution:

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
* ``auto`` — on a card with a fitted route (``schedule/plans.py``
  ``CARD_SPMM_ROUTES``) the route's pick and impl (K4, the planes or the
  row segments); elsewhere ``choose_schedule``'s pick, mapped as
  ``loops_tpu`` maps it: the skew and sorted picks to ``group_mapped``,
  the rest to ``row_mapped``.

CSR ``dtype="bfloat16"`` on every path: vals and B rounded to bf16, each
product rounded to bf16, sums in f32, output f32; the hub-dense product
stays f32, as in ``loops_tpu``.

BCSR (schedule ``row_mapped``; ``auto`` resolves to it), impl ->
execution:

* ``xla``     — each stored block times its B tile (a batched product),
  then a sorted segment sum over the block rows;
* ``pallas``  — kernel K9 (``ops/kernels/spmm_bcsr.py``), f32;
* ``pallas2`` — kernel K8 (``ops/kernels/spmm_bcsr_v2.py``);
* ``pallas3`` — kernel K7 (``ops/kernels/spmm_bcsr_v3.py``), the bench's.

BCSR ``dtype="bfloat16"`` takes ``pallas2``/``pallas3`` only: A and B
rounded to bf16, products and sums in f32 (``loops_tpu`` computes f32
without a word for ``xla`` and ``pallas``; here they raise).

COO and ELL take ``schedule='row_mapped'`` (or ``'auto'``) with
``impl='xla'`` only, as in ``loops_tpu``:

* COO — a stable sort of the nonzeros into row order at bind, then the
  sorted segment sum of ``vals * B[cols]`` (no scatter, bitwise
  repeatable on the card);
* ELL — ``B[idx]`` materialized as the [rows, pitch, F] plane, times the
  value plane, summed over the pitch. On a CUDA device planes larger
  than the card's free memory raise ``MemoryError`` before the gather
  (``ell_plane_guard``); nothing falls back.

``dtype='bfloat16'`` rounds vals, B and each product to bf16 and sums in
f32 on these too, as CSR does.

A kernel runs when the operator lives on a CUDA device; on the CPU its
wrapper takes the plain PyTorch version. float64 values with a kernel
impl raise ``ValueError`` on a CUDA device (the kernels stage f32) and,
on the CPU, warn and take the torch path, as ``loops_tpu`` does.
``impl_used`` names the path the build took and ``launches`` counts this
operator's kernel launches.
"""
from __future__ import annotations

import time
import warnings

import numpy as np
import torch

from loops_tpu_torch.formats import BCSR, COO, CSR, ELL
from loops_tpu_torch.layout import CsrLayout
from loops_tpu_torch.ops.kernels import (
    _build,
    spmm_bcsr,
    spmm_bcsr_v2,
    spmm_bcsr_v3,
    spmm_flat,
    spmv_bcsr,
)
from loops_tpu_torch.ops.kernels.spmm_flat import BF16, products
from loops_tpu_torch.ops.spmv import op_cache
from loops_tpu_torch.schedule.plans import (
    SCHEDULES,
    choose_schedule,
    make_plan,
    spmm_route_for,
)
from loops_tpu_torch.tuning.launch_box import launch_params
from loops_tpu_torch.utils import counters
from loops_tpu_torch.utils.platform import ensure_platform
from loops_tpu_torch.utils.trace import annotate

__all__ = ["spmm", "SpMMOperator"]

BCSR_KERNELS = {"pallas": "bcsr_spmm", "pallas2": "bcsr_spmm_v2",
                "pallas3": "bcsr_spmm_v3"}


def _dtype_mode(dtype):
    if dtype not in (None, BF16):
        raise ValueError(f"SpMM dtype={dtype!r}: expected None or "
                         f"{BF16!r}")
    return dtype


def ell_plane_bytes(rows: int, pitch: int, F: int, vals_dtype,
                    dtype=None) -> int:
    """Peak bytes that ELL SpMM's [rows, pitch, F] planes hold at once:
    the gather ``B[idx]`` and its product with the values (two planes of
    the value type); in bf16 mode the two bf16 planes and the product's
    float32 copy, counted together (2 + 2 + 4 bytes a cell)."""
    cell = 8 if dtype == BF16 else 2 * torch.finfo(vals_dtype).bits // 8
    return rows * pitch * F * cell


def ell_plane_guard(rows: int, pitch: int, F: int, vals_dtype, dtype,
                    device) -> None:
    """Raise ``MemoryError`` where ELL SpMM's planes (``ell_plane_bytes``)
    would not fit the card's free memory: the ``max_pitch`` probe at the
    width ``F`` of this call. Free memory is what the caching allocator
    holds unused, and only where that falls short, CUDA's free
    memory besides. No guard on the CPU."""
    if device.type != "cuda":
        return
    need = ell_plane_bytes(rows, pitch, F, vals_dtype, dtype)
    free = (torch.cuda.memory_reserved(device)
            - torch.cuda.memory_allocated(device))
    if need <= free:
        return
    free += torch.cuda.mem_get_info(device)[0]
    if need > free:
        max_pitch = pitch * free // need
        raise MemoryError(
            f"ELL SpMM holds {need / 2**30:.2f} GiB of [{rows}, {pitch}, "
            f"{F}] planes; at F = {F} the card's {free / 2**30:.2f} GiB "
            f"free fit a pitch of {max_pitch} (max_pitch)")


class SpMMOperator:
    """An SpMM bound to one CSR, BCSR, COO or ELL matrix on one device:
    ``op(B) -> C``.

    Plan once on the host, execute many times; ``C`` is float32 for f32
    or bf16 mode (float64 for float64 values on the torch paths).
    """

    def __init__(self, mat, schedule: str = "row_mapped",
                 impl: str = "xla", block_f: int | None = None, dtype=None,
                 hub_dense_min: int | None = None, block: int = 512,
                 device="cuda"):
        if not isinstance(mat, (CSR, BCSR, COO, ELL)):
            raise TypeError(f"SpMM takes a CSR, BCSR, COO or ELL matrix, "
                            f"got {type(mat).__name__}")
        if schedule not in SCHEDULES + ("auto",):
            raise ValueError(f"unknown schedule {schedule!r}; expected one "
                             f"of {SCHEDULES + ('auto',)}")
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
        build = getattr(self, f"_build_{type(mat).__name__.lower()}")
        self._bufs, self._raw = build(mat, schedule, impl)
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
        if counters.HOOK is not None:
            return counters.HOOK(self.work, self, B)
        with annotate("spmm"):
            B = self.stage(B)
            if self._kernel is None:
                return self._raw(self._bufs, B)
            before = _build.LAUNCHES[self._kernel]
            C = self._raw(self._bufs, B)
            self.launches += _build.LAUNCHES[self._kernel] - before
            return C

    def work(self, B) -> counters.Work:
        """One apply's work on a [cols, F] ``B`` (``utils/counters``): a
        BCSR by its stored blocks, any other format as the CSR of its
        nonzeros, in the operator's type mode."""
        m, F = self.mat, int(B.shape[1])
        if isinstance(m, BCSR):
            return counters.bcsr_work(self.rows, self.cols, m.num_blocks,
                                      m.num_block_rows, m.nnz, F, self.dtype)
        return counters.csr_spmm_work(self.rows, self.cols, m.nnz, F,
                                      self.dtype)

    def _to(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _f64_refusal(self, impl: str, vals_dtype, kernel: str) -> str:
        """``impl``, or ``'xla'`` for float64 values on the CPU (with a
        warning): the kernels stage f32. On a CUDA device the request
        raises, so a kernel request never runs torch ops on the card."""
        if impl == "xla" or np.dtype(vals_dtype) != np.float64:
            return impl
        reason = (f"impl={impl!r} stages float32 ({kernel}), and the values "
                  "are float64")
        if self.device.type == "cuda":
            raise ValueError(f"{reason}; pass impl='xla' for the torch path")
        warnings.warn(f"{reason}; falling back to the torch path",
                      stacklevel=4)
        return "xla"

    # ------------------------------------------------------------- CSR
    def _build_csr(self, csr: CSR, schedule, impl):
        if schedule == "auto":
            route = spmm_route_for(self.device)
            if route is None:
                pick = choose_schedule(CsrLayout.from_csr(csr))
                # SpMM has no sorted_flat analog; the skew/sorted picks map
                # to the degree-class planes, the rest to the
                # gather-segment path
                schedule = ("group_mapped"
                            if pick in ("group_mapped", "sorted_flat")
                            else "row_mapped")
            else:
                # the card's fitted route, with the impl it was timed on;
                # float64 values take the torch path (the kernels stage
                # f32, and auto is not a kernel request)
                schedule = choose_schedule(CsrLayout.from_csr(csr), route)
                impl = ("xla" if np.dtype(csr.vals.dtype) == np.float64
                        else route["impl"][schedule])
            self.schedule = schedule
        if impl not in ("xla", "pallas"):
            raise ValueError(f"csr SpMM implements impl 'xla' or 'pallas', "
                             f"got {impl!r}")
        if impl == "pallas" and schedule != "merge_path":
            raise ValueError(
                "csr SpMM implements impl='pallas' only with "
                f"schedule='merge_path'; got schedule={schedule!r}")
        impl = self._f64_refusal(impl, csr.vals.dtype, "K4")
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
        return self._row_segments(csr.offsets.astype(np.int64), csr.indices,
                                  csr.vals)

    def _row_segments(self, offsets, cols, vals):
        """Gather-multiply-segment: one sorted segment sum per row over
        row-ordered nonzeros and their int64 row ``offsets``."""
        bufs = dict(vals=self._to(vals), cols=self._to(cols).long(),
                    offsets=self._to(offsets))
        dtype = self.dtype

        def fn(b, B):
            prod = products(b["vals"], B, b["cols"], dtype)
            return torch.segment_reduce(prod, "sum", offsets=b["offsets"],
                                        axis=0, unsafe=True)
        return bufs, fn

    # ------------------------------------------------------------ BCSR
    def _build_bcsr(self, bcsr: BCSR, schedule, impl):
        if schedule not in ("row_mapped", "auto"):
            raise ValueError(
                f"bcsr SpMM implements schedule 'row_mapped' (or 'auto'), "
                f"got {schedule!r}: every BCSR impl runs block rows")
        self.schedule = "row_mapped"
        if impl not in ("xla", *BCSR_KERNELS):
            raise ValueError(f"bcsr SpMM implements impl in ('xla', "
                             f"'pallas', 'pallas2', 'pallas3'), got {impl!r}")
        if self.dtype == BF16 and impl not in ("pallas2", "pallas3"):
            raise ValueError(
                f"bcsr SpMM dtype='bfloat16' streams bf16 through K8/K7: "
                f"impl 'pallas2' or 'pallas3', got {impl!r}")
        impl = self._f64_refusal(impl, bcsr.vals.dtype, "K7-K9")
        if impl == "xla":
            shape = bcsr.shape

            def fn(b, B):
                return spmm_bcsr.bcsr_spmm_plain(b, B, shape)
            return spmv_bcsr.stage(bcsr, self.device), fn
        self.impl_used = BCSR_KERNELS[impl]
        if impl == "pallas":
            return spmm_bcsr.bcsr_spmm(bcsr, block_f=self.block_f,
                                       device=self.device)
        build = (spmm_bcsr_v2.bcsr_spmm_v2 if impl == "pallas2"
                 else spmm_bcsr_v3.bcsr_spmm_v3)
        return build(bcsr, block_f=self.block_f, dtype=self.dtype,
                     device=self.device)

    # ------------------------------------------------------ COO and ELL
    @staticmethod
    def _xla_row_mapped_only(fmt: str, schedule, impl):
        if schedule not in ("row_mapped", "auto") or impl != "xla":
            raise ValueError(
                f"{fmt} SpMM implements schedule='row_mapped' with "
                f"impl='xla' only, got schedule={schedule!r}, "
                f"impl={impl!r}")

    def _build_coo(self, coo: COO, schedule, impl):
        self._xla_row_mapped_only("coo", schedule, impl)
        self.schedule = "row_mapped"
        csr = coo.to_csr()  # a stable sort into row order
        return self._row_segments(csr.offsets.astype(np.int64), csr.indices,
                                  csr.vals)

    def _build_ell(self, ell: ELL, schedule, impl):
        self._xla_row_mapped_only("ell", schedule, impl)
        self.schedule = "row_mapped"
        idx, val = ell.to_device(self.device)
        rows, pitch = ell.shape[0], ell.pitch
        dtype = self.dtype

        def fn(b, B):
            ell_plane_guard(rows, pitch, B.shape[1], B.dtype, dtype,
                            B.device)
            s = products(b["val"].reshape(-1), B, b["idx"].reshape(-1).long(),
                         dtype)
            return s.reshape(rows, pitch, -1).sum(dim=1)
        return dict(idx=idx, val=val), fn

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


def spmm(mat, B, schedule: str = "row_mapped", impl: str = "xla",
         block_f: int | None = None, dtype=None, block: int = 512,
         device="cuda"):
    """One-shot SpMM with operator caching on the container."""
    device = ensure_platform(device)
    key = (schedule, impl, block_f, str(dtype), block, str(device))
    cache = op_cache(mat, "_spmm_ops")
    if key not in cache:
        cache[key] = SpMMOperator(mat, schedule, impl, block_f, dtype,
                                  block=block, device=device)
    return cache[key](B)
