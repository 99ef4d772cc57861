"""SpMV — sparse matrix x dense vector: CSR (every schedule) and BCSR.

The port of ``loops_tpu/ops/spmv.py`` for CSR and BCSR. Every schedule's
*plan* is host precompute (``loops_tpu_torch.schedule.plans``); the
device runs either plain torch ops or one of the hand-written CUDA
kernels.

Schedule -> execution (CSR):

* ``row_mapped``   — per-row segment sum of ``vals * x[cols]``
  (``torch.segment_reduce`` over the row offsets); the analog of
  thread_mapped (reference: spmv/thread_mapped.cuh:31-91).
* ``group_mapped`` — dense row reductions over the GroupMappedPlan's
  degree-class planes (reference: spmv/group_mapped.cuh:31-105).
* ``work_oriented`` / ``merge_path`` with ``impl='xla'`` — the two-phase
  blocked executor ``_flat_xla`` as torch ops: per-block products, then
  ``index_add_`` by output row. (``'xla'`` keeps the reference's impl
  name; here it names the torch-op executor.)
* ``merge_path`` with ``impl='pallas2'`` — kernel K2
  (``ops/kernels/spmv_flat_v2.py``); with ``impl='pallas'`` — kernel K3
  (``ops/kernels/spmv_flat.py``).
* ``sorted_flat`` (and ``auto`` where ``choose_schedule`` picks it) —
  kernel K1 (``ops/kernels/spmv_sorted.py``). ``auto`` is not a kernel
  request: on float64 values it warns and takes the torch ``merge_path``
  executor on every device, as the reference does.

BCSR has one execution shape, ``row_mapped`` (``auto`` resolves to it):
atoms are stored blocks and the reduction is block-row-local.
``impl='xla'`` is a batched einsum over each block's x segment, then a
sorted segment sum over the block rows; ``impl='pallas'`` is kernel K6
(``ops/kernels/spmv_bcsr.py``).

A kernel runs when the operator lives on a CUDA device; on the CPU each
kernel wrapper takes its plain PyTorch version. A kernel impl the kernels
cannot honor (float64 values; a row span past K3's window) raises on a
CUDA device and, on the CPU, warns and takes the torch executor.
``impl_used`` names the path the build took and ``launches`` counts this
operator's kernel launches.

COO, CSC, ELL and DIA matrices, ``reorder=``, ``plan_cache=`` and
``bucketed=`` are not ported yet and raise ``NotImplementedError`` naming
the ROADMAP item.
"""
from __future__ import annotations

import time
import warnings

import numpy as np
import torch

from loops_tpu_torch.formats import BCSR, CSR
from loops_tpu_torch.layout import CsrLayout
from loops_tpu_torch.ops.gather import gather1d
from loops_tpu_torch.ops.kernels import (
    _build,
    spmv_bcsr,
    spmv_flat,
    spmv_flat_v2,
    spmv_sorted,
)
from loops_tpu_torch.schedule.plans import SCHEDULES, choose_schedule, make_plan
from loops_tpu_torch.tuning.launch_box import launch_params
from loops_tpu_torch.utils.platform import ensure_platform

__all__ = ["spmv", "SpMVOperator", "SCHEDULES"]

# K3 takes plans whose 128-aligned row window is at most this many rows;
# a work_oriented plan over long runs of empty rows can be wider.
MAX_PALLAS_SPAN = spmv_flat.MAX_WINDOW


def _kernel_refusal(impl: str, vals_dtype, device, plan=None,
                    advice: str = "impl='xla'") -> str:
    """Effective impl for a kernel build (``pallas``, ``pallas2``,
    ``pallas3``). The kernels stage float32, and K3 takes plans whose row
    span fits its window. A request they cannot honor raises on a CUDA
    device, naming ``advice`` as the way to the torch executor, so a
    kernel request never runs torch ops on the card; on the CPU, where
    each wrapper runs its plain version, it warns and takes the torch
    executor, as the reference's plan-time refusals do."""
    if impl not in ("pallas", "pallas2", "pallas3"):
        return impl
    if np.dtype(vals_dtype) == np.float64:
        reason = f"impl={impl!r} stages float32, and the values are float64"
    elif impl == "pallas" and plan is not None and (
            span := spmv_flat.row_window(plan)) > MAX_PALLAS_SPAN:
        reason = (f"plan row span {span} exceeds K3's shared-memory row "
                  f"window of {MAX_PALLAS_SPAN} floats (work_oriented spans "
                  "are data dependent; schedule='merge_path' bounds them by "
                  "the block size)")
    else:
        return impl
    if device.type == "cuda":
        raise ValueError(f"{reason}; pass {advice} for the torch executor")
    warnings.warn(f"{reason}; falling back to the torch executor (pass "
                  f"{advice} to ask for it)", stacklevel=4)
    return "xla"


def _require(fmt: str, schedule: str, impl: str, schedules: tuple,
             impls: tuple):
    """Restrict (schedule, impl) to combinations the format honors —
    the API must not pretend to honor a knob it ignores."""
    if schedule not in schedules:
        raise ValueError(
            f"{fmt} SpMV implements schedules {schedules}, got "
            f"{schedule!r} (every {fmt} strategy funnels into one "
            "execution shape; pick a supported name)")
    if impl not in impls:
        raise ValueError(
            f"{fmt} SpMV (schedule={schedule!r}) implements impl "
            f"{impls}, got {impl!r}")


def _not_ported(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported to loops_tpu_torch yet (ROADMAP {item})")


class SpMVOperator:
    """An SpMV bound to one matrix on one device: plan once, execute many.

    The reference rebuilds its schedule inside every kernel launch from
    raw pointers; here planning is host work, so the operator form makes
    the plan/execute split explicit.
    """

    def __init__(self, mat, schedule: str = "row_mapped",
                 block: int | None = None, impl: str = "xla",
                 bucketed: bool = False, reorder: str | None = None,
                 class_step: float | None = None,
                 plan_cache: str | None = None, device="cuda"):
        if not isinstance(mat, (CSR, BCSR)):
            _not_ported(f"{type(mat).__name__} SpMV", "A6")
        if reorder is not None:
            _not_ported("reorder=", "A4 (layout/reorder.py)")
        if plan_cache is not None:
            _not_ported("plan_cache=", "A10 (io/plan_cache.py)")
        if bucketed:
            _not_ported("bucketed=", "A12")
        self.device = ensure_platform(device)
        if block is None:
            # the card-keyed launch box (util/launch_box.hxx:176-214)
            block = launch_params(self.device).spmv_block
        if schedule not in SCHEDULES and schedule not in (
                "auto", "sorted_flat"):
            raise ValueError(
                f"unknown schedule {schedule!r}; expected one of "
                f"{SCHEDULES + ('sorted_flat', 'auto')}")
        self.mat = mat
        self.schedule = schedule
        self.impl = impl
        self.block = block
        self.class_step = class_step
        self.rows, self.cols = mat.shape
        self._dtype = torch.from_numpy(mat.vals[:0]).dtype
        # "torch" for the torch-op executors, else the kernel's name
        self.impl_used = "torch"
        self.launches = 0
        build = self._build_csr if isinstance(mat, CSR) else self._build_bcsr
        self._bufs, self._raw = build(mat, schedule, block, impl)
        self._kernel = (self.impl_used if self.impl_used in _build.LAUNCHES
                        else None)
        # the device as a staged tensor's reads (with its index): an x
        # already there, of the value type and contiguous, is used as is
        self._staged_on = torch.empty(0, device=self.device).device
        # kernel-reported plan metadata (e.g. K1's plan_ms) survives on
        # the operator
        self.meta = dict(getattr(self._raw, "meta", {}) or {})

    def stage(self, x) -> torch.Tensor:
        """``x`` as a contiguous tensor of the matrix's value type on the
        operator's device (a no-op for an already staged tensor)."""
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.asarray(x))
        elif (x.dtype == self._dtype and x.device == self._staged_on
              and x.is_contiguous()):
            return x
        return x.to(self.device, self._dtype).contiguous()

    def __call__(self, x):
        x = self.stage(x)
        if self._kernel is None:
            return self._raw(self._bufs, x)
        before = _build.LAUNCHES[self._kernel]
        y = self._raw(self._bufs, x)
        self.launches += _build.LAUNCHES[self._kernel] - before
        return y

    def _to(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # ------------------------------------------------------------- CSR
    def _build_csr(self, csr: CSR, schedule, block, impl):
        rows = self.rows
        layout = CsrLayout.from_csr(csr)
        advice = "impl='xla'"
        f64 = np.dtype(csr.vals.dtype) == np.float64
        if schedule == "auto":
            schedule = self.schedule = choose_schedule(layout)
            if schedule == "sorted_flat" and f64:
                # auto is not a kernel request: as the reference does
                # (loops_tpu/ops/spmv.py:267-271), warn and take the
                # merge-path torch executor on every device
                warnings.warn(
                    "schedule='auto' chose sorted_flat, whose kernel K1 "
                    "stages float32; taking the torch merge-path executor "
                    "for float64 values", stacklevel=3)
                schedule = "merge_path"
        if schedule == "sorted_flat":
            schedule, impl = "merge_path", "pallas3"
            advice = "schedule='merge_path'"

        if schedule == "row_mapped":
            _require("csr", schedule, impl, SCHEDULES, ("xla",))
            bufs = dict(vals=self._to(csr.vals), cols=self._to(csr.indices),
                        offsets=self._to(csr.offsets.astype(np.int64)))

            def fn(b, x):
                return torch.segment_reduce(
                    b["vals"] * gather1d(x, b["cols"]), "sum",
                    offsets=b["offsets"], unsafe=True)
            return bufs, fn

        if schedule == "group_mapped":
            _require("csr", schedule, impl, SCHEDULES, ("xla",))
            plan = make_plan(layout, schedule,
                             **({"class_step": self.class_step}
                                if self.class_step else {}))
            bufs = dict(buckets=[
                (self._to(b["tiles"]),
                 self._to(csr.indices[b["atom_slots"]]),
                 self._to(np.where(b["valid"], csr.vals[b["atom_slots"]],
                                   0).astype(csr.vals.dtype)))
                for b in plan.buckets])

            def fn(b, x):
                y = torch.zeros(rows, dtype=x.dtype, device=x.device)
                for tiles, idx, v in b["buckets"]:
                    # each tile sits in exactly one bucket: a plain store
                    y[tiles] = (v * gather1d(x, idx)).sum(dim=1)
                return y
            return bufs, fn

        # balanced flat schedules
        _require("csr", schedule, impl, SCHEDULES,
                 ("xla", "pallas", "pallas2", "pallas3"))
        impl = _kernel_refusal(impl, csr.vals.dtype, self.device,
                               advice=advice)
        if impl == "pallas3":
            self.impl_used = "sorted_spmv"
            return spmv_sorted.sorted_spmv(csr, device=self.device)
        t0 = time.perf_counter()
        plan = make_plan(layout, schedule,
                         **({"block_atoms": block}
                            if schedule == "work_oriented"
                            else {"block_work": block}))
        plan_ms = (time.perf_counter() - t0) * 1e3
        impl = _kernel_refusal(impl, csr.vals.dtype, self.device, plan)
        if impl in ("pallas", "pallas2"):
            build = (spmv_flat.flat_spmv if impl == "pallas"
                     else spmv_flat_v2.flat_spmv_v2)
            self.impl_used = build.__name__
            bufs, fn = build(csr, plan, device=self.device)
            fn.meta["plan_ms"] = plan_ms  # host merge-path planning
            return bufs, fn
        return self._flat_xla(plan, vals=plan.gather(csr.vals),
                              gather_cols=plan.gather(csr.indices))

    # ------------------------------------------------------------- BCSR
    def _build_bcsr(self, bcsr: BCSR, schedule, block, impl):
        if schedule == "auto":
            schedule = self.schedule = "row_mapped"
        # one execution shape (the reference likewise ships only
        # bcsr_thread_mapped); impl picks the torch ops or K6
        _require("bcsr", schedule, impl, ("row_mapped",), ("xla", "pallas"))
        impl = _kernel_refusal(impl, bcsr.vals.dtype, self.device)
        if impl == "pallas":
            self.impl_used = "bcsr_spmv"
            return spmv_bcsr.bcsr_spmv(bcsr, device=self.device)
        shape = bcsr.shape

        def fn(b, x):
            return spmv_bcsr.bcsr_spmv_plain(b, x, shape)
        return spmv_bcsr.stage(bcsr, self.device), fn

    # ------------------------------------------------ flat torch executor
    def _flat_xla(self, plan, vals, gather_cols):
        """Two-phase blocked reduction for the flat schedules.

        Phase 1: per-block products (fixed [num_blocks, K]).
        Phase 2: combine by output row, from the plan's
        tile_starts + rel_tile (padding slots go to a dropped row).
        """
        rows = self.rows
        ids = plan.tile_starts[:-1, None].astype(np.int64) + plan.rel_tile
        ids = np.where(plan.valid, np.minimum(ids, rows), rows)
        bufs = dict(v=self._to(vals), gc=self._to(gather_cols),
                    ids=self._to(ids.reshape(-1)))
        empty = plan.num_atoms == 0

        def fn(b, x):
            if empty:
                # no nonzeros (and perhaps no column to gather): zeros
                return torch.zeros(rows, dtype=x.dtype, device=x.device)
            products = b["v"] * gather1d(x, b["gc"])       # [B, K]
            y = torch.zeros(rows + 1, dtype=x.dtype, device=x.device)
            return y.index_add_(0, b["ids"], products.reshape(-1))[:rows]
        return bufs, fn


def op_cache(mat, attr: str) -> dict:
    """The dict of operators kept on the container ``mat`` under ``attr``
    (``_spmv_ops``, ``_spmm_ops``, ``_sddmm_ops``), made on first use."""
    cache = getattr(mat, attr, None)
    if cache is None:
        cache = {}
        object.__setattr__(mat, attr, cache)
    return cache


def spmv(mat, x, schedule: str = "row_mapped", block: int | None = None,
         impl: str = "xla", device="cuda"):
    """One-shot SpMV with operator caching on the container."""
    device = ensure_platform(device)
    key = (schedule, block, impl, str(device))
    cache = op_cache(mat, "_spmv_ops")
    if key not in cache:
        cache[key] = SpMVOperator(mat, schedule, block, impl, device=device)
    return cache[key](x)
