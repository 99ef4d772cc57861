"""SpMV — sparse matrix x dense vector across all formats and schedules.

The port of ``loops_tpu/ops/spmv.py``. Every schedule's *plan* is host
precompute (``loops_tpu_torch.schedule.plans``); the device runs either
plain torch ops or one of the hand-written CUDA kernels.

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
* ``sorted_flat`` — kernel K1 (``ops/kernels/spmv_sorted.py``).
* ``auto`` — ``choose_schedule``'s pick under ``thresholds_for(device)``:
  on a card with a fitted row (``schedule/plans.py``
  ``CARD_THRESHOLDS``) run by the impl the sweep timed that schedule with
  (K1 for ``sorted_flat``, K2 for the flat schedules); elsewhere
  ``loops_tpu``'s table, whose ``sorted_flat`` runs on K1. ``auto`` is
  not a kernel request: on float64 values a kernel pick warns and takes
  the torch executor on every device, as the reference does.

The other formats take ``impl='xla'`` only, as in the reference, and run
torch ops; the deterministic ones sum each output row in a fixed order:

* COO ``row_mapped``/``group_mapped`` (``auto`` resolves to row_mapped)
  and CSC ``row_mapped`` — the matrix converted to CSR at bind (a stable
  sort of the nonzeros into row order), then CSR's row_mapped each apply
  (the reference scatter-adds into the output rows; no ``index_add_``
  here, so two applies on the card are bitwise equal). COO's
  ``work_oriented``/``merge_path`` go through ``_flat_xla`` over the
  degenerate COO layout, combined through the matrix's row ids.
* ELL ``row_mapped``/``group_mapped``/``auto`` — a masked reduction over
  the rows of the [rows, pitch] plane (sentinel slots staged as column
  0, value 0); ``work_oriented``/``merge_path`` — ``_flat_xla`` over the
  closed-form ELL layout.
* DIA ``row_mapped`` (``auto`` resolves to it) — the sweep over
  diagonals: ``vals * x[cols]`` over a clamped and masked [D, rows]
  column plane, summed over D.

BCSR has one execution shape, ``row_mapped`` (``auto`` resolves to it):
atoms are stored blocks and the reduction is block-row-local.
``impl='xla'`` is a batched einsum over each block's x segment, then a
sorted segment sum over the block rows; ``impl='pallas'`` is kernel K6
(``ops/kernels/spmv_bcsr.py``).

``reorder='degree'|'bfs'`` (CSR, square) permutes the matrix at plan
time (``layout/reorder.py``) and runs the permuted CSR under whatever
schedule and impl was asked for; ``x[perm]`` in and ``y[inv]`` out run
on the device.

A kernel runs when the operator lives on a CUDA device; on the CPU each
kernel wrapper takes its plain PyTorch version. A kernel impl the kernels
cannot honor (float64 values; a row span past K3's window) raises on a
CUDA device and, on the CPU, warns and takes the torch executor.
``impl_used`` names the path the build took and ``launches`` counts this
operator's kernel launches.

``plan_cache=dir`` keeps K1's host plan on disk (``io/plan_cache.py``):
a later operator on a matrix of the same shape and row offsets loads
it (``meta['plan_source']`` 'cache'). ``bucketed=`` (ROADMAP A12) is not ported and raises
``NotImplementedError`` naming the item.
"""
from __future__ import annotations

import time
import warnings

import numpy as np
import torch

from loops_tpu_torch.formats import BCSR, COO, CSC, CSR, DIA, ELL
from loops_tpu_torch.layout import (
    CooLayout,
    CsrLayout,
    EllLayout,
)
from loops_tpu_torch.ops.gather import gather1d
from loops_tpu_torch.ops.kernels import (
    _build,
    spmv_bcsr,
    spmv_flat,
    spmv_flat_v2,
    spmv_sorted,
)
from loops_tpu_torch.schedule.plans import (
    SCHEDULES,
    choose_schedule,
    make_plan,
    thresholds_for,
)
from loops_tpu_torch.tuning.launch_box import launch_params
from loops_tpu_torch.utils import counters
from loops_tpu_torch.utils.platform import ensure_platform

__all__ = ["spmv", "SpMVOperator", "SCHEDULES", "flat_partitioned_spmv"]

# rows past the last that the flat executor's padding slots are spread over
DROPPED_ROWS = 1024

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


def _reordered(mat, reorder: str):
    """``(permuted CSR, perm, inverse)`` for ``reorder=`` (reference:
    loops_tpu/ops/spmv.py:147-172): a symmetric permutation of a square
    CSR, ``perm`` mapping new index -> old."""
    from loops_tpu_torch.layout.reorder import (
        bfs_order,
        degree_order,
        inverse_permutation,
        permute_csr,
    )
    if not isinstance(mat, CSR):
        raise ValueError("reorder= implements CSR only")
    if mat.shape[0] != mat.shape[1]:
        raise ValueError("reorder= is a symmetric (square) permutation")
    if reorder == "degree":
        perm = degree_order(mat)
    elif reorder == "bfs":
        perm = bfs_order(mat)
    else:
        raise ValueError(f"unknown reorder {reorder!r}; 'degree' or 'bfs'")
    return permute_csr(mat, perm), perm, inverse_permutation(perm)


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
        if not isinstance(mat, (CSR, BCSR, COO, CSC, ELL, DIA)):
            raise TypeError(f"SpMV takes a CSR, BCSR, COO, CSC, ELL or DIA "
                            f"matrix, got {type(mat).__name__}")
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
        perm = None
        if reorder is not None:
            t0 = time.perf_counter()
            mat, perm, inv = _reordered(mat, reorder)
            reorder_ms = (time.perf_counter() - t0) * 1e3
        self.mat = mat
        self.reorder = reorder
        self.schedule = schedule
        self.impl = impl
        self.block = block
        self.class_step = class_step
        # a directory of the plan cache (io/plan_cache.py): K1's host plan
        # is built once per matrix, not once per process; no other
        # route has a plan to cache, and leaves it unused
        self.plan_cache = plan_cache
        self.rows, self.cols = mat.shape
        self._dtype = torch.from_numpy(mat.vals[:0]).dtype
        # "torch" for the torch-op executors, else the kernel's name
        self.impl_used = "torch"
        self.launches = 0
        build = getattr(self, f"_build_{type(mat).__name__.lower()}")
        self._bufs, self._raw = build(mat, schedule, block, impl)
        if perm is not None:
            self._bufs, self._raw = self._permuted(self._bufs, self._raw,
                                                   perm, inv)
        self._kernel = (self.impl_used if self.impl_used in _build.LAUNCHES
                        else None)
        # the device as a staged tensor's reads (with its index): an x
        # already there, of the value type and contiguous, is used as is
        self._staged_on = torch.empty(0, device=self.device).device
        # kernel-reported plan metadata (e.g. K1's plan_ms) survives on
        # the operator
        self.meta = dict(getattr(self._raw, "meta", {}) or {})
        if perm is not None:
            self.meta["reorder_ms"] = reorder_ms  # host ordering + permute

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
        if counters.HOOK is not None:
            return counters.HOOK(self.work, self, x)
        x = self.stage(x)
        if self._kernel is None:
            return self._raw(self._bufs, x)
        before = _build.LAUNCHES[self._kernel]
        y = self._raw(self._bufs, x)
        self.launches += _build.LAUNCHES[self._kernel] - before
        return y

    def work(self, x=None) -> counters.Work:
        """One apply's work (``utils/counters``): a BCSR by its stored
        blocks, any other format as the CSR of its nonzeros, whatever
        schedule or kernel runs it."""
        m = self.mat
        if isinstance(m, BCSR):
            return counters.bcsr_work(self.rows, self.cols, m.num_blocks,
                                      m.num_block_rows, m.nnz)
        return counters.csr_spmv_work(self.rows, self.cols, m.nnz)

    def _to(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _permuted(self, bufs, inner, perm, inv):
        """``inner`` on the permuted matrix, as a function of the original
        ``x``: ``y[i] = y_perm[inv[i]]`` with ``x_perm[i] = x[perm[i]]``."""
        bufs = dict(inner=bufs, perm=self._to(perm), inv=self._to(inv))

        def fn(b, x):
            return gather1d(inner(b["inner"], gather1d(x, b["perm"])),
                            b["inv"])
        fn.meta = getattr(inner, "meta", None)
        return bufs, fn

    def _row_mapped(self, csr: CSR):
        """Per-row sums of ``vals * x[cols]`` in storage order: the sorted
        segment sum over the CSR offsets (each row summed in a fixed
        order: no atomics)."""
        bufs = dict(vals=self._to(csr.vals), cols=self._to(csr.indices),
                    offsets=self._to(csr.offsets.astype(np.int64)))
        return bufs, _row_sums

    # ------------------------------------------------------------- CSR
    def _build_csr(self, csr: CSR, schedule, block, impl):
        rows = self.rows
        layout = CsrLayout.from_csr(csr)
        advice = "impl='xla'"
        f64 = np.dtype(csr.vals.dtype) == np.float64
        if schedule == "auto":
            table = thresholds_for(self.device)
            schedule = self.schedule = choose_schedule(layout, table)
            # a card's row runs each schedule with the impl it was timed on
            row_impl = table.get("impl", {}).get(schedule)
            impl = impl if row_impl is None else row_impl
            if f64 and (schedule == "sorted_flat"
                        or row_impl not in (None, "xla")):
                # auto is not a kernel request: as the reference does
                # (loops_tpu/ops/spmv.py:267-271), warn and take the
                # torch executor on every device
                warnings.warn(
                    f"schedule='auto' chose {schedule}, whose kernel stages "
                    "float32; taking the torch executor for float64 values",
                    stacklevel=3)
                if schedule == "sorted_flat":
                    schedule = "merge_path"
                impl = "xla"
        if schedule == "sorted_flat":
            schedule, impl = "merge_path", "pallas3"
            advice = "schedule='merge_path'"

        if schedule == "row_mapped":
            _require("csr", schedule, impl, SCHEDULES, ("xla",))
            return self._row_mapped(csr)

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
            return spmv_sorted.sorted_spmv(csr, device=self.device,
                                           cache_dir=self.plan_cache)
        t0 = time.perf_counter()
        plan = make_plan(layout, schedule, **_flat_kw(schedule, block))
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

    # ------------------------------------------------------------- COO
    def _build_coo(self, coo: COO, schedule, block, impl):
        if schedule == "auto":
            schedule = self.schedule = "row_mapped"
        _require("coo", schedule, impl, SCHEDULES, ("xla",))
        if schedule in ("row_mapped", "group_mapped"):
            # tile == atom == nonzero: both collapse to the row reduction
            # (reference: spmv/coo_thread_mapped.cuh:37-89), run as CSR's
            # after a stable sort into row order at bind
            return self._row_mapped(coo.to_csr())
        # flat schedules over the degenerate COO layout: per-block partial
        # products, combined through the *matrix* row ids
        plan = make_plan(CooLayout.from_coo(coo), schedule,
                         **_flat_kw(schedule, block))
        return self._flat_xla(plan, vals=plan.gather(coo.vals),
                              gather_cols=plan.gather(coo.cols),
                              out_of_tile=coo.rows)

    # ------------------------------------------------------------- CSC
    def _build_csc(self, csc: CSC, schedule, block, impl):
        if schedule == "auto":
            schedule = self.schedule = "row_mapped"
        # tile = column; atoms land in arbitrary output rows, so there is
        # one execution shape, as the reference's single csc kernel
        # (spmv/csc_thread_mapped.cuh:37-87)
        _require("csc", schedule, impl, ("row_mapped",), ("xla",))
        return self._row_mapped(csc.to_csr())

    # ------------------------------------------------------------- ELL
    def _build_ell(self, ell: ELL, schedule, block, impl):
        _require("ell", schedule, impl, SCHEDULES + ("auto",), ("xla",))
        if schedule in ("row_mapped", "group_mapped", "auto"):
            # the plane is one uniform group: a dense masked row reduction
            # (reference: spmv/ell_thread_mapped.cuh:28-76, whose sentinel
            # skips become multiplies by zero)
            idx, val = ell.to_device(self.device)

            def fn(b, x):
                return (b["val"] * gather1d(x, b["idx"])).sum(dim=1)
            return dict(idx=idx, val=val), fn
        # flat schedules over the closed-form uniform layout (reference:
        # spmv/ell_merge_path.cuh:32-126)
        plan = make_plan(EllLayout.from_ell(ell), schedule,
                         **_flat_kw(schedule, block))
        idx, val = ell.safe_planes()
        return self._flat_xla(plan, vals=plan.gather(val.ravel()),
                              gather_cols=plan.gather(idx.ravel()))

    # ------------------------------------------------------------- DIA
    def _build_dia(self, dia: DIA, schedule, block, impl):
        if schedule == "auto":
            schedule = self.schedule = "row_mapped"
        # one execution shape: the dense diagonal sweep (the reference
        # likewise ships only dia_thread_mapped, spmv/dia_thread_mapped.cuh:
        # 36-96)
        _require("dia", schedule, impl, ("row_mapped",), ("xla",))
        col, val = dia.column_plane()

        def fn(b, x):
            return (b["val"] * gather1d(x, b["col"])).sum(dim=0)
        return dict(col=self._to(col), val=self._to(val)), fn

    # ------------------------------------------------ flat torch executor
    def _flat_xla(self, plan, vals, gather_cols, out_of_tile=None):
        """Two-phase blocked reduction for the flat schedules.

        Phase 1: per-block products (fixed [num_blocks, K]).
        Phase 2: combine by output row. Where the layout's tiles *are*
        the output rows (CSR, ELL) the ids come from the plan's
        tile_starts + rel_tile; COO routes through the matrix row ids
        (``out_of_tile``). Padding slots go to ``DROPPED_ROWS`` rows past
        the last, spread over them: a COO plan is half padding, and
        ``index_add_``'s atomics all on one dropped row would serialize.
        """
        rows = self.rows
        if out_of_tile is None:
            ids = plan.tile_starts[:-1, None].astype(np.int64) + plan.rel_tile
            ids = np.minimum(ids, rows)
        else:
            ids = plan.gather(out_of_tile).astype(np.int64)
        dropped = rows + np.arange(ids.size).reshape(ids.shape) % DROPPED_ROWS
        ids = np.where(plan.valid, ids, dropped)
        bufs = dict(v=self._to(vals), gc=self._to(gather_cols),
                    ids=self._to(ids.reshape(-1)))
        empty = plan.num_atoms == 0

        def fn(b, x):
            if empty:
                # no nonzeros (and perhaps no column to gather): zeros
                return torch.zeros(rows, dtype=x.dtype, device=x.device)
            products = b["v"] * gather1d(x, b["gc"])       # [B, K]
            y = torch.zeros(rows + DROPPED_ROWS, dtype=x.dtype,
                            device=x.device)
            return y.index_add_(0, b["ids"], products.reshape(-1))[:rows]
        return bufs, fn


def _row_sums(b, x):
    """Per-row sums of ``vals * x[cols]`` over row-ordered nonzeros, each
    row summed in storage order (``torch.segment_reduce`` over the int64
    ``offsets``)."""
    return torch.segment_reduce(b["vals"] * gather1d(x, b["cols"]), "sum",
                                offsets=b["offsets"], unsafe=True)


def _flat_kw(schedule: str, block: int) -> dict:
    return ({"block_atoms": block} if schedule == "work_oriented"
            else {"block_work": block})


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


def flat_partitioned_spmv(csr: CSR, x, atoms_per_tile: int = 8,
                          device="cuda"):
    """SpMV through the flat re-binning partitioner (reference:
    spmv/flat_partitioned.cuh:46-106): K-atom windows processed
    tile-agnostically, each atom's output addressed through its base tile
    (``base().tile_of``). Over a CSR base layout an atom's base tile is its
    row, so the windows' sums are the per-row sums of ``row_mapped`` and the
    window width changes no sum: this is ``spmv(csr, x, 'row_mapped')``
    (``atoms_per_tile`` is checked, as the reference's layout checks it,
    and otherwise unused)."""
    if atoms_per_tile <= 0:
        raise ValueError("atoms_per_tile must be positive")
    return spmv(csr, x, "row_mapped", impl="xla", device=device)
