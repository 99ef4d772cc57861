"""Work counters: the flops and bytes of one call, and the rates they
are achieved at — the port of ``loops_tpu/utils/counters.py``.

The JAX module reads XLA's cost analysis of the compiled executable.
This one counts the problem's work instead: what the function must read,
write and compute whatever kernel or schedule runs it. Each formula takes
shapes (rows, cols, nnz, F, blocks, type), not matrices, and is the one
source of the bounds that ``chip_smoke.py`` prints:

* ``csr_spmv_work``: y = A x over CSR (offsets, cols, vals and x read, y
  written; 2 flops a nonzero);
* ``csr_spmm_work``: C = A B (B read once, C written once);
* ``bcsr_work``: BCSR SpMV or SpMM over the stored blocks;
* ``sddmm_flat_work`` / ``sddmm_bcsr_work``: the sampled products;
* ``stream_read_work``, ``saxpy_work``: K11 and K12;
* ``edge_rows_work``: reads of each edge's feature row (GAT's yardstick).

``bound(nbytes, flops, dtype, rate, floor)`` (``bound_of(work)``) turns
work into the least time the card could take: the bytes over 3.35 TB/s
(or a measured rate), the flops over the H100 SXM's peak for their type
(67 TFLOP/s f32 on the CUDA cores, 989 bf16) and a launch floor, the
largest of the three.

``compiled_counters(fn, *args)`` returns ``{"flops", "bytes accessed",
"dtype"}`` for one call of ``fn``. Each operator of the port
(``SpMVOperator``, ``SpMMOperator``, ``SDDMMOperator``, over any format)
and K12's ``saxpy`` knows its own work (``op.work(*args)``, from these
formulas) and reports it through ``HOOK`` while a count is open, so it
counts the same on the CPU and on the card, for every schedule and
kernel. The rest of the call is counted from its torch ops: flops by
``torch.utils.flop_counter.FlopCounterMode``, bytes as the tensor bytes
each op reads and writes (views move none). ``achieved(counters, ms)``
gives the same keys as the JAX module's.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.utils._pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

__all__ = ["compiled_counters", "achieved", "bound", "bound_of", "Work",
           "csr_spmv_work", "csr_spmm_work", "bcsr_work", "sddmm_flat_work",
           "sddmm_bcsr_work", "stream_read_work", "saxpy_work",
           "edge_rows_work"]

# H100 SXM at 700 W (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {None: 67e12, "bfloat16": 989e12}
F32, BF16 = None, "bfloat16"


@dataclass(frozen=True)
class Work:
    """One call's bytes and flops, and the type its flops run in
    (``None`` for f32, ``"bfloat16"``)."""
    nbytes: int
    flops: int
    dtype: str | None = F32

    def counters(self) -> dict:
        return {"flops": float(self.flops),
                "bytes accessed": float(self.nbytes),
                "dtype": "bfloat16" if self.dtype else "float32"}


def _mode(dtype) -> str | None:
    """``None`` (f32) or ``"bfloat16"`` from a mode name or torch type."""
    if dtype is None:
        return F32
    name = str(dtype).removeprefix("torch.")
    if name in ("bfloat16", "bf16"):
        return BF16
    if name in ("float32", "f32", "float64", "f64"):
        return F32
    raise ValueError(f"no peak rate for type {dtype!r}")


def bound(nbytes, flops, dtype=None, rate=None, floor=0.0):
    """``(ms, "bytes", "operations" or "launch")``: the least time the card
    could take to move ``nbytes`` at ``rate`` bytes/s (None: the nominal
    3.35 TB/s; or K11's measured rate), do ``flops`` at the peak of
    ``dtype`` and launch a kernel (``floor`` ms; 0 where it is not
    measured)."""
    t_bytes = nbytes / (HBM_BYTES_PER_S if rate is None else rate) * 1e3
    t_ops = flops / PEAK_FLOPS[_mode(dtype)] * 1e3
    return max((t_bytes, "bytes"), (t_ops, "operations"), (floor, "launch"),
               key=lambda b: b[0])


def csr_spmv_work(rows, cols, nnz) -> Work:
    """y = A x over CSR: offsets, cols, vals and x read, y written."""
    return Work(4 * (rows + 1) + 8 * nnz + 4 * cols + 4 * rows, 2 * nnz)


def csr_spmm_work(rows, cols, nnz, F, dtype=None) -> Work:
    """C = A B over CSR: offsets, cols, vals and B (f32) read, C written;
    in bf16 mode the products are bf16's."""
    return Work(4 * (rows + 1) + 8 * nnz + 4 * F * (cols + rows),
                2 * nnz * F, _mode(dtype))


def bcsr_work(rows, cols, blocks, block_rows, nnz, F=None,
              dtype=None) -> Work:
    """BCSR SpMV (``F`` None) or SpMM over ``blocks`` stored blocks in
    ``block_rows`` block rows holding ``nnz`` values: the block columns,
    offsets and values, x or B read (in the stream type), y or C (f32)
    written; 2 flops per stored value and feature."""
    index = 4 * (blocks + block_rows + 1)
    if F is None:
        return Work(index + 4 * nnz + 4 * (cols + rows), 2 * nnz)
    es = 2 if _mode(dtype) else 4
    return Work(index + es * (nnz + F * cols) + 4 * F * rows, 2 * nnz * F,
                _mode(dtype))


def sddmm_flat_work(rows, cols, nnz, F) -> Work:
    """K5: offsets, cols, vals, A and B (f32, rounded in registers) read,
    out written; 2 flops per nonzero and feature."""
    return Work(4 * (rows + 1) + 12 * nnz + 4 * F * (rows + cols),
                2 * nnz * F)


def sddmm_bcsr_work(rows, cols, blocks, nnz, F) -> Work:
    """K10: block rows and columns, vals, A and B read, out written; 2
    flops per stored value and feature."""
    return Work(8 * blocks + 8 * nnz + 4 * F * (rows + cols), 2 * nnz * F)


def stream_read_work(nbytes) -> Work:
    """K11: every byte read once, one sum an element (counted as none)."""
    return Work(int(nbytes), 0)


def saxpy_work(n) -> Work:
    """K12: x and y read, out written (12 bytes an element), a product
    and a sum an element."""
    return Work(12 * n, 2 * n)


def edge_rows_work(edges, width, passes=1) -> Work:
    """A yardstick of the attention aggregations: ``passes`` reads of
    each edge's f32 row of ``width`` values (no flops counted)."""
    return Work(4 * edges * width * passes, 0)


def bound_of(work: Work, rate=None, floor=0.0):
    """``bound`` of one formula's work."""
    return bound(work.nbytes, work.flops, work.dtype, rate, floor)


# ------------------------------------------------------- the port's calls
# set by compiled_counters while it counts a call: each counted entry
# point of the port (``SpMVOperator``, ``SpMMOperator``, ``SDDMMOperator``
# and K12's ``saxpy*``) then hands its call to it, ``HOOK(work, call,
# *args)``, where ``work(*args)`` is the call's formula; None outside
HOOK = None


class _OpBytes(TorchDispatchMode):
    """Counts the tensor bytes read and written by the torch ops
    dispatched while it is on and not ``paused`` (views and allocations
    that fill nothing move none)."""

    FREE = (torch.ops.aten.empty.memory_format,
            torch.ops.aten.empty_like.default,
            torch.ops.aten.empty_strided.default,
            torch.ops.aten.detach.default, torch.ops.aten.lift_fresh.default)

    def __init__(self):
        super().__init__()
        self.paused = False
        self.nbytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.paused or func in self.FREE or func.is_view:
            return out
        # each tensor read once, each written once: an in-place op's
        # operand counts as both
        for side in ((args, kwargs), out):
            seen = set()
            for t in pytree.tree_leaves(side):
                if isinstance(t, torch.Tensor):
                    key = (t.untyped_storage().data_ptr(), t.storage_offset(),
                           t.numel(), t.dtype)
                    if key not in seen:
                        seen.add(key)
                        self.nbytes += t.numel() * t.element_size()
        return out


def compiled_counters(fn, *args, **kwargs) -> dict:
    """``{"flops", "bytes accessed", "dtype"}`` of one call ``fn(*args,
    **kwargs)``, or ``{}`` when nothing can be counted (no torch op and no
    counted entry point ran).

    ``fn`` runs once. Each counted entry point of the port it reaches
    (``fn`` itself too) adds its formula's work, and none of the torch
    ops it runs; every other torch op adds its flops and bytes. A kernel
    launched outside a counted entry point (K11, the probes, a bare
    ``_build.launch``) has no formula here: ``RuntimeError``, rather than
    counts short of its work. ``dtype`` is ``"bfloat16"`` when every
    formula counted runs in bf16 and nothing else does flops, else
    ``"float32"``. Counts do not nest, and count every thread's calls."""
    global HOOK
    from loops_tpu_torch.ops.kernels import _build

    if HOOK is not None:
        raise RuntimeError("compiled_counters is already counting a call")
    found = []  # (formula's work, flops of the torch ops it ran)
    covered = dict.fromkeys(_build.LAUNCHES, 0)
    flops_mode = FlopCounterMode(display=False)
    byte_mode = _OpBytes()

    def hook(work, call, *a):
        global HOOK
        flops0 = flops_mode.get_total_flops()
        launched = dict(_build.LAUNCHES)
        HOOK, byte_mode.paused = None, True  # an entry point inside one
        try:
            out = call(*a)
        finally:
            HOOK, byte_mode.paused = hook, False
        for k, n in launched.items():
            covered[k] += _build.LAUNCHES[k] - n
        found.append((work(*a), flops_mode.get_total_flops() - flops0))
        return out

    launched = dict(_build.LAUNCHES)
    HOOK = hook
    try:
        with flops_mode, byte_mode:
            fn(*args, **kwargs)
    finally:
        HOOK = None
    missed = {k: _build.LAUNCHES[k] - n - covered[k]
              for k, n in launched.items()
              if _build.LAUNCHES[k] - n != covered[k]}
    if missed:
        raise RuntimeError(
            f"compiled_counters: launches outside any counted entry point "
            f"({missed}); their work has no formula here")
    flops = flops_mode.get_total_flops() - sum(f for _, f in found)
    nbytes = byte_mode.nbytes
    bf16_only = bool(found) and flops == 0
    for w, _ in found:
        flops += w.flops
        nbytes += w.nbytes
        bf16_only = bf16_only and w.dtype == BF16
    if not (flops or nbytes):
        return {}
    return Work(int(nbytes), int(flops), BF16 if bf16_only else F32).counters()


def achieved(counters: dict, ms: float, hbm_gbps: float | None = None,
             peak_tflops: float | None = None) -> dict:
    """Achieved rates and utilization from counters and a time in ms:
    ``achieved_gbps``, ``hbm_utilization``, ``achieved_gflops`` and
    ``mxu_utilization`` (the JAX module's keys; here the share of the
    peak of the work's type, on the CUDA cores in f32 and the tensor cores
    in bf16). The rates default to 3.35 TB/s and that peak."""
    out = {}
    secs = ms * 1e-3
    if secs <= 0 or not counters:
        return out
    flops = float(counters.get("flops", 0.0))
    byts = float(counters.get("bytes accessed", 0.0))
    if hbm_gbps is None:
        hbm_gbps = HBM_BYTES_PER_S / 1e9
    if peak_tflops is None:
        peak_tflops = PEAK_FLOPS[_mode(counters.get("dtype"))] / 1e12
    if byts:
        out["achieved_gbps"] = byts / secs / 1e9
        if hbm_gbps:
            out["hbm_utilization"] = out["achieved_gbps"] / hbm_gbps
    if flops:
        out["achieved_gflops"] = flops / secs / 1e9
        if peak_tflops:
            out["mxu_utilization"] = (out["achieved_gflops"]
                                      / (peak_tflops * 1e3))
    return out
