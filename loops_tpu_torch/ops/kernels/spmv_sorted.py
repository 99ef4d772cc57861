"""K1: the sorted-flat CSR SpMV kernel (``schedule='sorted_flat'``, and
``'auto'`` for all but extreme-skew matrices).

Replaces ``loops_tpu/ops/kernels/spmv_sorted.py`` (``sorted_spmv_plan``,
``sorted_spmv_bind``, ``sorted_spmv_pallas``). What crosses over is the
host plan's block cuts and the per-row f32 sums inside each block:

1.  **Merge-path blocks** of at most ``block_atoms`` atoms, split further
    so no block spans more than ``ROW_SPAN`` rows or crosses a
    ``STRIPE_ROWS`` row stripe — the same cuts as the reference plan.
2.  **Per-row sums inside a block**, in f32 (``csrc/spmv.cu``
    ``sorted_spmv_kernel``): the block's products ``vals * x[cols]`` go
    to shared memory first, then a group of lanes sums each row; the
    first and last row of each block go through the deterministic seam
    pass.

What does not cross over: the column sort and chunking, the Benes
unpermute, the touch-loop gathers and ``bucketed=`` all exist because the
TPU has no general gather and compiles per static shape; Hopper gathers
``x[col]`` natively and launches at any shape. Nor do the refusals that
bounded VMEM or the Mosaic compile (degenerate shape, ``x_sublanes_cap``,
``span_cap``, ``pad_cap``). The one bound kept is shared memory: a block's
products, ``block_atoms`` floats, fit one CTA (``MAX_BLOCK_ATOMS``).
Whether a column sort helps L2 locality on the H100 is open (ROADMAP).

What bounds K1 on an H100 is the ``x[col]`` gather, one random L2 sector
per nonzero: the kernel streams each block's values and columns as
16-byte pieces, independent of row boundaries, with several gathers in
flight per thread, and only then sums rows from shared memory. It writes
every row of y (the empty rows between blocks too), so y is allocated
with ``torch.empty``.

The plan/bind split mirrors the reference's preprocess-vs-kernel
separation (merge_path_flat.cuh:97-138): ``sorted_spmv_plan`` is pure
host numpy and reports its cost as ``plan_ms``; ``sorted_spmv_bind``
stages it on a device and, on a card, checks the staged buffers once, so
an apply checks only ``x``.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from loops_tpu_torch.ops.kernels import _build
from loops_tpu_torch.utils.platform import ensure_platform

LANES = 128
ROW_WINDOW = 1024             # the reference's output row window
ROW_SPAN = ROW_WINDOW - LANES   # max block row span, as in the reference
STRIPE_ROWS = 32768           # no block crosses a stripe, as in the reference
# a block's products live in one CTA's shared memory (227 KB on an H100)
MAX_BLOCK_ATOMS = 49152
# the block K1 builds by default: on an H100, 1024 atoms ran faster than
# 2048 up to 16384 on both bench_32768 and big_2097152 (a smaller
# products buffer leaves more of the SM's 256 KB to L1, which holds the
# bench matrix's 128 KB x; PERF.md section 6)
BLOCK_ATOMS = 1024


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def lanes_for(mean: float) -> int:
    """The lanes that sum one row (K1) or row run (K3) from shared memory:
    the power of two at or above ``mean``, the mean length of the
    nonempty rows or runs, at most a warp."""
    return int(min(32, 1 << max(int(np.ceil(np.log2(max(mean, 1.0)))), 0)))


# the arrays of a K1 plan that the plan derives (cached by io/plan_cache);
# the rest are the matrix's own (matrix_arrays)
PLAN_ARRAYS = ("cuts", "row_first", "row_last")
# what they derive from, besides the shape: the key of a cached K1 plan
PLAN_KEY_ARRAYS = ("offsets",)


def matrix_arrays(csr) -> dict:
    """The CSR's arrays as K1 stages them: int32 offsets and columns,
    f32 values."""
    return dict(offsets=csr.offsets.astype(np.int32),
                cols=csr.indices.astype(np.int32),
                vals=csr.vals.astype(np.float32))


def sorted_spmv_plan(csr, *, block_atoms: int = BLOCK_ATOMS):
    """Host planning: returns ``(arrays, params)`` — pure numpy."""
    t0 = time.perf_counter()
    if not 1 <= block_atoms <= MAX_BLOCK_ATOMS:
        raise ValueError(f"block_atoms={block_atoms}: K1 holds a block's "
                         f"products in shared memory, 1 to "
                         f"{MAX_BLOCK_ATOMS} atoms")
    rows, cols_n = csr.shape
    N = int(csr.nnz)
    if N == 0:
        return {}, dict(empty=True, rows=rows, cols_n=cols_n, num_blocks=0,
                        plan_ms=(time.perf_counter() - t0) * 1e3)
    K = int(block_atoms)
    offsets = csr.offsets.astype(np.int64)
    rid = np.repeat(np.arange(rows, dtype=np.int64), np.diff(offsets))

    # ---- block cuts: merge-path atoms, K-cap, row-span + stripe ----
    ST = max(ROW_WINDOW, min(STRIPE_ROWS, _round_up(rows, ROW_WINDOW)))
    ST = _round_up(ST, ROW_WINDOW)
    cuts = np.arange(0, N + K, K, dtype=np.int64)
    st_bounds = np.arange(ST, rows, ST, dtype=np.int64)
    cuts = np.unique(np.concatenate([cuts, offsets[st_bounds], [0, N]]))
    cuts = cuts[cuts <= N]
    extra = [np.arange(a, b, K, dtype=np.int64)
             for a, b in zip(cuts[:-1], cuts[1:]) if b - a > K]
    if extra:
        cuts = np.unique(np.concatenate([cuts, *extra]))
    for _ in range(64):  # split row spans > ROW_SPAN (terminates: each
        r0 = rid[cuts[:-1]]                  # new cut strictly interior
        r1 = rid[cuts[1:] - 1]
        bad = np.nonzero(r1 - r0 > ROW_SPAN)[0]
        if not len(bad):
            break
        cuts = np.unique(np.concatenate(
            [cuts, offsets[r0[bad] + ROW_SPAN]]))

    lanes = lanes_for(N / max(int(np.count_nonzero(np.diff(offsets))), 1))
    arrays = dict(
        **matrix_arrays(csr),
        cuts=cuts.astype(np.int32),
        row_first=rid[cuts[:-1]].astype(np.int32),
        row_last=rid[cuts[1:] - 1].astype(np.int32),
    )
    params = dict(empty=False, rows=rows, cols_n=cols_n,
                  num_blocks=len(cuts) - 1, block_atoms=K, ST=ST,
                  lanes_per_row=lanes, max_atoms=int(np.diff(cuts).max()),
                  plan_ms=(time.perf_counter() - t0) * 1e3)
    return arrays, params


def check_staged(b: dict, params: dict, device) -> None:
    """Raise ``ValueError`` unless the staged buffers ``b`` are what K1
    reads: contiguous int32/float32 tensors on ``device`` of the plan's
    sizes."""
    nb = int(params["num_blocks"])
    _build.check(b["offsets"], "offsets", torch.int32, device,
                 int(params["rows"]) + 1)
    _build.check(b["cols"], "cols", torch.int32, device, b["vals"].numel())
    _build.check(b["vals"], "vals", torch.float32, device)
    _build.check(b["cuts"], "cuts", torch.int32, device, nb + 1)
    _build.check(b["row_first"], "row_first", torch.int32, device, nb)
    _build.check(b["row_last"], "row_last", torch.int32, device, nb)


# the guard of the staged buffers, shared with K2 and K3
staged_fingerprint = _build.staged_fingerprint
staged_unchanged = _build.staged_unchanged


def sorted_spmv_cuda(b: dict, x: torch.Tensor, params: dict,
                     staged_on=None, out=None) -> torch.Tensor:
    """Launch K1 (``csrc/spmv.cu`` ``sorted_spmv_kernel`` + seam pass).
    ``staged_on``: the device on which ``check_staged`` has accepted ``b``
    (at bind); the buffers are then not checked again, and ``x`` must lie
    there too. ``out``: a float32 tensor of ``rows`` to write y into
    instead of a new ``torch.empty`` (the kernel writes every row, which a
    NaN-filled ``out`` shows)."""
    if not x.is_cuda:
        raise ValueError(f"sorted_spmv_cuda needs a CUDA tensor, got "
                         f"{x.device}")
    dev = x.device if staged_on is None else staged_on
    _build.check(x, "x", torch.float32, dev, params["cols_n"])
    if staged_on is None:
        check_staged(b, params, dev)
    nb = params["num_blocks"]
    y = _build.output(out, params["rows"], dev)
    seam = torch.empty(2 * nb, dtype=torch.float32, device=dev)
    _build.launch("loops_sorted_spmv_f32", "sorted_spmv", dev,
                  b["offsets"], b["cols"], b["vals"], b["cuts"],
                  b["row_first"], b["row_last"], x, y, seam, params["rows"],
                  nb, params["lanes_per_row"], params["max_atoms"])
    return y


def sorted_spmv_plain(b: dict, x: torch.Tensor, params: dict) -> torch.Tensor:
    """K1's plain PyTorch version over the same staged buffers: per-row
    f32 segment sums of ``vals * x[cols]`` over the CSR offsets."""
    prod = b["vals"] * x.to(torch.float32)[b["cols"]]
    return torch.segment_reduce(prod, "sum", offsets=b["offsets"].long(),
                                unsafe=True)


def sorted_spmv_bind(arrays, params, device):
    """Turn a plan into ``(bufs, fn)`` on ``device``; ``fn(bufs, x)``."""
    rows = int(params["rows"])
    if params.get("empty"):
        def fn(b, x):
            return torch.zeros(rows, dtype=torch.float32, device=x.device)
        bufs = {}
    else:
        bufs = {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}
        staged_on = _build.staged_guard(bufs, params, check_staged)

        def fn(b, x):
            if x.is_cpu:
                return sorted_spmv_plain(b, x, params)
            return sorted_spmv_cuda(b, x, params, staged_on(b))
    # the plan's parameters, for a caller of sorted_spmv_cuda on these
    # buffers
    fn.params = params
    fn.meta = dict(num_blocks=params["num_blocks"],
                   block_atoms=params.get("block_atoms"),
                   lanes_per_row=params.get("lanes_per_row"),
                   # host planning cost, excluding the device upload —
                   # the reference's preprocess-vs-kernel separation
                   # (merge_path_flat.cuh:97-138); for a plan from the
                   # cache, the load time, with the build's beside it
                   plan_ms=params["plan_ms"],
                   plan_source=params.get("plan_source", "built"),
                   built_plan_ms=params.get("built_plan_ms",
                                            params["plan_ms"]),
                   # hashing the shape and offsets into the cache's key
                   key_ms=params.get("key_ms"))
    return bufs, fn


def sorted_spmv(csr, *, block_atoms: int = BLOCK_ATOMS, device="cuda",
                cache_dir=None):
    """Build ``(bufs, fn)`` for CSR @ vector through K1.

    ``cache_dir``: a directory of the plan cache (``io/plan_cache.py``),
    keyed by the matrix's shape and row offsets, from which the plan
    derives, and ``block_atoms``. On a hit the host plan is loaded, not
    built, and ``fn.meta`` has ``plan_source`` 'cache' and ``plan_ms``
    the load time; on a miss the plan is built and saved (``plan_source``
    'built'). The cache holds the arrays the plan derives
    (``PLAN_ARRAYS``) and its parameters; the matrix's own arrays are the
    caller's CSR at every bind."""
    device = ensure_platform(device)
    if cache_dir is None:
        arrays, params = sorted_spmv_plan(csr, block_atoms=block_atoms)
        return sorted_spmv_bind(arrays, params, device)
    from loops_tpu_torch.io.plan_cache import plan_cache_get_or_build

    built = {}

    def build():
        arrays, params = sorted_spmv_plan(csr, block_atoms=block_atoms)
        built.update(arrays)
        return {k: arrays[k] for k in PLAN_ARRAYS if k in arrays}, params
    arrays, params = plan_cache_get_or_build(
        cache_dir, csr, dict(block_atoms=int(block_atoms)), build,
        arrays=PLAN_KEY_ARRAYS)
    if built:
        arrays = built
    elif not params.get("empty"):
        arrays = {**matrix_arrays(csr), **arrays}
    return sorted_spmv_bind(arrays, params, device)
