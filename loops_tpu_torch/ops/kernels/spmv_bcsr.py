"""K6: BCSR SpMV (``SpMVOperator(bcsr, impl='pallas')``).

Replaces ``loops_tpu/ops/kernels/spmv_bcsr.py`` (``bcsr_spmv_pallas``),
the register-accumulate block kernel (reference:
algorithms/spmv/bcsr_thread_mapped.cuh:36-123): ``y = A @ x`` in f32 for
a BCSR matrix, no scatter and no atomics.

What bounds it on an H100 is the bytes of the stored blocks, read once
from device memory (2 flops per 4-byte value): 64 MB at the bench's
32768^2 regime, past the 50 MB L2. One warp a block row, the first
design, kept one 4 KB block in flight a warp and waited, in the Poisson
tail of long block rows, on one load after another: 45.5% of its byte
bound from an empty L2 (PERF.md §6).

The CUDA kernel (``csrc/bcsr.cu`` ``bcsr_spmv_kernel``) balances the work
over the stored blocks instead. ``plan_runs`` packs whole block rows in
storage order into runs of at most ``RUN_BLOCKS`` blocks, one warp a
run; a block row longer than that is cut into runs of its own, whose
partial sums ``bcsr_spmv_seam_kernel`` adds in run order (no atomics).
A lane takes 4 neighbouring columns: float4 loads of ``vals`` (evict
first) and ``x``, two blocks' loads before their sums. Each row is a
lane's products, rounded to f32, added in block and column order, then
a fixed xor tree over the lanes: two applies are bitwise equal.

The plan is staged at bind with the BCSR arrays and checked there once
(``_build.staged_guard``); y is a ``torch.empty`` or a checked ``out=``:
the kernel writes every row, empty block rows as zeros.

Dropped with the TPU mechanism: the GROUP x KCH chunking, the staged
[nb_pad * R, C] slab with its pad blocks and dummy row, the 3-way bf16
split with the ones-contraction on the MXU, and the segment sum outside
the kernel. Kept: the refusals the design needs, ``R % 8 == 0``
(8-row register groups), ``C == 128`` (4 columns per lane) and f32
values.
"""
from __future__ import annotations

import numpy as np
import torch

from loops_tpu_torch.ops.kernels import _build
from loops_tpu_torch.utils.platform import ensure_platform

LANES = 128
# stored blocks a run (one warp) takes at most; <= 32, since a lane holds
# the block column of each
RUN_BLOCKS = 16


def check_blocks(bcsr) -> None:
    """Raise ``ValueError`` unless K6 takes the block shape and values."""
    R, C = bcsr.block_shape
    if R % 8 or C != LANES:
        raise ValueError(
            f"BCSR SpMV kernel K6 needs R%8==0 and C==128, got {R}x{C}")
    if np.dtype(bcsr.vals.dtype) != np.float32:
        raise ValueError("BCSR SpMV kernel K6 stages float32 values")


def stage(bcsr, device, dtype=None) -> dict:
    """The BCSR arrays as tensors on ``device``: block offsets and columns
    (int32), vals [nb, R, C] in ``dtype`` (default: the values' own)."""
    off, bcols, vals = bcsr.to_device(device)
    return dict(offsets=off, bcols=bcols,
                vals=vals if dtype is None else vals.to(dtype))


def plan_runs(offsets, run_blocks: int = RUN_BLOCKS):
    """K6's work split: ``(runs, splits)``, int32.

    ``runs`` [3, nruns + 1]: run w takes blocks ``runs[0, w]`` up to
    ``runs[0, w + 1]`` and walks block rows from ``runs[1, w]`` up to
    ``max(runs[1, w + 1], runs[1, w] + 1)``; ``runs[2, w]`` is its seam
    slot, -1 unless its block row is cut (``runs[2, nruns]``: the
    slots). Whole block rows are packed in storage order while a run holds
    at most ``run_blocks`` blocks, with the empty block rows after them;
    a longer block row is cut into runs of ``run_blocks`` of its own.
    ``splits`` [2, nsplit + 1]: each cut block row and its first slot
    (the last column: the number of block rows, the slots)."""
    off = np.asarray(offsets, dtype=np.int64)
    nbr, L = len(off) - 1, int(run_blocks)
    if not 1 <= L <= 32:
        raise ValueError(f"run_blocks={L}: K6 takes 1 to 32 blocks a run")
    run_t, run_b, slot, cut_row, cut_slot = [], [], [], [], []
    nslots = b = 0
    while b < nbr:
        t0, t1 = int(off[b]), int(off[b + 1])
        if t1 - t0 > L:
            cut_row.append(b)
            cut_slot.append(nslots)
            for t in range(t0, t1, L):
                run_t.append(t)
                run_b.append(b)
                slot.append(nslots)
                nslots += 1
            b += 1
        else:
            run_t.append(t0)
            run_b.append(b)
            slot.append(-1)
            # the block rows whose blocks end by t0 + L, empty ones after
            b = int(np.searchsorted(off, t0 + L, side="right")) - 1
    runs = np.array([run_t + [int(off[-1])], run_b + [nbr], slot + [nslots]],
                    dtype=np.int32)
    splits = np.array([cut_row + [nbr], cut_slot + [nslots]], dtype=np.int32)
    return runs, splits


def check_staged(b: dict, params: dict, device) -> None:
    """Raise ``ValueError`` unless the staged buffers ``b`` are what K6
    reads: contiguous int32/float32 tensors on ``device`` of the matrix's
    and the plan's sizes, ``vals`` 16-byte aligned (float4 loads)."""
    nb, R, C = params["num_blocks"], params["R"], params["C"]
    _build.check(b["vals"], "vals", torch.float32, device, nb * R * C)
    if b["vals"].data_ptr() % 16:
        raise ValueError("vals must be 16-byte aligned")
    _build.check(b["bcols"], "bcols", torch.int32, device, nb)
    _build.check(b["offsets"], "offsets", torch.int32, device,
                 params["nbr"] + 1)
    _build.check(b["runs"], "runs", torch.int32, device,
                 3 * (params["nruns"] + 1))
    _build.check(b["splits"], "splits", torch.int32, device,
                 2 * (params["nsplit"] + 1))


def plan_params(b: dict, shape) -> dict:
    """What K6's launch takes of the staged buffers, from their shapes."""
    nb, R, C = b["vals"].shape
    return dict(num_blocks=nb, R=R, C=C, nbr=-(-shape[0] // R),
                nruns=b["runs"].shape[-1] - 1,
                nsplit=b["splits"].shape[-1] - 1)


def bcsr_spmv_cuda(b: dict, x: torch.Tensor, shape, staged_on=None,
                   out=None, params=None) -> torch.Tensor:
    """Launch K6 on the staged buffers: y [rows] float32.
    ``staged_on``: the device on which ``check_staged`` has accepted ``b``
    (at bind, with ``params``); the buffers are then not checked again.
    ``out``: a float32 tensor of ``rows`` to write y into instead of a new
    ``torch.empty`` (the kernel writes every row)."""
    if not x.is_cuda:
        raise ValueError(f"bcsr_spmv_cuda needs a CUDA tensor, got "
                         f"{x.device}")
    rows, cols = shape
    dev = x.device if staged_on is None else staged_on
    if params is None:
        params = plan_params(b, shape)
    R, C = params["R"], params["C"]
    if R % 8 or C != LANES:
        raise ValueError(f"K6 needs R%8==0 and C==128, got {R}x{C}")
    _build.check(x, "x", torch.float32, dev, cols)
    if staged_on is None:
        check_staged(b, params, dev)
    y = _build.output(out, rows, dev)
    if rows == 0:
        return y  # a grid of 0 blocks is not a launch
    nruns, nsplit = params["nruns"], params["nsplit"]
    # a cut block row's partials, one slot (R values) a run at most
    seam = torch.empty(nruns * R, dtype=torch.float32, device=dev) \
        if nsplit else y
    _build.launch("loops_bcsr_spmv_f32", "bcsr_spmv", dev, b["offsets"],
                  b["bcols"], b["runs"], b["splits"], b["vals"], x, y, seam,
                  nruns, nsplit, R, rows, cols, int(x.data_ptr() % 16 == 0))
    return y


def bcsr_spmv_plain(b: dict, x: torch.Tensor, shape) -> torch.Tensor:
    """K6's plain PyTorch version over the same buffers, in their value
    type: x as C-wide segments per block, a batched einsum, then a sorted
    segment sum over the block rows (deterministic; no ``index_add_``)."""
    rows, cols = shape
    nb, R, C = b["vals"].shape
    nbc = -(-cols // C)
    xp = x.new_zeros(nbc * C)
    xp[:cols] = x
    xb = xp.view(nbc, C)[b["bcols"].long()]                 # [nb, C]
    prod = torch.einsum("brc,bc->br", b["vals"], xb)        # [nb, R]
    yb = torch.segment_reduce(prod, "sum",
                              lengths=torch.diff(b["offsets"].long()),
                              axis=0, unsafe=True)          # [nbr, R]
    return yb.reshape(-1)[:rows]


def stage_runs(bcsr, device, run_blocks: int = RUN_BLOCKS) -> dict:
    """K6's staged buffers: the BCSR arrays (``stage``) and its plan
    (``plan_runs``: ``runs``, ``splits``) as tensors on ``device``."""
    bufs = stage(bcsr, device)
    runs, splits = plan_runs(bcsr.block_offsets, run_blocks)
    bufs["runs"] = torch.from_numpy(runs).to(device)
    bufs["splits"] = torch.from_numpy(splits).to(device)
    return bufs


def bcsr_spmv(bcsr, device="cuda"):
    """Build ``(bufs, fn(bufs, x, out=None))`` for BCSR @ vector through
    K6; ``fn`` runs K6 on a CUDA tensor and the plain version on a CPU
    tensor. The buffers (``stage_runs``) are checked once here on a
    card."""
    device = ensure_platform(device)
    check_blocks(bcsr)
    shape = bcsr.shape
    bufs = stage_runs(bcsr, device)
    params = plan_params(bufs, shape)
    staged_on = _build.staged_guard(bufs, params, check_staged)

    def fn(b, x, out=None):
        if x.device.type == "cpu":
            return bcsr_spmv_plain(b, x, shape)
        return bcsr_spmv_cuda(b, x, shape, staged_on(b), out, params)
    fn.params = params
    fn.staged_on = staged_on
    fn.meta = dict(num_blocks=bcsr.num_blocks, block_shape=bcsr.block_shape,
                   run_blocks=RUN_BLOCKS, runs=params["nruns"],
                   cut_block_rows=params["nsplit"])
    return bufs, fn
