"""K6: BCSR SpMV (``SpMVOperator(bcsr, impl='pallas')``).

Replaces ``loops_tpu/ops/kernels/spmv_bcsr.py`` (``bcsr_spmv_pallas``),
the register-accumulate block kernel (reference:
algorithms/spmv/bcsr_thread_mapped.cuh:36-123): ``y = A @ x`` in f32 for
a BCSR matrix, each block row written once, no scatter and no atomics.

The CUDA kernel (``csrc/bcsr.cu`` ``bcsr_spmv_kernel``) gives one warp to
each block row: lanes over the 128 columns of a block, 8 row partials per
lane in registers, the row's blocks walked in storage order, then a fixed
shuffle tree per row. What bounds it on an H100 is the bytes of the stored
blocks, read once (2 flops per 4-byte value); x is read as one 128-wide
segment per block.

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


def bcsr_spmv_cuda(b: dict, x: torch.Tensor, shape) -> torch.Tensor:
    """Launch K6 on the staged buffers: y [rows] float32."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"bcsr_spmv_cuda needs a CUDA tensor, got {dev}")
    rows, cols = shape
    nb, R, C = b["vals"].shape
    if R % 8 or C != LANES:
        raise ValueError(f"K6 needs R%8==0 and C==128, got {R}x{C}")
    nbr = -(-rows // R)
    _build.check(x, "x", torch.float32, dev, cols)
    _build.check(b["vals"], "vals", torch.float32, dev)
    _build.check(b["bcols"], "bcols", torch.int32, dev, nb)
    _build.check(b["offsets"], "offsets", torch.int32, dev, nbr + 1)
    y = torch.empty(rows, dtype=torch.float32, device=dev)
    if rows == 0:
        return y  # a grid of 0 blocks is not a launch
    _build.launch("loops_bcsr_spmv_f32", "bcsr_spmv", dev, b["offsets"],
                  b["bcols"], b["vals"], x, y, nbr, R, rows, cols)
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


def bcsr_spmv(bcsr, device="cuda"):
    """Build ``(bufs, fn(bufs, x))`` for BCSR @ vector through K6; ``fn``
    runs K6 on a CUDA tensor and the plain version on a CPU tensor."""
    device = ensure_platform(device)
    check_blocks(bcsr)
    shape = bcsr.shape
    bufs = stage(bcsr, device)

    def fn(b, x):
        if x.device.type == "cpu":
            return bcsr_spmv_plain(b, x, shape)
        return bcsr_spmv_cuda(b, x, shape)
    fn.meta = dict(num_blocks=bcsr.num_blocks, block_shape=bcsr.block_shape)
    return bufs, fn
