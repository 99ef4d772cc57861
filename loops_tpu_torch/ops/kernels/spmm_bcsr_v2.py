"""K8: BCSR SpMM over super-rows (``SpMMOperator(bcsr,
impl='pallas2')``).

Replaces ``loops_tpu/ops/kernels/spmm_bcsr_v2.py``
(``bcsr_spmm_pallas_v2``): one grid step owns a super-row of SUPER block
rows and a feature tile, walks the super-row's stored blocks in order
with double-buffered copies of each A block and its B tile, and
accumulates on chip; the output tile is written once.

The CUDA kernel (``csrc/bcsr.cu`` ``bcsr_spmm_v2_kernel``) keeps that
contract with one CTA of 256 threads per (super-row, feature tile):
``cp.async`` double-buffers the R x C block and the C x FT B tile into
shared memory, the f32 accumulator [SUPER * R, FT] sits in shared memory,
and each thread sums whole dot products over C for its (row, feature)
pairs, adding them in block order. SUPER is the TPU's 128 / R block rows
(128 output rows); FT is 64 columns, halved while the CTA's shared
memory, ``4 * SUPER*R*FT + 2 * es * (R*C + C*FT)`` bytes (es = 4 in f32,
2 in bf16), passes 227 KB: 104 KB at 8 x 128 blocks in f32.

What bounds it on an H100: 2 flops per stored value and feature on the
CUDA cores, and one B tile per (stored block, feature tile) from L2;
each FMA here reads its operands from shared memory.

``dtype="bfloat16"`` streams A and B in bf16 (rounded operands, products
exact in f32, f32 sums). Kept: ``R % 8 == 0`` and ``C % 128 == 0``.
"""
from __future__ import annotations

import numpy as np
import torch

from loops_tpu_torch.ops.kernels import _build
from loops_tpu_torch.ops.kernels.spmm_bcsr import (
    bcsr_spmm_plain,
    check_blocks,
    fit_feature_tile,
    stage_b,
    stream_type,
)
from loops_tpu_torch.ops.kernels.spmv_bcsr import stage
from loops_tpu_torch.utils.platform import ensure_platform


def tiles(R: int, C: int, T, super_rows: int | None, block_f: int) -> dict:
    """The card's SUPER, FT and shared-memory bytes for K8."""
    SUPER = super_rows or max(128 // R, 1)
    es = torch.empty(0, dtype=T).element_size()
    FT, smem = fit_feature_tile(
        block_f, lambda ft: 4 * SUPER * R * ft + 2 * es * (R * C + C * ft))
    return dict(SUPER=SUPER, FT=FT, smem=smem)


def bcsr_spmm_v2_cuda(b: dict, B: torch.Tensor, shape, t: dict,
                      dtype=None) -> torch.Tensor:
    """Launch K8 on the staged buffers: C [rows, F] float32."""
    dev = B.device
    if dev.type != "cuda":
        raise ValueError(f"bcsr_spmm_v2_cuda needs a CUDA tensor, got {dev}")
    rows, cols = shape
    nb, R, C = b["vals"].shape
    if R % 8 or C % 128:
        raise ValueError(f"K8 needs R%8==0 and C%128==0, got {R}x{C}")
    if B.dim() != 2 or B.shape[0] != cols:
        raise ValueError(f"B has shape {tuple(B.shape)}, expected "
                         f"[{cols}, F]")
    F = B.shape[1]
    nbr = -(-rows // R)
    _build.check(B, "B", torch.float32, dev)
    _build.check(b["vals"], "vals", stream_type(dtype), dev)
    _build.check(b["bcols"], "bcols", torch.int32, dev, nb)
    _build.check(b["brow"], "brow", torch.int32, dev, nb)
    _build.check(b["offsets"], "offsets", torch.int32, dev, nbr + 1)
    if -(-F // t["FT"]) > 65535:
        raise ValueError(f"F={F} needs more than 65535 feature tiles")
    out = torch.empty(rows, F, dtype=torch.float32, device=dev)
    if rows == 0 or F == 0:
        return out  # a grid of 0 blocks is not a launch
    Bk, ld = stage_b(B, dtype)
    _build.launch("loops_bcsr_spmm_v2", "bcsr_spmm_v2", dev, b["offsets"],
                  b["bcols"], b["brow"], b["vals"], Bk, out, nbr, R, C,
                  rows, cols, F, ld, t["SUPER"], t["FT"], int(Bk.dtype ==
                                                             torch.bfloat16),
                  t["smem"])
    return out


def bcsr_spmm_v2_plain(b: dict, B: torch.Tensor, shape,
                       dtype=None) -> torch.Tensor:
    """K8's plain version over the same buffers: the stream-type A blocks
    and B (rounded to bf16 in that mode), multiplied and summed in f32."""
    Bs = B.to(stream_type(dtype)).float()
    return bcsr_spmm_plain(dict(b, vals=b["vals"].float()), Bs, shape)


def bcsr_spmm_v2(bcsr, block_f: int = 512, super_rows: int | None = None,
                 dtype=None, device="cuda"):
    """Build ``(bufs, fn(bufs, B))`` for BCSR @ dense through K8; ``fn``
    runs K8 on a CUDA tensor and the plain version on a CPU tensor."""
    device = ensure_platform(device)
    check_blocks(bcsr)
    T = stream_type(dtype)
    R, C = bcsr.block_shape
    t = tiles(R, C, T, super_rows, block_f)
    shape = bcsr.shape
    bufs = stage(bcsr, device, T)
    bufs["brow"] = torch.from_numpy(
        bcsr.block_row_ids().astype(np.int32)).to(device)

    def fn(b, B):
        if B.device.type == "cpu":
            return bcsr_spmm_v2_plain(b, B, shape, dtype)
        return bcsr_spmm_v2_cuda(b, B, shape, t, dtype)
    fn.meta = dict(num_blocks=bcsr.num_blocks, **t)
    return bufs, fn
