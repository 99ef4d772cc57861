"""K8: BCSR SpMM over super-rows (``SpMMOperator(bcsr,
impl='pallas2')``).

Replaces ``loops_tpu/ops/kernels/spmm_bcsr_v2.py``
(``bcsr_spmm_pallas_v2``): one grid step owns a super-row of SUPER block
rows and a feature tile, walks the super-row's stored blocks in order
with double-buffered copies of each A block and its B tile, and
accumulates on chip; the output tile is written once. Its plan is the
block offsets, ``bcols`` and ``brow``, walked in storage order: no chunk
staging (that is K7's).

The CUDA kernel (``csrc/bcsr.cu`` ``bcsr_spmm_v2_kernel``) keeps that
contract with one CTA of 256 threads per (super-row, feature tile):
``cp.async`` double-buffers the R x C block into shared memory, and the
f32 accumulator [SUPER * R, FT + 4] sits in shared memory. A block's work
is K7's units (``spmm_bcsr_v3``): 8 rows x 16 features a warp, warp w on
feature group w % (FT / 16). In bf16 the block's C x FT B tile is
double-buffered beside it and the units are the transposed product on
``mma.sync`` m16n8k16 with f32 sums; in f32 they are IEEE ``fmaf`` over
8 x 4 register tiles whose eight column splits are summed across lanes
in a fixed order, each lane reading its float4s of B straight from L2,
8 rows in flight. Each (row, f) adds its blocks' sums in storage order.
FT is the widest of 16, 32, 64 and 128 columns up to ``block_f`` whose
CTA fits 227 KB. A super-row is one block row unless ``super_rows`` says
otherwise: on the card the B path and the super-rows were chosen by
measurement (PERF.md §6).

What bounds it on an H100: 2 flops per stored value and feature (IEEE f32
on the CUDA cores: 0.239 ms at the bench's 16384^2, F = 512 regime; bf16
on the tensor cores: bytes, 0.024 ms), far below what re-reading one B
tile per stored block costs: 4.00 GB of B from L2 an apply in f32, 2.00 GB
in bf16, which sets the time.

``dtype="bfloat16"`` streams A and B in bf16 (rounded operands, products
exact in f32, f32 sums). Kept: ``R % 8 == 0`` and ``C % 128 == 0``. The
staged buffers are checked once, at bind (``_build.staged_guard``), and
C is a ``torch.empty`` or a checked ``out=``: the kernel writes every
row.
"""
from __future__ import annotations

import numpy as np
import torch

from loops_tpu_torch.ops.kernels import _build
from loops_tpu_torch.ops.kernels.spmm_bcsr import (
    SMEM_LIMIT,
    bcsr_spmm_plain,
    check_blocks,
    stage_b,
    stream_type,
)
from loops_tpu_torch.ops.kernels.spmm_bcsr_v3 import UNIT, WARPS
from loops_tpu_torch.ops.kernels.spmv_bcsr import stage
from loops_tpu_torch.utils.platform import ensure_platform

def smem_bytes(R: int, C: int, T, SUPER: int, FT: int) -> int:
    """Shared memory of one K8 CTA: the f32 accumulator [SUPER*R][FT + 4]
    and two A blocks in the stream type ``T``, and in bf16 two B tiles
    (K7's row pads of 16 bytes); f32 reads B straight from L2."""
    acc = 4 * SUPER * R * (FT + 4)
    if T == torch.bfloat16:
        return acc + 2 * 2 * (R * (C + 8) + C * (FT + 8))
    return acc + 2 * 4 * R * C


def tiles(R: int, C: int, T, super_rows: int | None,
          block_f: int) -> dict:
    """The card's SUPER, FT and shared-memory bytes for K8: ``super_rows``
    block rows a super-row (one by default), FT the widest feature tile
    of ``16 * 2^k`` columns (k <= 3: a 16-column unit for each of up to 8
    warps) up to ``block_f`` whose CTA fits; ``ValueError`` if none
    does."""
    block_f = int(block_f)
    if block_f < UNIT or block_f % UNIT:
        raise ValueError(f"block_f={block_f}: K8's feature tile is a "
                         f"positive multiple of {UNIT} columns")
    SUPER = super_rows or 1
    ft = UNIT
    while 2 * ft <= min(block_f, WARPS * UNIT):
        ft *= 2
    while ft >= UNIT:
        smem = smem_bytes(R, C, T, SUPER, ft)
        if smem <= SMEM_LIMIT:
            return dict(SUPER=SUPER, FT=ft, smem=smem)
        ft //= 2
    raise ValueError(f"the tiles need {smem_bytes(R, C, T, SUPER, UNIT)} "
                     f"bytes of shared memory at a {UNIT}-column feature "
                     f"tile, past the {SMEM_LIMIT} one CTA may use: fewer "
                     "super rows or narrower blocks")


def check_staged(b: dict, t: dict, device) -> None:
    """Raise ``ValueError`` unless the staged buffers ``b`` are what K8
    reads: contiguous tensors on ``device`` of the matrix's sizes, the
    values in the stream type."""
    nb, R, C = t["num_blocks"], t["R"], t["C"]
    _build.check(b["vals"], "vals", stream_type(t["dtype"]), device,
                 nb * R * C)
    _build.check(b["bcols"], "bcols", torch.int32, device, nb)
    _build.check(b["brow"], "brow", torch.int32, device, nb)
    _build.check(b["offsets"], "offsets", torch.int32, device,
                 t["nbr"] + 1)


def bcsr_spmm_v2_cuda(b: dict, B: torch.Tensor, shape, t: dict,
                      dtype=None, staged_on=None, out=None) -> torch.Tensor:
    """Launch K8 on the staged buffers: C [rows, F] float32.
    ``staged_on``: the device on which ``check_staged`` has accepted ``b``
    (at bind); the buffers are then not checked again. ``out``: a float32
    [rows, F] tensor to write C into instead of a new ``torch.empty``
    (the kernel writes every row)."""
    if not B.is_cuda:
        raise ValueError(f"bcsr_spmm_v2_cuda needs a CUDA tensor, got "
                         f"{B.device}")
    rows, cols = shape
    dev = B.device if staged_on is None else staged_on
    R, C = t["R"], t["C"]
    if R % 8 or C % 128:
        raise ValueError(f"K8 needs R%8==0 and C%128==0, got {R}x{C}")
    if B.dim() != 2 or B.shape[0] != cols:
        raise ValueError(f"B has shape {tuple(B.shape)}, expected "
                         f"[{cols}, F]")
    F = B.shape[1]
    _build.check(B, "B", torch.float32, dev)
    if stream_type(dtype) != stream_type(t["dtype"]):
        raise ValueError(f"dtype={dtype!r}: the buffers were staged for "
                         f"dtype={t['dtype']!r}")
    if staged_on is None:
        check_staged(b, t, dev)
    if -(-F // t["FT"]) > 65535:
        raise ValueError(f"F={F} needs more than 65535 feature tiles")
    C_out = _build.output(out, (rows, F), dev)
    if rows == 0 or F == 0:
        return C_out  # a grid of 0 blocks is not a launch
    Bk, ld = stage_b(B, dtype)
    _build.launch("loops_bcsr_spmm_v2", "bcsr_spmm_v2", dev, b["offsets"],
                  b["bcols"], b["brow"], b["vals"], Bk, C_out, t["nbr"], R,
                  C, rows, cols, F, ld, t["SUPER"], t["FT"],
                  int(Bk.dtype == torch.bfloat16), t["smem"])
    return C_out


def bcsr_spmm_v2_plain(b: dict, B: torch.Tensor, shape,
                       dtype=None) -> torch.Tensor:
    """K8's plain version over the same buffers: the stream-type A blocks
    and B (rounded to bf16 in that mode), multiplied and summed in f32."""
    Bs = B.to(stream_type(dtype)).float()
    return bcsr_spmm_plain(dict(b, vals=b["vals"].float()), Bs, shape)


def bcsr_spmm_v2(bcsr, block_f: int = 512, super_rows: int | None = None,
                 dtype=None, device="cuda"):
    """Build ``(bufs, fn(bufs, B, out=None))`` for BCSR @ dense through
    K8; ``fn`` runs K8 on a CUDA tensor and the plain version on a CPU
    tensor."""
    device = ensure_platform(device)
    check_blocks(bcsr)
    T = stream_type(dtype)
    R, C = bcsr.block_shape
    t = tiles(R, C, T, super_rows, block_f)
    shape = bcsr.shape
    t.update(R=R, C=C, num_blocks=bcsr.num_blocks,
             nbr=-(-shape[0] // R), dtype=dtype)
    bufs = stage(bcsr, device, T)
    bufs["brow"] = torch.from_numpy(
        bcsr.block_row_ids().astype(np.int32)).to(device)
    staged_on = _build.staged_guard(bufs, t, check_staged)

    def fn(b, B, out=None):
        if B.device.type == "cpu":
            return bcsr_spmm_v2_plain(b, B, shape, dtype)
        return bcsr_spmm_v2_cuda(b, B, shape, t, dtype, staged_on(b), out)
    fn.staged_on = staged_on
    fn.meta = dict(t)
    return bufs, fn
