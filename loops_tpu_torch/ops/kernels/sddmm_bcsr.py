"""K10: block SDDMM (``SDDMMOperator(bcsr, impl='pallas')``).

Replaces ``loops_tpu/ops/kernels/sddmm_bcsr.py`` (``bcsr_sddmm_pallas``):
for each stored block t at block row i and block column k,
``out[t] = vals[t] * (A[i*R:(i+1)*R, :] @ B[k*C:(k+1)*C, :]^T)``, an f32
``[NB, R, C]`` array, in IEEE f32 (never TF32), summed over all of F and
then scaled by vals once. Kept: ``R % 8 == 0`` and ``C % 128 == 0``, as
K7-K9 keep them.

The CUDA kernel (``csrc/sddmm.cu`` ``sddmm_bcsr_kernel``) gives one CTA of
128 threads to each (stored block, sub-tile of 16 or 8 rows x 128
columns); the TPU's innermost grid axis over feature tiles is the CTA's
own loop over 64-column tiles of A and B staged in shared memory, and
each thread keeps its column's sums in registers, so no output is
revisited. What bounds it on an H100: 2 * R * C * F flops per block on the
CUDA cores. ``block_f`` stays in the API; the card's feature tile is its
own (64).

``sddmm_bcsr_plain`` is the plain version, and in the values' own type
(f32 or f64) also the operator's ``impl='xla'`` executor for BCSR.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from loops_tpu_torch.ops.kernels import _build
from loops_tpu_torch.ops.kernels.sddmm_flat import check_operands
from loops_tpu_torch.ops.kernels.spmv_bcsr import stage
from loops_tpu_torch.utils.platform import ensure_platform

LANES = 128


def rows_per_cta(R: int) -> int:
    """Rows of the output sub-tile one K10 CTA sums: 16, or 8 when R is
    not a multiple of 16."""
    return 16 if R % 16 == 0 else 8


def sddmm_bcsr_cuda(b: dict, A: torch.Tensor, B: torch.Tensor,
                    shape) -> torch.Tensor:
    """Launch K10 on the staged buffers: out [NB, R, C] float32."""
    dev = A.device
    if dev.type != "cuda":
        raise ValueError(f"sddmm_bcsr_cuda needs a CUDA tensor, got {dev}")
    nb, R, C = b["vals"].shape
    if R % 8 or C % LANES:
        raise ValueError(f"K10 needs R%8==0 and C%128==0, got {R}x{C}")
    check_operands(A, B, shape)
    rows, cols = shape
    _build.check(A, "A", torch.float32, dev)
    _build.check(B, "B", torch.float32, dev)
    _build.check(b["vals"], "vals", torch.float32, dev)
    _build.check(b["brow"], "brow", torch.int32, dev, nb)
    _build.check(b["bcols"], "bcols", torch.int32, dev, nb)
    out = torch.empty(nb, R, C, dtype=torch.float32, device=dev)
    if nb == 0:
        return out  # a grid of 0 blocks is not a launch
    _build.launch("loops_bcsr_sddmm_f32", "sddmm_bcsr", dev, b["brow"],
                  b["bcols"], b["vals"], A, B, out, nb, R, C, rows, cols,
                  A.shape[1], rows_per_cta(R))
    return out


@contextlib.contextmanager
def _ieee_f32():
    """TF32 off for the products inside (PyTorch's default, set here so
    the plain version holds IEEE f32 whatever a caller set)."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def sddmm_bcsr_plain(b: dict, A: torch.Tensor, B: torch.Tensor,
                     shape) -> torch.Tensor:
    """The plain version over the same buffers, in their value type: the
    A and B tiles of every stored block gathered (rows past the matrix as
    zeros), one batched product, scaled by vals."""
    rows, cols = shape
    nb, R, C = b["vals"].shape
    F = A.shape[1]
    Ap = A.new_zeros(-(-rows // R) * R, F)
    Ap[:rows] = A
    Bp = B.new_zeros(-(-cols // C) * C, F)
    Bp[:cols] = B
    At = Ap.view(-1, R, F)[b["brow"].long()]          # [nb, R, F]
    Bt = Bp.view(-1, C, F)[b["bcols"].long()]         # [nb, C, F]
    with _ieee_f32():
        dots = torch.bmm(At, Bt.transpose(1, 2))      # [nb, R, C]
    return b["vals"] * dots


def stage_blocks(bcsr, device) -> dict:
    """The stored blocks on ``device``: block rows and columns (int32),
    vals [nb, R, C] in their own type."""
    b = stage(bcsr, device)
    del b["offsets"]
    b["brow"] = torch.from_numpy(bcsr.block_row_ids().astype(np.int32)).to(
        device)
    return b


def sddmm_bcsr(bcsr, block_f: int = 512, device="cuda"):
    """Build ``(bufs, fn(bufs, A, B))`` for block SDDMM through K10;
    ``fn`` runs K10 on CUDA tensors and the plain version on CPU
    tensors."""
    device = ensure_platform(device)
    R, C = bcsr.block_shape
    if R % 8 or C % LANES:
        raise ValueError(f"block SDDMM kernel K10 needs R%8==0 and "
                         f"C%128==0, got {R}x{C}")
    if np.dtype(bcsr.vals.dtype) != np.float32:
        raise ValueError("block SDDMM kernel K10 stages float32 values")
    if int(block_f) < 1:
        raise ValueError(f"block_f={block_f}: expected >= 1")
    shape = bcsr.shape
    bufs = stage_blocks(bcsr, device)

    def fn(b, A, B):
        if A.device.type == "cpu":
            check_operands(A, B, shape)
            return sddmm_bcsr_plain(b, A, B, shape)
        return sddmm_bcsr_cuda(b, A, B, shape)
    fn.meta = dict(num_blocks=bcsr.num_blocks, block_f=int(block_f),
                   rows_per_cta=rows_per_cta(bcsr.block_shape[0]))
    return bufs, fn
