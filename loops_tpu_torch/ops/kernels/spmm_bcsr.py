"""K9: BCSR SpMM, one block row at a time (``SpMMOperator(bcsr,
impl='pallas')``).

Replaces ``loops_tpu/ops/kernels/spmm_bcsr.py`` (``bcsr_spmm_pallas``):
``C[rows, F] = A(bcsr) @ B[cols, F]`` in f32, where the TPU kernel takes
one stored block per grid step and keeps the output tile resident while
the blocks of its row pass.

The CUDA kernel (``csrc/bcsr.cu`` ``bcsr_spmm_kernel``) gives one CTA of
128 threads to each (block row, group of 8 rows, feature tile of 512
columns). Thread i owns the 4 contiguous features 4i..4i+3 and keeps
8 rows x 4 features in registers. Each stored block of the row, in
storage order, is staged 8 x 128 at a time in shared memory, transposed
(a column's 8 values are two float4 every thread reads: a broadcast),
and B's rows come straight from L2 as 16-byte loads, 8 columns' loads in
flight before their 32 FMAs each; at 80 registers and 4 KB a CTA, 24
warps an SM keep enough of them in flight. Each output is one thread's
``fmaf`` chain over the row's blocks in storage order.

What bounds it on an H100: 2 flops per stored value and feature on the
CUDA cores (IEEE f32, no TF32), and B's rows read once per (stored
block, feature tile), from L2 when B fits its 50 MB: 4.00 GB at the
bench's 16384^2, F = 512 regime. Two redesigns measured slower on the
card and were not kept (PERF.md §6): B tiles staged in shared memory
by ``cp.async`` with 8 x 8 register tiles, and one B tile per column of a
group of block rows.

An empty block row's CTAs write its zeros, so the TPU's
``_pad_empty_rows`` (zero blocks inserted so every output tile is
visited) is dropped, with the TPU's B padding to 128-lane tiles. Kept:
``R % 8 == 0`` and ``C % 128 == 0``, f32 only. The staged buffers are
checked once, at bind (``_build.staged_guard``), and C is a
``torch.empty`` or a checked ``out=``: the kernel writes every row.

``bcsr_spmm_plain`` is the plain version, and in the values' own type
(f32 or f64) also the operators' ``impl='xla'`` executor for BCSR.
"""
from __future__ import annotations

import numpy as np
import torch

from loops_tpu_torch.ops.kernels import _build
from loops_tpu_torch.ops.kernels.spmm_flat import BF16
from loops_tpu_torch.ops.kernels.spmv_bcsr import stage
from loops_tpu_torch.utils.platform import ensure_platform

LANES = 128
# feature columns of one K9 CTA (csrc/bcsr.cu kK9Tile)
K9_TILE = 512


def check_blocks(bcsr) -> None:
    """Raise ``ValueError`` unless the BCSR SpMM kernels take the block
    shape (K7, K8 and K9 alike)."""
    R, C = bcsr.block_shape
    if R % 8 or C % LANES:
        raise ValueError(
            f"BCSR SpMM kernels need R%8==0 and C%128==0, got {R}x{C}")


def check_block_f(block_f: int) -> int:
    """``block_f``, the TPU kernel's feature tile, checked: a positive
    multiple of 128 lanes. K9's tile on the card is 512 columns
    (``K9_TILE``) whatever it is."""
    block_f = int(block_f)
    if block_f < LANES or block_f % LANES:
        raise ValueError(f"block_f={block_f}: K9's feature tile is a "
                         f"positive multiple of {LANES} columns")
    return block_f


def check_staged(b: dict, params: dict, device) -> None:
    """Raise ``ValueError`` unless the staged buffers ``b`` are what K9
    reads: contiguous int32/float32 tensors on ``device`` of the
    matrix's sizes."""
    nb, R, C = params["num_blocks"], params["R"], params["C"]
    _build.check(b["vals"], "vals", torch.float32, device, nb * R * C)
    _build.check(b["bcols"], "bcols", torch.int32, device, nb)
    _build.check(b["offsets"], "offsets", torch.int32, device,
                 params["nbr"] + 1)


def bcsr_spmm_cuda(b: dict, B: torch.Tensor, shape, staged_on=None,
                   out=None, params=None) -> torch.Tensor:
    """Launch K9 on the staged buffers: C [rows, F] float32.
    ``staged_on``: the device on which ``check_staged`` has accepted ``b``
    (at bind, with ``params``); the buffers are then not checked again.
    ``out``: a float32 [rows, F] tensor to write C into instead of a new
    ``torch.empty`` (the kernel writes every row)."""
    if not B.is_cuda:
        raise ValueError(f"bcsr_spmm_cuda needs a CUDA tensor, got "
                         f"{B.device}")
    rows, cols = shape
    dev = B.device if staged_on is None else staged_on
    if params is None:
        nb, R, C = b["vals"].shape
        params = dict(num_blocks=nb, R=R, C=C, nbr=-(-rows // R))
    R, C = params["R"], params["C"]
    if R % 8 or C % LANES:
        raise ValueError(f"K9 needs R%8==0 and C%128==0, got {R}x{C}")
    if B.dim() != 2 or B.shape[0] != cols:
        raise ValueError(f"B has shape {tuple(B.shape)}, expected "
                         f"[{cols}, F]")
    _build.check(B, "B", torch.float32, dev)
    if staged_on is None:
        check_staged(b, params, dev)
    F = B.shape[1]
    C_out = _build.output(out, (rows, F), dev)
    if rows == 0 or F == 0:
        return C_out  # a grid of 0 blocks is not a launch
    Bk, ld = stage_b(B, None)
    _build.launch("loops_bcsr_spmm_f32", "bcsr_spmm", dev, b["offsets"],
                  b["bcols"], b["vals"], Bk, C_out, params["nbr"], R, C,
                  rows, cols, F, ld)
    return C_out


def bcsr_spmm_plain(b: dict, B: torch.Tensor, shape) -> torch.Tensor:
    """The plain version over the same buffers, in their value type: the
    B tile of each stored block, a batched product, then a sorted segment
    sum over the block rows (deterministic; no ``index_add_``)."""
    rows, cols = shape
    nb, R, C = b["vals"].shape
    F = B.shape[1]
    nbc = -(-cols // C)
    Bp = B.new_zeros(nbc * C, F)
    Bp[:cols] = B
    prod = torch.bmm(b["vals"], Bp.view(nbc, C, F)[b["bcols"].long()])
    Cb = torch.segment_reduce(prod, "sum",
                              lengths=torch.diff(b["offsets"].long()),
                              axis=0, unsafe=True)          # [nbr, R, F]
    return Cb.reshape(-1, F)[:rows]


# --- shared by K7 and K8, whose CTAs keep tiles in shared memory
SMEM_LIMIT = 232448   # bytes of shared memory one H100 CTA may opt into


def stream_type(dtype):
    """The type K7/K8 stream A and B in: f32, or bf16 for ``dtype=
    'bfloat16'``."""
    if dtype not in (None, BF16):
        raise ValueError(f"dtype={dtype!r}: K7/K8 take None (f32) or "
                         f"{BF16!r}")
    return torch.bfloat16 if dtype == BF16 else torch.float32


def stage_b(B: torch.Tensor, dtype) -> tuple[torch.Tensor, int]:
    """``(B in the stream type, row pitch)``: a row pitch that is a whole
    number of 16-byte copies, and a 16-byte aligned base — B itself when
    it already is, else one padded copy."""
    T = stream_type(dtype)
    vec = 16 // torch.empty(0, dtype=T).element_size()
    F = B.shape[1]
    ld = -(-F // vec) * vec
    if B.dtype == T and ld == F and B.data_ptr() % 16 == 0:
        return B, ld
    return torch.nn.functional.pad(B.to(T), (0, ld - F)), ld


def bcsr_spmm(bcsr, block_f: int = 512, device="cuda"):
    """Build ``(bufs, fn(bufs, B, out=None))`` for BCSR @ dense through
    K9; ``fn`` runs K9 on a CUDA tensor and the plain version on a CPU
    tensor."""
    device = ensure_platform(device)
    check_blocks(bcsr)
    if np.dtype(bcsr.vals.dtype) != np.float32:
        raise ValueError("BCSR SpMM kernel K9 stages float32 values")
    check_block_f(block_f)
    shape = bcsr.shape
    R, C = bcsr.block_shape
    bufs = stage(bcsr, device)
    params = dict(num_blocks=bcsr.num_blocks, R=R, C=C,
                  nbr=-(-shape[0] // R))
    staged_on = _build.staged_guard(bufs, params, check_staged)

    def fn(b, B, out=None):
        if B.device.type == "cpu":
            return bcsr_spmm_plain(b, B, shape)
        return bcsr_spmm_cuda(b, B, shape, staged_on(b), out, params)
    fn.params = params
    fn.staged_on = staged_on
    fn.meta = dict(num_blocks=bcsr.num_blocks, block_f=block_f,
                   FT=K9_TILE)
    return bufs, fn
