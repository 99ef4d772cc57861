"""K10: block SDDMM (``SDDMMOperator(bcsr, impl='pallas')``).

Replaces ``loops_tpu/ops/kernels/sddmm_bcsr.py`` (``bcsr_sddmm_pallas``):
for each stored block t at block row i and block column k,
``out[t] = vals[t] * (A[i*R:(i+1)*R, :] @ B[k*C:(k+1)*C, :]^T)``, an f32
``[NB, R, C]`` array, in IEEE f32 (never TF32), summed over all of F and
then scaled by vals once. Kept: ``R % 8 == 0`` and ``C % 128 == 0``, as
K7-K9 keep them.

The CUDA kernel (``csrc/sddmm.cu`` ``sddmm_bcsr_kernel``) works on groups
staged here at bind (``stage_groups``): the stored blocks sorted by block
column, storage order within a column, cut into groups of at most G
blocks of one column (G = ``ROWS`` // R). One CTA of 2 * ``ROWS`` threads
takes a group's rows by a 128-column slice of C and loads each B feature
tile of ``FT`` features once for its G blocks, double-buffered with
``cp.async`` beside the group's A rows; each thread keeps an 8 x 8
register tile of sums (rows 8 rg.., columns cg + 16 j), each an ``fmaf``
chain over F in order, then one product with vals, written to its own
``out[t]`` through the permutation. The TPU's innermost grid axis over
feature tiles is the CTA's own loop. What bounds it on an H100: 2 * R * C
* F flops per block on the CUDA cores; B is read from L2 once per group,
not once per block. ``block_f`` stays in the API; the card's feature
tile is its own (``FT``). The staged buffers are checked once, at bind
(``_build.staged_guard``), and out is a ``torch.empty`` or a checked
``out=``: the kernel writes every element of every block.

``sddmm_bcsr_plain`` is the plain version, and in the values' own type
(f32 or f64) also the operator's ``impl='xla'`` executor for BCSR.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from loops_tpu_torch.ops.kernels import _build
from loops_tpu_torch.ops.kernels.sddmm_flat import check_operands
from loops_tpu_torch.ops.kernels.spmm_bcsr import stage_b
from loops_tpu_torch.ops.kernels.spmv_bcsr import stage
from loops_tpu_torch.utils.platform import ensure_platform

LANES = 128
# A rows of a K10 CTA (G blocks of R rows) and its feature tile
# (csrc/sddmm.cu sddmm_bcsr_kernel's ROWS and FT)
ROWS = 64
FT = 32


def group_blocks(R: int) -> int:
    """G, the blocks of one block column a K10 CTA takes: as many R-row
    blocks as its ``ROWS`` rows hold, at least one."""
    return max(ROWS // R, 1)


def stage_groups(bcsr, G: int) -> tuple[np.ndarray, np.ndarray]:
    """``(perm, gptr)``: the stored blocks sorted by block column (storage
    order within a column), and the offsets into ``perm`` of groups of at
    most ``G`` blocks of one column, both int32."""
    bcol = np.asarray(bcsr.block_cols, np.int64)
    perm = np.argsort(bcol, kind="stable")
    col = bcol[perm]
    n = len(perm)
    run_start = np.ones(n, bool)
    run_start[1:] = col[1:] != col[:-1]
    run_id = np.cumsum(run_start) - 1
    pos = np.arange(n) - np.flatnonzero(run_start)[run_id]  # in its column
    gptr = np.append(np.flatnonzero(pos % G == 0), n)
    return perm.astype(np.int32), gptr.astype(np.int32)


def check_staged(b: dict, t: dict, device) -> None:
    """Raise ``ValueError`` unless the staged buffers ``b`` are what K10
    reads: contiguous tensors on ``device`` of the plan's sizes."""
    nb, R, C = t["num_blocks"], t["R"], t["C"]
    _build.check(b["vals"], "vals", torch.float32, device, nb * R * C)
    for name in ("brow", "bcols", "perm"):
        _build.check(b[name], name, torch.int32, device, nb)
    _build.check(b["gptr"], "gptr", torch.int32, device, t["groups"] + 1)


def sddmm_bcsr_cuda(b: dict, A: torch.Tensor, B: torch.Tensor, shape,
                    t: dict, staged_on=None, out=None) -> torch.Tensor:
    """Launch K10 on the staged buffers: out [NB, R, C] float32. ``t``:
    the bind's parameters (``fn.meta``). ``staged_on``: the device on
    which ``check_staged`` has accepted ``b`` (at bind); the buffers are
    then not checked again. ``out``: a float32 [NB, R, C] tensor to write
    into instead of a new ``torch.empty``."""
    if not A.is_cuda:
        raise ValueError(f"sddmm_bcsr_cuda needs a CUDA tensor, got "
                         f"{A.device}")
    dev = A.device if staged_on is None else staged_on
    nb, R, C = t["num_blocks"], t["R"], t["C"]
    if R % 8 or C % LANES:
        raise ValueError(f"K10 needs R%8==0 and C%128==0, got {R}x{C}")
    check_operands(A, B, shape)
    rows, cols = shape
    _build.check(A, "A", torch.float32, dev)
    _build.check(B, "B", torch.float32, dev)
    if staged_on is None:
        check_staged(b, t, dev)
    o = _build.output(out, (nb, R, C), dev)
    if nb == 0:
        return o  # a grid of 0 blocks is not a launch
    Ak, lda = stage_b(A, None)
    Bk, ldb = stage_b(B, None)
    _build.launch("loops_bcsr_sddmm_f32", "sddmm_bcsr", dev, b["gptr"],
                  b["perm"], b["brow"], b["bcols"], b["vals"], Ak, Bk, o,
                  t["groups"], t["G"], R, C, rows, cols, A.shape[1], lda,
                  ldb)
    return o


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
    """Build ``(bufs, fn(bufs, A, B, out=None))`` for block SDDMM through
    K10; ``fn`` runs K10 on CUDA tensors and the plain version on CPU
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
    G = group_blocks(R)
    perm, gptr = stage_groups(bcsr, G)
    bufs = stage_blocks(bcsr, device)
    bufs["perm"] = torch.from_numpy(perm).to(device)
    bufs["gptr"] = torch.from_numpy(gptr).to(device)
    t = dict(num_blocks=bcsr.num_blocks, R=R, C=C, groups=len(gptr) - 1,
             G=G, rows_per_cta=ROWS, FT=FT, block_f=int(block_f))
    staged_on = _build.staged_guard(bufs, t, check_staged)

    def fn(b, A, B, out=None):
        if A.device.type == "cpu":
            check_operands(A, B, shape)
            return sddmm_bcsr_plain(b, A, B, shape)
        return sddmm_bcsr_cuda(b, A, B, shape, t, staged_on(b), out)
    fn.staged_on = staged_on
    fn.meta = dict(t)
    return bufs, fn
