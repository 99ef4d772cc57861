"""K5: flat CSR SDDMM with bf16 operands (``SDDMMOperator(csr,
impl='pallas', dtype='bfloat16')``).

Replaces ``loops_tpu/ops/kernels/sddmm_flat.py`` (``flat_sddmm_pallas``):
per CSR nonzero e, in storage order,
``out[e] = sum_f bf16(A[row_e, f]) * bf16(vals_e * bf16(B[col_e, f]))``,
f32 products and sums, an f32 ``[nnz]`` array. The rounding is the TPU
kernel's (vals folded into the gathered B row, then rounded to bf16), not
the XLA path's ``vals * sum bf16(A) * bf16(B)``.

The plan is the TPU kernel's, ``FlatBlockPlan.work_oriented`` with
``block_atoms`` (1024) atoms per block: every block but the last holds
exactly K atoms, so staged slot b*K + s is atom e and the output needs no
scatter. cols and vals are staged through ``plan.gather``; the row of
slot s of block b is ``tile_starts[b] + rel_tile[b, s]``.

The CUDA kernel (``csrc/sddmm.cu`` ``sddmm_flat_kernel``) gives a group
of G lanes to each atom (G the power of two, 4 to 32, that covers F in
VEC-wide pieces; VEC = 4 with 16-byte loads when F % 4 == 0 and A and B
are 16-byte aligned); each lane rounds its pieces of the A and B rows to
bf16 in registers, folds vals in, sums its products in order, and a fixed
xor-shuffle tree sums the group. What bounds it on an H100: the bytes of
the A and B rows, F * 8 per nonzero (f32 read, rounded in registers).

Dropped with the TPU mechanism: the A windows (16-row-aligned DMA bases,
their clamping, the power-of-two RW), the ``rw_cap`` and "fewer than RW
rows" refusals, GROUP padding, the one-hot MXU expansion, the eye-mask
transposes and the materialized ``gb`` array, so the card has no envelope
and ``rw_cap`` is not an argument here.
"""
from __future__ import annotations

import numpy as np
import torch

from loops_tpu_torch.layout import CsrLayout
from loops_tpu_torch.ops.kernels import _build
from loops_tpu_torch.schedule.plans import FlatBlockPlan
from loops_tpu_torch.utils.platform import ensure_platform

WARP = 32


def lane_group(F: int, vec: int) -> int:
    """Lanes per atom: the power of two at or above ``F / vec`` pieces,
    from 4 to 32."""
    g = 4
    while g < WARP and g * vec < F:
        g *= 2
    return g


def _vec(F: int, *tensors) -> int:
    """4 (16-byte loads) when every row starts 16-byte aligned, else 1."""
    aligned = F % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors)
    return 4 if aligned else 1


def check_operands(A, B, shape):
    """Raise ``ValueError`` unless A is [rows, F] and B [cols, F]."""
    rows, cols = shape
    if A.dim() != 2 or B.dim() != 2 or A.shape[0] != rows \
            or B.shape[0] != cols or A.shape[1] != B.shape[1]:
        raise ValueError(f"A {tuple(A.shape)} and B {tuple(B.shape)} do not "
                         f"fit a {rows}x{cols} matrix: expected [{rows}, F] "
                         f"and [{cols}, F]")


def sddmm_flat_cuda(b: dict, A: torch.Tensor, B: torch.Tensor, shape,
                    nnz: int) -> torch.Tensor:
    """Launch K5 on the staged buffers: out [nnz] float32."""
    dev = A.device
    if dev.type != "cuda":
        raise ValueError(f"sddmm_flat_cuda needs a CUDA tensor, got {dev}")
    check_operands(A, B, shape)
    F = A.shape[1]
    nb = b["tile_starts"].numel() - 1
    K = b["vals"].numel() // max(nb, 1)
    _build.check(A, "A", torch.float32, dev)
    _build.check(B, "B", torch.float32, dev)
    _build.check(b["vals"], "vals", torch.float32, dev, nb * K)
    _build.check(b["cols"], "cols", torch.int32, dev, nb * K)
    _build.check(b["rel"], "rel", torch.int32, dev, nb * K)
    _build.check(b["tile_starts"], "tile_starts", torch.int32, dev)
    if not 0 <= nnz <= nb * K:
        raise ValueError(f"nnz={nnz} does not fit {nb} blocks of {K} slots")
    out = torch.empty(nnz, dtype=torch.float32, device=dev)
    if nnz == 0:
        return out  # nothing to launch (sddmm_flat.py:72-77)
    vec = _vec(F, A, B)
    _build.launch("loops_sddmm_flat", "sddmm_flat", dev, b["vals"],
                  b["cols"], b["rel"], b["tile_starts"], A, B, out, nnz, K, F,
                  vec, lane_group(F, vec))
    return out


def slot_rows(b: dict) -> torch.Tensor:
    """The row of every staged slot, ``tile_starts[b] + rel[b, s]``, flat
    (int64)."""
    ts = b["tile_starts"].long()
    nb = ts.numel() - 1
    return (ts[:-1, None] + b["rel"].long().view(nb, -1)).reshape(-1)


def sddmm_flat_plain(b: dict, A: torch.Tensor, B: torch.Tensor,
                     nnz: int) -> torch.Tensor:
    """K5's plain PyTorch version over the same staged buffers: the first
    ``nnz`` slots are the atoms in storage order; bf16-rounded A rows
    times bf16(vals * bf16(B rows)), summed over F in f32."""
    bf = torch.bfloat16
    rows = slot_rows(b)[:nnz]
    cols = b["cols"][:nnz].long()
    v = b["vals"][:nnz].float()
    a = A.to(bf).float()[rows]
    g = (v[:, None] * B.to(bf).float()[cols]).to(bf).float()
    return (a * g).sum(dim=1)


def sddmm_flat(csr, block_atoms: int = 1024, device="cuda"):
    """Build ``(bufs, fn(bufs, A, B))`` for the CSR pattern through K5;
    ``fn`` runs K5 on CUDA tensors and the plain version on CPU tensors.
    Values are staged as f32 (they are rounded to bf16 with B anyway)."""
    device = ensure_platform(device)
    K = int(block_atoms)
    if K < 1:
        raise ValueError(f"block_atoms={block_atoms}: expected >= 1")
    nnz = int(csr.nnz)
    if nnz >= 2**31 or csr.shape[0] >= 2**31:
        raise ValueError(f"{nnz} nonzeros: K5 stages int32 indices")
    shape = csr.shape
    plan = FlatBlockPlan.work_oriented(CsrLayout.from_csr(csr), block_atoms=K)
    arrays = dict(
        vals=plan.gather(csr.vals).astype(np.float32).ravel(),
        cols=plan.gather(csr.indices).astype(np.int32).ravel(),
        rel=plan.rel_tile.astype(np.int32).ravel(),
        tile_starts=plan.tile_starts.astype(np.int32),
    )
    bufs = {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}

    def fn(b, A, B):
        if A.device.type == "cpu":
            check_operands(A, B, shape)
            return sddmm_flat_plain(b, A, B, nnz)
        return sddmm_flat_cuda(b, A, B, shape, nnz)
    fn.meta = dict(num_blocks=plan.num_blocks, K=K, nnz=nnz)
    return bufs, fn
