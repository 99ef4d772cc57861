"""K5: flat CSR SDDMM with bf16 operands (``SDDMMOperator(csr,
impl='pallas', dtype='bfloat16')``).

Replaces ``loops_tpu/ops/kernels/sddmm_flat.py`` (``flat_sddmm_pallas``):
per CSR nonzero e, in storage order,
``out[e] = sum_f bf16(A[row_e, f]) * bf16(vals_e * bf16(B[col_e, f]))``,
f32 products and sums, an f32 ``[nnz]`` array. The rounding is the TPU
kernel's (vals folded into the gathered B row, then rounded to bf16), not
the XLA path's ``vals * sum bf16(A) * bf16(B)``.

The row ids, columns and values are staged as the CSR stores them (int32,
int32, f32): the TPU kernel's work-oriented plan and its A windows have no
work to do on the card. The CUDA kernel (``csrc/sddmm.cu``
``sddmm_flat_kernel``) gives a group of G lanes (the power of two, 1 to
32, that covers F in VEC-wide pieces) runs of 4 consecutive nonzeros, and
issues all of a run's row gathers, and the next run's index loads, before
it uses any; lane j sums pieces j, j+G, ... of each product in order, and
a fixed xor-shuffle tree sums the group. What bounds it on an H100: the
latency of those gathers (the first port's one nonzero in flight per
group ran at 0.28 ns per nonzero), then their bytes.

The wrapper makes one bf16 copy of A and of B per call (inside the call,
and so inside its time), and the kernel gathers 16-byte pieces of 8
values of those: half the bytes of an f32 row, and the rounding of A and
B done once. Gathering the f32 rows and rounding them in registers was
slower on the card (PERF.md has the times).
"""
from __future__ import annotations

import numpy as np
import torch

from loops_tpu_torch.ops.kernels import _build
from loops_tpu_torch.utils.platform import ensure_platform

WARP = 32


def lane_group(F: int, vec: int) -> int:
    """Lanes per nonzero: the power of two at or above ``F / vec``
    pieces, from 1 to 32."""
    g = 1
    while g < WARP and g * vec < F:
        g *= 2
    return g


def piece_width(F: int) -> int:
    """bf16 values per piece: the widest of 8, 4 and 2 (16, 8 and 4
    bytes) that divides the row, else 1 (the copies start 16-byte
    aligned)."""
    vec = 8
    while vec > 1 and F % vec:
        vec //= 2
    return vec


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
    _build.check(A, "A", torch.float32, dev)
    _build.check(B, "B", torch.float32, dev)
    for name, dtype in (("rows", torch.int32), ("cols", torch.int32),
                        ("vals", torch.float32)):
        _build.check(b[name], name, dtype, dev, nnz)
    out = torch.empty(nnz, dtype=torch.float32, device=dev)
    if nnz == 0:
        return out  # nothing to launch (sddmm_flat.py:72-77)
    A16, B16 = A.to(torch.bfloat16), B.to(torch.bfloat16)
    vec = piece_width(F)
    _build.launch("loops_sddmm_flat", "sddmm_flat", dev, b["rows"],
                  b["cols"], b["vals"], A16, B16, out, nnz, F, vec,
                  lane_group(F, vec))
    return out


def sddmm_flat_plain(b: dict, A: torch.Tensor, B: torch.Tensor,
                     nnz: int) -> torch.Tensor:
    """K5's plain PyTorch version over the same staged buffers:
    bf16-rounded A rows times bf16(vals * bf16(B rows)), summed over F in
    f32."""
    bf = torch.bfloat16
    rows, cols = b["rows"][:nnz].long(), b["cols"][:nnz].long()
    v = b["vals"][:nnz].float()
    a = A.to(bf).float()[rows]
    g = (v[:, None] * B.to(bf).float()[cols]).to(bf).float()
    return (a * g).sum(dim=1)


def sddmm_flat(csr, device="cuda"):
    """Build ``(bufs, fn(bufs, A, B))`` for the CSR pattern through K5;
    ``fn`` runs K5 on CUDA tensors and the plain version on CPU tensors.
    Values are staged as f32 (they are rounded to bf16 with B anyway)."""
    device = ensure_platform(device)
    nnz = int(csr.nnz)
    if nnz >= 2**31 or csr.shape[0] >= 2**31:
        raise ValueError(f"{nnz} nonzeros: K5 stages int32 indices")
    shape = csr.shape
    arrays = dict(rows=csr.row_ids().astype(np.int32),
                  cols=np.asarray(csr.indices).astype(np.int32),
                  vals=np.asarray(csr.vals).astype(np.float32))
    bufs = {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}

    def fn(b, A, B):
        if A.device.type == "cpu":
            check_operands(A, B, shape)
            return sddmm_flat_plain(b, A, B, nnz)
        return sddmm_flat_cuda(b, A, B, shape, nnz)
    fn.meta = dict(nnz=nnz)
    return bufs, fn
