"""K3: flat balanced CSR SpMV by a per-block row window
(``schedule='merge_path'``, ``impl='pallas'``).

Replaces ``loops_tpu/ops/kernels/spmv_flat.py`` (``flat_spmv_pallas``),
which reduced each block with one [K, R] one-hot matmul into the
128-aligned output window ``y[s0*128 : s0*128 + R]``. The CUDA kernel
(``csrc/spmv.cu`` ``flat_spmv_kernel``) keeps the same staging (``rel``
relative to the aligned base ``s0*128``) and sums each row run of a block
on its own: interior rows go to ``y[s0*128 + rel]``, the block's first
and last row through the seam pass.

``R <= MAX_WINDOW`` (58112 rows) bounds the plans K3 takes; the TPU
kernel's bound was 4096 rows. The kernel holds each slot's ``rel`` in 16
bits of shared memory, which the bound keeps exact. Merge-path plans
stay far below it (span <= block + 128); only a work_oriented plan over
long runs of empty rows reaches it.

What bounds K3 on an H100 is what bounds K1: the ``x[col]`` gather, one
random L2 sector per nonzero. On top of K1's bytes it streams the
relative row (4 B) of every staged slot. The kernel works as K1 does, in
two phases over pieces of at most ``PIECE`` slots: the products
``vals * x[cols]`` (rounded to f32) and ``rel`` are streamed into shared
memory as 16-byte quads, 4 gathers in flight per thread and 8 CTAs of
128 threads an SM, then a group of ``lanes_per_row`` lanes sums each run
from there in a fixed order, the piece's last run carried into the next
piece. Each block writes the rows no run of it writes and no other block
owns (its empty rows, the gap up to the next block with atoms), so y is
a ``torch.empty``; the staged buffers are checked once, at bind.
"""
from __future__ import annotations

import numpy as np
import torch

from loops_tpu_torch.formats.base import INDEX_DTYPE
from loops_tpu_torch.ops.kernels import _build, spmv_sorted
from loops_tpu_torch.utils.platform import ensure_platform

LANES = 128
# rows: what 227 KB of f32 (an H100 block's shared memory) holds
MAX_WINDOW = 227 * 1024 // 4
# the slots a block of the kernel takes at a time (csrc/spmv.cu kK3Piece)
PIECE = 512


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def check_staged(b: dict, params: dict, device) -> None:
    """Raise ``ValueError`` unless the staged buffers ``b`` are what K3
    reads: contiguous int32/float32 tensors on ``device`` of the plan's
    sizes."""
    nb, K = params["num_blocks"], params["K"]
    _build.check(b["vals"], "vals", torch.float32, device, nb * K)
    _build.check(b["cols"], "cols", torch.int32, device, nb * K)
    _build.check(b["rel"], "rel", torch.int32, device, nb * K)
    _build.check(b["s0"], "s0", torch.int32, device, nb)
    _build.check(b["atom_starts"], "atom_starts", torch.int32, device,
                 nb + 1)
    for name in ("row_first", "row_last"):
        _build.check(b[name], name, torch.int32, device, nb)


def flat_spmv_cuda(b: dict, x: torch.Tensor, params: dict, staged_on=None,
                   out=None) -> torch.Tensor:
    """Launch K3 (``csrc/spmv.cu`` ``flat_spmv_kernel`` + seam pass).
    ``staged_on``: the device on which ``check_staged`` has accepted ``b``
    (at bind); the buffers are then not checked again, and ``x`` must lie
    there too. ``out``: a float32 tensor of ``rows`` to write y into
    instead of a new ``torch.empty`` (the kernel writes every row)."""
    if not x.is_cuda:
        raise ValueError(f"flat_spmv_cuda needs a CUDA tensor, got "
                         f"{x.device}")
    dev = x.device if staged_on is None else staged_on
    _build.check(x, "x", torch.float32, dev, params["cols_n"])
    if staged_on is None:
        check_staged(b, params, dev)
    rows, nb = params["rows"], params["num_blocks"]
    y = _build.output(out, rows, dev)
    seam = torch.empty(2 * nb, dtype=torch.float32, device=dev)
    _build.launch("loops_flat_spmv_f32", "flat_spmv", dev,
                  b["vals"], b["cols"], b["rel"], b["s0"], b["atom_starts"],
                  b["row_first"], b["row_last"], x, y, seam, rows, nb,
                  params["K"], params["piece"], params["lanes_per_row"])
    return y


def flat_spmv_plain(b: dict, x: torch.Tensor, shape, R: int
                    ) -> torch.Tensor:
    """K3's plain PyTorch version over the same staged buffers: the
    per-block [B, R] window by ``scatter_add_``, then the windows added
    into the 128-aligned output in block order."""
    rows = shape[0]
    nb, K = b["vals"].shape
    prod = b["vals"] * x.to(torch.float32)[b["cols"]]
    win = torch.zeros(nb, R, dtype=torch.float32, device=x.device)
    win.scatter_add_(1, b["rel"].long(), prod)
    slots = (b["s0"].long()[:, None] * LANES
             + torch.arange(R, device=x.device)[None, :])
    S = _round_up(rows, LANES) + R
    y = torch.zeros(S, dtype=torch.float32, device=x.device)
    return y.index_add_(0, slots.reshape(-1), win.reshape(-1))[:rows]


def _window(plan):
    """``(s0, rel, R)``: each block's 128-aligned base row ``s0*128``, its
    atoms' rows relative to that base, and the window width R, rounded
    up to 128."""
    r0 = plan.tile_starts[:-1].astype(np.int64)
    s0 = (r0 // LANES).astype(INDEX_DTYPE)
    rel = plan.rel_tile + (r0 % LANES)[:, None]
    return s0, rel, _round_up(int(rel.max(initial=0)) + 1, LANES)


def row_window(plan) -> int:
    """The row window R a plan needs; K3 takes plans with
    ``R <= MAX_WINDOW``."""
    return _window(plan)[2]


def lanes_per_run(plan) -> int:
    """The lanes that sum one row run of a block, from the plan's mean run
    length (atoms per run of one row inside one block)."""
    valid, rel = plan.valid, plan.rel_tile
    starts = valid.copy()
    starts[:, 1:] &= rel[:, 1:] != rel[:, :-1]
    return spmv_sorted.lanes_for(
        plan.num_atoms / max(int(np.count_nonzero(starts)), 1))


def flat_spmv(csr, plan, device="cuda"):
    """Build ``(bufs, fn(bufs, x))`` for CSR + a FlatBlockPlan."""
    device = ensure_platform(device)
    shape = csr.shape
    s0, rel, R = _window(plan)
    if R > MAX_WINDOW:
        raise ValueError(
            f"block row span {R} exceeds the {MAX_WINDOW}-float shared-memory "
            "row window; use a merge_path plan (span is bounded by block "
            "size) or the torch executor")
    row_first, row_last = plan.block_rows()
    arrays = dict(
        vals=plan.gather(csr.vals).astype(np.float32),
        cols=plan.gather(csr.indices).astype(np.int32),
        rel=rel.astype(np.int32),
        s0=s0,
        atom_starts=plan.atom_starts.astype(np.int32),
        row_first=row_first,
        row_last=row_last,
    )
    bufs = {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}
    K = int(arrays["vals"].shape[1])
    params = dict(rows=shape[0], cols_n=shape[1], num_blocks=plan.num_blocks,
                  K=K, R=R, piece=min(PIECE, _round_up(K, 4)),
                  lanes_per_row=lanes_per_run(plan))
    staged_on = _build.staged_guard(bufs, params, check_staged)
    empty = plan.num_atoms == 0

    def fn(b, x):
        if empty:
            # no nonzeros: y is zeros, and there is nothing to launch
            return torch.zeros(shape[0], dtype=torch.float32, device=x.device)
        if x.is_cpu:
            return flat_spmv_plain(b, x, shape, R)
        return flat_spmv_cuda(b, x, params, staged_on(b))
    # the plan's parameters, for a caller of flat_spmv_cuda on these buffers
    fn.params = params
    fn.meta = dict(num_blocks=plan.num_blocks, block_atoms=plan.block_atoms,
                   R=R, lanes_per_row=params["lanes_per_row"])
    return bufs, fn
