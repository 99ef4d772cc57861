"""K2: flat balanced CSR SpMV by segmented scan (``schedule='merge_path'``,
``impl='pallas2'``).

Replaces ``loops_tpu/ops/kernels/spmv_flat_v2.py``
(``flat_spmv_pallas_v2``, ``_stage_extraction``). Segments are sorted
within a block, so an in-block **segmented inclusive scan** of the
products (boundary-reset prefix sum, per-row f32 summation so the
Wilkinson bound holds row-wise) leaves every row's total at its last
atom. The CUDA kernel (``csrc/spmv.cu`` ``flat_spmv_v2_kernel``) scans
with warp shuffles keyed on ``keep`` and writes each row end to its row;
the first and last row of a block go through the seam pass.

Of ``_stage_extraction`` the kernel takes only the ``keep`` flags
(``_keep_flags``). Its 128-aligned extraction slots (``end_arr``,
``rel_arr``, ``R``, ``S``) served the TPU's one-hot extraction, whose
Mosaic compile envelopes (``R > 4096``, ``S*R > 2**22``) have no
counterpart on the GPU and are dropped.

What bounds K2 on an H100 is what bounds K1: the ``x[col]`` gather, one
random L2 sector per nonzero. On top of K1's bytes it streams the keep
flag (1 B) of every staged slot and reads the relative row (4 B) at each
run's end. The kernel is a register-blocked reduce-by-key: each thread
owns ``ITEMS`` consecutive slots (two 16-byte quads, 8 gathers in
flight), folds them sequentially, and one block scan per ``CHUNK`` slots
over the threads' folds gives each its carry-in. Each block writes the
rows no run of it writes and no other block owns (its empty rows, the gap
up to the next block with atoms), so y is a ``torch.empty``; the staged
buffers are checked once, at bind.
"""
from __future__ import annotations

import numpy as np
import torch

from loops_tpu_torch.ops.kernels import _build
from loops_tpu_torch.utils.platform import ensure_platform

# the kernel's threads a block, the consecutive slots a thread owns, and
# the slots one block scan covers (csrc/spmv.cu kK2Threads, kK2Items,
# kK2Chunk)
THREADS = 128
ITEMS = 8
CHUNK = THREADS * ITEMS


def _keep_flags(plan):
    """[B, K] bool: False where the segmented scan restarts (a block's
    first atom, each new row run, the first padding slot) — the ``keep``
    of the reference's ``_stage_extraction``."""
    B, K = plan.atom_gather.shape
    valid, rel = plan.valid, plan.rel_tile
    keep = np.ones((B, K), bool)
    keep[:, 1:] = ~(valid[:, 1:] & (rel[:, 1:] != rel[:, :-1]))
    keep[:, 0] = False
    n = valid.sum(axis=1)
    pad = np.nonzero(n < K)[0]
    keep[pad, n[pad]] = False
    return keep


def check_staged(b: dict, params: dict, device) -> None:
    """Raise ``ValueError`` unless the staged buffers ``b`` are what K2
    reads: contiguous tensors of their types on ``device`` of the plan's
    sizes."""
    nb, K = params["num_blocks"], params["K"]
    _build.check(b["vals"], "vals", torch.float32, device, nb * K)
    _build.check(b["cols"], "cols", torch.int32, device, nb * K)
    _build.check(b["keep"], "keep", torch.uint8, device, nb * K)
    _build.check(b["rel"], "rel", torch.int32, device, nb * K)
    for name in ("tile_starts", "atom_starts"):
        _build.check(b[name], name, torch.int32, device, nb + 1)
    for name in ("row_first", "row_last"):
        _build.check(b[name], name, torch.int32, device, nb)


def flat_spmv_v2_cuda(b: dict, x: torch.Tensor, params: dict,
                      staged_on=None, out=None) -> torch.Tensor:
    """Launch K2 (``csrc/spmv.cu`` ``flat_spmv_v2_kernel`` + seam pass).
    ``staged_on``: the device on which ``check_staged`` has accepted ``b``
    (at bind); the buffers are then not checked again, and ``x`` must lie
    there too. ``out``: a float32 tensor of ``rows`` to write y into
    instead of a new ``torch.empty`` (the kernel writes every row)."""
    if not x.is_cuda:
        raise ValueError(f"flat_spmv_v2_cuda needs a CUDA tensor, got "
                         f"{x.device}")
    dev = x.device if staged_on is None else staged_on
    _build.check(x, "x", torch.float32, dev, params["cols_n"])
    if staged_on is None:
        check_staged(b, params, dev)
    rows, nb = params["rows"], params["num_blocks"]
    y = _build.output(out, rows, dev)
    seam = torch.empty(2 * nb, dtype=torch.float32, device=dev)
    _build.launch("loops_flat_spmv_v2_f32", "flat_spmv_v2", dev,
                  b["vals"], b["cols"], b["keep"], b["rel"],
                  b["tile_starts"], b["atom_starts"], b["row_first"],
                  b["row_last"], x, y, seam, rows, nb, params["K"])
    return y


def flat_spmv_v2_plain(b: dict, x: torch.Tensor, shape) -> torch.Tensor:
    """K2's plain PyTorch version over the same staged buffers: products
    summed into their rows (tile_starts + rel) with ``index_add_``."""
    rows = shape[0]
    nb, K = b["vals"].shape
    prod = b["vals"] * x.to(torch.float32)[b["cols"]]
    n = b["atom_starts"][1:] - b["atom_starts"][:-1]
    valid = torch.arange(K, device=x.device)[None, :] < n[:, None]
    ids = torch.where(valid, b["tile_starts"][:-1, None] + b["rel"], rows)
    y = torch.zeros(rows + 1, dtype=torch.float32, device=x.device)
    return y.index_add_(0, ids.reshape(-1), prod.reshape(-1))[:rows]


def flat_spmv_v2(csr, plan, device="cuda"):
    """Build ``(bufs, fn(bufs, x))`` for CSR + a FlatBlockPlan."""
    device = ensure_platform(device)
    row_first, row_last = plan.block_rows()
    arrays = dict(
        vals=plan.gather(csr.vals).astype(np.float32),
        cols=plan.gather(csr.indices).astype(np.int32),
        keep=_keep_flags(plan).astype(np.uint8),
        rel=plan.rel_tile.astype(np.int32),
        tile_starts=plan.tile_starts.astype(np.int32),
        atom_starts=plan.atom_starts.astype(np.int32),
        row_first=row_first,
        row_last=row_last,
    )
    bufs = {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}
    shape = csr.shape
    params = dict(rows=shape[0], cols_n=shape[1], num_blocks=plan.num_blocks,
                  K=int(arrays["vals"].shape[1]))
    staged_on = _build.staged_guard(bufs, params, check_staged)
    empty = plan.num_atoms == 0

    def fn(b, x):
        if empty:
            # no nonzeros: y is zeros, and there is nothing to launch
            return torch.zeros(shape[0], dtype=torch.float32, device=x.device)
        if x.is_cpu:
            return flat_spmv_v2_plain(b, x, shape)
        return flat_spmv_v2_cuda(b, x, params, staged_on(b))
    # the plan's parameters, for a caller of flat_spmv_v2_cuda on these
    # buffers
    fn.params = params
    fn.meta = dict(num_blocks=plan.num_blocks, block_atoms=plan.block_atoms)
    return bufs, fn
