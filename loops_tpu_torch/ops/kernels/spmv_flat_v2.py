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

What bounds K2 on an H100 is bytes: per staged slot it reads the value
(4 B), column (4 B), keep flag (1 B) and relative row (4 B), and gathers
``x[col]``; the staged [B, K] buffers repeat the CSR arrays in block
layout, so it moves more than K1 does.
"""
from __future__ import annotations

import numpy as np
import torch

from loops_tpu_torch.ops.kernels import _build
from loops_tpu_torch.utils.platform import ensure_platform


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


def flat_spmv_v2_cuda(b: dict, x: torch.Tensor, shape) -> torch.Tensor:
    """Launch K2 (``csrc/spmv.cu`` ``flat_spmv_v2_kernel`` + seam pass)."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"flat_spmv_v2_cuda needs a CUDA tensor, got {dev}")
    rows, cols_n = shape
    nb, K = b["vals"].shape
    _build.check(x, "x", torch.float32, dev, cols_n)
    _build.check(b["vals"], "vals", torch.float32, dev)
    _build.check(b["cols"], "cols", torch.int32, dev, nb * K)
    _build.check(b["keep"], "keep", torch.uint8, dev, nb * K)
    _build.check(b["rel"], "rel", torch.int32, dev, nb * K)
    for name in ("tile_starts", "atom_starts"):
        _build.check(b[name], name, torch.int32, dev, nb + 1)
    for name in ("row_first", "row_last"):
        _build.check(b[name], name, torch.int32, dev, nb)
    y = torch.zeros(rows, dtype=torch.float32, device=dev)
    seam = torch.empty(2 * nb, dtype=torch.float32, device=dev)
    _build.launch("loops_flat_spmv_v2_f32", "flat_spmv_v2", dev,
                  b["vals"], b["cols"], b["keep"], b["rel"],
                  b["tile_starts"], b["atom_starts"], b["row_first"],
                  b["row_last"], x, y, seam, nb, K)
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

    empty = plan.num_atoms == 0

    def fn(b, x):
        if empty:
            # no nonzeros: y is zeros, and there is nothing to launch
            return torch.zeros(shape[0], dtype=torch.float32, device=x.device)
        if x.device.type == "cpu":
            return flat_spmv_v2_plain(b, x, shape)
        return flat_spmv_v2_cuda(b, x, shape)
    fn.meta = dict(num_blocks=plan.num_blocks, block_atoms=plan.block_atoms)
    return bufs, fn
