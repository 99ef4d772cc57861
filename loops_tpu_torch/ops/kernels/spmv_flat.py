"""K3: flat balanced CSR SpMV by a per-block row window
(``schedule='merge_path'``, ``impl='pallas'``).

Replaces ``loops_tpu/ops/kernels/spmv_flat.py`` (``flat_spmv_pallas``),
which reduced each block with one [K, R] one-hot matmul into the
128-aligned output window ``y[s0*128 : s0*128 + R]``. The CUDA kernel
(``csrc/spmv.cu`` ``flat_spmv_kernel``) keeps the same staging (``rel``
relative to the aligned base ``s0*128``) but holds the window in shared
memory: each row run is summed in CSR order by the one thread that owns
it, then the window goes to y, the block's first and last row through
the seam pass.

``R <= MAX_WINDOW`` stays as the shared-memory bound of that window:
58112 floats, the 227 KB of dynamic shared memory an H100 block may opt
into (the TPU kernel's bound was 4096 rows). Merge-path plans stay far
below it (span <= block + 128); only a work_oriented plan over long runs
of empty rows reaches it.

What bounds K3 on an H100: bytes, as for K2 (value, column and relative
row per staged slot, the ``x[col]`` gather), and, on matrices with long
rows, latency: one thread walks each row run, so a block of few long
rows keeps few of its threads busy. That is the design the TPU kernel's
contract allows without shared-memory atomics; K2 is the parallel one.
"""
from __future__ import annotations

import numpy as np
import torch

from loops_tpu_torch.formats.base import INDEX_DTYPE
from loops_tpu_torch.ops.kernels import _build
from loops_tpu_torch.utils.platform import ensure_platform

LANES = 128
MAX_WINDOW = 227 * 1024 // 4  # floats: an H100 block's opt-in shared memory


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def flat_spmv_cuda(b: dict, x: torch.Tensor, shape, R: int
                   ) -> torch.Tensor:
    """Launch K3 (``csrc/spmv.cu`` ``flat_spmv_kernel`` + seam pass)."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"flat_spmv_cuda needs a CUDA tensor, got {dev}")
    if R > MAX_WINDOW:
        raise ValueError(f"row window {R} exceeds the {MAX_WINDOW}-float "
                         "shared-memory row window")
    rows, cols_n = shape
    nb, K = b["vals"].shape
    _build.check(x, "x", torch.float32, dev, cols_n)
    _build.check(b["vals"], "vals", torch.float32, dev)
    _build.check(b["cols"], "cols", torch.int32, dev, nb * K)
    _build.check(b["rel"], "rel", torch.int32, dev, nb * K)
    _build.check(b["s0"], "s0", torch.int32, dev, nb)
    _build.check(b["atom_starts"], "atom_starts", torch.int32, dev, nb + 1)
    for name in ("row_first", "row_last"):
        _build.check(b[name], name, torch.int32, dev, nb)
    y = torch.zeros(rows, dtype=torch.float32, device=dev)
    seam = torch.empty(2 * nb, dtype=torch.float32, device=dev)
    _build.launch("loops_flat_spmv_f32", "flat_spmv", dev,
                  b["vals"], b["cols"], b["rel"], b["s0"], b["atom_starts"],
                  b["row_first"], b["row_last"], x, y, seam, nb, K, R)
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

    empty = plan.num_atoms == 0

    def fn(b, x):
        if empty:
            # no nonzeros: y is zeros, and there is nothing to launch
            return torch.zeros(shape[0], dtype=torch.float32, device=x.device)
        if x.device.type == "cpu":
            return flat_spmv_plain(b, x, shape, R)
        return flat_spmv_cuda(b, x, shape, R)
    fn.meta = dict(num_blocks=plan.num_blocks, block_atoms=plan.block_atoms,
                   R=R)
    return bufs, fn
