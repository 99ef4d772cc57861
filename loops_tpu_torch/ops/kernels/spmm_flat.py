"""K4: flat merge-path CSR SpMM (``schedule='merge_path'``,
``impl='pallas'``) — the GCN aggregation, forward and gradient.

Replaces ``loops_tpu/ops/kernels/spmm_flat.py`` (``flat_spmm_pallas``):
``C[rows, F] = A(csr) @ B[cols, F]`` over a merge-path ``FlatBlockPlan``
(each block at most K atoms and at most K rows). The CUDA kernel
(``csrc/spmm.cu`` ``flat_spmm_kernel`` + ``spmm_seam_kernel``) gives one
CTA of 8 warps to each (plan block, feature tile). The block's atoms are
cut into 8 equal warp ranges (``warp_cuts``); a warp walks its range 4
atoms at a time, all 4 B-row gathers in flight before it adds them in
storage order, with the next 32 atoms' indices loaded ahead. A row
wholly inside a warp's range goes to C; the warps' first and last rows
meet in shared memory, added in warp order; the block's first and last
rows go through a seam pass that adds them in block order, so two
applies are bitwise equal. Every row of C is written
once (a row without atoms as zeros, by the block whose row range holds
it), so C is allocated with ``torch.empty``.

Modes: f32 (products and sums in f32) and ``dtype="bfloat16"``: vals and
B rounded to bf16, each product rounded to bf16 (as the TPU kernel's
staged products were), sums in f32, output f32. The wrapper makes one
bf16 copy of B per call (half the gather's bytes; reading f32 B and
rounding it in registers was slower on the card, PERF.md has the times);
the kernel rounds vals on load.

Dropped with the TPU mechanism: the [K, R] one-hot MXU contraction, the
f32 mode's 3-way bf16 split, the 4096-row output stripes, their re-cut
(``cut_at_rows``) and GROUP padding.

``pad_groups``/``pad_R`` keep the TPU kernel's contract
(``loops_tpu/ops/kernels/spmm_flat.py:48-57``): several CSRs of one
padded shape get staged buffers of identical shapes, so a stream of
out-of-core shards (``io/shards.py``) reuses one set of device buffers.
The port has no GROUP of 8 blocks and no row window, so ``pad_groups``
pads the staged block count ``nb`` with empty blocks (no atoms,
``row_first``/``row_last`` -1, the row range empty at ``rows``), which
the kernel leaves at once and the seam pass skips; C is the unpadded C
bit for bit. ``pad_R`` raises the recorded ``R``, the most rows any
block spans, and has no other effect: the kernel holds no window of
``R`` rows. ``fn.meta`` records both as ``groups`` (the staged block
count) and ``R``.

What bounds K4 on an H100: the bytes of the ``B[col, :]`` gather, F * 4 B
(f32) or F * 2 B (bf16) per nonzero; the feature tile is 32 * FPL columns
(FPL in 1, 2, 4, 8, at most ``block_f / 32``), so a narrow F (40, the
GCN's last layer) is not padded to 128 lanes.
"""
from __future__ import annotations

import numpy as np
import torch

from loops_tpu_torch.ops.kernels import _build
from loops_tpu_torch.utils.platform import ensure_platform

WARP = 32
WARPS = 8  # per CTA: a block's atoms are cut into this many warp ranges
MAX_FPL = 8
BF16 = "bfloat16"


def features_per_lane(F: int, block_f: int) -> int:
    """Columns each lane owns: the power of two at or above ``F / 32``,
    at most ``block_f / 32`` and ``MAX_FPL``."""
    cap = min(block_f // WARP, MAX_FPL)
    fpl = 1
    while fpl < cap and fpl * WARP < F:
        fpl *= 2
    return fpl


def _check_block_f(block_f: int) -> int:
    block_f = int(block_f)
    if block_f < WARP or block_f % WARP:
        raise ValueError(f"block_f={block_f}: K4's feature tile is a "
                         f"positive multiple of {WARP} columns")
    return block_f


def flat_spmm_cuda(b: dict, B: torch.Tensor, shape, dtype=None,
                   block_f: int = 256) -> torch.Tensor:
    """Launch K4 (``csrc/spmm.cu``) on the staged buffers: C [rows, F]
    float32, every row written by the kernel."""
    dev = B.device
    if dev.type != "cuda":
        raise ValueError(f"flat_spmm_cuda needs a CUDA tensor, got {dev}")
    rows, cols_n = shape
    nb, K = b["vals"].shape
    if B.dim() != 2 or B.shape[0] != cols_n:
        raise ValueError(f"B has shape {tuple(B.shape)}, expected "
                         f"[{cols_n}, F]")
    F = B.shape[1]
    _build.check(B, "B", torch.float32, dev)
    _build.check(b["vals"], "vals", torch.float32, dev)
    for name in ("cols", "rows"):
        _build.check(b[name], name, torch.int32, dev, nb * K)
    _build.check(b["offsets"], "offsets", torch.int32, dev, rows + 1)
    for name in ("atom_starts", "row_starts"):
        _build.check(b[name], name, torch.int32, dev, nb + 1)
    for name in ("row_first", "row_last"):
        _build.check(b[name], name, torch.int32, dev, nb)
    fpl = features_per_lane(F, _check_block_f(block_f))
    if -(-F // (WARP * fpl)) > 65535:
        raise ValueError(f"F={F} needs more than 65535 feature tiles")
    C = torch.empty(rows, F, dtype=torch.float32, device=dev)
    if nb == 0 or F == 0 or rows == 0:
        return C  # a grid of 0 blocks is not a launch: C is the answer
    if dtype == BF16:
        B = B.to(torch.bfloat16)
    # one vector load per lane: F % FPL == 0 and B aligned for it
    vec = int(fpl > 1 and F % fpl == 0
              and B.data_ptr() % min(16, fpl * B.element_size()) == 0)
    seam = torch.empty(2 * nb * F, dtype=torch.float32, device=dev)
    _build.launch("loops_flat_spmm", "flat_spmm", dev,
                  b["vals"], b["cols"], b["rows"], b["offsets"],
                  b["atom_starts"], b["row_starts"], b["row_first"],
                  b["row_last"], B, C, seam, nb, K, F, fpl,
                  int(dtype == BF16), vec)
    return C


def products(vals: torch.Tensor, B: torch.Tensor, cols: torch.Tensor,
             dtype=None) -> torch.Tensor:
    """``vals[:, None] * B[cols]`` as float32 [n, F]: in f32, or with
    vals and B rounded to bf16 and each product rounded to bf16."""
    if dtype == BF16:
        bf = torch.bfloat16
        return (vals.to(bf)[:, None] * B.to(bf)[cols]).float()
    return vals[:, None] * B[cols]


def warp_cuts(atom_starts: torch.Tensor) -> torch.Tensor:
    """Every block's cuts into ``WARPS`` warp ranges, ``a0 + n*w // 8``
    for w in 0..7 (``n`` the block's atoms), flat [nb * 8] int64: the
    kernel's formula."""
    a0 = atom_starts[:-1].long()
    n = atom_starts[1:].long() - a0
    w = torch.arange(WARPS, device=a0.device)
    return (a0[:, None] + n[:, None] * w // WARPS).reshape(-1)


def _segment_sums(x: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """Sums of the runs of ``x`` that begin at the sorted, distinct
    ``starts`` (the first at 0), each in order."""
    lengths = torch.diff(starts, append=starts.new_tensor([x.shape[0]]))
    return torch.segment_reduce(x, "sum", lengths=lengths, axis=0,
                                unsafe=True)


def flat_spmm_plain(b: dict, B: torch.Tensor, shape, dtype=None
                    ) -> torch.Tensor:
    """K4's plain PyTorch version over the same staged buffers, in the
    kernel's order by three sorted segment reductions: the per-atom
    products summed in runs cut at row starts, block starts and warp cuts
    (a warp's atoms of one row, in storage order); the runs of each
    (block, row) in warp order; then the block sums of each row in block
    order."""
    rows = shape[0]
    nb, K = b["vals"].shape
    F = B.shape[1]
    dev = B.device
    starts_b = b["atom_starts"].long()
    n = starts_b[1:] - starts_b[:-1]
    valid = torch.arange(K, device=dev)[None, :] < n[:, None]
    # the valid slots, block after block, are the CSR atoms in order
    prod = products(b["vals"][valid], B.to(torch.float32),
                    b["cols"][valid].long(), dtype)
    nnz = prod.shape[0]
    if nnz == 0:
        return torch.zeros(rows, F, dtype=torch.float32, device=dev)
    offsets = b["offsets"].long()
    starts = torch.unique(torch.cat([offsets[:-1], warp_cuts(starts_b)]))
    starts = starts[starts < nnz]
    runs = _segment_sums(prod, starts)
    # (block, row) of each run; runs of one pair are consecutive
    key = ((torch.searchsorted(starts_b, starts, right=True) - 1) * (rows + 1)
           + torch.searchsorted(offsets, starts, right=True) - 1)
    first = torch.ones_like(key, dtype=torch.bool)
    first[1:] = key[1:] != key[:-1]
    pos = torch.nonzero(first).reshape(-1)
    blocks = _segment_sums(runs, pos)
    run_row = torch.searchsorted(offsets, starts[pos], right=True) - 1
    return torch.segment_reduce(
        blocks, "sum", lengths=torch.bincount(run_row, minlength=rows),
        axis=0, unsafe=True)


def flat_spmm_apply(b: dict, B: torch.Tensor, shape, dtype=None,
                    block_f: int = 256) -> torch.Tensor:
    """C = A @ B over K4's staged buffers ``b``: K4 on a CUDA tensor, its
    plain version on a CPU tensor."""
    if B.device.type == "cpu":
        return flat_spmm_plain(b, B, shape, dtype)
    return flat_spmm_cuda(b, B, shape, dtype, block_f)


def flat_spmm(csr, plan, block_f: int = 256, dtype=None, device="cuda",
              pad_groups: int | None = None, pad_R: int | None = None):
    """Build ``(bufs, fn(bufs, B))`` for CSR @ dense over a merge-path
    FlatBlockPlan. ``fn`` runs K4 on a CUDA tensor and the plain version
    on a CPU tensor. ``pad_groups``/``pad_R``: stage at least this many
    blocks (empty ones past the plan's) and record at least this ``R``
    (module docstring); ``fn.meta`` has the realized ``groups`` and
    ``R``."""
    device = ensure_platform(device)
    if dtype not in (None, BF16):
        raise ValueError(f"dtype={dtype!r}: K4 takes None (f32) or "
                         f"{BF16!r}")
    if csr.nnz >= 2**31:
        raise ValueError(f"{csr.nnz} nonzeros: K4 stages int32 offsets")
    block_f = _check_block_f(block_f)
    shape = csr.shape
    rows = shape[0]
    row_first, row_last = plan.block_rows()
    # each block's row range [row_starts[b], row_starts[b+1]), which
    # together cover every row: the kernel writes zeros to those of its
    # range that have no atoms
    row_starts = plan.tile_starts.astype(np.int64).copy()
    row_starts[0], row_starts[-1] = 0, rows
    slot_rows = np.where(plan.valid, plan.tile_starts[:-1, None].astype(
        np.int64) + plan.rel_tile, 0)
    groups = max(plan.num_blocks, int(pad_groups or 0))
    R = max(plan.max_rel_span, int(pad_R or 0))
    pad = groups - plan.num_blocks
    # padding blocks: no atoms (atom_starts repeated), no seam rows, an
    # empty row range at `rows`, zero slots
    arrays = dict(
        vals=_pad(plan.gather(csr.vals).astype(np.float32), pad, 0),
        cols=_pad(plan.gather(csr.indices).astype(np.int32), pad, 0),
        rows=_pad(slot_rows.astype(np.int32), pad, 0),
        offsets=csr.offsets.astype(np.int32),
        atom_starts=_pad(plan.atom_starts.astype(np.int32), pad,
                         plan.atom_starts[-1]),
        row_starts=_pad(row_starts.astype(np.int32), pad, rows),
        row_first=_pad(row_first, pad, -1),
        row_last=_pad(row_last, pad, -1),
    )
    bufs = {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}
    empty = plan.num_atoms == 0

    def fn(b, B):
        if empty:
            # no nonzeros: C is zeros, and there is nothing to launch
            return torch.zeros(rows, B.shape[1], dtype=torch.float32,
                               device=B.device)
        return flat_spmm_apply(b, B, shape, dtype, block_f)
    fn.meta = dict(num_blocks=plan.num_blocks, block_atoms=plan.block_atoms,
                   block_f=block_f, groups=groups, R=R)
    return bufs, fn


def _pad(a: np.ndarray, pad: int, value) -> np.ndarray:
    """``a`` with ``pad`` rows (entries of a 1-D ``a``) of ``value`` below."""
    if pad == 0:
        return a
    return np.concatenate([a, np.full((pad, *a.shape[1:]), value, a.dtype)])
