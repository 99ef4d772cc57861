"""K7: BCSR SpMM with column-deduplicated B tiles (``SpMMOperator(bcsr,
impl='pallas3')``), the block-sparse bench's kernel.

Replaces ``loops_tpu/ops/kernels/spmm_bcsr_v3.py``
(``bcsr_spmm_pallas_v3``). Its contract, kept here: inside each super-row
of SUPER block rows the stored blocks are sorted by (column, row) and cut
into chunks of at most KCH blocks of one column (``_stage_chunks``); a
chunk's A blocks are one padded contiguous [KCH * R, C] slab; the B tile
of a column is loaded only where ``bfetch == 1``, once per (super-row,
column), into buffer ``bslot``, and reused by every chunk of that column;
each chunk's rows add into the output tile at ``rowoff``.

The CUDA kernel (``csrc/bcsr.cu`` ``bcsr_spmm_v3_kernel``) gives one CTA
of 256 threads to each (super-row, feature tile): ``cp.async``
double-buffers the slab and the B tile into shared memory, and the f32
accumulator [SUPER * R, FT] sits in shared memory. A chunk's work is cut
into units of 8 slab rows x 16 features; warp w owns feature group
w % G (G = FT / 16) and every (8 / G)-th unit, and adds each unit's sums
into the accumulator at the block's rowoff, chunk after chunk in chunk
order. In bf16 a unit is the transposed product (16 features x 8 rows)
on ``mma.sync`` m16n8k16 with f32 sums; in f32 it is IEEE ``fmaf`` over
8 x 4 register tiles, the eight column splits of a warp summed across
lanes in a fixed order.

The TPU's SUPER = 2048 / R (a 2048 x 512 f32 output tile, 4 MB) and KCH
= 128 / R do not fit 227 KB of shared memory, so the card picks its own
(``card_tiles``, halved for wide blocks until a CTA fits): tall
super-rows and chunks of 8 blocks at 8 x 128, so that chunks fill and
each B tile serves many blocks. FT is the widest of 16, 32, 64 and 128
columns up to ``block_f`` whose shared memory (``smem_bytes``: the
accumulator, two slabs, two B tiles, rows padded by 16 bytes where a
phase would read a bank twice) fits 227 KB.

What bounds it on an H100: in IEEE f32, 2 flops per stored value and
feature on the CUDA cores (0.239 ms at the bench's 16384^2, F = 512
regime); in bf16 the bytes (0.024 ms), far below what the B tiles
re-read from L2 and the per-chunk barriers cost. The column dedup cuts
B tile reads, which come from L2 when B fits its 50 MB.

``dtype="bfloat16"`` streams A and B in bf16 (rounded operands, products
exact in f32, f32 sums). Kept: ``R % 8 == 0`` and ``C % 128 == 0``. The
staged buffers are checked once, at bind (``_build.staged_guard``), and
C is a ``torch.empty`` or a checked ``out=``: the kernel writes every
row.
"""
from __future__ import annotations

import numpy as np
import torch

from loops_tpu_torch.formats.base import INDEX_DTYPE
from loops_tpu_torch.ops.kernels import _build
from loops_tpu_torch.ops.kernels.spmm_bcsr import (
    SMEM_LIMIT,
    check_blocks,
    stage_b,
    stream_type,
)
from loops_tpu_torch.utils.platform import ensure_platform


def tpu_tiles(R: int) -> tuple[int, int]:
    """``loops_tpu``'s default (SUPER, KCH) for R-row blocks."""
    return max(2048 // R, 1), max(128 // R, 1)


# the card's tiles at R = 8: (SUPER block rows, KCH blocks) per stream
# type; taller blocks keep the rows (SUPER * R, KCH * R)
CARD_TILES = {torch.float32: (128, 4), torch.bfloat16: (64, 8)}
# feature columns of a warp's unit (csrc/bcsr.cu kK7Unit)
UNIT = 16
WARPS = 8


def card_tiles(R: int, dtype=None) -> tuple[int, int]:
    """This kernel's default (SUPER, KCH) for R-row blocks in the mode
    ``dtype`` streams."""
    sup, kch = CARD_TILES[stream_type(dtype)]
    return max(sup * 8 // R, 1), max(kch * 8 // R, 1)


def default_tiles(R: int, C: int, T, dtype, block_f: int) -> dict:
    """K7's tiles at ``card_tiles``, KCH and then SUPER halved until a CTA
    fits (wide blocks)."""
    SUPER, KCH = card_tiles(R, dtype)
    while (smem_bytes(R, C, T, SUPER, KCH, UNIT) > SMEM_LIMIT
           and SUPER * KCH > 1):
        if KCH > 1:
            KCH //= 2
        else:
            SUPER //= 2
    return tiles(R, C, T, SUPER, KCH, block_f)


def _stage_chunks(bcsr, SUPER: int, KCH: int):
    """Column-sorted, KCH-padded chunk arrays for every super-row.

    Returns (chunk_ptr [nsup+1], ccol [T], bfetch [T], bslot [T],
    rowoff [T*KCH], src [T*KCH] with -1 pads) where T = total chunks —
    the arrays of ``loops_tpu``'s ``_stage_chunks``, vectorized.
    """
    nbr = bcsr.num_block_rows
    nsup = max(-(-nbr // SUPER), 1)
    brow = bcsr.block_row_ids().astype(np.int64)
    bcol = np.asarray(bcsr.block_cols, np.int64)
    sup = brow // SUPER
    # per super-row, blocks by (column, row)
    order = np.lexsort((brow, bcol, sup))
    s_sup, s_col = sup[order], bcol[order]
    n = len(order)
    run_start = np.ones(n, bool)
    run_start[1:] = (s_sup[1:] != s_sup[:-1]) | (s_col[1:] != s_col[:-1])
    run_id = np.cumsum(run_start) - 1
    run_first = np.flatnonzero(run_start)
    pos = np.arange(n) - run_first[run_id]            # position in its run
    chunk_start = pos % KCH == 0
    chunk_id = np.cumsum(chunk_start) - 1              # chunk of each block
    T = int(chunk_id[-1]) + 1 if n else 0
    first = np.flatnonzero(chunk_start)
    ccol = s_col[first].astype(INDEX_DTYPE)
    bfetch = (pos[first] == 0).astype(INDEX_DTYPE)     # a run's first chunk
    bslot = ((np.cumsum(bfetch) - 1) % 2).astype(INDEX_DTYPE)
    slot = chunk_id * KCH + pos % KCH
    rowoff = np.zeros(T * KCH, INDEX_DTYPE)
    rowoff[slot] = brow[order] - s_sup * SUPER
    src = np.full(T * KCH, -1, np.int64)
    src[slot] = order
    chunk_ptr = np.zeros(nsup + 1, INDEX_DTYPE)
    np.cumsum(np.bincount(s_sup[first], minlength=nsup), out=chunk_ptr[1:])
    return chunk_ptr, ccol, bfetch, bslot, rowoff, src


def traffic_bytes(bcsr, F: int, itemsize: int = 4,
                  SUPER: int | None = None, KCH: int | None = None) -> int:
    """Bytes the kernel moves for one apply: the padded A slabs, the
    deduplicated B-tile fetches and the output tile writes (``loops_tpu``'s
    ``bench.py`` ``v3_actual_traffic_bytes``; by default at its SUPER and
    KCH)."""
    R, C = bcsr.block_shape
    t_super, t_kch = tpu_tiles(R)
    SUPER = SUPER or t_super
    KCH = KCH or t_kch
    chunk_ptr, ccol, bfetch, *_ = _stage_chunks(bcsr, SUPER, KCH)
    nsup = len(chunk_ptr) - 1
    a_bytes = len(ccol) * KCH * R * C * itemsize
    b_bytes = int(bfetch.sum()) * C * F * itemsize
    c_bytes = nsup * SUPER * R * F * 4          # f32 output
    return a_bytes + b_bytes + c_bytes


def smem_bytes(R: int, C: int, T, SUPER: int, KCH: int, FT: int) -> int:
    """Shared memory of one K7 CTA: the f32 accumulator [SUPER*R][FT + 4],
    two slabs and two B tiles in the stream type ``T`` (rows padded by 16
    bytes in bf16, B's in f32) and two chunks' rowoff."""
    es = torch.empty(0, dtype=T).element_size()
    pad_a, pad_b = (8, 8) if T == torch.bfloat16 else (0, 4)
    return (4 * SUPER * R * (FT + 4)
            + 2 * es * (KCH * R * (C + pad_a) + C * (FT + pad_b))
            + 2 * 4 * KCH)


def tiles(R: int, C: int, T, SUPER: int, KCH: int, block_f: int) -> dict:
    """FT and shared-memory bytes for K7 at (SUPER, KCH): the widest
    feature tile of ``16 * 2^k`` columns (k <= 3: a 16-column unit for
    each of up to 8 warps) up to ``block_f`` whose CTA fits;
    ``ValueError`` if none does."""
    unit = UNIT
    block_f = int(block_f)
    if block_f < unit or block_f % unit:
        raise ValueError(f"block_f={block_f}: K7's feature tile is a "
                         f"positive multiple of {unit} columns")
    ft = unit
    while 2 * ft <= min(block_f, WARPS * unit):
        ft *= 2
    while ft >= unit:
        smem = smem_bytes(R, C, T, SUPER, KCH, ft)
        if smem <= SMEM_LIMIT:
            return dict(SUPER=SUPER, KCH=KCH, FT=ft, smem=smem)
        ft //= 2
    raise ValueError(f"the tiles need {smem_bytes(R, C, T, SUPER, KCH, unit)}"
                     f" bytes of shared memory at a {unit}-column feature "
                     f"tile, past the {SMEM_LIMIT} one CTA may use: fewer "
                     "super rows or chunk blocks, or narrower blocks")


def check_staged(b: dict, t: dict, device) -> None:
    """Raise ``ValueError`` unless the staged chunk buffers ``b`` are what
    K7 reads at the tiles ``t``: contiguous tensors on ``device`` of the
    plan's sizes."""
    n, KCH = t["chunks"], t["KCH"]
    _build.check(b["a3d"], "a3d", stream_type(t["dtype"]), device,
                 n * KCH * t["R"] * t["C"])
    _build.check(b["chunk_ptr"], "chunk_ptr", torch.int32, device,
                 t["nsup"] + 1)
    for name in ("ccol", "bfetch", "bslot", "nlive"):
        _build.check(b[name], name, torch.int32, device, n)
    _build.check(b["rowoff"], "rowoff", torch.int32, device, n * KCH)


def bcsr_spmm_v3_cuda(b: dict, B: torch.Tensor, shape, t: dict,
                      dtype=None, staged_on=None, out=None) -> torch.Tensor:
    """Launch K7 on the staged chunk buffers: C [rows, F] float32.
    ``staged_on``: the device on which ``check_staged`` has accepted ``b``
    (at bind); the buffers are then not checked again. ``out``: a float32
    [rows, F] tensor to write C into instead of a new ``torch.empty``
    (the kernel writes every row)."""
    if not B.is_cuda:
        raise ValueError(f"bcsr_spmm_v3_cuda needs a CUDA tensor, got "
                         f"{B.device}")
    rows, cols = shape
    dev = B.device if staged_on is None else staged_on
    R, C, KCH = t["R"], t["C"], t["KCH"]
    if R % 8 or C % 128:
        raise ValueError(f"K7 needs R%8==0 and C%128==0, got R={R}, C={C}")
    if B.dim() != 2 or B.shape[0] != cols:
        raise ValueError(f"B has shape {tuple(B.shape)}, expected "
                         f"[{cols}, F]")
    F = B.shape[1]
    _build.check(B, "B", torch.float32, dev)
    if stream_type(dtype) != stream_type(t["dtype"]):
        raise ValueError(f"dtype={dtype!r}: the buffers were staged for "
                         f"dtype={t['dtype']!r}")
    if staged_on is None:
        check_staged(b, t, dev)
    if -(-F // t["FT"]) > 65535:
        raise ValueError(f"F={F} needs more than 65535 feature tiles")
    C_out = _build.output(out, (rows, F), dev)
    if rows == 0 or F == 0:
        return C_out  # a grid of 0 blocks is not a launch
    Bk, ld = stage_b(B, dtype)
    _build.launch("loops_bcsr_spmm_v3", "bcsr_spmm_v3", dev, b["chunk_ptr"],
                  b["ccol"], b["bfetch"], b["bslot"], b["rowoff"],
                  b["nlive"], b["a3d"], Bk, C_out, t["nsup"], R, C, rows,
                  cols, F, ld, t["SUPER"], KCH, t["FT"],
                  int(Bk.dtype == torch.bfloat16), t["smem"])
    return C_out


def bcsr_spmm_v3_plain(b: dict, B: torch.Tensor, shape, t: dict,
                       dtype=None) -> torch.Tensor:
    """K7's plain version over the same chunk buffers: each chunk's slab
    times its column's B tile (stream-type operands, f32 products and
    sums), its live rows sent to ``rowoff``, then a sorted segment sum
    per output row in chunk order (deterministic; no ``index_add_``)."""
    rows, cols = shape
    R, KCH, SUPER = t["R"], t["KCH"], t["SUPER"]
    Tn, QR, C = b["a3d"].shape
    F = B.shape[1]
    dev = B.device
    nsup = b["chunk_ptr"].numel() - 1
    nbc = -(-cols // C)
    Bp = torch.zeros(nbc * C, F, dtype=torch.float32, device=dev)
    Bp[:cols] = B.to(stream_type(dtype)).float()
    prod = torch.bmm(b["a3d"].float(),
                     Bp.view(nbc, C, F)[b["ccol"].long()])   # [T, QR, F]
    sup = torch.repeat_interleave(
        torch.arange(nsup, device=dev),
        torch.diff(b["chunk_ptr"].long()))                 # super-row of t
    k = torch.arange(KCH, device=dev)
    live = k[None, :] < b["nlive"].long()[:, None]         # [T, KCH]
    block_row = sup[:, None] * SUPER + b["rowoff"].long().view(-1, KCH)
    ids = (block_row[:, :, None] * R
           + torch.arange(R, device=dev)).reshape(-1)    # [T * QR]
    keep = live[:, :, None].expand(-1, -1, R).reshape(-1)
    ids, part = ids[keep], prod.reshape(-1, F)[keep]
    order = torch.sort(ids, stable=True).indices
    total = -(-rows // R) * R if rows else 0
    C_out = torch.segment_reduce(
        part[order], "sum", lengths=torch.bincount(ids, minlength=total),
        axis=0, unsafe=True)
    return C_out[:rows]


def bcsr_spmm_v3(bcsr, block_f: int = 512, super_rows: int | None = None,
                 chunk_blocks: int | None = None, dtype=None,
                 device="cuda"):
    """Build ``(bufs, fn(bufs, B, out=None))`` for BCSR @ dense through
    K7; ``fn`` runs K7 on a CUDA tensor and the plain version on a CPU
    tensor. ``super_rows`` and ``chunk_blocks`` default to this kernel's
    SUPER and KCH in the mode (``card_tiles``)."""
    device = ensure_platform(device)
    check_blocks(bcsr)
    T = stream_type(dtype)
    R, C = bcsr.block_shape
    if super_rows or chunk_blocks:
        d_super, d_kch = card_tiles(R, dtype)
        t = tiles(R, C, T, super_rows or d_super, chunk_blocks or d_kch,
                  block_f)
    else:
        t = default_tiles(R, C, T, dtype, block_f)
    SUPER, KCH = t["SUPER"], t["KCH"]
    chunk_ptr, ccol, bfetch, bslot, rowoff, src = _stage_chunks(
        bcsr, SUPER, KCH)
    Tn = len(ccol)
    live = src >= 0
    # padded contiguous A slabs: one copy per chunk
    a3d = np.zeros((max(Tn, 1), KCH * R, C), np.float32)
    a3d.reshape(max(Tn, 1) * KCH, R, C)[live] = bcsr.vals[src[live]]
    nlive = live.reshape(-1, KCH).sum(1).astype(np.int32)
    t.update(R=R, C=C, chunks=Tn, nsup=len(chunk_ptr) - 1, dtype=dtype)
    arrays = dict(chunk_ptr=chunk_ptr, ccol=ccol, bfetch=bfetch,
                  bslot=bslot, rowoff=rowoff, nlive=nlive)
    bufs = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in arrays.items()}
    bufs["a3d"] = torch.from_numpy(a3d[:Tn]).to(device, T)
    shape = bcsr.shape
    staged_on = _build.staged_guard(bufs, t, check_staged)

    def fn(b, B, out=None):
        if B.device.type == "cpu":
            return bcsr_spmm_v3_plain(b, B, shape, t, dtype)
        return bcsr_spmm_v3_cuda(b, B, shape, t, dtype, staged_on(b), out)
    fn.staged_on = staged_on
    fn.meta = dict(num_blocks=bcsr.num_blocks, b_fetches=int(bfetch.sum()),
                   **t)
    return bufs, fn
