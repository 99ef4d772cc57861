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
double-buffers the slab and the B tile into shared memory, the f32
accumulator [SUPER * R, FT] sits in shared memory, and each thread
computes 4 x 4 register tiles of a chunk's rows x features and adds them
in chunk order. The TPU's SUPER = 2048 / R (a 2048 x 512 f32 output tile,
4 MB) and KCH = 128 / R do not fit 227 KB of shared memory, so the card
picks its own: SUPER = 256 / R block rows (256 output rows), KCH = 64 / R
blocks (64 slab rows), FT = 64 columns, halved while
``4 * SUPER*R*FT + 2 * es * (KCH*R*C + C*FT)`` bytes passes 227 KB
(es = 4 in f32, 2 in bf16): 192 KB at 8 x 128 blocks in f32, 128 KB in
bf16.

What bounds it on an H100: in IEEE f32, 2 flops per stored value and
feature on the CUDA cores (0.239 ms at the bench's 16384^2, F = 512
regime); in bf16 only the tensor cores could reach the byte bound. The
column dedup cuts B tile reads, which come from L2 when B fits its 50 MB.

``dtype="bfloat16"`` streams A and B in bf16 (rounded operands, products
exact in f32, f32 sums). Kept: ``R % 8 == 0`` and ``C % 128 == 0``.
"""
from __future__ import annotations

import numpy as np
import torch

from loops_tpu_torch.formats.base import INDEX_DTYPE
from loops_tpu_torch.ops.kernels import _build
from loops_tpu_torch.ops.kernels.spmm_bcsr import (
    check_blocks,
    fit_feature_tile,
    stage_b,
    stream_type,
)
from loops_tpu_torch.utils.platform import ensure_platform


def tpu_tiles(R: int) -> tuple[int, int]:
    """``loops_tpu``'s default (SUPER, KCH) for R-row blocks."""
    return max(2048 // R, 1), max(128 // R, 1)


def card_tiles(R: int) -> tuple[int, int]:
    """This kernel's default (SUPER, KCH) for R-row blocks."""
    return max(256 // R, 1), max(64 // R, 1)


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


def tiles(R: int, C: int, T, SUPER: int, KCH: int, block_f: int) -> dict:
    """FT and shared-memory bytes for K7 at (SUPER, KCH)."""
    es = torch.empty(0, dtype=T).element_size()
    FT, smem = fit_feature_tile(
        block_f,
        lambda ft: 4 * SUPER * R * ft + 2 * es * (KCH * R * C + C * ft))
    return dict(SUPER=SUPER, KCH=KCH, FT=FT, smem=smem)


def bcsr_spmm_v3_cuda(b: dict, B: torch.Tensor, shape, t: dict,
                      dtype=None) -> torch.Tensor:
    """Launch K7 on the staged chunk buffers: C [rows, F] float32."""
    dev = B.device
    if dev.type != "cuda":
        raise ValueError(f"bcsr_spmm_v3_cuda needs a CUDA tensor, got {dev}")
    rows, cols = shape
    Tn, QR, C = b["a3d"].shape
    R, KCH = t["R"], t["KCH"]
    if R % 8 or C % 128 or QR != KCH * R:
        raise ValueError(f"K7 needs R%8==0, C%128==0 and KCH*R slab rows, "
                         f"got R={R}, C={C}, slab rows {QR}")
    if B.dim() != 2 or B.shape[0] != cols:
        raise ValueError(f"B has shape {tuple(B.shape)}, expected "
                         f"[{cols}, F]")
    F = B.shape[1]
    nsup = b["chunk_ptr"].numel() - 1
    _build.check(B, "B", torch.float32, dev)
    _build.check(b["a3d"], "a3d", stream_type(dtype), dev)
    _build.check(b["chunk_ptr"], "chunk_ptr", torch.int32, dev)
    for name in ("ccol", "bfetch", "bslot", "nlive"):
        _build.check(b[name], name, torch.int32, dev, t["chunks"])
    _build.check(b["rowoff"], "rowoff", torch.int32, dev, t["chunks"] * KCH)
    if -(-F // t["FT"]) > 65535:
        raise ValueError(f"F={F} needs more than 65535 feature tiles")
    out = torch.empty(rows, F, dtype=torch.float32, device=dev)
    if rows == 0 or F == 0:
        return out  # a grid of 0 blocks is not a launch
    Bk, ld = stage_b(B, dtype)
    _build.launch("loops_bcsr_spmm_v3", "bcsr_spmm_v3", dev, b["chunk_ptr"],
                  b["ccol"], b["bfetch"], b["bslot"], b["rowoff"],
                  b["nlive"], b["a3d"], Bk, out, nsup, R, C, rows, cols, F,
                  ld, t["SUPER"], KCH, t["FT"],
                  int(Bk.dtype == torch.bfloat16), t["smem"])
    return out


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
    """Build ``(bufs, fn(bufs, B))`` for BCSR @ dense through K7; ``fn``
    runs K7 on a CUDA tensor and the plain version on a CPU tensor.
    ``super_rows`` and ``chunk_blocks`` default to this kernel's SUPER and
    KCH (``card_tiles``)."""
    device = ensure_platform(device)
    check_blocks(bcsr)
    T = stream_type(dtype)
    R, C = bcsr.block_shape
    d_super, d_kch = card_tiles(R)
    SUPER, KCH = super_rows or d_super, chunk_blocks or d_kch
    t = tiles(R, C, T, SUPER, KCH, block_f)
    chunk_ptr, ccol, bfetch, bslot, rowoff, src = _stage_chunks(
        bcsr, SUPER, KCH)
    Tn = len(ccol)
    live = src >= 0
    # padded contiguous A slabs: one copy per chunk
    a3d = np.zeros((max(Tn, 1), KCH * R, C), np.float32)
    a3d.reshape(max(Tn, 1) * KCH, R, C)[live] = bcsr.vals[src[live]]
    nlive = live.reshape(-1, KCH).sum(1).astype(np.int32)
    t.update(R=R, chunks=Tn)
    arrays = dict(chunk_ptr=chunk_ptr, ccol=ccol, bfetch=bfetch,
                  bslot=bslot, rowoff=rowoff, nlive=nlive)
    bufs = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in arrays.items()}
    bufs["a3d"] = torch.from_numpy(a3d[:Tn]).to(device, T)
    shape = bcsr.shape

    def fn(b, B):
        if B.device.type == "cpu":
            return bcsr_spmm_v3_plain(b, B, shape, t, dtype)
        return bcsr_spmm_v3_cuda(b, B, shape, t, dtype)
    fn.meta = dict(num_blocks=bcsr.num_blocks, b_fetches=int(bfetch.sum()),
                   **t)
    return bufs, fn
