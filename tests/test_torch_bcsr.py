"""The BCSR tier of the port on the CPU: the container, its layout view,
the bench's block-sparse generator, K7's chunk staging and traffic count
— all held identical to ``loops_tpu``'s for the same inputs — and the
refusals and the example CLI. The operators against ``loops_tpu``'s are
in ``test_torch_bcsr_slice.py``.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import loops_tpu.utils.generate as jgen
import loops_tpu_torch.formats as tf
from loops_tpu.formats import BCSR as JaxBCSR, COO as JaxCOO
from loops_tpu.layout import BcsrLayout as JaxBcsrLayout
from loops_tpu.ops.kernels.spmm_bcsr_v3 import (
    _stage_chunks as jax_stage_chunks,
    bcsr_spmm_pallas_v3,
)
from loops_tpu_torch.formats import BCSR
from loops_tpu_torch.layout import BcsrLayout, check_layout_invariants
from loops_tpu_torch.ops.kernels import (
    spmm_bcsr,
    spmm_bcsr_v2,
    spmm_bcsr_v3,
    spmv_bcsr,
)
from loops_tpu_torch.ops.spmm import SpMMOperator
from loops_tpu_torch.ops.spmv import SpMVOperator
from loops_tpu_torch.utils import generate, reference

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKS = [(8, 128), (16, 128), (4, 128), (2, 3)]
MATRICES = {
    "random": lambda: jgen.random_csr(40, 36, 0.15, seed=11),
    "skewed": lambda: jgen.skewed_csr(24, 30, heavy_rows=3),
    "empty_rows": lambda: jgen.empty_row_csr(21, 18),
    "block_diag": lambda: jgen.block_diag_csr(5, 4),
    "tall": lambda: jgen.random_csr(600, 300, 0.02, seed=2),
    "wide": lambda: jgen.random_csr(64, 700, 0.05, seed=5),
    "empty": lambda: JaxCOO((12, 10), [], [], []).to_csr(),
}


def pair(name):
    """(port CSR, loops_tpu CSR) holding the same arrays."""
    j = MATRICES[name]()
    return tf.csr_from_arrays(j.shape, j.offsets, j.indices, j.vals), j


def _same_bcsr(t, j):
    assert t.shape == j.shape and t.block_shape == j.block_shape
    for name in ("block_offsets", "block_cols", "vals"):
        a, b = getattr(t, name), getattr(j, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert (t.num_blocks, t.num_block_rows, t.num_block_cols, t.nnz) == \
        (j.num_blocks, j.num_block_rows, j.num_block_cols, j.nnz)
    np.testing.assert_array_equal(t.block_row_ids(), j.block_row_ids())


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_bcsr_matches_loops_tpu(name, block):
    t, j = pair(name)
    tb, jb = BCSR.from_csr(t, *block), JaxBCSR.from_csr(j, *block)
    _same_bcsr(tb, jb)
    _same_bcsr(t.to_bcsr(*block), jb)
    np.testing.assert_array_equal(tb.to_dense(), jb.to_dense())
    np.testing.assert_array_equal(tb.to_dense(), t.to_dense())
    tc, jc = tb.to_csr(), jb.to_csr()
    for field in ("offsets", "indices", "vals"):
        np.testing.assert_array_equal(getattr(tc, field), getattr(jc, field))
    tl, jl = BcsrLayout.from_bcsr(tb), JaxBcsrLayout.from_bcsr(jb)
    np.testing.assert_array_equal(tl.tile_offsets(), jl.tile_offsets())
    assert (tl.num_tiles, tl.num_atoms) == (jl.num_tiles, jl.num_atoms)
    check_layout_invariants(tl)


def test_bcsr_to_device_and_checks():
    t, _ = pair("random")
    b = BCSR.from_csr(t, 8, 128)
    off, cols, vals = b.to_device(CPU)
    assert off.dtype == cols.dtype == torch.int32
    assert tuple(vals.shape) == (b.num_blocks, 8, 128)
    np.testing.assert_array_equal(vals.numpy(), b.vals)
    with pytest.raises(ValueError, match="vals shape"):
        BCSR(b.shape, (8, 128), b.block_offsets, b.block_cols, b.vals[:, :4])
    with pytest.raises(ValueError, match="block_offsets"):
        BCSR(b.shape, (8, 128), b.block_offsets[:-1], b.block_cols, b.vals)


def _jax_block_sparse(N, R, C, block_density, seed):
    """``bench.py``'s ``build_block_sparse`` (its eight lines, over
    ``loops_tpu.formats``; importing ``bench`` initializes a backend)."""
    rng = np.random.default_rng(seed)
    nbr, nbc = N // R, N // C
    nb = int(nbr * nbc * block_density)
    br = rng.integers(0, nbr, nb)
    bc = rng.integers(0, nbc, nb)
    key = np.unique(br.astype(np.int64) * nbc + bc)
    br = (key // nbc).astype(np.int32)
    bc = (key % nbc).astype(np.int32)
    nb = len(key)
    rr = np.repeat(br * R, R * C) + np.tile(np.repeat(np.arange(R), C), nb)
    cc = np.repeat(bc * C, R * C) + np.tile(np.tile(np.arange(C), R), nb)
    vv = rng.normal(size=nb * R * C).astype(np.float32)
    csr = JaxCOO((N, N), rr, cc, vv).to_csr()
    return csr, JaxBCSR.from_csr(csr, R, C)


@pytest.mark.parametrize("N,R,density,seed", [
    (1024, 8, 0.06, 0), (2048, 16, 0.015, 3)])
def test_build_block_sparse_matches_bench(N, R, density, seed):
    tc, tb = generate.build_block_sparse(N, R, 128, density, seed)
    jc, jb = _jax_block_sparse(N, R, 128, density, seed)
    for field in ("offsets", "indices", "vals"):
        np.testing.assert_array_equal(getattr(tc, field), getattr(jc, field))
    _same_bcsr(tb, jb)


def _jax_traffic(bcsr, F, SUPER, KCH, itemsize=4):
    """``bench.py``'s ``v3_actual_traffic_bytes`` at (SUPER, KCH)."""
    R, C = bcsr.block_shape
    chunk_ptr, ccol, bfetch, *_ = jax_stage_chunks(bcsr, SUPER, KCH)
    nsup = len(chunk_ptr) - 1
    return (len(ccol) * KCH * R * C * itemsize
            + int(bfetch.sum()) * C * F * itemsize
            + nsup * SUPER * R * F * 4)


@pytest.mark.parametrize("super_kch", [(4, 2), (256, 16), (32, 8), (1, 1)])
@pytest.mark.parametrize("name", ["random", "tall", "wide", "empty",
                                  "bench_1024"])
def test_stage_chunks_and_traffic_match_loops_tpu(name, super_kch):
    if name == "bench_1024":
        tb = generate.build_block_sparse(1024, 8, 128, 0.06, 0)[1]
        jb = _jax_block_sparse(1024, 8, 128, 0.06, 0)[1]
    else:
        t, j = pair(name)
        tb, jb = BCSR.from_csr(t, 8, 128), JaxBCSR.from_csr(j, 8, 128)
    SUPER, KCH = super_kch
    mine = spmm_bcsr_v3._stage_chunks(tb, SUPER, KCH)
    theirs = jax_stage_chunks(jb, SUPER, KCH)
    for a, b, what in zip(mine, theirs, ("chunk_ptr", "ccol", "bfetch",
                                          "bslot", "rowoff", "src")):
        assert a.dtype == b.dtype, what
        np.testing.assert_array_equal(a, b, err_msg=what)
    for F, itemsize in ((512, 4), (300, 2)):
        assert spmm_bcsr_v3.traffic_bytes(tb, F, itemsize, SUPER, KCH) == \
            _jax_traffic(jb, F, SUPER, KCH, itemsize)
    if (SUPER, KCH) == (256, 16):  # the bench's own defaults for R = 8
        assert spmm_bcsr_v3.traffic_bytes(tb, 512) == \
            _jax_traffic(jb, 512, SUPER, KCH)


def test_staged_slabs_match_loops_tpu():
    t, j = pair("tall")
    tb, jb = BCSR.from_csr(t, 8, 128), JaxBCSR.from_csr(j, 8, 128)
    mine, fn = spmm_bcsr_v3.bcsr_spmm_v3(tb, super_rows=4, chunk_blocks=2,
                                         device=CPU)
    theirs, _ = bcsr_spmm_pallas_v3(jb, super_rows=4, chunk_blocks=2)
    for name in ("a3d", "chunk_ptr", "ccol", "bfetch", "bslot", "rowoff"):
        np.testing.assert_array_equal(mine[name].numpy(),
                                      np.asarray(theirs[name]), err_msg=name)
    assert fn.meta["chunks"] == len(mine["ccol"])


def _emulate_k7(b, B, shape, meta):
    """numpy mirror of ``bcsr_spmm_v3_kernel``'s buffer protocol: per
    super-row, two B buffers filled only where ``bfetch`` says, into slot
    ``bslot``; each chunk's live slab rows times the buffer of its slot,
    added in chunk order at ``rowoff``."""
    rows, cols = shape
    R, KCH, SUPER = meta["R"], meta["KCH"], meta["SUPER"]
    a3d = b["a3d"].numpy()
    C = a3d.shape[2]
    ptr, ccol, bfetch, bslot, rowoff, nlive = (
        b[k].numpy() for k in ("chunk_ptr", "ccol", "bfetch", "bslot",
                               "rowoff", "nlive"))
    out = np.zeros((-(-rows // (SUPER * R)) * SUPER * R, B.shape[1]),
                   np.float32)
    for s in range(len(ptr) - 1):
        bufs = [None, None]  # stale from the last super-row: never read
        for t in range(ptr[s], ptr[s + 1]):
            if bfetch[t]:
                tile = np.zeros((C, B.shape[1]), np.float32)
                r0 = ccol[t] * C
                tile[:max(0, min(C, cols - r0))] = B[r0:r0 + C]
                bufs[bslot[t]] = tile
            for k in range(nlive[t]):
                row = (s * SUPER + rowoff[t * KCH + k]) * R
                out[row:row + R] += a3d[t, k * R:(k + 1) * R] @ bufs[bslot[t]]
    return out[:rows]


@pytest.mark.parametrize("super_kch", [(4, 2), (1, 1), (32, 8)])
@pytest.mark.parametrize("name", ["tall", "wide", "random"])
def test_k7_buffer_protocol_mirror(name, super_kch):
    """The chunk arrays drive K7's double-buffered B tiles to the right
    product: a fetch lands in the slot its chunks read, and no chunk
    reads a tile its super-row did not fetch."""
    t, _ = pair(name)
    tb = BCSR.from_csr(t, 8, 128)
    B = np.random.default_rng(6).normal(size=(t.shape[1], 24)).astype(
        np.float32)
    b, fn = spmm_bcsr_v3.bcsr_spmm_v3(tb, super_rows=super_kch[0],
                                      chunk_blocks=super_kch[1], device=CPU)
    mirror = _emulate_k7(b, B, t.shape, fn.meta)
    np.testing.assert_allclose(mirror, reference.spmm(t, B), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(fn(b, torch.from_numpy(B)).numpy(), mirror,
                               rtol=1e-5, atol=1e-5)


def _ldmatrix(smem, lane_rows, lane_cols, n_mats, trans):
    """``ldmatrix.m8n8.x{n_mats}[.trans]``: matrix m's row r at the address
    lane 8m + r gives; lane t receives, per matrix, (row t/4, columns 2(t%4)
    and +1), or with .trans (rows 2(t%4) and +1, column t/4)."""
    regs = np.zeros((32, n_mats, 2), np.float64)
    for m in range(n_mats):
        M = np.stack([smem[lane_rows[8 * m + r],
                           lane_cols[8 * m + r]:lane_cols[8 * m + r] + 8]
                      for r in range(8)])
        t = np.arange(32)
        if trans:
            regs[:, m] = np.stack([M[2 * (t % 4), t // 4],
                                   M[2 * (t % 4) + 1, t // 4]], 1)
        else:
            regs[:, m] = np.stack([M[t // 4, 2 * (t % 4)],
                                   M[t // 4, 2 * (t % 4) + 1]], 1)
    return regs


def _mma_m16n8k16(a, b):
    """mma.sync m16n8k16 row.col from per-lane fragments: a [32, 4, 2],
    b [32, 2, 2]; returns d [32, 4] (c0..c3 of each lane)."""
    A, Bm = np.zeros((16, 16)), np.zeros((16, 8))
    for t in range(32):
        g, q = t // 4, t % 4
        for i, (r, c) in enumerate(((g, 2 * q), (g + 8, 2 * q),
                                    (g, 2 * q + 8), (g + 8, 2 * q + 8))):
            A[r, c:c + 2] = a[t, i]
        for i, k in enumerate((2 * q, 2 * q + 8)):
            Bm[k:k + 2, g] = b[t, i]
    D = A @ Bm
    g, q = np.arange(32) // 4, np.arange(32) % 4
    return np.stack([D[g, 2 * q], D[g, 2 * q + 1], D[g + 8, 2 * q],
                     D[g + 8, 2 * q + 1]], 1)


def _k7_unit_bf16(As, Bs, q, g):
    """One warp's unit of ``k7_units`` (bf16): Bᵀ's fragments by
    ldmatrix.x4.trans over the B tile, A's by ldmatrix.x4 over the slab,
    the even and odd k-steps in two chains; returns the 16 x 8 (feature,
    row) tile as the lanes' accumulator fragments place it."""
    lanes = np.arange(32)
    d, e = np.zeros((32, 4)), np.zeros((32, 4))
    for c0 in range(0, As.shape[1] - 8, 128):
        for ks in range(0, 8, 2):
            af = _ldmatrix(As, 8 * q + (lanes & 7),
                           c0 + 16 * ks + 8 * (lanes >> 3), 4, trans=False)
            for k, chain in ((ks, d), (ks + 1, e)):
                bf = _ldmatrix(Bs, c0 + 16 * k + (lanes & 7) + 8 * (lanes >> 4),
                               16 * g + 8 * ((lanes >> 3) & 1), 4, trans=True)
                chain += _mma_m16n8k16(bf, af[:, 2 * (k - ks):2 * (k - ks) + 2])
    tile = np.zeros((16, 8))
    gid, tig = lanes >> 2, lanes & 3
    tile[gid, 2 * tig], tile[gid, 2 * tig + 1] = (d + e)[:, 0], (d + e)[:, 1]
    tile[gid + 8, 2 * tig], tile[gid + 8, 2 * tig + 1] = (d + e)[:, 2], \
        (d + e)[:, 3]
    return tile


def _k7_unit_f32(As, Bs, q, g):
    """One warp's unit of ``k7_units`` (f32), in its float32 order: lane
    (split s, quad fq) sums columns 32 j + 4 s + i by fma, then three
    shuffle rounds leave row s at lane s as (((S_s + S_s^4) + (S_s^2 +
    S_s^6)) + ((S_s^1 + S_s^5) + (S_s^3 + S_s^7))); returns [8, 16]."""
    C = As.shape[1]
    f32 = np.float32
    S = np.zeros((8, 8, 16), f32)  # split, row, feature
    a = As[8 * q:8 * q + 8]
    for s in range(8):
        for c0 in range(4 * s, C, 32):
            for i in range(4):
                c = c0 + i
                S[s] = (a[:, c:c + 1].astype(np.float64)
                        * Bs[c, 16 * g:16 * g + 16].astype(np.float64)
                        + S[s]).astype(f32)
    out = np.zeros((8, 16), f32)
    for r in range(8):
        P = [S[x][r] + S[x ^ 4][r] for x in range(8)]
        Q = [P[x] + P[x ^ 2] for x in range(8)]
        out[r] = Q[r] + Q[r ^ 1]
    return out


def _emulate_k7_tiles(b, B, shape, meta, bf16):
    """numpy mirror of ``bcsr_spmm_v3_kernel``'s work split: per
    (super-row, feature tile) an f32 accumulator; per chunk, warp w takes
    feature group w % G and units w / G, w / G + 8 / G, ...; each unit's
    tile adds into the accumulator rows at rowoff. Asserts that no two
    units of a chunk write the same accumulator entry."""
    rows, cols = shape
    R, KCH, SUPER, FT = meta["R"], meta["KCH"], meta["SUPER"], meta["FT"]
    a3d = b["a3d"].float().numpy()
    C = a3d.shape[2] if a3d.size else 128
    ptr, ccol, bslot, rowoff, nlive = (
        b[k].numpy() for k in ("chunk_ptr", "ccol", "bslot", "rowoff",
                               "nlive"))
    F = B.shape[1]
    G = FT // 16
    nft = -(-F // FT)
    Bp = np.zeros((-(-cols // C) * C, nft * FT), np.float32)
    Bp[:cols, :F] = B
    SR = SUPER * R
    out = np.zeros((len(ptr) - 1, SR, nft * FT))
    for s in range(len(ptr) - 1):
        for ft in range(nft):
            acc = np.zeros((SR, FT), np.float32)
            for t in range(ptr[s], ptr[s + 1]):
                Bs = np.zeros((C, FT + 8), np.float32)
                Bs[:, :FT] = Bp[ccol[t] * C:(ccol[t] + 1) * C,
                                ft * FT:(ft + 1) * FT]
                As = np.zeros((KCH * R, C + 8), np.float32)
                As[:, :C] = a3d[t]
                written = np.zeros((SR, FT), bool)
                for w in range(8):
                    g = w % G
                    for q in range(w // G, nlive[t] * R // 8, 8 // G):
                        arow = rowoff[t * KCH + 8 * q // R] * R + 8 * q % R
                        fs = slice(16 * g, 16 * g + 16)
                        assert not written[arow:arow + 8, fs].any()
                        written[arow:arow + 8, fs] = True
                        acc[arow:arow + 8, fs] += (
                            _k7_unit_bf16(As, Bs, q, g).T if bf16
                            else _k7_unit_f32(As[:, :C], Bs, q, g))
            out[s, :, ft * FT:(ft + 1) * FT] = acc
    return out.reshape(-1, nft * FT)[:rows, :F]


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
@pytest.mark.parametrize("block,super_kch,block_f", [
    ((8, 128), (4, 2), 32), ((8, 128), (None, None), 64),
    ((16, 128), (2, 2), 16), ((8, 256), (4, 4), 32)])
def test_k7_tile_order_mirror(dtype, block, super_kch, block_f):
    """K7's units on the card: the m16n8k16 fragments of the transposed
    product (bf16) and the f32 register tiles with their cross-lane sums,
    placed at the accumulator rows rowoff names, give A @ B over the
    mode's operands."""
    csr = generate.random_csr(70, 300, 0.03, seed=4)
    tb = BCSR.from_csr(csr, *block)
    b, fn = spmm_bcsr_v3.bcsr_spmm_v3(
        tb, block_f=block_f, super_rows=super_kch[0],
        chunk_blocks=super_kch[1], dtype=dtype, device=CPU)
    B = np.random.default_rng(7).normal(size=(300, 40)).astype(np.float32)
    ops_B = reference.bf16_round(B) if dtype else B
    ops_csr = (tf.csr_from_arrays(csr.shape, csr.offsets, csr.indices,
                                  reference.bf16_round(csr.vals))
               if dtype else csr)
    mirror = _emulate_k7_tiles(b, ops_B, csr.shape, fn.meta, dtype)
    np.testing.assert_allclose(mirror, reference.spmm(ops_csr, ops_B),
                               rtol=1e-5, atol=1e-5)


def _emulate_k8_tiles(b, B, shape, meta, bf16):
    """numpy mirror of ``bcsr_spmm_v2_kernel``'s work split: per
    (super-row, feature tile) an f32 accumulator; the super-row's blocks
    in storage order (``offsets``), one a step; warp w takes feature group
    w % G and the block's units w / G, w / G + 8 / G, ...; each unit is
    K7's (the m16n8k16 fragments in bf16, the f32 register tiles with
    their cross-lane sums) and adds into the accumulator rows of the
    block's block row (``brow``). Asserts that no two units of a block
    write the same accumulator entry."""
    rows, cols = shape
    R, C, SUPER, FT = meta["R"], meta["C"], meta["SUPER"], meta["FT"]
    vals = b["vals"].float().numpy()
    off, bcols, brow = (b[k].numpy() for k in ("offsets", "bcols", "brow"))
    F = B.shape[1]
    G = FT // 16
    nft = -(-F // FT)
    Bp = np.zeros((-(-cols // C) * C, nft * FT), np.float32)
    Bp[:cols, :F] = B
    SR = SUPER * R
    nbr = len(off) - 1
    nsup = -(-nbr // SUPER)
    out = np.zeros((nsup, SR, nft * FT), np.float32)
    for s in range(nsup):
        t0, t1 = off[min(s * SUPER, nbr)], off[min((s + 1) * SUPER, nbr)]
        for ft in range(nft):
            acc = np.zeros((SR, FT), np.float32)
            for t in range(t0, t1):
                Bs = np.zeros((C, FT + 8), np.float32)
                Bs[:, :FT] = Bp[bcols[t] * C:(bcols[t] + 1) * C,
                                ft * FT:(ft + 1) * FT]
                As = np.zeros((R, C + 8), np.float32)
                As[:, :C] = vals[t]
                arow = (brow[t] - s * SUPER) * R
                written = np.zeros((SR, FT), bool)
                for w in range(8):
                    g = w % G
                    for q in range(w // G, R // 8, 8 // G):
                        row, fs = arow + 8 * q, slice(16 * g, 16 * g + 16)
                        assert not written[row:row + 8, fs].any()
                        written[row:row + 8, fs] = True
                        acc[row:row + 8, fs] += (
                            _k7_unit_bf16(As, Bs, q, g).T if bf16
                            else _k7_unit_f32(As[:, :C], Bs, q, g))
            out[s, :, ft * FT:(ft + 1) * FT] = acc
    return out.reshape(-1, nft * FT)[:rows, :F]


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
@pytest.mark.parametrize("block,super_rows,block_f", [
    ((8, 128), None, 128), ((8, 128), 2, 32), ((16, 128), 4, 64),
    ((8, 256), 2, 16)])
def test_k8_tile_order_mirror(dtype, block, super_rows, block_f):
    """K8's steps on the card: one block a step in storage order, K7's
    units (bf16 fragments of the transposed product; f32 column-split
    register tiles summed across lanes in a fixed order) split over the
    warps and added at the block row's accumulator rows, give A @ B over
    the mode's operands; the plain version agrees."""
    csr = generate.random_csr(70, 300, 0.03, seed=4)
    tb = BCSR.from_csr(csr, *block)
    b, fn = spmm_bcsr_v2.bcsr_spmm_v2(tb, block_f=block_f,
                                      super_rows=super_rows, dtype=dtype,
                                      device=CPU)
    B = np.random.default_rng(7).normal(size=(300, 40)).astype(np.float32)
    ops_B = reference.bf16_round(B) if dtype else B
    ops_csr = (tf.csr_from_arrays(csr.shape, csr.offsets, csr.indices,
                                  reference.bf16_round(csr.vals))
               if dtype else csr)
    mirror = _emulate_k8_tiles(b, ops_B, csr.shape, fn.meta, dtype)
    np.testing.assert_allclose(mirror, reference.spmm(ops_csr, ops_B),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(fn(b, torch.from_numpy(B)).numpy(), mirror,
                               rtol=1e-5, atol=1e-5)


def _emulate_k9(b, B, shape):
    """numpy mirror of ``bcsr_spmm_kernel``'s sums in their float32 order:
    each output (row, feature) is one thread's fma chain over the row's
    blocks in storage order and each block's columns in order, stopping at
    the matrix's last column; the thread's 4 features are contiguous."""
    rows, cols = shape
    vals = b["vals"].numpy()
    nb, R, C = vals.shape
    off, bcols = b["offsets"].numpy(), b["bcols"].numpy()
    out = np.zeros((len(off) - 1, R, B.shape[1]), np.float32)
    for br in range(len(off) - 1):
        acc = np.zeros((R, B.shape[1]), np.float32)
        for t in range(off[br], off[br + 1]):
            c0 = bcols[t] * C
            for c in range(min(C, cols - c0)):
                acc = (vals[t, :, c:c + 1].astype(np.float64)
                       * B[c0 + c].astype(np.float64) + acc).astype(
                    np.float32)
        out[br] = acc
    return out.reshape(-1, B.shape[1])[:rows]


@pytest.mark.parametrize("block", [(8, 128), (16, 128), (8, 256)])
@pytest.mark.parametrize("name", ["random", "empty_rows", "wide"])
def test_k9_storage_order_mirror(name, block):
    """K9's per-output fma chains, over the row's blocks in storage order,
    give A @ B; the plain version agrees within the pair tolerance."""
    t, _ = pair(name)
    tb = BCSR.from_csr(t, *block)
    B = np.random.default_rng(8).normal(size=(t.shape[1], 70)).astype(
        np.float32)
    b, fn = spmm_bcsr.bcsr_spmm(tb, device=CPU)
    mirror = _emulate_k9(b, B, t.shape)
    np.testing.assert_allclose(mirror, reference.spmm(t, B), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(fn(b, torch.from_numpy(B)).numpy(), mirror,
                               rtol=1e-5, atol=1e-5)


def test_card_tiles_fit_shared_memory():
    # the card's defaults at the bench's 8 x 128 blocks, in both modes
    f32, bf16 = torch.float32, torch.bfloat16
    assert spmm_bcsr_v3.card_tiles(8) == (128, 4)
    assert spmm_bcsr_v3.card_tiles(8, "bfloat16") == (64, 8)
    assert spmm_bcsr_v3.card_tiles(16, "bfloat16") == (32, 4)
    t7 = spmm_bcsr_v3.tiles(8, 128, f32, *spmm_bcsr_v3.card_tiles(8), 512)
    assert (t7["SUPER"], t7["KCH"], t7["FT"]) == (128, 4, 32)
    # acc [1024][36] f32 + 2 slabs [32][128] + 2 B tiles [128][36] + rowoff
    assert t7["smem"] == 4 * 1024 * 36 + 2 * 4 * (32 * 128 + 128 * 36) \
        + 2 * 4 * 4 == 217120
    tb = spmm_bcsr_v3.tiles(8, 128, bf16,
                            *spmm_bcsr_v3.card_tiles(8, "bfloat16"), 512)
    assert (tb["SUPER"], tb["KCH"], tb["FT"]) == (64, 8, 64)
    # bf16 rows padded by 16 bytes for ldmatrix
    assert tb["smem"] == 4 * 512 * 68 + 2 * 2 * (64 * 136 + 128 * 72) \
        + 2 * 4 * 8 == 211008
    for t in (t7, tb):
        assert t["smem"] <= spmm_bcsr.SMEM_LIMIT
        assert t["FT"] in (16, 32, 64, 128)  # a divisor of 8 warps' units
    # K8: one block row a super-row at 8-row blocks, 128-column tiles
    t8 = spmm_bcsr_v2.tiles(8, 128, f32, None, 512)
    assert (t8["SUPER"], t8["FT"], t8["smem"]) == (1, 128, 4 * 8 * 132
                                                   + 2 * 4 * 8 * 128)
    # in bf16 two B tiles beside the two blocks, rows padded by 16 bytes
    t8b = spmm_bcsr_v2.tiles(8, 128, bf16, None, 512)
    assert (t8b["SUPER"], t8b["FT"], t8b["smem"]) == (
        1, 128, 4 * 8 * 132 + 2 * 2 * (8 * 136 + 128 * 136))
    assert spmm_bcsr_v2.tiles(16, 128, f32, 4, 64)["FT"] == 64
    assert spmm_bcsr_v2.tiles(8, 128, f32, None, 16)["FT"] == 16
    with pytest.raises(ValueError, match="multiple of 16"):
        spmm_bcsr_v2.tiles(8, 128, f32, None, 24)
    # wider blocks halve the feature tile until the CTA fits; block_f caps it
    assert spmm_bcsr_v3.tiles(8, 256, bf16, 64, 8, 512)["FT"] == 32
    assert spmm_bcsr_v3.tiles(8, 128, bf16, 64, 8, 16)["FT"] == 16
    assert spmm_bcsr_v3.tiles(8, 128, f32, 8, 4, 512)["FT"] == 128
    with pytest.raises(ValueError, match="shared memory"):
        spmm_bcsr_v3.tiles(8, 4096, f32, 32, 8, 512)
    with pytest.raises(ValueError, match="multiple of 16"):
        spmm_bcsr_v3.tiles(8, 128, f32, 32, 8, 12)
    # the defaults shrink KCH, then SUPER, for blocks too wide to fit
    assert spmm_bcsr_v3.default_tiles(8, 1024, f32, None, 512)["KCH"] < 4
    # K9: one 512-column tile a CTA; block_f is checked as the TPU's tile
    assert spmm_bcsr.K9_TILE == 512
    assert spmm_bcsr.check_block_f(256) == 256
    with pytest.raises(ValueError, match="multiple of 128"):
        spmm_bcsr.check_block_f(96)


def test_stage_b_pads_only_when_needed():
    B = torch.ones(10, 8)
    assert spmm_bcsr.stage_b(B, None)[0] is B
    Bk, ld = spmm_bcsr.stage_b(torch.ones(10, 5), None)
    assert ld == 8 and tuple(Bk.shape) == (10, 8) and not Bk[:, 5:].any()
    Bk, ld = spmm_bcsr.stage_b(torch.ones(10, 20), "bfloat16")
    assert ld == 24 and Bk.dtype == torch.bfloat16


def test_refusals():
    t, _ = pair("random")
    b4 = BCSR.from_csr(t, 4, 128)
    b8 = BCSR.from_csr(t, 8, 128)
    with pytest.raises(ValueError, match="R%8"):
        SpMVOperator(b4, impl="pallas", device=CPU)
    with pytest.raises(ValueError, match="C==128"):
        SpMVOperator(BCSR.from_csr(t, 8, 256), impl="pallas", device=CPU)
    for impl in ("pallas", "pallas2", "pallas3"):
        with pytest.raises(ValueError, match="R%8"):
            SpMMOperator(b4, impl=impl, device=CPU)
        with pytest.raises(ValueError, match="C%128"):
            SpMMOperator(BCSR.from_csr(t, 8, 64), impl=impl, device=CPU)
    for impl in ("xla", "pallas"):
        with pytest.raises(ValueError, match="bfloat16"):
            SpMMOperator(b8, impl=impl, dtype="bfloat16", device=CPU)
    with pytest.raises(ValueError, match="impl"):
        SpMMOperator(b8, impl="mosaic", device=CPU)
    with pytest.raises(ValueError, match="schedule"):
        SpMMOperator(b8, "group_mapped", device=CPU)
    with pytest.raises(ValueError):
        SpMVOperator(b8, "merge_path", device=CPU)
    with pytest.raises(ValueError):
        SpMVOperator(b8, impl="pallas2", device=CPU)
    # the xla path takes any block shape
    B = np.random.default_rng(0).normal(size=(36, 5)).astype(np.float32)
    np.testing.assert_allclose(SpMMOperator(b4, device=CPU)(B).numpy(),
                               reference.spmm(t, B), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("impl", ["pallas", "pallas2", "pallas3"])
def test_f64_kernel_request_warns_and_takes_torch_path(impl):
    f64 = generate.random_csr(20, 140, 0.2, seed=13, dtype=np.float64)
    bcsr = BCSR.from_csr(f64, 8, 128)
    B = np.random.default_rng(2).normal(size=(140, 6))
    with pytest.warns(UserWarning, match="float64"):
        op = SpMMOperator(bcsr, impl=impl, device=CPU)
    assert op.impl_used == "torch"
    C = op(B).numpy()
    assert C.dtype == np.float64
    np.testing.assert_allclose(C, reference.spmm(f64, B), rtol=1e-12,
                               atol=1e-12)
    if impl == "pallas":
        x = np.random.default_rng(3).normal(size=140)
        with pytest.warns(UserWarning, match="float64"):
            vop = SpMVOperator(bcsr, impl=impl, device=CPU)
        assert vop.impl_used == "torch"
        np.testing.assert_allclose(vop(x).numpy(), reference.spmv(f64, x),
                                   rtol=1e-12, atol=1e-12)


def test_bcsr_wrappers_refuse_cpu_tensors():
    t, _ = pair("random")
    b = BCSR.from_csr(t, 8, 128)
    x, B = torch.zeros(36), torch.zeros(36, 4)
    bufs6, _ = spmv_bcsr.bcsr_spmv(b, device=CPU)
    with pytest.raises(ValueError, match="CUDA tensor"):
        spmv_bcsr.bcsr_spmv_cuda(bufs6, x, t.shape)
    bufs9, _ = spmm_bcsr.bcsr_spmm(b, device=CPU)
    with pytest.raises(ValueError, match="CUDA tensor"):
        spmm_bcsr.bcsr_spmm_cuda(bufs9, B, t.shape)
    bufs8, f8 = spmm_bcsr_v2.bcsr_spmm_v2(b, device=CPU)
    with pytest.raises(ValueError, match="CUDA tensor"):
        spmm_bcsr_v2.bcsr_spmm_v2_cuda(bufs8, B, t.shape, f8.meta)
    bufs7, f7 = spmm_bcsr_v3.bcsr_spmm_v3(b, device=CPU)
    with pytest.raises(ValueError, match="CUDA tensor"):
        spmm_bcsr_v3.bcsr_spmm_v3_cuda(bufs7, B, t.shape, f7.meta)


def test_empty_matrix_gives_zeros():
    t, _ = pair("empty")
    b = BCSR.from_csr(t, 8, 128)
    B = np.ones((10, 3), np.float32)
    for impl in ("xla", "pallas", "pallas2", "pallas3"):
        C = SpMMOperator(b, impl=impl, device=CPU)(B)
        assert tuple(C.shape) == (12, 3) and not C.any()
    for impl in ("xla", "pallas"):
        y = SpMVOperator(b, impl=impl, device=CPU)(np.ones(10, np.float32))
        assert tuple(y.shape) == (12,) and not y.any()


def test_example_cli_bcsr_on_cpu():
    r = subprocess.run(
        [sys.executable, "examples/spmm_torch.py", "--device", "cpu",
         "--format", "bcsr", "--impl", "pallas", "--validate", "--rows",
         "512", "--cols", "384", "--feature-dim", "40"],
        capture_output=True, text=True, timeout=180, cwd=REPO)
    assert r.returncode == 0, r.stdout + r.stderr
    lines = r.stdout.splitlines()
    assert lines[0].startswith("spmm_bcsr_row_mapped_pallas,random,512,384,")
    assert len(lines[0].split(",")) == 7
    assert "Errors: 0" in lines
    assert "impl_used: bcsr_spmm launches: 0" in r.stderr
