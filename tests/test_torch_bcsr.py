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


def test_card_tiles_fit_shared_memory():
    # the card's defaults at the bench's 8 x 128 blocks
    f32, bf16 = torch.float32, torch.bfloat16
    t7 = spmm_bcsr_v3.tiles(8, 128, f32, *spmm_bcsr_v3.card_tiles(8), 512)
    assert (t7["SUPER"], t7["KCH"], t7["FT"]) == (32, 8, 64)
    assert t7["smem"] == 196608
    assert spmm_bcsr_v3.tiles(8, 128, bf16, 32, 8, 512)["smem"] == 131072
    t8 = spmm_bcsr_v2.tiles(8, 128, f32, None, 512)
    assert (t8["SUPER"], t8["FT"], t8["smem"]) == (16, 64, 106496)
    # wider blocks halve the feature tile until the CTA fits
    assert spmm_bcsr_v3.tiles(8, 256, f32, 32, 8, 512)["FT"] == 32
    assert spmm_bcsr_v3.tiles(8, 128, f32, 32, 8, 16)["FT"] == 16
    with pytest.raises(ValueError, match="shared memory"):
        spmm_bcsr_v3.tiles(8, 4096, f32, 32, 8, 512)
    with pytest.raises(ValueError, match="multiple of 8"):
        spmm_bcsr_v3.tiles(8, 128, f32, 32, 8, 12)
    assert spmm_bcsr.features_per_thread(512, 512) == 4
    assert spmm_bcsr.features_per_thread(20, 512) == 1
    assert spmm_bcsr.features_per_thread(300, 256) == 2
    with pytest.raises(ValueError, match="multiple of 128"):
        spmm_bcsr.features_per_thread(300, 96)


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
