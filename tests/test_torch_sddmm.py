"""The SDDMM slice of the port on the CPU, against ``loops_tpu`` on the
same numpy inputs: ``sddmm`` for CSR and COO (``xla``, f32 and bf16) and
BCSR (``xla`` and ``pallas``), K5's and K10's plain versions against the
JAX package's Pallas kernels in interpret mode (as
``tests/test_spmm_sddmm.py`` runs them), K5's staging, nnz = 0,
the refusals, the operator cache, the validator from both sides, numpy
mirrors of the two CUDA kernels' summation orders, the stream probe K11
and ``scripts/primitives_torch.py``.

Tolerances:

- f32 paths against ``loops_tpu`` and the host reference:
  ``count_mismatches(atol=1e-3, rtol=1e-4) == 0``, as the JAX tests use,
  and ``NOT_A_BUG`` from ``rigorously_validate_sddmm``.
- bf16 ``xla`` against ``loops_tpu``'s bf16 ``xla``: both compute
  ``vals * sum bf16(A) * bf16(B)`` with exact f32 products, so twice the
  f32 Wilkinson bound over the rounded operands, floor 1e-6.
- K5's plain version against the JAX kernel: both round identically, so
  twice the f32 summation bound over K5's terms,
  ``2 * 4 * F * u32 * sum_f |bf16(A) * bf16(v * bf16(B))|``, floor 1e-6.
- K5 against the bf16 ``xla`` path: the two differ by rounding
  ``v * bf16(B)`` to bf16, at most ``2**-8`` of each term, so
  ``2**-8 * |v| sum_f |a b|`` plus twice the f32 summation bound.
"""
import functools
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

import loops_tpu.utils.generate as jgen
import loops_tpu_torch.formats as tf
from loops_tpu.formats import BCSR as JaxBCSR, COO as JaxCOO, CSR as JaxCSR
from loops_tpu.ops import sddmm as jax_sddmm
from loops_tpu.ops.kernels.sddmm_bcsr import bcsr_sddmm_pallas
from loops_tpu.ops.kernels.sddmm_flat import flat_sddmm_pallas
from loops_tpu_torch.formats import BCSR, CSR
from loops_tpu_torch.ops import SDDMMOperator, sddmm
from loops_tpu_torch.ops.kernels import sddmm_bcsr, sddmm_flat
from loops_tpu_torch.utils import generate, reference, stream
from loops_tpu_torch.utils.equal import count_mismatches

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16 = "bfloat16"
U32 = reference.unit_roundoff(np.float32)
# tests/test_spmm_sddmm.py:11-16 and :191-198
CASES = {
    "random": lambda: jgen.random_csr(40, 36, 0.15, seed=11),
    "skewed": lambda: jgen.skewed_csr(24, 30, heavy_rows=3),
    "empty_rows": lambda: jgen.empty_row_csr(21, 18),
    "block_diag": lambda: jgen.block_diag_csr(5, 4),
}
FLAT = {
    "uniform": lambda: jgen.random_csr(1024, 1024, 0.01, seed=2),
    "rect": lambda: jgen.random_csr(768, 1536, 0.01, seed=3),
    "skewed": lambda: jgen.skewed_csr(512, 512, heavy_rows=4),
}
BCSR_CASES = {
    "random": lambda: jgen.random_csr(40, 36, 0.15, seed=11),
    "skewed": lambda: jgen.skewed_csr(24, 30, heavy_rows=3),
    "empty_rows": lambda: jgen.empty_row_csr(21, 18),
    "block_diag": lambda: jgen.block_diag_csr(5, 4),
    "tall": lambda: jgen.random_csr(600, 300, 0.02, seed=2),
}


def _operands(shape, F, seed_a=5, seed_b=6):
    rng_a, rng_b = np.random.default_rng(seed_a), np.random.default_rng(seed_b)
    return (rng_a.normal(size=(shape[0], F)).astype(np.float32),
            rng_b.normal(size=(shape[1], F)).astype(np.float32))


def _port(j):
    return tf.csr_from_arrays(j.shape, j.offsets, j.indices, j.vals)


@functools.lru_cache(maxsize=None)
def flat_case(name, F):
    """(port CSR, A, B, loops_tpu's K5 output at block_atoms=256)."""
    j = FLAT[name]()
    A, B = _operands(j.shape, F)
    bufs, fn = flat_sddmm_pallas(j, block_atoms=256)
    return _port(j), A, B, np.asarray(fn(bufs, A, B))


def _k5_bound(csr, A, B):
    t = reference.sddmm_terms(csr, A, B, np.arange(csr.nnz), BF16)
    return reference.sddmm_bound(t, atol_floor=0.0), t


# ------------------------------------------------------------ CSR / COO
@pytest.mark.parametrize("dtype", [None, BF16])
@pytest.mark.parametrize("name", sorted(CASES))
def test_sddmm_csr_matches_loops_tpu(name, dtype):
    j = CASES[name]()
    t = _port(j)
    A, B = _operands(j.shape, 12)
    op = SDDMMOperator(t, dtype=dtype, device=CPU)
    out = op(A, B)
    assert op.impl_used == "torch" and op.launches == 0
    assert out.dtype == torch.float32 and tuple(out.shape) == (t.nnz,)
    out = out.numpy()
    want = np.asarray(jax_sddmm(j, A, B, dtype=dtype))
    if dtype is None:
        assert count_mismatches(out, want, atol=1e-3, rtol=1e-4) == 0
        assert count_mismatches(out, reference.sddmm(t, A, B), 1e-3,
                                1e-4) == 0
        rep = reference.rigorously_validate_sddmm(t, A, B, out)
    else:
        rA, rB = reference.bf16_round(A), reference.bf16_round(B)
        terms = reference.sddmm_terms(t, rA, rB, np.arange(t.nnz))
        tol = 2 * reference.sddmm_bound(terms)
        assert np.all(np.abs(out.astype(np.float64) - want) <= tol)
        rep = reference.rigorously_validate_sddmm(t, rA, rB, out)
    assert rep.verdict == "NOT_A_BUG", rep


@pytest.mark.parametrize("name", ["random", "empty_rows", "skewed"])
def test_sddmm_coo_matches_loops_tpu(name):
    j = CASES[name]()
    t = _port(j)
    A, B = _operands(j.shape, 12)
    out = sddmm(t.to_coo(), A, B, device=CPU).numpy()
    want = np.asarray(jax_sddmm(j.to_coo(), A, B))
    assert count_mismatches(out, want, atol=1e-3, rtol=1e-4) == 0
    # a row-sorted COO holds its nonzeros in CSR order
    np.testing.assert_allclose(out, sddmm(t, A, B, device=CPU).numpy(),
                               rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------ BCSR
@pytest.mark.parametrize("F", [12, 300])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("block", [(8, 128), (16, 128)])
@pytest.mark.parametrize("name", ["block_diag", "random", "tall"])
def test_sddmm_bcsr_matches_loops_tpu(name, block, impl, F):
    j = BCSR_CASES[name]()
    tb = BCSR.from_csr(_port(j), *block)
    A, B = _operands(j.shape, F)
    op = SDDMMOperator(tb, impl=impl, block_f=128, device=CPU)
    assert op.impl_used == ("sddmm_bcsr" if impl == "pallas" else "torch")
    out = op(A, B)
    assert out.dtype == torch.float32
    assert tuple(out.shape) == (tb.num_blocks, *block)
    want = np.asarray(jax_sddmm(JaxBCSR.from_csr(j, *block), A, B,
                                impl=impl, block_f=128))
    assert count_mismatches(out.numpy(), want, atol=1e-3, rtol=1e-4) == 0


@pytest.mark.parametrize("F", [12, 300])
@pytest.mark.parametrize("block", [(8, 128), (16, 128)])
@pytest.mark.parametrize("name", sorted(BCSR_CASES))
def test_k10_plain_matches_pallas_kernel(name, block, F):
    j = BCSR_CASES[name]()
    tb = BCSR.from_csr(_port(j), *block)
    A, B = _operands(j.shape, F)
    bufs, fn = bcsr_sddmm_pallas(JaxBCSR.from_csr(j, *block), block_f=128)
    want = np.asarray(fn(bufs, A, B))
    b, _ = sddmm_bcsr.sddmm_bcsr(tb, block_f=128, device=CPU)
    got = sddmm_bcsr.sddmm_bcsr_plain(b, torch.from_numpy(A),
                                      torch.from_numpy(B), tb.shape).numpy()
    assert count_mismatches(got, want, atol=1e-3, rtol=1e-4) == 0
    # and the dense oracle at the stored blocks (test_spmm_sddmm.py:100-113)
    np.testing.assert_allclose(got, _dense_block_oracle(tb, A, B),
                               atol=1e-4, rtol=1e-4)


def _dense_block_oracle(tb, A, B):
    R, C = tb.block_shape
    dots = A.astype(np.float64) @ B.astype(np.float64).T
    rows, cols = tb.shape
    out = np.zeros((tb.num_blocks, R, C))
    for k, br in enumerate(tb.block_row_ids()):
        r0, c0 = br * R, tb.block_cols[k] * C
        rr, cc = min(R, rows - r0), min(C, cols - c0)
        out[k, :rr, :cc] = dots[r0:r0 + rr, c0:c0 + cc]
    return tb.vals * out


def _k10_mirror(tb, A, B):
    """numpy mirror of ``sddmm_bcsr_kernel``: per (block, sub-tile of ROWS
    rows x 128 columns) the 64-column feature tiles in order, rows past
    the matrix as zeros, one fused multiply-add per feature (f64 product,
    one rounding to f32), then one product with vals."""
    R, C = tb.block_shape
    rows, cols = tb.shape
    F = A.shape[1]
    ROWS = sddmm_bcsr.rows_per_cta(R)
    out = np.zeros((tb.num_blocks, R, C), np.float32)
    for t, br in enumerate(tb.block_row_ids()):
        for r0 in range(0, R, ROWS):
            for c0 in range(0, C, 128):
                ar = br * R + r0 + np.arange(ROWS)
                bc = tb.block_cols[t] * C + c0 + np.arange(128)
                a = np.where((ar < rows)[:, None], A[np.minimum(ar, rows - 1)],
                             0).astype(np.float64)
                b = np.where((bc < cols)[:, None], B[np.minimum(bc, cols - 1)],
                             0).astype(np.float64)
                acc = np.zeros((ROWS, 128), np.float32)
                for f0 in range(0, F, 64):
                    for f in range(f0, min(f0 + 64, F)):
                        acc = (a[:, f, None] * b[None, :, f]
                               + acc).astype(np.float32)
                out[t, r0:r0 + ROWS, c0:c0 + 128] = (
                    tb.vals[t, r0:r0 + ROWS, c0:c0 + 128] * acc)
    return out


@pytest.mark.parametrize("block,F", [((8, 128), 20), ((16, 128), 150),
                                     ((8, 256), 70)])
def test_k10_tile_loop_mirror(block, F):
    t = _port(BCSR_CASES["tall"]())
    tb = BCSR.from_csr(t, *block)
    A, B = _operands(t.shape, F)
    mirror = _k10_mirror(tb, A, B)
    np.testing.assert_allclose(mirror, _dense_block_oracle(tb, A, B),
                               atol=1e-4, rtol=1e-4)
    b, fn = sddmm_bcsr.sddmm_bcsr(tb, device=CPU)
    np.testing.assert_allclose(fn(b, torch.from_numpy(A),
                                  torch.from_numpy(B)).numpy(), mirror,
                               atol=1e-4, rtol=1e-4)


# --------------------------------------------------------------------- K5
@pytest.mark.parametrize("F", [64, 20])
@pytest.mark.parametrize("name", sorted(FLAT))
def test_k5_plain_matches_pallas_kernel(name, F):
    t, A, B, want = flat_case(name, F)
    b, fn = sddmm_flat.sddmm_flat(t, device=CPU)
    got = fn(b, torch.from_numpy(A), torch.from_numpy(B))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    got = got.numpy()
    bound, _ = _k5_bound(t, A, B)
    tol = np.maximum(1e-6, 2 * bound)
    assert np.all(np.abs(got.astype(np.float64) - want) <= tol)
    rep = reference.rigorously_validate_sddmm(t, A, B, got, operands=BF16)
    assert rep.verdict == "NOT_A_BUG" and rep.kernel_overruns == 0, rep
    # the JAX kernel's own bound against the f32 reference
    ref = reference.sddmm(t, A, B)
    assert np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-9) < 2e-2


@pytest.mark.parametrize("name", sorted(FLAT) + [
    f"battery_{k}" for k in sorted(generate.BATTERY)])
def test_k5_staging_matches_loops_tpu_csr(name):
    """K5 stages the row ids, columns and values as the CSR stores them:
    the JAX CSR's ``row_ids()``, ``indices`` and ``vals``, in order."""
    if name.startswith("battery_"):
        c = generate.BATTERY[name[len("battery_"):]]()
        j = JaxCSR(c.shape, c.offsets, c.indices, c.vals)
    else:
        j = FLAT[name]()
    b, fn = sddmm_flat.sddmm_flat(_port(j), device=CPU)
    assert sorted(b) == ["cols", "rows", "vals"]
    assert b["rows"].dtype == b["cols"].dtype == torch.int32
    assert b["vals"].dtype == torch.float32
    np.testing.assert_array_equal(b["rows"].numpy(), j.row_ids())
    np.testing.assert_array_equal(b["cols"].numpy(), j.indices)
    np.testing.assert_array_equal(b["vals"].numpy(), j.vals)
    assert fn.meta["nnz"] == j.nnz


def _k5_mirror(a, g, vec, G):
    """numpy mirror of ``sddmm_flat_kernel`` over rounded rows a, g [n, F]:
    lane j of the group sums pieces j, j+G, ... of VEC values each, in
    order (each product exact in f32), then the xor-shuffle tree."""
    n, F = a.shape
    lanes = np.zeros((n, G), np.float32)
    for j in range(G):
        for p in range(j, -(-F // vec), G):
            for f in range(p * vec, min(p * vec + vec, F)):
                lanes[:, j] = lanes[:, j] + a[:, f] * g[:, f]
    off = G // 2
    while off:
        lanes = lanes + lanes[:, np.arange(G) ^ off]
        off //= 2
    return lanes[:, 0]


@pytest.mark.parametrize("F", [1, 20, 33, 64, 128, 300])
def test_k5_lane_and_shuffle_order_mirror(F):
    t = _port(FLAT["skewed"]())
    A, B = _operands(t.shape, F)
    terms = reference.sddmm_terms(t, A, B, np.arange(t.nnz), BF16)
    a = reference.bf16_round(A[t.row_ids()])
    v = t.vals[:, None]
    g = reference.bf16_round(v * reference.bf16_round(B[t.indices]))
    # the piece the wrapper picks: up to 16 bytes of the bf16 copies
    vec = sddmm_flat.piece_width(F)
    G = sddmm_flat.lane_group(F, vec)
    assert (vec, G) == {1: (1, 1), 20: (4, 8), 33: (1, 32), 64: (8, 8),
                        128: (8, 16), 300: (4, 32)}[F]
    mirror = _k5_mirror(a, g, vec, G)
    exact = terms.sum(axis=1)
    bound = reference.sddmm_bound(terms)
    assert np.all(np.abs(mirror - exact) <= bound)
    b, fn = sddmm_flat.sddmm_flat(t, device=CPU)
    plain = fn(b, torch.from_numpy(A), torch.from_numpy(B)).numpy()
    assert np.all(np.abs(plain.astype(np.float64) - mirror) <= 2 * bound)


@pytest.mark.parametrize("name", sorted(CASES))
def test_k5_against_bf16_xla_path(name):
    t = _port(CASES[name]())
    A, B = _operands(t.shape, 32)
    k5 = SDDMMOperator(t, impl="pallas", dtype=BF16, device=CPU)
    assert k5.impl_used == "sddmm_flat"
    got = k5(A, B).numpy()
    xla = sddmm(t, A, B, dtype=BF16, device=CPU).numpy()
    rA, rB = reference.bf16_round(A), reference.bf16_round(B)
    terms = reference.sddmm_terms(t, rA, rB, np.arange(t.nnz))
    l1 = np.abs(terms).sum(axis=1)
    tol = np.maximum(1e-6, 2.0 ** -8 * l1 + 2 * reference.sddmm_bound(terms))
    assert np.all(np.abs(got.astype(np.float64) - xla) <= tol)


# ------------------------------------------------------- edges, refusals
def test_no_nonzeros():
    empty = CSR((12, 10), np.zeros(13, np.int64), np.zeros(0, np.int64),
                np.zeros(0, np.float32))
    A, B = _operands(empty.shape, 6)
    for impl, dtype in (("xla", None), ("xla", BF16), ("pallas", BF16)):
        out = SDDMMOperator(empty, impl=impl, dtype=dtype, device=CPU)(A, B)
        assert out.dtype == torch.float32 and tuple(out.shape) == (0,)
    assert tuple(sddmm(empty.to_coo(), A, B, device=CPU).shape) == (0,)
    b, fn = sddmm_flat.sddmm_flat(empty, device=CPU)
    assert fn.meta["nnz"] == 0 and tuple(fn(b, torch.from_numpy(A),
                                            torch.from_numpy(B)).shape) == (0,)
    jax_out = np.asarray(flat_sddmm_pallas(JaxCOO((12, 10), [], [], [])
                                           .to_csr())[1](None, A, B))
    assert jax_out.shape == (0,)
    tb = BCSR.from_csr(empty, 8, 128)
    for impl in ("xla", "pallas"):
        out = SDDMMOperator(tb, impl=impl, device=CPU)(A, B)
        assert tuple(out.shape) == (0, 8, 128)


def test_refusals_and_cpu_warning():
    t = _port(CASES["random"]())
    A, B = _operands(t.shape, 8)
    with pytest.warns(UserWarning, match="bf16-operand kernel K5"):
        op = SDDMMOperator(t, impl="pallas", device=CPU)
    assert op.impl_used == "torch"
    np.testing.assert_allclose(op(A, B).numpy(), reference.sddmm(t, A, B),
                               rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="impl"):
        SDDMMOperator(t, impl="pallas2", device=CPU)
    with pytest.raises(ValueError, match="dtype"):
        SDDMMOperator(t, dtype="float16", device=CPU)
    with pytest.raises(ValueError, match="COO"):
        SDDMMOperator(t.to_coo(), impl="pallas", dtype=BF16, device=CPU)
    with pytest.raises(TypeError, match="unsupported format"):
        SDDMMOperator(t.to_csc(), device=CPU)
    tb = BCSR.from_csr(t, 8, 128)
    with pytest.raises(ValueError, match="bfloat16"):
        SDDMMOperator(tb, impl="pallas", dtype=BF16, device=CPU)
    with pytest.raises(ValueError, match="R%8"):
        SDDMMOperator(BCSR.from_csr(t, 4, 128), impl="pallas", device=CPU)
    with pytest.raises(ValueError, match="C%128"):
        SDDMMOperator(BCSR.from_csr(t, 8, 64), impl="pallas", device=CPU)
    # the torch path takes any block shape
    b4 = BCSR.from_csr(t, 4, 64)
    np.testing.assert_allclose(
        SDDMMOperator(b4, device=CPU)(A, B).numpy(),
        _dense_block_oracle(b4, A, B), atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="expected"):
        op(A[:, :5], B)
    with pytest.raises(ValueError, match="expected"):
        op(A[:-1], B)


def test_f64_bcsr_kernel_request_warns_and_takes_torch_path():
    f64 = generate.random_csr(20, 140, 0.2, seed=13, dtype=np.float64)
    tb = BCSR.from_csr(f64, 8, 128)
    A, B = _operands(f64.shape, 6)
    with pytest.warns(UserWarning, match="float64"):
        op = SDDMMOperator(tb, impl="pallas", device=CPU)
    assert op.impl_used == "torch"
    out = op(A, B).numpy()
    assert out.dtype == np.float64
    np.testing.assert_allclose(out, _dense_block_oracle(tb, A, B),
                               rtol=1e-12, atol=1e-12)


def test_wrappers_refuse_cpu_tensors():
    t = _port(CASES["random"]())
    A, B = (torch.from_numpy(x) for x in _operands(t.shape, 8))
    b5, _ = sddmm_flat.sddmm_flat(t, device=CPU)
    with pytest.raises(ValueError, match="CUDA tensor"):
        sddmm_flat.sddmm_flat_cuda(b5, A, B, t.shape, t.nnz)
    b10, _ = sddmm_bcsr.sddmm_bcsr(BCSR.from_csr(t, 8, 128), device=CPU)
    with pytest.raises(ValueError, match="CUDA tensor"):
        sddmm_bcsr.sddmm_bcsr_cuda(b10, A, B, t.shape)
    with pytest.raises(ValueError, match="CUDA tensor"):
        stream.stream_read_cuda(torch.zeros(64))


def test_operator_cache():
    t = _port(CASES["random"]())
    A, B = _operands(t.shape, 8)
    first = sddmm(t, A, B, device=CPU)
    again = sddmm(t, A, B, device=CPU)
    sddmm(t, A, B, impl="pallas", dtype=BF16, device=CPU)
    assert torch.equal(first, again) and len(t._sddmm_ops) == 2
    tb = BCSR.from_csr(t, 8, 128)
    sddmm(tb, A, B, impl="pallas", device=CPU)
    sddmm(tb, A, B, impl="pallas", device=CPU)
    assert len(tb._sddmm_ops) == 1


# ------------------------------------------------------------ validator
@pytest.mark.parametrize("operands", [None, BF16])
def test_validator_pinned_from_both_sides(operands):
    t = _port(FLAT["rect"]())
    A, B = _operands(t.shape, 64)
    terms = reference.sddmm_terms(t, A, B, np.arange(t.nnz), operands)
    exact = terms.sum(axis=1)
    bound = reference.sddmm_bound(terms, atol_floor=1e-6)
    # a correct f32 result passes: exact sums rounded once, and the
    # port's own path
    ok = exact.astype(np.float32)
    rep = reference.rigorously_validate_sddmm(t, A, B, ok, operands)
    assert rep.verdict == "NOT_A_BUG" and rep.kernel_overruns == 0
    op = (SDDMMOperator(t, impl="pallas", dtype=BF16, device=CPU)
          if operands else SDDMMOperator(t, device=CPU))
    assert reference.rigorously_validate_sddmm(
        t, A, B, op(A, B).numpy(), operands).verdict == "NOT_A_BUG"
    # a result off by three bounds on a few nonzeros fails, and so does
    # one scaled by a relative error no f32 sum makes
    bad = ok.astype(np.float64).copy()
    bad[[3, 500, 9000]] += 3 * bound[[3, 500, 9000]]
    rep = reference.rigorously_validate_sddmm(t, A, B, bad, operands)
    assert rep.verdict == "POTENTIAL_BUG" and rep.kernel_overruns == 3
    scaled = exact * (1 + 1e-3)
    assert reference.rigorously_validate_sddmm(
        t, A, B, scaled, operands).verdict == "POTENTIAL_BUG"
    # the sampled form, on a torch tensor as from the card
    s_ok = reference.validate_sampled_sddmm(t, A, B, torch.from_numpy(ok),
                                            n=2000, operands=operands)
    assert s_ok.nonzeros == 2000 and s_ok.overruns == 0
    assert s_ok.rel_error < 1e-6
    shifted = ok + np.float32(0.01)
    s_bad = reference.validate_sampled_sddmm(t, A, B, shifted, n=2000,
                                             operands=operands)
    assert s_bad.overruns > 1000 and s_bad.rel_error > 1e-4
    # f32 mode, without rounding, at the bench tolerance too
    if operands is None:
        assert count_mismatches(ok, reference.sddmm(t, A, B), 1e-3,
                                1e-4) == 0
    with pytest.raises(ValueError, match="operands"):
        reference.sddmm_terms(t, A, B, [0], "float16")


def test_host_reference_matches_loops_tpu():
    from loops_tpu.utils import reference as jref

    j = FLAT["skewed"]()
    A, B = _operands(j.shape, 16)
    np.testing.assert_array_equal(reference.sddmm(_port(j), A, B),
                                  jref.sddmm(j, A, B))


# -------------------------------------------------------- the slice
def test_slice_on_the_arxiv_shaped_graph():
    """``sddmm`` on the GCN adjacency of the same synthetic arxiv-shaped
    graph both packages build, every CSR/COO path against ``loops_tpu``'s
    XLA path, at a small scale."""
    from loops_tpu.io import ogb as jogb
    from loops_tpu_torch.io import ogb

    jadj = jogb.load("ogbn-arxiv", scale=0.004).graph.gcn_normalized().adj
    adj = ogb.load("ogbn-arxiv", scale=0.004).graph.gcn_normalized().adj
    np.testing.assert_array_equal(adj.offsets, jadj.offsets)
    np.testing.assert_array_equal(adj.vals, jadj.vals)
    A, B = _operands(adj.shape, 40, seed_a=0, seed_b=0)
    want = np.asarray(jax_sddmm(jadj, A, B))
    for impl, dtype, mat in (("xla", None, adj), ("xla", None, adj.to_coo()),
                             ("xla", BF16, adj), ("pallas", BF16, adj)):
        got = sddmm(mat, A, B, impl=impl, dtype=dtype, device=CPU).numpy()
        if dtype is None:
            assert count_mismatches(got, want, 1e-3, 1e-4) == 0
        else:
            ref = reference.sddmm(adj, A, B)
            assert np.abs(got - ref).max() / np.abs(ref).max() < 2e-2
    rep = reference.rigorously_validate_sddmm(
        adj, A, B, sddmm(adj, A, B, impl="pallas", dtype=BF16,
                         device=CPU).numpy(), BF16)
    assert rep.verdict == "NOT_A_BUG"


# ------------------------------------------------------------------ K11
def test_stream_plain_and_rate_on_cpu():
    x = stream.stream_input(64, 128, CPU)
    assert x.dtype == torch.float32 and x.abs().max() <= 8
    assert torch.equal(x, x.round())
    # integer terms: the f32 total is exact
    total = stream.stream_read(x, passes=3)
    assert total.item() == 3 * int(x.sum(dtype=torch.float64)) != 0
    assert np.isfinite(stream.pass_ms(x, lo=1, hi=3, repeats=1))
    # one thread: the host-clock slope of 600 sums stays well above the
    # noise of a machine shared by parallel test workers
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert stream.measure_stream_gbps(CPU, rows=512, cols=512) > 0
    finally:
        torch.set_num_threads(threads)


def test_primitives_script_on_cpu():
    r = subprocess.run(
        [sys.executable, "scripts/primitives_torch.py", "--device", "cpu",
         "--scale", "0.004", "--features", "8", "--iters", "1",
         "--repeats", "1"], capture_output=True, text=True, timeout=300,
        cwd=REPO)
    assert r.returncode == 0, r.stdout + r.stderr
    lines = r.stdout.splitlines()
    assert lines[0].startswith("adjacency: ") and "device=cpu" in lines[0]
    assert lines[1].startswith("| F | SpMM group_mapped | SpMM scatter |")
    row = [ln for ln in lines if ln.startswith("| 8 ")]
    assert len(row) == 1 and row[0].count(" ms (") == 5


def test_flat_and_bcsr_ops_warn_nothing_on_the_kernel_path():
    t = _port(CASES["random"]())
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        SDDMMOperator(t, impl="pallas", dtype=BF16, device=CPU)
        SDDMMOperator(BCSR.from_csr(t, 8, 128), impl="pallas", device=CPU)


@pytest.mark.parametrize("block", [(8, 128), (16, 128), (3, 5)])
@pytest.mark.parametrize("name", ["random", "empty_rows", "tall"])
def test_stored_pattern_maps_payload_to_csr(name, block):
    t = _port(BCSR_CASES[name]())
    tb = BCSR.from_csr(t, *block)
    pattern, slot = tb.stored_pattern()
    # the stored entries inside the matrix, in row order, zeros kept
    assert pattern.nnz == len(slot) <= tb.nnz
    np.testing.assert_array_equal(pattern.to_dense(), tb.to_dense())
    np.testing.assert_array_equal(pattern.vals, tb.vals.reshape(-1)[slot])
    assert np.all(np.diff(pattern.row_ids() * t.shape[1]
                          + pattern.indices) > 0)
    A, B = _operands(t.shape, 7)
    out = SDDMMOperator(tb, device=CPU)(A, B).numpy().reshape(-1)
    np.testing.assert_allclose(out[slot], reference.sddmm(pattern, A, B),
                               rtol=1e-5, atol=1e-5)
    assert not np.delete(out, slot).any()
