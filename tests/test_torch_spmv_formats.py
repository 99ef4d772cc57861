"""SpMV on COO, CSC, ELL and DIA, ``flat_partitioned_spmv``, and COO and
ELL SpMM against ``loops_tpu`` on the same numpy inputs: every
(schedule, impl) pair that ``loops_tpu``'s ``_require`` accepts gives its
``y`` within ``rtol=1e-5, atol=1e-6`` in float32, and every pair it
refuses raises ``ValueError`` here too. The deterministic routes (COO and
CSC row_mapped, ELL's plane, DIA's sweep) are also held to a sum of each
row in order."""
import warnings

import numpy as np
import pytest
import torch

import loops_tpu.formats as jf
from loops_tpu.ops.spmm import SpMMOperator as JaxSpMM
from loops_tpu.ops.spmv import SpMVOperator as JaxSpMV
from loops_tpu.ops.spmv import flat_partitioned_spmv as jax_flat_partitioned
import loops_tpu_torch.formats as tf
from loops_tpu_torch.ops.spmm import SpMMOperator, spmm
from loops_tpu_torch.ops.spmv import SpMVOperator, flat_partitioned_spmv, spmv
from loops_tpu_torch.utils import generate

CPU = torch.device("cpu")
RTOL, ATOL = 1e-5, 1e-6
FORMATS = ("coo", "csc", "ell", "dia")
SCHEDULES = ("row_mapped", "group_mapped", "work_oriented", "merge_path",
             "auto", "sorted_flat", "bucketing")
IMPLS = ("xla", "pallas", "pallas2", "pallas3")
MATRICES = {
    **generate.BATTERY,
    "wide_rows": lambda: generate.random_csr(40, 300, 0.05, seed=8),
    "empty_runs": lambda: generate.sized_csr([3] * 10 + [0] * 40 + [2] * 10,
                                             30, seed=22),
}


def _pair(name, fmt):
    t = MATRICES[name]()
    j = jf.CSR(t.shape, t.offsets, t.indices, t.vals)
    return getattr(t, f"to_{fmt}")(), getattr(j, f"to_{fmt}")(), t


def _jax_or_error(fn):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            return np.asarray(fn()), None
        except ValueError as e:
            return None, e


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_every_pair_matches_loops_tpu(name, fmt):
    tm, jm, csr = _pair(name, fmt)
    x = generate.make_input_vector(csr.shape[1])
    accepted = 0
    for schedule in SCHEDULES:
        for impl in IMPLS:
            want, refusal = _jax_or_error(
                lambda: JaxSpMV(jm, schedule, block=8, impl=impl)(x))
            if refusal is not None:
                with pytest.raises(ValueError):
                    SpMVOperator(tm, schedule, block=8, impl=impl,
                                 device=CPU)
                continue
            op = SpMVOperator(tm, schedule, block=8, impl=impl, device=CPU)
            y = op(x)
            assert y.dtype == torch.float32 and op.launches == 0
            assert op.impl_used == "torch"
            np.testing.assert_allclose(y.numpy(), want, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{schedule}/{impl}")
            accepted += 1
    # what loops_tpu's _require names: xla only, and these schedules
    assert accepted == {"coo": 5, "csc": 2, "ell": 5, "dia": 2}[fmt]


@pytest.mark.parametrize("fmt,schedule", [
    ("coo", "row_mapped"), ("coo", "group_mapped"), ("csc", "row_mapped"),
    ("ell", "row_mapped"), ("ell", "auto"), ("dia", "row_mapped")])
@pytest.mark.parametrize("name", ["random", "skewed", "wide_rows",
                                  "empty_rows"])
def test_deterministic_routes_sum_rows_in_order(name, fmt, schedule):
    # a row's nonzeros summed left to right in float32 (COO/CSC by
    # stored order, ELL by plane slot, DIA by diagonal): the sorted
    # segment sums and the plane reductions are that order on the CPU
    tm, _, csr = _pair(name, fmt)
    if fmt == "coo":
        # scramble the COO: the operator's stable sort restores row order
        perm = np.random.default_rng(0).permutation(tm.nnz)
        tm = type(tm)(tm.shape, tm.rows[perm], tm.cols[perm], tm.vals[perm])
    x = generate.make_input_vector(csr.shape[1])
    y = SpMVOperator(tm, schedule, device=CPU)(x).numpy()
    want = csr.to_dense().astype(np.float64) @ x.astype(np.float64)
    np.testing.assert_allclose(y, want, rtol=RTOL, atol=ATOL)
    assert np.array_equal(y, SpMVOperator(tm, schedule, device=CPU)(x).numpy())


def test_coo_unsorted_rows_match_loops_tpu():
    rng = np.random.default_rng(3)
    n, nnz = 50, 400
    r, c = rng.integers(0, n, nnz), rng.integers(0, 40, nnz)
    v = rng.uniform(-1, 1, nnz).astype(np.float32)
    t, j = tf.COO((n, 40), r, c, v), jf.COO((n, 40), r, c, v)
    x = generate.make_input_vector(40)
    for schedule in ("row_mapped", "group_mapped", "merge_path",
                     "work_oriented"):
        want = np.asarray(JaxSpMV(j, schedule, block=8)(x))
        got = SpMVOperator(t, schedule, block=8, device=CPU)(x).numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("fmt", FORMATS)
def test_empty_matrix_gives_zeros(fmt):
    csr = tf.CSR((6, 5), np.zeros(7, np.int64), np.zeros(0, np.int64),
                 np.zeros(0, np.float32))
    mat = getattr(csr, f"to_{fmt}")()
    for schedule in ("row_mapped", "auto"):
        y = SpMVOperator(mat, schedule, device=CPU)(np.ones(5, np.float32))
        assert tuple(y.shape) == (6,) and not y.any()


@pytest.mark.parametrize("atoms_per_tile", [1, 3, 8])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_flat_partitioned_matches_loops_tpu(name, atoms_per_tile):
    csr = MATRICES[name]()
    j = jf.CSR(csr.shape, csr.offsets, csr.indices, csr.vals)
    x = generate.make_input_vector(csr.shape[1])
    want = np.asarray(jax_flat_partitioned(j, x, atoms_per_tile))
    got = flat_partitioned_spmv(csr, x, atoms_per_tile, device=CPU)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    # the staged arrays are kept on the container: a second call is the same
    assert torch.equal(got, flat_partitioned_spmv(csr, torch.from_numpy(x),
                                                  atoms_per_tile, device=CPU))


def test_flat_partitioned_refuses_a_bad_width():
    csr = MATRICES[sorted(MATRICES)[0]]()
    j = jf.CSR(csr.shape, csr.offsets, csr.indices, csr.vals)
    x = generate.make_input_vector(csr.shape[1])
    for width in (0, -2):
        with pytest.raises(ValueError, match="atoms_per_tile"):
            jax_flat_partitioned(j, x, width)
        with pytest.raises(ValueError, match="atoms_per_tile"):
            flat_partitioned_spmv(csr, x, width, device=CPU)


def test_one_shot_spmv_takes_every_format():
    csr = generate.random_csr(30, 20, 0.2, seed=6)
    x = generate.make_input_vector(20)
    want = csr.to_dense() @ x
    for fmt in FORMATS:
        mat = getattr(csr, f"to_{fmt}")()
        np.testing.assert_allclose(spmv(mat, x, device=CPU).numpy(), want,
                                   rtol=RTOL, atol=ATOL)


def test_unknown_container_raises():
    with pytest.raises(TypeError, match="CSR"):
        SpMVOperator(np.eye(3), device=CPU)
    with pytest.raises(TypeError, match="CSR"):
        SpMMOperator(np.eye(3), device=CPU)


@pytest.mark.parametrize("fmt", ["coo", "ell"])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_spmm_matches_loops_tpu(name, fmt):
    tm, jm, csr = _pair(name, fmt)
    B = np.random.default_rng(1).normal(
        size=(csr.shape[1], 7)).astype(np.float32)
    for schedule in ("row_mapped", "auto", "group_mapped", "merge_path"):
        for impl in ("xla", "pallas", "pallas2"):
            want, refusal = _jax_or_error(
                lambda: JaxSpMM(jm, schedule, impl)(B))
            if refusal is not None:
                with pytest.raises(ValueError, match="row_mapped"):
                    SpMMOperator(tm, schedule, impl, device=CPU)
                continue
            op = SpMMOperator(tm, schedule, impl, device=CPU)
            assert op.schedule == "row_mapped"
            np.testing.assert_allclose(op(B).numpy(), want, rtol=RTOL,
                                       atol=ATOL)
    np.testing.assert_allclose(spmm(tm, B, device=CPU).numpy(),
                               csr.to_dense() @ B, rtol=RTOL, atol=1e-5)


@pytest.mark.parametrize("fmt", ["coo", "ell"])
def test_spmm_bf16_rounds_like_csr(fmt):
    # bf16 mode: vals, B and each product rounded to bf16, sums in f32 —
    # the CSR row path's arithmetic, so the same products
    csr = generate.random_csr(40, 30, 0.15, seed=9)
    B = np.random.default_rng(2).normal(size=(30, 6)).astype(np.float32)
    mat = getattr(csr, f"to_{fmt}")()
    got = SpMMOperator(mat, dtype="bfloat16", device=CPU)(B)
    want = SpMMOperator(csr, dtype="bfloat16", device=CPU)(B)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL,
                               atol=ATOL)


def _mock_card(monkeypatch, free, reserved=0, allocated=0):
    """torch.cuda's memory reads as a card with ``free`` bytes free and a
    caching allocator holding ``reserved - allocated`` unused; returns the
    list of mem_get_info calls."""
    calls = []

    def mem_get_info(device=None):
        calls.append(device)
        return free, 80 << 30
    monkeypatch.setattr(torch.cuda, "mem_get_info", mem_get_info)
    monkeypatch.setattr(torch.cuda, "memory_reserved",
                        lambda device=None: reserved)
    monkeypatch.setattr(torch.cuda, "memory_allocated",
                        lambda device=None: allocated)
    return calls


def test_ell_spmm_plane_guard(monkeypatch):
    from loops_tpu_torch.ops.spmm import ell_plane_guard

    # on a card whose free memory cannot hold the [rows, pitch, F] planes
    # the guard raises before the gather; it never falls back
    _mock_card(monkeypatch, 1 << 20)
    cuda = torch.device("cuda", 0)
    ell_plane_guard(100, 2, 128, torch.float32, None, cuda)  # 200 KB: fits
    with pytest.raises(MemoryError, match="max_pitch"):
        ell_plane_guard(1000, 64, 128, torch.float32, None, cuda)
    # no guard on the CPU
    ell_plane_guard(1000, 64, 128, torch.float32, None, CPU)


@pytest.mark.parametrize("vals_dtype,dtype,cell", [
    (torch.float32, None, 8), (torch.float64, None, 16),
    (torch.float32, "bfloat16", 8)])
def test_ell_spmm_plane_guard_counts_both_planes(monkeypatch, vals_dtype,
                                                 dtype, cell):
    from loops_tpu_torch.ops.spmm import ell_plane_bytes, ell_plane_guard

    # the gather and its product coexist (and in bf16 the product's f32
    # copy): free memory between one plane and all of them must raise
    rows, pitch, F = 1000, 16, 64
    need = ell_plane_bytes(rows, pitch, F, vals_dtype, dtype)
    assert need == rows * pitch * F * cell
    plane = rows * pitch * F * torch.finfo(vals_dtype).bits // 8
    cuda = torch.device("cuda", 0)
    _mock_card(monkeypatch, plane + (need - plane) // 2)
    with pytest.raises(MemoryError, match="max_pitch"):
        ell_plane_guard(rows, pitch, F, vals_dtype, dtype, cuda)
    _mock_card(monkeypatch, need)
    ell_plane_guard(rows, pitch, F, vals_dtype, dtype, cuda)


def test_ell_spmm_plane_guard_counts_the_allocator_cache(monkeypatch):
    from loops_tpu_torch.ops.spmm import ell_plane_bytes, ell_plane_guard

    rows, pitch, F = 1000, 16, 64
    need = ell_plane_bytes(rows, pitch, F, torch.float32)
    cuda = torch.device("cuda", 0)
    # memory the caching allocator holds unused is free for the planes;
    # where it covers them mem_get_info is not called
    calls = _mock_card(monkeypatch, 0, reserved=need + 100, allocated=100)
    ell_plane_guard(rows, pitch, F, torch.float32, None, cuda)
    assert calls == []
    # where it does not, mem_get_info's free memory adds to it
    calls = _mock_card(monkeypatch, need // 2, reserved=need // 2 + 100,
                       allocated=100)
    ell_plane_guard(rows, pitch, F, torch.float32, None, cuda)
    assert len(calls) == 1
    _mock_card(monkeypatch, need // 2 - 1, reserved=need // 2 + 100,
               allocated=100)
    with pytest.raises(MemoryError, match="max_pitch"):
        ell_plane_guard(rows, pitch, F, torch.float32, None, cuda)
