"""The ELL and DIA containers and the ELL, DIA and CSC layout views give
``loops_tpu``'s arrays on the same matrices: the probes, both guards'
``MemoryError``, round trips through CSR and dense, the empty matrix,
DIA's explicit-zero parity (``nnz`` counts nonzero values), the device
staging's sentinel rewrite, and the views' ``tile_offsets``."""
import numpy as np
import pytest
import torch

import loops_tpu.formats as jf
import loops_tpu.layout as jl
import loops_tpu_torch.formats as tf
import loops_tpu_torch.layout as tl
from loops_tpu_torch.utils import generate

CPU = torch.device("cpu")

MATRICES = {
    **generate.BATTERY,
    "random_wide": lambda: generate.random_csr(30, 70, 0.08, seed=4),
    "random_f64": lambda: generate.random_csr(25, 30, 0.2, seed=5,
                                              dtype=np.float64),
    "empty": lambda: tf.CSR((6, 5), np.zeros(7, np.int64),
                            np.zeros(0, np.int64), np.zeros(0, np.float32)),
}


def _pair(name):
    t = MATRICES[name]()
    return t, jf.CSR(t.shape, t.offsets, t.indices, t.vals)


def _same_arrays(a, b, names):
    assert tuple(a.shape) == tuple(b.shape)
    for n in names:
        x, y = getattr(a, n), getattr(b, n)
        assert x.dtype == y.dtype, n
        np.testing.assert_array_equal(x, y, err_msg=n)


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_ell_matches_loops_tpu(name):
    t, j = _pair(name)
    assert tf.ELL.max_nnz_per_row(t) == jf.ELL.max_nnz_per_row(j)
    te, je = t.to_ell(), j.to_ell()
    _same_arrays(te, je, ("indices", "vals"))
    assert te.pitch == je.pitch and te.nnz == je.nnz == t.nnz
    np.testing.assert_array_equal(te.to_dense(), je.to_dense())
    np.testing.assert_array_equal(te.to_dense(), t.to_dense())
    back = te.to_csr()
    _same_arrays(back, je.to_csr(), ("offsets", "indices", "vals"))
    np.testing.assert_array_equal(back.to_dense(), t.to_dense())


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_dia_matches_loops_tpu(name):
    t, j = _pair(name)
    assert tf.DIA.count_diagonals(t) == jf.DIA.count_diagonals(j)
    td, jd = t.to_dia(), j.to_dia()
    _same_arrays(td, jd, ("diag_offsets", "vals"))
    assert td.num_diagonals == jd.num_diagonals and td.nnz == jd.nnz
    np.testing.assert_array_equal(td.to_dense(), jd.to_dense())
    np.testing.assert_array_equal(td.to_dense(), t.to_dense())
    _same_arrays(td.to_csr(), jd.to_csr(), ("offsets", "indices", "vals"))


@pytest.mark.parametrize("fmt,kw,probe", [
    ("ell", "max_pitch", lambda c: tf.ELL.max_nnz_per_row(c)),
    ("dia", "max_diagonals", lambda c: tf.DIA.count_diagonals(c)),
])
def test_guards_raise_memory_error_like_loops_tpu(fmt, kw, probe):
    t, j = _pair("skewed")
    limit = probe(t)
    getattr(t, f"to_{fmt}")(**{kw: limit})  # at the limit: converts
    for mat in (t, j):
        with pytest.raises(MemoryError, match=kw):
            getattr(mat, f"to_{fmt}")(**{kw: limit - 1})


def test_dia_explicit_zero_vanishes_as_in_loops_tpu():
    # a stored zero on an occupied diagonal: it keeps its diagonal but
    # neither nnz nor to_csr counts it
    offsets = np.array([0, 2, 3, 4])
    cols = np.array([0, 1, 1, 2])
    vals = np.array([1.0, 0.0, 2.0, 3.0], np.float32)
    t = tf.CSR((3, 3), offsets, cols, vals)
    j = jf.CSR((3, 3), offsets, cols, vals)
    td, jd = t.to_dia(), j.to_dia()
    assert t.nnz == 4
    assert td.nnz == jd.nnz == 3
    assert td.num_diagonals == jd.num_diagonals == 2
    assert td.to_csr().nnz == jd.to_csr().nnz == 3
    # ELL keeps the stored zero: its nnz counts slots, not values
    assert t.to_ell().nnz == j.to_ell().nnz == 4


@pytest.mark.parametrize("name", ["skewed", "empty_rows", "random_wide",
                                  "empty"])
def test_ell_staging_rewrites_sentinels(name):
    t, j = _pair(name)
    te = t.to_ell()
    pad = te.indices == tf.ell.SENTINEL
    idx, val = te.to_device(CPU)
    # a raw -1 would read x's last entry: staging points padding at
    # column 0 with value 0, as loops_tpu's as_jax does
    assert idx.dtype == torch.int32 and val.dtype == torch.from_numpy(
        te.vals).dtype
    assert int(idx.min()) >= 0 if idx.numel() else True
    assert not idx.numpy()[pad].any() and not val.numpy()[pad].any()
    ji, jv = j.to_ell().as_jax(pad_rows_to=1, pad_pitch_to=1)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(val.numpy(), np.asarray(jv))
    # the staged planes give the SpMV even where x's last entry is huge
    x = np.ones(t.shape[1], np.float32)
    if len(x):
        x[-1] = 1e30
    y = (val * torch.from_numpy(x)[idx.long()]).sum(dim=1).numpy()
    np.testing.assert_allclose(y, t.to_dense() @ x, rtol=1e-6)


def test_dia_column_plane_is_clamped_and_masked():
    t = generate.banded_csr(12, 20, band=2, seed=1)
    d = t.to_dia()
    col, val = d.column_plane()
    assert col.min() >= 0 and col.max() < t.shape[1]
    x = np.random.default_rng(0).normal(size=t.shape[1]).astype(np.float32)
    np.testing.assert_allclose((val * x[col]).sum(axis=0), t.to_dense() @ x,
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_views_tile_offsets_match_loops_tpu(name):
    t, j = _pair(name)
    pairs = [
        (tl.EllLayout.from_ell(t.to_ell()), jl.EllLayout.from_ell(j.to_ell())),
        (tl.DiaLayout.from_dia(t.to_dia()), jl.DiaLayout.from_dia(j.to_dia())),
        (tl.CscLayout.from_csc(t.to_csc()), jl.CscLayout.from_csc(j.to_csc())),
    ]
    for a, b in pairs:
        assert (a.num_tiles, a.num_atoms) == (b.num_tiles, b.num_atoms)
        np.testing.assert_array_equal(a.tile_offsets(), b.tile_offsets())
        assert a.tile_offsets().dtype == b.tile_offsets().dtype
        np.testing.assert_array_equal(a.atom_tile_ids(), b.atom_tile_ids())
        tl.check_layout_invariants(a)
