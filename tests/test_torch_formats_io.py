"""Host containers, the Matrix Market loader and the generators of the
port give the same arrays as ``loops_tpu`` on the same files and seeds."""
import os

import numpy as np
import pytest

import loops_tpu.formats as jf
import loops_tpu.io.market as jmarket
import loops_tpu.utils.generate as jgen
import loops_tpu_torch.formats as tf
import loops_tpu_torch.io.market as tmarket
import loops_tpu_torch.utils.generate as tgen

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MTX = os.path.join(REPO, "datasets", "chesapeake.mtx")

# every generator of utils/generate.py, at test sizes and several seeds
GENERATORS = {
    "random": lambda g, s: g.random_csr(40, 33, 0.1, seed=s),
    "random_f64": lambda g, s: g.random_csr(25, 30, 0.2, seed=s,
                                            dtype=np.float64),
    "identity": lambda g, s: g.identity_csr(9 + s),
    "banded": lambda g, s: g.banded_csr(12, 20, band=2, seed=s),
    "block_diag": lambda g, s: g.block_diag_csr(4, 3, seed=s),
    "skewed": lambda g, s: g.skewed_csr(14, 24, heavy_rows=2, seed=s),
    "empty_rows": lambda g, s: g.empty_row_csr(15, 9, seed=s),
    "tridiag": lambda g, s: g.tridiag_csr(17, seed=s),
    "diag": lambda g, s: g.diag_csr(11, seed=s),
}


def assert_same_csr(a, b):
    assert tuple(a.shape) == tuple(b.shape)
    for name in ("offsets", "indices", "vals"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_generators_match(name, seed):
    assert_same_csr(GENERATORS[name](tgen, seed), GENERATORS[name](jgen, seed))


@pytest.mark.parametrize("seed", [1, 7])
def test_input_vector_matches(seed):
    np.testing.assert_array_equal(tgen.make_input_vector(50, seed=seed),
                                  jgen.make_input_vector(50, seed=seed))


def test_market_chesapeake_matches():
    t, j = tmarket.load(MTX), jmarket.load(MTX)
    assert t.shape == j.shape == (39, 39)
    for name in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
    assert_same_csr(tmarket.load_csr(MTX), jmarket.load_csr(MTX))


@pytest.mark.parametrize("body", [
    b"%%MatrixMarket matrix coordinate real general\n% c\n3 4 4\n"
    b"1 1 1.5\n3 4 -2\n2 2 0.25\n1 3 7\n",
    b"%%MatrixMarket matrix coordinate integer symmetric\n3 3 3\n"
    b"1 1 2\n3 1 5\n3 2 -1\n",
    b"%%MatrixMarket matrix coordinate pattern general\n2 3 2\n2 3\n1 1\n",
])
def test_market_bytes_match(body):
    assert_same_csr(tmarket.load(body).to_csr(), jmarket.load(body).to_csr())


@pytest.mark.parametrize("bad", [
    b"%%MatrixMarket matrix array real general\n2 2\n1\n2\n3\n4\n",
    b"%%MatrixMarket matrix coordinate complex general\n1 1 1\n1 1 1 0\n",
    b"%%MatrixMarket matrix coordinate real general\n2 2 1\n0 1 1.0\n",
    b"%%MatrixMarket matrix coordinate real general\n2 2 1\n3 1 1.0\n",
])
def test_market_rejects_like_reference(bad):
    with pytest.raises(ValueError):
        jmarket.load(bad)
    with pytest.raises(ValueError):
        tmarket.load(bad)


@pytest.mark.parametrize("seed", [0, 3])
def test_coo_to_csr_matches(seed):
    rng = np.random.default_rng(seed)
    n = 300
    r = rng.integers(0, 50, n)
    c = rng.integers(0, 40, n)
    v = rng.uniform(-1, 1, n).astype(np.float32)
    t = tf.COO((50, 40), r, c, v)
    j = jf.COO((50, 40), r, c, v)
    assert_same_csr(t.to_csr(), j.to_csr())
    for op in ("first", "sum"):
        td, jd = t.remove_duplicates(op), j.remove_duplicates(op)
        for name in ("rows", "cols", "vals"):
            np.testing.assert_array_equal(getattr(td, name), getattr(jd, name))
    tc, jc = t.to_csr().to_coo(), j.to_csr().to_coo()
    np.testing.assert_array_equal(tc.rows, jc.rows)
    np.testing.assert_array_equal(t.to_dense(), j.to_dense())


def test_csr_from_arrays_round_trip():
    j = jgen.random_csr(30, 20, 0.2, seed=4)
    t = tf.csr_from_arrays(j.shape, j.offsets, j.indices, j.vals)
    assert_same_csr(t, j)
    np.testing.assert_array_equal(t.row_ids(), j.row_ids())
    np.testing.assert_array_equal(t.to_dense(), j.to_dense())


def test_to_device_returns_tensors():
    import torch

    t = tgen.random_csr(10, 8, 0.3, seed=2)
    off, idx, val = t.to_device(torch.device("cpu"))
    assert off.dtype == torch.int32 and idx.dtype == torch.int32
    assert val.dtype == torch.float32
    np.testing.assert_array_equal(val.numpy(), t.vals)


@pytest.mark.parametrize("target", ["to_csc", "to_ell", "to_dia"])
def test_unported_conversions_raise(target):
    """Every conversion of CSR is ported now: CSC (the transpose behind
    the GNN aggregation's gradient), ELL, DIA and BCSR give the arrays of
    ``loops_tpu``'s, and convert back to the same dense matrix."""
    t = tgen.random_csr(10, 8, 0.3, seed=2)
    j = jgen.random_csr(10, 8, 0.3, seed=2)
    names = {"to_csc": ("offsets", "indices", "vals"),
             "to_ell": ("indices", "vals"),
             "to_dia": ("diag_offsets", "vals")}[target]
    tc, jc = getattr(t, target)(), getattr(j, target)()
    for name in names:
        np.testing.assert_array_equal(getattr(tc, name), getattr(jc, name))
    np.testing.assert_array_equal(tc.to_csr().to_dense(), t.to_dense())
    tb, jb = t.to_bcsr(2, 2), j.to_bcsr(2, 2)
    for name in ("block_offsets", "block_cols", "vals"):
        np.testing.assert_array_equal(getattr(tb, name), getattr(jb, name))


@pytest.mark.parametrize("comment", [None, "written by a test\nsecond line"])
@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_market_save_writes_loops_tpus_bytes(tmp_path, name, comment):
    t = GENERATORS[name](tgen, 1)
    j = GENERATORS[name](jgen, 1)
    tmarket.save(tmp_path / "t.mtx", t, comment=comment)
    jmarket.save(tmp_path / "j.mtx", j, comment=comment)
    assert (tmp_path / "t.mtx").read_bytes() == (tmp_path / "j.mtx").read_bytes()
    # and it round-trips through the loader: exactly in float32, to the
    # nine digits written in float64
    back = tmarket.load_csr(tmp_path / "t.mtx", dtype=t.vals.dtype)
    if t.vals.dtype == np.float32:
        assert_same_csr(back, t)
    else:
        np.testing.assert_array_equal(back.indices, t.indices)
        np.testing.assert_allclose(back.vals, t.vals, rtol=1e-8)


def test_market_save_takes_a_coo_and_a_csc(tmp_path):
    t = tgen.random_csr(12, 9, 0.3, seed=4)
    for mat in (t.to_coo(), t.to_csc()):
        tmarket.save(tmp_path / "m.mtx", mat)
        back = tmarket.load_csr(tmp_path / "m.mtx")
        np.testing.assert_array_equal(back.to_dense(), t.to_dense())


SORT_CASES = {
    "empty": (0, 5), "one": (1, 5), "duplicates": (300, 4),
    "wide": (5000, 100_000), "keys_past_bound": (200, 50),
}


@pytest.mark.parametrize("case", sorted(SORT_CASES))
def test_packed_sorts_equal_numpy_stable_sorts(case):
    # the COO/CSC sorts' packed stable passes give np.lexsort's
    # permutation, duplicates in their given order
    m, n = SORT_CASES[case]
    rng = np.random.default_rng(m)
    rows, cols = rng.integers(0, n, m), rng.integers(0, n, m)
    bound = 10 if case == "keys_past_bound" else n
    np.testing.assert_array_equal(tf.convert.lexsort2(cols, rows, bound,
                                                      bound),
                                  np.lexsort((cols, rows)))
    np.testing.assert_array_equal(tf.convert.stable_argsort(cols, bound),
                                  np.argsort(cols, kind="stable"))
    coo = tf.COO((n, n), rows, cols, np.arange(m, dtype=np.float32))
    jcoo = jf.COO((n, n), rows, cols, np.arange(m, dtype=np.float32))
    for sort in ("sort_by_row", "sort_by_column"):
        a, b = getattr(coo, sort)(), getattr(jcoo, sort)()
        for name in ("rows", "cols", "vals"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
