"""The port's native host tier (``loops_tpu_torch/native``) against
``loops_tpu.native`` and numpy, array for array: the library builds with
g++, ``coo_to_csr`` (stable within (row, col)), ``unique_remap`` and
``mtx_parse`` give the same arrays, inputs outside the native contract
give None, and ``CSR.from_coo`` past its native threshold equals
``loops_tpu``'s. Every comparison is exact."""
import os

import numpy as np
import pytest

import loops_tpu.formats as jf
import loops_tpu.io.market as jmarket
import loops_tpu.native.convert as jconvert
import loops_tpu.native.mtx as jmtx
import loops_tpu_torch.formats as tf
import loops_tpu_torch.io.market as tmarket
from loops_tpu_torch import native
from loops_tpu_torch.formats.csr import NATIVE_MIN_NNZ
from loops_tpu_torch.native import build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MTX = os.path.join(REPO, "datasets", "chesapeake.mtx")


def _coo_arrays(n_rows, n_cols, nnz, seed, dup_every=0):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n_rows, nnz, dtype=np.int32)
    cols = rng.integers(0, n_cols, nnz, dtype=np.int32)
    if dup_every:
        # repeated (row, col) pairs, to show the order duplicates keep
        rows[::dup_every] = rows[0]
        cols[::dup_every] = cols[0]
    vals = rng.standard_normal(nnz).astype(np.float32)
    return rows, cols, vals


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def test_library_builds_here():
    lib = native.load_library()
    assert lib is not None, "g++ is present: the native tier must build"
    path = build.library_path(build._source_files())
    assert os.path.exists(path)
    assert os.path.dirname(path) == build.BUILD_DIR
    # the port's sources, not the JAX package's build
    assert os.path.commonpath([path, os.path.join(REPO, "loops_tpu_torch")]) \
        == os.path.join(REPO, "loops_tpu_torch")
    names = sorted(os.listdir(build.SRC_DIR))
    assert names == ["coo_to_csr.cpp", "mtx_parser.cpp", "unique_remap.cpp"]


@pytest.mark.parametrize("case", [
    (50, 40, 600, 1, 0), (1000, 300, 20000, 2, 7), (7, 5, 100, 3, 3),
    (3000, 3000, 0, 4, 0), (1, 9, 50, 5, 2), (20000, 10, 100000, 6, 0),
])
def test_coo_to_csr_matches_jax_package_and_lexsort(case):
    n_rows, n_cols, nnz, seed, dup = case
    rows, cols, vals = _coo_arrays(n_rows, n_cols, nnz, seed, dup)
    got = native.coo_to_csr(rows, cols, vals, n_rows)
    want = jconvert.coo_to_csr(rows, cols, vals, n_rows)
    assert got is not None and want is not None
    _same(got, want)
    # numpy: a stable lexsort by (row, col), duplicates in input order
    order = np.lexsort((cols, rows))
    np.testing.assert_array_equal(got[1], cols[order])
    np.testing.assert_array_equal(got[2], vals[order])
    np.testing.assert_array_equal(
        got[0], np.searchsorted(rows[order], np.arange(n_rows + 1)))


@pytest.mark.parametrize("bad", ["row_high", "row_negative", "int64",
                                 "float64"])
def test_coo_to_csr_outside_contract_is_none(bad):
    rows, cols, vals = _coo_arrays(10, 10, 50, 1)
    if bad == "row_high":
        rows[3] = 10
    elif bad == "row_negative":
        rows[3] = -1
    elif bad == "int64":
        rows = rows.astype(np.int64)
    else:
        vals = vals.astype(np.float64)
    assert native.coo_to_csr(rows, cols, vals, 10) is None
    assert jconvert.coo_to_csr(rows, cols, vals, 10) is None


@pytest.mark.parametrize("case", [(5000, 200_000, 11), (10, 3, 1),
                                  (100, 0, 2), (1 << 20, 50_000, 3),
                                  (64, 10_000, 4)])
def test_unique_remap_matches_jax_package_and_numpy(case):
    n_cols, nnz, seed = case
    cols = np.random.default_rng(seed).integers(0, n_cols, nnz).astype(
        np.int32)
    uniq, local = native.unique_remap(cols, n_cols)
    j_uniq, j_local = jconvert.unique_remap(cols, n_cols)
    _same((uniq, local), (j_uniq, j_local))
    ref_u, ref_l = np.unique(cols, return_inverse=True)
    np.testing.assert_array_equal(uniq, ref_u)
    np.testing.assert_array_equal(local, ref_l)
    np.testing.assert_array_equal(uniq[local], cols)


@pytest.mark.parametrize("cols", [[1, 2, 99], [-1, 0], [10]])
def test_unique_remap_out_of_range_is_none(cols):
    cols = np.array(cols, np.int32)
    assert native.unique_remap(cols, 10) is None
    assert jconvert.unique_remap(cols, 10) is None
    assert native.unique_remap(cols.astype(np.int64), 100) is None


@pytest.mark.parametrize("body,nnz,ncols", [
    (b"1 2 3.5\n4 5 -6e-3\n", 2, 3),
    (b"  1\t2 3.5\r\n% a comment\n\n4 5 6\n7 8 9\n", 3, 3),
    (b"1 2\n3 4\n5 6\n", 3, 2),
    (b"1 2 3\n4 5\n", 2, 3),          # too few fields: not parsed
    (b"1 2 x\n", 1, 3),               # malformed field
    (b"1 2 3\n", 2, 3),               # fewer records than asked
    (b"", 0, 2),
])
def test_mtx_parse_matches_jax_package(body, nnz, ncols):
    got = native.mtx_parse(body, nnz, ncols)
    want = jmtx.mtx_parse(body, nnz, ncols)
    if want is None:
        assert got is None
    else:
        np.testing.assert_array_equal(got, want)
        assert got.dtype == np.float64 and got.shape == (nnz, ncols)


def test_mtx_parse_over_a_memoryview():
    body = b"1 2 3.5\n4 5 6\n"
    view = memoryview(bytearray(b"XX" + body))[2:]
    np.testing.assert_array_equal(native.mtx_parse(view, 2, 3),
                                  np.array([[1, 2, 3.5], [4, 5, 6]]))


def test_market_load_takes_the_native_tokenizer(monkeypatch):
    calls = []
    real = native.mtx_parse

    def spy(body, nnz, ncols):
        calls.append((type(body), nnz, ncols))
        return real(body, nnz, ncols)
    monkeypatch.setattr(native, "mtx_parse", spy)
    coo = tmarket.load(MTX)
    assert calls and calls[0][0] is memoryview  # the mapped file's body
    j = jmarket.load(MTX)
    for name in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(getattr(coo, name), getattr(j, name))


def test_market_load_without_library_takes_numpy(monkeypatch):
    monkeypatch.setattr(native, "mtx_parse", lambda *a: None)
    coo = tmarket.load(MTX)
    j = jmarket.load(MTX)
    for name in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(getattr(coo, name), getattr(j, name))


@pytest.mark.parametrize("case", [(5000, 4000, NATIVE_MIN_NNZ, 1, 0),
                                  (300, 200, 150_000, 2, 5),
                                  (40000, 9, 120_000, 3, 0)])
def test_csr_from_coo_at_native_size_equals_jax_package(case, monkeypatch):
    n_rows, n_cols, nnz, seed, dup = case
    rows, cols, vals = _coo_arrays(n_rows, n_cols, nnz, seed, dup)
    t = tf.CSR.from_coo(tf.COO((n_rows, n_cols), rows, cols, vals))
    j = jf.CSR.from_coo(jf.COO((n_rows, n_cols), rows, cols, vals))
    for name in ("offsets", "indices", "vals"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
    # the numpy path gives the same arrays
    import loops_tpu_torch.native.convert as tconvert
    monkeypatch.setattr(tconvert, "coo_to_csr", lambda *a: None)
    t2 = tf.CSR.from_coo(tf.COO((n_rows, n_cols), rows, cols, vals))
    for name in ("offsets", "indices", "vals"):
        np.testing.assert_array_equal(getattr(t, name), getattr(t2, name))


def test_csr_from_coo_takes_native_only_from_threshold(monkeypatch):
    import loops_tpu_torch.native.convert as tconvert
    calls = []
    real = tconvert.coo_to_csr

    def spy(*a):
        calls.append(len(a[0]))
        return real(*a)
    monkeypatch.setattr(tconvert, "coo_to_csr", spy)
    for nnz in (NATIVE_MIN_NNZ - 1, NATIVE_MIN_NNZ):
        rows, cols, vals = _coo_arrays(100, 100, nnz, 9)
        tf.CSR.from_coo(tf.COO((100, 100), rows, cols, vals))
    assert calls == [NATIVE_MIN_NNZ]
    rows, cols, vals = _coo_arrays(100, 100, NATIVE_MIN_NNZ, 9)
    tf.CSR.from_coo(tf.COO((100, 100), rows, cols, vals.astype(np.float64)))
    assert calls == [NATIVE_MIN_NNZ]  # f64 values stay on numpy's path


def test_load_library_without_compiler(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setattr(build, "_tried", False)
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "empty"))
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    assert build.load_library() is None
    assert native.coo_to_csr(*_coo_arrays(4, 4, 8, 1), 4) is None
    assert native.unique_remap(np.zeros(3, np.int32), 4) is None
    assert native.mtx_parse(b"1 2\n", 1, 2) is None


def test_libbuild_publishes_by_rename(tmp_path):
    """The build helper the native tier and the CUDA kernels share: the
    name holds a hash of the sources and flags, the library appears only
    by a rename, and a failed build leaves nothing behind."""
    from loops_tpu_torch.utils import libbuild

    src = tmp_path / "a.cpp"
    src.write_text("int f() { return 1; }\n")
    p1 = libbuild.library_path(str(tmp_path / "b"), "x", [src], ("-O3",))
    assert os.path.basename(p1).startswith("libx_") and p1.endswith(".so")
    assert p1 != libbuild.library_path(str(tmp_path / "b"), "x", [src],
                                       ("-O2",))
    src.write_text("int f() { return 2; }\n")
    assert p1 != libbuild.library_path(str(tmp_path / "b"), "x", [src],
                                       ("-O3",))
    seen = []

    def make(tmp, tag):
        seen.append((tmp, tag))
        assert not os.path.exists(p1)
        open(tmp, "w").close()
    libbuild.publish(p1, make)
    (tmp, tag), = seen
    assert str(os.getpid()) in tag and tmp != p1
    assert os.listdir(os.path.dirname(p1)) == [os.path.basename(p1)]

    def broken(tmp, tag):
        open(tmp, "w").close()
        raise RuntimeError("compiler failed")
    p2 = p1.replace(".so", "_2.so")
    with pytest.raises(RuntimeError):
        libbuild.publish(p2, broken)
    assert os.listdir(os.path.dirname(p1)) == [os.path.basename(p1)]
