"""The binary CSR cache and the edge-list loader of the port against
``loops_tpu``'s: binary files round-trip and read across the two packages
in both directions; ``load_edges`` gives the JAX package's graph, array
for array, on comma, whitespace, commented and weighted inputs and under
``make_undirected``, and raises its errors. The port's tokenizer is
numpy's alone (the JAX package takes pandas where it can), so each input
below goes through both of the JAX package's paths' rules: comments
skipped as whole lines and after data, blank lines, either separator."""
import numpy as np
import pytest

import loops_tpu.io as jio
import loops_tpu.io.binary as jbinary
import loops_tpu.utils.generate as jgen
import loops_tpu_torch.io as tio
import loops_tpu_torch.io.binary as tbinary
import loops_tpu_torch.utils.generate as tgen

MATRICES = {
    "random": lambda g: g.random_csr(40, 33, 0.1, seed=3),
    "random_f64": lambda g: g.random_csr(25, 30, 0.2, seed=4,
                                         dtype=np.float64),
    "empty_rows": lambda g: g.empty_row_csr(15, 9, seed=2),
    "skewed": lambda g: g.skewed_csr(14, 24, heavy_rows=2),
    "identity": lambda g: g.identity_csr(1),
}


def _same_csr(a, b):
    assert tuple(int(d) for d in a.shape) == tuple(int(d) for d in b.shape)
    for name in ("offsets", "indices", "vals"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_binary_round_trip(name, tmp_path):
    csr = MATRICES[name](tgen)
    path = tmp_path / "m.npz"
    tbinary.save_csr(path, csr)
    _same_csr(tbinary.load_csr(path), csr)


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_binary_reads_across_packages(name, tmp_path):
    t, j = MATRICES[name](tgen), MATRICES[name](jgen)
    tbinary.save_csr(tmp_path / "t.npz", t)
    jbinary.save_csr(tmp_path / "j.npz", j)
    # a file of either package reads in the other
    _same_csr(jbinary.load_csr(tmp_path / "t.npz"), j)
    _same_csr(tbinary.load_csr(tmp_path / "j.npz"), t)


def test_binary_rejects_another_magic(tmp_path):
    np.savez(tmp_path / "x.npz", magic="something-else",
             shape=np.array([1, 1]), offsets=np.zeros(2, np.int32),
             indices=np.zeros(0, np.int32), vals=np.zeros(0, np.float32))
    with pytest.raises(ValueError, match="not a loops-tpu binary CSR"):
        tbinary.load_csr(tmp_path / "x.npz")


EDGE_INPUTS = {
    "whitespace": b"0 1\n1 2\n2 0\n3 1\n",
    "tabs": b"0\t1\n1\t2\n4\t0\n",
    "comma": b"0,1\n1,2\n2,3\n3,0\n",
    "comma_spaces": b"0, 1\n1, 2\n2, 3\n",
    "commented": b"# header line\n0 1\n# middle\n1 2\n\n2 3\n",
    "inline_comment": b"0 1 # first\n1 2\n2 0 # last\n",
    "weighted": b"0 1 0.5\n1 2 2.0\n2 0 -1.25\n0 2 3\n",
    "weighted_comma": b"0,1,0.5\n1,2,2\n2,0,1.5\n",
    "duplicates": b"0 1\n0 1\n1 0\n2 2\n",
    "float_ids": b"0.0 1.0\n2.0 1.0\n",
    "trailing_blank": b"0 1\n1 2\n\n\n",
    "crlf": b"0 1\r\n1 2\r\n2 0\r\n",
}


def _graph_arrays(g):
    return g.num_nodes, g.adj.offsets, g.adj.indices, g.adj.vals


@pytest.mark.parametrize("undirected", [False, True])
@pytest.mark.parametrize("name", sorted(EDGE_INPUTS))
def test_load_edges_equals_jax_package(name, undirected, tmp_path):
    data = EDGE_INPUTS[name]
    t = tio.load_edges(data, make_undirected=undirected)
    j = jio.load_edges(data, make_undirected=undirected)
    tn, *ta = _graph_arrays(t)
    jn, *ja = _graph_arrays(j)
    assert tn == jn
    for x, y in zip(ta, ja):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    # from a file, and with the node count given
    path = tmp_path / "e.txt"
    path.write_bytes(data)
    t2 = tio.load_edges(str(path), num_nodes=tn + 3,
                        make_undirected=undirected)
    j2 = jio.load_edges(str(path), num_nodes=jn + 3,
                        make_undirected=undirected)
    assert t2.num_nodes == j2.num_nodes == tn + 3
    np.testing.assert_array_equal(t2.adj.indices, j2.adj.indices)
    np.testing.assert_array_equal(t2.adj.vals, j2.adj.vals)


def test_load_edges_other_comment_char():
    data = b"% matrix-market style\n0 1\n1 2\n"
    t = tio.load_edges(data, comment="%")
    j = jio.load_edges(data, comment="%")
    np.testing.assert_array_equal(t.adj.offsets, j.adj.offsets)
    np.testing.assert_array_equal(t.adj.indices, j.adj.indices)


def test_load_edges_larger_random_list():
    rng = np.random.default_rng(5)
    src = rng.integers(0, 500, 4000)
    dst = rng.integers(0, 500, 4000)
    w = rng.random(4000).round(3)
    text = "\n".join(f"{a}\t{b}\t{c}" for a, b, c in zip(src, dst, w))
    data = ("# generated\n" + text + "\n").encode()
    for undirected in (False, True):
        t = tio.load_edges(data, make_undirected=undirected)
        j = jio.load_edges(data, make_undirected=undirected)
        for name in ("offsets", "indices", "vals"):
            np.testing.assert_array_equal(getattr(t.adj, name),
                                          getattr(j.adj, name))


@pytest.mark.parametrize("data,err,match", [
    (b"0 -1\n1 2\n", ValueError, "negative node id"),
    (b"-3 1\n", ValueError, "negative node id"),
    (b"0\n1\n2\n", ValueError, "at least src and dst"),
    (b"", ValueError, "at least src and dst"),
    (b"# only a comment\n", ValueError, "at least src and dst"),
    (b"0 2147483647\n", OverflowError, "int32"),
])
def test_load_edges_errors_match(data, err, match):
    with pytest.raises(err, match=match):
        tio.load_edges(data)
    with pytest.raises(err, match=match):
        jio.load_edges(data)


@pytest.mark.parametrize("data", [b"0 1\n1 2 3\n", b"0 1 2\n1 2\n",
                                  b"0,1\n1,x\n"])
def test_load_edges_unequal_or_malformed_rows_raise(data):
    """As ``loops_tpu``'s numpy path raises (its pandas path fills a
    short row with NaN)."""
    with pytest.raises(ValueError, match="edge list"):
        tio.load_edges(data)
