"""Plan-time reordering: ``degree_order`` and ``bfs_order`` give
``loops_tpu``'s permutations element for element (the battery, a
scrambled ring, a directed graph that is not symmetric, a graph of many
components, a random graph), ``permute_csr``, ``inverse_permutation`` and
``bandwidth`` give its arrays, and ``SpMVOperator(reorder=)`` gives its
``y`` within ``rtol=1e-5, atol=1e-6`` on every schedule and impl."""
import warnings

import numpy as np
import pytest
import torch

import loops_tpu.formats as jf
from loops_tpu.layout import reorder as jr
from loops_tpu.ops.spmv import SpMVOperator as JaxSpMV
from loops_tpu_torch.formats import COO
from loops_tpu_torch.layout import reorder as tr
from loops_tpu_torch.ops.spmv import SpMVOperator
from loops_tpu_torch.utils import generate

CPU = torch.device("cpu")


def _ring(n=64, seed=7):
    from loops_tpu_torch.models.graph import Graph
    rng = np.random.default_rng(seed)
    scramble = rng.permutation(n)
    return Graph.from_edges(scramble, np.roll(scramble, -1), n,
                            make_undirected=True).adj


def _directed(n=50, seed=3):
    # a one-way chain through a scrambled order plus random one-way edges:
    # A is not symmetric, so the ordering must symmetrize the pattern
    rng = np.random.default_rng(seed)
    order = rng.permutation(n)
    r = np.concatenate([order[:-1], rng.integers(0, n, 30)])
    c = np.concatenate([order[1:], rng.integers(0, n, 30)])
    return COO((n, n), r, c, rng.uniform(-1, 1, len(r)).astype(
        np.float32)).remove_duplicates().to_csr()


def _components(n=40, seed=5):
    # small cliques, isolated nodes and a self-loop
    rng = np.random.default_rng(seed)
    r, c = [], []
    for start in range(0, 30, 6):
        for a in range(start, start + 4):
            for b in range(start, start + 4):
                if a != b:
                    r.append(a)
                    c.append(b)
    r.append(35)
    c.append(35)
    return COO((n, n), r, c, rng.uniform(size=len(r)).astype(
        np.float32)).to_csr()


GRAPHS = {
    **generate.BATTERY,
    "ring": _ring,
    "directed": _directed,
    "components": _components,
    "random": lambda: generate.random_csr(300, 300, 0.01, seed=2),
    "skewed_square": lambda: generate.skewed_csr(60, 60, heavy_rows=3,
                                                 heavy_nnz=30, seed=5),
}
SQUARE = sorted(k for k, make in GRAPHS.items()
                if make().shape[0] == make().shape[1])


def _jax(t):
    return jf.CSR(t.shape, t.offsets, t.indices, t.vals)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_orders_are_loops_tpus(name):
    t = GRAPHS[name]()
    j = _jax(t)
    for desc in (True, False):
        a, b = tr.degree_order(t, desc), jr.degree_order(j, desc)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    if t.shape[1] > t.shape[0]:
        # both orderings index a node array of the rows by column: a wide
        # matrix's columns overrun it in loops_tpu and here alike
        for mod, mat in ((tr, t), (jr, j)):
            with pytest.raises(IndexError):
                mod.bfs_order(mat)
        return
    a, b = tr.bfs_order(t), jr.bfs_order(j)
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)
    assert sorted(a.tolist()) == list(range(t.shape[0]))


@pytest.mark.parametrize("name", SQUARE)
def test_permute_and_bandwidth_are_loops_tpus(name):
    t = GRAPHS[name]()
    j = _jax(t)
    perm = tr.bfs_order(t)
    for cols in (True, False):
        a, b = tr.permute_csr(t, perm, cols), jr.permute_csr(j, perm, cols)
        for f in ("offsets", "indices", "vals"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    np.testing.assert_array_equal(tr.inverse_permutation(perm),
                                  jr.inverse_permutation(perm))
    assert tr.bandwidth(t) == jr.bandwidth(j)


def test_bfs_recovers_the_ring():
    ring = _ring()
    order = tr.bfs_order(ring)
    assert tr.bandwidth(tr.permute_csr(ring, order)) <= 2 < tr.bandwidth(ring)


ROUTES = [("row_mapped", "xla"), ("group_mapped", "xla"),
          ("work_oriented", "xla"), ("merge_path", "xla"),
          ("merge_path", "pallas"), ("merge_path", "pallas2"),
          ("sorted_flat", "xla"), ("auto", "xla")]


@pytest.mark.parametrize("reorder", ["degree", "bfs"])
@pytest.mark.parametrize("schedule,impl", ROUTES)
@pytest.mark.parametrize("name", ["skewed_square", "directed", "random"])
def test_operator_reorder_matches_loops_tpu(name, schedule, impl, reorder):
    t = GRAPHS[name]()
    x = generate.make_input_vector(t.shape[1])
    op = SpMVOperator(t, schedule, block=8, impl=impl, reorder=reorder,
                      device=CPU)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = np.asarray(JaxSpMV(_jax(t), schedule, block=8, impl=impl,
                                  reorder=reorder)(x))
    np.testing.assert_allclose(op(x).numpy(), want, rtol=1e-5, atol=1e-6)
    assert op.reorder == reorder and op.meta["reorder_ms"] >= 0
    # the operator holds the permuted matrix, as loops_tpu's does
    np.testing.assert_array_equal(op.mat.indices, tr.permute_csr(
        t, getattr(tr, f"{reorder}_order")(t)).indices)


def test_reorder_refusals_match_loops_tpu():
    t = generate.random_csr(10, 12, 0.3, seed=1)
    sq = generate.random_csr(10, 10, 0.3, seed=1)
    for mat, jmat, kw in (
            (t, _jax(t), dict(reorder="degree")),
            (sq.to_coo(), _jax(sq).to_coo(), dict(reorder="bfs")),
            (sq, _jax(sq), dict(reorder="rcm"))):
        with pytest.raises(ValueError) as mine:
            SpMVOperator(mat, "row_mapped", device=CPU, **kw)
        with pytest.raises(ValueError) as theirs:
            JaxSpMV(jmat, "row_mapped", **kw)
        assert str(mine.value) == str(theirs.value)
