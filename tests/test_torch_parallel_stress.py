"""Scale and adversarial cases of the port's multi-device tier, after
``tests/test_parallel_stress.py``.

Eight gloo ranks, spawned once for the module, run every exchange
(all-gather, overlapped halo, hierarchical 2 x 4) on the 10^5-node
graph and on the adversarial ones: shards with no edges, shards whose
columns are all remote, a column hub, a row hub. Each output is held
against ``loops_tpu``'s host oracle (``reference.spmm``) with that
file's tolerances (rtol 1e-4; atol 1e-2 at 10^5 nodes, 1e-3 on the
small graphs), and each plan against ``loops_tpu``'s bit for bit. The
10^6-node cases compare the plans only, with no ranks, so that the file
stays near a minute. ``EdgePartition.from_shards`` is held to
``tests/test_shards.py``'s case (96 nodes, 2 shards x 4 chips, hier)
through the ranks, and to ``loops_tpu``'s plan at 10^6 nodes.
"""
import numpy as np
import pytest

import loops_tpu.parallel as J
from loops_tpu.formats import CSR as JCSR
from loops_tpu.io.shards import ShardedCSR as JShardedCSR
from loops_tpu.models import Graph as JGraph
from loops_tpu.parallel.halo import HaloPlan as JHaloPlan
from loops_tpu.utils import reference
from loops_tpu_torch.formats import CSR
from loops_tpu_torch.io.shards import ShardedCSR
from loops_tpu_torch.models.graph import Graph
from loops_tpu_torch.parallel import EdgePartition, HaloPlan, HierHaloPlan
from loops_tpu_torch.parallel import launch, workers
from loops_tpu_torch.utils import generate

WORLD = 8
PROTOCOLS = {"all_gather": "flat", "halo_overlap": "flat",
             "hier": ("hier", 2, 4)}


def _random_edges(n, deg, seed):
    rng = np.random.default_rng(seed)
    m = deg * n
    return rng.integers(0, n, m), rng.integers(0, n, m), n


def _coo_csr(cls, rows, cols, n):
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    offs = np.searchsorted(rows, np.arange(n + 1))
    return cls((n, n), offs.astype(np.int64), cols,
               np.ones(len(rows), np.float32))


def _adversarial():
    """``{name: (rows, cols, n, X)}`` of the small stress graphs."""
    out = {}
    rng = np.random.default_rng(5)
    src, dst = rng.integers(0, 64, 2000), rng.integers(0, 4096, 2000)
    out["empty_shards"] = (src, dst, 4096,
                           rng.normal(size=(4096, 8)).astype(np.float32))
    n = 8192
    src = np.repeat(np.arange(n), 2)
    dst = ((src + n // 2) + np.tile([0, 7], n)) % n
    out["all_remote"] = (src, dst, n, np.random.default_rng(6).normal(
        size=(n, 8)).astype(np.float32))
    n = 4096
    src = np.arange(n)
    out["column_hub"] = (np.concatenate([src, src]),
                         np.concatenate([np.zeros(n, np.int64), src]), n,
                         np.random.default_rng(7).normal(
                             size=(n, 8)).astype(np.float32))
    rng = np.random.default_rng(8)
    srcr, dstr = rng.integers(0, n, 2 * n), rng.integers(0, n, 2 * n)
    out["row_hub"] = (np.concatenate([np.zeros(n, np.int64), srcr]),
                      np.concatenate([np.arange(n), dstr]), n,
                      rng.normal(size=(n, 8)).astype(np.float32))
    return out


ADVERSARIAL = _adversarial()


@pytest.fixture(scope="module")
def big():
    """The 10^5-node graph (~1.6M edges) and its features, both
    packages'."""
    e = _random_edges(100_000, 8, seed=1)
    X = np.random.default_rng(2).normal(
        size=(100_000, 16)).astype(np.float32)
    return (Graph.from_edges(*e, make_undirected=True).adj,
            JGraph.from_edges(*e, make_undirected=True).adj, X)


@pytest.fixture(scope="module")
def shard_store(tmp_path_factory):
    csr = generate.random_csr(96, 96, 0.08, seed=13)
    d = tmp_path_factory.mktemp("st")
    return csr, ShardedCSR.build(csr, 2, str(d / "port")), str(d / "port")


@pytest.fixture(scope="module")
def ranks(big, shard_store):
    cases, names = [], []
    for proto, mesh in PROTOCOLS.items():
        names.append(("big", proto))
        cases.append(("spmm", mesh, dict(csr=big[0], X=big[2],
                                         protocol=proto, grad=False)))
        for name, (rows, cols, n, X) in ADVERSARIAL.items():
            names.append((name, proto))
            cases.append(("spmm", mesh, dict(
                csr=_coo_csr(CSR, rows, cols, n), X=X, protocol=proto,
                grad=False)))
    csr, _, path = shard_store
    names.append(("from_shards", "hier"))
    cases.append(("spmm", ("hier", 2, 4), dict(
        store=path, chips_per_shard=4,
        X=np.random.default_rng(5).normal(size=(96, 6)).astype(np.float32),
        protocol="hier", grad=False)))
    out = launch.run_ranks(workers.run_cases, WORLD, cases, "cpu",
                           backend="gloo", timeout=400)
    return {k: [out[r][i] for r in range(WORLD)]
            for i, k in enumerate(names)}


def _got(part, res):
    by_p = {r["p"]: r["out"] for r in res}
    return part.unpad_output(np.stack([by_p[p] for p in range(len(by_p))]))


def _bitwise(port, ref):
    for k, v in vars(ref).items():
        if isinstance(v, np.ndarray) or isinstance(v, (int, np.integer)):
            a = getattr(port, k)
            assert np.asarray(a).dtype == np.asarray(v).dtype, k
            np.testing.assert_array_equal(a, v, err_msg=k)


def _plans_bitwise(port_csr, ref_csr, P=8):
    part = EdgePartition.build(port_csr, P)
    jpart = J.EdgePartition.build(ref_csr, P)
    _bitwise(part, jpart)
    halo, jhalo = HaloPlan.build(part), JHaloPlan.build(jpart)
    _bitwise(halo, jhalo)
    hier = HierHaloPlan.build(part, 2, 4)
    _bitwise(hier, J.HierHaloPlan.build(jpart, 2, 4))
    return part, halo


@pytest.mark.parametrize("protocol", list(PROTOCOLS))
def test_scale_1e5_all_protocols(ranks, big, protocol):
    part = EdgePartition.build(big[0], WORLD)
    np.testing.assert_allclose(_got(part, ranks["big", protocol]),
                               reference.spmm(big[1], big[2]), rtol=1e-4,
                               atol=1e-2, err_msg=f"protocol {protocol}")


def test_scale_1e5_plans_bitwise(big):
    part, _ = _plans_bitwise(big[0], big[1])
    assert part.halo_stats()["max_halo"] > 1000


def test_scale_1e6_plans_bitwise():
    e = _random_edges(1_000_000, 2, seed=3)
    _plans_bitwise(Graph.from_edges(*e, make_undirected=True).adj,
                   JGraph.from_edges(*e, make_undirected=True).adj)


@pytest.mark.parametrize("name", list(ADVERSARIAL))
@pytest.mark.parametrize("protocol", list(PROTOCOLS))
def test_adversarial_graphs_match(ranks, name, protocol):
    rows, cols, n, X = ADVERSARIAL[name]
    part = EdgePartition.build(_coo_csr(CSR, rows, cols, n), WORLD)
    np.testing.assert_allclose(
        _got(part, ranks[name, protocol]),
        reference.spmm(_coo_csr(JCSR, rows, cols, n), X), rtol=1e-4,
        atol=1e-3, err_msg=f"{name}: protocol {protocol}")


@pytest.mark.parametrize("name", list(ADVERSARIAL))
def test_adversarial_plans_bitwise(name):
    rows, cols, n, _ = ADVERSARIAL[name]
    part, halo = _plans_bitwise(_coo_csr(CSR, rows, cols, n),
                                _coo_csr(JCSR, rows, cols, n))
    if name == "empty_shards":  # the case under test
        assert min(int(part.offsets[p, -1]) for p in range(WORLD)) == 0
    if name == "all_remote":
        assert np.trace(part.halo_stats()["comm_matrix"]) == 0
    if name == "row_hub":  # a halo slab as large as half a shard
        assert halo.H >= part.rows_per_dev // 2


def test_hier_hosts_mismatch_raises():
    e = _random_edges(256, 4, seed=9)
    plan = EdgePartition.build(Graph.from_edges(*e, make_undirected=True).adj,
                               8)
    with pytest.raises(ValueError):
        HierHaloPlan.build(plan, 3, 4)


def test_from_shards_matches_jax(ranks, shard_store, tmp_path):
    csr, store, _ = shard_store
    part = EdgePartition.from_shards(store, chips_per_shard=4)
    jstore = JShardedCSR.build(JCSR(csr.shape, csr.offsets, csr.indices,
                                    csr.vals), 2, str(tmp_path / "jax"))
    jpart = J.EdgePartition.from_shards(jstore, chips_per_shard=4)
    _bitwise(part, jpart)
    assert part.num_devices == 8
    assert part.row_starts[0] == 0 and part.row_starts[-1] == 96
    assert sum(int(part.offsets[p, -1]) for p in range(8)) == csr.nnz
    assert part.row_starts[4] == store.row_starts[1]
    _bitwise(HierHaloPlan.build(part, 2, 4), J.HierHaloPlan.build(jpart, 2,
                                                                  4))
    X = np.random.default_rng(5).normal(size=(96, 6)).astype(np.float32)
    np.testing.assert_allclose(
        _got(part, ranks["from_shards", "hier"]),
        reference.spmm(JCSR(csr.shape, csr.offsets, csr.indices, csr.vals),
                       X), rtol=1e-4, atol=1e-4)


def test_from_shards_scale_1e6_plans_bitwise(tmp_path):
    e = _random_edges(1_000_000, 2, seed=11)
    port = Graph.from_edges(*e, make_undirected=True).adj
    ref = JGraph.from_edges(*e, make_undirected=True).adj
    part = EdgePartition.from_shards(
        ShardedCSR.build(port, 2, str(tmp_path / "port")), 4)
    jstore = JShardedCSR.build(ref, 2, str(tmp_path / "jax"))
    jpart = J.EdgePartition.from_shards(jstore, 4)
    _bitwise(part, jpart)
    assert part.row_starts[4] == jstore.row_starts[1]
    _bitwise(HierHaloPlan.build(part, 2, 4),
             J.HierHaloPlan.build(jpart, 2, 4))
