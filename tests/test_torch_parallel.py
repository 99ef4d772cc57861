"""The port's multi-device tier (``loops_tpu_torch/parallel/``) against
``loops_tpu.parallel``, case for case of ``tests/test_parallel.py``.

The JAX side runs on the 8-device CPU mesh of ``tests/conftest.py``; the
port's on 8 gloo ranks spawned once for the module
(``parallel/launch.run_ranks`` over ``parallel/workers.run_cases``), each
rank's output held against JAX's slice ``[p]`` of the same stacked
array. Inputs come from numpy seeds; parameters are JAX's, carried by
``params_from_jax``.

- plans bit for bit: ``EdgePartition`` (and its halo statistics and
  padded space), ``HaloPlan`` with ``split_edges``, ``HierHaloPlan``
  with ``volume_stats``, P = 64 included;
- outputs of DistSpMM (all-gather, and ``feature_axis`` on a 4 x 2
  mesh), DistSpMMHalo with and without overlap and DistSpMMHier 2 x 4,
  and their gradients, with no scatter node in the autograd graph;
- DistGCN and DistGraphSAGE forwards; the parameters' summed gradients
  against ``jax.grad`` of the same loss; five Adam steps' losses against
  ``optax.adam``; the replicas equal after training; hier against flat;
- ``launch.dryrun_multichip(8)`` from JAX's initial parameters.

Tolerances are ``tests/test_parallel.py``'s: rtol = atol = 1e-4 for
SpMM and its gradients, 1e-3 for the models.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import loops_tpu.parallel as J
from loops_tpu.models import Graph as JGraph
from loops_tpu.parallel.dist_ops import _stack_labels as j_stack_labels
from loops_tpu.parallel.halo import DistSpMMHalo as JHalo
from loops_tpu.parallel.halo import HaloPlan as JHaloPlan
from loops_tpu.parallel.mesh import make_mesh_2d, make_mesh_hier
from loops_tpu.utils import reference
from loops_tpu_torch.models.graph import Graph
from loops_tpu_torch.parallel import EdgePartition, HaloPlan, HierHaloPlan
from loops_tpu_torch.parallel import launch, workers

SPMM_TOL = dict(rtol=1e-4, atol=1e-4)
MODEL_TOL = dict(rtol=1e-3, atol=1e-3)
WORLD = 8


def _edges(n, seed):
    rng = np.random.default_rng(seed)
    m = 4 * n
    return rng.integers(0, n, m), rng.integers(0, n, m), n


def _graph(n=64, seed=0):
    return Graph.from_edges(*_edges(n, seed), make_undirected=True)


def _jgraph(n=64, seed=0):
    return JGraph.from_edges(*_edges(n, seed), make_undirected=True)


def _ring(n=128):
    src = np.concatenate([np.arange(n)] * 4)
    dst = np.concatenate([(np.arange(n) + d) % n for d in (1, 2, n - 1,
                                                           n - 2)])
    return src, dst, n


def _blocks():
    """8 cliques of 4 nodes, one per rank; blocks 4-7 also hold a chord
    to the block before them, so that ranks 0-2 read no halo row and the
    others do."""
    src, dst = [], []
    for b in range(8):
        for i in range(4):
            for j in range(4):
                if i != j:
                    src.append(4 * b + i)
                    dst.append(4 * b + j)
    for b in range(4, 8):
        src.append(4 * b)
        dst.append(4 * b - 1)
    return np.array(src), np.array(dst), 32


def _x(n, f, seed):
    return np.random.default_rng(seed).normal(size=(n, f)).astype(np.float32)


def _task(n, f, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, f)).astype(np.float32),
            rng.integers(0, 3, n).astype(np.int32), np.ones(n, np.float32))


def _plan_arrays(obj):
    return {k: v for k, v in vars(obj).items()
            if isinstance(v, np.ndarray) or isinstance(v, (int, np.integer))}


def assert_bitwise(port, ref):
    a, b = _plan_arrays(port), _plan_arrays(ref)
    assert a.keys() == b.keys()
    for k in a:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ------------------------------------------------ the ranks' cases
SAGE_DIMS, GCN_DIMS = [5, 6, 3], [5, 7, 3]


def _cases():
    """``{name: (kind, mesh, kwargs)}`` run on the 8 ranks in one group."""
    g48, X6, X8 = _graph(48, 4), _x(48, 6, 5), _x(48, 8, 5)
    g32, X4 = _graph(32, 10), _x(32, 4, 6)
    gparams = _jparams("gcn", GCN_DIMS, 0)
    cases = {}
    for proto in ("all_gather", "halo", "halo_overlap"):
        cases[f"spmm_{proto}"] = ("spmm", "flat", dict(
            csr=g48.adj, X=X6, protocol=proto))
        cases[f"grad_{proto}"] = ("spmm", "flat", dict(
            csr=g32.adj, X=X4, protocol=proto))
    cases["grad_halo_overlap_blocks"] = ("spmm", "flat", dict(
        csr=Graph.from_edges(*_blocks(), make_undirected=True).adj, X=X4,
        protocol="halo_overlap"))
    cases["spmm_hier"] = ("spmm", ("hier", 2, 4), dict(
        csr=g48.adj, X=X6, protocol="hier"))
    cases["grad_hier"] = ("spmm", ("hier", 2, 4), dict(
        csr=g32.adj, X=X4, protocol="hier"))
    cases["spmm_feature_axis"] = ("spmm", ("2d", 4, 2), dict(
        csr=g48.adj, X=X8, protocol="feature_axis"))
    X40 = _x(40, 5, 7)
    for exch, overlap in (("halo", True), ("halo", False),
                          ("all_gather", False)):
        cases[f"gcn_{exch}_{overlap}"] = ("model", "flat", dict(
            kind="gcn", graph=_graph(40, 6), dims=GCN_DIMS, params=gparams,
            X=X40, exchange=exch, overlap=overlap))
    cases["sage"] = ("model", "flat", dict(
        kind="sage", graph=_graph(36, 12), dims=SAGE_DIMS,
        params=_jparams("sage", SAGE_DIMS, 0), X=_x(36, 5, 8)))
    X, y, mask = _task(32, 4, 9)
    for name, mesh, exch in (("train_gcn", "flat", "halo"),
                             ("train_gcn_all_gather", "flat", "all_gather"),
                             ("train_gcn_hier", ("hier", 2, 4), "hier")):
        cases[name] = ("train", mesh, dict(
            kind="gcn", graph=_graph(32, 8), dims=[4, 8, 3],
            params=_jparams("gcn", [4, 8, 3], 1), X=X, y=y, mask=mask,
            lr=5e-2, steps=40 if name == "train_gcn" else 10,
            exchange=exch))
    Xs, ys, ms = _task(36, 5, 9)
    cases["train_sage"] = ("train", "flat", dict(
        kind="sage", graph=_graph(36, 12), dims=SAGE_DIMS,
        params=_jparams("sage", SAGE_DIMS, 0), X=Xs, y=ys, mask=ms,
        lr=3e-2, steps=30))
    Xo, yo, mo = _task(40, 5, 15)
    for exch in ("halo", "all_gather"):
        cases[f"sgd_{exch}"] = ("train", "flat", dict(
            kind="gcn", graph=_graph(40, 14), dims=[5, 6, 3],
            params=_jparams("gcn", [5, 6, 3], 3), X=Xo, y=yo, mask=mo,
            lr=1e-2, steps=1, exchange=exch, optimizer="sgd"))
    return cases


def _jparams(kind, dims, seed):
    from loops_tpu.models.gcn import init_gcn
    from loops_tpu.models.sage import init_sage

    init = init_gcn if kind == "gcn" else init_sage
    return [{k: np.asarray(v) for k, v in layer.items()}
            for layer in init(jax.random.PRNGKey(seed), dims)]


@pytest.fixture(scope="module")
def ranks():
    """Every case's per-rank results, from one group of 8 gloo ranks."""
    cases = _cases()
    names = list(cases)
    out = launch.run_ranks(workers.run_cases, WORLD,
                           [cases[n] for n in names], "cpu", backend="gloo",
                           timeout=300)
    return {n: [out[r][i] for r in range(WORLD)]
            for i, n in enumerate(names)}


def _stacked(res, key="out"):
    """Rank results -> [P, ...] in partition order (one rank a p)."""
    by_p = {r["p"]: r[key] for r in res}
    return np.stack([by_p[p] for p in range(len(by_p))])


# ------------------------------------------------ plans, bit for bit
@pytest.mark.parametrize("n,seed,P", [(50, 1, 8), (30, 2, 4), (40, 3, 4),
                                      (48, 4, 8), (96, 11, 8)])
def test_edge_partition_bitwise(n, seed, P):
    port = EdgePartition.build(_graph(n, seed).adj, P)
    ref = J.EdgePartition.build(_jgraph(n, seed).adj, P)
    assert_bitwise(port, ref)
    np.testing.assert_array_equal(port.indices_padded, ref.indices_padded)
    ids = np.arange(n)
    np.testing.assert_array_equal(port.owner_of(ids), ref.owner_of(ids))
    np.testing.assert_array_equal(port.global_to_padded(ids),
                                  ref.global_to_padded(ids))
    X = _x(n, 3, seed)
    np.testing.assert_array_equal(port.pad_features(X), ref.pad_features(X))
    for p in range(P):
        np.testing.assert_array_equal(port.local_features(X, p),
                                      ref.pad_features(X)[p])
    np.testing.assert_array_equal(port.unpad_output(port.pad_features(X)), X)


def test_partition_invariants():
    csr = _graph(50, seed=1).adj
    plan = EdgePartition.build(csr, 8)
    assert plan.row_starts[0] == 0 and plan.row_starts[-1] == 50
    assert (np.diff(plan.row_starts) >= 0).all()
    assert sum(int(plan.offsets[p, -1]) for p in range(8)) == csr.nnz
    work = [int(plan.offsets[p, -1]) + int(np.diff(plan.row_starts)[p])
            for p in range(8)]
    ipp = -(-(csr.nnz + 50) // 8)
    assert max(work) <= ipp + int(csr.row_sizes().max())


def test_halo_stats_bitwise():
    port = EdgePartition.build(_graph(40, 3).adj, 4).halo_stats()
    ref = J.EdgePartition.build(_jgraph(40, 3).adj, 4).halo_stats()
    np.testing.assert_array_equal(port["comm_matrix"], ref["comm_matrix"])
    assert port["max_halo"] == ref["max_halo"] <= 40
    for a, b in zip(port["halo_nodes"], ref["halo_nodes"]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("graph", ["g48", "g32", "ring", "p64"])
def test_halo_plan_and_split_bitwise(graph):
    if graph == "ring":
        port_g = Graph.from_edges(*_ring())
        ref_g = JGraph.from_edges(*_ring())
    elif graph == "p64":
        rng = np.random.default_rng(16)
        n = 2048
        e = rng.integers(0, n, 16 * n), rng.integers(0, n, 16 * n), n
        port_g = Graph.from_edges(*e, make_undirected=True)
        ref_g = JGraph.from_edges(*e, make_undirected=True)
    else:
        n, seed = (48, 4) if graph == "g48" else (32, 10)
        port_g, ref_g = _graph(n, seed), _jgraph(n, seed)
    P = 64 if graph == "p64" else 8
    port = HaloPlan.build(EdgePartition.build(port_g.adj, P))
    ref = JHaloPlan.build(J.EdgePartition.build(ref_g.adj, P))
    assert_bitwise(port, ref)
    assert_bitwise(port.part, ref.part)
    a, b = port.split_edges(), ref.split_edges()
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    R = port.part.rows_per_dev
    assert port.indices_local.max() < R + P * port.H
    assert port.send_idx.max() < R
    if graph == "ring":  # the per-pair halo is tiny against the table
        assert 8 * port.H < 128 // 2


@pytest.mark.parametrize("n,seed", [(48, 4), (96, 11), (32, 8)])
def test_hier_plan_and_volume_bitwise(n, seed):
    port = HierHaloPlan.build(EdgePartition.build(_graph(n, seed).adj, 8),
                              2, 4)
    ref = J.HierHaloPlan.build(J.EdgePartition.build(_jgraph(n, seed).adj,
                                                     8), 2, 4)
    assert_bitwise(port, ref)
    assert port.indices_local.max() < port.part.rows_per_dev + 4 * port.Hi
    stats = port.volume_stats()
    assert stats == ref.volume_stats()
    assert stats["dcn_hier_rows"] <= stats["dcn_flat_rows"]
    if (n, seed) == (96, 11):
        assert stats["dcn_dedup_factor"] > 1.5, stats


def test_hier_hosts_mismatch_raises():
    plan = EdgePartition.build(_graph(64, 9).adj, 8)
    with pytest.raises(ValueError):
        HierHaloPlan.build(plan, 3, 4)


# ------------------------------------------------ outputs and gradients
def _j_op(protocol, part, mesh=None):
    if protocol == "all_gather":
        return J.DistSpMM(part, J.make_mesh(8))
    if protocol == "feature_axis":
        return J.DistSpMM(part, make_mesh_2d(4, 2), feature_axis="model")
    if protocol == "hier":
        return J.DistSpMMHier(J.HierHaloPlan.build(part, 2, 4),
                              make_mesh_hier(2, 4))
    return JHalo(JHaloPlan.build(part), J.make_mesh(8),
                 overlap=protocol == "halo_overlap")


@pytest.mark.parametrize("protocol", ["all_gather", "halo", "halo_overlap",
                                      "hier", "feature_axis"])
def test_dist_spmm_matches_jax(ranks, protocol):
    csr = _jgraph(48, 4).adj
    X = _x(48, 8 if protocol == "feature_axis" else 6, 5)
    part = J.EdgePartition.build(csr, 4 if protocol == "feature_axis"
                                 else 8)
    want = np.asarray(_j_op(protocol, part)(part.pad_features(X)))
    res = ranks[f"spmm_{protocol}"]
    if protocol == "feature_axis":
        # rank (g, m) holds graph partition g's F-slice m
        got = np.zeros_like(want)
        for r, rr in enumerate(res):
            m = r % 2
            got[rr["p"], :, 4 * m:4 * (m + 1)] = rr["out"]
    else:
        got = _stacked(res)
    np.testing.assert_allclose(got, want, **SPMM_TOL)
    np.testing.assert_allclose(part.unpad_output(got),
                               reference.spmm(csr, X), **SPMM_TOL)


def test_halo_overlap_gradient_where_some_ranks_read_no_halo(ranks):
    """Ranks with no boundary edge skip the boundary reduction; every
    rank still issues the exchange's backward, and the result and the
    gradient stay JAX's."""
    csr = JGraph.from_edges(*_blocks(), make_undirected=True).adj
    part = J.EdgePartition.build(csr, 8)
    s = JHaloPlan.build(part).split_edges()
    empty = (s["bnd_rows"] >= part.rows_per_dev).all(axis=1)
    assert 0 < empty.sum() < 8
    op = _j_op("halo_overlap", part)
    h = part.pad_features(_x(32, 4, 6))
    res = ranks["grad_halo_overlap_blocks"]
    np.testing.assert_allclose(_stacked(res), np.asarray(op(h)), **SPMM_TOL)
    want = np.asarray(jax.grad(lambda v: (op(v) ** 2).sum())(h))
    np.testing.assert_allclose(_stacked(res, "grad"), want, **SPMM_TOL)


@pytest.mark.parametrize("protocol", ["all_gather", "halo", "halo_overlap",
                                      "hier"])
def test_dist_spmm_gradients_match_jax(ranks, protocol):
    csr = _jgraph(32, 10).adj
    part = J.EdgePartition.build(csr, 8)
    op = _j_op(protocol, part)
    h = part.pad_features(_x(32, 4, 6))
    want = np.asarray(jax.grad(lambda v: (op(v) ** 2).sum())(h))
    res = ranks[f"grad_{protocol}"]
    np.testing.assert_allclose(_stacked(res, "grad"), want, **SPMM_TOL)
    # the dense oracle, as test_halo_gradients_flow
    dense = jnp.asarray(csr.to_dense())
    gd = np.asarray(jax.grad(lambda X: ((dense @ X) ** 2).sum())(
        jnp.asarray(_x(32, 4, 6))))
    np.testing.assert_allclose(part.unpad_output(_stacked(res, "grad")), gd,
                               rtol=1e-3, atol=1e-3)
    # the exchanges' and local reductions' gradients scatter nowhere
    for r in res:
        bad = [n for n in r["ops"] if any(s in n for s in
                                          workers.SCATTER_NODES)]
        assert not bad, bad


@pytest.mark.parametrize("exchange,overlap", [("halo", True),
                                              ("halo", False),
                                              ("all_gather", False)])
def test_dist_gcn_forward_matches_jax(ranks, exchange, overlap):
    g = _jgraph(40, 6)
    model = J.DistGCN(g, GCN_DIMS, J.make_mesh(8), exchange=exchange,
                      overlap=overlap)
    params = model.init(jax.random.PRNGKey(0))
    X = _x(40, 5, 7)
    want = np.asarray(model.apply(params, model.plan.pad_features(X)))
    got = _stacked(ranks[f"gcn_{exchange}_{overlap}"])
    np.testing.assert_allclose(got, want, **MODEL_TOL)
    # the single-device GCN, as test_dist_gcn_forward_matches_single_device
    from loops_tpu.models import GCN
    single = np.asarray(GCN(g, GCN_DIMS, dropout=0.0).apply(params, X))
    np.testing.assert_allclose(model.plan.unpad_output(got), single,
                               **MODEL_TOL)


def test_dist_graphsage_forward_matches_jax(ranks):
    g = _jgraph(36, 12)
    model = J.DistGraphSAGE(g, SAGE_DIMS, J.make_mesh(8))
    params = model.init(jax.random.PRNGKey(0))
    X = _x(36, 5, 8)
    want = np.asarray(model.apply(params, model.plan.pad_features(X)))
    np.testing.assert_allclose(_stacked(ranks["sage"]), want, **MODEL_TOL)


def _jax_losses(kind, n, seed, dims, X, y, mask, lr, steps, mesh=None,
                exchange="halo", pseed=1):
    Model = J.DistGCN if kind == "gcn" else J.DistGraphSAGE
    model = Model(_jgraph(n, seed), dims, mesh or J.make_mesh(8),
                  exchange=exchange)
    params = model.init(jax.random.PRNGKey(pseed))
    opt = optax.adam(lr)
    step = model.make_train_step(opt, X, y, mask)
    state = opt.init(params)
    losses = []
    for _ in range(steps):
        params, state, loss = step(params, state)
        losses.append(float(loss))
    return model, losses


def test_dist_gcn_trains_like_jax(ranks):
    X, y, mask = _task(32, 4, 9)
    _, want = _jax_losses("gcn", 32, 8, [4, 8, 3], X, y, mask, 5e-2, 5)
    res = ranks["train_gcn"]
    losses = res[0]["losses"]
    np.testing.assert_allclose(losses[:5], want, **MODEL_TOL)
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.8, losses[::10]
    # every rank took the same steps: one loss, one set of parameters
    for r in res[1:]:
        assert r["losses"] == losses
        for a, b in zip(r["params"], res[0]["params"]):
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])


def test_dist_gcn_param_gradients_match_jax(ranks):
    X, y, mask = _task(32, 4, 9)
    model = J.DistGCN(_jgraph(32, 8), [4, 8, 3], J.make_mesh(8))
    params = model.init(jax.random.PRNGKey(1))
    h0 = jnp.asarray(model.plan.pad_features(X))
    lab, msk = j_stack_labels(model.plan, y, mask)

    def loss_fn(p):
        logp = jax.nn.log_softmax(model.apply(p, h0), axis=-1)
        nll = -jnp.take_along_axis(logp, lab[..., None], axis=-1)[..., 0]
        return (nll * msk).sum() / jnp.maximum(msk.sum(), 1.0)

    want = jax.grad(loss_fn)(params)
    for r in ranks["train_gcn"]:
        for got, ref in zip(r["grads"], want):
            for k in ref:
                np.testing.assert_allclose(got[k], np.asarray(ref[k]),
                                           **MODEL_TOL)


def test_dist_graphsage_trains_like_jax(ranks):
    X, y, mask = _task(36, 5, 9)
    _, want = _jax_losses("sage", 36, 12, SAGE_DIMS, X, y, mask, 3e-2, 5,
                          pseed=0)
    losses = ranks["train_sage"][0]["losses"]
    np.testing.assert_allclose(losses[:5], want, **MODEL_TOL)
    assert losses[-1] < losses[0]


def test_hier_dist_gcn_trains_like_flat(ranks):
    X, y, mask = _task(32, 4, 9)
    _, want = _jax_losses("gcn", 32, 8, [4, 8, 3], X, y, mask, 5e-2, 5,
                          mesh=make_mesh_hier(2, 4), exchange="hier")
    hier = ranks["train_gcn_hier"][0]["losses"]
    flat = ranks["train_gcn"][0]["losses"][:10]
    assert np.isfinite(hier).all()
    np.testing.assert_allclose(hier, flat, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(hier[:5], want, **MODEL_TOL)
    np.testing.assert_allclose(
        ranks["train_gcn_all_gather"][0]["losses"], flat, rtol=1e-4,
        atol=1e-5)


def test_halo_overlap_sgd_step_matches_all_gather_oracle(ranks):
    a, b = ranks["sgd_halo"][0], ranks["sgd_all_gather"][0]
    np.testing.assert_allclose(a["losses"], b["losses"], rtol=1e-5)
    for x, y in zip(a["params"], b["params"]):
        for k in x:
            np.testing.assert_allclose(x[k], y[k], rtol=1e-4, atol=1e-5)
    # and the JAX package's step from the same parameters
    Xo, yo, mo = _task(40, 5, 15)
    model = J.DistGCN(_jgraph(40, 14), [5, 6, 3], J.make_mesh(8))
    params = model.init(jax.random.PRNGKey(3))
    opt = optax.sgd(1e-2)
    p1, _, loss = model.make_train_step(opt, Xo, yo, mo)(
        params, opt.init(params))
    np.testing.assert_allclose(a["losses"][0], float(loss), **MODEL_TOL)
    for x, y in zip(a["params"], p1):
        for k in y:
            np.testing.assert_allclose(x[k], np.asarray(y[k]), **MODEL_TOL)


def test_dryrun_multichip_matches_jax(capsys):
    from loops_tpu.models.gcn import init_gcn
    from loops_tpu.parallel.dist_ops import DistGCN

    params = [{k: np.asarray(v) for k, v in layer.items()}
              for layer in init_gcn(jax.random.PRNGKey(0), [8, 16, 4])]
    r = launch.dryrun_multichip(8, params, timeout=300)
    line = capsys.readouterr().out
    assert "dryrun_multichip(8)" in line and "dedup" in line, line
    # the JAX dry run's step from the same graph and parameters
    rng = np.random.default_rng(2)
    n = 512 * 8
    g = JGraph.from_edges(rng.integers(0, n, 4 * n),
                          rng.integers(0, n, 4 * n), n, make_undirected=True)
    model = DistGCN(g, [8, 16, 4], J.make_mesh(8))
    rng = np.random.default_rng(3)
    feats = rng.normal(size=(n, 8)).astype(np.float32)
    labels = rng.integers(0, 4, n).astype(np.int32)
    opt = optax.adam(1e-2)
    _, _, loss = model.make_train_step(opt, feats, labels,
                                       np.ones(n, np.float32))(
        params, opt.init(params))
    np.testing.assert_allclose(r["loss"], float(loss), **MODEL_TOL)
    assert abs(r["oracle_loss"] - r["loss"]) <= 1e-4 * abs(r["loss"])
    assert abs(r["hier_loss"] - r["loss"]) <= 1e-4 * abs(r["loss"])
    jstats = J.HierHaloPlan.build(model.plan, 2, 4).volume_stats()
    assert r["dcn_dedup_factor"] == jstats["dcn_dedup_factor"]
