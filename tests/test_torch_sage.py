"""The port's neighbour sampling (``models/sampling.py``) and GraphSAGE
(``models/sage.py``) against ``loops_tpu``'s on the same seeded numpy
inputs, with the JAX model's weights carried over by ``params_from_jax``.

A torch generator cannot reproduce JAX's PRNG, so the sampling cases feed
the port's mappings ``neighbors_from_draws`` and ``block_from_draws`` the
draws that ``jax.random.randint`` makes inside ``loops_tpu``: the ids must
be equal exactly, isolated seeds (which sample themselves) and the last
node, whose row starts at the last edge, included.

Tolerances:

- full-graph logits: ``rtol=atol=1e-5`` on group_mapped (both packages'
  CPU route under ``auto``), ``1e-4`` on ``merge_path``/``pallas`` (K4's
  plain version on the CPU); parameter gradients the same;
- bf16, layer by layer on JAX's own layer inputs: each aggregation within
  ``tests/test_torch_spmm_bf16.py``'s bound for the bf16 group_mapped
  route (twice the Wilkinson bound over the bf16-rounded products plus
  one bf16 rounding of each, ``(2 * 4 * nnz_r * u32 + 2**-8) * sum |p|``,
  floor 1e-6), and each layer's output within that bound carried through
  ``|W_neigh|`` plus the f32 rounding of both layers' products and sums,
  ``2 * (K + 2) * u32 * (|h| |W_self| + |agg| |W_neigh| + |b|)``;
- ``apply_frontiers`` on JAX's frontiers against ``apply_sampled``:
  ``1e-5``;
- one Adam step, sampled (from JAX's seeds and draws) and full-graph,
  against one ``optax.adam`` step: loss ``rtol=1e-5``, parameters
  ``atol=1e-5``.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import loops_tpu.models.train as JT
from loops_tpu.models import GraphSAGE as JaxSAGE
from loops_tpu.models import sampling as jsampling
from loops_tpu.models.graph import Graph as JaxGraph
from loops_tpu.models.sage import make_sampled_train_step as jax_sampled_step
from loops_tpu_torch import models
from loops_tpu_torch.models import (
    GraphSAGE,
    init_sage,
    make_sampled_train_step,
    params_from_jax,
    sample_neighbors,
    sampled_block,
)
from loops_tpu_torch.models import train as T
from loops_tpu_torch.models.graph import Graph
from loops_tpu_torch.models.sampling import (
    DRAW_HIGH,
    block_from_draws,
    neighbors_from_draws,
)
from loops_tpu_torch.utils import reference

CPU = torch.device("cpu")
N, F_IN = 40, 6
DIMS = [F_IN, 10, 10, 3]
U32 = reference.unit_roundoff(np.float32)
U_BF16 = 2.0 ** -8


def graphs(n=N, m=90, isolated=3, seed=13):
    """The same graph in both packages; the last ``isolated`` nodes have
    no edge, so the last one's row starts at the last edge (nnz)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n - isolated, m)
    dst = rng.integers(0, n - isolated, m)
    return (Graph.from_edges(src, dst, n, make_undirected=True),
            JaxGraph.from_edges(src, dst, n, make_undirected=True))


def _is_neighbor(g, seeds, nbr):
    """Every sampled id is a CSR neighbour of its seed, or the seed itself
    where the seed has none."""
    off, ind = g.adj.offsets, g.adj.indices
    for s, row in zip(np.asarray(seeds), np.asarray(nbr)):
        cols = ind[off[s]:off[s + 1]]
        allowed = cols if len(cols) else np.array([s])
        if not np.isin(row, allowed).all():
            return False
    return True


def _jax_draws(key, frontier, fanouts):
    """The draws ``loops_tpu.models.sampling.sampled_block`` makes."""
    draws = []
    for f in fanouts:
        key, sub = jax.random.split(key)
        draws.append(np.asarray(jax.random.randint(sub, (frontier, f), 0,
                                                   DRAW_HIGH)))
        frontier *= f
    return draws


def test_neighbors_from_draws_equal_jax():
    g, jg = graphs()
    seeds = np.array([0, 5, 37, 38, 39, 12, 39, 1], np.int32)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jsampling.sample_neighbors(jg, seeds, 7, key))
    r = np.asarray(jax.random.randint(key, (len(seeds), 7), 0, DRAW_HIGH))
    got = neighbors_from_draws(g, seeds, r)
    assert got.dtype == torch.int64 and got.shape == (8, 7)
    np.testing.assert_array_equal(got.numpy(), want)
    assert g.adj.offsets[39] == g.adj.nnz        # the last row's start
    assert np.all(got.numpy()[2:5] == seeds[2:5, None])   # isolated seeds
    assert _is_neighbor(g, seeds, got)


def test_block_from_draws_equals_jax_sampled_block():
    g, jg = graphs()
    seeds = np.array(list(range(0, N, 3)) + [N - 1], np.int32)
    fanouts = [3, 2, 2]
    key = jax.random.PRNGKey(5)
    jhops, jfr = jsampling.sampled_block(jg, seeds, fanouts, key)
    hops, fr = block_from_draws(g, seeds,
                                _jax_draws(key, len(seeds), fanouts))
    assert len(hops) == len(jhops) and len(fr) == len(jfr)
    for a, b in zip(hops + fr, list(jhops) + list(jfr)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_sampling_from_a_generator():
    g, _ = graphs()
    seeds = torch.arange(N)
    a = sample_neighbors(g, seeds, 5, torch.Generator().manual_seed(1),
                         device=CPU)
    b = sample_neighbors(g, seeds, 5, torch.Generator().manual_seed(1),
                         device=CPU)
    assert a.shape == (N, 5) and a.dtype == torch.int64
    assert torch.equal(a, b) and _is_neighbor(g, seeds, a)
    hops, fr = sampled_block(g, seeds, [2, 3],
                             torch.Generator().manual_seed(2), device=CPU)
    assert [tuple(h.shape) for h in hops] == [(N, 2), (2 * N, 3)]
    assert [len(f) for f in fr] == [N, 2 * N, 6 * N]
    assert _is_neighbor(g, fr[0], hops[0]) and _is_neighbor(g, fr[1],
                                                            hops[1])
    # a graph without edges: every seed samples itself
    empty = Graph.from_edges(np.zeros(0, int), np.zeros(0, int), 4)
    np.testing.assert_array_equal(
        neighbors_from_draws(empty, np.arange(4), np.ones((4, 2))).numpy(),
        np.repeat(np.arange(4)[:, None], 2, axis=1))


def test_csr_is_staged_once_per_device():
    g, _ = graphs()
    a = g.csr_on(CPU)
    assert g.csr_on("cpu") is a
    np.testing.assert_array_equal(a[0].numpy(), g.adj.offsets)
    np.testing.assert_array_equal(a[1].numpy(), g.adj.indices)
    assert a[0].dtype == a[1].dtype == torch.int64


# a generator on another device than the sampling's (a stand-in with only
# the ``device`` the checks read), and ids on another device
CARD_GENERATOR = types.SimpleNamespace(device=torch.device("cuda", 0))
FOREIGN = {
    "sample_neighbors": lambda g, m: sample_neighbors(
        g, np.arange(4), 2, CARD_GENERATOR, device=CPU),
    "sampled_block": lambda g, m: sampled_block(
        g, np.arange(4), [2], CARD_GENERATOR, device=CPU),
    "apply_sampled": lambda g, m: m.apply_sampled(
        np.zeros((N, F_IN), np.float32), np.arange(4), [2, 2, 2],
        CARD_GENERATOR),
    "make_sampled_train_step": lambda g, m: make_sampled_train_step(
        m, torch.optim.Adam(m.parameters()), np.zeros((N, F_IN), np.float32),
        np.zeros(N, np.int32), [2, 2, 2], 4, generator=CARD_GENERATOR),
    "seed_tensor": lambda g, m: sample_neighbors(
        g, torch.arange(4, device="meta"), 2, torch.Generator(), device=CPU),
    "draws_and_seeds": lambda g, m: neighbors_from_draws(
        g, torch.arange(4, device="meta"), np.zeros((4, 2), np.int64)),
    "frontier_tensor": lambda g, m: m.apply_frontiers(
        np.zeros((N, F_IN), np.float32),
        [torch.arange(2, device="meta")] * 4, [2, 2, 2]),
}


@pytest.mark.parametrize("case", sorted(FOREIGN))
def test_sampling_refuses_another_device(case):
    g, _ = graphs()
    m = GraphSAGE(g, DIMS, device=CPU)
    with pytest.raises(ValueError, match="sampling moves nothing"):
        FOREIGN[case](g, m)


def _pair(schedule="auto", impl="xla", dtype=None):
    g, jg = graphs()
    jm = JaxSAGE(jg, DIMS, dtype=dtype)
    params = jm.init(jax.random.PRNGKey(0))
    m = GraphSAGE(g, DIMS, schedule=schedule, impl=impl, dtype=dtype,
                  device=CPU)
    m.load_state_dict(params_from_jax(params))
    x = np.random.default_rng(4).normal(size=(N, F_IN)).astype(np.float32)
    return m, jm, params, x


@pytest.mark.parametrize("route,tol", [
    (("auto", "xla"), 1e-5), (("merge_path", "pallas"), 1e-4)],
    ids=["group_mapped", "k4"])
def test_full_graph_forward_and_gradients_match_jax(route, tol):
    m, jm, params, x = _pair(*route)
    assert [op.impl_used for op in m.operators()] == (
        ["flat_spmm", "flat_spmm"] if route[1] == "pallas"
        else ["torch", "torch"])
    want = np.asarray(jm.apply(params, x))
    y = m(torch.from_numpy(x))
    assert y.shape == (N, DIMS[-1])
    np.testing.assert_allclose(y.detach().numpy(), want, rtol=tol, atol=tol)
    (y ** 2).sum().backward()
    grads = jax.grad(lambda p: (jm.apply(p, x) ** 2).sum())(params)
    for i, layer in enumerate(grads):
        for k, v in layer.items():
            np.testing.assert_allclose(
                getattr(m.layers[i], k).grad.numpy(), np.asarray(v),
                rtol=tol, atol=tol, err_msg=f"layer {i} {k}")


def _bf16_agg_tol(csr, h):
    """``test_torch_spmm_bf16.py``'s bound for the bf16 group_mapped
    route against ``loops_tpu``'s, for the aggregation of ``h``."""
    p = reference.bf16_products(csr, h)
    l1 = np.zeros((csr.shape[0], h.shape[1]))
    np.add.at(l1, csr.row_ids(), np.abs(p).astype(np.float64))
    nnz_r = csr.row_sizes().astype(np.float64)[:, None]
    return np.maximum(1e-6, 2 * reference.DEFAULT_WILKINSON_K * nnz_r * U32
                      * l1) + U_BF16 * l1


@pytest.mark.parametrize("layer", range(len(DIMS) - 1))
def test_bf16_layers_match_jax_bf16_mode(layer):
    m, jm, params, x = _pair(dtype="bfloat16")
    a_mean = m.graph.mean_normalized().adj
    h = jnp.asarray(x)
    for p in params[:layer]:                 # JAX's input to this layer
        h = jax.nn.relu(h @ p["w_self"] + jm.aggregate._fn(h) @ p["w_neigh"]
                        + p["b"])
    h = np.asarray(h)
    p = {k: np.asarray(v, np.float64) for k, v in params[layer].items()}
    agg_j = np.asarray(jm.aggregate._fn(jnp.asarray(h)), np.float64)
    out_j = h @ p["w_self"] + agg_j @ p["w_neigh"] + p["b"]
    if layer + 1 < len(params):
        out_j = np.maximum(out_j, 0)
    ht = torch.from_numpy(h)
    agg_t = m.aggregate._fn(ht)
    out_t = m.layer(layer, ht, agg_t).detach().numpy()
    agg_t = agg_t.detach().numpy()

    tol = _bf16_agg_tol(a_mean, h)
    assert np.all(np.abs(agg_t - agg_j) <= tol), \
        np.max(np.abs(agg_t - agg_j) - tol)
    k = h.shape[1] + 2
    out_tol = tol @ np.abs(p["w_neigh"]) + 2 * k * U32 * (
        np.abs(h) @ np.abs(p["w_self"]) + np.abs(agg_j) @ np.abs(p["w_neigh"])
        + np.abs(p["b"]))
    assert np.all(np.abs(out_t - out_j) <= out_tol), \
        np.max(np.abs(out_t - out_j) - out_tol)
    # the rounding is the mode's: f32 sums of the same input differ more
    m32, *_ = _pair()
    assert not np.array_equal(m32.aggregate._fn(ht).numpy(), agg_t)


def _frontiers_from_jax(jm, seeds, fanouts, key):
    """``loops_tpu``'s frontiers of ``apply_sampled(..., key)``."""
    frontiers = [np.asarray(seeds)]
    for f, k in zip(fanouts, jax.random.split(key, len(fanouts))):
        nbr = jsampling.sample_neighbors(jm.graph, frontiers[-1], f, k)
        frontiers.append(np.asarray(nbr).reshape(-1))
    return frontiers


def test_apply_frontiers_matches_jax_apply_sampled():
    m, jm, params, x = _pair()
    seeds = np.array([1, 4, 9, 39, 20], np.int32)
    fanouts = [3, 2, 2]
    key = jax.random.PRNGKey(8)
    want = np.asarray(jm.apply_sampled(params, x, seeds, fanouts, key))
    frontiers = _frontiers_from_jax(jm, seeds, fanouts, key)
    # the port's mapping of JAX's draws gives the same frontiers
    hops, fr = block_from_draws(m.graph, seeds, [
        np.asarray(jax.random.randint(k, (len(f), fo), 0, DRAW_HIGH))
        for k, f, fo in zip(jax.random.split(key, 3), frontiers, fanouts)])
    for a, b in zip(fr, frontiers):
        np.testing.assert_array_equal(a.numpy(), b)
    got = m.apply_frontiers(x, frontiers, fanouts).detach().numpy()
    assert got.shape == (5, DIMS[-1])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="fanout"):
        m.apply_frontiers(x, frontiers, fanouts[:2])


def test_apply_sampled_is_apply_frontiers_over_its_draws():
    m, _, _, x = _pair()
    seeds = torch.tensor([3, 7, 39])
    got = m.apply_sampled(x, seeds, [2, 2, 3],
                          torch.Generator().manual_seed(4))
    fr = m.sample_frontiers(seeds, [2, 2, 3],
                            torch.Generator().manual_seed(4))
    assert [len(f) for f in fr] == [3, 6, 12, 36]
    assert torch.equal(got, m.apply_frontiers(x, fr, [2, 2, 3]))


def _labels(x, seed=6):
    rng = np.random.default_rng(seed)
    return (x @ rng.normal(size=(F_IN, DIMS[-1]))).argmax(1).astype(np.int32)


def _assert_params_equal(m, params, atol):
    for i, layer in enumerate(params):
        for k, v in layer.items():
            np.testing.assert_allclose(
                getattr(m.layers[i], k).detach().numpy(), np.asarray(v),
                rtol=0, atol=atol, err_msg=f"layer {i} {k}")


def test_sampled_step_matches_optax_on_jax_draws():
    m, jm, params, x = _pair()
    labels = _labels(x)
    fanouts, batch = [3, 2, 2], 8
    opt = optax.adam(1e-2)
    rng = jax.random.PRNGKey(11)
    new, _, _, lj = jax.jit(jax_sampled_step(jm, opt, x, labels, fanouts,
                                             batch))(params, opt.init(params),
                                                     rng)
    # the seeds and draws of loops_tpu's step (models/sage.py:100)
    _, k_seed, k_sample = jax.random.split(rng, 3)
    seeds = np.asarray(jax.random.randint(k_seed, (batch,), 0, N))
    frontiers = _frontiers_from_jax(jm, seeds, fanouts, k_sample)
    step = make_sampled_train_step(
        m, torch.optim.Adam(m.parameters(), lr=1e-2), x, labels, fanouts,
        batch, generator=torch.Generator())
    lt = step(seeds, frontiers)
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
    _assert_params_equal(m, new, 1e-5)
    assert step.frontiers is frontiers


def test_full_graph_step_matches_optax():
    m, jm, params, x = _pair()
    labels = _labels(x)
    mask = (np.arange(N) % 3 != 0).astype(np.float32)
    opt = optax.adam(1e-2)
    new, _, _, lj = jax.jit(JT.make_train_step(jm, opt, x, labels, mask))(
        params, opt.init(params), jax.random.PRNGKey(0))
    step = T.make_train_step(m, torch.optim.Adam(m.parameters(), lr=1e-2),
                             x, labels, mask)
    np.testing.assert_allclose(float(step()), float(lj), rtol=1e-5)
    _assert_params_equal(m, new, 1e-5)
    assert T.evaluate(m, x, labels, mask) == pytest.approx(
        JT.evaluate(jm, new, x, labels, mask), abs=1e-9)


def _toy():
    g, _ = graphs(m=120, isolated=0)
    rng = np.random.default_rng(6)
    feats = rng.normal(size=(N, F_IN)).astype(np.float32)
    return g, feats, _labels(feats)


def test_sampled_training_descends():
    g, feats, labels = _toy()
    model = GraphSAGE(g, [F_IN, 12, 3], device=CPU)
    step = make_sampled_train_step(
        model, torch.optim.Adam(model.parameters(), lr=1e-2), feats, labels,
        fanouts=[4, 4], batch_size=16,
        generator=torch.Generator().manual_seed(1))
    losses = [float(step()) for _ in range(120)]
    assert np.mean(losses[-10:]) < 0.9 * np.mean(losses[:10])
    assert [len(f) for f in step.frontiers] == [16, 64, 256]
    assert _is_neighbor(g, step.frontiers[0],
                        step.frontiers[1].reshape(16, 4))


@pytest.mark.parametrize("form", ["sampled", "full_graph"])
def test_two_runs_are_bitwise_equal(form):
    g, feats, labels = _toy()
    model = GraphSAGE(g, [F_IN, 12, 12, 3], device=CPU)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    runs = []
    for _ in range(2):
        model.load_state_dict(start)
        opt = torch.optim.Adam(model.parameters(), lr=1e-2)
        if form == "sampled":
            step = make_sampled_train_step(
                model, opt, feats, labels, fanouts=[4, 3, 2], batch_size=16,
                generator=torch.Generator().manual_seed(2))
        else:
            step = T.make_train_step(model, opt, feats, labels,
                                     np.ones(N, np.float32))
        losses = torch.stack([step() for _ in range(3)])
        runs.append((losses, {k: v.clone()
                              for k, v in model.state_dict().items()}))
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(runs[0][1][k], runs[1][1][k]) for k in start)


def test_full_graph_training_and_evaluate():
    g, feats, labels = _toy()
    model = GraphSAGE(g, [F_IN, 12, 3], device=CPU)
    mask = np.ones(N, np.float32)
    step = T.make_train_step(model, torch.optim.Adam(model.parameters(),
                                                     lr=1e-2),
                             feats, labels, mask)
    losses = [float(step()) for _ in range(30)]
    assert losses[-1] < losses[0]
    assert 0.0 <= T.evaluate(model, feats, labels, mask) <= 1.0
    assert model.training is True
    # no prepare_features and no dropout: both packages read them through
    # getattr; weight decay reads each layer's w, which SAGE has not
    assert not hasattr(model, "prepare_features")
    with pytest.raises(ValueError, match="weight_decay"):
        T.make_train_step(model, torch.optim.Adam(model.parameters()),
                          feats, labels, mask, weight_decay=1e-3)


def test_init_and_params_carry():
    g, jg = graphs()
    params = JaxSAGE(jg, DIMS).init(jax.random.PRNGKey(2))
    m = GraphSAGE(g, DIMS, device=CPU)
    state = params_from_jax(params)
    assert set(state) == set(m.state_dict())
    m.load_state_dict(state)
    _assert_params_equal(m, params, 0)
    mine = init_sage(torch.Generator().manual_seed(0), DIMS)
    assert [sorted(layer) for layer in mine] == [sorted(layer)
                                                 for layer in params]
    for a, b in zip(mine, params):
        for k in a:
            assert tuple(a[k].shape) == np.asarray(b[k]).shape
    assert all(float(layer["b"].abs().sum()) == 0 for layer in mine)
    # the model's own init is init_sage's draw from its generator
    m2 = GraphSAGE(g, DIMS, device=CPU,
                   generator=torch.Generator().manual_seed(0))
    for i, layer in enumerate(mine):
        for k, v in layer.items():
            assert torch.equal(getattr(m2.layers[i], k).detach(), v)


def test_models_exports():
    for name in ("GraphSAGE", "init_sage", "make_sampled_train_step",
                 "sample_neighbors", "sampled_block"):
        assert callable(getattr(models, name))
    assert models.GraphSAGE is GraphSAGE
    assert models.sample_neighbors is sample_neighbors
