"""The port's GAT and GATv2 (``models/gat.py``, ``models/gatv2.py``)
against ``loops_tpu``'s on the same seeded numpy inputs, with the JAX
models' weights carried over by ``params_from_jax``.

Tolerances:

- f32 logits of every route (GAT fused with the transposed-plan backward,
  fused through autograd, textbook; GATv2 fused and textbook) within
  ``rtol=atol=1e-4`` of JAX's fused and textbook routes, parameter
  gradients the same;
- one Adam step against one ``optax.adam`` step: loss ``rtol=1e-5``,
  parameters ``atol=1e-5``; the hidden layers' ``b`` (which GAT never
  reads) stays 0 in both;
- bf16 (the fused routes) within JAX's own bf16 bounds of JAX's bf16
  model: logits 0.05, parameter gradients 0.08
  (``tests/test_attention.py:69, 173``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from loops_tpu.models import GAT as JaxGAT
from loops_tpu.models import GATv2 as JaxGATv2
from loops_tpu.models import train as JT
from loops_tpu.models.graph import Graph as JaxGraph
from loops_tpu_torch.models import (
    GAT,
    GATv2,
    init_gat,
    init_gatv2,
    params_from_jax,
)
from loops_tpu_torch.models import train as T
from loops_tpu_torch.models.graph import Graph
from test_torch_cuda_gnn import grad_fn_names, scatter_nodes

CPU = torch.device("cpu")
N, F_IN, HEADS = 40, 6, 2
DIMS = [F_IN, 5, 3]
TOL = 1e-4
BF16_FWD, BF16_GRAD = 0.05, 0.08
JAX_MODELS = {"gat": JaxGAT, "gatv2": JaxGATv2}
MODELS = {"gat": GAT, "gatv2": GATv2}
# route -> (constructor keywords of both packages, the port's only)
ROUTES = {
    "gat": {"fused": ({}, {}), "autograd": ({}, {"vjp": False}),
            "textbook": ({"fused": False}, {})},
    "gatv2": {"fused": ({}, {}), "textbook": ({"fused": False}, {})},
}
CASES = [(m, r) for m in ROUTES for r in ROUTES[m]]


def graphs(n=N, m=90, isolated=3, seed=13):
    """The same graph in both packages; the last ``isolated`` nodes have
    no edge but their self-loop."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n - isolated, m)
    dst = rng.integers(0, n - isolated, m)
    # a hub: node 0 hears from half the graph
    src = np.concatenate([src, np.arange(1, n // 2)])
    dst = np.concatenate([dst, np.zeros(n // 2 - 1, np.int64)])
    return (Graph.from_edges(src, dst, n),
            JaxGraph.from_edges(src, dst, n))


def _pair(model, route="fused", dtype=None, seed=0):
    g, jg = graphs()
    both, port_only = ROUTES[model][route]
    jm = JAX_MODELS[model](jg, DIMS, heads=HEADS, dtype=dtype, **both)
    params = jm.init(jax.random.PRNGKey(seed))
    m = MODELS[model](g, DIMS, heads=HEADS, dtype=dtype, device=CPU,
                      **both, **port_only)
    m.load_state_dict(params_from_jax(params))
    x = np.random.default_rng(4).normal(size=(N, F_IN)).astype(np.float32)
    return m, jm, params, x


def _loss(logits):
    return (logits ** 2).sum()


def _jax_grads(jm, params, x):
    return jax.grad(lambda p: _loss(jm.apply(p, x)))(params)


def _assert_grads(m, grads, tol):
    for i, layer in enumerate(grads):
        for k, v in layer.items():
            g = getattr(m.layers[i], k).grad
            got = np.zeros_like(np.asarray(v)) if g is None else g.numpy()
            np.testing.assert_allclose(got, np.asarray(v), rtol=tol,
                                       atol=tol, err_msg=f"layer {i} {k}")


def test_init_shapes_match_jax():
    g = torch.Generator().manual_seed(0)
    for port, jax_init in ((init_gat, JaxGAT(graphs()[1], DIMS, HEADS).init),
                           (init_gatv2,
                            JaxGATv2(graphs()[1], DIMS, HEADS).init)):
        mine, theirs = port(g, DIMS, HEADS), jax_init(jax.random.PRNGKey(0))
        assert [{k: tuple(v.shape) for k, v in layer.items()}
                for layer in mine] == [
            {k: tuple(np.shape(v)) for k, v in layer.items()}
            for layer in theirs]
        assert not mine[-1]["b"].any()


@pytest.mark.parametrize("model,route", CASES)
def test_logits_and_gradients_match_jax(model, route):
    m, jm, params, x = _pair(model, route)
    # the port's route against both of JAX's
    jf = JAX_MODELS[model](graphs()[1], DIMS, heads=HEADS)
    jt = JAX_MODELS[model](graphs()[1], DIMS, heads=HEADS, fused=False)
    y = m(torch.from_numpy(x))
    assert y.shape == (N, DIMS[-1])
    for j in (jf, jt):
        np.testing.assert_allclose(y.detach().numpy(),
                                   np.asarray(j.apply(params, x)),
                                   rtol=TOL, atol=TOL)
    _loss(y).backward()
    _assert_grads(m, _jax_grads(jf, params, x), TOL)


@pytest.mark.parametrize("model,route", [c for c in CASES
                                         if c[1] != "textbook"])
def test_bf16_within_jax_bf16_bounds(model, route):
    m, jm, params, x = _pair(model, route, dtype="bfloat16")
    y = m(torch.from_numpy(x))
    np.testing.assert_allclose(y.detach().numpy(),
                               np.asarray(jm.apply(params, x)),
                               rtol=BF16_FWD, atol=BF16_FWD)
    _loss(y).backward()
    _assert_grads(m, _jax_grads(jm, params, x), BF16_GRAD)


def _labels(x, seed=6):
    rng = np.random.default_rng(seed)
    return (x @ rng.normal(size=(F_IN, DIMS[-1]))).argmax(1).astype(np.int32)


@pytest.mark.parametrize("model,route", CASES)
def test_adam_step_matches_optax(model, route):
    m, jm, params, x = _pair(model, route)
    labels = _labels(x)
    mask = (np.arange(N) % 3 != 0).astype(np.float32)
    opt = optax.adam(1e-2)

    @jax.jit
    def jstep(p, state):
        loss, grads = jax.value_and_grad(lambda q: JT.cross_entropy(
            jm.apply(q, x), jnp.asarray(labels), jnp.asarray(mask)))(p)
        updates, state = opt.update(grads, state, p)
        return optax.apply_updates(p, updates), loss
    new, lj = jstep(params, opt.init(params))
    step = T.make_train_step(m, torch.optim.Adam(m.parameters(), lr=1e-2),
                             x, labels, mask)
    np.testing.assert_allclose(float(step()), float(lj), rtol=1e-5)
    for i, layer in enumerate(new):
        for k, v in layer.items():
            np.testing.assert_allclose(
                getattr(m.layers[i], k).detach().numpy(), np.asarray(v),
                rtol=0, atol=1e-5, err_msg=f"layer {i} {k}")
    if model == "gat":
        # GAT reads b on the last layer only: the hidden ones stay 0
        assert not np.any(np.asarray(new[0]["b"]))
        assert not m.layers[0].b.detach().any()
    assert T.evaluate(m, x, labels, mask) == pytest.approx(
        float(JT.accuracy(jm.apply(new, x), jnp.asarray(labels),
                          jnp.asarray(mask))), abs=1e-9)


@pytest.mark.parametrize("model,route", CASES)
def test_forward_has_no_scatter(model, route):
    m, _, _, x = _pair(model, route)
    names = grad_fn_names(m(torch.from_numpy(x)))
    assert not scatter_nodes(names), names


@pytest.mark.parametrize("model,route", CASES)
def test_two_training_runs_are_bitwise_equal(model, route):
    m, _, _, x = _pair(model, route)
    labels = _labels(x)
    start = {k: v.clone() for k, v in m.state_dict().items()}
    runs = []
    for _ in range(2):
        m.load_state_dict(start)
        step = T.make_train_step(m, torch.optim.Adam(m.parameters(),
                                                     lr=1e-2),
                                 x, labels, np.ones(N, np.float32))
        losses = torch.stack([step() for _ in range(3)])
        runs.append((losses, {k: v.clone()
                              for k, v in m.state_dict().items()}))
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(runs[0][1][k], runs[1][1][k]) for k in start)


def test_models_of_one_graph_share_their_plans():
    g, _ = graphs()
    a = GAT(g, DIMS, heads=HEADS, device=CPU)
    b = GATv2(g, DIMS, heads=HEADS, dtype="bfloat16", device=CPU)
    assert a.graph is b.graph is g.with_self_loops()
    fresh = g.add_self_loops().adj
    assert np.array_equal(a.graph.adj.offsets, fresh.offsets)
    assert np.array_equal(a.graph.adj.indices, fresh.indices)
    assert a.attention.planes is b.attention.planes
    # self-loops on every node, the isolated ones included
    assert np.all(a.graph.adj.row_sizes() >= 1)


def test_training_descends():
    g, _ = graphs(m=160, isolated=0)
    x = np.random.default_rng(7).normal(size=(N, F_IN)).astype(np.float32)
    labels = _labels(x)
    for model in (GAT, GATv2):
        m = model(g, [F_IN, 8, 3], heads=2, device=CPU)
        step = T.make_train_step(m, torch.optim.Adam(m.parameters(),
                                                     lr=2e-2),
                                 x, labels, np.ones(N, np.float32))
        losses = [float(step()) for _ in range(60)]
        assert np.mean(losses[-5:]) < 0.7 * np.mean(losses[:5]), losses
