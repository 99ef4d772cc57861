"""The GCN path of the port (``loops_tpu_torch.models``, ``io.ogb``,
``examples/train_gcn_torch.py``) against ``loops_tpu``'s on the same
numpy inputs, with the JAX GCN's weights carried over by
``params_from_jax`` and dropout 0.

The aggregation-operator cases run K4 on both sides
(``schedule="merge_path", impl="pallas"``): the JAX Pallas kernel in
interpret mode, the port's wrapper in its plain version. The whole-model
cases take both packages' CPU route, ``group_mapped``, which computes the
same function (``tests/test_models.py`` holds it against the flat
kernel).

Tolerances: f32 logits and gradients ``rtol=atol=1e-4``; three Adam
steps: losses within 1e-5 relative, parameters within 1e-4. bf16 logits:
one bf16 ulp at the largest logit, ``2**-7 * max|logits|`` — the port
rounds each aggregation product to bf16 where XLA on the CPU keeps it in
f32 (``test_torch_spmm_bf16.py``), and one flipped rounding of a layer's
input propagates — with argmax equal on at least 99% of the rows.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import loops_tpu.models.train as JT
from loops_tpu.io import ogb as jogb
from loops_tpu.models import GCN as JaxGCN
from loops_tpu.models.graph import Graph as JaxGraph
from loops_tpu.models.message_passing import (
    aggregate_operator as jax_aggregate,
    edge_aggregate as jax_edge_aggregate,
    masked_aggregate_operator as jax_masked,
)
from loops_tpu_torch.io import ogb
from loops_tpu_torch.models import GCN, checkpoint, params_from_jax
from loops_tpu_torch.models.gcn import dropout
from loops_tpu_torch.models import train as T
from loops_tpu_torch.models.graph import Graph
from loops_tpu_torch.models.message_passing import (
    aggregate_operator,
    edge_aggregate,
    mask_rows,
    masked_aggregate_operator,
)

CPU = torch.device("cpu")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIMS = [16, 24, 24, 5]


def _edges(n, m, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, n, m), rng.integers(0, n, m)


def graphs(n=200, m=1200, seed=0):
    src, dst = _edges(n, m, seed)
    return (Graph.from_edges(src, dst, n, make_undirected=True),
            JaxGraph.from_edges(src, dst, n, make_undirected=True))


def dataset():
    """The same synthetic dataset from both packages (300 nodes)."""
    return (ogb.synthetic_powerlaw("t", 300, 6, 16, 5, seed=3),
            jogb.synthetic_powerlaw("t", 300, 6, 16, 5, seed=3))


def _dense(n, f, seed):
    return np.random.default_rng(seed).normal(size=(n, f)).astype(np.float32)


def _same_csr(a, b):
    assert a.shape == b.shape
    for name in ("offsets", "indices", "vals"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))


def test_graph_preprocessing_matches():
    t, j = graphs(seed=1)
    _same_csr(t.adj, j.adj)
    _same_csr(t.add_self_loops().adj, j.add_self_loops().adj)
    _same_csr(t.gcn_normalized().adj, j.gcn_normalized().adj)
    _same_csr(t.mean_normalized().adj, j.mean_normalized().adj)
    np.testing.assert_array_equal(t.in_degrees(), j.in_degrees())
    np.testing.assert_array_equal(t.out_degrees(), j.out_degrees())
    assert (t.num_nodes, t.num_edges) == (j.num_nodes, j.num_edges)


def test_synthetic_datasets_identical():
    td, jd = dataset()
    _same_csr(td.graph.adj, jd.graph.adj)
    for name in ("features", "labels", "train_mask", "val_mask",
                 "test_mask"):
        np.testing.assert_array_equal(getattr(td, name), getattr(jd, name))
    t, j = ogb.load("tiny", scale=0.05), jogb.load("tiny", scale=0.05)
    _same_csr(t.graph.adj, j.graph.adj)
    np.testing.assert_array_equal(t.features, j.features)
    assert t.synthetic and t.num_classes == j.num_classes
    with pytest.raises(FileNotFoundError):
        ogb.load("ogbn-arxiv", allow_synthetic=False)


@pytest.mark.parametrize("op", ["gcn", "mean"])
def test_aggregate_operator_and_gradient_match(op):
    # gcn: symmetric, the backward reuses the forward operator; mean:
    # asymmetric, the backward is K4 over A^T
    t, j = graphs(seed=15)
    X, W = _dense(200, 6, 3), _dense(6, 8, 4)
    jop = jax_aggregate(j, op, schedule="merge_path", impl="pallas")
    top = aggregate_operator(t, op, schedule="merge_path", impl="pallas",
                             device=CPU)
    assert top.impl_used == "flat_spmm"
    assert (top._vjp_op is top) == (op == "gcn")

    def jloss(X):
        return (jop._fn(X @ jnp.asarray(W)) ** 2).sum()
    Xt = torch.from_numpy(X).requires_grad_(True)
    tloss = (top._fn(Xt @ torch.from_numpy(W)) ** 2).sum()
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss(X)),
                               rtol=1e-4)
    np.testing.assert_allclose(Xt.grad.numpy(),
                               np.asarray(jax.grad(jloss)(X)),
                               rtol=1e-4, atol=1e-4)
    assert top.launches == 0  # the CPU runs K4's plain version


def test_masked_aggregate_operator_and_gradient_match():
    t, j = graphs(seed=9)
    mask = (np.random.default_rng(2).random(200) < 0.55).astype(np.float32)
    Z = _dense(200, 7, 5)
    jop = jax_masked(j, mask, schedule="merge_path", impl="pallas")
    top = masked_aggregate_operator(t, mask, schedule="merge_path",
                                    impl="pallas", device=CPU)
    np.testing.assert_array_equal(top.rows, jop.rows)
    dy = _dense(len(top.rows), 7, 6)

    def jloss(Z):
        return (jop._fn(Z) * dy).sum()
    Zt = torch.from_numpy(Z).requires_grad_(True)
    y = top._fn(Zt)
    (y * torch.from_numpy(dy)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jop._fn(Z)),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(Zt.grad.numpy(),
                               np.asarray(jax.grad(jloss)(Z)),
                               rtol=1e-4, atol=1e-4)


def _models(td, jd, dims=DIMS, **kw):
    jm = JaxGCN(jd.graph, dims, dropout=0.0, **kw)
    params = jm.init(jax.random.PRNGKey(0))
    if "loss_rows" in kw:
        kw["loss_rows"] = td.train_mask
    tm = GCN(td.graph, dims, dropout=0.0, **kw, device=CPU)
    tm.load_state_dict(params_from_jax(params))
    return tm, jm, params


FORMS = {
    "plain": {},
    "precompute": dict(precompute_first=True),
    "loss_rows": dict(loss_rows=True),
    "precompute_loss_rows": dict(precompute_first=True, loss_rows=True),
}


def _kw(form, jd):
    kw = dict(FORMS[form])
    if kw.get("loss_rows"):
        kw["loss_rows"] = jd.train_mask
    return kw


@pytest.mark.parametrize("form", sorted(FORMS))
def test_gcn_logits_match_f32(form):
    td, jd = dataset()
    tm, jm, params = _models(td, jd, **_kw(form, jd))
    lj = np.asarray(jm.apply(params, jm.prepare_features(jd.features)))
    lt = tm(tm.prepare_features(td.features)).detach().numpy()
    np.testing.assert_allclose(lt, lj, rtol=1e-4, atol=1e-4)
    if tm.loss_rows is not None:
        mj = np.asarray(jm.apply(params, jm.prepare_features(jd.features),
                                 masked_output=True))
        mt = tm(tm.prepare_features(td.features), masked_output=True)
        np.testing.assert_allclose(mt.detach().numpy(), mj, rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("form", ["plain", "precompute_loss_rows"])
def test_gcn_logits_match_bf16(form):
    td, jd = dataset()
    tm, jm, params = _models(td, jd, dtype="bfloat16", **_kw(form, jd))
    lj = np.asarray(jm.apply(params, jm.prepare_features(jd.features)))
    lt = tm(tm.prepare_features(td.features)).detach().numpy()
    tol = 2.0 ** -7 * np.abs(lj).max()
    assert np.abs(lt - lj).max() <= tol, (np.abs(lt - lj).max(), tol)
    assert (lt.argmax(1) == lj.argmax(1)).mean() >= 0.99


@pytest.mark.parametrize("form", ["plain", "precompute_loss_rows"])
def test_three_adam_steps_match_optax(form):
    td, jd = dataset()
    tm, jm, params = _models(td, jd, **_kw(form, jd))
    opt = optax.adam(1e-2)
    st = opt.init(params)
    step = jax.jit(JT.make_train_step(jm, opt, jd.features, jd.labels,
                                      jd.train_mask))
    tstep = T.make_train_step(tm, torch.optim.Adam(tm.parameters(), lr=1e-2),
                              td.features, td.labels, td.train_mask)
    rng = jax.random.PRNGKey(1)
    for _ in range(3):
        params, st, rng, lj = step(params, st, rng)
        lt = tstep()
        np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
    for i, layer in enumerate(tm.layers):
        for name in ("w", "b"):
            np.testing.assert_allclose(getattr(layer, name).detach().numpy(),
                                       np.asarray(params[i][name]),
                                       atol=1e-4)
    for mask in ("val_mask", "test_mask"):
        assert T.evaluate(tm, td.features, td.labels, getattr(td, mask)) \
            == pytest.approx(JT.evaluate(jm, params, jd.features, jd.labels,
                                         getattr(jd, mask)), abs=1e-9)
    assert tm.training is True  # evaluate restores the mode


def test_train_epochs_and_checkpoint_round_trip(tmp_path):
    td, _ = dataset()

    def fresh():
        m = GCN(td.graph, DIMS, dropout=0.5,
                generator=torch.Generator().manual_seed(0), device=CPU)
        return m, torch.optim.Adam(m.parameters(), lr=1e-2)
    m1, o1 = fresh()
    g1 = torch.Generator().manual_seed(7)
    ep = T.make_train_epochs(m1, o1, td.features, td.labels, td.train_mask,
                             steps_per_call=2, generator=g1)
    ep()
    path = str(tmp_path / "ckpt" / "state.pt")
    checkpoint.save(path, {"model": m1.state_dict(),
                           "optimizer": o1.state_dict(), "step": 2,
                           "generator": g1.get_state()})
    loss_a = ep()
    m2, o2 = fresh()
    state = checkpoint.restore(path)
    m2.load_state_dict(state["model"])
    o2.load_state_dict(state["optimizer"])
    g2 = torch.Generator()
    g2.set_state(state["generator"])
    assert state["step"] == 2
    loss_b = T.make_train_epochs(m2, o2, td.features, td.labels,
                                 td.train_mask, steps_per_call=2,
                                 generator=g2)()
    assert float(loss_a) == float(loss_b)
    for a, b in zip(m1.parameters(), m2.parameters()):
        assert torch.equal(a, b)


def test_dropout_is_seeded_and_keeps_one_minus_p():
    # the draws come from a torch.Generator and cannot match JAX's bits
    # from the same seed; what holds is reproducibility and the rate
    h = torch.ones(400, 250)
    out = dropout(h, 0.3, torch.Generator().manual_seed(3))
    assert torch.equal(out, dropout(h, 0.3, torch.Generator().manual_seed(3)))
    kept = out != 0
    assert abs(kept.float().mean().item() - 0.7) < 0.01
    torch.testing.assert_close(out[kept], torch.full_like(out[kept], 1 / 0.7))
    td, _ = dataset()
    m = GCN(td.graph, DIMS, dropout=0.5, device=CPU)
    x = m.prepare_features(td.features)
    runs = [m(x, generator=torch.Generator().manual_seed(5)) for _ in "ab"]
    assert torch.equal(runs[0], runs[1])
    with pytest.raises(ValueError, match="Generator"):
        m(x)  # train() mode draws, and only from an explicit generator
    m.eval()
    assert torch.equal(m(x), m(x))
    assert not torch.equal(m(x), runs[0])


def test_remat_matches():
    td, jd = dataset()
    tm, _, _ = _models(td, jd)
    rm = GCN(td.graph, DIMS, dropout=0.0, remat=True, device=CPU)
    rm.load_state_dict(tm.state_dict())
    h = tm.prepare_features(td.features)
    grads = []
    for m in (tm, rm):
        m.zero_grad()
        out = m(h)
        (out ** 2).sum().backward()
        grads.append([p.grad.clone() for p in m.parameters()])
    torch.testing.assert_close(rm(h), tm(h), rtol=0, atol=0)
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_single_layer_precompute_masked_output_is_masked():
    # loops_tpu returns the full logits here; the port the loss rows'
    td, _ = dataset()
    m = GCN(td.graph, [16, 5], dropout=0.0, precompute_first=True,
            loss_rows=td.train_mask, device=CPU)
    h = m.prepare_features(td.features)
    full = m(h)
    sub = m(h, masked_output=True)
    rows = np.nonzero(td.train_mask)[0]
    assert tuple(sub.shape) == (len(rows), 5)
    torch.testing.assert_close(sub, full[torch.from_numpy(rows)])


def test_integer_mask_is_a_mask():
    # loops_tpu reads an integer 0/1 mask of length N as the row indices
    # 0 and 1; the port takes its nonzero rows
    t, _ = graphs(n=50, m=200, seed=3)
    mask = (np.arange(50) % 3 == 0).astype(np.int32)
    np.testing.assert_array_equal(mask_rows(mask, 50), np.nonzero(mask)[0])
    op = masked_aggregate_operator(t, mask, device=CPU)
    ref = masked_aggregate_operator(t, mask.astype(bool), device=CPU)
    np.testing.assert_array_equal(op.rows, ref.rows)
    np.testing.assert_array_equal(mask_rows(np.array([4, 9, 2]), 50),
                                  [4, 9, 2])
    for bad in (np.array([0, 50]), np.array([-1]), np.ones(49, bool),
                np.ones((50, 1), np.int32), np.array(["a"])):
        with pytest.raises(ValueError):
            mask_rows(bad, 50)


def test_loss_rows_must_be_the_train_mask():
    td, _ = dataset()
    m = GCN(td.graph, DIMS, dropout=0.0, loss_rows=td.train_mask, device=CPU)
    opt = torch.optim.Adam(m.parameters())
    with pytest.raises(ValueError, match="loss_rows"):
        T.make_train_step(m, opt, td.features, td.labels, td.val_mask)


@pytest.mark.parametrize("op", ["sum", "mean", "max", "min"])
def test_edge_aggregate_matches(op):
    t, j = graphs(n=60, m=150, seed=4)
    h = _dense(60, 5, 8)

    def jfn(m, w):
        return m * w[:, None]

    def tfn(m, w):
        return m * w[:, None]
    for ja, ta in ((None, None), (jfn, tfn)):
        want = np.asarray(jax_edge_aggregate(j, jnp.asarray(h), ja, op))
        got = edge_aggregate(t, torch.from_numpy(h), ta, op).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError):
        edge_aggregate(t, torch.from_numpy(h), op="prod")


def test_example_cli_on_cpu():
    r = subprocess.run(
        [sys.executable, "examples/train_gcn_torch.py", "--dataset", "tiny",
         "--epochs", "4", "--device", "cpu"],
        capture_output=True, text=True, timeout=180, cwd=REPO)
    assert r.returncode == 0, r.stdout + r.stderr
    lines = r.stdout.splitlines()
    assert lines[0].startswith("dataset=tiny (synthetic) nodes=100 ")
    assert sum(ln.startswith("epoch ") and " loss " in ln and " val " in ln
               for ln in lines) >= 2
    assert any(ln.startswith("test_accuracy: ") for ln in lines)
    assert any(ln.startswith("train_time_s: ") and "edges_per_s:" in ln
               for ln in lines)
    assert "impl_used: torch launches: 0" in r.stderr
    r = subprocess.run(
        [sys.executable, "examples/train_gcn_torch.py", "--dataset", "tiny",
         "--model", "sage", "--epochs", "4", "--device", "cpu"],
        capture_output=True, text=True, timeout=180, cwd=REPO)
    assert r.returncode == 0, r.stdout + r.stderr
    assert any(ln.startswith("test_accuracy: ")
               for ln in r.stdout.splitlines()), r.stdout
    assert "impl_used: torch launches: 0" in r.stderr
    r = subprocess.run(
        [sys.executable, "examples/train_gcn_torch.py", "--dataset", "tiny",
         "--model", "gat", "--epochs", "4", "--device", "cpu"],
        capture_output=True, text=True, timeout=180, cwd=REPO)
    assert r.returncode == 0, r.stdout + r.stderr
    assert any(ln.startswith("test_accuracy: ")
               for ln in r.stdout.splitlines()), r.stdout
    assert "impl_used: fused launches: 0" in r.stderr
