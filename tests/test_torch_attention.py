"""The port's fused attention ops (``loops_tpu_torch.ops.attention``)
against ``loops_tpu.ops.attention`` on the same seeded numpy inputs: a
graph with a hub row (150 of 160 columns) and empty rows, one with every
third row empty, and a random one with self-loops.

Tolerances:

- f32 forward within ``rtol=atol=1e-5`` of JAX's op, and within ``1e-4``
  of the per-edge f64 oracle (``reference_attention_aggregate``, as
  ``tests/test_attention.py`` holds JAX's op to it);
- gradients of ``s_src``, ``s_dst`` and ``hw`` (``grad=True``, the
  transposed-plan backward, and ``grad=False``, autograd through the
  forward) within ``rtol=atol=1e-4`` of ``jax.grad`` through JAX's
  custom VJP; GATv2's of ``u``, ``v`` and ``a`` within ``1e-4`` of
  ``jax.grad`` through JAX's op;
- bf16 within JAX's own bf16 bounds of JAX's bf16 op (forward 0.05,
  gradients 0.08: ``tests/test_attention.py:69, 173``). The port keeps
  the score halves and the softmax statistics in f32 where JAX rounds
  them through bf16 (ROADMAP C1): ``test_c1_bf16_scores_stay_f32`` shows
  the size of that departure against the f64 oracle.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loops_tpu.formats import CSR as JaxCSR
from loops_tpu.ops import attention as jatt
from loops_tpu_torch import ops as tops
from loops_tpu_torch.formats import COO
from loops_tpu_torch.ops import attention as tatt
from loops_tpu_torch.utils import generate
from test_torch_cuda_gnn import grad_fn_names, scatter_nodes

CPU = torch.device("cpu")
H, D = 3, 5
TOL = 1e-5
GRAD_TOL = 1e-4
BF16_FWD, BF16_GRAD = 0.05, 0.08


def _with_identity(csr):
    dense = csr.to_dense() + np.eye(csr.shape[0], dtype=np.float32)
    return COO.from_dense(dense).to_csr()


def _hub():
    sizes = [0, 150, 3, 0, 1] + [int(k) for k in np.arange(155) % 9]
    return generate.sized_csr(sizes, len(sizes), seed=3)


GRAPHS = {
    "hub_and_empty_rows": _hub,
    "every_third_row_empty": lambda: generate.empty_row_csr(50, 50, every=3),
    "random_self_loops": lambda: _with_identity(
        generate.random_csr(50, 50, 0.12, seed=2)),
}


def _jax_csr(csr):
    return JaxCSR(csr.shape, csr.offsets, csr.indices, csr.vals)


def _inputs(n, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    s_src = (scale * rng.normal(size=(n, H))).astype(np.float32)
    s_dst = (scale * rng.normal(size=(n, H))).astype(np.float32)
    hw = rng.normal(size=(n, H, D)).astype(np.float32)
    ct = rng.normal(size=(n, H, D)).astype(np.float32)
    return s_src, s_dst, hw, ct


def _port(op, args, ct):
    """The port's output and the gradients of ``<op(*args), ct>``."""
    xs = [torch.from_numpy(a).requires_grad_() for a in args]
    y = op(*xs)
    (y * torch.from_numpy(ct)).sum().backward()
    return y.detach().numpy(), [x.grad.numpy() for x in xs]


def _jax(op, args, ct):
    y = np.asarray(op.apply(*args))
    grads = jax.grad(lambda *a: jnp.vdot(op.apply(*a), ct),
                     argnums=tuple(range(len(args))))(*args)
    return y, [np.asarray(g) for g in grads]


def test_exports():
    assert tops.GroupedAttentionAggregate is tatt.GroupedAttentionAggregate
    assert tops.GroupedAttentionV2 is tatt.GroupedAttentionV2


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_forward_matches_jax(graph):
    csr = GRAPHS[graph]()
    s_src, s_dst, hw, _ = _inputs(csr.shape[0])
    want = np.asarray(jatt.GroupedAttentionAggregate(_jax_csr(csr))(
        s_src, s_dst, hw))
    oracle = tatt.reference_attention_aggregate(csr, s_src, s_dst, hw)
    np.testing.assert_array_equal(oracle, jatt.reference_attention_aggregate(
        _jax_csr(csr), s_src, s_dst, hw))
    for grad in (True, False):
        op = tatt.GroupedAttentionAggregate(csr, grad=grad, device=CPU)
        got = op(*(torch.from_numpy(a) for a in (s_src, s_dst, hw)))
        assert got.shape == (csr.shape[0], H, D)
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got.numpy(), oracle, rtol=1e-4, atol=1e-4)
    empty = csr.row_sizes() == 0
    assert np.all(got.numpy()[empty] == 0)


def test_oracle_on_chosen_rows():
    csr = _hub()
    s_src, s_dst, hw, _ = _inputs(csr.shape[0])
    full = tatt.reference_attention_aggregate(csr, s_src, s_dst, hw)
    rows = [1, 0, 7]
    part = tatt.reference_attention_aggregate(csr, s_src, s_dst, hw,
                                              rows=rows)
    np.testing.assert_array_equal(part[rows], full[rows])
    assert not np.any(np.delete(part, rows, axis=0))


@pytest.mark.parametrize("grad", [True, False], ids=["vjp", "autograd"])
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_gradients_match_jax_custom_vjp(graph, grad):
    csr = GRAPHS[graph]()
    s_src, s_dst, hw, ct = _inputs(csr.shape[0], seed=4)
    want, jgrads = _jax(jatt.GroupedAttentionAggregate(_jax_csr(csr)),
                        (s_src, s_dst, hw), ct)
    got, grads = _port(tatt.GroupedAttentionAggregate(csr, grad=grad,
                                                      device=CPU),
                       (s_src, s_dst, hw), ct)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    for name, a, b in zip(("s_src", "s_dst", "hw"), grads, jgrads):
        np.testing.assert_allclose(a, b, rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("grad", [True, False], ids=["vjp", "autograd"])
def test_bf16_within_jax_bf16_bounds(grad):
    csr = _with_identity(generate.random_csr(40, 40, 0.15, seed=12))
    s_src, s_dst, hw, ct = _inputs(40, seed=3)
    want, jgrads = _jax(jatt.GroupedAttentionAggregate(
        _jax_csr(csr), dtype="bfloat16"), (s_src, s_dst, hw), ct)
    got, grads = _port(tatt.GroupedAttentionAggregate(
        csr, dtype="bfloat16", grad=grad, device=CPU), (s_src, s_dst, hw), ct)
    np.testing.assert_allclose(got, want, rtol=BF16_FWD, atol=BF16_FWD)
    for name, a, b in zip(("s_src", "s_dst", "hw"), grads, jgrads):
        np.testing.assert_allclose(a, b, rtol=BF16_GRAD, atol=BF16_GRAD,
                                   err_msg=name)
    # the mode rounds: f32 gives other values
    f32, _ = _port(tatt.GroupedAttentionAggregate(csr, device=CPU),
                   (s_src, s_dst, hw), ct)
    assert not np.array_equal(f32, got)


def test_c1_bf16_scores_stay_f32():
    # logits scaled by 8: a bf16 rounding of the score halves moves each
    # exp by up to 8 |s| 2**-8; the port keeps them in f32
    csr = _with_identity(generate.random_csr(40, 40, 0.15, seed=12))
    s_src, s_dst, hw, ct = _inputs(40, seed=3, scale=8.0)
    oracle = tatt.reference_attention_aggregate(csr, s_src, s_dst, hw)
    jop = jatt.GroupedAttentionAggregate(_jax_csr(csr), dtype="bfloat16")
    j_out, j_grads = _jax(jop, (s_src, s_dst, hw), ct)
    t_out, t_grads = _port(tatt.GroupedAttentionAggregate(
        csr, dtype="bfloat16", device=CPU), (s_src, s_dst, hw), ct)
    _, ref_grads = _jax(jatt.GroupedAttentionAggregate(_jax_csr(csr)),
                        (s_src, s_dst, hw), ct)
    j_err = float(np.abs(j_out - oracle).max())
    t_err = float(np.abs(t_out - oracle).max())
    j_gerr = [float(np.abs(a - b).max()) for a, b in zip(j_grads, ref_grads)]
    t_gerr = [float(np.abs(a - b).max()) for a, b in zip(t_grads, ref_grads)]
    print(f"bf16, logits x8: max |out - f64 oracle| JAX {j_err:.4g}, port "
          f"{t_err:.4g}; max |grad - f32 grad| (s_src, s_dst, hw) JAX "
          f"{[round(e, 4) for e in j_gerr]}, port "
          f"{[round(e, 4) for e in t_gerr]}")
    assert t_err <= j_err
    assert t_err <= BF16_FWD and max(t_gerr) <= BF16_GRAD


def _v2_inputs(n, seed=5):
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(n, H, D)).astype(np.float32)
    v = rng.normal(size=(n, H, D)).astype(np.float32)
    a = rng.normal(size=(H, D)).astype(np.float32)
    ct = rng.normal(size=(n, H, D)).astype(np.float32)
    return u, v, a, ct


def _v2_port(op, u, v, a, ct):
    xs = [torch.from_numpy(x).requires_grad_() for x in (u, v, a)]
    y = op(xs[0], xs[1], xs[2], xs[0])
    (y * torch.from_numpy(ct)).sum().backward()
    return y.detach().numpy(), [x.grad.numpy() for x in xs]


def _v2_jax(op, u, v, a, ct):
    y = np.asarray(op.apply(u, v, a, u))
    grads = jax.grad(lambda u, v, a: jnp.vdot(op.apply(u, v, a, u), ct),
                     argnums=(0, 1, 2))(u, v, a)
    return y, [np.asarray(g) for g in grads]


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_v2_matches_jax(graph):
    csr = GRAPHS[graph]()
    u, v, a, ct = _v2_inputs(csr.shape[0])
    want, jgrads = _v2_jax(jatt.GroupedAttentionV2(_jax_csr(csr)),
                           u, v, a, ct)
    got, grads = _v2_port(tatt.GroupedAttentionV2(csr, device=CPU),
                          u, v, a, ct)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    for name, x, y in zip(("u", "v", "a"), grads, jgrads):
        np.testing.assert_allclose(x, y, rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=name)
    # vals given apart from u: the same values
    op = tatt.GroupedAttentionV2(csr, device=CPU)
    ut = torch.from_numpy(u)
    np.testing.assert_array_equal(
        op(ut, torch.from_numpy(v), torch.from_numpy(a), ut.clone()).numpy(),
        got)


def test_v2_bf16_within_jax_bf16_bounds():
    csr = _with_identity(generate.random_csr(40, 40, 0.15, seed=12))
    u, v, a, ct = _v2_inputs(40)
    want, jgrads = _v2_jax(jatt.GroupedAttentionV2(_jax_csr(csr),
                                                   dtype="bfloat16"),
                           u, v, a, ct)
    got, grads = _v2_port(tatt.GroupedAttentionV2(csr, dtype="bfloat16",
                                                  device=CPU), u, v, a, ct)
    np.testing.assert_allclose(got, want, rtol=BF16_FWD, atol=BF16_FWD)
    for name, x, y in zip(("u", "v", "a"), grads, jgrads):
        np.testing.assert_allclose(x, y, rtol=BF16_GRAD, atol=BF16_GRAD,
                                   err_msg=name)


CASES = {
    "vjp": lambda csr: tatt.GroupedAttentionAggregate(csr, device=CPU),
    "autograd": lambda csr: tatt.GroupedAttentionAggregate(csr, grad=False,
                                                           device=CPU),
    "v2": lambda csr: tatt.GroupedAttentionV2(csr, device=CPU),
    "v2_bf16": lambda csr: tatt.GroupedAttentionV2(csr, dtype="bfloat16",
                                                   device=CPU),
}


def _run(case, csr, seed=6):
    op = CASES[case](csr)
    n = csr.shape[0]
    if case.startswith("v2"):
        u, v, a, ct = _v2_inputs(n, seed)
        xs = [torch.from_numpy(x).requires_grad_() for x in (u, v, a)]
        y = op(xs[0], xs[1], xs[2], xs[0])
    else:
        s_src, s_dst, hw, ct = _inputs(n, seed)
        xs = [torch.from_numpy(x).requires_grad_() for x in (s_src, s_dst,
                                                              hw)]
        y = op(*xs)
    return y, xs, ct


@pytest.mark.parametrize("case", sorted(CASES))
def test_backward_has_no_scatter(case):
    y, _, _ = _run(case, _hub())
    names = grad_fn_names(y)
    assert not scatter_nodes(names), names
    assert "_SegmentGatherBackward" in names or case == "vjp", names


@pytest.mark.parametrize("case", sorted(CASES))
def test_two_runs_are_bitwise_equal(case):
    runs = []
    for _ in range(2):
        y, xs, ct = _run(case, _hub())
        (y * torch.from_numpy(ct)).sum().backward()
        runs.append([y.detach()] + [x.grad for x in xs])
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_leaky_relu_slope_test_at_zero():
    x = torch.tensor([-2.0, 0.0, 3.0], requires_grad=True)
    y = tatt.leaky_relu(x, 0.2)
    y.sum().backward()
    np.testing.assert_array_equal(y.detach().numpy(),
                                  np.float32([-0.4, 0.0, 3.0]))
    # 1 at 0, as jax.nn.leaky_relu's gradient
    np.testing.assert_array_equal(x.grad.numpy(), np.float32([0.2, 1, 1]))
    jg = jax.grad(lambda v: jax.nn.leaky_relu(v, 0.2).sum())(
        jnp.array([-2.0, 0.0, 3.0]))
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(jg))


def test_plans_staged_once_and_transposed_map():
    csr = _hub()
    a = tatt.GroupedAttentionAggregate(csr, device=CPU)
    b = tatt.GroupedAttentionAggregate(csr, grad=False, device=CPU)
    c = tatt.GroupedAttentionV2(csr, device=CPU)
    assert a.planes is b.planes is c.planes
    assert b.transposed is None
    # every edge's forward slot maps to a distinct transposed slot; padded
    # forward slots to the zero row after them
    fmap = a.transposed.fwd_map.numpy()
    valid = np.concatenate([bk["valid"].reshape(-1)
                            for bk in a.planes.plan.buckets])
    total = sum(a.transposed.planes.slots)
    assert len(np.unique(fmap[valid])) == csr.nnz
    assert np.all(fmap[valid] < total) and np.all(fmap[~valid] == total)
    # rows of every bucket, once
    tiles = a.planes.tiles.numpy()
    np.testing.assert_array_equal(np.sort(tiles),
                                  np.flatnonzero(csr.row_sizes()))


def test_refusals():
    csr = _hub()
    with pytest.raises(ValueError, match="dtype"):
        tatt.GroupedAttentionAggregate(csr, dtype="float16", device=CPU)
    empty = generate.sized_csr([0, 0, 0], 3)
    with pytest.raises(ValueError, match="no nonzeros"):
        tatt.GroupedAttentionV2(empty, device=CPU)
