"""The port's segment ops (``loops_tpu_torch.ops.segment``) against
``loops_tpu.ops.segment`` (``jax.ops.segment_*``) on the same seeded numpy
inputs: the four ops, sorted and unsorted ids, 1-D and [E, H] data, with
empty segments between the ids and past the last one.

Tolerances: values ``rtol=atol=1e-6``; gradients against ``jax.grad``
``rtol=atol=1e-5``, on data with no ties. Where entries tie for a
segment's max, both packages split the max's gradient equally between
them (``test_segment_max_splits_ties_equally``, exact).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loops_tpu.ops import segment as jseg
from loops_tpu_torch import ops as tops
from loops_tpu_torch.ops import segment as tseg

RTOL = ATOL = 1e-6
GRAD_TOL = 1e-5
OPS = ("sum", "max", "mean", "softmax")
N_SEG = 12
EMPTY = [3, 7, 10, 11]
SHAPES = {"1d": (), "EH": (3,)}


def _case(shape, sorted_ids, seed=0, E=40):
    """Data with no ties and ids over ``N_SEG`` segments, of which 3, 7,
    10 and 11 are empty."""
    rng = np.random.default_rng(seed)
    live = np.array([s for s in range(N_SEG) if s not in EMPTY])
    ids = rng.choice(live, size=E)
    ids[:len(live)] = live
    if sorted_ids:
        ids = np.sort(ids)
    data = rng.permutation(E * int(np.prod(shape, dtype=int))).reshape(
        (E,) + shape).astype(np.float32) / 7.0
    data += rng.normal(scale=1e-3, size=data.shape).astype(np.float32)
    return data, ids.astype(np.int32)


def _jax(op, data, ids, sorted_ids):
    fn = getattr(jseg, f"segment_{op}")
    return fn(jnp.asarray(data), jnp.asarray(ids), N_SEG,
              sorted_ids=sorted_ids)


def _torch(op, data, ids, sorted_ids):
    if not isinstance(data, torch.Tensor):
        data = torch.from_numpy(data)
    return getattr(tseg, f"segment_{op}")(data, torch.from_numpy(ids),
                                          N_SEG, sorted_ids=sorted_ids)


def _finite(a):
    """The max of an empty segment is -inf in both packages: such rows
    are compared by value, and left out of a gradient's cotangent."""
    return np.isfinite(np.asarray(a))


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("sorted_ids", [True, False])
@pytest.mark.parametrize("op", OPS)
def test_segment_op_matches_jax(op, sorted_ids, shape):
    data, ids = _case(SHAPES[shape], sorted_ids)
    want = np.asarray(_jax(op, data, ids, sorted_ids))
    got = _torch(op, data, ids, sorted_ids).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    if op in ("sum", "mean"):
        assert np.all(got[EMPTY] == 0)
    if op == "max":
        assert np.all(got[EMPTY] == -np.inf)
        assert np.all(np.isfinite(np.delete(got, EMPTY, axis=0)))


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("sorted_ids", [True, False])
@pytest.mark.parametrize("op", OPS)
def test_segment_op_gradient_matches_jax(op, sorted_ids, shape):
    data, ids = _case(SHAPES[shape], sorted_ids, seed=1)
    rows = len(data) if op == "softmax" else N_SEG
    ct = np.random.default_rng(2).normal(
        size=(rows,) + SHAPES[shape]).astype(np.float32)
    live = _finite(_jax(op, data, ids, sorted_ids))
    ct = np.where(live, ct, 0).astype(np.float32)
    want = np.asarray(jax.grad(lambda d: jnp.sum(jnp.where(
        live, _jax(op, d, ids, sorted_ids), 0) * ct))(jnp.asarray(data)))
    x = torch.from_numpy(data).requires_grad_()
    y = _torch(op, x, ids, sorted_ids)
    (torch.where(torch.from_numpy(live), y, 0) * torch.from_numpy(ct)
     ).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), want, rtol=GRAD_TOL,
                               atol=GRAD_TOL)


@pytest.mark.parametrize("sorted_ids", [True, False])
def test_segment_max_splits_ties_equally(sorted_ids):
    # segment 0 ties twice, segment 2 three times, segment 1 once
    data = np.array([[1, 3, 3, 2, 5, 5, 5]], np.float32).T.copy()
    ids = np.array([0, 0, 0, 1, 2, 2, 2], np.int32)
    if not sorted_ids:
        order = np.random.default_rng(3).permutation(len(ids))
        data, ids = data[order], ids[order]
    want = np.asarray(jax.grad(lambda d: jseg.segment_max(
        d, jnp.asarray(ids), 4, sorted_ids=sorted_ids)[:3].sum())(
            jnp.asarray(data)))
    x = torch.from_numpy(data).requires_grad_()
    tseg.segment_max(x, torch.from_numpy(ids), 4,
                     sorted_ids=sorted_ids)[:3].sum().backward()
    got = x.grad.numpy()
    np.testing.assert_array_equal(got, want)
    share = {3: 0.5, 2: 1.0, 5: np.float32(1) / 3, 1: 0.0}
    np.testing.assert_array_equal(
        got[:, 0], np.array([share[v] for v in data[:, 0]], np.float32))


@pytest.mark.parametrize("op", OPS)
def test_unsorted_ids_equal_sorted_ones(op):
    # a stable sort first: bit for bit the same as the ids given in order
    data, ids = _case((2,), False, seed=3)
    order = np.argsort(ids, kind="stable")
    a = _torch(op, data, ids, False)
    b = _torch(op, data[order], ids[order], True)
    if op == "softmax":
        a = a[torch.from_numpy(order)]
    assert torch.equal(a, b)


def _grad_fns(t):
    """The names of every node of ``t``'s autograd graph."""
    seen, todo = set(), [t.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        todo.extend(f for f, _ in fn.next_functions)
    return {type(fn).__name__ for fn in seen}


@pytest.mark.parametrize("sorted_ids", [True, False])
@pytest.mark.parametrize("op", OPS)
def test_backward_has_no_scatter(op, sorted_ids):
    # autograd's own backward of a gather (index, index_select) is a
    # scatter-add, atomic on the card: none may appear in the graph
    data, ids = _case((3,), sorted_ids, seed=4)
    x = torch.from_numpy(data).requires_grad_()
    names = _grad_fns(_torch(op, x, ids, sorted_ids))
    assert not [n for n in names if n.startswith(("Index", "Gather",
                                                   "Scatter", "Put"))], names


def test_empty_data():
    ids = np.zeros(0, np.int32)
    for op in OPS:
        got = _torch(op, np.zeros((0, 2), np.float32), ids, False)
        want = np.asarray(_jax(op, np.zeros((0, 2), np.float32), ids, False))
        np.testing.assert_array_equal(got.numpy(), want)


BAD_IDS = {
    "past_num_segments": (np.array([0, 1, N_SEG]), "num_segments"),
    "negative": (np.array([0, -1, 2]), "negative"),
    "shape": (np.array([0, 1]), "shape"),
}


@pytest.mark.parametrize("case", sorted(BAD_IDS))
def test_bad_ids_raise(case):
    ids, match = BAD_IDS[case]
    with pytest.raises(ValueError, match=match):
        tseg.segment_sum(torch.zeros(3), torch.from_numpy(ids), N_SEG)


def test_ops_exports_the_segment_ops():
    for op in OPS:
        assert getattr(tops, f"segment_{op}") is getattr(tseg,
                                                         f"segment_{op}")
