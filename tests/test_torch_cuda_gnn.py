"""The segment ops, neighbour sampling, GraphSAGE (full graph on both
routes, and the sampled minibatch), GAT (fused with the transposed-plan
backward, fused through autograd, textbook) and GATv2 (fused, textbook)
on the card: two runs bitwise equal, forward and backward (no float
atomics on these paths), no scatter node in GAT's and GATv2's autograd
graphs, K4's counters rising on SAGE's ``merge_path``/``pallas`` route,
sampled ids that are CSR neighbours, the device refusals, and the card
against the CPU at a small size.

Every test here needs an NVIDIA card and skips without one. The file
imports neither JAX nor ``loops_tpu``; run it on the card with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_gnn.py

Card against CPU: segment ops ``rtol=atol=1e-6`` (values) and ``1e-5``
(gradients), logits ``rtol=atol=1e-4``, parameter gradients
``rtol=atol=1e-3`` (the card's matmuls and reductions sum in other
orders); GAT and GATv2 in bf16 one bf16 ulp (2**-7) of the largest
logit and of each parameter's largest gradient entry (``h W`` can round
to the neighbouring bf16 value).
"""
import numpy as np
import pytest
import torch

from loops_tpu_torch.io import ogb
from loops_tpu_torch.models import (
    GAT,
    GATv2,
    GraphSAGE,
    make_sampled_train_step,
    sample_neighbors,
)
from loops_tpu_torch.models import train as T
from loops_tpu_torch.models.sampling import neighbors_from_draws
from loops_tpu_torch.ops import segment

CPU = torch.device("cpu")
DIMS = [32, 16, 16, 8]
OPS = ("sum", "max", "mean", "softmax")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _data():
    return ogb.synthetic_powerlaw("t", 3000, 8, 32, 8, seed=1)


def _segment_case(E=20000, H=8, n=600, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 500, E)          # segments 500..599 empty
    data = rng.normal(size=(E, H)).astype(np.float32)
    ct = rng.normal(size=(E, H)).astype(np.float32)
    return data, ids, ct, n


def _segment_run(op, data, ids, ct, n, device, sorted_ids):
    x = torch.from_numpy(data).to(device).requires_grad_()
    y = getattr(segment, f"segment_{op}")(
        x, torch.from_numpy(ids).to(device), n, sorted_ids=sorted_ids)
    rows = y.shape[0]
    w = torch.from_numpy(ct[:rows]).to(device)
    (torch.where(torch.isfinite(y), y, 0) * w).sum().backward()
    return y.detach(), x.grad


@pytest.mark.cuda
@pytest.mark.parametrize("sorted_ids", [True, False])
@pytest.mark.parametrize("op", OPS)
def test_segment_ops_on_the_card(cuda_device, op, sorted_ids):
    data, ids, ct, n = _segment_case()
    if sorted_ids:
        ids = np.sort(ids)
    card = [_segment_run(op, data, ids, ct, n, cuda_device, sorted_ids)
            for _ in range(2)]
    host = _segment_run(op, data, ids, ct, n, CPU, sorted_ids)
    assert torch.equal(card[0][0], card[1][0])
    assert torch.equal(card[0][1], card[1][1])
    np.testing.assert_allclose(card[0][0].cpu().numpy(), host[0].numpy(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(card[0][1].cpu().numpy(), host[1].numpy(),
                               rtol=1e-5, atol=1e-5)


MODELS = {
    # the planes, named (schedule="auto" follows the card's fitted route)
    "sage": lambda ds, dev: GraphSAGE(ds.graph, DIMS, schedule="group_mapped",
                                      device=dev),
    "sage_bf16": lambda ds, dev: GraphSAGE(ds.graph, DIMS, dtype="bfloat16",
                                           schedule="group_mapped",
                                           device=dev),
    "sage_k4": lambda ds, dev: GraphSAGE(ds.graph, DIMS,
                                         schedule="merge_path",
                                         impl="pallas", device=dev),
    "sage_k4_bf16": lambda ds, dev: GraphSAGE(
        ds.graph, DIMS, schedule="merge_path", impl="pallas",
        dtype="bfloat16", device=dev),
}


def _grads(model, x):
    model.zero_grad(set_to_none=True)
    y = model(x)
    (y ** 2).mean().backward()
    # GAT's hidden layers' b is never read: it gets no gradient
    return y.detach(), {k: p.grad.detach().clone()
                        for k, p in model.named_parameters()
                        if p.grad is not None}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(MODELS))
def test_sage_backward_repeats_bitwise(cuda_device, name):
    ds = _data()
    model = MODELS[name](ds, cuda_device)
    x = torch.from_numpy(ds.features).to(cuda_device)
    y1, g1 = _grads(model, x)
    y2, g2 = _grads(model, x)
    assert torch.equal(y1, y2)
    assert g1.keys() == g2.keys() and len(g1) == 3 * (len(DIMS) - 1)
    for k in g1:
        assert torch.equal(g1[k], g2[k]), k
    fwd, bwd = model.operators()
    if name.startswith("sage_k4"):
        # the mean-normalized Aᵀ is not A: a second K4 operator
        assert fwd.impl_used == bwd.impl_used == "flat_spmm"
        assert fwd.launches == 2 * (len(DIMS) - 1)
        assert bwd.launches == 2 * (len(DIMS) - 2)
    else:
        assert fwd.impl_used == bwd.impl_used == "torch"


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(MODELS))
def test_sage_card_matches_cpu(cuda_device, name):
    ds = _data()
    card = MODELS[name](ds, cuda_device)
    host = MODELS[name](ds, CPU)
    host.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    yc, gc = _grads(card, torch.from_numpy(ds.features).to(cuda_device))
    yh, gh = _grads(host, torch.from_numpy(ds.features))
    assert gc.keys() == gh.keys()
    np.testing.assert_allclose(yc.cpu().numpy(), yh.numpy(), rtol=1e-4,
                               atol=1e-4)
    for k in gh:
        np.testing.assert_allclose(gc[k].cpu().numpy(), gh[k].numpy(),
                                   rtol=1e-3, atol=1e-3, err_msg=k)


def _neighbour_ok(graph, parents, children):
    off, ind = graph.adj.offsets, graph.adj.indices
    for s, t in zip(parents, children):
        row = ind[off[s]:off[s + 1]]
        if not ((t in row) if len(row) else t == s):
            return False
    return True


@pytest.mark.cuda
def test_sampled_sage_repeats_and_samples_neighbours(cuda_device):
    ds = _data()
    model = GraphSAGE(ds.graph, DIMS, device=cuda_device)
    fanouts = [5, 4, 3]
    start = {k: v.clone() for k, v in model.state_dict().items()}
    runs = []
    for _ in range(2):
        model.load_state_dict(start)
        step = make_sampled_train_step(
            model, torch.optim.Adam(model.parameters(), lr=1e-2),
            ds.features, ds.labels, fanouts, 64,
            generator=torch.Generator(cuda_device).manual_seed(3))
        losses = torch.stack([step() for _ in range(3)])
        runs.append((losses, {k: v.clone()
                              for k, v in model.state_dict().items()}))
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(runs[0][1][k], runs[1][1][k]) for k in start)
    fr = [f.cpu().numpy() for f in step.frontiers]
    assert all(f.device.type == "cuda" for f in step.frontiers)
    for d, k in enumerate(fanouts):
        assert _neighbour_ok(ds.graph, np.repeat(fr[d], k), fr[d + 1])
    assert 0.0 <= T.evaluate(model, ds.features, ds.labels,
                             ds.test_mask) <= 1.0


@pytest.mark.cuda
def test_sampling_on_the_card_maps_as_on_the_cpu(cuda_device):
    ds = _data()
    n = ds.graph.num_nodes
    # the last node and nodes of every degree, including isolated ones
    seeds = np.concatenate([np.arange(0, n, 7), [n - 1]])
    r = np.random.default_rng(5).integers(0, 1 << 30, (len(seeds), 6))
    card = neighbors_from_draws(ds.graph, torch.from_numpy(seeds).to(
        cuda_device), torch.from_numpy(r).to(cuda_device))
    host = neighbors_from_draws(ds.graph, seeds, r)
    assert torch.equal(card.cpu(), host)
    ids = sample_neighbors(ds.graph, torch.from_numpy(seeds).to(cuda_device),
                           6, torch.Generator(cuda_device).manual_seed(1),
                           device=cuda_device)
    assert ids.device.type == "cuda"
    assert _neighbour_ok(ds.graph, np.repeat(seeds, 6),
                         ids.cpu().numpy().reshape(-1))
    # a CPU generator for a card sample, and host-resident seed tensors
    with pytest.raises(ValueError, match="sampling moves nothing"):
        sample_neighbors(ds.graph, seeds, 2, torch.Generator(),
                         device=cuda_device)
    with pytest.raises(ValueError, match="sampling moves nothing"):
        sample_neighbors(ds.graph, torch.from_numpy(seeds), 2,
                         torch.Generator(cuda_device), device=cuda_device)


GAT_DIMS = [32, 16, 8]
ATTENTION = {
    "gat": lambda ds, dev: GAT(ds.graph, GAT_DIMS, device=dev),
    "gat_autograd": lambda ds, dev: GAT(ds.graph, GAT_DIMS, vjp=False,
                                        device=dev),
    "gat_textbook": lambda ds, dev: GAT(ds.graph, GAT_DIMS, fused=False,
                                        device=dev),
    "gat_bf16": lambda ds, dev: GAT(ds.graph, GAT_DIMS, dtype="bfloat16",
                                    device=dev),
    "gatv2": lambda ds, dev: GATv2(ds.graph, GAT_DIMS, device=dev),
    "gatv2_textbook": lambda ds, dev: GATv2(ds.graph, GAT_DIMS, fused=False,
                                            device=dev),
    "gatv2_bf16": lambda ds, dev: GATv2(ds.graph, GAT_DIMS,
                                        dtype="bfloat16", device=dev),
}


def grad_fn_names(t):
    """The names of every node of ``t``'s autograd graph."""
    seen, todo = set(), [t.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        todo.extend(f for f, _ in fn.next_functions)
    return {type(fn).__name__ for fn in seen}


def scatter_nodes(names):
    """Nodes whose backward is a scatter (``index_put_``, ``index_add_``,
    ``scatter_add_``: atomic on the card) or that index a tensor."""
    return [n for n in names
            if n.startswith(("Index", "Gather", "Scatter", "Put"))]


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(ATTENTION))
def test_attention_backward_repeats_bitwise(cuda_device, name):
    ds = _data()
    model = ATTENTION[name](ds, cuda_device)
    x = torch.from_numpy(ds.features).to(cuda_device)
    y1, g1 = _grads(model, x)
    y2, g2 = _grads(model, x)
    assert torch.equal(y1, y2)
    for k in g1:
        assert torch.equal(g1[k], g2[k]), k
    names = grad_fn_names(model(x))
    assert not scatter_nodes(names), names


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(ATTENTION))
def test_attention_card_matches_cpu(cuda_device, name):
    ds = _data()
    card = ATTENTION[name](ds, cuda_device)
    host = ATTENTION[name](ds, CPU)
    host.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    yc, gc = _grads(card, torch.from_numpy(ds.features).to(cuda_device))
    yh, gh = _grads(host, torch.from_numpy(ds.features))
    assert gc.keys() == gh.keys()
    if name.endswith("bf16"):
        # h W is summed in another order on the card and can round to
        # the neighbouring bf16 value before the attention reads it: one
        # bf16 ulp of the largest entry
        for a, b in [(yc, yh)] + [(gc[k], gh[k]) for k in gh]:
            tol = 2.0 ** -7 * float(b.abs().max())
            assert float((a.cpu() - b).abs().max()) <= tol
        return
    np.testing.assert_allclose(yc.cpu().numpy(), yh.numpy(), rtol=1e-4,
                               atol=1e-4)
    for k in gh:
        np.testing.assert_allclose(gc[k].cpu().numpy(), gh[k].numpy(),
                                   rtol=1e-3, atol=1e-3, err_msg=k)
