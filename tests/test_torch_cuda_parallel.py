"""The multi-device tier on the card, as one NCCL rank: each exchange's
distributed SpMM (all-gather, halo with and without overlap, the 1 x 1
hierarchical mesh) against ``SpMMOperator`` with K4 on the same graph,
forward and backward, and DistGCN against the single-device GCN, logits
and train steps. K4 must launch.

Every test here needs an NVIDIA card and skips without one. The file
imports neither JAX nor ``loops_tpu``; run it on the card with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_parallel.py

Tolerances: at one rank each local CSR holds the graph's rows, columns
and values in its own column space and K4 plans them alike, so the
forward equals ``SpMMOperator``'s bit for bit (with the overlap the
boundary is empty, and its reduction is skipped); the gradient ``rtol=1e-5, atol=1e-6``
(the single-device operator's backward reuses the forward plan of a
symmetric matrix). DistGCN: logits within ``1e-4 * max(|logit|, 1)``
(``chip_smoke.py`` phase 8's rule), three Adam steps' losses within
1e-3 relative.
"""
import numpy as np
import pytest
import torch

from loops_tpu_torch.models import GCN
from loops_tpu_torch.models import train as T
from loops_tpu_torch.models.graph import Graph
from loops_tpu_torch.ops.kernels import _build
from loops_tpu_torch.ops.spmm import SpMMOperator
from loops_tpu_torch.parallel import DistGCN, EdgePartition, launch, workers

PROTOCOLS = {"all_gather": "flat", "halo": "flat", "halo_overlap": "flat",
             "hier": ("hier", 1, 1)}


def _graph(n=3000, seed=1):
    rng = np.random.default_rng(seed)
    m = 6 * n
    return Graph.from_edges(rng.integers(0, n, m), rng.integers(0, n, m), n,
                            make_undirected=True)


@pytest.fixture(scope="module")
def nccl_rank():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    with launch.single_rank("nccl"):
        yield torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("protocol", sorted(PROTOCOLS))
def test_dist_spmm_matches_spmm_operator(nccl_rank, protocol):
    adj = _graph().gcn_normalized().adj
    part = EdgePartition.build(adj, 1)
    mesh = workers.mesh_for(PROTOCOLS[protocol], "cuda")
    op = workers._exchange_op(part, mesh, protocol)
    X = np.random.default_rng(2).normal(size=(adj.shape[0], 64)).astype(
        np.float32)
    h = torch.from_numpy(part.local_features(X, 0)).to(
        nccl_rank).requires_grad_(True)
    before = _build.LAUNCHES["flat_spmm"]
    out = op(h)
    (out ** 2).sum().backward()
    assert _build.LAUNCHES["flat_spmm"] > before
    ref_op = SpMMOperator(adj, "merge_path", "pallas", device=nccl_rank)
    xr = torch.from_numpy(X).to(nccl_rank).requires_grad_(True)
    from loops_tpu_torch.models.message_passing import propagate_operator
    ref = propagate_operator(adj, "merge_path", "pallas", device=nccl_rank)
    want = ref._fn(xr)
    (want ** 2).sum().backward()
    n = adj.shape[0]
    torch.testing.assert_close(out[:n], ref_op(X), rtol=0, atol=0)
    torch.testing.assert_close(out[:n], want, rtol=0, atol=0)
    torch.testing.assert_close(h.grad[:n], xr.grad, rtol=1e-5, atol=1e-6)
    assert bool((out[n:] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("exchange", ["halo", "all_gather", "hier"])
def test_dist_gcn_matches_gcn(nccl_rank, exchange):
    g = _graph(2000, 3)
    rng = np.random.default_rng(4)
    X = rng.normal(size=(2000, 32)).astype(np.float32)
    y = rng.integers(0, 5, 2000).astype(np.int32)
    mask = (rng.random(2000) < 0.5).astype(np.float32)
    dims = [32, 64, 5]
    mesh = workers.mesh_for("flat" if exchange != "hier" else ("hier", 1, 1),
                            "cuda")
    dist = DistGCN(g, dims, mesh, exchange=exchange)
    single = GCN(g, dims, dropout=0.0, device=nccl_rank)
    single.load_state_dict(dist.state_dict())
    with torch.no_grad():
        got = dist(dist.local_features(X))[:2000].cpu().numpy()
        want = single(single.prepare_features(X)).cpu().numpy()
    scale = max(float(np.abs(want).max()), 1.0)
    assert float(np.abs(got - want).max()) <= 1e-4 * scale
    before = dist.launches()
    step = dist.make_train_step(torch.optim.Adam(dist.parameters(), lr=1e-2),
                                X, y, mask)
    sstep = T.make_train_step(single, torch.optim.Adam(single.parameters(),
                                                       lr=1e-2), X, y, mask)
    for _ in range(3):
        a, b = float(step()), float(sstep())
        assert abs(a - b) <= 1e-3 * abs(b), (a, b)
    assert dist.launches() > before
