"""Kernel K4 (``flat_spmm``, ``loops_tpu_torch/csrc/spmm.cu``) on the card:
against its plain PyTorch version on the same staged buffers, forward and
over Aᵀ (the aggregation's gradient), two applies bitwise equal, the
launch counter, the wrapper's input checks, an empty matrix without a
launch, and the float64 refusal.

Every test here needs an NVIDIA card and skips without one. The file
imports neither JAX nor ``loops_tpu``; run it on the card with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_spmm.py

K4 against its plain version: bit for bit. The kernel sums each run of a
row inside one warp's atom range in storage order, the runs of a block in
warp order and the blocks in block order, as the plain version's three
segment sums do, without FMA contraction. Each result must also pass the
Wilkinson validator: the f32 bound for f32, the bound over the
bf16-rounded products for bf16. Against the CPU torch path (the backward
test) the tolerance is ``rtol=1e-5, atol=1e-6``.
"""
import numpy as np
import pytest
import torch

from loops_tpu_torch.formats import CSR
from loops_tpu_torch.layout import CsrLayout
from loops_tpu_torch.models import GCN, train
from loops_tpu_torch.models.graph import Graph
from loops_tpu_torch.models.message_passing import (
    aggregate_operator,
    masked_aggregate_operator,
)
from loops_tpu_torch.ops.kernels import _build, spmm_flat
from loops_tpu_torch.ops.spmm import SpMMOperator
from loops_tpu_torch.ops.spmv import SpMVOperator
from loops_tpu_torch.schedule.plans import make_plan
from loops_tpu_torch.utils import generate, reference

RTOL, ATOL = 1e-5, 1e-6

BATTERY = {
    **generate.BATTERY,
    "long_rows": lambda: generate.skewed_csr(30, 3000, heavy_rows=2,
                                             heavy_nnz=2500, seed=4),
    # one row over several warps and blocks, a run of empty rows past a
    # block's work, empty rows at the end (at blocks 8, 64 and 512)
    **generate.SPMM_EDGE_CASES,
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _dense(rows, F, seed=1):
    return np.random.default_rng(seed).normal(size=(rows, F)).astype(
        np.float32)


def _verdict(csr, B, C, dtype):
    if dtype is None:
        return reference.rigorously_validate_spmm(csr, B, C, mxu_bf16=False)
    return reference.rigorously_validate_spmm_bf16(csr, B, C)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [None, "bfloat16"])
@pytest.mark.parametrize("F", [5, 40, 128])
@pytest.mark.parametrize("block", [8, 512])
@pytest.mark.parametrize("name", sorted(BATTERY))
def test_k4_matches_plain(cuda_device, name, block, F, dtype):
    csr = BATTERY[name]()
    B = _dense(csr.shape[1], F)
    plan = make_plan(CsrLayout.from_csr(csr), "merge_path", block_work=block)
    Bd = torch.from_numpy(B).to(cuda_device)
    b, fn = spmm_flat.flat_spmm(csr, plan, dtype=dtype, device=cuda_device)
    # NaN in the memory C will reuse: a row the kernel skips shows
    torch.full((2 * csr.shape[0] * F + 1024,), float("nan"),
               device=cuda_device)
    before = _build.LAUNCHES["flat_spmm"]
    C1 = fn(b, Bd)
    C2 = fn(b, Bd)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flat_spmm"] == before + 2
    assert torch.equal(C1, C2), "two applies differ"
    plain = spmm_flat.flat_spmm_plain(b, Bd, csr.shape, dtype)
    assert torch.equal(C1, plain), "K4 and its plain version differ"
    C = C1.cpu().numpy()
    rep = _verdict(csr, B, C, dtype)
    assert rep.verdict == "NOT_A_BUG", rep


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_k4_backward_over_transpose(cuda_device, dtype):
    # the masked last layer: forward over A[rows, :], backward over its
    # transpose, both through K4, against the CPU torch path
    rng = np.random.default_rng(9)
    n = 400
    g = Graph.from_edges(rng.integers(0, n, 2400), rng.integers(0, n, 2400),
                         n, make_undirected=True)
    mask = (rng.random(n) < 0.5).astype(np.float32)
    h = _dense(n, 40, seed=3)
    dy = _dense(int(mask.sum()), 40, seed=4)
    outs = {}
    for dev in ("cpu", cuda_device):
        op = masked_aggregate_operator(g, mask, dtype=dtype,
                                       schedule="merge_path", impl="pallas",
                                       device=dev)
        ht = torch.from_numpy(h).to(dev).requires_grad_(True)
        y = op._fn(ht)
        y.backward(torch.from_numpy(dy).to(dev))
        outs[str(dev)] = (y.detach().cpu().numpy(), ht.grad.cpu().numpy(),
                          op)
    y_cpu, g_cpu, _ = outs["cpu"]
    y_gpu, g_gpu, op = outs[str(cuda_device)]
    assert op.launches == 1 and op._vjp_op.launches == 1
    np.testing.assert_allclose(y_gpu, y_cpu, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(g_gpu, g_cpu, rtol=RTOL, atol=ATOL)
    # the backward kernel against its plain version on the same buffers
    bwd = op._vjp_op
    dyd = torch.from_numpy(dy).to(cuda_device)
    plain = spmm_flat.flat_spmm_plain(bwd._bufs, dyd, bwd.mat.shape, dtype)
    np.testing.assert_array_equal(g_gpu, plain.cpu().numpy())
    rep = _verdict(bwd.mat, dy, g_gpu, dtype)
    assert rep.verdict == "NOT_A_BUG", rep


@pytest.mark.cuda
def test_k4_wrapper_checks_inputs(cuda_device):
    csr = BATTERY["random"]()
    plan = make_plan(CsrLayout.from_csr(csr), "merge_path", block_work=8)
    b, fn = spmm_flat.flat_spmm(csr, plan, device=cuda_device)
    cols = csr.shape[1]
    bad = [torch.zeros(cols, 4, dtype=torch.float64, device=cuda_device),
           torch.zeros(cols + 1, 4, device=cuda_device),
           torch.zeros(cols, device=cuda_device),
           torch.zeros(4, cols, device=cuda_device).t(),
           torch.zeros(cols, 4)]
    for B in bad:
        with pytest.raises(ValueError):
            spmm_flat.flat_spmm_cuda(b, B, csr.shape)
    with pytest.raises(ValueError, match="block_f"):
        spmm_flat.flat_spmm_cuda(b, torch.zeros(cols, 4, device=cuda_device),
                                 csr.shape, block_f=48)
    with pytest.raises(NotImplementedError, match="A10"):
        spmm_flat.flat_spmm(csr, plan, device=cuda_device, pad_groups=2)


@pytest.mark.cuda
def test_empty_matrix_launches_nothing(cuda_device):
    empty = CSR((5, 7), np.zeros(6, np.int64), np.zeros(0, np.int64),
                np.zeros(0, np.float32))
    before = dict(_build.LAUNCHES)
    op = SpMMOperator(empty, "merge_path", impl="pallas", device=cuda_device)
    C = op(np.ones((7, 3), np.float32))
    assert op.impl_used == "flat_spmm" and op.launches == 0
    assert C.shape == (5, 3) and not C.any()
    for impl in ("pallas", "pallas2", "pallas3"):
        y = SpMVOperator(empty, "merge_path", impl=impl,
                         device=cuda_device)(np.ones(7, np.float32))
        assert y.shape == (5,) and not y.any()
    torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == before


@pytest.mark.cuda
def test_f64_pallas_raises_on_cuda(cuda_device):
    f64 = generate.random_csr(20, 18, 0.25, seed=13, dtype=np.float64)
    with pytest.raises(ValueError, match="float64"):
        SpMMOperator(f64, "merge_path", impl="pallas", device=cuda_device)
    assert SpMMOperator(f64, "merge_path", impl="xla",
                        device=cuda_device).impl_used == "torch"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_aggregation_routes_k4_and_trains(cuda_device, dtype):
    rng = np.random.default_rng(5)
    n = 300
    g = Graph.from_edges(rng.integers(0, n, 1500), rng.integers(0, n, 1500),
                         n, make_undirected=True)
    assert aggregate_operator(g, "gcn", dtype=dtype,
                              device=cuda_device).impl_used == "flat_spmm"
    assert aggregate_operator(g, "mean", dtype=dtype,
                              device=cuda_device).impl_used == "torch"
    feats = _dense(n, 16, seed=6)
    labels = rng.integers(0, 4, n)
    mask = (rng.random(n) < 0.6).astype(np.float32)
    model = GCN(g, [16, 32, 4], dtype=dtype, precompute_first=True,
                loss_rows=mask, device=cuda_device)
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    step = train.make_train_step(model, opt, feats, labels, mask)
    losses = [float(step()) for _ in range(5)]
    assert np.isfinite(losses).all()
    assert model.launches() > 0
    acc = train.evaluate(model, feats, labels, mask)
    assert 0.0 <= acc <= 1.0
