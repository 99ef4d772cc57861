"""COO, CSC, ELL and DIA SpMV, ``flat_partitioned_spmv``, ``reorder=``
and COO and ELL SpMM on the card: each route against the same route on
the CPU, the deterministic routes (COO and CSC row_mapped, ELL's plane,
DIA's sweep, the flat partitioner, COO and ELL SpMM) two applies bitwise
equal, ``reorder=`` through K1 and K2 with their launch counters rising,
and the ELL SpMM plane guard raising on the card instead of falling back.

Every test here needs an NVIDIA card and skips without one. The file
imports neither JAX nor ``loops_tpu``; run it on the card with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_formats.py

Card against CPU: ``rtol=1e-5, atol=1e-6`` for SpMV and ``1e-5`` for
SpMM (the card's reductions and the flat executors' ``index_add_`` sum in
other orders).
"""
import numpy as np
import pytest
import torch

from loops_tpu_torch.ops.spmm import SpMMOperator
from loops_tpu_torch.ops.spmv import SpMVOperator, flat_partitioned_spmv
from loops_tpu_torch.utils import generate

CPU = torch.device("cpu")
ROUTES = [("coo", "row_mapped", True), ("coo", "group_mapped", True),
          ("coo", "merge_path", False), ("coo", "work_oriented", False),
          ("csc", "row_mapped", True), ("ell", "row_mapped", True),
          ("ell", "auto", True), ("ell", "merge_path", False),
          ("dia", "row_mapped", True)]
MATRICES = {
    "random": lambda: generate.random_csr(3000, 2500, 0.004, seed=1),
    "skewed": lambda: generate.skewed_csr(2000, 2000, heavy_rows=4,
                                          heavy_nnz=900, seed=2),
    "banded": lambda: generate.banded_csr(5000, 5000, band=4, seed=4),
    "empty_rows": lambda: generate.empty_row_csr(3000, 900, seed=5),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("fmt,schedule,deterministic", ROUTES)
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_route_on_the_card_matches_the_cpu(cuda_device, name, fmt, schedule,
                                           deterministic):
    csr = MATRICES[name]()
    mat = getattr(csr, f"to_{fmt}")()
    x = generate.make_input_vector(csr.shape[1])
    op = SpMVOperator(mat, schedule, block=256, device=cuda_device)
    xd = torch.from_numpy(x).to(cuda_device)
    y = op(xd)
    assert y.is_cuda and op.launches == 0 and op.impl_used == "torch"
    want = SpMVOperator(mat, schedule, block=256, device=CPU)(x).numpy()
    np.testing.assert_allclose(y.cpu().numpy(), want, rtol=1e-5, atol=1e-6)
    if deterministic:
        assert torch.equal(y, op(xd))


@pytest.mark.cuda
def test_flat_partitioned_on_the_card(cuda_device):
    csr = MATRICES["skewed"]()
    x = generate.make_input_vector(csr.shape[1])
    xd = torch.from_numpy(x).to(cuda_device)
    y = flat_partitioned_spmv(csr, xd, 8, device=cuda_device)
    assert y.is_cuda and torch.equal(y, flat_partitioned_spmv(
        csr, xd, 8, device=cuda_device))
    np.testing.assert_allclose(
        y.cpu().numpy(), flat_partitioned_spmv(csr, x, 8, device=CPU).numpy(),
        rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("reorder", ["degree", "bfs"])
@pytest.mark.parametrize("schedule,impl,kernel", [
    ("sorted_flat", "xla", "sorted_spmv"),
    ("merge_path", "pallas2", "flat_spmv_v2"),
    ("row_mapped", "xla", None)])
def test_reorder_on_the_card(cuda_device, reorder, schedule, impl, kernel):
    csr = generate.random_csr(3000, 3000, 0.004, seed=1)
    x = generate.make_input_vector(csr.shape[1])
    op = SpMVOperator(csr, schedule, block=256, impl=impl, reorder=reorder,
                      device=cuda_device)
    y = op(x)
    assert op.impl_used == (kernel or "torch")
    assert op.launches == (1 if kernel else 0)
    want = SpMVOperator(csr, schedule, block=256, impl=impl, reorder=reorder,
                        device=CPU)(x).numpy()
    np.testing.assert_allclose(y.cpu().numpy(), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(y.cpu().numpy(), csr.to_dense() @ x,
                               rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["coo", "ell"])
@pytest.mark.parametrize("name", ["random", "skewed", "empty_rows"])
def test_spmm_on_the_card(cuda_device, name, fmt):
    csr = MATRICES[name]()
    mat = getattr(csr, f"to_{fmt}")()
    B = np.random.default_rng(3).normal(
        size=(csr.shape[1], 33)).astype(np.float32)
    op = SpMMOperator(mat, device=cuda_device)
    Bd = torch.from_numpy(B).to(cuda_device)
    C = op(Bd)
    assert C.is_cuda and torch.equal(C, op(Bd))
    want = SpMMOperator(mat, device=CPU)(B).numpy()
    np.testing.assert_allclose(C.cpu().numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_ell_spmm_guard_raises_on_the_card(cuda_device):
    from loops_tpu_torch.ops.spmm import ell_plane_guard

    _, total = torch.cuda.mem_get_info(cuda_device)
    rows, F = 1 << 20, 1024
    # past the whole card's memory: no cache can hold that
    pitch = total // (rows * F * 4) + 1
    with pytest.raises(MemoryError, match="max_pitch"):
        ell_plane_guard(rows, pitch, F, torch.float32, None, cuda_device)
    ell_plane_guard(rows, 1, 16, torch.float32, None, cuda_device)
