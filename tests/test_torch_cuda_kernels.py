"""The CUDA kernels of ``loops_tpu_torch`` on the card: each kernel against
its plain PyTorch version on the same staged buffers, two runs bitwise
equal, the launch counter, and the wrappers' input checks.

Every test here needs an NVIDIA card and skips without one. The file
imports neither JAX nor ``loops_tpu``, so it runs on a machine that has
only PyTorch; ``tests/conftest.py`` imports JAX, so run it there with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

The tolerance against the plain version is ``rtol=1e-5, atol=1e-6``: the
kernels sum each row in f32 in another order (lane-strided partials and
shuffle trees, warp scans) than the plain versions.
"""
import numpy as np
import pytest
import torch

from loops_tpu_torch.layout import CsrLayout
from loops_tpu_torch.ops.kernels import _build, spmv_flat, spmv_flat_v2, spmv_sorted
from loops_tpu_torch.ops.spmv import SpMVOperator
from loops_tpu_torch.schedule.plans import make_plan
from loops_tpu_torch.utils import generate, reference

RTOL, ATOL = 1e-5, 1e-6

# the 9-matrix battery of tests/test_spmv_battery.py, plus a long-row case
BATTERY = {
    **generate.BATTERY,
    "long_rows": lambda: generate.skewed_csr(30, 3000, heavy_rows=2,
                                             heavy_nnz=2500, seed=4),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _builds(csr, block, device):
    plan = make_plan(CsrLayout.from_csr(csr), "merge_path", block_work=block)
    return {
        "sorted_spmv": (spmv_sorted.sorted_spmv(csr, block_atoms=block,
                                                device=device),
                        spmv_sorted.sorted_spmv_plain),
        "flat_spmv_v2": (spmv_flat_v2.flat_spmv_v2(csr, plan, device=device),
                         spmv_flat_v2.flat_spmv_v2_plain),
        "flat_spmv": (spmv_flat.flat_spmv(csr, plan, device=device),
                      spmv_flat.flat_spmv_plain),
    }


def _plain_args(kname, fn, csr):
    if kname == "sorted_spmv":
        return (None,)
    if kname == "flat_spmv_v2":
        return (csr.shape,)
    return (csr.shape, fn.meta["R"])


@pytest.mark.cuda
@pytest.mark.parametrize("block", [8, 1024])
@pytest.mark.parametrize("name", sorted(BATTERY))
def test_kernels_match_plain(cuda_device, name, block):
    csr = BATTERY[name]()
    x = generate.make_input_vector(csr.shape[1])
    xd = torch.from_numpy(x).to(cuda_device)
    for kname, ((b, fn), plain) in _builds(csr, block, cuda_device).items():
        before = _build.LAUNCHES[kname]
        y1 = fn(b, xd)
        y2 = fn(b, xd)
        torch.cuda.synchronize()
        assert _build.LAUNCHES[kname] == before + 2, kname
        assert torch.equal(y1, y2), f"{kname}/{name}: two runs differ"
        y_plain = plain(b, xd, *_plain_args(kname, fn, csr))
        tol = (dict(rtol=1e-4, atol=1e-3) if name == "long_rows"
               else dict(rtol=RTOL, atol=ATOL))
        np.testing.assert_allclose(y1.cpu().numpy(), y_plain.cpu().numpy(),
                                   err_msg=f"{kname}/{name}", **tol)
        rep = reference.rigorously_validate_spmv(csr, x, y1.cpu().numpy())
        assert rep.verdict == "NOT_A_BUG", f"{kname}/{name}: {rep}"


@pytest.mark.cuda
@pytest.mark.parametrize("schedule,impl,kname", [
    ("merge_path", "pallas", "flat_spmv"),
    ("merge_path", "pallas2", "flat_spmv_v2"),
    ("sorted_flat", "xla", "sorted_spmv"),
    ("auto", "xla", "sorted_spmv")])
def test_operator_launches_kernel(cuda_device, schedule, impl, kname):
    csr = generate.random_csr(3000, 2500, 0.004, seed=7)
    x = generate.make_input_vector(2500)
    op = SpMVOperator(csr, schedule, impl=impl, device=cuda_device)
    assert op.impl_used == kname
    y = op(x).cpu().numpy()
    assert op.launches == 1
    rep = reference.rigorously_validate_spmv(csr, x, y)
    assert rep.verdict == "NOT_A_BUG", rep


@pytest.mark.cuda
def test_wrappers_check_inputs(cuda_device):
    csr = BATTERY["random"]()
    b, fn = spmv_sorted.sorted_spmv(csr, device=cuda_device)
    with pytest.raises(ValueError):
        fn(b, torch.zeros(csr.shape[1], dtype=torch.float64,
                          device=cuda_device))
    with pytest.raises(ValueError):
        fn(b, torch.zeros(csr.shape[1] + 1, device=cuda_device))
    plan = make_plan(CsrLayout.from_csr(csr), "merge_path", block_work=8)
    b2, fn2 = spmv_flat_v2.flat_spmv_v2(csr, plan, device=cuda_device)
    with pytest.raises(ValueError):
        fn2(b2, torch.zeros(csr.shape[1] + 1, device=cuda_device))
    b3, fn3 = spmv_flat.flat_spmv(csr, plan, device=cuda_device)
    with pytest.raises(ValueError):
        fn3(b3, torch.zeros(2 * csr.shape[1], device=cuda_device)[::2])


@pytest.mark.cuda
def test_flat_window_past_default_shared_memory(cuda_device):
    # a 40064-float row window (157 KB) needs K3's opt-in past 48 KB
    csr = generate.wide_span_csr(40_000)
    x = generate.make_input_vector(4)
    plan = make_plan(CsrLayout.from_csr(csr), "work_oriented", block_atoms=8)
    b, fn = spmv_flat.flat_spmv(csr, plan, device=cuda_device)
    assert 48 * 1024 < 4 * fn.meta["R"] <= 4 * spmv_flat.MAX_WINDOW
    xd = torch.from_numpy(x).to(cuda_device)
    y = fn(b, xd)
    assert torch.equal(y, spmv_flat.flat_spmv_plain(b, xd, csr.shape,
                                                    fn.meta["R"]))
    rep = reference.rigorously_validate_spmv(csr, x, y.cpu().numpy())
    assert rep.verdict == "NOT_A_BUG", rep


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["pallas", "pallas2", "pallas3"])
def test_kernel_refusals_raise_on_cuda(cuda_device, impl):
    # a kernel request the kernels cannot honor never runs torch ops on
    # the card
    f64 = generate.random_csr(20, 18, 0.25, seed=13, dtype=np.float64)
    with pytest.raises(ValueError, match="float64"):
        SpMVOperator(f64, "merge_path", block=8, impl=impl,
                     device=cuda_device)
    wide = generate.wide_span_csr(spmv_flat.MAX_WINDOW + 1)
    if impl == "pallas":
        with pytest.raises(ValueError, match="row window"):
            SpMVOperator(wide, "work_oriented", block=8, impl=impl,
                         device=cuda_device)
    assert SpMVOperator(f64, "merge_path", block=8, impl="xla",
                        device=cuda_device).impl_used == "torch"
