"""The SDDMM kernels K5 and K10 and the stream probe K11 of
``loops_tpu_torch`` (``csrc/sddmm.cu``, ``csrc/stream.cu``) on the card:
each against its plain PyTorch version on the same staged buffers, two
applies bitwise equal, the launch counters, the operators' routing, and
the wrappers' input checks.

Every test here needs an NVIDIA card and skips without one. The file
imports neither JAX nor ``loops_tpu``; run it on the card with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_sddmm.py

Tolerance against the plain version: twice the Wilkinson bound of each
output's f32 dot, ``2 * 4 * F * u32 * sum_f |term|``, floor 1e-6, over the
terms both sides form identically (K5: ``bf16(A) * bf16(v * bf16(B))``,
exact in f32; K10: ``A * B``, then one product with vals, whose rounding
adds ``u32 |v dot|`` to each side). Each K5 result must also get
``NOT_A_BUG`` from the validator over its rounded terms, each K10 result
over the f32 operands. K11 reads integers in [-8, 8], so its total must
equal the integer sum exactly.
"""
import numpy as np
import pytest
import torch

from loops_tpu_torch.formats import BCSR, CSR
from loops_tpu_torch.ops.kernels import _build, sddmm_bcsr, sddmm_flat
from loops_tpu_torch.ops.sddmm import SDDMMOperator
from loops_tpu_torch.utils import generate, reference, stream

BF16 = "bfloat16"
FLAT = {
    "uniform": lambda: generate.random_csr(1024, 1024, 0.01, seed=2),
    "rect": lambda: generate.random_csr(768, 1536, 0.01, seed=3),
    "skewed_512": lambda: generate.skewed_csr(512, 512, heavy_rows=4),
    **generate.BATTERY,
}
FS = [1, 20, 33, 64, 128, 300]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _operands(shape, F, seed=4):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(shape[0], F)).astype(np.float32),
            rng.normal(size=(shape[1], F)).astype(np.float32))


def _twice_bound(csr, A, B, operands):
    t = reference.sddmm_terms(csr, A, B, np.arange(csr.nnz), operands)
    return 2 * reference.sddmm_bound(t, atol_floor=1e-6)


def _check_k5(csr, F, dev, A=None, B=None):
    if A is None:
        A, B = _operands(csr.shape, F)
    Ad = A if isinstance(A, torch.Tensor) else torch.from_numpy(A).to(dev)
    Bd = B if isinstance(B, torch.Tensor) else torch.from_numpy(B).to(dev)
    A, B = Ad.cpu().numpy(), Bd.cpu().numpy()
    b, fn = sddmm_flat.sddmm_flat(csr, device=dev)
    before = _build.LAUNCHES["sddmm_flat"]
    o1, o2 = fn(b, Ad, Bd), fn(b, Ad, Bd)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["sddmm_flat"] == before + (2 if csr.nnz else 0)
    assert torch.equal(o1, o2)
    out = o1.cpu().numpy()
    assert out.shape == (csr.nnz,) and np.all(np.isfinite(out))
    plain = sddmm_flat.sddmm_flat_plain(b, Ad, Bd, csr.nnz).cpu().numpy()
    diff = np.abs(out.astype(np.float64) - plain)
    assert np.all(diff <= _twice_bound(csr, A, B, BF16)), diff.max()
    rep = reference.rigorously_validate_sddmm(csr, A, B, out, BF16)
    assert rep.verdict == "NOT_A_BUG", rep


@pytest.mark.cuda
@pytest.mark.parametrize("F", FS)
@pytest.mark.parametrize("name", sorted(FLAT))
def test_k5_matches_plain(cuda_device, name, F):
    _check_k5(FLAT[name](), F, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("F", [7, 40])
def test_k5_runs_shorter_than_a_warp(cuda_device, F):
    # fewer nonzeros than one warp's runs, and a tail past the last run
    for nnz_rows in (1, 3, 37):
        csr = generate.random_csr(nnz_rows, 50, 0.1, seed=nnz_rows)
        _check_k5(csr, F, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("F", [20, 64, 33])
def test_k5_unaligned_operands(cuda_device, F):
    csr = FLAT["uniform"]()
    A, B = _operands(csr.shape, F)
    # a view one float into a buffer: rows are no longer 16-byte aligned
    Ab = torch.zeros(A.size + 1, device=cuda_device)
    Ab[1:] = torch.from_numpy(A.ravel()).to(cuda_device)
    Ad = Ab[1:].view(A.shape)
    assert Ad.data_ptr() % 16
    _check_k5(csr, F, cuda_device, Ad, torch.from_numpy(B).to(cuda_device))


def _check_k10(csr, block, F, dev):
    bcsr = BCSR.from_csr(csr, *block)
    A, B = _operands(csr.shape, F)
    b, fn = sddmm_bcsr.sddmm_bcsr(bcsr, device=dev)
    Ad, Bd = torch.from_numpy(A).to(dev), torch.from_numpy(B).to(dev)
    before = _build.LAUNCHES["sddmm_bcsr"]
    o1, o2 = fn(b, Ad, Bd), fn(b, Ad, Bd)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["sddmm_bcsr"] == before + (2 if bcsr.num_blocks
                                                      else 0)
    assert torch.equal(o1, o2)
    out = o1.cpu().numpy()
    assert out.shape == (bcsr.num_blocks, *block) and np.all(np.isfinite(out))
    plain = sddmm_bcsr.sddmm_bcsr_plain(b, Ad, Bd, csr.shape).cpu().numpy()
    # the validator's nonzeros: the stored entries inside the matrix
    pattern, slot = bcsr.stored_pattern()
    flat = out.reshape(-1)[slot]
    diff = np.abs(flat.astype(np.float64) - plain.reshape(-1)[slot])
    assert np.all(diff <= _twice_bound(pattern, A, B, None)), diff.max()
    rep = reference.rigorously_validate_sddmm(pattern, A, B, flat)
    assert rep.verdict == "NOT_A_BUG", rep
    # entries outside the matrix are zero
    assert not np.delete(out.reshape(-1), slot).any()


@pytest.mark.cuda
@pytest.mark.parametrize("F", [1, 20, 300])
@pytest.mark.parametrize("block", [(8, 128), (16, 128), (8, 256), (24, 128)])
@pytest.mark.parametrize("name", sorted(generate.BCSR_CASES))
def test_k10_matches_plain(cuda_device, name, block, F):
    _check_k10(generate.BCSR_CASES[name](), block, F, cuda_device)


@pytest.mark.cuda
def test_operators_take_the_kernels(cuda_device):
    csr, bcsr = generate.build_block_sparse(N=1024, R=8, C=128,
                                            block_density=0.06, seed=3)
    A, B = _operands(csr.shape, 64)
    op = SDDMMOperator(bcsr, impl="pallas", device=cuda_device)
    assert op.impl_used == "sddmm_bcsr"
    out = op(A, B)
    assert op.launches == 1
    xla = SDDMMOperator(bcsr, device=cuda_device)
    assert xla.impl_used == "torch"
    torch.testing.assert_close(out, xla(A, B), atol=1e-4, rtol=1e-4)
    sp = generate.random_csr(2000, 3000, 0.004, seed=1)
    A, B = _operands(sp.shape, 128)
    k5 = SDDMMOperator(sp, impl="pallas", dtype=BF16, device=cuda_device)
    assert k5.impl_used == "sddmm_flat"
    rep = reference.validate_sampled_sddmm(sp, A, B, k5(A, B), n=500,
                                           operands=BF16)
    assert k5.launches == 1 and rep.overruns == 0, rep
    f32 = SDDMMOperator(sp, device=cuda_device)(A, B)
    assert reference.validate_sampled_sddmm(sp, A, B, f32, n=500).overruns \
        == 0
    with pytest.raises(ValueError, match="bf16-operand kernel K5"):
        SDDMMOperator(sp, impl="pallas", device=cuda_device)
    f64 = generate.random_csr(20, 140, 0.2, seed=13, dtype=np.float64)
    with pytest.raises(ValueError, match="float64"):
        SDDMMOperator(BCSR.from_csr(f64, 8, 128), impl="pallas",
                      device=cuda_device)


@pytest.mark.cuda
def test_no_nonzeros_launch_nothing(cuda_device):
    empty = CSR((20, 300), np.zeros(21, np.int64), np.zeros(0, np.int64),
                np.zeros(0, np.float32))
    A, B = (torch.ones(20, 5, device=cuda_device),
            torch.ones(300, 5, device=cuda_device))
    before = dict(_build.LAUNCHES)
    out = SDDMMOperator(empty, impl="pallas", dtype=BF16,
                        device=cuda_device)(A, B)
    assert tuple(out.shape) == (0,)
    out = SDDMMOperator(BCSR.from_csr(empty, 8, 128), impl="pallas",
                        device=cuda_device)(A, B)
    assert tuple(out.shape) == (0, 8, 128)
    assert _build.LAUNCHES == before


@pytest.mark.cuda
def test_wrappers_check_inputs(cuda_device):
    dev = cuda_device
    csr = generate.BCSR_CASES["random"]()
    A = torch.ones(csr.shape[0], 6, device=dev)
    B = torch.ones(csr.shape[1], 6, device=dev)
    b5, _ = sddmm_flat.sddmm_flat(csr, device=dev)
    b10, _ = sddmm_bcsr.sddmm_bcsr(BCSR.from_csr(csr, 8, 128), device=dev)
    calls = {
        "K5": lambda A, B: sddmm_flat.sddmm_flat_cuda(b5, A, B, csr.shape,
                                                      csr.nnz),
        "K10": lambda A, B: sddmm_bcsr.sddmm_bcsr_cuda(b10, A, B, csr.shape),
    }
    for call in calls.values():
        with pytest.raises(ValueError, match="CUDA tensor"):
            call(A.cpu(), B.cpu())
        with pytest.raises(ValueError, match="dtype"):
            call(A.double(), B.double())
        with pytest.raises(ValueError, match="contiguous"):
            call(torch.ones(6, csr.shape[0], device=dev).t(), B)
        with pytest.raises(ValueError, match="expected"):
            call(A, torch.ones(csr.shape[1] + 1, 6, device=dev))
    x = torch.ones(1024, device=dev)
    with pytest.raises(ValueError, match="CUDA tensor"):
        stream.stream_read_cuda(x.cpu())
    with pytest.raises(ValueError, match="dtype"):
        stream.stream_read_cuda(x.double())
    with pytest.raises(ValueError, match="16-byte"):
        stream.stream_read_cuda(x[:1022])


@pytest.mark.cuda
def test_stream_matches_plain_and_rate_is_positive(cuda_device):
    # integers in [-8, 8]: every f32 partial sum is exact, and so the total
    x = stream.stream_input(4096, 512, cuda_device)
    exact = 3 * int(x.sum(dtype=torch.float64))
    assert exact != 0
    before = _build.LAUNCHES["stream_read"]
    parts = stream.stream_read(x, passes=3)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["stream_read"] == before + 1
    assert parts.double().sum().item() == exact
    assert stream.stream_read_plain(x, passes=3).item() == exact
    assert torch.equal(parts, stream.stream_read(x, passes=3))
    assert stream.pass_ms(x) > 0
    assert stream.measure_stream_gbps(cuda_device, rows=8192) > 0
