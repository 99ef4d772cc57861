"""The BCSR kernels K6–K9 of ``loops_tpu_torch`` (``csrc/bcsr.cu``) on the
card: each against its plain PyTorch version on the same staged buffers,
two applies bitwise equal, the launch counter, the operators' routing,
the wrappers' input checks, and (K7–K9) the edge cases, a NaN-filled
``out=`` written in full and the staged-buffer checks.

Every test here needs an NVIDIA card and skips without one. The file
imports neither JAX nor ``loops_tpu``; run it on the card with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_bcsr.py

Tolerance against the plain version: twice the Wilkinson bound,
``2 * 4 * nnz_r * u32 * sum |a * b|`` per entry, floor 1e-6, over the
operands the mode multiplies (bf16-rounded A and B in bf16 mode, whose
products are exact in f32): both sides sum the same products in f32 in
other orders, each within one bound of the exact sum. Each result must
also get ``NOT_A_BUG`` from the f32 validator over those operands.
"""
import numpy as np
import pytest
import torch

from loops_tpu_torch.formats import BCSR, CSR
from loops_tpu_torch.ops.kernels import (
    _build,
    spmm_bcsr,
    spmm_bcsr_v2,
    spmm_bcsr_v3,
    spmv_bcsr,
)
from loops_tpu_torch.ops.spmm import SpMMOperator
from loops_tpu_torch.ops.spmv import SpMVOperator
from loops_tpu_torch.utils import generate, reference

BLOCKS = [(8, 128), (16, 128), (8, 256)]
FS = [20, 300, 513]
BF16 = "bfloat16"
SPMM = {
    # kernel -> (its build function at block_f 128, its modes)
    "bcsr_spmm": (lambda m, dtype, dev, **kw: spmm_bcsr.bcsr_spmm(
        m, block_f=128, device=dev), (None,)),
    "bcsr_spmm_v2": (lambda m, dtype, dev, **kw: spmm_bcsr_v2.bcsr_spmm_v2(
        m, block_f=128, dtype=dtype, device=dev, **kw), (None, BF16)),
    "bcsr_spmm_v3": (lambda m, dtype, dev, **kw: spmm_bcsr_v3.bcsr_spmm_v3(
        m, block_f=128, dtype=dtype, device=dev, **kw), (None, BF16)),
}
SPMM_CASES = [(k, d) for k, (_, ds) in SPMM.items() for d in ds]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _operands(csr, B, dtype):
    """The CSR and B the mode multiplies: bf16-rounded in bf16 mode."""
    if dtype is None:
        return csr, B
    return (CSR(csr.shape, csr.offsets, csr.indices,
                reference.bf16_round(csr.vals)), reference.bf16_round(B))


def _pair_tolerance(csr, B):
    nnz_r = csr.row_sizes().astype(np.float64)[:, None]
    return np.maximum(1e-6, 2 * reference.DEFAULT_WILKINSON_K * nnz_r
                      * reference.unit_roundoff(np.float32)
                      * reference.spmm_l1_products(csr, B))


def _plain(kname, b, Bd, shape, dtype, meta):
    if kname == "bcsr_spmm":
        return spmm_bcsr.bcsr_spmm_plain(b, Bd, shape)
    if kname == "bcsr_spmm_v2":
        return spmm_bcsr_v2.bcsr_spmm_v2_plain(b, Bd, shape, dtype)
    return spmm_bcsr_v3.bcsr_spmm_v3_plain(b, Bd, shape, meta, dtype)


def _check_spmm(kname, csr, bcsr, F, dtype, dev, **kw):
    b, fn = SPMM[kname][0](bcsr, dtype, dev, **kw)
    B = np.random.default_rng(F).normal(size=(csr.shape[1], F)).astype(
        np.float32)
    Bd = torch.from_numpy(B).to(dev)
    before = _build.LAUNCHES[kname]
    C1 = fn(b, Bd)
    C2 = fn(b, Bd)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[kname] == before + 2
    assert torch.equal(C1, C2)
    C = C1.cpu().numpy()
    assert C.shape == (csr.shape[0], F) and np.all(np.isfinite(C))
    plain = _plain(kname, b, Bd, csr.shape, dtype, fn.meta).cpu().numpy()
    ops_csr, ops_B = _operands(csr, B, dtype)
    diff = np.abs(C.astype(np.float64) - plain)
    assert np.all(diff <= _pair_tolerance(ops_csr, ops_B)), diff.max()
    rep = reference.rigorously_validate_spmm(ops_csr, ops_B, C,
                                             mxu_bf16=False)
    assert rep.verdict == "NOT_A_BUG", rep
    # K7, K8 and K9 write every row of a torch.empty C, or of out=
    out = torch.full_like(C1, float("nan"))
    assert fn(b, Bd, out=out) is out
    torch.cuda.synchronize()
    assert torch.equal(out, C1)
    return fn.meta


@pytest.mark.cuda
@pytest.mark.parametrize("F", FS)
@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("name", sorted(generate.BCSR_CASES))
@pytest.mark.parametrize("kname,dtype", SPMM_CASES)
def test_spmm_kernels_match_plain(cuda_device, kname, dtype, name, block, F):
    csr = generate.BCSR_CASES[name]()
    _check_spmm(kname, csr, BCSR.from_csr(csr, *block), F, dtype,
                cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("kname,dtype", SPMM_CASES)
def test_spmm_kernels_at_small_super_rows(cuda_device, kname, dtype):
    # several super-rows and chunks of two blocks (K7), several feature
    # tiles, ragged F
    csr = generate.random_csr(200, 280, 0.05, seed=9)
    bcsr = BCSR.from_csr(csr, 8, 128)
    kw = dict(super_rows=4)
    if kname == "bcsr_spmm_v3":
        kw["chunk_blocks"] = 2
    if kname == "bcsr_spmm":
        kw = {}
    meta = _check_spmm(kname, csr, bcsr, 150, dtype, cuda_device, **kw)
    if kname == "bcsr_spmm_v3":
        assert meta["SUPER"] == 4 and meta["chunks"] > meta["b_fetches"]


@pytest.mark.cuda
@pytest.mark.parametrize("block", [(8, 128), (16, 128)])
@pytest.mark.parametrize("name", sorted(generate.BCSR_CASES))
def test_spmv_kernel_matches_plain(cuda_device, name, block):
    csr = generate.BCSR_CASES[name]()
    b, fn = spmv_bcsr.bcsr_spmv(BCSR.from_csr(csr, *block),
                                device=cuda_device)
    x = generate.make_input_vector(csr.shape[1])
    xd = torch.from_numpy(x).to(cuda_device)
    before = _build.LAUNCHES["bcsr_spmv"]
    y1, y2 = fn(b, xd), fn(b, xd)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["bcsr_spmv"] == before + 2
    assert torch.equal(y1, y2)
    y = y1.cpu().numpy()
    plain = spmv_bcsr.bcsr_spmv_plain(b, xd, csr.shape).cpu().numpy()
    tol = 2 * reference.DEFAULT_WILKINSON_K * csr.row_sizes() \
        * reference.unit_roundoff(np.float32) \
        * reference.row_l1_products(csr, x)
    assert np.all(np.abs(y.astype(np.float64) - plain)
                  <= np.maximum(1e-6, tol))
    assert reference.rigorously_validate_spmv(csr, x, y).verdict \
        == "NOT_A_BUG"


@pytest.mark.cuda
def test_operators_take_the_kernels(cuda_device):
    csr, bcsr = generate.build_block_sparse(N=1024, R=8, C=128,
                                            block_density=0.06, seed=3)
    B = np.random.default_rng(2).normal(size=(1024, 64)).astype(np.float32)
    for impl, kname in (("pallas", "bcsr_spmm"), ("pallas2", "bcsr_spmm_v2"),
                        ("pallas3", "bcsr_spmm_v3")):
        op = SpMMOperator(bcsr, "row_mapped", impl, device=cuda_device)
        assert op.impl_used == kname
        C = op(B)
        assert op.launches == 1
        rep = reference.validate_sampled_rows(csr, B, C, n=64)
        assert rep.overruns == 0 and rep.rel_error < 1e-5, rep
    xla = SpMMOperator(bcsr, impl="xla", device=cuda_device)
    assert xla.impl_used == "torch"
    assert reference.validate_sampled_rows(csr, B, xla(B), n=64).overruns \
        == 0
    x = generate.make_input_vector(1024)
    op = SpMVOperator(bcsr, impl="pallas", device=cuda_device)
    assert op.impl_used == "bcsr_spmv"
    y = op(x).cpu().numpy()
    assert op.launches == 1
    assert reference.rigorously_validate_spmv(csr, x, y).verdict \
        == "NOT_A_BUG"


@pytest.mark.cuda
def test_empty_matrix_without_blocks(cuda_device):
    empty = CSR((20, 300), np.zeros(21, np.int64), np.zeros(0, np.int64),
                np.zeros(0, np.float32))
    bcsr = BCSR.from_csr(empty, 8, 128)
    B = torch.ones(300, 5, device=cuda_device)
    for impl in ("pallas", "pallas2", "pallas3"):
        C = SpMMOperator(bcsr, impl=impl, device=cuda_device)(B)
        assert tuple(C.shape) == (20, 5) and not C.any()
    y = SpMVOperator(bcsr, impl="pallas", device=cuda_device)(
        torch.ones(300, device=cuda_device))
    assert tuple(y.shape) == (20,) and not y.any()


@pytest.mark.cuda
def test_wrappers_check_inputs(cuda_device):
    csr = generate.BCSR_CASES["random"]()
    bcsr = BCSR.from_csr(csr, 8, 128)
    dev = cuda_device
    b6, _ = spmv_bcsr.bcsr_spmv(bcsr, device=dev)
    x = torch.ones(csr.shape[1], device=dev)
    with pytest.raises(ValueError, match="CUDA tensor"):
        spmv_bcsr.bcsr_spmv_cuda(b6, x.cpu(), csr.shape)
    with pytest.raises(ValueError, match="dtype"):
        spmv_bcsr.bcsr_spmv_cuda(b6, x.double(), csr.shape)
    B = torch.ones(csr.shape[1], 6, device=dev)
    b9, _ = spmm_bcsr.bcsr_spmm(bcsr, device=dev)
    b8, f8 = spmm_bcsr_v2.bcsr_spmm_v2(bcsr, device=dev)
    b7, f7 = spmm_bcsr_v3.bcsr_spmm_v3(bcsr, device=dev)
    calls = {
        "K9": lambda b, B: spmm_bcsr.bcsr_spmm_cuda(b, B, csr.shape),
        "K8": lambda b, B: spmm_bcsr_v2.bcsr_spmm_v2_cuda(b, B, csr.shape,
                                                          f8.meta),
        "K7": lambda b, B: spmm_bcsr_v3.bcsr_spmm_v3_cuda(b, B, csr.shape,
                                                          f7.meta),
    }
    for (name, call), b in zip(calls.items(), (b9, b8, b7)):
        with pytest.raises(ValueError, match="CUDA tensor"):
            call(b, B.cpu())
        with pytest.raises(ValueError, match="dtype"):
            call(b, B.double())
        with pytest.raises(ValueError, match="contiguous"):
            call(b, torch.ones(6, csr.shape[1], device=dev).t())
        with pytest.raises(ValueError, match="shape"):
            call(b, torch.ones(csr.shape[1] + 1, 6, device=dev))


@pytest.mark.cuda
def test_float64_kernel_requests_raise(cuda_device):
    f64 = generate.random_csr(20, 140, 0.2, seed=13, dtype=np.float64)
    bcsr = BCSR.from_csr(f64, 8, 128)
    for impl in ("pallas", "pallas2", "pallas3"):
        with pytest.raises(ValueError, match="float64"):
            SpMMOperator(bcsr, impl=impl, device=cuda_device)
    with pytest.raises(ValueError, match="float64"):
        SpMVOperator(bcsr, impl="pallas", device=cuda_device)
    y = SpMVOperator(bcsr, impl="xla", device=cuda_device)(
        np.ones(140))
    assert y.dtype == torch.float64


# K7's, K8's and K9's edge cases: B's rows past the last full block column
# (cols not a multiple of C), empty block rows and, at two block rows a
# super-row, empty super-rows; chunks of one block (K7)
EDGE = {
    "ragged_cols": lambda: generate.random_csr(100, 300, 0.04, seed=21),
    "empty_super_rows": lambda: generate.sized_csr(
        [3] * 16 + [0] * 40 + [2] * 16 + [0] * 9, 390, seed=22),
}


@pytest.mark.cuda
@pytest.mark.parametrize("F", [20, 513])
@pytest.mark.parametrize("block", [(8, 128), (16, 128)])
@pytest.mark.parametrize("name", sorted(EDGE))
@pytest.mark.parametrize("kname,dtype", SPMM_CASES)
def test_k7_k9_edge_cases(cuda_device, kname, dtype, name, block, F):
    csr = EDGE[name]()
    bcsr = BCSR.from_csr(csr, *block)
    kws = {"bcsr_spmm": [{}],
           "bcsr_spmm_v2": [{}, dict(super_rows=2)],
           "bcsr_spmm_v3": [{}, dict(super_rows=2, chunk_blocks=1),
                            dict(super_rows=2, chunk_blocks=2)]}[kname]
    for kw in kws:
        meta = _check_spmm(kname, csr, bcsr, F, dtype, cuda_device, **kw)
        if kw.get("chunk_blocks") == 1:
            assert meta["chunks"] == meta["num_blocks"]


@pytest.mark.cuda
@pytest.mark.parametrize("kname,dtype", SPMM_CASES)
def test_k7_k9_check_staged_buffers_and_out(cuda_device, kname, dtype):
    csr = generate.BCSR_CASES["tall"]()
    b, fn = SPMM[kname][0](BCSR.from_csr(csr, 8, 128), dtype, cuda_device)
    Bd = torch.ones(csr.shape[1], 24, device=cuda_device)
    C = fn(b, Bd)
    for bad in (torch.zeros(csr.shape[0], 23, device=cuda_device),
                torch.zeros(csr.shape[0] + 1, 24, device=cuda_device),
                torch.zeros(csr.shape[0], 24, device=cuda_device,
                            dtype=torch.float64)):
        with pytest.raises(ValueError, match="out"):
            fn(b, Bd, out=bad)
    key = "ccol" if kname == "bcsr_spmm_v3" else "bcols"
    # a replaced buffer is checked again: one of the right kind passes
    b[key] = b[key].clone()
    assert fn.staged_on(b) is None
    assert torch.equal(fn(b, Bd), C)
    # one changed in place is refused
    b[key].resize_(b[key].numel() - 1)
    with pytest.raises(ValueError, match=key):
        fn(b, Bd)
