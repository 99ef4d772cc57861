"""The out-of-core tier on the card: K4 (``csrc/spmm.cu``) staged with
``pad_groups``/``pad_R`` against K4 unpadded, bit for bit, at F = 40, 128
and 256 in f32 and bf16; ``StreamedSpMM`` on the card against its CPU
run; and K1's plan cache on the card.

Every test here needs an NVIDIA card and skips without one. The file
imports neither JAX nor ``loops_tpu``; run it on the card with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_outofcore.py

Tolerances: padded against unpadded K4, and the streamed ``merge_path``
(K4) on the card against the CPU run (K4's plain version, which sums in
the kernel's order): bit for bit. The streamed ``row_mapped`` (a sorted
``torch.segment_reduce``, whose CUDA and CPU reductions may order a row's
sum differently) against the CPU run: ``rtol=1e-5, atol=1e-6``. The plan
cache: the cached plan's ``y`` equals the built plan's bit for bit, and
K1's plain version on the CPU over the cached plan within
``rtol=1e-5, atol=1e-6``.
"""
import numpy as np
import pytest
import torch

from loops_tpu_torch.io.shards import ShardedCSR, StreamedSpMM
from loops_tpu_torch.layout import CsrLayout
from loops_tpu_torch.ops.kernels import _build, spmm_flat
from loops_tpu_torch.ops.spmv import SpMVOperator
from loops_tpu_torch.schedule.plans import FlatBlockPlan
from loops_tpu_torch.utils import generate

CPU = torch.device("cpu")
MATRICES = {
    **generate.SPMM_EDGE_CASES,
    "random": lambda: generate.random_csr(3000, 2500, 0.004, seed=11),
    "skewed": lambda: generate.skewed_csr(2000, 2000, heavy_rows=6),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [None, "bfloat16"])
@pytest.mark.parametrize("F", [40, 128, 256])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_k4_padded_equals_unpadded(cuda_device, name, F, dtype):
    csr = MATRICES[name]()
    block = 8 if name in generate.SPMM_EDGE_CASES and not name.endswith(
        "_512") else 512
    plan = FlatBlockPlan.merge_path(CsrLayout.from_csr(csr),
                                    block_work=block)
    B = torch.from_numpy(np.random.default_rng(F).normal(
        size=(csr.shape[1], F)).astype(np.float32)).to(cuda_device)
    b0, f0 = spmm_flat.flat_spmm(csr, plan, dtype=dtype, device=cuda_device)
    groups = plan.num_blocks + 37
    b1, f1 = spmm_flat.flat_spmm(csr, plan, dtype=dtype, device=cuda_device,
                                 pad_groups=groups,
                                 pad_R=plan.max_rel_span + 9)
    assert f1.meta["groups"] == groups
    # NaN in the memory the padded run's C reuses: a skipped row shows
    torch.full((4 * csr.shape[0] * F,), float("nan"), device=cuda_device)
    before = _build.LAUNCHES["flat_spmm"]
    C1 = f1(b1, B)
    C0 = f0(b0, B)
    assert _build.LAUNCHES["flat_spmm"] - before == 2
    assert torch.equal(C0, C1)
    plain = spmm_flat.flat_spmm_plain({k: v.cpu() for k, v in b1.items()},
                                      B.cpu(), csr.shape, dtype)
    assert torch.equal(C1.cpu(), plain)


def _store(tmp_path, name, shards):
    csr = {"random": lambda: generate.random_csr(3000, 2800, 0.003, seed=6),
           "skewed": lambda: generate.skewed_csr(2000, 2000, heavy_rows=6),
           "empty_rows": lambda: generate.empty_row_csr(400, 50)}[name]()
    return csr, ShardedCSR.build(csr, shards, str(tmp_path / name))


@pytest.mark.cuda
@pytest.mark.parametrize("schedule,dtype", [("merge_path", None),
                                            ("merge_path", "bfloat16"),
                                            ("row_mapped", None)])
@pytest.mark.parametrize("name,shards", [("random", 5), ("skewed", 3),
                                         ("empty_rows", 7)])
def test_streamed_on_card_equals_cpu_run(cuda_device, tmp_path, name,
                                         shards, schedule, dtype):
    csr, st = _store(tmp_path, name, shards)
    X = np.random.default_rng(4).normal(size=(csr.shape[1], 96)).astype(
        np.float32)
    before = _build.LAUNCHES["flat_spmm"]
    card = StreamedSpMM(st, schedule, dtype=dtype, device=cuda_device)
    got = card(X)
    launched = _build.LAUNCHES["flat_spmm"] - before
    want = StreamedSpMM(st, schedule, dtype=dtype, device=CPU)(X)
    if schedule == "merge_path":
        assert launched == shards
        np.testing.assert_array_equal(got, want)
    else:
        assert launched == 0
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert all(len(v) == shards for v in card.times.values())
    # a second stream through the same buffers gives the same bits
    np.testing.assert_array_equal(card(X), got)


@pytest.mark.cuda
def test_streamed_into_memmap_on_card(cuda_device, tmp_path):
    csr, st = _store(tmp_path, "random", 4)
    X = np.lib.format.open_memmap(str(tmp_path / "x.npy"), mode="w+",
                                  dtype=np.float32, shape=(csr.shape[1], 64))
    X[:] = np.random.default_rng(2).normal(size=X.shape)
    Y = np.lib.format.open_memmap(str(tmp_path / "y.npy"), mode="w+",
                                  dtype=np.float32, shape=(csr.shape[0], 64))
    StreamedSpMM(st, "merge_path", device=cuda_device)(X, out=Y)
    Y.flush()
    np.testing.assert_allclose(np.load(tmp_path / "y.npy"),
                               csr.to_dense() @ np.asarray(X),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_plan_cache_on_card(cuda_device, tmp_path):
    csr = generate.random_csr(20000, 20000, 0.0005, seed=8)
    x = torch.from_numpy(generate.make_input_vector(20000)).to(cuda_device)
    ops = [SpMVOperator(csr, "sorted_flat", plan_cache=str(tmp_path),
                        device=cuda_device) for _ in range(2)]
    assert [op.meta["plan_source"] for op in ops] == ["built", "cache"]
    ys = [op(x) for op in ops]
    assert [op.launches for op in ops] == [1, 1]
    assert torch.equal(ys[0], ys[1])
    # the cached plan on the CPU: K1's plain version, within f32 sums
    cpu = SpMVOperator(csr, "sorted_flat", plan_cache=str(tmp_path),
                       device=CPU)
    assert cpu.meta["plan_source"] == "cache"
    np.testing.assert_allclose(ys[0].cpu().numpy(), cpu(x.cpu()).numpy(),
                               rtol=1e-5, atol=1e-6)
