"""The CSR SpMM of the port (``loops_tpu_torch.ops.spmm``, kernel K4 in
``ops/kernels/spmm_flat.py``) against ``loops_tpu``'s ``SpMMOperator`` in
f32, on the same numpy inputs; the bf16 mode is in
``test_torch_spmm_bf16.py``.

Cases: the matrices of ``tests/test_spmm_flat_pallas.py`` and the 9-matrix
battery; blocks 8 and 64 for the merge-path kernel; F in {5, 16, 40}. The
JAX side runs as its own tests run on the CPU: K4's Pallas kernel in
interpret mode. It runs once per matrix (and block) at F = 40, and the
F = 5 and 16 cases compare the leading columns: each column of C is its
own sum over the same products (the Pallas kernel pads every F up to a
128-lane tile anyway). On the CPU the port's K4 wrapper runs its plain
version.

Tolerance in f32: ``atol=rtol=1e-4``, as the JAX test uses, and the
port's result must get ``NOT_A_BUG`` from the f32 Wilkinson validator.
``_emulate_k4`` mirrors in numpy what ``csrc/spmm.cu`` does with the
staged buffers (each block's atoms cut into 8 warp ranges, the warps'
partial rows added in warp order, the seam pass, zeros for rows without
atoms), so a wrong staging array or summation order shows here;
``test_torch_cuda_spmm.py`` holds the kernel against its plain version on
the card, bit for bit. The ``hub``, ``empty_run`` and ``empty_tail``
matrices put one row across several warps and blocks, a run of empty rows
longer than any block's work, and empty rows at the end.
"""
import functools

import numpy as np
import pytest
import torch

import loops_tpu.utils.generate as jgen
import loops_tpu.utils.reference as jref
import loops_tpu_torch.formats as tf
from loops_tpu.formats import CSR as JaxCSR
from loops_tpu.ops.spmm import SpMMOperator as JaxSpMM
from loops_tpu_torch.layout import CsrLayout
from loops_tpu_torch.models.message_passing import _transpose_csr
from loops_tpu_torch.ops.kernels import spmm_flat
from loops_tpu_torch.ops.spmm import SpMMOperator, spmm
from loops_tpu_torch.schedule.plans import make_plan
from loops_tpu_torch.utils import generate, reference

CPU = torch.device("cpu")

F_MAX = 40
FS = [5, 16, 40]
BLOCKS = [8, 64]
XLA_SCHEDULES = ["row_mapped", "group_mapped", "merge_path",
                 "work_oriented", "auto"]

# tests/test_spmm_flat_pallas.py's cases, and the battery under its own
# names where they differ
MATRICES = {
    "identity": lambda: jgen.identity_csr(16),
    "skewed": lambda: jgen.skewed_csr(14, 24, heavy_rows=2),
    "empty_rows": lambda: jgen.empty_row_csr(15, 9),
    "random": lambda: jgen.random_csr(40, 35, 0.15, seed=11),
    "random_big": lambda: jgen.random_csr(300, 280, 0.03, seed=3),
    **{f"battery_{k}": (lambda make=make: JaxCSR(*_arrays(make())))
       for k, make in generate.BATTERY.items()
       if k not in ("identity", "skewed", "empty_rows")},
    # generate.SPMM_EDGE_CASES at blocks 8 and 64: one row over several
    # warps and blocks, 130 empty rows in a run, the last rows empty
    **{k: (lambda make=make: JaxCSR(*_arrays(make())))
       for k, make in generate.SPMM_EDGE_CASES.items()
       if not k.endswith("_512")},
}


def _arrays(c):
    return c.shape, c.offsets, c.indices, c.vals


def inputs(name):
    """(port CSR, loops_tpu CSR, B [cols, F_MAX]) for one case."""
    j = MATRICES[name]()
    t = tf.csr_from_arrays(*_arrays(j))
    B = np.random.default_rng(1).normal(size=(j.shape[1], F_MAX)).astype(
        np.float32)
    return t, j, B


@functools.lru_cache(maxsize=None)
def jax_result(name, schedule, impl, block, dtype):
    _, j, B = inputs(name)
    return np.asarray(JaxSpMM(j, schedule=schedule, impl=impl, block=block,
                              dtype=dtype)(B))


def port_result(name, schedule, impl, block, dtype, F):
    t, _, B = inputs(name)
    op = SpMMOperator(t, schedule, impl, dtype=dtype, block=block, device=CPU)
    C = op(B[:, :F])
    assert isinstance(C, torch.Tensor) and C.dtype == torch.float32
    assert tuple(C.shape) == (t.shape[0], F)
    assert op.launches == 0  # the CPU runs the plain version
    assert op.impl_used == ("flat_spmm" if impl == "pallas" else "torch")
    return t, B[:, :F], C.numpy()


def check_f32(name, schedule, impl, block, F):
    t, B, C = port_result(name, schedule, impl, block, None, F)
    want = jax_result(name, schedule, impl, block, None)[:, :F]
    np.testing.assert_allclose(C, want, atol=1e-4, rtol=1e-4,
                               err_msg=f"{schedule}/{impl}/{name}")
    rep = reference.rigorously_validate_spmm(t, B, C, mxu_bf16=False)
    assert rep.verdict == "NOT_A_BUG", rep


@pytest.mark.parametrize("F", FS)
@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_merge_path_kernel_matches_loops_tpu(name, block, F):
    check_f32(name, "merge_path", "pallas", block, F)


@pytest.mark.parametrize("F", FS)
@pytest.mark.parametrize("schedule", XLA_SCHEDULES)
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_torch_schedules_match_loops_tpu(name, schedule, F):
    check_f32(name, schedule, "xla", 512, F)


def _emulate_k4(b, B, shape, dtype=None):
    """numpy mirror of ``csrc/spmm.cu``. Per block: rows of its row range
    without atoms are zeros; its atoms are cut into 8 warp ranges at
    ``a0 + n*w // 8``; a warp sums each row's atoms of its range in
    storage order, a row strictly inside the range straight to C, its
    first and last rows to the block's partials; the block adds each
    row's partials in warp order, its first and last rows to the seam
    buffer, the rest to C. Then the seam pass in block order. C starts as
    NaN, so a row the kernel would not write shows."""
    rows, F = shape[0], B.shape[1]
    vals, cols = b["vals"].numpy(), b["cols"].numpy()
    srows = b["rows"].numpy()
    off, starts = b["offsets"].numpy(), b["atom_starts"].numpy()
    row_starts = b["row_starts"].numpy()
    rf_, rl_ = b["row_first"].numpy(), b["row_last"].numpy()
    nb, K = vals.shape
    if dtype == "bfloat16":
        vals = reference.bf16_round(vals)
        B = reference.bf16_round(B)
    C = np.full((rows, F), np.nan, np.float32)
    seam = np.full((nb, 2, F), np.nan, np.float32)
    for blk in range(nb):
        for r in range(row_starts[blk], row_starts[blk + 1]):
            if off[r] == off[r + 1]:
                C[r] = 0
        n = starts[blk + 1] - starts[blk]
        parts = []  # (row, partial) of each warp's first and last row
        for w in range(spmm_flat.WARPS):
            lo, hi = n * w // 8, n * (w + 1) // 8
            if lo >= hi:
                continue
            wf, wl = srows[blk, lo], srows[blk, hi - 1]
            runs = []  # (row, sum) in storage order
            for a in range(lo, hi):
                p = np.float32(vals[blk, a]) * B[cols[blk, a]]
                if dtype == "bfloat16":
                    p = reference.bf16_round(p)
                if not runs or runs[-1][0] != srows[blk, a]:
                    runs.append((srows[blk, a], np.zeros(F, np.float32)))
                runs[-1] = (runs[-1][0], runs[-1][1] + p)
            for r, acc in runs:
                if r in (wf, wl):
                    parts.append((r, acc))
                else:
                    C[r] = acc
        sums = []
        for r, p in parts:
            if sums and sums[-1][0] == r:
                sums[-1] = (r, sums[-1][1] + p)
            else:
                sums.append((r, p))
        for r, s in sums:
            if r == rf_[blk]:
                seam[blk, 0] = s
            elif r == rl_[blk]:
                seam[blk, 1] = s
            else:
                C[r] = s

    def walk(r, c, s):
        while c < nb and rf_[c] == r:
            s = s + seam[c, 0]
            if rl_[c] != r:
                break
            c += 1
        return s
    for blk in range(nb):
        rf, rl = rf_[blk], rl_[blk]
        if rf < 0:
            continue
        if blk == 0 or rl_[blk - 1] != rf:
            s = seam[blk, 0]
            C[rf] = walk(rf, blk + 1, s) if rl == rf else s
        if rl != rf:
            C[rl] = walk(rl, blk + 1, seam[blk, 1])
    return C


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
@pytest.mark.parametrize("block", [8, 64])
@pytest.mark.parametrize("name", ["random_big", "skewed", "empty_rows",
                                  "battery_band_asym", "hub", "empty_run",
                                  "empty_tail"])
def test_plain_and_kernel_mirror_agree(name, block, dtype):
    """The plain version equals the numpy mirror of the kernel bit for
    bit (the same products, the same order of sums, every row written),
    and the host reference within the Wilkinson bound."""
    t, _, B = inputs(name)
    plan = make_plan(CsrLayout.from_csr(t), "merge_path", block_work=block)
    b, fn = spmm_flat.flat_spmm(t, plan, dtype=dtype, device=CPU)
    plain = fn(b, torch.from_numpy(B)).numpy()
    mirror = _emulate_k4(b, B, t.shape, dtype)
    assert not np.isnan(mirror).any()
    np.testing.assert_array_equal(plain, mirror)
    if dtype is None:
        np.testing.assert_allclose(plain, reference.spmm(t, B), rtol=1e-5,
                                   atol=1e-6)
        rep = reference.rigorously_validate_spmm(t, B, plain,
                                                 mxu_bf16=False)
    else:
        rep = reference.rigorously_validate_spmm_bf16(t, B, plain)
    assert rep.verdict == "NOT_A_BUG", rep


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
@pytest.mark.parametrize("name", ["hub_512", "empty_run_512",
                                  "empty_tail_512"])
def test_plain_and_kernel_mirror_agree_at_block_512(name, dtype):
    """The edge cases sized past the kernel's default block of 512 work
    items, at that block: the mirror and the plain version bit for bit,
    and the host reference."""
    t = generate.SPMM_EDGE_CASES[name]()
    B = np.random.default_rng(1).normal(size=(t.shape[1], 24)).astype(
        np.float32)
    plan = make_plan(CsrLayout.from_csr(t), "merge_path", block_work=512)
    b, fn = spmm_flat.flat_spmm(t, plan, dtype=dtype, device=CPU)
    plain = fn(b, torch.from_numpy(B)).numpy()
    mirror = _emulate_k4(b, B, t.shape, dtype)
    assert not np.isnan(mirror).any()
    np.testing.assert_array_equal(plain, mirror)
    if dtype is None:
        np.testing.assert_allclose(plain, reference.spmm(t, B), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_transpose_matches_loops_tpu(name):
    from loops_tpu.models.message_passing import (
        _transpose_csr as jax_transpose,
    )

    t, j, _ = inputs(name)
    tt, jt = _transpose_csr(t), jax_transpose(j)
    assert tt.shape == jt.shape == (j.shape[1], j.shape[0])
    for field in ("offsets", "indices", "vals"):
        np.testing.assert_array_equal(getattr(tt, field), getattr(jt, field))
    np.testing.assert_array_equal(tt.to_dense(), t.to_dense().T)


@pytest.mark.parametrize("corrupt", [False, True])
@pytest.mark.parametrize("name", ["random_big", "skewed", "battery_diag"])
def test_spmm_validator_pinned_to_loops_tpu(name, corrupt):
    """The SpMM half of the validator, from both sides: the same host
    products and the same report for a right and a wrong result."""
    t, j, B = inputs(name)
    for dtype in (np.float32, np.float64):
        np.testing.assert_allclose(reference.spmm(t, B, dtype=dtype),
                                   jref.spmm(j, B, dtype=dtype),
                                   rtol=1e-6, atol=1e-6)
    C = reference.spmm(t, B, dtype=np.float64).astype(np.float32)
    if corrupt:
        C = C.copy()
        C[t.shape[0] // 2, 3] += 0.5
    for bf16 in (True, False):
        mine = reference.rigorously_validate_spmm(t, B, C, mxu_bf16=bf16)
        theirs = jref.rigorously_validate_spmm(j, B, C, mxu_bf16=bf16)
        assert mine.verdict == theirs.verdict
        assert mine.verdict == ("POTENTIAL_BUG" if corrupt else "NOT_A_BUG")
        assert mine.kernel_overruns == theirs.kernel_overruns
        assert mine.f32_baseline_overruns == theirs.f32_baseline_overruns
        assert mine.naive_mismatches == theirs.naive_mismatches
        np.testing.assert_allclose(mine.max_abs_error, theirs.max_abs_error,
                                   rtol=1e-6, atol=1e-12)


def test_bf16_validator_judges_the_sums():
    t, _, B = inputs("random_big")
    p = reference.bf16_products(t, B)
    exact = np.zeros((t.shape[0], F_MAX))
    np.add.at(exact, t.row_ids(), p.astype(np.float64))
    good = exact.astype(np.float32)
    assert reference.rigorously_validate_spmm_bf16(t, B, good).verdict \
        == "NOT_A_BUG"
    # the unrounded f32 result is off by the products' bf16 rounding
    unrounded = reference.spmm(t, B)
    assert reference.rigorously_validate_spmm_bf16(
        t, B, unrounded).verdict == "POTENTIAL_BUG"
    x = np.random.default_rng(0).normal(size=5000).astype(np.float32)
    np.testing.assert_array_equal(
        reference.bf16_round(x),
        torch.from_numpy(x).to(torch.bfloat16).float().numpy())


@pytest.mark.parametrize("schedule,impl", [
    ("row_mapped", "xla"), ("group_mapped", "xla"), ("merge_path", "xla"),
    ("work_oriented", "xla"), ("auto", "xla"), ("merge_path", "pallas")])
@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_empty_matrix_gives_zeros(schedule, impl, dtype):
    # nnz == 0 (loops_tpu raises IndexError staging the merge-path
    # kernel's buffers): C is zeros of shape [rows, F]
    empty = tf.CSR((6, 4), np.zeros(7, np.int64), np.zeros(0, np.int64),
                   np.zeros(0, np.float32))
    op = SpMMOperator(empty, schedule, impl, dtype=dtype, block=8, device=CPU)
    C = op(np.ones((4, 3), np.float32))
    assert tuple(C.shape) == (6, 3) and not C.any()
    assert op.launches == 0


def test_group_mapped_hub_rows_dense_product():
    # rows of >= hub_dense_min nonzeros take the dense matmul path
    t = tf.csr_from_arrays(*_arrays(jgen.skewed_csr(40, 64, heavy_rows=3,
                                                    heavy_nnz=48, seed=2)))
    B = np.random.default_rng(4).normal(size=(64, 12)).astype(np.float32)
    op = SpMMOperator(t, "group_mapped", hub_dense_min=32, device=CPU)
    assert "hub_rows" in op._bufs and len(op._bufs["hub_tiles"]) == 3
    np.testing.assert_allclose(op(B).numpy(), reference.spmm(t, B),
                               rtol=1e-5, atol=1e-5)


def test_refusals():
    t, _, _ = inputs("random")
    with pytest.raises(ValueError, match="merge_path"):
        SpMMOperator(t, "row_mapped", impl="pallas", device=CPU)
    with pytest.raises(ValueError):
        SpMMOperator(t, "sorted_flat", device=CPU)
    with pytest.raises(ValueError):
        SpMMOperator(t, "merge_path", impl="pallas2", device=CPU)
    with pytest.raises(ValueError, match="dtype"):
        SpMMOperator(t, "row_mapped", dtype="float16", device=CPU)
    with pytest.raises(ValueError, match="shape"):
        SpMMOperator(t, "row_mapped", device=CPU)(np.ones((3, 2), np.float32))
    with pytest.raises(NotImplementedError, match="A8"):
        SpMMOperator(t.to_coo(), "row_mapped", device=CPU)
    plan = make_plan(CsrLayout.from_csr(t), "merge_path", block_work=8)
    with pytest.raises(NotImplementedError, match="A10"):
        spmm_flat.flat_spmm(t, plan, pad_R=16, device=CPU)
    with pytest.raises(ValueError, match="CUDA tensor"):
        spmm_flat.flat_spmm_cuda({}, torch.zeros(3, 2), t.shape)


def test_f64_pallas_warns_and_takes_torch_path():
    f64 = generate.random_csr(20, 18, 0.25, seed=13, dtype=np.float64)
    B = np.random.default_rng(2).normal(size=(18, 6))
    with pytest.warns(UserWarning, match="float64"):
        op = SpMMOperator(f64, "merge_path", impl="pallas", device=CPU)
    assert op.impl_used == "torch"
    C = op(B).numpy()
    assert C.dtype == np.float64
    np.testing.assert_allclose(C, reference.spmm(f64, B), rtol=1e-12,
                               atol=1e-12)


def test_feature_tiles():
    # the kernel's tile is 32 * FPL columns: F = 40 takes 64, not 128
    fpl = spmm_flat.features_per_lane
    assert [fpl(F, 256) for F in (1, 5, 32, 33, 40, 64, 65, 128, 500)] == \
        [1, 1, 1, 2, 2, 2, 4, 4, 8]
    assert fpl(128, 64) == 2 and fpl(40, 32) == 1
    with pytest.raises(ValueError, match="block_f"):
        spmm_flat.flat_spmm(*_plan_for("random"), block_f=48, device=CPU)


def _plan_for(name):
    t, _, _ = inputs(name)
    return t, make_plan(CsrLayout.from_csr(t), "merge_path", block_work=8)


def test_spmm_caches_operator():
    t, _, B = inputs("random")
    spmm(t, B, schedule="merge_path", impl="pallas", device=CPU)
    spmm(t, B, schedule="merge_path", impl="pallas", device=CPU)
    spmm(t, B, schedule="row_mapped", device=CPU)
    assert len(t._spmm_ops) == 2
