"""The BCSR slice of the port as a whole: ``SpMVOperator`` (``xla``,
``pallas`` = K6) and ``SpMMOperator`` (``xla``, ``pallas`` = K9,
``pallas2`` = K8, ``pallas3`` = K7) against ``loops_tpu``'s ``spmv`` /
``spmm`` with the same impl, on the same numpy inputs. The JAX side runs
as ``tests/test_bcsr_kernels.py`` runs it on the CPU: its Pallas kernels
in interpret mode. On the CPU the port's wrappers run their plain
versions.

Cases: the five matrices of ``tests/test_bcsr_kernels.py``, blocks
8 x 128 and 16 x 128, F in {20, 300} with ``block_f=128`` (300 spans
three of the TPU kernels' feature tiles). ``loops_tpu`` runs once per
case at F = 300; F = 20 compares the leading columns (each column of C
is its own sum).

Tolerances. f32: ``atol=1e-3, rtol=1e-4`` against ``loops_tpu``, as its
own test holds its kernels to the host reference, and ``NOT_A_BUG`` from
the f32 Wilkinson validator. bf16 (``pallas2``, ``pallas3``): both sides
round A and B to bf16 and sum the exact products in f32, so against
``loops_tpu``'s bf16 the bound is twice the f32 Wilkinson bound over the
rounded operands, floor 1e-6; the validator over the rounded operands
gives ``NOT_A_BUG``; and against the f32 reference ``rel < 2e-2``
(``test_bcsr_kernels.py``'s bound for one bf16 rounding of the streams).
"""
import functools

import numpy as np
import pytest
import torch

import loops_tpu.utils.generate as jgen
import loops_tpu_torch.formats as tf
from loops_tpu.formats import BCSR as JaxBCSR
from loops_tpu.ops import spmm as jax_spmm, spmv as jax_spmv
from loops_tpu_torch.formats import BCSR, CSR
from loops_tpu_torch.ops.spmm import SpMMOperator
from loops_tpu_torch.ops.spmv import SpMVOperator
from loops_tpu_torch.utils import reference

CPU = torch.device("cpu")
BF16 = "bfloat16"
F_MAX = 300
FS = [20, 300]
BLOCKS = [(8, 128), (16, 128)]
MATRICES = {
    "random": lambda: jgen.random_csr(40, 36, 0.15, seed=11),
    "skewed": lambda: jgen.skewed_csr(24, 30, heavy_rows=3),
    "empty_rows": lambda: jgen.empty_row_csr(21, 18),
    "block_diag": lambda: jgen.block_diag_csr(5, 4),
    "tall": lambda: jgen.random_csr(600, 300, 0.02, seed=2),
}
SPMM_IMPLS = [("xla", None), ("pallas", None), ("pallas2", None),
              ("pallas3", None), ("pallas2", BF16), ("pallas3", BF16)]
KERNEL_OF = {"pallas": "bcsr_spmm", "pallas2": "bcsr_spmm_v2",
             "pallas3": "bcsr_spmm_v3"}


@functools.lru_cache(maxsize=None)
def inputs(name, block):
    """(port CSR, port BCSR, loops_tpu BCSR, B [cols, F_MAX], x)."""
    j = MATRICES[name]()
    t = tf.csr_from_arrays(j.shape, j.offsets, j.indices, j.vals)
    rng = np.random.default_rng(3)
    B = rng.normal(size=(j.shape[1], F_MAX)).astype(np.float32)
    x = rng.uniform(-1, 1, size=j.shape[1]).astype(np.float32)
    return t, BCSR.from_csr(t, *block), JaxBCSR.from_csr(j, *block), B, x


@functools.lru_cache(maxsize=None)
def jax_spmm_result(name, block, impl, dtype):
    _, _, jb, B, _ = inputs(name, block)
    return np.asarray(jax_spmm(jb, B, impl=impl, block_f=128, dtype=dtype))


def _rounded(t, B):
    return (CSR(t.shape, t.offsets, t.indices, reference.bf16_round(t.vals)),
            reference.bf16_round(B))


@pytest.mark.parametrize("F", FS)
@pytest.mark.parametrize("impl,dtype", SPMM_IMPLS)
@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_spmm_matches_loops_tpu(name, block, impl, dtype, F):
    t, tb, _, B_all, _ = inputs(name, block)
    B = np.ascontiguousarray(B_all[:, :F])
    op = SpMMOperator(tb, "row_mapped", impl, block_f=128, dtype=dtype,
                      device=CPU)
    assert op.impl_used == KERNEL_OF.get(impl, "torch")
    C = op(B)
    assert isinstance(C, torch.Tensor) and C.dtype == torch.float32
    assert tuple(C.shape) == (t.shape[0], F) and op.launches == 0
    C = C.numpy()
    want = jax_spmm_result(name, block, impl, dtype)[:, :F]
    if dtype is None:
        np.testing.assert_allclose(C, want, atol=1e-3, rtol=1e-4)
        rep = reference.rigorously_validate_spmm(t, B, C, mxu_bf16=False)
    else:
        rt, rB = _rounded(t, B)
        nnz_r = t.row_sizes().astype(np.float64)[:, None]
        tol = np.maximum(1e-6, 2 * reference.DEFAULT_WILKINSON_K * nnz_r
                         * reference.unit_roundoff(np.float32)
                         * reference.spmm_l1_products(rt, rB))
        assert np.all(np.abs(C.astype(np.float64) - want) <= tol)
        rep = reference.rigorously_validate_spmm(rt, rB, C, mxu_bf16=False)
        ref = reference.spmm(t, B)
        assert np.abs(C - ref).max() / max(np.abs(ref).max(), 1e-9) < 2e-2
    assert rep.verdict == "NOT_A_BUG", rep


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_spmv_matches_loops_tpu(name, block, impl):
    t, tb, jb, _, x = inputs(name, block)
    op = SpMVOperator(tb, impl=impl, device=CPU)
    assert op.impl_used == ("bcsr_spmv" if impl == "pallas" else "torch")
    assert op.schedule == "row_mapped"
    y = op(x)
    assert y.dtype == torch.float32 and op.launches == 0
    y = y.numpy()
    np.testing.assert_allclose(y, np.asarray(jax_spmv(jb, x, impl=impl)),
                               atol=1e-3, rtol=1e-4)
    assert reference.rigorously_validate_spmv(t, x, y).verdict == "NOT_A_BUG"


def test_auto_schedule_and_operator_cache():
    t, tb, _, B, x = inputs("random", (8, 128))
    op = SpMMOperator(tb, "auto", "pallas3", device=CPU)
    assert op.schedule == "row_mapped"
    assert SpMVOperator(tb, "auto", device=CPU).schedule == "row_mapped"
    from loops_tpu_torch.ops.spmm import spmm
    from loops_tpu_torch.ops.spmv import spmv
    spmm(tb, B, impl="pallas3", device=CPU)
    spmm(tb, B, impl="pallas3", device=CPU)
    spmv(tb, x, impl="pallas", device=CPU)
    assert len(tb._spmm_ops) == 1 and len(tb._spmv_ops) == 1
