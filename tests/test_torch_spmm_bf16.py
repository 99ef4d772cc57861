"""The SpMM bf16 mode (``dtype="bfloat16"``) of the port against
``loops_tpu``'s, on the cases of ``test_torch_spmm.py``: every schedule,
blocks 8 and 64 for the merge-path kernel K4, F in {5, 16, 40}.

The mode rounds vals and B to bf16, rounds each product to bf16, and sums
in f32. K4's Pallas kernel does the same (its products are staged in
bf16), so against it the tolerance is the Wilkinson bound computed over
the bf16-rounded products p, twice over (both sides sum in f32, in other
orders): ``2 * 4 * nnz_r * u32 * sum |p|``, floor 1e-6. ``loops_tpu``'s
XLA paths write the same rounding, but XLA on the CPU fuses the product
with its conversion back to f32 and keeps the product unrounded; against
those paths the tolerance adds one bf16 rounding of each product,
``u_bf16 * sum |p|`` with ``u_bf16 = 2**-8``. The port's result must
also pass the validator over the rounded products
(``rigorously_validate_spmm_bf16``).
"""
import numpy as np
import pytest

from loops_tpu_torch.utils import reference
from test_torch_spmm import (
    BLOCKS,
    FS,
    MATRICES,
    XLA_SCHEDULES,
    jax_result,
    port_result,
)

BF16 = "bfloat16"
U32 = reference.unit_roundoff(np.float32)
U_BF16 = 2.0 ** -8


def check_bf16(name, schedule, impl, block, F):
    t, B, C = port_result(name, schedule, impl, block, BF16, F)
    want = jax_result(name, schedule, impl, block, BF16)[:, :F]
    p = reference.bf16_products(t, B)
    l1 = np.zeros(C.shape)
    np.add.at(l1, t.row_ids(), np.abs(p).astype(np.float64))
    nnz_r = t.row_sizes().astype(np.float64)[:, None]
    tol = np.maximum(1e-6, 2 * reference.DEFAULT_WILKINSON_K * nnz_r * U32
                     * l1)
    if impl != "pallas":
        tol = tol + U_BF16 * l1
    diff = np.abs(C.astype(np.float64) - want)
    assert np.all(diff <= tol), (
        f"{schedule}/{impl}/{name}: max excess {(diff - tol).max():.3e}")
    rep = reference.rigorously_validate_spmm_bf16(t, B, C)
    assert rep.verdict == "NOT_A_BUG", rep


@pytest.mark.parametrize("F", FS)
@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_merge_path_kernel_bf16_matches_loops_tpu(name, block, F):
    check_bf16(name, "merge_path", "pallas", block, F)


@pytest.mark.parametrize("F", FS)
@pytest.mark.parametrize("schedule", XLA_SCHEDULES)
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_torch_schedules_bf16_match_loops_tpu(name, schedule, F):
    check_bf16(name, schedule, "xla", 512, F)
