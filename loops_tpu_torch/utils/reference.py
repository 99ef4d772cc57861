"""Host reference engines + the rigorous (Wilkinson-bound) validator.

Direct functional parity with the reference's correctness backbone
(reference: include/loops/util/reference.hxx:57-388): f32/f64 host SpMV,
the default float tolerance, per-row L1 products, unit roundoff, and the
``rigorously_validate_spmv`` machinery that separates true kernel bugs from
legitimate f32 summation-order noise.

A *correct* f32 kernel may disagree with an f64 reference by up to the
Wilkinson forward-error bound ``K * nnz_row * eps * sum_j |A[r,j] * x[j]|``
per row (any summation order satisfies it); a kernel that overruns the
bound on rows where a plain f32 baseline does not is flagged POTENTIAL_BUG.
This is how kernels whose summation order differs from the sequential
loop (warp trees, segmented scans) are judged. Pure numpy: results from
the device are handed over as host arrays.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# Default elementwise tolerance for f32 SpMV comparisons
# (reference: reference.hxx:115-131).
DEFAULT_ATOL = 1e-2
DEFAULT_RTOL = 1e-3
# Wilkinson constant: bound = max(atol_floor, K * nnz_r * eps * L1_r).
DEFAULT_WILKINSON_K = 4.0
DEFAULT_ATOL_FLOOR = 1e-7


def spmv(csr, x, dtype=None) -> np.ndarray:
    """Host CSR SpMV in the input precision (reference.hxx:57-76)."""
    dtype = dtype or csr.vals.dtype
    y = np.zeros(csr.shape[0], dtype=dtype)
    np.add.at(y, csr.row_ids(),
              csr.vals.astype(dtype) * np.asarray(x, dtype=dtype)[csr.indices])
    return y


def spmv_f64(csr, x) -> np.ndarray:
    """Double-accumulation reference (reference.hxx:146-166)."""
    return spmv(csr, x, dtype=np.float64)


def row_l1_products(csr, x) -> np.ndarray:
    """Per-row sum of |A[r, j] * x[j]| — the conditioning term of the
    Wilkinson bound (reference.hxx:178-198)."""
    l1 = np.zeros(csr.shape[0], dtype=np.float64)
    np.add.at(l1, csr.row_ids(),
              np.abs(csr.vals.astype(np.float64)
                     * np.asarray(x, np.float64)[csr.indices]))
    return l1


def unit_roundoff(dtype=np.float32) -> float:
    """u = eps/2 (reference.hxx:203-214)."""
    return float(np.finfo(dtype).eps) / 2.0


def count_errors(a, b, atol=DEFAULT_ATOL, rtol=DEFAULT_RTOL) -> int:
    """Element-wise mismatch counter (reference.hxx:357-388)."""
    a, b = np.asarray(a), np.asarray(b)
    bad = np.abs(a - b) > (atol + rtol * np.abs(b))
    return int(bad.sum())


@dataclass
class RigorousReport:
    """Output of :func:`rigorously_validate_spmv` (reference.hxx:300-337)."""
    wilkinson_k: float
    naive_mismatches: int        # kernel vs naive f32, default tolerance
    f32_baseline_overruns: int   # naive f32 vs bound (legitimate noise rate)
    kernel_overruns: int         # kernel vs bound (the bug signal)
    max_abs_error: float
    max_rel_error: float

    @property
    def verdict(self) -> str:
        # The Wilkinson bound holds for *any* summation order of a correct
        # kernel, so overrunning it on more rows than the f32 baseline does
        # means the kernel computed something else (reference.hxx:300-337).
        return ("NOT_A_BUG"
                if self.kernel_overruns <= self.f32_baseline_overruns
                else "POTENTIAL_BUG")


def rigorously_validate_spmv(csr, x, y_kernel,
                             k: float = DEFAULT_WILKINSON_K,
                             atol_floor: float = DEFAULT_ATOL_FLOOR,
                             ) -> RigorousReport:
    """Wilkinson per-row validation against the f64 reference
    (reference.hxx:226-337)."""
    y_kernel = np.asarray(y_kernel, np.float64)
    y64 = spmv_f64(csr, x)
    y32 = spmv(csr, x, dtype=np.float32).astype(np.float64)
    nnz_r = csr.row_sizes().astype(np.float64)
    l1 = row_l1_products(csr, x)
    u = unit_roundoff(np.float32)
    bound = np.maximum(atol_floor, k * nnz_r * u * l1)

    err_kernel = np.abs(y_kernel - y64)
    err_naive = np.abs(y32 - y64)
    denom = np.maximum(np.abs(y64), 1e-30)
    return RigorousReport(
        wilkinson_k=k,
        naive_mismatches=count_errors(y_kernel, y32),
        f32_baseline_overruns=int((err_naive > bound).sum()),
        kernel_overruns=int((err_kernel > bound).sum()),
        max_abs_error=float(err_kernel.max(initial=0.0)),
        max_rel_error=float((err_kernel / denom).max(initial=0.0)),
    )
