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
loop (warp trees, segmented scans) are judged. The SpMM half applies the
same bound per (row, feature) entry, the SDDMM half per nonzero over its
F products. Host code only (numpy, and
scipy.sparse for the SpMM products): results from the device are handed
over as host arrays.
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


def _scipy_csr(csr, dtype, absolute: bool = False):
    from scipy.sparse import csr_matrix

    vals = csr.vals.astype(dtype)
    return csr_matrix((np.abs(vals) if absolute else vals, csr.indices,
                       csr.offsets), shape=csr.shape)


def spmm(csr, B, dtype=None) -> np.ndarray:
    """Host CSR x dense SpMM: C[r, :] = sum_nz vals * B[col, :], each row
    summed in storage order in ``dtype`` (scipy's CSR product: the same
    sums as ``loops_tpu``'s ``np.add.at`` loop, without the [nnz, F]
    product array, so the validator stays quick at full width)."""
    B = np.asarray(B)
    dtype = dtype or np.result_type(csr.vals.dtype, B.dtype)
    return np.asarray(_scipy_csr(csr, dtype) @ B.astype(dtype), dtype)


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
    return spmv_judge(csr, x, k, atol_floor)(y_kernel)


def spmv_judge(csr, x, k: float = DEFAULT_WILKINSON_K,
               atol_floor: float = DEFAULT_ATOL_FLOOR):
    """``rigorously_validate_spmv`` with its host references (the f64 and
    naive f32 products, the per-row bound) computed once: returns
    ``judge(y_kernel) -> RigorousReport``, for many results on one
    ``(csr, x)``."""
    y64 = spmv_f64(csr, x)
    y32 = spmv(csr, x, dtype=np.float32).astype(np.float64)
    nnz_r = csr.row_sizes().astype(np.float64)
    l1 = row_l1_products(csr, x)
    u = unit_roundoff(np.float32)
    bound = np.maximum(atol_floor, k * nnz_r * u * l1)

    def judge(y_kernel) -> RigorousReport:
        return _report(k, np.asarray(y_kernel, np.float64), y64, y32, bound)
    return judge


def spmm_l1_products(csr, B) -> np.ndarray:
    """Per-entry ``sum_nz |v * B[col, f]|``: the conditioning term of the
    SpMM bound, as ``|A| @ |B|`` in f64."""
    return np.asarray(_scipy_csr(csr, np.float64, absolute=True)
                      @ np.abs(np.asarray(B, np.float64)))


def rigorously_validate_spmm(csr, B, C_kernel,
                             k: float = DEFAULT_WILKINSON_K,
                             atol_floor: float = DEFAULT_ATOL_FLOOR,
                             mxu_bf16: bool = True) -> RigorousReport:
    """Wilkinson validation for SpMM, per (row, feature) entry.

    The same forward-error bound applies column-wise —
    ``|C[r,f] - C64[r,f]| <= K * nnz_r * u * sum_nz |v * B[col, f]|``.
    ``mxu_bf16=True`` widens u 256-fold, ``loops_tpu``'s constant for its
    default-precision MXU paths (still far below bf16's own roundoff: the
    bf16 mode is judged by ``rigorously_validate_spmm_bf16``); ``False``
    holds an f32 path to the f32 roundoff.
    """
    B = np.asarray(B)
    C_kernel = np.asarray(C_kernel, np.float64)
    C64 = spmm(csr, B, dtype=np.float64)
    C32 = spmm(csr, B, dtype=np.float32).astype(np.float64)
    nnz_r = csr.row_sizes().astype(np.float64)[:, None]
    u = (float(np.finfo(np.float32).eps) * 256.0 / 2.0 if mxu_bf16
         else unit_roundoff(np.float32))
    bound = np.maximum(atol_floor, k * nnz_r * u * spmm_l1_products(csr, B))
    return _report(k, C_kernel, C64, C32, bound)


def bf16_round(x) -> np.ndarray:
    """float32 values rounded to the nearest bfloat16 (ties to even),
    returned as float32 — the rounding of ``tensor.to(torch.bfloat16)``
    and of CUDA's ``__float2bfloat16_rn`` for finite values (which stay
    below 2**32 in the uint32 sum)."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    u = (u + np.uint32(0x7FFF) + ((u >> 16) & np.uint32(1))) \
        & np.uint32(0xFFFF0000)
    return u.view(np.float32)


def bf16_products(csr, B) -> np.ndarray:
    """[nnz, F] float32: ``bf16(bf16(v) * bf16(B[col, :]))``, the products
    of the SpMM bf16 mode, in CSR order."""
    v = bf16_round(csr.vals)
    Bb = bf16_round(np.asarray(B, np.float32))
    return bf16_round(v[:, None] * Bb[csr.indices])


def rigorously_validate_spmm_bf16(csr, B, C_kernel,
                                  k: float = DEFAULT_WILKINSON_K,
                                  atol_floor: float = DEFAULT_ATOL_FLOOR
                                  ) -> RigorousReport:
    """Wilkinson validation of the SpMM bf16 mode, per entry, over its
    bf16-rounded products: the mode rounds vals, B and each product to
    bf16 by definition, so what is judged is the f32 summation —
    ``|C[r,f] - sum_nz p| <= K * nnz_r * u32 * sum_nz |p|`` with the exact
    sum taken in f64. (``rigorously_validate_spmm`` judges against the
    unrounded inputs, whose bf16 rounding no f32 bound covers.)"""
    B = np.asarray(B, np.float32)
    rows, F = csr.shape[0], B.shape[1]
    C64 = np.zeros((rows, F))
    C32 = np.zeros((rows, F), np.float32)
    l1 = np.zeros((rows, F))
    nz = np.nonzero(csr.row_sizes())[0]
    starts = csr.offsets[nz]
    for f0 in range(0, F if len(nz) else 0, 32):  # bounded host memory
        cols = slice(f0, min(f0 + 32, F))
        p = bf16_products(csr, B[:, cols])
        C64[nz, cols] = np.add.reduceat(p.astype(np.float64), starts, axis=0)
        C32[nz, cols] = np.add.reduceat(p, starts, axis=0)
        l1[nz, cols] = np.add.reduceat(np.abs(p).astype(np.float64), starts,
                                       axis=0)
    nnz_r = csr.row_sizes().astype(np.float64)[:, None]
    bound = np.maximum(atol_floor,
                       k * nnz_r * unit_roundoff(np.float32) * l1)
    return _report(k, np.asarray(C_kernel, np.float64), C64,
                   C32.astype(np.float64), bound)


@dataclass
class SampledRowsReport:
    """Output of :func:`validate_sampled_rows`."""
    rows: int            # rows checked
    rel_error: float     # max |C - C64| / max |C64| over those rows
    overruns: int        # entries past the f32 Wilkinson bound


def validate_sampled_rows(csr, B, C, n: int = 256, seed: int = 7,
                          k: float = DEFAULT_WILKINSON_K,
                          atol_floor: float = DEFAULT_ATOL_FLOOR,
                          bf16_products: bool = False
                          ) -> SampledRowsReport:
    """SpMM check at bench scale, where the full validator's host
    products take too long: ``n`` rows drawn from ``seed`` (the JAX
    bench's ``check_correctness`` draw), each summed in f64 and held to
    the f32 Wilkinson bound ``K * nnz_r * u32 * sum |v * B[col, f]|``.
    ``C`` may be a card tensor: only the drawn rows are copied back. A
    bf16 mode whose products are exact in f32 is judged over its rounded
    operands (pass the rounded vals and B); ``bf16_products`` judges the
    SpMM bf16 mode, which rounds vals, B and each product to bf16, over
    those rounded products (as ``rigorously_validate_spmm_bf16``)."""
    return sampled_rows_judge(csr, B, n, seed, k, atol_floor,
                              bf16_products)(C)


def sampled_rows_judge(csr, B, n: int = 256, seed: int = 7,
                       k: float = DEFAULT_WILKINSON_K,
                       atol_floor: float = DEFAULT_ATOL_FLOOR,
                       bf16_products: bool = False):
    """``validate_sampled_rows`` with its host sums computed once: returns
    ``judge(C, slack=0.0) -> SampledRowsReport`` for many results on one
    ``(csr, B)``. ``slack`` widens the bound by ``slack * sum |p|`` (one
    more rounding of each product, for a route that forms some products
    in another precision)."""
    chk, ref, l1 = sampled_rows_reference(csr, B, n, seed, bf16_products)
    nnz_r = csr.row_sizes()[chk].astype(np.float64)[:, None]
    bound = np.maximum(atol_floor, k * nnz_r * unit_roundoff(np.float32)
                       * l1)

    def judge(C, slack: float = 0.0) -> SampledRowsReport:
        if hasattr(C, "cpu"):
            import torch
            C = C[torch.from_numpy(chk).to(C.device)].cpu().numpy()
        else:
            C = np.asarray(C)[chk]
        err = np.abs(np.asarray(C, np.float64) - ref)
        return SampledRowsReport(
            rows=len(chk),
            rel_error=float(err.max(initial=0.0)
                            / max(np.abs(ref).max(initial=0.0), 1e-9)),
            overruns=int((err > bound + slack * l1).sum()))
    return judge


def sampled_rows_reference(csr, B, n: int = 256, seed: int = 7,
                           bf16_products: bool = False):
    """``(rows, sums, l1)`` of ``validate_sampled_rows``: the ``n`` rows
    drawn from ``seed``, their f64 sums and ``sum |p|`` per entry."""
    rng = np.random.default_rng(seed)
    chk = np.sort(rng.choice(csr.shape[0], min(n, csr.shape[0]),
                             replace=False))
    if bf16_products:
        B16 = bf16_round(np.asarray(B, np.float32))
    B = np.asarray(B, np.float64)
    ref = np.zeros((len(chk), B.shape[1]))
    l1 = np.zeros_like(ref)
    for i, r in enumerate(chk):
        a0, a1 = csr.offsets[r], csr.offsets[r + 1]
        if bf16_products:
            v = bf16_round(np.asarray(csr.vals[a0:a1], np.float32))
            p = bf16_round(v[:, None] * B16[csr.indices[a0:a1]]).astype(
                np.float64)
        else:
            p = (csr.vals[a0:a1, None].astype(np.float64)
                 * B[csr.indices[a0:a1]])
        ref[i] = p.sum(0)
        l1[i] = np.abs(p).sum(0)
    return chk, ref, l1


def sddmm(csr, A, B) -> np.ndarray:
    """Host SDDMM: ``out_nz = vals_nz * <A[row_nz, :], B[col_nz, :]>`` in
    f64, per nonzero in CSR order (``loops_tpu``'s ``reference.sddmm``)."""
    A, B = np.asarray(A, np.float64), np.asarray(B, np.float64)
    dots = np.einsum("ij,ij->i", A[csr.row_ids()], B[csr.indices])
    return csr.vals.astype(np.float64) * dots


SDDMM_OPERANDS = (None, "bfloat16")


def sddmm_terms(csr, A, B, nz, operands=None) -> np.ndarray:
    """[len(nz), F] float64: the terms whose sum is nonzero ``nz``'s
    SDDMM value. ``operands=None``: ``vals * A[r, f] * B[c, f]``.
    ``"bfloat16"``: the terms of the card's bf16 kernel (K5),
    ``bf16(A[r, f]) * bf16(vals * bf16(B[c, f]))``, each exact in f32."""
    if operands not in SDDMM_OPERANDS:
        raise ValueError(f"operands={operands!r}: expected one of "
                         f"{SDDMM_OPERANDS}")
    nz = np.asarray(nz, np.int64)
    rows = np.searchsorted(csr.offsets, nz, side="right") - 1
    cols = csr.indices[nz]
    if operands is None:
        v = csr.vals[nz].astype(np.float64)[:, None]
        return (v * np.asarray(A, np.float64)[rows]
                * np.asarray(B, np.float64)[cols])
    v = csr.vals[nz].astype(np.float32)[:, None]
    a = bf16_round(np.asarray(A, np.float32)[rows])
    g = bf16_round(v * bf16_round(np.asarray(B, np.float32)[cols]))
    return a.astype(np.float64) * g


def sddmm_bound(terms, k: float = DEFAULT_WILKINSON_K,
                atol_floor: float = DEFAULT_ATOL_FLOOR) -> np.ndarray:
    """The Wilkinson bound of each nonzero's f32 dot over its ``terms``:
    ``K * F * u32 * sum_f |term|``, floor ``atol_floor``."""
    F = terms.shape[1]
    return np.maximum(atol_floor, k * F * unit_roundoff(np.float32)
                      * np.abs(terms).sum(axis=1))


def rigorously_validate_sddmm(csr, A, B, out, operands=None,
                              k: float = DEFAULT_WILKINSON_K,
                              atol_floor: float = 1e-6,
                              chunk: int = 1 << 16) -> RigorousReport:
    """Wilkinson validation of SDDMM, per nonzero:
    ``|out - exact| <= K * F * u32 * |v| * sum_f |A[r,f] * B[c,f]|``
    (floor 1e-6), the exact value in f64. With ``operands="bfloat16"`` the
    bound is over the bf16 kernel's rounded terms (see ``sddmm_terms``),
    whose rounding is the mode's definition, as
    ``rigorously_validate_spmm_bf16`` does for K4; what is judged is the
    f32 sum. The f32 baseline sums the same terms in f32, in order. The
    nonzeros are taken ``chunk`` at a time, so host memory stays bounded."""
    out = np.asarray(out, np.float64)
    exact = np.zeros(csr.nnz)
    naive = np.zeros(csr.nnz)
    bound = np.zeros(csr.nnz)
    for e0 in range(0, csr.nnz, chunk):
        nz = np.arange(e0, min(e0 + chunk, csr.nnz))
        t = sddmm_terms(csr, A, B, nz, operands)
        exact[nz] = t.sum(axis=1)
        naive[nz] = t.astype(np.float32).sum(axis=1, dtype=np.float32)
        bound[nz] = sddmm_bound(t, k, atol_floor)
    return _report(k, out, exact, naive, bound)


@dataclass
class SampledNonzerosReport:
    """Output of :func:`validate_sampled_sddmm`."""
    nonzeros: int        # nonzeros checked
    rel_error: float     # max |out - exact| / max |exact| over them
    overruns: int        # nonzeros past the f32 Wilkinson bound


def validate_sampled_sddmm(csr, A, B, out, n: int = 4096, seed: int = 7,
                           operands=None, k: float = DEFAULT_WILKINSON_K,
                           atol_floor: float = 1e-6
                           ) -> SampledNonzerosReport:
    """SDDMM check at bench scale: ``n`` nonzeros drawn from ``seed``, each
    summed in f64 and held to the bound of ``rigorously_validate_sddmm``.
    ``out`` may be a card tensor: only the drawn values are copied back."""
    rng = np.random.default_rng(seed)
    nz = np.sort(rng.choice(csr.nnz, min(n, csr.nnz), replace=False))
    t = sddmm_terms(csr, A, B, nz, operands)
    exact = t.sum(axis=1)
    if hasattr(out, "cpu"):
        import torch
        got = out[torch.from_numpy(nz).to(out.device)].cpu().numpy()
    else:
        got = np.asarray(out)[nz]
    err = np.abs(np.asarray(got, np.float64) - exact)
    return SampledNonzerosReport(
        nonzeros=len(nz),
        rel_error=float(err.max(initial=0.0)
                        / max(np.abs(exact).max(initial=0.0), 1e-9)),
        overruns=int((err > sddmm_bound(t, k, atol_floor)).sum()))


def _report(k, kernel, exact, naive, bound) -> RigorousReport:
    err_kernel = np.abs(kernel - exact)
    err_naive = np.abs(naive - exact)
    denom = np.maximum(np.abs(exact), 1e-30)
    return RigorousReport(
        wilkinson_k=k,
        naive_mismatches=count_errors(kernel, naive),
        f32_baseline_overruns=int((err_naive > bound).sum()),
        kernel_overruns=int((err_kernel > bound).sum()),
        max_abs_error=float(err_kernel.max(initial=0.0)),
        max_rel_error=float((err_kernel / denom).max(initial=0.0)),
    )
