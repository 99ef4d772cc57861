"""Deterministic synthetic matrix generators.

Parity with the reference's util/generate.hxx:54-113 (seeded uniform
random CSR via random COO + dedup) plus the test-fixture factories from
unittests/test_helpers.hxx:92-225 (identity, banded, block-diagonal,
power-law skewed, empty-row). Every draw comes from numpy
``default_rng(seed)``, so a seed gives the same matrix as ``loops_tpu``.
"""
from __future__ import annotations

import numpy as np

from loops_tpu_torch.formats import BCSR, COO, CSR


def random_csr(rows: int, cols: int, sparsity: float = 0.1,
               seed: int = 0, dtype=np.float32) -> CSR:
    """Uniform random CSR: draw ~rows*cols*sparsity coordinates, dedupe
    (reference: generate.hxx:94-113)."""
    rng = np.random.default_rng(seed)
    n = int(rows * cols * sparsity)
    r = rng.integers(0, rows, size=n)
    c = rng.integers(0, cols, size=n)
    v = rng.uniform(0.0, 1.0, size=n).astype(dtype)
    coo = COO((rows, cols), r, c, v).remove_duplicates(op="first")
    return coo.to_csr()


def identity_csr(n: int, dtype=np.float32) -> CSR:
    i = np.arange(n)
    return CSR((n, n), np.arange(n + 1), i, np.ones(n, dtype=dtype))


def banded_csr(rows: int, cols: int, band: int = 1, seed: int = 0,
               dtype=np.float32) -> CSR:
    """Banded matrix: nonzeros at |col - row| <= band (asymmetric shapes
    allowed)."""
    rng = np.random.default_rng(seed)
    r = np.repeat(np.arange(rows), 2 * band + 1)
    c = (np.tile(np.arange(-band, band + 1), rows) + r)
    keep = (c >= 0) & (c < cols)
    r, c = r[keep], c[keep]
    v = rng.uniform(-1.0, 1.0, size=len(r)).astype(dtype)
    return COO((rows, cols), r, c, v).to_csr()


def block_diag_csr(num_blocks: int, block: int, seed: int = 0,
                   dtype=np.float32) -> CSR:
    """Dense blocks along the diagonal."""
    rng = np.random.default_rng(seed)
    n = num_blocks * block
    base = np.arange(block)
    r = (np.repeat(np.arange(num_blocks), block * block) * block
         + np.tile(np.repeat(base, block), num_blocks))
    c = (np.repeat(np.arange(num_blocks), block * block) * block
         + np.tile(np.tile(base, block), num_blocks))
    v = rng.uniform(-1.0, 1.0, size=len(r)).astype(dtype)
    return COO((n, n), r, c, v).to_csr()


def skewed_csr(rows: int, cols: int, heavy_rows: int = 1,
               heavy_nnz: int | None = None, light_nnz: int = 2,
               seed: int = 0, dtype=np.float32) -> CSR:
    """Power-law-style load-balance stress: a few rows carry most of the
    nonzeros (reference test_helpers.hxx make_skewed_csr)."""
    rng = np.random.default_rng(seed)
    heavy_nnz = heavy_nnz if heavy_nnz is not None else max(cols // 2, 4)
    rs, cs = [], []
    for i in range(rows):
        k = heavy_nnz if i < heavy_rows else light_nnz
        k = min(k, cols)
        cs.append(rng.choice(cols, size=k, replace=False))
        rs.append(np.full(k, i))
    r = np.concatenate(rs)
    c = np.concatenate(cs)
    v = rng.uniform(-1.0, 1.0, size=len(r)).astype(dtype)
    return COO((rows, cols), r, c, v).to_csr()


def empty_row_csr(rows: int, cols: int, every: int = 3, seed: int = 0,
                  dtype=np.float32) -> CSR:
    """Every ``every``-th row is empty — the binary-search / planner edge
    case (reference test_helpers.hxx make_empty_row_csr)."""
    rng = np.random.default_rng(seed)
    rs, cs = [], []
    for i in range(rows):
        if i % every == 0:
            continue
        k = min(1 + int(rng.integers(0, 3)), cols)
        cs.append(rng.choice(cols, size=k, replace=False))
        rs.append(np.full(k, i))
    if not rs:
        return COO((rows, cols), [], [], []).to_csr()
    r = np.concatenate(rs)
    c = np.concatenate(cs)
    v = rng.uniform(-1.0, 1.0, size=len(r)).astype(dtype)
    return COO((rows, cols), r, c, v).to_csr()


def tridiag_csr(n: int, seed: int = 0, dtype=np.float32) -> CSR:
    return banded_csr(n, n, band=1, seed=seed, dtype=dtype)


def diag_csr(n: int, seed: int = 0, dtype=np.float32) -> CSR:
    rng = np.random.default_rng(seed)
    i = np.arange(n)
    return CSR((n, n), np.arange(n + 1), i,
               rng.uniform(0.5, 1.5, size=n).astype(dtype))


def wide_span_csr(rows: int, cols: int = 4, seed: int = 0,
                  dtype=np.float32) -> CSR:
    """Nonzeros in the first and the last row only, every row between
    empty: one work_oriented block spans all the rows (the row-window edge
    case of the flat kernels)."""
    rng = np.random.default_rng(seed)
    offsets = np.ones(rows + 1, np.int64)
    offsets[0], offsets[-1] = 0, 2
    return CSR((rows, cols), offsets, np.array([0, cols - 1]),
               rng.uniform(-1.0, 1.0, size=2).astype(dtype))


def sized_csr(sizes, cols: int, seed: int = 0, dtype=np.float32) -> CSR:
    """A CSR with the given row sizes, distinct sorted columns per row and
    normal values, from ``seed``."""
    rng = np.random.default_rng(seed)
    idx = [np.sort(rng.choice(cols, n, replace=False)) for n in sizes]
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    indices = np.concatenate(idx).astype(np.int64)
    return CSR((len(sizes), cols), offsets, indices,
               rng.normal(size=len(indices)).astype(dtype))


def build_block_sparse(N: int = 4096, R: int = 8, C: int = 128,
                       block_density: float = 0.06, seed: int = 0):
    """The JAX bench's block-sparse matrix (``bench.py``
    ``build_block_sparse``): an N x N matrix of dense R x C blocks at
    ``block_density`` of the block grid, N(0, 1) values. Returns
    ``(csr, bcsr)``; the same seed gives ``loops_tpu``'s matrix."""
    rng = np.random.default_rng(seed)
    nbr, nbc = N // R, N // C
    nb = int(nbr * nbc * block_density)
    br = rng.integers(0, nbr, nb)
    bc = rng.integers(0, nbc, nb)
    key = np.unique(br.astype(np.int64) * nbc + bc)
    br = (key // nbc).astype(np.int32)
    bc = (key % nbc).astype(np.int32)
    nb = len(key)
    rr = np.repeat(br * R, R * C) + np.tile(np.repeat(np.arange(R), C), nb)
    cc = np.repeat(bc * C, R * C) + np.tile(np.tile(np.arange(C), R), nb)
    vv = rng.normal(size=nb * R * C).astype(np.float32)
    csr = COO((N, N), rr, cc, vv).to_csr()
    return csr, BCSR.from_csr(csr, R, C)


def make_input_vector(n: int, seed: int = 1, dtype=np.float32) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.uniform(-1.0, 1.0, size=n).astype(dtype)


# The 9-matrix SpMV correctness battery (name -> builder), the recipes of
# the reference's unittests/test_spmv_battery.hxx:52-94.
BATTERY = {
    "identity": lambda: identity_csr(16),
    "diag": lambda: diag_csr(11),
    "tridiag": lambda: tridiag_csr(17),
    "band_asym": lambda: banded_csr(12, 20, band=2),
    "block_diag_2x2": lambda: block_diag_csr(5, 2),
    "block_diag_3x3": lambda: block_diag_csr(4, 3),
    "skewed": lambda: skewed_csr(14, 24, heavy_rows=2),
    "empty_rows": lambda: empty_row_csr(15, 9),
    "random": lambda: random_csr(21, 18, 0.2, seed=11),
}

# The five matrices of the BCSR kernel tests (``loops_tpu``'s
# tests/test_bcsr_kernels.py): empty block rows, ragged edges, one dense
# block diagonal, and a tall matrix of many block rows.
BCSR_CASES = {
    "random": lambda: random_csr(40, 36, 0.15, seed=11),
    "skewed": lambda: skewed_csr(24, 30, heavy_rows=3),
    "empty_rows": lambda: empty_row_csr(21, 18),
    "block_diag": lambda: block_diag_csr(5, 4),
    "tall": lambda: random_csr(600, 300, 0.02, seed=2),
}

# The merge-path SpMM's edge cases (K4): one row over several warps of a
# block and several blocks; a run of empty rows longer than a block's
# work; empty rows at the end. The first three at blocks of 8 and 64 work
# items, the ``_512`` ones past the kernel's default of 512.
SPMM_EDGE_CASES = {
    "hub": lambda: sized_csr([2, 0, 3, 1, 2, 150, 1, 0, 3, 2, 1, 2, 0, 3,
                              1, 2, 1, 3, 0, 2, 1, 2, 3, 1], 200, seed=21),
    "empty_run": lambda: sized_csr([3] * 10 + [0] * 130 + [2] * 10, 30,
                                   seed=22),
    "empty_tail": lambda: sized_csr([2, 3, 1, 4] * 8 + [0] * 10, 30, seed=23),
    "hub_512": lambda: sized_csr([2, 0, 3, 1, 2, 2900, 1, 0, 3, 2] * 3, 3000,
                                 seed=24),
    "empty_run_512": lambda: sized_csr([3] * 40 + [0] * 1300 + [2] * 40, 30,
                                       seed=25),
    "empty_tail_512": lambda: sized_csr([2, 3, 1, 4] * 50 + [0] * 700, 30,
                                        seed=26),
}
