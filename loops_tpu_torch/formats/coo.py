"""COO (coordinate) container.

Functional parity with the reference's ``coo_t`` (reference:
include/loops/container/coo.hxx:38-165): sort-by-row / sort-by-column,
duplicate removal, CSR round-trip — all as vectorized numpy.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from loops_tpu_torch.formats import convert
from loops_tpu_torch.formats.base import (
    as_index_array,
    as_value_array,
    check_shape,
)


@dataclass
class COO:
    shape: tuple
    rows: np.ndarray  # [nnz] row index per nonzero
    cols: np.ndarray  # [nnz] col index per nonzero
    vals: np.ndarray  # [nnz]

    def __post_init__(self):
        self.shape = check_shape(self.shape)
        self.rows = as_index_array(self.rows, "row indices")
        self.cols = as_index_array(self.cols, "col indices")
        self.vals = as_value_array(self.vals)
        if not (len(self.rows) == len(self.cols) == len(self.vals)):
            raise ValueError("COO arrays must have equal length")

    @property
    def nnz(self) -> int:
        return len(self.vals)

    # -- reorderings (reference: coo.hxx:104-122) --------------------------
    def _row_major_order(self) -> np.ndarray | None:
        """Permutation of a stable (row, col) sort, or None when the
        entries are already in that order (the permutation would be the
        identity, so the sort is skipped)."""
        key = self.rows.astype(np.int64) * max(self.shape[1], 1) + self.cols
        if key.size < 2 or bool((key[1:] >= key[:-1]).all()):
            return None
        return convert.lexsort2(self.cols, self.rows, self.shape[1],
                                self.shape[0])

    def sort_by_row(self) -> "COO":
        """Stable (row, col) lexicographic sort."""
        perm = self._row_major_order()
        if perm is None:
            return COO(self.shape, self.rows, self.cols, self.vals)
        return COO(self.shape, self.rows[perm], self.cols[perm], self.vals[perm])

    def sort_by_column(self) -> "COO":
        """Stable (col, row) lexicographic sort."""
        perm = convert.lexsort2(self.rows, self.cols, self.shape[0],
                                self.shape[1])
        return COO(self.shape, self.rows[perm], self.cols[perm], self.vals[perm])

    def remove_duplicates(self, op: str = "first") -> "COO":
        """Drop duplicate (row, col) entries.

        ``op='first'`` keeps the first occurrence (reference semantics,
        coo.hxx:128-145 via unique_by_key); ``op='sum'`` accumulates.
        """
        c = self.sort_by_row()
        if c.nnz == 0:
            return c
        keys = c.rows.astype(np.int64) * self.shape[1] + c.cols
        uniq_mask = np.empty(c.nnz, dtype=bool)
        uniq_mask[0] = True
        np.not_equal(keys[1:], keys[:-1], out=uniq_mask[1:])
        if op == "first":
            return COO(self.shape, c.rows[uniq_mask], c.cols[uniq_mask],
                       c.vals[uniq_mask])
        elif op == "sum":
            seg = np.cumsum(uniq_mask) - 1
            out = np.zeros(int(seg[-1]) + 1, dtype=c.vals.dtype)
            np.add.at(out, seg, c.vals)
            return COO(self.shape, c.rows[uniq_mask], c.cols[uniq_mask], out)
        raise ValueError(f"unknown dedup op {op!r}")

    # -- conversions -------------------------------------------------------
    @classmethod
    def from_csr(cls, csr) -> "COO":
        """CSR -> COO: expand offsets to row indices (reference:
        coo.hxx:87-98)."""
        rows = convert.offsets_to_indices(csr.offsets)
        return cls(csr.shape, rows, csr.indices.copy(), csr.vals.copy())

    def to_csr(self):
        from loops_tpu_torch.formats.csr import CSR
        return CSR.from_coo(self)

    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.shape, dtype=self.vals.dtype)
        np.add.at(out, (self.rows, self.cols), self.vals)
        return out

    @classmethod
    def from_dense(cls, dense: np.ndarray) -> "COO":
        dense = np.asarray(dense)
        rows, cols = np.nonzero(dense)
        return cls(dense.shape, rows, cols, dense[rows, cols])
