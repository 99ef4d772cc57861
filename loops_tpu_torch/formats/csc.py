"""CSC (compressed sparse column) container.

Parity with the reference's ``csc_t`` (reference:
include/loops/container/csc.hxx:84-106): COO construction via column sort,
CSR construction via structural transpose through COO. The GNN slice uses
it for Aᵀ, the operator of the aggregation's gradient.
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
class CSC:
    shape: tuple
    offsets: np.ndarray  # [cols+1] column offsets
    indices: np.ndarray  # [nnz] row index per nonzero
    vals: np.ndarray     # [nnz]

    def __post_init__(self):
        self.shape = check_shape(self.shape)
        self.offsets = as_index_array(self.offsets, "col offsets")
        self.indices = as_index_array(self.indices, "row indices")
        self.vals = as_value_array(self.vals)
        if len(self.offsets) != self.shape[1] + 1:
            raise ValueError(
                f"offsets length {len(self.offsets)} != cols+1 "
                f"({self.shape[1] + 1})")

    @property
    def nnz(self) -> int:
        return len(self.vals)

    def col_ids(self) -> np.ndarray:
        """Per-nonzero column index (segment ids over the column tiles)."""
        return convert.offsets_to_indices(self.offsets)

    # -- conversions -------------------------------------------------------
    @classmethod
    def from_coo(cls, coo) -> "CSC":
        """COO -> CSC = sort_by_column + indices_to_offsets (reference:
        csc.hxx:84-92)."""
        c = coo.sort_by_column()
        offsets = convert.indices_to_offsets(c.cols, coo.shape[1])
        return cls(coo.shape, offsets, c.rows, c.vals)

    @classmethod
    def from_csr(cls, csr) -> "CSC":
        """CSR -> CSC structural transpose via COO (reference:
        csc.hxx:104-106)."""
        return cls.from_coo(csr.to_coo())

    def to_coo(self):
        from loops_tpu_torch.formats.coo import COO
        return COO(self.shape, self.indices.copy(), self.col_ids(),
                   self.vals.copy()).sort_by_row()

    def to_csr(self):
        from loops_tpu_torch.formats.csr import CSR
        return CSR.from_coo(self.to_coo())

    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.shape, dtype=self.vals.dtype)
        out[self.indices, self.col_ids()] = self.vals
        return out
