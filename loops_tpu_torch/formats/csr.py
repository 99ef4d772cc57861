"""CSR (compressed sparse row) container — the workhorse format.

Parity with the reference's ``csr_t`` (reference:
include/loops/container/csr.hxx:36-94): COO construction via sort + offset
compression, dense round-trips, and device staging for the kernels.
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

# from this many f32 nonzeros CSR.from_coo takes the native counting sort
NATIVE_MIN_NNZ = 100_000


@dataclass
class CSR:
    shape: tuple
    offsets: np.ndarray  # [rows+1] row offsets
    indices: np.ndarray  # [nnz] col index per nonzero
    vals: np.ndarray     # [nnz]

    def __post_init__(self):
        self.shape = check_shape(self.shape)
        self.offsets = as_index_array(self.offsets, "row offsets")
        self.indices = as_index_array(self.indices, "col indices")
        self.vals = as_value_array(self.vals)
        if len(self.offsets) != self.shape[0] + 1:
            raise ValueError(
                f"offsets length {len(self.offsets)} != rows+1 "
                f"({self.shape[0] + 1})")
        if len(self.indices) != len(self.vals):
            raise ValueError("indices/vals length mismatch")

    @property
    def rows(self) -> int:
        return self.shape[0]

    @property
    def cols(self) -> int:
        return self.shape[1]

    @property
    def nnz(self) -> int:
        return len(self.vals)

    def row_sizes(self) -> np.ndarray:
        return np.diff(self.offsets)

    def row_ids(self) -> np.ndarray:
        """Per-nonzero row index (the COO row array)."""
        return convert.offsets_to_indices(self.offsets)

    # -- conversions -------------------------------------------------------
    @classmethod
    def from_coo(cls, coo) -> "CSR":
        """COO -> CSR = sort_by_row + indices_to_offsets (reference:
        csr.hxx:86-94). From 100,000 f32 nonzeros the native counting sort
        (``native/src/coo_to_csr.cpp``, O(nnz + rows) against lexsort's
        O(nnz log nnz)) gives the same arrays, as in
        ``loops_tpu/formats/csr.py``; without the library, numpy's."""
        if coo.nnz >= NATIVE_MIN_NNZ and coo.vals.dtype == np.float32:
            from loops_tpu_torch.native.convert import coo_to_csr
            res = coo_to_csr(coo.rows, coo.cols, coo.vals, coo.shape[0])
            if res is not None:
                return cls(coo.shape, *res)
        c = coo.sort_by_row()
        offsets = convert.indices_to_offsets(c.rows, coo.shape[0])
        return cls(coo.shape, offsets, c.cols, c.vals)

    def to_coo(self):
        from loops_tpu_torch.formats.coo import COO
        return COO.from_csr(self)

    def to_csc(self):
        from loops_tpu_torch.formats.csc import CSC
        return CSC.from_csr(self)

    def to_ell(self, max_pitch: int | None = None):
        from loops_tpu_torch.formats.ell import ELL
        return ELL.from_csr(self, max_pitch=max_pitch)

    def to_bcsr(self, block_rows: int, block_cols: int):
        from loops_tpu_torch.formats.bcsr import BCSR
        return BCSR.from_csr(self, block_rows, block_cols)

    def to_dia(self, max_diagonals: int | None = None):
        from loops_tpu_torch.formats.dia import DIA
        return DIA.from_csr(self, max_diagonals=max_diagonals)

    @classmethod
    def from_dense(cls, dense: np.ndarray) -> "CSR":
        from loops_tpu_torch.formats.coo import COO
        return cls.from_coo(COO.from_dense(dense))

    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.shape, dtype=self.vals.dtype)
        out[self.row_ids(), self.indices] = self.vals
        return out

    @classmethod
    def from_scipy(cls, sp) -> "CSR":
        """From a scipy.sparse matrix (any format; converted to csr)."""
        sp = sp.tocsr()
        return cls(sp.shape, sp.indptr, sp.indices, sp.data)

    def to_scipy(self):
        """To scipy.sparse.csr_matrix (requires scipy)."""
        from scipy.sparse import csr_matrix
        return csr_matrix((self.vals, self.indices, self.offsets),
                          shape=self.shape)

    def to_device(self, device):
        """Stage ``(offsets, indices, vals)`` as torch tensors on
        ``device``."""
        import torch
        return tuple(torch.from_numpy(a).to(device)
                     for a in (self.offsets, self.indices, self.vals))
