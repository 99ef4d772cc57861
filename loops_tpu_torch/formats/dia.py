"""DIA (diagonal) container.

Parity with the reference's ``dia_t`` (reference:
include/loops/container/dia.hxx:69-188): values stored per stored diagonal,
with a ``count_diagonals`` preflight probe (reference: dia.hxx:98-116 —
their hash-set probe is a vectorized ``np.unique`` here).

Storage convention (row-major): ``vals[d, i] = A[i, i + diag_offsets[d]]``
for ``0 <= i < rows`` with zeros where the column falls outside the
matrix. Each diagonal is a contiguous length-``rows`` lane, so SpMV over
DIA is a dense shifted multiply.

``nnz`` counts the nonzero values, so an explicitly stored zero of the
source matrix is not counted and does not survive ``to_csr``, as in
``loops_tpu``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from loops_tpu_torch.formats.base import as_value_array, check_shape


@dataclass
class DIA:
    shape: tuple
    diag_offsets: np.ndarray  # [num_diags] sorted k where k = col - row
    vals: np.ndarray          # [num_diags, rows]

    def __post_init__(self):
        self.shape = check_shape(self.shape)
        self.diag_offsets = np.ascontiguousarray(self.diag_offsets,
                                                 dtype=np.int32)
        self.vals = as_value_array(self.vals)
        if self.vals.shape != (len(self.diag_offsets), self.shape[0]):
            raise ValueError(
                f"vals shape {self.vals.shape} != (num_diags, rows) = "
                f"({len(self.diag_offsets)}, {self.shape[0]})")

    @property
    def num_diagonals(self) -> int:
        return len(self.diag_offsets)

    @property
    def nnz(self) -> int:
        return int(np.count_nonzero(self.vals))

    @staticmethod
    def count_diagonals(csr) -> int:
        """Preflight probe: number of occupied diagonals (reference:
        dia.hxx:98-116). O(nnz): a mark per diagonal ``k = col - row``,
        no sort."""
        if csr.nnz == 0:
            return 0
        rows, cols = csr.shape
        seen = np.zeros(rows + cols, bool)
        seen[csr.indices.astype(np.int64) - csr.row_ids() + rows] = True
        return int(np.count_nonzero(seen))

    # -- conversions -------------------------------------------------------
    @classmethod
    def from_csr(cls, csr, max_diagonals: int | None = None) -> "DIA":
        """CSR -> DIA (reference: dia.hxx:135-188), vectorized scatter.

        ``max_diagonals`` is the blow-up guard the probe enables: raises
        ``MemoryError`` past it.
        """
        rows = csr.shape[0]
        if csr.nnz == 0:
            return cls(csr.shape, np.zeros(0, np.int32),
                       np.zeros((0, rows), dtype=csr.vals.dtype))
        rid = csr.row_ids()
        k = csr.indices.astype(np.int64) - rid
        uniq, inv = np.unique(k, return_inverse=True)
        if max_diagonals is not None and len(uniq) > max_diagonals:
            raise MemoryError(
                f"{len(uniq)} diagonals exceeds max_diagonals "
                f"{max_diagonals}; matrix too irregular for DIA")
        vals = np.zeros((len(uniq), rows), dtype=csr.vals.dtype)
        vals[inv.reshape(-1), rid] = csr.vals
        return cls(csr.shape, uniq.astype(np.int32), vals)

    def to_csr(self):
        from loops_tpu_torch.formats.coo import COO
        d, r = np.nonzero(self.vals)
        c = r + self.diag_offsets[d]
        keep = (c >= 0) & (c < self.shape[1])
        return COO(self.shape, r[keep], c[keep], self.vals[d, r][keep]).to_csr()

    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.shape, dtype=self.vals.dtype)
        r = np.arange(self.shape[0])
        for d, k in enumerate(self.diag_offsets):
            c = r + k
            keep = (c >= 0) & (c < self.shape[1])
            out[r[keep], c[keep]] = self.vals[d, r[keep]]
        return out

    def column_plane(self):
        """``(cols, vals)``, both [num_diags, rows]: the column each
        diagonal's slot reads, clamped into ``[0, cols)``, and the values
        with every slot whose column falls outside the matrix masked to
        0 — the in-bounds gather plane of the diagonal sweep."""
        rows, cols = self.shape
        offs = self.diag_offsets.astype(np.int64)
        col = np.arange(rows, dtype=np.int64)[None, :] + offs[:, None]
        inside = (col >= 0) & (col < cols)
        return (np.clip(col, 0, max(cols - 1, 0)).astype(np.int32),
                np.where(inside, self.vals, 0).astype(self.vals.dtype))
