"""ELL (ELLPACK) container — dense [rows, pitch] index/value planes.

Parity with the reference's ``ell_t`` (reference:
include/loops/container/ell.hxx:45-145): sentinel-padded row-major planes,
a ``max_nnz_per_row`` preflight probe guarding against memory blow-up on
skewed matrices, and host CSR bucket-fill.

The planes are static-shape dense arrays, so a device SpMV over them is a
masked row reduction with no plan: the padding's zero values make the
sentinel slots a mathematical no-op once staging points them at column 0.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from loops_tpu_torch.formats.base import INDEX_DTYPE, as_value_array, check_shape

SENTINEL = INDEX_DTYPE(-1)


@dataclass
class ELL:
    shape: tuple
    pitch: int                # max nonzeros per row (plane width)
    indices: np.ndarray       # [rows, pitch] col index, -1 = padding
    vals: np.ndarray          # [rows, pitch] value, 0 at padding

    def __post_init__(self):
        self.shape = check_shape(self.shape)
        self.pitch = int(self.pitch)
        self.indices = np.ascontiguousarray(self.indices, dtype=INDEX_DTYPE)
        self.vals = as_value_array(self.vals)
        if self.indices.shape != (self.shape[0], self.pitch):
            raise ValueError(
                f"indices shape {self.indices.shape} != "
                f"(rows, pitch) = ({self.shape[0]}, {self.pitch})")
        if self.vals.shape != self.indices.shape:
            raise ValueError("vals/indices shape mismatch")

    @property
    def nnz(self) -> int:
        return int((self.indices != SENTINEL).sum())

    @staticmethod
    def max_nnz_per_row(csr) -> int:
        """Preflight probe: the pitch a CSR would need (reference:
        ell.hxx:91-102). Call before converting to bound memory."""
        sizes = csr.row_sizes()
        return int(sizes.max()) if len(sizes) else 0

    # -- conversions -------------------------------------------------------
    @classmethod
    def from_csr(cls, csr, max_pitch: int | None = None) -> "ELL":
        """CSR -> ELL bucket fill (reference: ell.hxx:113-145), vectorized:
        scatter each nonzero to (row, rank-within-row).

        ``max_pitch`` guards skewed matrices: raises ``MemoryError`` if the
        required pitch exceeds it.
        """
        rows = csr.shape[0]
        pitch = cls.max_nnz_per_row(csr)
        if max_pitch is not None and pitch > max_pitch:
            raise MemoryError(
                f"ELL pitch {pitch} exceeds max_pitch {max_pitch}; "
                f"matrix too skewed for ELL")
        indices = np.full((rows, max(pitch, 1)), SENTINEL, dtype=INDEX_DTYPE)
        vals = np.zeros((rows, max(pitch, 1)), dtype=csr.vals.dtype)
        if csr.nnz:
            rid = csr.row_ids()
            rank = np.arange(csr.nnz, dtype=np.int64) - csr.offsets[rid]
            indices[rid, rank] = csr.indices
            vals[rid, rank] = csr.vals
        return cls(csr.shape, max(pitch, 1), indices, vals)

    def to_csr(self):
        from loops_tpu_torch.formats.coo import COO
        mask = self.indices != SENTINEL
        rid, rank = np.nonzero(mask)
        return COO(self.shape, rid, self.indices[rid, rank],
                   self.vals[rid, rank]).to_csr()

    def to_dense(self) -> np.ndarray:
        out = np.zeros(self.shape, dtype=self.vals.dtype)
        mask = self.indices != SENTINEL
        rid, rank = np.nonzero(mask)
        out[rid, self.indices[rid, rank]] = self.vals[rid, rank]
        return out

    def safe_planes(self):
        """``(indices, vals)`` with every sentinel slot rewritten to
        column 0 and value 0, so a gather through the plane stays in
        bounds and the padding adds nothing. A raw ``-1`` would not fail
        in torch: it wraps to the last element of ``x``."""
        pad = self.indices == SENTINEL
        return (np.where(pad, 0, self.indices).astype(INDEX_DTYPE),
                np.where(pad, 0, self.vals).astype(self.vals.dtype))

    def to_device(self, device):
        """Stage ``(indices, vals)`` as torch tensors on ``device``, the
        sentinels rewritten as :meth:`safe_planes` does."""
        import torch
        return tuple(torch.from_numpy(a).to(device)
                     for a in self.safe_planes())
