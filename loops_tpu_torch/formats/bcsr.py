"""BCSR (block compressed sparse row) container.

Parity with the reference's ``bcsr_t`` (reference:
include/loops/container/bcsr.hxx:54-194): block-row offsets over stored
R x C blocks with dense per-block payloads. The reference's two-pass
conversion (discover non-empty block columns, then scatter) is one
vectorized unique + scatter here, giving the same arrays as
``loops_tpu``'s container for the same CSR.

On the card each stored block is a dense operand: the BCSR kernels
(``ops/kernels/spmv_bcsr.py``, ``spmm_bcsr*.py``) stream the blocks and
read x or B as dense C-wide segments, with no per-nonzero gather.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from loops_tpu_torch.formats import convert
from loops_tpu_torch.formats.base import (
    INDEX_DTYPE,
    as_index_array,
    as_value_array,
    check_shape,
)


@dataclass
class BCSR:
    shape: tuple              # logical (rows, cols) of the original matrix
    block_shape: tuple        # (R, C) block dims
    block_offsets: np.ndarray  # [num_block_rows+1]
    block_cols: np.ndarray     # [num_blocks] block-column index
    vals: np.ndarray           # [num_blocks, R, C] dense payloads

    def __post_init__(self):
        self.shape = check_shape(self.shape)
        self.block_shape = (int(self.block_shape[0]),
                            int(self.block_shape[1]))
        self.block_offsets = as_index_array(self.block_offsets,
                                            "block offsets")
        self.block_cols = as_index_array(self.block_cols, "block cols")
        self.vals = as_value_array(self.vals)
        R, C = self.block_shape
        if self.vals.shape != (len(self.block_cols), R, C):
            raise ValueError(
                f"vals shape {self.vals.shape} != (num_blocks, R, C) = "
                f"({len(self.block_cols)}, {R}, {C})")
        if len(self.block_offsets) != self.num_block_rows + 1:
            raise ValueError("block_offsets length != num_block_rows + 1")

    @property
    def num_block_rows(self) -> int:
        return -(-self.shape[0] // self.block_shape[0])

    @property
    def num_block_cols(self) -> int:
        return -(-self.shape[1] // self.block_shape[1])

    @property
    def num_blocks(self) -> int:
        return len(self.block_cols)

    @property
    def nnz(self) -> int:
        """Stored values = blocks x R x C (explicit zeros inside blocks
        included, as in the reference's dense-payload semantics)."""
        return int(self.vals.size)

    def block_row_ids(self) -> np.ndarray:
        return convert.offsets_to_indices(self.block_offsets)

    # -- conversions -------------------------------------------------------
    @classmethod
    def from_csr(cls, csr, block_rows: int, block_cols: int) -> "BCSR":
        """CSR -> BCSR (reference: bcsr.hxx:111-194), vectorized."""
        R, C = int(block_rows), int(block_cols)
        n_brows = -(-csr.shape[0] // R)
        if csr.nnz == 0:
            return cls(csr.shape, (R, C),
                       np.zeros(n_brows + 1, dtype=INDEX_DTYPE),
                       np.zeros(0, dtype=INDEX_DTYPE),
                       np.zeros((0, R, C), dtype=csr.vals.dtype))
        rid = csr.row_ids()
        br = rid // R
        bc = csr.indices // C
        key = br.astype(np.int64) * (1 << 32) + bc
        order = np.argsort(key, kind="stable")
        skey = key[order]
        new_block = np.empty(len(skey), dtype=bool)
        new_block[0] = True
        np.not_equal(skey[1:], skey[:-1], out=new_block[1:])
        block_id_sorted = np.cumsum(new_block) - 1
        block_id = np.empty_like(block_id_sorted)
        block_id[order] = block_id_sorted
        n_blocks = int(block_id_sorted[-1]) + 1
        ub = skey[new_block]
        ubr = (ub >> 32).astype(INDEX_DTYPE)
        ubc = (ub & 0xFFFFFFFF).astype(INDEX_DTYPE)
        vals = np.zeros((n_blocks, R, C), dtype=csr.vals.dtype)
        vals[block_id, rid % R, csr.indices % C] = csr.vals
        offsets = convert.indices_to_offsets(ubr, n_brows)
        return cls(csr.shape, (R, C), offsets, ubc, vals)

    def to_csr(self):
        from loops_tpu_torch.formats.coo import COO
        R, C = self.block_shape
        if self.num_blocks == 0:
            return COO(self.shape, [], [], []).to_csr()
        brid = self.block_row_ids()
        b, r, c = np.meshgrid(np.arange(self.num_blocks), np.arange(R),
                              np.arange(C), indexing="ij")
        rows = brid[b] * R + r
        cols = self.block_cols[b] * C + c
        keep = ((rows < self.shape[0]) & (cols < self.shape[1])
                & (self.vals != 0))
        return COO(self.shape, rows[keep], cols[keep],
                   self.vals[keep]).to_csr()

    def stored_pattern(self):
        """``(csr, slot)``: every stored entry inside the matrix, explicit
        zeros kept, as a CSR in row order (the pattern block SDDMM
        samples), and each entry's index in the flattened
        [num_blocks, R, C] payload."""
        from loops_tpu_torch.formats.csr import CSR
        R, C = self.block_shape
        rows, cols = self.shape
        t, r, c = np.meshgrid(np.arange(self.num_blocks), np.arange(R),
                              np.arange(C), indexing="ij")
        gr = self.block_row_ids()[t] * R + r
        gc = self.block_cols[t].astype(np.int64) * C + c
        slot = (t * R + r) * C + c
        keep = (gr < rows) & (gc < cols)
        gr, gc, slot = gr[keep], gc[keep], slot[keep]
        order = np.argsort(gr * max(cols, 1) + gc, kind="stable")
        gr, gc, slot = gr[order], gc[order], slot[order]
        offsets = np.searchsorted(gr, np.arange(rows + 1))
        return (CSR(self.shape, offsets, gc, self.vals.reshape(-1)[slot]),
                slot)

    def to_dense(self) -> np.ndarray:
        R, C = self.block_shape
        padded = np.zeros((self.num_block_rows * R, self.num_block_cols * C),
                          dtype=self.vals.dtype)
        brid = self.block_row_ids()
        for k in range(self.num_blocks):
            r0, c0 = brid[k] * R, self.block_cols[k] * C
            padded[r0:r0 + R, c0:c0 + C] = self.vals[k]
        return padded[: self.shape[0], : self.shape[1]]

    def to_device(self, device):
        """Stage ``(block_offsets, block_cols, vals)`` as torch tensors on
        ``device``."""
        import torch
        return tuple(torch.from_numpy(a).to(device)
                     for a in (self.block_offsets, self.block_cols,
                               self.vals))
