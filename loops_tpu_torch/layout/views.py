"""Layout views of the ported formats (reference: include/loops/
container/layout.hxx:87-149, 239-285, 385-421). The CSC, ELL and DIA
views come with their formats (ROADMAP A6).

==========  ==================  ==========================  ================
view        tile                atom                        tile_offsets
==========  ==================  ==========================  ================
CsrLayout   row                 nonzero                     row offsets
BcsrLayout  block-row           stored RxC block            block offsets
CooLayout   nonzero (==atom)    nonzero                     arange (closed)
==========  ==================  ==========================  ================
"""
from __future__ import annotations

import numpy as np

from loops_tpu_torch.formats.base import INDEX_DTYPE
from loops_tpu_torch.layout.contract import Layout


class OffsetsLayout(Layout):
    """Offsets-backed layout (reference: layout.hxx:87-149)."""

    def __init__(self, offsets, num_atoms: int | None = None):
        self._offsets = np.ascontiguousarray(offsets, dtype=INDEX_DTYPE)
        self.num_tiles = len(self._offsets) - 1
        self.num_atoms = int(self._offsets[-1]) if num_atoms is None else int(num_atoms)

    def tile_offsets(self) -> np.ndarray:
        return self._offsets


class CsrLayout(OffsetsLayout):
    @classmethod
    def from_csr(cls, csr):
        return cls(csr.offsets)


class BcsrLayout(OffsetsLayout):
    """Tiles are block-rows, atoms are stored block ids
    (layout.hxx:239-285)."""

    @classmethod
    def from_bcsr(cls, bcsr):
        return cls(bcsr.block_offsets)


class CooLayout(Layout):
    """Degenerate view: tile == atom == nonzero (layout.hxx:385-421)."""

    def __init__(self, nnz: int):
        self.num_tiles = int(nnz)
        self.num_atoms = int(nnz)

    @classmethod
    def from_coo(cls, coo):
        return cls(coo.nnz)

    def tile_offsets(self) -> np.ndarray:
        return np.arange(self.num_tiles + 1, dtype=INDEX_DTYPE)

    def tile_begin(self, t):
        return t

    def tile_end(self, t):
        return t + 1

    def tile_of(self, a):
        return np.asarray(a, dtype=INDEX_DTYPE)
