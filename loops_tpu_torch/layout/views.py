"""Layout views (reference: include/loops/container/layout.hxx:87-496).
The ELL and DIA formats are not ported yet (ROADMAP A6): their views
exist, built from a row count and a pitch, and ``from_ell`` / ``from_dia``
raise until the formats come.

============  ==================  ==========================  ================
view          tile                atom                        tile_offsets
============  ==================  ==========================  ================
CsrLayout     row                 nonzero                     row offsets
BcsrLayout    block-row           stored RxC block            block offsets
CooLayout     nonzero (==atom)    nonzero                     arange (closed)
EllLayout     row                 plane slot (incl. padding)  t*pitch (closed)
DiaLayout     row                 (row, diagonal) slot        t*ndiag (closed)
============  ==================  ==========================  ================
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


class UniformLayout(Layout):
    """Closed-form layout with a fixed number of atoms per tile, the
    common core of the ELL and DIA views (layout.hxx:443-496, 166-217).
    The offsets array is never materialized unless asked for."""

    def __init__(self, num_tiles: int, pitch: int):
        self.num_tiles = int(num_tiles)
        self.pitch = int(pitch)
        self.num_atoms = self.num_tiles * self.pitch

    def tile_offsets(self) -> np.ndarray:
        return (np.arange(self.num_tiles + 1, dtype=np.int64)
                * self.pitch).astype(INDEX_DTYPE)

    def tile_begin(self, t):
        return t * self.pitch

    def tile_end(self, t):
        return (t + 1) * self.pitch

    def tile_of(self, a):
        return (np.asarray(a) // max(self.pitch, 1)).astype(INDEX_DTYPE)


def _not_ported(fmt: str):
    raise NotImplementedError(
        f"the {fmt} format is not ported to loops_tpu_torch yet (ROADMAP "
        f"A6: the other SpMV formats); build the view from its row count "
        "and pitch")


class EllLayout(UniformLayout):
    """Tiles are rows; each row holds ``pitch`` plane slots, padding
    included."""

    @classmethod
    def from_ell(cls, ell):
        _not_ported("ELL")


class DiaLayout(UniformLayout):
    """Tiles are rows; each row holds one atom slot per stored diagonal
    (layout.hxx:166-217)."""

    @classmethod
    def from_dia(cls, dia):
        _not_ported("DIA")


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
