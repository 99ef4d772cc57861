"""The tile/atom layout contract — the load-bearing abstraction.

Every irregular workload is a set of **tiles** (logical work groups: a CSR
row, a CSC column, a BCSR block-row) containing **atoms** (smallest
processing units: a nonzero, a stored block). Any object satisfying this
contract drives any schedule (reference: include/loops/container/
layout.hxx:16-58).

As in ``loops_tpu``, the contract is a set of host *arrays*:
``tile_offsets`` [num_tiles+1] is the single universal artifact, and
``atom_tile_ids`` [num_atoms] (the materialized ``tile_of``) is what
segmented reductions consume.
"""
from __future__ import annotations

import numpy as np

from loops_tpu_torch.formats.base import INDEX_DTYPE


class Layout:
    """Base class; concrete views override ``tile_offsets`` (closed-form
    layouts) or store it (offsets-backed layouts).

    Invariants (checked by :func:`check_layout_invariants`):
      * ``tile_offsets()[0] == 0``
      * ``tile_offsets()`` is non-decreasing
      * ``tile_offsets()[-1] == num_atoms``
    """

    num_tiles: int
    num_atoms: int

    def tile_offsets(self) -> np.ndarray:
        raise NotImplementedError

    # -- derived helpers (reference: layout.hxx tile_begin/end/size) -------
    def tile_begin(self, t: int) -> int:
        return int(self.tile_offsets()[t])

    def tile_end(self, t: int) -> int:
        return int(self.tile_offsets()[t + 1])

    def tile_size(self, t: int) -> int:
        return self.tile_end(t) - self.tile_begin(t)

    def tile_of(self, a) -> np.ndarray:
        """Atom id(s) -> owning tile id(s). Vectorized searchsorted — the
        analog of the reference's hand-rolled upper_bound
        (layout.hxx:127-149)."""
        off = self.tile_offsets()
        return (np.searchsorted(off, np.asarray(a), side="right") - 1).astype(
            INDEX_DTYPE)

    def atom_tile_ids(self) -> np.ndarray:
        """Materialized ``tile_of`` for every atom."""
        from loops_tpu_torch.formats.convert import offsets_to_indices
        return offsets_to_indices(self.tile_offsets())

    def tile_sizes(self) -> np.ndarray:
        return np.diff(self.tile_offsets())


def check_layout_invariants(layout: Layout) -> None:
    """Contract conformance check (reference: unittests/
    test_layout_contract.hxx:30-61). Raises AssertionError on violation."""
    off = np.asarray(layout.tile_offsets())
    assert off.ndim == 1 and len(off) == layout.num_tiles + 1, (
        f"tile_offsets length {len(off)} != num_tiles+1")
    assert off[0] == 0, "tile_offsets[0] must be 0"
    assert (np.diff(off) >= 0).all(), "tile_offsets must be non-decreasing"
    assert off[-1] == layout.num_atoms, (
        f"tile_offsets[-1]={off[-1]} != num_atoms={layout.num_atoms}")
    for t in range(layout.num_tiles):
        assert layout.tile_size(t) == off[t + 1] - off[t]


def check_tile_of_round_trip(layout: Layout) -> None:
    """Every atom's tile_of must land in a tile whose [begin, end) contains
    it (reference: test_layout_contract.hxx:69-88)."""
    if layout.num_atoms == 0:
        return
    atoms = np.arange(layout.num_atoms)
    tiles = layout.tile_of(atoms)
    off = layout.tile_offsets()
    assert (off[tiles] <= atoms).all()
    assert (atoms < off[tiles + 1]).all()
    np.testing.assert_array_equal(tiles, layout.atom_tile_ids())
