"""Merge-path diagonal search — the balanced-partitioning primitive.

The reference performs a 2-D binary search per diagonal on the device
(reference: include/loops/util/search.hxx:34-60, used by the work_oriented
and merge_path_flat schedules). The merge "matrix" has the tile-end
sequence on one axis and the atom counting sequence on the other; cutting
it along equally spaced diagonals yields per-processor (tile, atom) start
coordinates such that every processor gets the same amount of
``tiles + atoms`` total work, regardless of row skew.

Here the per-diagonal binary search is **one vectorized searchsorted over
the monotone key ``offsets[t+1] + t + 1``** on the host — the analog of
the reference's ``preprocess_t`` coordinate materialization
(schedule/merge_path_flat.hxx:99-172).

Semantics: for diagonal ``d``, ``merge_path_partition`` returns ``(t, a)``
with ``t + a == d`` where ``t`` counts *tile boundaries already crossed*
and ``a`` counts *atoms already consumed*. The sequential merge consumes
atom ``a`` while ``a < offsets[t+1]`` and crosses a tile boundary
otherwise — identical to CUB/merge-path SpMV decomposition.
"""
from __future__ import annotations

import numpy as np

from loops_tpu_torch.formats.base import INDEX_DTYPE


def merge_path_partition(offsets: np.ndarray, num_partitions: int,
                         items_per_partition: int | None = None):
    """Cut the (tiles x atoms) merge matrix into equal diagonals.

    Args:
      offsets: tile offsets, shape [num_tiles+1].
      num_partitions: number of processors P.
      items_per_partition: work per processor; default ceil(total/P).

    Returns:
      (tile_starts, atom_starts): int32 arrays of shape [P+1]; processor p
      owns the merge-path segment from (tile_starts[p], atom_starts[p]) to
      (tile_starts[p+1], atom_starts[p+1]).
    """
    offsets = np.asarray(offsets)
    num_tiles = len(offsets) - 1
    num_atoms = int(offsets[-1])
    total = num_tiles + num_atoms
    ipp = (items_per_partition if items_per_partition is not None
           else -(-total // max(num_partitions, 1)))
    d = np.minimum(np.arange(num_partitions + 1, dtype=np.int64) * ipp, total)
    # key[t] = offsets[t+1] + (t+1): diagonal at which tile t's boundary
    # has been fully consumed. Monotone because offsets is non-decreasing.
    key = offsets[1:].astype(np.int64) + np.arange(1, num_tiles + 1)
    t = np.searchsorted(key, d, side="right")
    a = d - t
    return t.astype(INDEX_DTYPE), a.astype(INDEX_DTYPE)


def merge_path_reference(offsets: np.ndarray):
    """Sequential merge walk — the oracle for planner tests. Yields the
    (tile, atom) coordinate before each of the ``total`` merge steps."""
    offsets = np.asarray(offsets)
    num_tiles = len(offsets) - 1
    num_atoms = int(offsets[-1])
    t = a = 0
    coords = []
    while t < num_tiles or a < num_atoms:
        coords.append((t, a))
        if t < num_tiles and a >= offsets[t + 1]:
            t += 1  # cross a tile boundary
        else:
            a += 1  # consume an atom
    coords.append((t, a))
    return coords
