"""Offset/index converters — the primitive pair underlying every
cross-format conversion — and ``csr_from_arrays``.

Mirrors the reference's detail::{offsets_to_indices, indices_to_offsets}
(reference: include/loops/container/detail/convert.hxx:37-78) the numpy
way: ``repeat`` for expansion and ``searchsorted`` for compression.
"""
from __future__ import annotations

import numpy as np

from loops_tpu_torch.formats.base import INDEX_DTYPE


def offsets_to_indices(offsets: np.ndarray) -> np.ndarray:
    """CSR-style offsets [n_tiles+1] -> per-atom tile index [n_atoms].

    offsets = [0, 2, 2, 5] -> [0, 0, 2, 2, 2]   (empty tiles emit nothing)
    """
    offsets = np.asarray(offsets)
    sizes = np.diff(offsets)
    return np.repeat(np.arange(len(sizes), dtype=INDEX_DTYPE), sizes)


def indices_to_offsets(indices: np.ndarray, num_tiles: int) -> np.ndarray:
    """Sorted per-atom tile indices [n_atoms] -> offsets [num_tiles+1].

    Inverse of :func:`offsets_to_indices` for sorted input; tolerates empty
    tiles anywhere (reference: convert.hxx:70-78).
    """
    indices = np.asarray(indices)
    return np.searchsorted(
        indices, np.arange(num_tiles + 1, dtype=np.int64), side="left"
    ).astype(INDEX_DTYPE)


def csr_from_arrays(shape, offsets, indices, vals):
    """A :class:`~loops_tpu_torch.formats.csr.CSR` from plain arrays, such
    as the fields of another package's CSR — one matrix fed to both."""
    from loops_tpu_torch.formats.csr import CSR
    return CSR(tuple(shape), np.asarray(offsets), np.asarray(indices),
               np.asarray(vals))


def stable_argsort(keys: np.ndarray, bound: int) -> np.ndarray:
    """``np.argsort(keys, kind="stable")`` for integer keys, mostly in
    ``[0, bound)``. Where a key and its position fit one int64 together, the
    packed words are sorted by value instead (numpy's vectorized sort,
    several times faster than its stable argsort), which gives the same
    permutation."""
    n = len(keys)
    if n == 0:
        return np.zeros(0, np.int64)
    lo, hi = int(keys.min()), int(keys.max())
    pos_bits = max(int(n - 1).bit_length(), 1)
    if lo < 0 or max(hi, int(bound) - 1).bit_length() + pos_bits > 63:
        return np.argsort(keys, kind="stable")
    packed = (keys.astype(np.int64) << pos_bits) | np.arange(n,
                                                            dtype=np.int64)
    packed.sort()
    return packed & ((1 << pos_bits) - 1)


def lexsort2(minor: np.ndarray, major: np.ndarray, minor_bound: int,
             major_bound: int) -> np.ndarray:
    """``np.lexsort((minor, major))`` (by ``major``, then ``minor``, then
    position) as two stable passes, least significant key first."""
    perm = stable_argsort(minor, minor_bound)
    return perm[stable_argsort(major[perm], major_bound)]
