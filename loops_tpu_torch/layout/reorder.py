"""Graph/matrix reordering for gather locality, as in
``loops_tpu/layout/reorder.py``.

Reorder the matrix once at plan time, keep the permutation, undo it on
the output: consecutive nonzeros then read nearby entries of ``x``.

Two orderings:
  * ``degree_order``  — hubs first (groups heavy rows; also the sigma
    pass that tightens group_mapped's degree-class buckets).
  * ``bfs_order``     — Cuthill-McKee-style breadth-first from a
    min-degree seed; clusters neighborhoods so edge gathers walk nearby
    addresses.

``bfs_order`` gives ``loops_tpu``'s permutation element for element. The
reference drains a Python list node by node (``queue.pop(0)``, quadratic
in the queue's length); here each BFS level is one vectorized step over
the whole frontier, which visits the nodes in the same order.
"""
from __future__ import annotations

import numpy as np

from loops_tpu_torch.formats import COO, CSR
from loops_tpu_torch.formats.base import INDEX_DTYPE


def degree_order(csr: CSR, descending: bool = True) -> np.ndarray:
    """Permutation sorting rows by degree (stable)."""
    deg = csr.row_sizes()
    key = -deg if descending else deg
    return np.argsort(key, kind="stable").astype(INDEX_DTYPE)


def _symmetrized(csr: CSR) -> CSR:
    """The pattern of ``A + Aᵀ`` for a square ``csr`` (each entry once,
    columns sorted within a row), so the ordering works on directed
    graphs; ``csr`` itself otherwise."""
    if csr.shape[0] != csr.shape[1]:
        return csr
    coo = csr.to_coo()
    rows = np.concatenate([coo.rows, coo.cols])
    cols = np.concatenate([coo.cols, coo.rows])
    vals = np.ones(len(rows), np.float32)
    return COO(csr.shape, rows, cols, vals).remove_duplicates().to_csr()


def _next_level(sym: CSR, deg: np.ndarray, visited: np.ndarray,
                frontier: np.ndarray) -> np.ndarray:
    """The nodes the reference's queue appends while it pops
    ``frontier``, in its order: each node's unvisited neighbours, first
    reach wins, each node's share sorted by degree (stable in adjacency
    order). Marks them visited."""
    starts = sym.offsets[frontier].astype(np.int64)
    sizes = sym.offsets[frontier + 1].astype(np.int64) - starts
    total = int(sizes.sum())
    if total == 0:
        return frontier[:0]
    owner = np.repeat(np.arange(len(frontier), dtype=np.int64), sizes)
    pos = np.arange(total, dtype=np.int64) - np.repeat(
        np.cumsum(sizes) - sizes, sizes)
    nbrs = sym.indices[starts[owner] + pos]
    fresh = ~visited[nbrs]
    nbrs, owner = nbrs[fresh], owner[fresh]
    # first reach wins: the earliest (owner, adjacency) slot of each node
    _, first = np.unique(nbrs, return_index=True)
    first.sort()
    nbrs, owner = nbrs[first], owner[first]
    # by owner, then degree, then adjacency order (lexsort is stable)
    nxt = nbrs[np.lexsort((deg[nbrs], owner))]
    visited[nxt] = True
    return nxt


def bfs_order(csr: CSR) -> np.ndarray:
    """Cuthill-McKee-flavored BFS ordering over the symmetrized pattern;
    isolated/unreached nodes append at the end in index order."""
    n = csr.shape[0]
    sym = _symmetrized(csr)
    deg = sym.row_sizes()
    visited = np.zeros(n, bool)
    order = np.empty(n, dtype=INDEX_DTYPE)
    pos = 0
    for seed in np.argsort(deg, kind="stable"):
        if visited[seed]:
            continue
        visited[seed] = True
        frontier = np.array([seed], dtype=np.int64)
        while len(frontier):
            order[pos:pos + len(frontier)] = frontier
            pos += len(frontier)
            frontier = _next_level(sym, deg, visited, frontier)
    return order


def permute_csr(csr: CSR, perm: np.ndarray, permute_cols: bool = True) -> CSR:
    """Symmetric (or row-only) permutation: A'[i, j] = A[perm[i], perm[j]].

    ``perm`` maps new index -> old index. Returns the permuted CSR;
    ``y_original = y_permuted[inverse_permutation(perm)]``.
    """
    inv = inverse_permutation(perm)
    coo = csr.to_coo()
    rows = inv[coo.rows]
    cols = inv[coo.cols] if permute_cols else coo.cols
    return COO(csr.shape, rows, cols, coo.vals).to_csr()


def inverse_permutation(perm: np.ndarray) -> np.ndarray:
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm), dtype=perm.dtype)
    return inv


def bandwidth(csr: CSR) -> int:
    """Max |row - col| over nonzeros — the locality metric BFS ordering
    minimizes (lower = nearer gathers)."""
    if csr.nnz == 0:
        return 0
    return int(np.abs(csr.row_ids().astype(np.int64)
                      - csr.indices).max())
