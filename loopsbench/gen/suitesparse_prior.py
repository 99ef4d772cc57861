"""Directed graphs at a SuiteSparse matrix's published (rows, nnz), under a
structure prior per family fitted to the graph's published degree
figures, made on the device from a seed.

The families are those of ``loops_tpu_torch/utils/statmatch.py``
``replica``, re-written as torch draws on the device (the host version
takes minutes at tens of millions of nonzeros) and held to the figures
that a traffic file's ``graph`` block gives. A graph made here is a
size-and-prior match, not the real matrix. Edge (i, j) is the matrix
entry A[i, j] != 0, read as an edge from i to j, as SuiteSparse stores
the SNAP and DIMACS10 graphs.

* ``powerlaw`` (social and web graphs): a Chung-Lu draw. Each node has
  an out-weight and an in-weight, a power law of its rank ``(k + k0) **
  -exponent``, the offsets set so that the largest expected out- and
  in-degree are the published maxima (``max_out``, ``max_in``); a node
  holds the same rank on both sides (the hubs that are followed also
  follow), and the ranks lie on the node ids in an order drawn from the
  seed. Pairs (source by out-weight, destination by in-weight) are drawn
  in rounds until ``nnz`` distinct ones exist, then ``nnz`` of them kept
  uniformly, as statmatch's ``_exact_unique_coo``.
* ``lattice`` (road networks; symmetric, as DIMACS10's road graphs are):
  the nodes on a grid ``ceil(sqrt(rows))`` wide, numbered row by row, so
  that the ids follow the map; each row of the grid a path, the rows
  joined at their first column (a spanning tree: no node is isolated),
  and the rest of the ``nnz / 2`` undirected edges drawn without
  replacement from the other vertical neighbours. Degrees 1 to 4, their
  mean the published one; an edge's ends lie 1 id apart along a row and
  one grid row (about ``sqrt(rows)`` ids) apart across.

The graph comes from a seed fixed by the ``graph`` block, in one order for
every run seed: the data set, as a user's file is. ``structure_seed`` in
the block draws another graph of the same figures.
"""
from __future__ import annotations

import math

import torch

from loopsbench.gen import capped_cdf, draw, structure_generator


def powerlaw(graph: dict, g: torch.Generator, device, max_rounds: int = 64):
    """``(src, dst)``: ``nnz`` distinct int64 pairs of ``rows`` nodes."""
    rows, nnz = int(graph["rows"]), int(graph["nnz"])
    e = float(graph["exponent"])
    out_cdf = capped_cdf(rows, nnz, int(graph["max_out"]), e, device)
    in_cdf = capped_cdf(rows, nnz, int(graph["max_in"]), e, device)
    node = torch.randperm(rows, generator=g, device=device)
    keys = torch.empty(0, dtype=torch.int64, device=device)
    need = nnz
    for _ in range(max_rounds):
        k = int(need * 1.1) + 16
        i = node[draw(out_cdf, k, g)]
        j = node[draw(in_cdf, k, g)]
        keys = torch.unique(torch.cat([keys, i * rows + j]))
        if keys.numel() >= nnz:
            pick = torch.randperm(keys.numel(), generator=g,
                                  device=device)[:nnz]
            keys = keys[pick]
            return keys // rows, keys % rows
        need = nnz - keys.numel()
    raise RuntimeError(f"powerlaw: {keys.numel()} distinct pairs of "
                       f"{nnz} after {max_rounds} rounds")


def lattice(graph: dict, g: torch.Generator, device):
    """``(src, dst)``: ``nnz`` int64 pairs, each undirected edge both
    ways."""
    rows, nnz = int(graph["rows"]), int(graph["nnz"])
    if nnz % 2:
        raise ValueError(f"a symmetric graph without self-loops has an "
                         f"even nnz, not {nnz}")
    width = math.isqrt(rows - 1) + 1
    ids = torch.arange(rows, dtype=torch.int64, device=device)
    col = ids % width
    # the tree: each grid row a path, the rows joined at column 0
    path = ids[(col < width - 1) & (ids + 1 < rows)]
    join = ids[(col == 0) & (ids + width < rows)]
    tree_u = torch.cat([path, join])
    tree_v = torch.cat([path + 1, join + width])
    need = nnz // 2 - tree_u.numel()
    # the other vertical neighbours: (i, i + width), column > 0
    cand = ids[(col > 0) & (ids + width < rows)]
    if need < 0 or need > cand.numel():
        raise ValueError(f"{nnz // 2} edges do not fit a lattice of "
                         f"{rows} nodes {width} wide")
    extra = cand[torch.randperm(cand.numel(), generator=g,
                                device=device)[:need]]
    u = torch.cat([tree_u, extra])
    v = torch.cat([tree_v, extra + width])
    return torch.cat([u, v]), torch.cat([v, u])


FAMILIES = {"powerlaw": powerlaw, "lattice": lattice}


def make(graph: dict, seed: int, device) -> dict:
    """``{"num_nodes", "src", "dst"}`` for a traffic file's ``graph``
    block (``family``, ``rows``, ``nnz`` and the family's figures); the
    same for every ``seed``."""
    src, dst = FAMILIES[graph["family"]](
        graph, structure_generator(graph, device), device)
    return dict(num_nodes=int(graph["rows"]), src=src, dst=dst)
