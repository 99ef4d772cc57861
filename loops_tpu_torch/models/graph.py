"""Graph container for GNN workloads.

Wraps a CSR adjacency with the preprocessing GNNs need (self-loops,
symmetric GCN normalization, degree vectors). Host numpy, as in
``loops_tpu/models/graph.py``: the same arrays from the same edges. The
adjacency is a loops container, so every SpMM schedule and kernel in
``ops/`` applies to message passing unchanged. ``csr_on`` stages the
CSR's offsets and indices on a device once per graph, for the models
that read the structure itself (neighbour sampling); ``with_self_loops``
makes the self-looped graph once, so that the attention models of one
graph share it and its staged plans.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from loops_tpu_torch.formats import COO, CSR
from loops_tpu_torch.utils.platform import resolve_device


@dataclass
class Graph:
    """num_nodes nodes; adjacency in CSR (row = destination, columns =
    sources, so SpMM aggregates *incoming* messages)."""
    adj: CSR
    # device -> (offsets, indices), staged by csr_on
    _on_device: dict = field(default_factory=dict, repr=False,
                             compare=False)
    # the graph with self-loops, made by with_self_loops
    _self_loops: "Graph | None" = field(default=None, repr=False,
                                        compare=False)

    def csr_on(self, device) -> tuple[torch.Tensor, torch.Tensor]:
        """The CSR's offsets and indices as int64 tensors on ``device``,
        staged on the first call and kept with the graph."""
        key = resolve_device(device)
        if key not in self._on_device:
            self._on_device[key] = tuple(
                torch.from_numpy(np.asarray(a, np.int64)).to(device)
                for a in (self.adj.offsets, self.adj.indices))
        return self._on_device[key]

    @property
    def num_nodes(self) -> int:
        return self.adj.shape[0]

    @property
    def num_edges(self) -> int:
        return self.adj.nnz

    @classmethod
    def from_edges(cls, src, dst, num_nodes: int, weights=None,
                   make_undirected: bool = False) -> "Graph":
        src = np.asarray(src)
        dst = np.asarray(dst)
        w = (np.ones(len(src), np.float32) if weights is None
             else np.asarray(weights, np.float32))
        if make_undirected:
            src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
            w = np.concatenate([w, w])
        coo = COO((num_nodes, num_nodes), dst, src, w)
        return cls(coo.remove_duplicates(op="first").to_csr())

    def add_self_loops(self, weight: float = 1.0) -> "Graph":
        n = self.num_nodes
        coo = self.adj.to_coo()
        has_loop = np.zeros(n, bool)
        has_loop[coo.rows[coo.rows == coo.cols]] = True
        missing = np.nonzero(~has_loop)[0]
        rows = np.concatenate([coo.rows, missing])
        cols = np.concatenate([coo.cols, missing])
        vals = np.concatenate(
            [coo.vals, np.full(len(missing), weight, np.float32)])
        return Graph(COO(self.adj.shape, rows, cols, vals).to_csr())

    def with_self_loops(self) -> "Graph":
        """``add_self_loops()``, made on the first call and kept with the
        graph."""
        if self._self_loops is None:
            self._self_loops = self.add_self_loops()
        return self._self_loops

    def in_degrees(self) -> np.ndarray:
        return self.adj.row_sizes()

    def out_degrees(self) -> np.ndarray:
        deg = np.zeros(self.num_nodes, np.int64)
        np.add.at(deg, self.adj.indices, 1)
        return deg

    def gcn_normalized(self) -> "Graph":
        """A_hat = D^-1/2 (A + I) D^-1/2 — the Kipf-Welling propagation
        matrix."""
        g = self.add_self_loops()
        coo = g.adj.to_coo()
        deg = np.zeros(g.num_nodes, np.float64)
        np.add.at(deg, coo.rows, coo.vals.astype(np.float64))
        dinv = 1.0 / np.sqrt(np.maximum(deg, 1e-12))
        vals = (coo.vals * dinv[coo.rows] * dinv[coo.cols]).astype(np.float32)
        return Graph(CSR(g.adj.shape, g.adj.offsets, g.adj.indices, vals))

    def mean_normalized(self) -> "Graph":
        """Row-normalized adjacency (mean aggregation as one SpMM)."""
        deg = np.maximum(self.in_degrees(), 1).astype(np.float32)
        vals = self.adj.vals / deg[self.adj.row_ids()]
        return Graph(CSR(self.adj.shape, self.adj.offsets, self.adj.indices,
                         vals))
