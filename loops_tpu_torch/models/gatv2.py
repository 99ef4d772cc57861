"""GATv2 (Brody, Alon & Yahav 2022): dynamic graph attention.

The port of ``loops_tpu/models/gatv2.py``. GATv1's score
``a . [W h_i || W h_j]`` splits into node halves, so its ranking of
neighbours is the same for every query node; GATv2 moves the
nonlinearity inside, ``e_ij = a . leaky_relu(W_l h_i + W_r h_j)``, which
makes the score a per-edge vector computation. ``fused=True`` runs score,
softmax and sum in the group_mapped plane windows
(``ops/attention.GroupedAttentionV2``), ``fused=False`` the textbook
per-edge composition; autograd differentiates both, and neither
scatters. Heads, ELU and ``dtype`` as in ``models/gat.py``.

Parameters ``layers.{i}.w_l`` (destination role) and ``w_r`` (source
role and values) [d_in, H * d_out] and ``a`` [H, d_out] on every layer,
``b`` [d_out] on the last only, one to one with ``loops_tpu``'s
(``params_from_jax``).
"""
from __future__ import annotations

import torch

from loops_tpu_torch.models.gat import GraphAttention
from loops_tpu_torch.models.gcn import init_layers
from loops_tpu_torch.models.graph import Graph
from loops_tpu_torch.ops.attention import GroupedAttentionV2, leaky_relu


def _gatv2_shapes(dims, heads):
    shapes = []
    for i in range(len(dims) - 1):
        d_in, d_out = dims[i] * (heads if i else 1), dims[i + 1]
        layer = {"w_l": (d_in, heads * d_out), "w_r": (d_in, heads * d_out),
                 "a": (heads, d_out)}
        if i == len(dims) - 2:
            # only the head-averaged last layer adds a bias
            layer["b"] = (d_out,)
        shapes.append(layer)
    return shapes


def init_gatv2(generator: torch.Generator, dims, heads: int = 4):
    """dims = [in, hidden..., out]; returns ``[{"w_l", "w_r", "a"}, ...,
    {"w_l", "w_r", "a", "b"}]`` of CPU tensors: Glorot-uniform draws from
    ``generator``, a zero bias."""
    return init_layers(generator, _gatv2_shapes(dims, heads))


class GATv2(GraphAttention):
    """Multi-head GATv2 bound to a graph on one device: ``model(h)`` maps
    [N, F] to [N, C]."""

    def __init__(self, graph: Graph, dims, heads: int = 4,
                 negative_slope: float = 0.2, fused: bool = True,
                 dtype=None, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__(graph, dims, _gatv2_shapes(dims, heads), heads,
                         negative_slope, fused, device, generator)
        if fused:
            self.attention = GroupedAttentionV2(
                self.graph.adj, negative_slope, dtype=dtype,
                device=self.device)

    def transform(self, i: int, h: torch.Tensor):
        """Layer ``i``'s inputs to the attention from its input ``h``:
        ``(u, v)``, the source (and value) and destination transforms
        [N, H, D]."""
        p = self.layers[i]
        shape = (h.shape[0], self.heads, p.a.shape[1])
        return (h @ p.w_r).reshape(shape), (h @ p.w_l).reshape(shape)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        for i, p in enumerate(self.layers):
            u, v = self.transform(i, h)
            if self.fused:
                out = self.attention(u, v, p.a, u)
            else:
                n, H, D = u.shape
                us = self._by_src(u.reshape(n, -1)).reshape(-1, H, D)
                vs = self._by_dst(v.reshape(n, -1)).reshape(-1, H, D)
                e = (leaky_relu(us + vs, self.negative_slope) * p.a).sum(-1)
                out = self._edge_softmax_sum(e, us)
            h = self._next(i, out)
        return h
