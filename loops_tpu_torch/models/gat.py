"""GAT (graph attention network): scores on the edges, a softmax over each
node's incoming edges, and the weighted sum of the sources' features.

The port of ``loops_tpu/models/gat.py``. Per head and layer, with
self-loops added::

    e_ij    = LeakyReLU(a_src . (W h_j) + a_dst . (W h_i))
    alpha   = softmax of e over the incoming edges of i
    h'_i    = sum_j alpha_ij (W h_j)

ELU between layers; the heads are concatenated on hidden layers and
averaged, plus ``b``, on the last. ``fused=True`` runs each layer's
scores, softmax and sum over the group_mapped planes
(``ops/attention.GroupedAttentionAggregate``): with ``vjp=True`` its
transposed-plan backward, with ``vjp=False`` autograd through it.
``fused=False`` is the textbook per-edge composition on
``ops/segment.py``. No path scatters, forward or backward.
``dtype="bfloat16"`` is the fused op's throughput mode; the textbook
path ignores it, as in ``loops_tpu``.

Parameters ``layers.{i}.w`` [d_in, H * d_out], ``a_src`` and ``a_dst``
[H, d_out] and ``b`` [d_out] on every layer (only the last reads ``b``)
map one to one onto ``loops_tpu``'s (``params_from_jax``). ``h @ W`` is
float32 with TF32 off, as in GCN. There is no dropout.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from loops_tpu_torch.models.gcn import _Layer, init_layers, load_params
from loops_tpu_torch.models.graph import Graph
from loops_tpu_torch.ops.attention import GroupedAttentionAggregate, leaky_relu
from loops_tpu_torch.ops.segment import Gather, segment_softmax, segment_sum
from loops_tpu_torch.utils.platform import ensure_platform


def _gat_shapes(dims, heads):
    # hidden layers read the concatenation of every head
    return [{"w": (dims[i] * (heads if i else 1), heads * dims[i + 1]),
             "a_src": (heads, dims[i + 1]), "a_dst": (heads, dims[i + 1]),
             "b": (dims[i + 1],)} for i in range(len(dims) - 1)]


def init_gat(generator: torch.Generator, dims, heads: int = 4):
    """dims = [in, hidden..., out]; returns ``[{"w", "a_src", "a_dst",
    "b"}, ...]`` of CPU tensors: Glorot-uniform draws from ``generator``,
    zero biases."""
    return init_layers(generator, _gat_shapes(dims, heads))


class GraphAttention(nn.Module):
    """What GAT and GATv2 share: the self-looped graph, the per-layer
    parameters, the textbook path's gathers by source and destination, and
    the head handling between layers."""

    def __init__(self, graph: Graph, dims, shapes, heads: int,
                 negative_slope: float, fused: bool, device,
                 generator: torch.Generator | None):
        super().__init__()
        self.device = ensure_platform(device)
        self.graph = graph.with_self_loops()
        self.dims = list(dims)
        self.heads = heads
        self.negative_slope = float(negative_slope)
        self.fused = fused
        self._shapes = shapes
        self.layers = nn.ModuleList(_Layer(**s) for s in shapes)
        if not fused:
            adj, n = self.graph.adj, self.graph.num_nodes
            self._by_src = Gather(adj.indices, n, self.device)
            self._by_dst = Gather(adj.row_ids(), n, self.device)
        self.init(generator if generator is not None
                  else torch.Generator().manual_seed(0))
        self.to(self.device)

    def init(self, generator: torch.Generator):
        """Reset the parameters: Glorot weights from ``generator``."""
        load_params(self.layers, init_layers(generator, self._shapes))
        return self

    def _edge_softmax_sum(self, e, values):
        """The textbook path's softmax of the edge scores ``e`` [E, H] over
        each destination and the weighted sum of ``values`` [E, H, D]:
        sorted segment reductions over the CSR rows. [N, H, D]."""
        n, dst = self.graph.num_nodes, self._by_dst.ids
        alpha = segment_softmax(e, dst, n, sorted_ids=True)
        msgs = (alpha[..., None] * values).reshape(e.shape[0], -1)
        return segment_sum(msgs, dst, n, sorted_ids=True).reshape(
            n, self.heads, -1)

    def _next(self, i: int, out: torch.Tensor) -> torch.Tensor:
        """Layer ``i``'s output from its aggregation [N, H, D]: ELU over
        the concatenated heads, or the heads' mean plus ``b`` on the
        last layer."""
        if i + 1 < len(self.layers):
            return F.elu(out.reshape(out.shape[0], -1))
        return out.mean(dim=1) + self.layers[i].b


class GAT(GraphAttention):
    """Multi-head GAT bound to a graph on one device: ``model(h)`` maps
    [N, F] to [N, C]."""

    def __init__(self, graph: Graph, dims, heads: int = 4,
                 negative_slope: float = 0.2, fused: bool = True,
                 dtype=None, vjp: bool = True, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__(graph, dims, _gat_shapes(dims, heads), heads,
                         negative_slope, fused, device, generator)
        if fused:
            self.attention = GroupedAttentionAggregate(
                self.graph.adj, negative_slope, dtype=dtype, grad=vjp,
                device=self.device)

    def transform(self, i: int, h: torch.Tensor):
        """Layer ``i``'s inputs to the attention from its input ``h``:
        ``(s_src, s_dst, hw)``, the score halves [N, H] and ``h W`` as
        [N, H, D]."""
        p = self.layers[i]
        (d_in, _), d_out = p.w.shape, p.a_src.shape[1]
        hw = (h @ p.w).reshape(h.shape[0], self.heads, d_out)
        # the score halves folded on the parameter side:
        # s_src[n, h] = sum_d (h W)[n, h, d] a_src[h, d] = h @ v_src with
        # v_src[:, h] = W_h a_src[h], one [N, d_in] x [d_in, H] product
        w3 = p.w.reshape(d_in, self.heads, d_out)
        s_src = h @ torch.einsum("ihd,hd->ih", w3, p.a_src)
        s_dst = h @ torch.einsum("ihd,hd->ih", w3, p.a_dst)
        return s_src, s_dst, hw

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        for i in range(len(self.layers)):
            s_src, s_dst, hw = self.transform(i, h)
            if self.fused:
                out = self.attention(s_src, s_dst, hw)
            else:
                e = leaky_relu(self._by_src(s_src) + self._by_dst(s_dst),
                               self.negative_slope)
                values = self._by_src(hw.reshape(hw.shape[0], -1))
                out = self._edge_softmax_sum(
                    e, values.reshape(-1, *hw.shape[1:]))
            h = self._next(i, out)
        return h
