"""GCN (Kipf & Welling) as a PyTorch ``nn.Module``.

N-layer GCN with the parameter layout of ``loops_tpu/models/gcn.py``: one
weight ``[in, out]`` and one bias ``[out]`` per layer, state-dict names
``layers.{i}.w`` / ``layers.{i}.b`` that map one to one onto
``loops_tpu``'s ``[{"w", "b"}, ...]`` (``params_from_jax`` carries them
over). Each layer is ``A_hat @ (H W) + b``: the propagation is one SpMM
(K4 on a card, ``models/message_passing.py``). The parameter helpers
here (``init_layers``, ``_Layer``, ``load_params``, ``params_from_jax``)
carry any layer dict's keys, and GraphSAGE uses them too.

``H @ W`` is ``torch.matmul`` in float32. The module leaves TF32 off for
it, which is PyTorch's default (``torch.backends.cuda.matmul.allow_tf32``
is False), so the dense products keep full f32 precision on the card.

Dropout is active only in ``train()`` mode and draws from an explicit
``torch.Generator`` passed to ``forward``; its draws differ from JAX's
from the same seed.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from loops_tpu_torch.models.graph import Graph
from loops_tpu_torch.models.message_passing import (
    aggregate_operator,
    masked_aggregate_operator,
)
from loops_tpu_torch.utils.platform import ensure_platform


def _glorot(generator: torch.Generator, fan_in: int, fan_out: int):
    lim = float(np.sqrt(6.0 / (fan_in + fan_out)))
    u = torch.rand((fan_in, fan_out), generator=generator,
                   dtype=torch.float32)
    return u * (2 * lim) - lim


def init_layers(generator: torch.Generator, shapes) -> list:
    """Per-layer ``{name: tensor}`` dicts of CPU tensors for ``shapes``
    (``[{name: shape}, ...]``): a zero bias for ``b``, and a
    Glorot-uniform draw from ``generator`` for every other name, in
    order. The parameter initialisation every model of the port shares."""
    return [{k: (torch.zeros(shape, dtype=torch.float32) if k == "b"
                 else _glorot(generator, *shape))
             for k, shape in layer.items()} for layer in shapes]


def _gcn_shapes(dims):
    return [{"w": (dims[i], dims[i + 1]), "b": (dims[i + 1],)}
            for i in range(len(dims) - 1)]


def init_gcn(generator: torch.Generator, dims):
    """dims = [in, hidden..., out]; returns ``[{"w", "b"}, ...]`` of CPU
    tensors: Glorot-uniform weights drawn from ``generator``, zero
    biases."""
    return init_layers(generator, _gcn_shapes(dims))


def params_from_jax(params) -> dict:
    """A model's state dict from ``loops_tpu``'s parameters of the same
    model (a list of per-layer dicts of arrays: ``{"w", "b"}`` for GCN,
    ``{"w_self", "w_neigh", "b"}`` for GraphSAGE), so both packages
    compute with the same weights: every key of layer i becomes
    ``layers.{i}.{key}``."""
    state = {}
    for i, layer in enumerate(params):
        for name, value in layer.items():
            state[f"layers.{i}.{name}"] = torch.from_numpy(
                np.array(value, dtype=np.float32))
    return state


def dropout(h: torch.Tensor, p: float,
            generator: torch.Generator) -> torch.Tensor:
    """Inverted dropout: keep each entry with probability ``1 - p`` (a
    uniform draw from ``generator``, on ``h``'s device) and scale the kept
    ones by ``1 / (1 - p)``."""
    keep = torch.rand(h.shape, generator=generator, device=h.device) < (
        1.0 - p)
    return torch.where(keep, h / (1.0 - p), torch.zeros((), device=h.device))


class _Layer(nn.Module):
    """One layer's named parameters (``name=shape``), zeros until
    ``load_params`` or ``load_state_dict`` fills them."""

    def __init__(self, **shapes):
        super().__init__()
        for name, shape in shapes.items():
            self.register_parameter(name, nn.Parameter(torch.zeros(shape)))


def load_params(layers: nn.ModuleList, params) -> None:
    """Copy per-layer ``{name: tensor}`` dicts into ``layers``."""
    with torch.no_grad():
        for layer, p in zip(layers, params):
            for name, value in p.items():
                getattr(layer, name).copy_(value)


class GCN(nn.Module):
    """N-layer GCN bound to a graph on one device.

    The propagation operator is built once from the GCN-normalized
    adjacency. With ``precompute_first=True``, ``forward`` expects
    *prepared* features — ``prepare_features(X) == A @ X`` — and skips
    layer 1's propagation; ``models/train.py`` prepares them for you.

    ``loss_rows`` (a mask or row indices) restricts the last layer's
    propagation, forward and backward, to the rows the loss reads;
    ``forward(..., masked_output=True)`` then returns their [M, C]
    logits. Evaluation keeps the full propagation.
    """

    def __init__(self, graph: Graph, dims, dropout: float = 0.5,
                 schedule: str = "auto", impl: str = "xla",
                 remat: bool = False, dtype=None,
                 precompute_first: bool = False, loss_rows=None,
                 device="cuda", generator: torch.Generator | None = None):
        super().__init__()
        self.device = ensure_platform(device)
        self.dims = list(dims)
        self.dropout = dropout
        self.remat = remat
        self.precompute_first = precompute_first
        self.layers = nn.ModuleList(
            _Layer(**shapes) for shapes in _gcn_shapes(self.dims))
        self.propagate = aggregate_operator(graph, op="gcn",
                                            schedule=schedule, impl=impl,
                                            dtype=dtype, device=self.device)
        self.loss_rows = None
        self.propagate_masked = None
        if loss_rows is not None:
            op = masked_aggregate_operator(graph, loss_rows, op="gcn",
                                           schedule=schedule, impl=impl,
                                           dtype=dtype, device=self.device)
            self.loss_rows = op.rows
            self.propagate_masked = op
            self._loss_rows_t = torch.from_numpy(op.rows).to(self.device)
        self.init(generator if generator is not None
                  else torch.Generator().manual_seed(0))
        self.to(self.device)

    def init(self, generator: torch.Generator) -> "GCN":
        """Reset the parameters: Glorot weights from ``generator``."""
        load_params(self.layers, init_gcn(generator, self.dims))
        return self

    def operators(self) -> list:
        """The distinct SpMM operators of the model, forward and
        backward (their ``launches`` add up to the model's)."""
        ops = [self.propagate, self.propagate._vjp_op]
        if self.propagate_masked is not None:
            ops += [self.propagate_masked, self.propagate_masked._vjp_op]
        return list({id(op): op for op in ops}.values())

    def launches(self) -> int:
        return sum(op.launches for op in self.operators())

    def prepare_features(self, features) -> torch.Tensor:
        """Features as a float32 tensor on the model's device; with
        ``precompute_first=True``, ``A @ X`` instead (layer 1's
        propagation, hoisted out of every step: ``A(XW) == (AX)W``)."""
        if not isinstance(features, torch.Tensor):
            features = torch.from_numpy(np.asarray(features))
        features = features.to(self.device, torch.float32)
        if not self.precompute_first:
            return features
        with torch.no_grad():
            return self.propagate(features)

    def forward(self, h: torch.Tensor, *, masked_output: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        prop = self.propagate._fn
        if masked_output:
            if self.propagate_masked is None:
                raise ValueError("masked_output requires loss_rows=")
            prop_last = self.propagate_masked._fn
        else:
            prop_last = prop
        drop = self.training and self.dropout > 0
        if drop and generator is None:
            raise ValueError("dropout in train() mode draws from an "
                             "explicit torch.Generator: pass generator=")
        n = len(self.layers)
        for i, layer in enumerate(self.layers):
            skip = i == 0 and self.precompute_first
            last = i == n - 1
            if skip and last and masked_output:
                # layer 1's propagation is precomputed: the masked view is
                # the prepared rows at loss_rows
                h = h[self._loss_rows_t]
            fn = (lambda h, w, b, skip=skip, p=(prop_last if last else prop):
                  (h @ w + b) if skip else p(h @ w) + b)
            if self.remat and torch.is_grad_enabled():
                h = checkpoint(fn, h, layer.w, layer.b, use_reentrant=False)
            else:
                h = fn(h, layer.w, layer.b)
            if not last:
                h = torch.relu(h)
                if drop:
                    h = dropout(h, self.dropout, generator)
        return h
