"""GraphSAGE: mean aggregator, full-graph and sampled-minibatch forms.

The port of ``loops_tpu/models/sage.py``. Layer:
``h' = relu(h W_self + mean_{j in N(i)} h_j W_neigh + b)``, with no relu
after the last. The full-graph form aggregates with one SpMM over the
row-normalized adjacency (``aggregate_operator(op="mean")``): under
``schedule="auto"`` the card's fitted route (K4 on the H100) and the
group_mapped planes on the CPU, as ``loops_tpu`` routes mean
aggregation; with ``schedule="merge_path", impl="pallas"`` kernel K4,
forward and, for the gradient, over the mean-normalized Aᵀ (which is not
symmetric). The minibatch form takes the fixed-shape [b, k] samples of
``models/sampling.py``: the mean over the fanout is a dense reduction.

``h @ W`` runs in float32 with TF32 off (PyTorch's default), as GCN's
does. State-dict names ``layers.{i}.w_self``, ``w_neigh`` and ``b`` map
one to one onto ``loops_tpu``'s parameter dicts (``params_from_jax``).
There is no dropout.
"""
from __future__ import annotations

import torch
from torch import nn

from loops_tpu_torch.models.gcn import _Layer, init_layers, load_params
from loops_tpu_torch.models.graph import Graph
from loops_tpu_torch.models.message_passing import aggregate_operator
from loops_tpu_torch.models.sampling import node_ids, require_on, sampled_block
from loops_tpu_torch.models.train import as_tensor, cross_entropy
from loops_tpu_torch.utils.platform import ensure_platform


def _shapes(dims):
    return [{"w_self": (dims[i], dims[i + 1]),
             "w_neigh": (dims[i], dims[i + 1]), "b": (dims[i + 1],)}
            for i in range(len(dims) - 1)]


def init_sage(generator: torch.Generator, dims):
    """dims = [in, hidden..., out]; returns ``[{"w_self", "w_neigh",
    "b"}, ...]`` of CPU tensors: Glorot-uniform weights drawn from
    ``generator``, zero biases."""
    return init_layers(generator, _shapes(dims))


class GraphSAGE(nn.Module):
    """N-layer mean-aggregator GraphSAGE bound to a graph on one device.

    ``dtype="bfloat16"`` is the aggregation's throughput mode (bf16
    operands, each product rounded to bf16, f32 sums), as for GCN.
    """

    def __init__(self, graph: Graph, dims, schedule: str = "auto",
                 impl: str = "xla", dtype=None, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        self.device = ensure_platform(device)
        self.graph = graph
        self.dims = list(dims)
        self.layers = nn.ModuleList(_Layer(**shapes)
                                    for shapes in _shapes(self.dims))
        self.aggregate = aggregate_operator(graph, op="mean",
                                            schedule=schedule, impl=impl,
                                            dtype=dtype, device=self.device)
        self.init(generator if generator is not None
                  else torch.Generator().manual_seed(0))
        self.to(self.device)

    def init(self, generator: torch.Generator) -> "GraphSAGE":
        """Reset the parameters: Glorot weights from ``generator``."""
        load_params(self.layers, init_sage(generator, self.dims))
        return self

    def operators(self) -> list:
        """The distinct SpMM operators, forward and backward (their
        ``launches`` add up to the model's)."""
        ops = [self.aggregate, self.aggregate._vjp_op]
        return list({id(op): op for op in ops}.values())

    def launches(self) -> int:
        return sum(op.launches for op in self.operators())

    def layer(self, i: int, h: torch.Tensor,
              neigh: torch.Tensor) -> torch.Tensor:
        """Layer ``i`` on its input ``h`` and the mean of the neighbours'
        inputs ``neigh``."""
        p = self.layers[i]
        h = h @ p.w_self + neigh @ p.w_neigh + p.b
        return h if i + 1 == len(self.layers) else torch.relu(h)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        """Full-graph forward: [N, F] -> [N, C]."""
        for i in range(len(self.layers)):
            h = self.layer(i, h, self.aggregate._fn(h))
        return h

    def sample_frontiers(self, seeds, fanouts,
                         generator: torch.Generator) -> list:
        """``[seeds, hop 1, ...]``: frontier d+1 holds frontier d's
        ``fanouts[d]`` sampled neighbours each, flattened; drawn on the
        model's device from ``generator``, which must be there too."""
        return sampled_block(self.graph, seeds, fanouts, generator,
                             device=self.device)[1]

    def apply_frontiers(self, features, frontiers, fanouts) -> torch.Tensor:
        """The minibatch forward over given frontiers (one fanout a
        layer): layer l transforms the representations of every depth
        left, and depth d+1 grouped by parent is a static [len(frontier_d),
        fanout_d, F] view whose mean is the neighbours'. Frontier tensors
        must be on the model's device. Returns the seeds' [b, C] logits."""
        L = len(self.layers)
        if len(fanouts) != L or len(frontiers) != L + 1:
            raise ValueError("need one fanout per layer and L + 1 "
                             "frontiers")
        features = as_tensor(features, self.device, torch.float32)
        reps = [features[node_ids(fr, self.device)] for fr in frontiers]
        for i in range(L):
            reps = [self.layer(i, reps[d], reps[d + 1].reshape(
                        reps[d].shape[0], fanouts[d], -1).mean(dim=1))
                    for d in range(L - i)]
        return reps[0]

    def apply_sampled(self, features, seeds, fanouts,
                      generator: torch.Generator) -> torch.Tensor:
        """The minibatch forward over fanouts sampled from ``generator``
        (one on the model's device)."""
        return self.apply_frontiers(
            features, self.sample_frontiers(seeds, fanouts, generator),
            fanouts)


def make_sampled_train_step(model: GraphSAGE, optimizer, features, labels,
                            fanouts, batch_size: int,
                            generator: torch.Generator):
    """Minibatch training with neighbour sampling: ``step() -> loss`` (a
    detached 0-d tensor). Each call draws ``batch_size`` seeds with
    ``torch.randint``, then each hop's samples, from ``generator`` (one on
    the model's device), and takes one step of ``optimizer``.

    ``step(seeds, frontiers)`` takes the step on given seeds and frontiers
    instead of drawing them (a replay, or ``loops_tpu``'s draws).
    ``step.frontiers`` holds the last step's frontiers.
    """
    device = model.device
    require_on("the generator", generator.device, device)
    features = as_tensor(features, device, torch.float32)
    labels = as_tensor(labels, device).long()
    n = features.shape[0]

    def step(seeds=None, frontiers=None):
        if seeds is None:
            seeds = torch.randint(0, n, (batch_size,), generator=generator,
                                  device=device)
            frontiers = model.sample_frontiers(seeds, fanouts, generator)
        seeds = node_ids(seeds, device)
        model.train()
        optimizer.zero_grad(set_to_none=True)
        logits = model.apply_frontiers(features, frontiers, fanouts)
        loss = cross_entropy(logits, labels[seeds])
        loss.backward()
        optimizer.step()
        step.frontiers = frontiers
        return loss.detach()

    step.frontiers = None
    return step
