"""Distributed sparse ops and GNNs over a device mesh.

The port of ``loops_tpu/parallel/dist_ops.py`` to one process per rank
under ``torch.distributed``. The adjacency's rows are edge-balanced
across the ``graph`` axis (``parallel/graph_partition.py``); rank p holds
its [rows_per_dev, F] slice of the stacked features, and every op takes
and returns that slice. The **default exchange is the overlapped
targeted halo** (``parallel/halo.py``): each layer a rank ships only the
boundary features its neighbours reference (O(P*H*F)) by one
all-to-all, overlapped with the interior reduction. ``exchange=
"all_gather"`` keeps the O(N*F)-per-rank mode as the oracle, and
``"hier"`` the two-stage exchange of ``parallel/hier.py``.

Every exchange is differentiable: ``all_gather``'s backward is a
reduce-scatter, ``all_to_all``'s the reverse all-to-all
(``parallel/mesh.py``). Each rank's local reduction is one
``SpMMOperator`` over its own CSR: K4 on a card, forward and over the
transpose backward, its plain version on the CPU.

The models hold replicated parameters (``torch.nn`` modules with the
layouts of ``models/gcn.py`` and ``models/sage.py``, so
``params_from_jax`` carries ``loops_tpu``'s parameters over). JAX's
``value_and_grad`` through ``shard_map`` sums the replicated parameters'
gradients over the devices; here ``make_train_step`` sums them over the
ranks (one ``all_reduce``) before the optimizer's step, so every rank
takes the same step and keeps the same parameters.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from loops_tpu_torch.models.gcn import _Layer, init_gcn, load_params
from loops_tpu_torch.models.graph import Graph
from loops_tpu_torch.models.sage import init_sage
from loops_tpu_torch.parallel.graph_partition import EdgePartition
from loops_tpu_torch.parallel.halo import as_rows, local_operator
from loops_tpu_torch.parallel.mesh import (
    all_gather,
    all_reduce_sum,
    axis_group,
    axis_rank,
    axis_size,
    mesh_device,
)

__all__ = ["DistSpMM", "DistGCN", "DistGraphSAGE"]


class DistSpMM:
    """Distributed SpMM with the all-gather exchange, rank p's part:
    ``op(h) : [rows_per_dev, F] -> [rows_per_dev, F]``.

    ``feature_axis`` names a second mesh axis (``"model"`` of
    ``make_mesh_2d``) that shards the feature dim: SpMM is independent
    over F, so each model rank reduces its own F-slice (its ``h`` is that
    slice) with no exchange along the feature axis: the wide-F mode.
    """

    def __init__(self, plan: EdgePartition, mesh,
                 feature_axis: str | None = None):
        if feature_axis is not None and (
                feature_axis not in mesh.mesh_dim_names):
            raise ValueError(
                f"feature_axis {feature_axis!r} not in mesh axes "
                f"{tuple(mesh.mesh_dim_names)}")
        P, R = plan.num_devices, plan.rows_per_dev
        if axis_size(mesh, "graph") != P:
            raise ValueError(f"the plan has {P} partitions, the mesh's "
                             f"graph axis {axis_size(mesh, 'graph')} ranks")
        self.plan = plan
        self.mesh = mesh
        self.feature_axis = feature_axis
        self.device = mesh_device(mesh)
        self.group = axis_group(mesh, "graph")
        self.p = p = axis_rank(mesh, "graph")
        self.local = local_operator(
            plan.local_csr(p, plan.indices_padded, P * R), self.device)
        self.operators = [self.local]

    def __call__(self, h) -> torch.Tensor:
        h = as_rows(h, self.device)
        return self.local._fn(all_gather(h, self.group))


def _build_propagate(plan, mesh, exchange: str, overlap: bool):
    """The exchange a distributed model propagates through.

    ``halo`` with ``overlap`` is the default and the scalable path; it
    moves only the boundary features each layer and overlaps the
    all-to-all with the interior reduction. ``all_gather`` is the
    oracle.
    """
    if exchange == "halo":
        from loops_tpu_torch.parallel.halo import DistSpMMHalo, HaloPlan
        return DistSpMMHalo(HaloPlan.build(plan), mesh, overlap=overlap)
    if exchange == "hier":
        from loops_tpu_torch.parallel.hier import DistSpMMHier, HierHaloPlan
        if tuple(mesh.mesh_dim_names) != ("host", "chip"):
            raise ValueError(
                'exchange="hier" needs a ("host", "chip") mesh '
                "(parallel.mesh.make_mesh_hier)")
        hosts, chips = axis_size(mesh, "host"), axis_size(mesh, "chip")
        return DistSpMMHier(HierHaloPlan.build(plan, hosts, chips), mesh)
    if exchange == "all_gather":
        return DistSpMM(plan, mesh)
    raise ValueError(f"unknown exchange {exchange!r}")


def _partition(graph, mesh, num_devices, normalize: str):
    g = graph if isinstance(graph, Graph) else Graph(graph)
    norm = g.gcn_normalized() if normalize == "gcn" else g.mean_normalized()
    P = num_devices or int(np.prod(mesh.mesh.shape))
    return EdgePartition.build(norm.adj, P)


class _DistModel(nn.Module):
    """What DistGCN and DistGraphSAGE share: the partition, the exchange,
    replicated parameters, the rank's features and the train step."""

    def __init__(self, plan, mesh, dims, exchange, overlap, shapes,
                 generator):
        super().__init__()
        self.plan = plan
        self.mesh = mesh
        self.dims = list(dims)
        self.device = mesh_device(mesh)
        self.propagate = _build_propagate(plan, mesh, exchange, overlap)
        self.p = self.propagate.p
        self.layers = nn.ModuleList(_Layer(**s) for s in shapes)
        self.init(generator if generator is not None
                  else torch.Generator().manual_seed(0))
        self.to(self.device)

    def local_features(self, features) -> torch.Tensor:
        """This rank's [rows_per_dev, F] slice of the [N, F] features."""
        return as_rows(self.plan.local_features(
            np.asarray(features, np.float32), self.p), self.device)

    def operators(self) -> list:
        """The distinct SpMM operators of the rank, forward and backward."""
        ops = [o for op in self.propagate.operators for o in (op, op._vjp_op)]
        return list({id(op): op for op in ops}.values())

    def launches(self) -> int:
        return sum(op.launches for op in self.operators())

    def make_train_step(self, optimizer, features, labels, train_mask):
        """Full-graph training over the partition: ``step() -> loss``, the
        global masked cross-entropy (a detached 0-d tensor, equal on every
        rank). Each rank's masked NLL sum is divided by the global mask
        count; the parameters' gradients are summed over the ranks (one
        ``all_reduce``) before ``optimizer.step()``. Every rank must call
        ``step`` the same number of times."""
        h0 = self.local_features(features)
        lab = torch.from_numpy(self.plan.local_features(
            np.asarray(labels), self.p)).to(self.device).long()
        msk = torch.from_numpy(self.plan.local_features(
            np.asarray(train_mask, np.float32), self.p)).to(self.device)
        count = all_reduce_sum(msk.sum())
        denom = torch.clamp(count, min=1.0)
        params = list(self.parameters())

        def step():
            self.train()
            optimizer.zero_grad(set_to_none=True)
            logp = torch.log_softmax(self(h0), dim=1)
            nll = -torch.take_along_dim(logp, lab[:, None], dim=1)[:, 0]
            loss = (nll * msk).sum() / denom
            loss.backward()
            flat = all_reduce_sum(torch.cat([q.grad.reshape(-1)
                                             for q in params]))
            for q, g in zip(params, torch.split(flat, [q.numel()
                                                       for q in params])):
                q.grad.copy_(g.reshape(q.shape))
            optimizer.step()
            return all_reduce_sum(loss.detach().clone())

        return step


class DistGCN(_DistModel):
    """Distributed GCN: per layer ``A_hat (H W) + b`` with H row-sharded
    and W replicated. The GCN-normalized adjacency is partitioned once at
    construction; ``plan=`` takes a prebuilt partition of it instead
    (``EdgePartition.from_shards`` over an out-of-core store), and
    ``graph`` is then ignored. Default exchange: the overlapped halo."""

    def __init__(self, graph, dims, mesh, num_devices: int | None = None,
                 exchange: str = "halo", overlap: bool = True,
                 plan: EdgePartition | None = None,
                 generator: torch.Generator | None = None):
        if plan is None:
            plan = _partition(graph, mesh, num_devices, "gcn")
        dims = list(dims)
        super().__init__(plan, mesh, dims, exchange, overlap,
                         [{"w": (dims[i], dims[i + 1]), "b": (dims[i + 1],)}
                          for i in range(len(dims) - 1)], generator)

    def init(self, generator: torch.Generator) -> "DistGCN":
        """Glorot weights from ``generator``, zero biases: the same draw
        on every rank from the same seed."""
        load_params(self.layers, init_gcn(generator, self.dims))
        return self

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        n = len(self.layers)
        for i, layer in enumerate(self.layers):
            h = self.propagate(h @ layer.w) + layer.b
            if i + 1 < n:
                h = torch.relu(h)
        return h


class DistGraphSAGE(_DistModel):
    """Distributed GraphSAGE: ``h' = act(h W_self + meanagg(h) W_neigh +
    b)`` with the mean-normalized adjacency partitioned as DistGCN's."""

    def __init__(self, graph, dims, mesh, num_devices: int | None = None,
                 exchange: str = "halo", overlap: bool = True,
                 generator: torch.Generator | None = None):
        dims = list(dims)
        super().__init__(_partition(graph, mesh, num_devices, "mean"), mesh,
                         dims, exchange, overlap,
                         [{"w_self": (dims[i], dims[i + 1]),
                           "w_neigh": (dims[i], dims[i + 1]),
                           "b": (dims[i + 1],)}
                          for i in range(len(dims) - 1)], generator)

    def init(self, generator: torch.Generator) -> "DistGraphSAGE":
        load_params(self.layers, init_sage(generator, self.dims))
        return self

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        n = len(self.layers)
        for i, layer in enumerate(self.layers):
            neigh = self.propagate(h)
            h = h @ layer.w_self + neigh @ layer.w_neigh + layer.b
            if i + 1 < n:
                h = torch.relu(h)
        return h
