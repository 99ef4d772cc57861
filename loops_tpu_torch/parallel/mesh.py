"""Device meshes over ``torch.distributed``, and the differentiable
collectives the distributed ops run over their axes.

The port of ``loops_tpu/parallel/mesh.py``. JAX runs one controller over
every device; here each rank is a process of an initialised
``torch.distributed`` group, and a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the whole group with
the JAX package's axis names: ``graph`` shards graph rows (destination
nodes), ``model`` shards the feature dim, and the hierarchical mesh is
``("host", "chip")``. Ranks are laid out row-major, so on the
hierarchical mesh rank ``= host * chips + chip``: the host-major order in
which ``jax.devices()`` lists a pod's devices.

``device="cuda"`` (the default) needs an NCCL group and a card;
``device="cpu"`` a gloo group. Neither falls back to the other.

The collectives are ``torch.autograd.Function``s of the port's own:
``all_to_all`` of equal chunks along dim 0 (JAX's ``all_to_all(tiled=True,
split_axis=0, concat_axis=0)``), whose backward is the same exchange of
the gradient, and ``all_gather`` along dim 0, whose backward is
``reduce_scatter_tensor`` (sum).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from loops_tpu_torch.utils.platform import ensure_platform

__all__ = ["make_mesh", "make_mesh_2d", "make_mesh_hier", "axis_rank",
           "axis_size", "axis_group", "mesh_device", "all_to_all",
           "all_to_all_start", "all_gather", "all_reduce_sum"]

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def _gather_into(out, x, group):
    # all_gather_single is all_gather_into_tensor's newer name
    fn = getattr(dist, "all_gather_single", None) or (
        dist.all_gather_into_tensor)
    fn(out, x, group=group)


def _reduce_scatter_into(out, g, group):
    fn = getattr(dist, "reduce_scatter_single", None) or (
        dist.reduce_scatter_tensor)
    fn(out, g, op=dist.ReduceOp.SUM, group=group)


def _mesh(shape: tuple, names: tuple, device):
    from torch.distributed.device_mesh import init_device_mesh

    dev = ensure_platform(device)
    if not dist.is_initialized():
        raise RuntimeError(
            "no torch.distributed group: call init_process_group first "
            "(or run through loops_tpu_torch.parallel.launch)")
    backend = dist.get_backend()
    if backend != BACKENDS[dev.type]:
        raise ValueError(f"a {dev.type} mesh runs over {BACKENDS[dev.type]}; "
                         f"the group's backend is {backend}")
    world = dist.get_world_size()
    if int(np.prod(shape)) != world:
        raise ValueError(f"a {' x '.join(map(str, shape))} mesh needs "
                         f"{int(np.prod(shape))} ranks; the group has "
                         f"{world}")
    return init_device_mesh(dev.type, tuple(int(s) for s in shape),
                            mesh_dim_names=names)


def make_mesh(n_devices: int | None = None, axis: str = "graph",
              device="cuda"):
    """1-D mesh over the group's ``n_devices`` ranks (default: all;
    another count raises ``ValueError``)."""
    if n_devices is None:
        n_devices = dist.get_world_size() if dist.is_initialized() else 1
    return _mesh((n_devices,), (axis,), device)


def make_mesh_2d(graph: int, model: int, device="cuda"):
    """2-D mesh sharding graph rows x feature (model) dims: for wide-F
    distributed SpMM, where each model rank holds an F-slice (see
    DistSpMM's ``feature_axis``)."""
    return _mesh((graph, model), ("graph", "model"), device)


def make_mesh_hier(hosts: int, chips: int, device="cuda"):
    """Hierarchical (host x chip) mesh for the two-stage exchange
    (``parallel/hier.py``): the ``chip`` axis joins one host's ranks,
    the ``host`` axis the ranks of one chip index across hosts."""
    return _mesh((hosts, chips), ("host", "chip"), device)


def axis_rank(mesh, axis: str) -> int:
    """This rank's index along ``axis``."""
    return int(mesh.get_local_rank(axis))


def axis_size(mesh, axis: str) -> int:
    return int(mesh.size(list(mesh.mesh_dim_names).index(axis)))


def axis_group(mesh, axis: str):
    """The process group of this rank's line along ``axis``."""
    return mesh.get_group(axis)


def mesh_device(mesh) -> torch.device:
    """The device this rank's tensors live on: its current card for a
    CUDA mesh, else the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


class _AllToAll(torch.autograd.Function):
    """Chunk q of ``x`` (equal chunks along dim 0) goes to rank q of
    ``group``; chunk q of the result came from rank q. The backward sends
    each gradient chunk back where its chunk came from: the same
    exchange. Where ``pending`` is a list, the forward exchange is
    started asynchronously and its handle appended to it: the result
    holds the data only after the handle's ``wait()``."""

    @staticmethod
    def forward(ctx, x, group, pending):
        ctx.group = group
        out = torch.empty_like(x)
        work = dist.all_to_all_single(out, x.contiguous(), group=group,
                                      async_op=pending is not None)
        if pending is not None:
            pending.append(work)
        return out

    @staticmethod
    def backward(ctx, g):
        out = torch.empty_like(g)
        dist.all_to_all_single(out, g.contiguous(), group=ctx.group)
        return out, None, None


class _AllGather(torch.autograd.Function):
    """Every rank's ``x`` stacked along dim 0 in rank order; the backward
    sums the gradient over the ranks and keeps this rank's chunk
    (``reduce_scatter_tensor``)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        n = dist.get_world_size(group)
        out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
        _gather_into(out, x.contiguous(), group)
        return out

    @staticmethod
    def backward(ctx, g):
        n = dist.get_world_size(ctx.group)
        out = g.new_empty((g.shape[0] // n,) + tuple(g.shape[1:]))
        _reduce_scatter_into(out, g.contiguous(), ctx.group)
        return out, None


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable all-to-all of equal chunks along dim 0."""
    return _AllToAll.apply(x, group, None)


def all_to_all_start(x: torch.Tensor, group):
    """``(out, work)``: the all-to-all started asynchronously; ``out``
    holds the exchange after ``work.wait()``. Differentiable."""
    pending = []
    out = _AllToAll.apply(x, group, pending)
    return out, pending[0]


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable all-gather along dim 0."""
    return _AllGather.apply(x, group)


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group`` (default: all), in
    place; not differentiable."""
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x
