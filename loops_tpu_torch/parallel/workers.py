"""Per-rank entry points of the distributed tier, for ``launch.run_ranks``.

Each builds the tier's objects on its rank from host inputs that every
rank receives alike (a CSR, features, ``loops_tpu``-layout parameters as
numpy arrays), runs them, and returns plain data: the rank's slice of
the result, losses, gradients. They live in the package so that spawned
ranks import the port alone. ``run_cases`` runs a list of them in one
group, in order, on meshes it builds once; the CLIs and ``chip_smoke.py``
call the others directly.
"""
from __future__ import annotations

import time

import numpy as np
import torch

__all__ = ["run_cases", "spmm_case", "model_case", "train_case",
           "scaling_rank", "store_train_rank", "dryrun_rank", "mesh_for",
           "autograd_ops"]

# autograd nodes of a scatter or an atomic accumulation (gather backwards
# through index_put, index_add, scatter_add)
SCATTER_NODES = ("IndexAdd", "IndexPut", "Scatter", "IndexBackward",
                 "EmbeddingBackward")


def mesh_for(kind, device="cuda", cache: dict | None = None):
    """The mesh named by ``kind``: ``"flat"`` (1-D ``graph`` over every
    rank), ``("hier", hosts, chips)`` or ``("2d", graph, model)``; kept in
    ``cache`` where given, so that a group builds each mesh once."""
    from loops_tpu_torch.parallel import mesh as M

    key = (kind if isinstance(kind, str) else tuple(kind), str(device))
    if cache is not None and key in cache:
        return cache[key]
    if kind == "flat":
        m = M.make_mesh(device=device)
    elif kind[0] == "hier":
        m = M.make_mesh_hier(kind[1], kind[2], device=device)
    elif kind[0] == "2d":
        m = M.make_mesh_2d(kind[1], kind[2], device=device)
    else:
        raise ValueError(f"unknown mesh {kind!r}")
    if cache is not None:
        cache[key] = m
    return m


def autograd_ops(t: torch.Tensor) -> set:
    """The names of every node of ``t``'s autograd graph."""
    seen, names, todo = set(), set(), [t.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or id(fn) in seen:
            continue
        seen.add(id(fn))
        names.add(type(fn).__name__)
        todo.extend(nxt for nxt, _ in fn.next_functions)
    return names


def _exchange_op(part, mesh, protocol: str):
    from loops_tpu_torch.parallel.dist_ops import DistSpMM, _build_propagate

    if protocol == "feature_axis":
        return DistSpMM(part, mesh, feature_axis="model")
    if protocol == "halo_overlap":
        return _build_propagate(part, mesh, "halo", True)
    return _build_propagate(part, mesh, protocol, False)


def spmm_case(mesh, csr=None, X=None, protocol: str = "halo_overlap",
              grad: bool = True, store: str | None = None,
              chips_per_shard: int | None = None) -> dict:
    """One distributed SpMM of ``X`` [N, F] over ``csr`` (or over the
    ``ShardedCSR`` at ``store``, partitioned by ``from_shards``) through
    ``protocol`` (``all_gather``, ``feature_axis`` on a 2-D mesh,
    ``halo``, ``halo_overlap``, ``hier``). Returns the rank's index
    ``p``, its [rows_per_dev, F] output (its F-slice for
    ``feature_axis``) and, with ``grad``, the gradient of
    ``sum(out ** 2)`` over every rank with respect to the rank's input,
    and the names of the autograd graph's nodes."""
    from loops_tpu_torch.parallel.graph_partition import EdgePartition
    from loops_tpu_torch.parallel.mesh import axis_rank, axis_size

    if store is not None:
        from loops_tpu_torch.io.shards import ShardedCSR

        part = EdgePartition.from_shards(ShardedCSR.open(store),
                                         chips_per_shard)
    else:
        part = EdgePartition.build(csr, axis_size(
            mesh, "graph") if "graph" in mesh.mesh_dim_names
            else int(np.prod(mesh.mesh.shape)))
    op = _exchange_op(part, mesh, protocol)
    h = part.local_features(np.asarray(X, np.float32), op.p)
    if protocol == "feature_axis":
        m, M = axis_rank(mesh, "model"), axis_size(mesh, "model")
        w = h.shape[1] // M
        h = np.ascontiguousarray(h[:, m * w:(m + 1) * w])
    h = torch.from_numpy(h).to(op.device).requires_grad_(grad)
    out = op(h)
    res = {"p": op.p, "out": out.detach().cpu().numpy(),
           "launches": sum(o.launches for o in op.operators)}
    if grad:
        loss = (out ** 2).sum()
        res["ops"] = sorted(autograd_ops(loss))
        loss.backward()
        res["grad"] = h.grad.cpu().numpy()
    return res


def _model(mesh, kind: str, graph, dims, params, exchange, overlap,
           plan=None):
    from loops_tpu_torch.models.gcn import params_from_jax
    from loops_tpu_torch.parallel.dist_ops import DistGCN, DistGraphSAGE

    if kind == "gcn":
        model = DistGCN(graph, dims, mesh, exchange=exchange,
                        overlap=overlap, plan=plan)
    elif kind == "sage":
        model = DistGraphSAGE(graph, dims, mesh, exchange=exchange,
                              overlap=overlap)
    else:
        raise ValueError(f"unknown model {kind!r}")
    if params is not None:
        model.load_state_dict(params_from_jax(params))
    return model


def model_case(mesh, kind: str, graph, dims, params, X,
               exchange: str = "halo", overlap: bool = True) -> dict:
    """The forward of a distributed GCN (``kind="gcn"``) or GraphSAGE
    (``"sage"``) from ``params``: the rank's index and logits."""
    model = _model(mesh, kind, graph, dims, params, exchange, overlap)
    model.eval()
    with torch.no_grad():
        out = model(model.local_features(X))
    return {"p": model.p, "out": out.cpu().numpy()}


def _param_dicts(model) -> list:
    return [{k: v.detach().cpu().numpy().copy()
             for k, v in layer.named_parameters()} for layer in model.layers]


def train_case(mesh, kind: str, graph, dims, params, X, y, mask,
               lr: float = 1e-2, steps: int = 5, exchange: str = "halo",
               overlap: bool = True, optimizer: str = "adam",
               plan=None) -> dict:
    """``steps`` full-graph train steps of a distributed model from
    ``params`` (default: the port's draw from seed 0) with
    ``torch.optim.Adam`` (or ``"sgd"``) at ``lr``: the global losses, the
    host seconds of each step, the summed parameter gradients of the
    first step and the parameters after the last step, as
    ``[{name: array}, ...]``, and the rank's kernel launches."""
    model = _model(mesh, kind, graph, dims, params, exchange, overlap,
                   plan=plan)
    opt = (torch.optim.Adam if optimizer == "adam" else torch.optim.SGD)(
        model.parameters(), lr=lr)
    step = model.make_train_step(opt, X, y, mask)
    losses, grads, seconds = [], None, []
    for i in range(steps):
        t0 = time.perf_counter()
        losses.append(float(step()))  # a host copy: the step has ended
        seconds.append(time.perf_counter() - t0)
        if i == 0:
            grads = [{k: v.grad.cpu().numpy().copy()
                      for k, v in layer.named_parameters()}
                     for layer in model.layers]
    return {"p": model.p, "losses": losses, "grads": grads,
            "seconds": seconds, "params": _param_dicts(model),
            "launches": model.launches()}


def toy_graph(n: int, avg_deg: int, seed: int = 0):
    """``__graft_entry__._toy_graph``: a random undirected graph."""
    from loops_tpu_torch.models.graph import Graph

    rng = np.random.default_rng(seed)
    m = n * avg_deg
    return Graph.from_edges(rng.integers(0, n, m), rng.integers(0, n, m),
                            n, make_undirected=True)


def dryrun_rank(rank: int, world: int, params=None) -> dict:
    """One rank of ``launch.dryrun_multichip``: the shapes of
    ``__graft_entry__.dryrun_multichip`` (512 rows a rank, F = 8, dims
    [8, 16, 4], Adam at 1e-2), on gloo."""
    from loops_tpu_torch.parallel.halo import DistSpMMHalo

    n, f, classes = 512 * world, 8, 4
    graph = toy_graph(n, 4, seed=2)
    rng = np.random.default_rng(3)
    feats = rng.normal(size=(n, f)).astype(np.float32)
    labels = rng.integers(0, classes, n).astype(np.int32)
    mask = np.ones(n, np.float32)
    dims = [f, 16, classes]
    cache = {}
    flat = mesh_for("flat", "cpu", cache)

    def one_step(mesh, exchange):
        model = _model(mesh, "gcn", graph, dims, params, exchange, True)
        opt = torch.optim.Adam(model.parameters(), lr=1e-2)
        return model, float(model.make_train_step(opt, feats, labels,
                                                  mask)())

    model, loss = one_step(flat, "halo")
    if not (isinstance(model.propagate, DistSpMMHalo)
            and model.propagate.overlap):
        raise RuntimeError("the default exchange is not the overlapped halo")
    res = {"loss": loss, "oracle_loss": one_step(flat, "all_gather")[1],
           "hier_loss": None}
    if world % 2 == 0 and world >= 4:
        hmodel, res["hier_loss"] = one_step(
            mesh_for(("hier", 2, world // 2), "cpu", cache), "hier")
        if rank == 0:
            res.update(hmodel.propagate.plan.volume_stats())
    return res


def scaling_rank(rank: int, world: int, csr, X, protocols, iters: int,
                 device="cuda") -> dict:
    """One rank of ``scripts/bench_scaling_torch.py``: the distributed
    SpMM of ``X`` over ``csr`` through each of ``protocols``, timed by
    ``utils/bench.apply_ms`` (CUDA events on a card, the host clock on the
    CPU) and, on a card, ``device_ms``. Returns ``{protocol: (apply_ms,
    device_ms)}``, ``device_ms`` None on the CPU and where ``device_ms``
    refused every hold (``HoldExpired``)."""
    from loops_tpu_torch.parallel.graph_partition import EdgePartition
    from loops_tpu_torch.utils import bench

    mesh = mesh_for("flat", device)
    part = EdgePartition.build(csr, world)
    out = {}
    for proto in protocols:
        op = _exchange_op(part, mesh, proto)
        h = torch.from_numpy(part.local_features(
            np.asarray(X, np.float32), op.p)).to(op.device)
        with torch.no_grad():
            ms = bench.apply_ms(op, h, iters=iters)
            card = None
            if h.is_cuda:
                try:
                    card = bench.device_ms(op, h)
                except bench.HoldExpired:  # not measured: left None
                    pass
        out[proto] = (ms, card)
    return out


def store_train_rank(rank: int, world: int, store: str, hosts: int,
                     dims, steps: int, lr: float = 1e-2,
                     device="cuda") -> dict:
    """One rank of ``scripts/outofcore_mesh_train_torch.py``: the
    GCN-normalized ``ShardedCSR`` at ``store`` (one shard a host)
    partitioned by ``EdgePartition.from_shards`` over ``world // hosts``
    chips a host, with no global CSR, and ``steps`` Adam steps of a
    DistGCN through the hierarchical exchange. The features, labels and
    mask are ``X.npy``, ``labels.npy`` and ``mask.npy`` in ``store``,
    read memory-mapped: a rank reads its own rows."""
    import os

    from loops_tpu_torch.io.shards import ShardedCSR
    from loops_tpu_torch.parallel.graph_partition import EdgePartition

    mesh = mesh_for(("hier", hosts, world // hosts), device)
    t0 = time.perf_counter()
    part = EdgePartition.from_shards(ShardedCSR.open(store), world // hosts)
    plan_s = time.perf_counter() - t0
    arrays = {k: np.load(os.path.join(store, f"{k}.npy"), mmap_mode="r")
              for k in ("X", "labels", "mask")}
    res = train_case(mesh, "gcn", None, dims, None, arrays["X"],
                     arrays["labels"], arrays["mask"], lr=lr, steps=steps,
                     exchange="hier", plan=part)
    res.update(plan_s=plan_s, rows_per_dev=part.rows_per_dev,
               nnz_per_dev=part.nnz_per_dev)
    del res["grads"], res["params"]
    return res


CASES = {"spmm": spmm_case, "model": model_case, "train": train_case}


def run_cases(rank: int, world: int, cases, device="cuda") -> list:
    """Run ``cases`` (``[(kind, mesh kind, kwargs), ...]``, kind one of
    ``CASES``) in order on this rank, the meshes built once; returns each
    case's result."""
    cache = {}
    return [CASES[kind](mesh_for(mk, device, cache), **kw)
            for kind, mk, kw in cases]
