"""Neighbour sampling: static-shape uniform k-neighbour sampling.

The port of ``loops_tpu/models/sampling.py``. Every fanout gives a dense
[batch, k] neighbour matrix (drawn with replacement; an isolated node
samples itself), so each hop is one fixed-shape gather on the device.

A draw is split from its mapping. ``sample_neighbors`` and
``sampled_block`` draw ``r`` in ``[0, 2^30)`` from an explicit
``torch.Generator``; ``neighbors_from_draws`` and ``block_from_draws``
map draws to ids, slot ``r % max(deg, 1)`` of each seed's CSR row. Fed
``jax.random.randint``'s draws, the mapping gives ``loops_tpu``'s ids
exactly (a torch generator cannot reproduce JAX's PRNG).

Sampling runs on the device asked for (``device="cuda"`` by default),
over the graph's CSR staged there once (``Graph.csr_on``). The generator
and any id tensor must already be on that device: a mismatch raises
``ValueError`` rather than draw on one device and move ids to another.
"""
from __future__ import annotations

import numpy as np
import torch

from loops_tpu_torch.models.graph import Graph
from loops_tpu_torch.utils.platform import ensure_platform, resolve_device

DRAW_HIGH = 1 << 30


def require_on(what: str, got, device) -> None:
    """Raise ``ValueError`` unless ``got`` (a device) is ``device``."""
    if resolve_device(got) != resolve_device(device):
        raise ValueError(f"{what} is on {got}, not on {device}: sampling "
                         "moves nothing between devices")


def node_ids(ids, device) -> torch.Tensor:
    """Node ids as int64 on ``device``: an array is staged there, a
    tensor must already be there."""
    if not isinstance(ids, torch.Tensor):
        return torch.from_numpy(np.array(ids)).to(device).long()
    require_on("a node id tensor", ids.device, device)
    return ids.long()


def neighbors_from_draws(graph: Graph, seeds, r) -> torch.Tensor:
    """[b, k] neighbour ids of ``seeds`` [b] from draws ``r`` [b, k] in
    ``[0, 2^30)``: slot ``r % max(deg, 1)`` of each seed's CSR row; an
    isolated seed gives itself. Runs on ``r``'s device, where a seed
    tensor must be too."""
    if not isinstance(r, torch.Tensor):
        r = torch.from_numpy(np.array(r))
    r = r.long()
    offsets, indices = graph.csr_on(r.device)
    seeds = node_ids(seeds, r.device)
    start = offsets[seeds]
    deg = offsets[seeds + 1] - start
    if indices.numel() == 0:
        return seeds[:, None].expand(r.shape).clone()
    slot = r % torch.clamp(deg, min=1)[:, None]
    # an isolated seed whose row starts at nnz would read one past the
    # last edge: clamp the read (as JAX clamps a gather), then take the
    # seed itself
    pos = torch.clamp(start[:, None] + slot, max=indices.numel() - 1)
    return torch.where(deg[:, None] > 0, indices[pos], seeds[:, None])


def sample_neighbors(graph: Graph, seeds, k: int,
                     generator: torch.Generator,
                     device="cuda") -> torch.Tensor:
    """Uniform-with-replacement neighbour sample: [b, k] int64 ids on
    ``device``, drawn from ``generator`` (one on ``device``). The graph is
    CSR with row = destination, columns = sources."""
    device = ensure_platform(device)
    require_on("the generator", generator.device, device)
    seeds = node_ids(seeds, device)
    r = torch.randint(0, DRAW_HIGH, (seeds.shape[0], k),
                      generator=generator, device=device)
    return neighbors_from_draws(graph, seeds, r)


def block_from_draws(graph: Graph, seeds, draws):
    """``sampled_block`` with hop i's draws given: ``draws[i]`` of shape
    [len(frontier_i), fanout_i], all on the device the ids come back on
    (a seed tensor's, where there is no hop)."""
    draws = [r if isinstance(r, torch.Tensor)
             else torch.from_numpy(np.array(r)) for r in draws]
    device = (draws[0].device if draws else
              seeds.device if isinstance(seeds, torch.Tensor) else "cpu")
    frontiers = [node_ids(seeds, device)]
    hops = []
    for r in draws:
        nbr = neighbors_from_draws(graph, frontiers[-1], r)
        hops.append(nbr)
        frontiers.append(nbr.reshape(-1))
    return hops, frontiers


def sampled_block(graph: Graph, seeds, fanouts, generator: torch.Generator,
                  device="cuda"):
    """Multi-hop sampled computation block: ``(hops, frontiers)``, hop i
    a [len(frontier_i), fanout_i] neighbour matrix and ``frontier[i+1]``
    its flattening, duplicates kept (fixed shapes; the duplicated work is
    the trade). Each hop's draws come from ``generator`` (one on
    ``device``), hop by hop."""
    device = ensure_platform(device)
    require_on("the generator", generator.device, device)
    seeds = node_ids(seeds, device)
    draws, b = [], seeds.shape[0]
    for fanout in fanouts:
        draws.append(torch.randint(0, DRAW_HIGH, (b, fanout),
                                   generator=generator, device=device))
        b *= fanout
    return block_from_draws(graph, seeds, draws)
