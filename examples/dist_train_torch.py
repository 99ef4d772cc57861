#!/usr/bin/env python
"""Distributed GCN training over a mesh of ranks with the PyTorch + CUDA
port: the counterpart of ``examples/dist_train.py`` for
``loops_tpu_torch``.

    python examples/dist_train_torch.py --epochs 20
    python examples/dist_train_torch.py --device cpu --world 8 \
        --exchange hier --hosts 2

On a card (``--device cuda``, the default) it runs as one NCCL rank in
this process, or as ``--world`` spawned NCCL ranks, one a card, where
that many cards are visible; it never falls back to the CPU. With
``--device cpu`` it spawns ``--world`` gloo ranks (default 8). Each rank
holds an edge-balanced row slice of the GCN-normalized graph and
aggregates it with K4 (its plain version on the CPU); ``--exchange``
picks how the ranks share boundary features. Prints the dataset line,
``epoch … loss …`` lines and ``test_accuracy:`` (the trained parameters
on the single-device GCN) and ``train_time_s: … edges_per_s:``; the
kernel launches go to stderr.
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from loops_tpu_torch.parallel import launch, workers  # noqa: E402


def main(argv=None):
    import numpy as np
    import torch

    from loops_tpu_torch.io import ogb
    from loops_tpu_torch.models import GCN
    from loops_tpu_torch.models import train as T
    from loops_tpu_torch.utils.platform import ensure_platform

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", default="tiny")
    p.add_argument("--scale", type=float, default=1.0)
    p.add_argument("--hidden", type=int, default=64)
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--exchange", default="all_gather",
                   choices=["all_gather", "halo", "hier"])
    p.add_argument("--hosts", type=int, default=2,
                   help="host-axis size for --exchange hier")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--world", type=int, default=None,
                   help="ranks (default: 1 on a card, 8 on the CPU)")
    args = p.parse_args(argv)

    device = ensure_platform(args.device)
    world = args.world or (1 if device.type == "cuda" else 8)
    ds = ogb.load(args.dataset, scale=args.scale)
    if args.exchange == "hier":
        hosts = min(args.hosts, world)
        if world % hosts:
            p.error(f"--world {world} is not a multiple of --hosts {hosts}")
        mesh = ("hier", hosts, world // hosts)
    else:
        mesh = "flat"
    print(f"dataset={ds.name} nodes={ds.graph.num_nodes:,} "
          f"edges={ds.graph.num_edges:,} devices={world} "
          f"exchange={args.exchange} backend="
          f"{'nccl' if device.type == 'cuda' else 'gloo'}", flush=True)

    dims = [ds.features.shape[1], args.hidden, ds.num_classes]
    case = ("train", mesh, dict(
        kind="gcn", graph=ds.graph, dims=dims, params=None, X=ds.features,
        y=ds.labels, mask=ds.train_mask, lr=args.lr, steps=args.epochs,
        exchange=args.exchange))
    res = launch.run(workers.run_cases, world, [case], device.type,
                     device=device)
    r0 = [r[0] for r in res]
    losses = r0[0]["losses"]
    for epoch, loss in enumerate(losses):
        if epoch % max(args.epochs // 5, 1) == 0:
            print(f"epoch {epoch:4d} loss {loss:.4f}")
    # the step time is the slowest rank's; the first step builds the
    # kernels and is left out where there are others
    secs = np.max([r["seconds"] for r in r0], axis=0)
    timed = secs[1:] if len(secs) > 1 else secs
    dt = float(timed.sum())
    eps = ds.graph.num_edges * len(timed) / dt

    # evaluate the trained parameters on the single-device model
    single = GCN(ds.graph, dims, dropout=0.0, device=device)
    single.load_state_dict({f"layers.{i}.{k}": torch.from_numpy(v)
                            for i, layer in enumerate(r0[0]["params"])
                            for k, v in layer.items()})
    acc = T.evaluate(single, ds.features, ds.labels, ds.test_mask)
    print(f"test_accuracy: {acc:.4f}")
    print(f"train_time_s: {dt:.3f}  edges_per_s: {eps:,.0f}")
    print(f"kernel launches per rank: {[r['launches'] for r in r0]} "
          f"({'K4' if device.type == 'cuda' else 'plain versions'})",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
