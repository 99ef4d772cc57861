#!/usr/bin/env python
"""Train a 3-layer GCN, GraphSAGE or GAT on an OGB-style node-classification
dataset with the PyTorch + CUDA port — the counterpart of
``examples/train_gcn.py`` for ``loops_tpu_torch``.

Uses a local OGB copy under ``datasets/`` when present, otherwise a
size-matched synthetic power-law graph (the same one ``loops_tpu``
builds). Prints the dataset line, ``epoch … loss … val …`` lines, and
``test_accuracy:`` / ``train_time_s: … edges_per_s:``; the aggregation
path (``impl_used``) and the kernel launches go to stderr.

    python examples/train_gcn_torch.py --dataset ogbn-arxiv --scale 1.0 \
        --epochs 20

``--device cuda`` (the default) fails when no card is visible; it never
falls back to the CPU. On the card the GCN aggregation runs kernel K4,
forward and backward. ``--model sage`` trains full-graph GraphSAGE (dims
[F, hidden, hidden, classes], mean aggregation as ``schedule="auto"``
routes it: K4 on the H100, the group_mapped planes on the CPU; no
dropout). ``--model gat`` trains
full-graph GAT (the same dims, 4 heads, the fused attention with its
transposed-plan backward; no dropout; the launches printed are every
kernel counter's, which stay 0 on this path), as ``examples/train_gcn.py``
does.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from loops_tpu_torch.io import ogb  # noqa: E402
from loops_tpu_torch.models import GAT, GCN, GraphSAGE  # noqa: E402
from loops_tpu_torch.models import train as T  # noqa: E402
from loops_tpu_torch.ops.kernels import _build  # noqa: E402
from loops_tpu_torch.utils.platform import ensure_platform  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", default="ogbn-arxiv")
    p.add_argument("--scale", type=float, default=0.05,
                   help="node-count scale for the synthetic fallback")
    p.add_argument("--model", default="gcn", choices=["gcn", "sage", "gat"])
    p.add_argument("--hidden", type=int, default=128)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--dropout", type=float, default=0.5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--steps-per-call", type=int, default=None,
                   help="training steps between printed evaluations")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    device = ensure_platform(args.device)
    ds = ogb.load(args.dataset, scale=args.scale)
    print(f"dataset={ds.name}{' (synthetic)' if ds.synthetic else ''} "
          f"nodes={ds.graph.num_nodes:,} edges={ds.graph.num_edges:,} "
          f"feat={ds.features.shape[1]} classes={ds.num_classes}")

    dims = [ds.features.shape[1], args.hidden, args.hidden, ds.num_classes]
    init = torch.Generator().manual_seed(args.seed)
    if args.model == "gat":
        model = GAT(ds.graph, dims, heads=4, device=device, generator=init)
        route = None    # torch ops: LAUNCHES counts any kernel it runs
    elif args.model == "sage":
        model = GraphSAGE(ds.graph, dims, device=device, generator=init)
        route = model.aggregate
    else:
        model = GCN(ds.graph, dims, dropout=args.dropout, device=device,
                    generator=init)
        route = model.propagate
    opt = torch.optim.Adam(model.parameters(), lr=args.lr)
    spc = (max(args.epochs // 10, 1) if args.steps_per_call is None
           else args.steps_per_call)
    epochs = T.make_train_epochs(
        model, opt, ds.features, ds.labels, ds.train_mask,
        steps_per_call=spc,
        generator=torch.Generator(device).manual_seed(args.seed + 1))

    _build.reset_launches()
    t0 = time.time()
    for epoch in range(0, args.epochs, spc):
        loss = epochs()
        if (epoch // spc) % max(args.epochs // spc // 10, 1) == 0:
            val = T.evaluate(model, ds.features, ds.labels, ds.val_mask)
            print(f"epoch {epoch:4d} loss {float(loss):.4f} val {val:.4f}")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0

    test = T.evaluate(model, ds.features, ds.labels, ds.test_mask)
    eps = ds.graph.num_edges * args.epochs / dt
    print(f"test_accuracy: {test:.4f}")
    print(f"train_time_s: {dt:.1f}  edges_per_s: {eps:,.0f}")
    if route is None:
        impl = "fused" if model.fused else "textbook"
        launches = sum(_build.LAUNCHES.values())
    else:
        impl, launches = route.impl_used, model.launches()
    print(f"impl_used: {impl} launches: {launches}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
