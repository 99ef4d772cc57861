#!/usr/bin/env python
"""Accuracy and throughput record of the GNN model tier with the PyTorch +
CUDA port: the counterpart of ``scripts/train_record.py`` (3-layer GCN
and GraphSAGE, accuracy-matched).

Trains each model twice on the same dataset and seed: through the exact
f32 aggregation path (``schedule="group_mapped", impl="xla"``: torch ops,
no kernel) and through the throughput path (``schedule="auto",
dtype="bfloat16"``: on the H100 kernel K4 forward and backward, for GCN
with ``precompute_first``, for GraphSAGE's mean aggregation as ``auto``
routes it), then prints a markdown table of test accuracy and train-step
time. The throughput path must land within noise of the exact path.

With no local OGB copy the dataset is the size-matched synthetic
power-law stand-in (``io/ogb.py``); the dataset line says which one was
used. Each row's kernel launches per counter go to stderr.

    python scripts/train_record_torch.py --dataset ogbn-arxiv --epochs 100

``--device cuda`` (the default) fails when no card is visible; it never
falls back to the CPU.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from loops_tpu_torch.utils.platform import ensure_platform  # noqa: E402

MODES = ("exact", "throughput")


def model_kwargs(model_name: str, mode: str) -> dict:
    """The aggregation options of ``mode`` for ``model_name``."""
    if mode == "throughput":
        kw = dict(schedule="auto", dtype="bfloat16")
        if model_name == "gcn":
            kw["precompute_first"] = True   # (AX)W1 hoist, exact
        return kw
    if mode == "exact":
        return dict(schedule="group_mapped", impl="xla")
    raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")


def run_one(ds, model_name, mode, epochs, lr, hidden, seed, device="cuda"):
    """Train ``model_name`` (``gcn`` or ``sage``) on ``ds`` for ``epochs``
    full-graph steps in ``mode``. Returns ``(test accuracy, ms a step,
    M edges a second, launches per counter)``; the steps are timed after
    one warm-up step, the card synchronized before each clock read."""
    from loops_tpu_torch.models import GCN, GraphSAGE
    from loops_tpu_torch.models import train as T
    from loops_tpu_torch.ops.kernels import _build

    device = ensure_platform(device)
    dims = [ds.features.shape[1], hidden, hidden, ds.num_classes]
    kw = model_kwargs(model_name, mode)
    init = torch.Generator().manual_seed(seed)
    before = dict(_build.LAUNCHES)
    if model_name == "gcn":
        model = GCN(ds.graph, dims, dropout=0.5, device=device,
                    generator=init, **kw)
    elif model_name == "sage":
        model = GraphSAGE(ds.graph, dims, device=device, generator=init, **kw)
    else:
        raise ValueError(f"unknown model {model_name!r}; gcn or sage")
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    step = T.make_train_step(
        model, opt, ds.features, ds.labels, ds.train_mask,
        generator=torch.Generator(device).manual_seed(seed + 1))

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    step()   # warm-up
    sync()
    t0 = time.perf_counter()
    for _ in range(epochs - 1):
        step()
    sync()
    ms = (time.perf_counter() - t0) / max(epochs - 1, 1) * 1e3
    acc = float(T.evaluate(model, ds.features, ds.labels, ds.test_mask))
    launches = {k: n - before[k] for k, n in _build.LAUNCHES.items()
                if n != before[k]}
    eps = ds.graph.num_edges / (ms * 1e-3) / 1e6
    return acc, ms, eps, launches


def dataset_line(ds) -> str:
    src = "synthetic power-law fixture" if ds.synthetic else "real OGB"
    return (f"dataset={ds.name} ({src}) nodes={ds.graph.num_nodes:,} "
            f"edges={ds.graph.num_edges:,} classes={ds.num_classes}")


def table_row(model_name, mode, acc, ms, eps) -> str:
    return f"| {model_name} | {mode} | {acc:.4f} | {ms:.1f} | {eps:.1f} |"


TABLE_HEAD = ("| model | path | test acc | ms/step | M edges/s |",
              "|---|---|---|---|---|")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", default="ogbn-arxiv")
    p.add_argument("--scale", type=float, default=1.0)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--hidden", type=int, default=128)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--models", default="gcn,sage")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    device = ensure_platform(args.device)

    from loops_tpu_torch.io import ogb

    ds = ogb.load(args.dataset, scale=args.scale)
    print(dataset_line(ds) + "\n")
    print("\n".join(TABLE_HEAD))
    for model_name in args.models.split(","):
        for mode in MODES:
            acc, ms, eps, launches = run_one(
                ds, model_name, mode, args.epochs, args.lr, args.hidden,
                args.seed, device)
            print(table_row(model_name, mode, acc, ms, eps), flush=True)
            print(f"{model_name} {mode} launches: "
                  + (", ".join(f"{k} {n}" for k, n in sorted(
                      launches.items())) or "none"), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
