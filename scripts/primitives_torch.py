#!/usr/bin/env python
"""SpMM (F = 32..512) and SDDMM on the arxiv-shaped adjacency, on the card.

The counterpart of ``scripts/tpu_primitives_bench.py`` for
``loops_tpu_torch``: the GCN-normalized adjacency of ``io/ogb.load(
"ogbn-arxiv")`` (169,343 nodes, 2,465,171 nonzeros at ``--scale 1``),
and for each F a markdown row of ms per apply (the median of CUDA-event
timings, ``utils/bench.apply_ms``; the host clock on the CPU) and millions
of edges per second: SpMM ``group_mapped`` and ``row_mapped`` ("scatter"),
SDDMM through the torch path in f32 and bf16, as the TPU script has them,
and SDDMM through kernel K5 (``impl="pallas"``, bf16).

    python scripts/primitives_torch.py [--device cuda] [--scale 1.0]

``--device cuda`` (the default) fails when no card is visible. At F = 512
the torch SDDMM path gathers two [nnz, 512] f32 arrays (5 GB each).
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from loops_tpu_torch.io import ogb  # noqa: E402
from loops_tpu_torch.ops.sddmm import SDDMMOperator  # noqa: E402
from loops_tpu_torch.ops.spmm import SpMMOperator  # noqa: E402
from loops_tpu_torch.utils.bench import apply_ms  # noqa: E402
from loops_tpu_torch.utils.platform import ensure_platform  # noqa: E402

COLUMNS = ("SpMM group_mapped", "SpMM scatter", "SDDMM f32", "SDDMM bf16",
           "SDDMM bf16 K5")


def main(argv=None) -> int:
    import torch

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--scale", type=float, default=1.0)
    p.add_argument("--features", type=int, nargs="+", default=[32, 128, 512])
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--repeats", type=int, default=3)
    args = p.parse_args(argv)
    device = ensure_platform(args.device)
    adj = ogb.load("ogbn-arxiv", scale=args.scale).graph.gcn_normalized().adj
    E, N = adj.nnz, adj.shape[0]
    print(f"adjacency: {N:,} nodes, {E:,} nnz (self-looped, normalized); "
          f"device={device}"
          + (f" ({torch.cuda.get_device_name(device)})"
             if device.type == "cuda" else ""), flush=True)
    print("| F | " + " | ".join(COLUMNS) + " |", flush=True)
    print("|---" * (len(COLUMNS) + 1) + "|", flush=True)
    rng = np.random.default_rng(0)
    ops = {
        "SpMM group_mapped": SpMMOperator(adj, "group_mapped", device=device),
        "SpMM scatter": SpMMOperator(adj, "row_mapped", device=device),
        "SDDMM f32": SDDMMOperator(adj, device=device),
        "SDDMM bf16": SDDMMOperator(adj, dtype="bfloat16", device=device),
        "SDDMM bf16 K5": SDDMMOperator(adj, impl="pallas", dtype="bfloat16",
                                       device=device),
    }
    for F in args.features:
        h = torch.from_numpy(rng.normal(size=(N, F)).astype(np.float32)).to(
            device)
        row = [f"| {F} "]
        for name in COLUMNS:
            op = ops[name]
            fn = op if name.startswith("SpMM") else (lambda v, op=op: op(v, v))
            ms = apply_ms(fn, h, iters=args.iters, repeats=args.repeats,
                          warmup=1)
            row.append(f"| {ms:.3f} ms ({E / ms * 1e-3:.0f} M e/s) ")
        print("".join(row) + "|", flush=True)
        del h
    k5 = ops["SDDMM bf16 K5"]
    print(f"impl_used: {k5.impl_used} launches: {k5.launches}",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
