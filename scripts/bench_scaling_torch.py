#!/usr/bin/env python
"""Multi-rank scaling of the distributed SpMM (the aggregation layer):
edges a second at 1, 2, 4, ... ranks for the all-gather and the
overlapped halo exchange, the counterpart of ``scripts/bench_scaling.py``
for ``loops_tpu_torch``.

    python scripts/bench_scaling_torch.py --nodes 20000
    python scripts/bench_scaling_torch.py --device cpu --world 8 \
        --nodes 20000
    python scripts/bench_scaling_torch.py --volume-model --world 64

On a card (``--device cuda``, the default) it runs on 1 to ``--world``
NCCL ranks, one a card, as many as are visible (one rank in this
process); each time is ``utils/bench.apply_ms`` (CUDA events), with the
card's own time (``device_ms``) beside it. With ``--device cpu`` each
rank count is a new group of gloo ranks, timed by the host clock: a
check that the protocols run, not a measure of any card's scaling.
Efficiency is the rate over (the 1-rank rate x ranks).

``--volume-model`` builds the plans only (no ranks) and prints each
exchange's per-layer volume at every rank count up to ``--world``, the
time it would take at ``--link-gbps`` (an assumed rate, not a
measurement), and the hierarchical exchange's host-stage volume and
deduplication at every (hosts x chips) factorization.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from loops_tpu_torch.parallel import launch, workers  # noqa: E402

PROTOCOLS = ("all_gather", "halo_overlap")


def graph_csr(args):
    """The benchmark's adjacency: a power-law graph or a banded one,
    optionally BFS-reordered."""
    from loops_tpu_torch.io import ogb
    from loops_tpu_torch.layout import reorder as R
    from loops_tpu_torch.utils import generate

    if args.graph == "banded":
        csr = generate.banded_csr(args.nodes, args.nodes,
                                  band=max(args.avg_deg // 2, 1))
        X = np.random.default_rng(0).normal(
            size=(args.nodes, args.feature_dim)).astype(np.float32)
    else:
        ds = ogb.synthetic_powerlaw("scaling", args.nodes, args.avg_deg,
                                    args.feature_dim, 8)
        csr, X = ds.graph.adj, ds.features.astype(np.float32)
    if args.reorder:
        csr = R.permute_csr(csr, R.bfs_order(csr))
    return csr, X


def volume_model(csr, counts, F: int, gbps: float) -> None:
    """Per-layer exchange volumes from the plans' arrays (no ranks)."""
    from loops_tpu_torch.parallel import EdgePartition, HaloPlan, HierHaloPlan

    print(f"\nper-layer exchange volume model (F={F}, f32, "
          f"{gbps:.0f} GB/s a rank, assumed):")
    print(f"{'P':>3} {'all_gather MB/rank':>19} {'halo MB/rank':>13} "
          f"{'halo(padded)':>13} {'ag ms':>7} {'halo ms':>8} "
          f"{'halo frac of N':>15}")
    for ndev in counts:
        if ndev == 1:
            print(f"{1:3d} {'0':>19} {'0':>13} {'0':>13} "
                  f"{0.0:7.3f} {0.0:8.3f} {'-':>15}")
            continue
        part = EdgePartition.build(csr, ndev)
        hp = HaloPlan.build(part)
        rows_pad = part.row_starts[-1] // ndev
        # all_gather: every rank receives the other P-1 shards
        ag_bytes = (ndev - 1) * rows_pad * F * 4
        # halo: the boundary rows shipped (valid slots), and the padded
        # package the all-to-all moves (send buffers are padded to H)
        sends = int(hp.send_valid.sum())
        halo_bytes = sends * F * 4 / ndev
        halo_pad = (ndev - 1) * hp.H * F * 4
        frac = sends / ndev / max(rows_pad, 1)
        print(f"{ndev:3d} {ag_bytes/1e6:19.2f} {halo_bytes/1e6:13.2f} "
              f"{halo_pad/1e6:13.2f} {ag_bytes/gbps/1e6:7.3f} "
              f"{max(halo_bytes, halo_pad)/gbps/1e6:8.3f} {frac:15.1%}")

    print("\nhierarchical host/chip volume model "
          "(total rows x F x 4B per layer):")
    print(f"{'mesh':>8} {'host flat MB':>13} {'host hier MB':>13} "
          f"{'dedup':>7} {'chip MB':>8}")
    P_all = counts[-1]
    part = EdgePartition.build(csr, P_all)
    hosts = 2
    while hosts < P_all:
        if P_all % hosts == 0:
            st = HierHaloPlan.build(part, hosts, P_all // hosts
                                    ).volume_stats()
            mb = F * 4 / 1e6
            print(f"{hosts}x{P_all // hosts:>2}   "
                  f"{st['dcn_flat_rows'] * mb:13.1f} "
                  f"{st['dcn_hier_rows'] * mb:13.1f} "
                  f"{st['dcn_dedup_factor']:7.2f} "
                  f"{st['ici_rows'] * mb:8.1f}")
        hosts *= 2


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--nodes", type=int, default=20000)
    p.add_argument("--avg-deg", type=int, default=15)
    p.add_argument("--feature-dim", type=int, default=128)
    p.add_argument("--iters", type=int, default=10,
                   help="applies per timed run (utils/bench.apply_ms)")
    p.add_argument("--volume-model", action="store_true",
                   help="print the per-layer exchange volume model "
                        "(bytes and time per protocol) instead of rates")
    p.add_argument("--reorder", action="store_true",
                   help="BFS-reorder the graph before partitioning")
    p.add_argument("--graph", choices=("powerlaw", "banded"),
                   default="powerlaw",
                   help="banded ~ mesh/PDE locality (the halo exchange's "
                        "home); powerlaw ~ citation graphs")
    p.add_argument("--link-gbps", type=float, default=450.0,
                   help="per-rank exchange rate the volume model assumes "
                        "(GB/s; 450: an H100 SXM's NVLink, one direction, "
                        "NVIDIA's data sheet)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--world", type=int, default=None,
                   help="largest rank count (default: the visible cards, "
                        "8 on the CPU)")
    args = p.parse_args(argv)

    from loops_tpu_torch.utils.platform import ensure_platform

    if args.volume_model:
        world = args.world or 8
    else:
        import torch

        device = ensure_platform(args.device)
        world = args.world or (torch.cuda.device_count()
                               if device.type == "cuda" else 8)
    csr, X = graph_csr(args)
    counts = [1]
    while counts[-1] * 2 <= world:
        counts.append(counts[-1] * 2)
    print(f"graph: {args.nodes:,} nodes, {csr.nnz:,} edges, "
          f"F={args.feature_dim}; ranks up to {counts[-1]}", flush=True)
    if args.volume_model:
        volume_model(csr, counts, args.feature_dim, args.link_gbps)
        return 0

    rates = {proto: [] for proto in PROTOCOLS}
    for ndev in counts:
        res = launch.run(workers.scaling_rank, ndev, csr, X, PROTOCOLS,
                         args.iters, device.type, device=device)
        for proto in PROTOCOLS:
            ms = max(r[proto][0] for r in res)
            cards = [r[proto][1] for r in res if r[proto][1] is not None]
            eps = csr.nnz / (ms * 1e-3)
            rates[proto].append(eps)
            eff = eps / (rates[proto][0] * ndev) if ndev > 1 else 1.0
            card = (f", card {max(cards):.4f} ms" if cards else "")
            print(f"  {proto:13s} {ndev:3d} ranks: {ms:8.4f} ms{card}  "
                  f"{eps / 1e6:8.2f} M edges/s  eff={eff:.2%}", flush=True)
    if device.type == "cuda":
        import subprocess

        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
        print(f"card: {smi[0] if smi else 'nvidia-smi gave nothing'}")
    else:
        print("device: cpu (gloo ranks on this machine's cores; host "
              "clock)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
