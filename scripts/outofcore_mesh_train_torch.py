#!/usr/bin/env python
"""Out-of-core store -> mesh train steps, the counterpart of
``scripts/outofcore_mesh_train.py`` for ``loops_tpu_torch``.

Stages the GCN-normalized adjacency of a power-law graph (with self
loops) into a memmapped ``ShardedCSR``, one shard a host, with the
features, labels and train mask beside it; every rank then builds the
mesh partition with ``EdgePartition.from_shards`` (no global CSR) and
trains a DistGCN through the hierarchical host/chip exchange, reading
its own feature rows from the memmap.

    python scripts/outofcore_mesh_train_torch.py --nodes 1000000
    python scripts/outofcore_mesh_train_torch.py --device cpu --world 8 \
        --hosts 2 --nodes 10000000 --avg-deg 8 --feat 32

On a card (``--device cuda``, the default) it runs as one NCCL rank, or
``--world`` NCCL ranks, one a card; with ``--device cpu``, ``--world``
gloo ranks (default 8) of this machine. ``--hosts`` (default 2, or 1 for
one rank) cuts the graph into that many shards; each host's shard is
split across ``world // hosts`` chips. ``--dir`` defaults to a new
directory under the temporary directory, removed at the end. Prints the
graph, normalize, stage and plan lines, the first step (kernel builds
included) and the mean step, and ``check: OK``.
"""
from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from loops_tpu_torch.parallel import launch, workers  # noqa: E402


def main(argv=None):
    from loops_tpu_torch.io.shards import ShardedCSR
    from loops_tpu_torch.models.graph import Graph
    from loops_tpu_torch.utils.generate import powerlaw_csr
    from loops_tpu_torch.utils.platform import ensure_platform

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--nodes", type=int, default=10_000_000)
    p.add_argument("--avg-deg", type=int, default=8)
    p.add_argument("--hosts", type=int, default=None)
    p.add_argument("--feat", type=int, default=32)
    p.add_argument("--classes", type=int, default=16)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--dir", default=None)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--world", type=int, default=None,
                   help="ranks (default: 1 on a card, 8 on the CPU)")
    args = p.parse_args(argv)

    device = ensure_platform(args.device)
    world = args.world or (1 if device.type == "cuda" else 8)
    hosts = args.hosts or (2 if world > 1 else 1)
    if world % hosts:
        p.error(f"--world {world} is not a multiple of --hosts {hosts}")
    chips = world // hosts
    n = args.nodes
    made = args.dir is None
    d = tempfile.mkdtemp(prefix="loops_mesh_shards_") if made else args.dir
    if not made and os.path.exists(d) and os.listdir(d) and not (
            os.path.exists(os.path.join(d, ShardedCSR.META))):
        p.error(f"--dir {d} holds files and no {ShardedCSR.META}: "
                "not a store this script wrote")
    try:
        t0 = time.perf_counter()
        csr = powerlaw_csr(n, args.avg_deg, seed=3)
        print(f"graph: {n:,} nodes {csr.nnz:,} edges "
              f"({time.perf_counter() - t0:.1f}s)", flush=True)
        t0 = time.perf_counter()
        norm = Graph(csr).add_self_loops().gcn_normalized().adj
        del csr
        print(f"normalize: {norm.nnz:,} nnz "
              f"({time.perf_counter() - t0:.1f}s)", flush=True)

        t0 = time.perf_counter()
        ShardedCSR.build(norm, hosts, d)
        rng = np.random.default_rng(0)
        np.save(os.path.join(d, "X.npy"),
                rng.normal(size=(n, args.feat)).astype(np.float32))
        np.save(os.path.join(d, "labels.npy"),
                rng.integers(0, args.classes, n).astype(np.int32))
        np.save(os.path.join(d, "mask.npy"),
                (rng.random(n) < 0.5).astype(np.float32))
        nbytes = sum(os.path.getsize(os.path.join(d, f))
                     for f in os.listdir(d))
        print(f"stage: {hosts} shards and the features, "
              f"{nbytes / 2**20:.0f} MiB ({time.perf_counter() - t0:.1f}s)",
              flush=True)

        dims = [args.feat, 32, args.classes]
        t0 = time.perf_counter()
        res = launch.run(workers.store_train_rank, world, d, hosts, dims,
                         args.steps + 1, 1e-2, device.type, device=device)
        wall = time.perf_counter() - t0
        r = res[0]
        print(f"from_shards: P={world} ({hosts}x{chips}) rows_pd="
              f"{r['rows_per_dev']:,} nnz_pd={r['nnz_per_dev']:,} "
              f"({max(x['plan_s'] for x in res):.1f}s a rank)", flush=True)
        secs = np.max([x["seconds"] for x in res], axis=0)
        losses = r["losses"]
        print(f"step 0 (kernel builds, first launch): loss={losses[0]:.4f} "
              f"({secs[0]:.1f}s)", flush=True)
        ms = float(np.mean(secs[1:])) * 1e3 if len(secs) > 1 else secs[0] * 1e3
        eps = norm.nnz * 2 * (len(dims) - 1) / (ms * 1e-3)
        print(f"train: {ms:.0f} ms/step ({eps / 1e6:.1f} M layer-edges/s "
              f"fwd+bwd, {hosts}x{chips} {device.type} ranks), final "
              f"loss={losses[-1]:.4f}; ranks' wall {wall:.1f}s", flush=True)
        if not np.all(np.isfinite(losses)):
            print(f"check: FAILED, losses {losses}", flush=True)
            return 1
        print("check: OK", flush=True)
        return 0
    finally:
        if made:
            shutil.rmtree(d, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
