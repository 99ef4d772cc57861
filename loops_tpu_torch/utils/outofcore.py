"""The out-of-core bench: a papers100M-shaped graph staged into row shards
on disk, planned shard by shard, and streamed through one device against
a feature table on disk (``scripts/bench_outofcore.py``'s flow, with the
stream split into its parts). The CLI is
``scripts/bench_outofcore_torch.py``:

    python scripts/bench_outofcore_torch.py --nodes 10000000 --avg-deg 15 \\
        --shards 16 --feat 128 --schedule merge_path [--dtype bfloat16] \\
        [--device cpu]

It prints the graph, ``stage:``, ``plan:``, ``spmm:`` and ``check:``
lines. The ``spmm:`` line adds each part of the stream in seconds, summed
over the shards: ``stage`` (host plan and staging of a shard), ``gather``
(its feature rows gathered on the host into the pinned buffer),
``upload``, ``kernel`` (K4 for ``merge_path`` by CUDA events on a card;
the sorted segment sum for ``row_mapped``) and ``download``. The check
holds the heaviest row to its f64 sum, as the reference script does.
Shards, features and output live in ``--dir``, by default a new
directory under the temporary directory. The CLI removes at the end only
a directory that it made. It refuses a ``--dir`` that holds files but no
``meta.json`` (no store of an earlier run), and leaves one it did not
make, with this run's files in it.
"""
from __future__ import annotations

import argparse
import os
import shutil
import tempfile
import time

import numpy as np

from loops_tpu_torch.io.shards import PARTS, ShardedCSR, StreamedSpMM
from loops_tpu_torch.utils.generate import powerlaw_csr

# the reference script's block for its plan line, and its feature seed
PLAN_BLOCK_WORK = 4096
FEATURE_SEED = 1
# rows of the feature table drawn at once
FILL_ROWS = 1 << 20


def build_graph(nodes: int, avg_deg: int, seed: int = 0):
    """``(csr, seconds)``."""
    t0 = time.perf_counter()
    csr = powerlaw_csr(nodes, avg_deg, seed)
    return csr, time.perf_counter() - t0


def stage(csr, shards: int, directory: str):
    """``(sharded, seconds, bytes on disk)``: ``csr`` cut into ``shards``
    row shards under ``directory``."""
    t0 = time.perf_counter()
    sharded = ShardedCSR.build(csr, shards, directory)
    dt = time.perf_counter() - t0
    nbytes = sum(os.path.getsize(os.path.join(directory, f))
                 for f in os.listdir(directory))
    return sharded, dt, nbytes


def plan_all(sharded):
    """``(blocks, seconds)``: every shard planned merge_path on its own,
    one shard's plan alive at a time."""
    t0 = time.perf_counter()
    blocks = 0
    for p in range(sharded.num_shards):
        blocks += sharded.plan(p, "merge_path",
                               block_work=PLAN_BLOCK_WORK).num_blocks
    return blocks, time.perf_counter() - t0


def feature_table(path: str, rows: int, feat: int, seed: int = FEATURE_SEED):
    """A disk-backed f32 ``[rows, feat]`` table of standard normals."""
    X = np.lib.format.open_memmap(path, mode="w+", dtype=np.float32,
                                  shape=(rows, feat))
    rng = np.random.default_rng(seed)
    for i in range(0, rows, FILL_ROWS):
        X[i:i + FILL_ROWS] = rng.standard_normal(
            (min(FILL_ROWS, rows - i), feat), dtype=np.float32)
    return X


def output_table(path: str, rows: int, feat: int):
    return np.lib.format.open_memmap(path, mode="w+", dtype=np.float32,
                                     shape=(rows, feat))


def stream(sharded, X, Y, schedule: str, dtype=None, device="cuda"):
    """``(op, seconds, setup seconds)``: ``Y = A @ X`` streamed."""
    t0 = time.perf_counter()
    op = StreamedSpMM(sharded, schedule=schedule, dtype=dtype, device=device)
    setup = time.perf_counter() - t0
    t0 = time.perf_counter()
    op(X, out=Y)
    return op, time.perf_counter() - t0, setup


def part_seconds(op) -> dict:
    """Each part of the last stream, summed over the shards."""
    return {k: sum(op.times[k]) for k in PARTS}


def heaviest_row(csr, X, Y, dtype=None):
    """``(ok, nnz)``: the heaviest row of ``Y`` against its f64 sum, at
    the reference script's tolerances."""
    r = int(np.argmax(np.diff(csr.offsets)))
    a0, a1 = int(csr.offsets[r]), int(csr.offsets[r + 1])
    want = (csr.vals[a0:a1, None].astype(np.float64)
            * X[csr.indices[a0:a1]]).sum(axis=0)
    # bf16 product rounding carries ~0.4% relative error per term
    atol, rtol = (0.1, 2e-2) if dtype else (1e-2, 1e-3)
    return bool(np.allclose(Y[r], want, atol=atol, rtol=rtol)), a1 - a0


def spmm_line(op, dt, setup, nnz, feat) -> str:
    parts = part_seconds(op)
    return (f"spmm:  streamed {op.schedule} F={feat} in {dt:.1f}s "
            f"({nnz / dt / 1e6:.1f} M edges/s incl. host gathers; setup "
            f"{setup:.1f}s); parts (s): "
            + ", ".join(f"{k} {v:.3f}" for k, v in parts.items()))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--nodes", type=int, default=2_000_000)
    p.add_argument("--avg-deg", type=int, default=15)
    p.add_argument("--shards", type=int, default=16)
    p.add_argument("--feat", type=int, default=128)
    p.add_argument("--dir", default=None,
                   help="working directory: new, empty, or an earlier "
                   "run's store (default: a new directory under the "
                   "temporary directory; a directory the run made is "
                   "removed at the end)")
    p.add_argument("--schedule", default="row_mapped",
                   choices=["row_mapped", "merge_path"])
    p.add_argument("--dtype", default=None, choices=[None, "bfloat16"])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    from loops_tpu_torch.utils.platform import ensure_platform

    device = ensure_platform(args.device)
    if args.dir is None:
        directory, made = tempfile.mkdtemp(prefix="loops_tpu_torch_ooc_"), True
    else:
        directory, made = args.dir, not os.path.exists(args.dir)
        if (os.path.isdir(directory) and os.listdir(directory) and not
                os.path.exists(os.path.join(directory, ShardedCSR.META))):
            p.error(f"--dir {directory} holds files and no "
                    f"{ShardedCSR.META}: name a new or empty directory")
    try:
        csr, dt = build_graph(args.nodes, args.avg_deg)
        print(f"graph: {csr.shape[0]:,} nodes {csr.nnz:,} edges "
              f"(built {dt:.1f}s)", flush=True)
        sharded, dt, nbytes = stage(csr, args.shards, directory)
        print(f"stage: {args.shards} shards, {nbytes / 2**20:.0f} MiB in "
              f"{dt:.1f}s ({csr.nnz / dt / 1e6:.1f} M edges/s)", flush=True)
        blocks, dt = plan_all(sharded)
        print(f"plan:  merge_path x{args.shards} shards, {blocks:,} blocks "
              f"in {dt:.1f}s ({csr.nnz / dt / 1e6:.1f} M edges/s)",
              flush=True)
        X = feature_table(os.path.join(directory, "X.npy"), csr.shape[1],
                          args.feat)
        Y = output_table(os.path.join(directory, "Y.npy"), csr.shape[0],
                         args.feat)
        op, dt, setup = stream(sharded, X, Y, args.schedule, args.dtype,
                               device)
        print(spmm_line(op, dt, setup, csr.nnz, args.feat) + f" [{device}]",
              flush=True)
        ok, nnz = heaviest_row(csr, X, Y, args.dtype)
        print(f"check: heaviest row ({nnz} nnz) "
              f"{'OK' if ok else 'MISMATCH'}", flush=True)
        del X, Y
    finally:
        if made:
            shutil.rmtree(directory, ignore_errors=True)
    return 0 if ok else 1
