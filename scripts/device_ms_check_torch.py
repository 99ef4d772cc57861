#!/usr/bin/env python
"""Why ``utils/bench.device_ms`` once read a card time above the wall time.

For each cell of the sweep whose logged ``device_ms`` (column 8) stood
more than 5% above its ``apply_ms`` (column 6), all ``group_mapped``, this
builds the matrix and the operator as ``tuning/sweep.py`` does and prints:

- ``apply_ms``: back-to-back applies under CUDA events (the sweep's
  column 6);
- ``held_run`` behind one sleep of ``HOLD_CYCLES`` (the sample the sweep
  once took, three times), of ``HOLD_CAP_CYCLES`` and with no sleep: the
  card time of each apply from events recorded between them, the host's
  ms to queue them, whether the sleep had ended when the last was
  queued, and the allocator's counters over the run;
- ``bench.held_sample`` at each hold from ``HOLD_CYCLES`` to
  ``HOLD_CAP_CYCLES``: how many applies were queued before the sleep
  ended;
- ``device_ms`` as it now stands;
- once, how many one-cycle kernels the host can queue behind a held card
  before a launch waits (CUDA's queue of pending work).

    python scripts/device_ms_check_torch.py [--cells NAME,...] [--out F]

One JSON line per cell goes to ``--out`` (default
``device_ms_check.jsonl`` in the working directory). It needs a card.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# (population, op, dtype, norm, matrix, log): the nine rows
CELLS = [
    ("gnn", "spmm", "bfloat16", "none", "lgn_n32768_d8_s2.0", "spmm/bf16"),
    ("gnn", "spmm", "bfloat16", "none", "pl_n4096_d4_a1.2", "spmm/bf16"),
    ("gnn", "spmm", "bfloat16", "none", "pl_n8192_d4_a1.2", "spmm/bf16"),
    ("gnn", "spmm", "bfloat16", "mean", "lgn_n32768_d16_s3.0",
     "spmm/bf16_mean"),
    ("gnn", "spmm", "bfloat16", "mean", "pl_n4096_d16_a1.2",
     "spmm/bf16_mean"),
    ("gnn", "spmm", None, "none", "pl_n65536_d16_a1.6", "spmm/f32"),
    ("synthetic", "spmv", None, "none", "rmat_n32768_d8_g500_s1",
     "synthetic"),
    ("synthetic", "spmv", None, "none", "pl_n65536_d16_a1.2", "synthetic"),
    ("xl", "spmv", None, "none", "xl_lognormal_67108864", "xl"),
]
ALLOC_KEYS = ("num_device_alloc", "num_device_free", "num_alloc_retries",
              "num_sync_all_streams")


def _alloc_counts(device) -> dict:
    import torch

    stats = torch.cuda.memory_stats(device)
    return {k: int(stats.get(k, 0)) for k in ALLOC_KEYS}


def held_run(fn, x, applies: int, hold: int | None) -> dict:
    """``applies`` applies queued behind a sleep of ``hold`` cycles (none
    where ``hold`` is None), events recorded between them: the card ms of
    each, the host ms to queue them all, whether the sleep had ended when
    the last was queued, and the allocator's counters over the run."""
    import torch

    torch.cuda.synchronize(x.device)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(applies + 1)]
    before = _alloc_counts(x.device)
    if hold:
        torch.cuda._sleep(hold)
    ev[0].record()
    h0 = time.perf_counter()
    for i in range(applies):
        fn(x)
        ev[i + 1].record()
    queue_ms = (time.perf_counter() - h0) * 1e3
    expired = bool(ev[0].query())
    ev[-1].synchronize()
    after = _alloc_counts(x.device)
    per = [ev[i].elapsed_time(ev[i + 1]) for i in range(applies)]
    return dict(ms=sum(per) / applies, median=statistics.median(per),
                max=max(per), first=per[0], queue_ms=queue_ms,
                expired=expired,
                alloc={k: after[k] - before[k] for k in ALLOC_KEYS})


def queue_depth(device, launches: int = 8192) -> dict:
    """How far the host can queue ahead of a held card: ``launches``
    one-cycle sleep kernels behind a sleep of ``HOLD_CAP_CYCLES``, each
    launch timed on the host clock; the first that returns more than a
    millisecond late marks where the host began to wait for the card."""
    import torch

    from loops_tpu_torch.utils import bench

    torch.cuda.synchronize(device)
    t0 = torch.cuda.Event()
    torch.cuda._sleep(bench.HOLD_CAP_CYCLES)
    t0.record()
    waits = []
    for _ in range(launches):
        h0 = time.perf_counter()
        torch.cuda._sleep(1)
        waits.append(time.perf_counter() - h0)
    ended = bool(t0.query())
    torch.cuda.synchronize(device)
    blocked = [i for i, w in enumerate(waits) if w > 1e-3]
    return dict(launches=launches, first_wait=blocked[0] if blocked
                else None, longest_wait_ms=max(waits) * 1e3,
                sleep_ended_first=ended)


def check_cell(cell, device, applies: int) -> dict:
    import torch

    from loops_tpu_torch.tuning import sweep
    from loops_tpu_torch.utils import bench
    from loops_tpu_torch.utils.generate import make_input_vector

    pop, op, dtype, norm, name, log = cell
    csr, build_s = sweep.build_matrix(pop, name, norm=norm)
    if op == "spmv":
        x = torch.from_numpy(make_input_vector(csr.shape[1])).to(device)
        fn, used = sweep._spmv_op(csr, "group_mapped", device)
    else:
        B = np.random.default_rng(5).standard_normal(
            (csr.shape[1], 128)).astype(np.float32)
        x = torch.from_numpy(B).to(device)
        fn, used = sweep._spmm_op(csr, "group_mapped", device, dtype)
    fn(x)
    rec = dict(cell=f"{log}/{name}", nnz=int(csr.nnz), build_s=build_s,
               impl=used, applies=applies)
    rec["apply_ms"] = bench.apply_ms(fn, x)
    rec["held"] = [held_run(fn, x, applies, bench.HOLD_CYCLES)
                   for _ in range(3)]
    rec["held_cap"] = held_run(fn, x, applies, bench.HOLD_CAP_CYCLES)
    rec["unheld"] = held_run(fn, x, applies, None)
    rec["queued"] = []  # (hold, applies queued before the sleep ended)
    hold = bench.HOLD_CYCLES
    while hold <= bench.HOLD_CAP_CYCLES:
        rec["queued"].append((hold, bench.held_sample(fn, x, applies,
                                                      hold)[1]))
        hold *= 2
    try:
        rec["device_ms"] = bench.device_ms(fn, x, applies)
    except bench.HoldExpired as e:
        rec["device_ms"] = None
        rec["refused"] = str(e)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", default="",
                    help="comma-separated matrix names (default: all nine)")
    ap.add_argument("--applies", type=int, default=50)
    ap.add_argument("--out", default="device_ms_check.jsonl")
    args = ap.parse_args(argv)
    import torch

    from loops_tpu_torch.utils import bench
    from loops_tpu_torch.utils.platform import ensure_platform

    device = ensure_platform("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    depth = queue_depth(device)
    print(f"launch queue: {json.dumps(depth)}  [{smi}]", flush=True)
    wanted = set(args.cells.split(",")) if args.cells else None
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "a") as f:
        for cell in CELLS:
            if wanted and cell[4] not in wanted:
                continue
            rec = check_cell(cell, device, args.applies)
            rec["card"] = smi
            rec["queue"] = depth
            f.write(json.dumps(rec) + "\n")
            f.flush()
            held, cap, free = rec["held"], rec["held_cap"], rec["unheld"]
            print(f"{rec['cell']} ({rec['nnz']} nnz, {rec['impl']}): apply "
                  f"{rec['apply_ms']:.4f} ms; behind {bench.HOLD_CYCLES} "
                  "cycles "
                  + ", ".join(f"{u['ms']:.4f} ms (queued in "
                              f"{u['queue_ms']:.1f} ms, expired "
                              f"{u['expired']}, alloc {u['alloc']})"
                              for u in held)
                  + f"; per apply behind the cap median {cap['median']:.4f}"
                  f" max {cap['max']:.4f}, unheld median "
                  f"{free['median']:.4f} max {free['max']:.4f}; queued "
                  f"before the sleep ended (hold, applies) {rec['queued']};"
                  f" device_ms {rec['device_ms']}  [{smi}]", flush=True)
            del rec
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
