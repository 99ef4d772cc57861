"""The readings a cell's correctness limits are set from, on the chip at
the cell's own size, many seeds in one process:

    python3 -m loopsbench.calibrate --workload <cell> --seeds 1,2,...
        [--structure-seeds s,t] [--control-seeds a,b,c]
        [--faults name,...] [--fault-seeds a,b,c] [--clock-units n]

* the program's sound runs (``--seeds``): each a whole run of the cell,
  with a short window (``--seconds``), as ``loopsbench.run`` makes it;
  with ``--structure-seeds``, on each graph those seeds draw (a
  ``structure_seed`` in the cell's ``graph`` block) besides the cell's
  own;
* the control (``--control-seeds``): the reference in the precision
  below the configuration's, in the program's place;
* each fault of the driver's ``FAULTS`` named (``--faults``), planted
  in the program, on ``--fault-seeds``;
* ``--clock-units``: that many units of the window timed both by the
  host's clock and by CUDA events recorded after each unit's host read,
  and the largest gap of the two per unit.

Prints one JSON line for each reading, then the largest and least value
of each number by side. The benchmark's own runs do not run this.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time


def _seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--faults", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--structure-seeds", default="")
    p.add_argument("--clock-units", type=int, default=0)
    p.add_argument("--seconds", type=float, default=1.0)
    args = p.parse_args(argv)
    from loopsbench import harness, run, spec

    cell = spec.resolve(args.workload)
    drv = cell.driver
    seen = {}

    graph = (cell.traffic if "graph" in cell.traffic else cell.config)["graph"]

    def emit(side, seed, values, seconds):
        line = {"workload": args.workload, "side": side, "seed": seed,
                "structure": graph.get("structure_seed"),
                "seconds": round(seconds, 3),
                "checks": {k: run._finite(v) for k, v in values.items()}}
        print(json.dumps(line), flush=True)
        for k, v in values.items():
            seen.setdefault(side, {}).setdefault(k, []).append(v)

    def program(side, seed):
        t = time.perf_counter()
        _, readings = harness.execute(cell, seed, args.seconds, False,
                                      "cuda", t)
        emit(side, seed, readings, time.perf_counter() - t)

    for structure in [None] + _seeds(args.structure_seeds):
        if structure is not None:
            graph["structure_seed"] = structure
        for seed in _seeds(args.seeds):
            program("program", seed)
    graph.pop("structure_seed", None)
    for seed in _seeds(args.control_seeds):
        t = time.perf_counter()
        emit("control", seed, drv.control(cell, seed, "cuda"),
             time.perf_counter() - t)
    planted = drv.FAULTS
    for name in (n for n in args.faults.split(",") if n):
        for seed in _seeds(args.fault_seeds):
            with planted[name]():
                program(f"fault:{name}", seed)
    if args.clock_units:
        clock(cell, 424242, args.clock_units)
    for side, numbers in seen.items():
        for k, vals in numbers.items():
            finite = [v for v in vals if math.isfinite(v)]
            print(f"{side} {k}: n={len(vals)} max={max(vals)!r} "
                  f"min={min(vals)!r} finite={len(finite)}", file=sys.stderr)
    return 0


def clock(cell, seed: int, count: int) -> None:
    """``count`` units timed by the host's clock and by CUDA events,
    each recorded after the unit's host read; prints the largest and the
    median gap of the two, and each one's 95th percentile."""
    import torch

    from loopsbench import harness, readings

    run = harness.Run(cell, "cuda")
    st = cell.driver.setup(run, cell, seed, "cuda")
    events = [torch.cuda.Event(enable_timing=True) for _ in range(count + 1)]
    host = []
    events[0].record()
    t = time.perf_counter()
    for i in range(count):
        cell.driver.unit(run, st)
        events[i + 1].record()
        now = time.perf_counter()
        host.append(now - t)
        t = now
    torch.cuda.synchronize()
    device = [a.elapsed_time(b) * 1e-3 for a, b in zip(events, events[1:])]
    gaps = sorted(abs(h - d) for h, d in zip(host, device))
    run.units = host
    p95_host = readings.p95_ms(run)
    run.units = device
    print(json.dumps({"workload": cell.name, "clock_units": count,
                      "gap_max_us": gaps[-1] * 1e6,
                      "gap_median_us": gaps[len(gaps) // 2] * 1e6,
                      "p95_ms_host": p95_host,
                      "p95_ms_device": readings.p95_ms(run)}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
