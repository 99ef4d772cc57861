#!/usr/bin/env python
"""The design probes on an NVIDIA card: the counterparts of
``scripts/tpu_mosaic_probe{,2}.py`` (K13), ``scripts/tpu_r2_probe.py``
(K14) and ``scripts/tpu_r{3,4}_gather_probe.py`` (K15), each probe kernel
written by hand in CUDA C++ (``loops_tpu_torch/probes``).

    python scripts/h100_probes.py [--probe mosaic|r2|gather|all]
                                  [--device cuda|cpu] [--quick]

Prints the card's name and power limit (``nvidia-smi``) first, then one
line per probe in the TPU scripts' formats (``ns/elem``, ``us/chunk``,
``GB/s``, ``exact=True``). Sizes are the TPU scripts' own unless
``--quick``. Every probe kernel is held against its plain PyTorch version
first: a mismatch stops the run with a non-zero exit. ``--device cuda``
(the default) fails when no card is visible; it never falls back to the
CPU, where the plain versions run and no number is a device's.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from loops_tpu_torch.probes import gather, mosaic, r2  # noqa: E402
from loops_tpu_torch.utils.platform import ensure_platform  # noqa: E402

PROBES = {"mosaic": mosaic, "r2": r2, "gather": gather}


def card_line(device) -> str:
    """``nvidia-smi``'s name and power limit of the card, or a note that
    the run is on the CPU."""
    if device.type != "cuda":
        return "device: cpu (plain versions; no device numbers)"
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[device.index or 0]


def main(argv=None, out=print) -> tuple[int, list]:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--probe", default="all", choices=[*PROBES, "all"])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--quick", action="store_true",
                   help="small sizes (for a check, not a measurement)")
    args = p.parse_args(argv)
    device = ensure_platform(args.device)
    out(card_line(device))
    names = list(PROBES) if args.probe == "all" else [args.probe]
    records = []
    t0 = time.perf_counter()
    for name in names:
        out(f"[{time.perf_counter() - t0:.0f}s] {name}...")
        records += PROBES[name].run(device, quick=args.quick, out=out)
    out(f"[{time.perf_counter() - t0:.0f}s] done: {len(records)} probe "
        "kernels held to their plain versions")
    return 0, records


if __name__ == "__main__":
    sys.exit(main()[0])
