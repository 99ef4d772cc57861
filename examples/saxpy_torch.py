#!/usr/bin/env python
"""SAXPY demo for the PyTorch + CUDA port (reference: examples/saxpy.cu,
the grid-stride-loop hello world).

The counterpart of ``examples/saxpy.py``: the same ``n = 1 << 16`` values
as [8, n/8] from ``default_rng(0)`` and ``a = 2.5``; torch's ``a*x+y``
against the hand-written kernel K12 (``loops_tpu_torch.ops.kernels.saxpy``)
on ``--device``. Prints the max error and ``Errors: 0`` when they agree
bit for bit.

    python examples/saxpy_torch.py [--device cuda|cpu] [--n N]

``--device cuda`` (the default) fails when no card is visible; it never
falls back to the CPU.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from loops_tpu_torch.ops.kernels.saxpy import saxpy  # noqa: E402
from loops_tpu_torch.utils.platform import ensure_platform  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--n", type=int, default=1 << 16,
                   help="element count, a multiple of 8")
    args = p.parse_args(argv)
    if args.n <= 0 or args.n % 8:
        p.error("--n must be a positive multiple of 8")
    device = ensure_platform(args.device)
    import torch

    n = args.n
    rng = np.random.default_rng(0)
    x = rng.normal(size=(8, n // 8)).astype(np.float32)
    y = rng.normal(size=(8, n // 8)).astype(np.float32)
    a = 2.5
    xt, yt = (torch.from_numpy(v).to(device) for v in (x, y))
    out1 = a * xt + yt
    out2 = saxpy(a, xt, yt, device=device)
    err = float((out1 - out2).abs().max())
    print(f"saxpy n={n}: torch vs kernel max err {err:.2e}")
    ok = bool(torch.equal(out1, out2))
    print("Errors: 0" if ok else "Errors: >0")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
