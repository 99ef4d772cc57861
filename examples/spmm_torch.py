#!/usr/bin/env python
"""SpMM example runner for the PyTorch + CUDA port — CSV timing line +
validation.

The counterpart of ``examples/spmm.py`` for ``loops_tpu_torch``: loads a
Matrix Market file (or generates a random matrix), blocks it into the
launch box's BCSR blocks with ``--format bcsr``, runs the operator on
``--device``, prints the ``kernel,dataset,rows,cols,nnz,elapsed,gflops``
CSV line (elapsed in ms per apply: CUDA events on the card, the host clock
on the CPU) and, with ``--validate``, ``Errors: N``. The path the build
took (``impl_used``) and its kernel launches go to stderr.

    python examples/spmm_torch.py --format bcsr --impl pallas --validate

``--device cuda`` (the default) fails when no card is visible; it never
falls back to the CPU.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from loops_tpu_torch.formats import BCSR  # noqa: E402
from loops_tpu_torch.io import filepath, market  # noqa: E402
from loops_tpu_torch.ops.spmm import SpMMOperator  # noqa: E402
from loops_tpu_torch.tuning.launch_box import launch_params  # noqa: E402
from loops_tpu_torch.utils import generate, reference  # noqa: E402
from loops_tpu_torch.utils.bench import apply_ms  # noqa: E402
from loops_tpu_torch.utils.equal import count_mismatches  # noqa: E402
from loops_tpu_torch.utils.platform import ensure_platform  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-m", "--market")
    p.add_argument("--rows", type=int, default=2048)
    p.add_argument("--cols", type=int, default=2048)
    p.add_argument("--sparsity", type=float, default=0.01)
    p.add_argument("--feature-dim", type=int, default=128)
    p.add_argument("--schedule", default="row_mapped")
    p.add_argument("--format", default="csr", choices=["csr", "bcsr"])
    p.add_argument("--impl", default="xla", choices=["xla", "pallas"])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--validate", action="store_true")
    args = p.parse_args(argv)

    device = ensure_platform(args.device)

    if args.market:
        csr = market.load_csr(args.market)
        dataset = filepath.extract_dataset(args.market)
    else:
        csr = generate.random_csr(args.rows, args.cols, args.sparsity)
        dataset = "random"
    mat = (BCSR.from_csr(csr, *launch_params(device).bcsr_block)
           if args.format == "bcsr" else csr)

    rng = np.random.default_rng(1)
    B = rng.normal(size=(csr.shape[1], args.feature_dim)).astype(np.float32)
    op = SpMMOperator(mat, schedule=args.schedule, impl=args.impl,
                      device=device)
    C = op(B).cpu().numpy()
    print(f"impl_used: {op.impl_used} launches: {op.launches}",
          file=sys.stderr)

    elapsed = apply_ms(op, op.stage(B), iters=5, repeats=3)
    gflops = 2 * csr.nnz * args.feature_dim / (elapsed * 1e-3) / 1e9

    kernel = f"spmm_{args.format}_{args.schedule}" + (
        "_pallas" if args.impl == "pallas" else "")
    print(f"{kernel},{dataset},{csr.shape[0]},{csr.shape[1]},{csr.nnz},"
          f"{elapsed:.5f},{gflops:.1f}")
    if args.validate:
        errors = count_mismatches(C, reference.spmm(csr, B))
        print(f"Errors: {errors}")
        return 1 if errors else 0
    return 0


if __name__ == "__main__":
    sys.exit(main())
