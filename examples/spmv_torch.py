#!/usr/bin/env python
"""SpMV example runner for the PyTorch + CUDA port — CSV timing line +
validation.

The counterpart of ``examples/spmv.py`` for ``loops_tpu_torch``: loads a
Matrix Market file (or generates a random matrix), converts it to
``--format`` (``auto`` asks the format advisor and names its pick on
stderr), runs the chosen schedule on ``--device``, prints the
``kernel,dataset,rows,cols,nnzs,elapsed`` CSV line (elapsed in ms per
apply: CUDA events on the card, the host clock on the CPU), and with
``--validate`` / ``--rigorous`` prints the Errors / Wilkinson-verdict
blocks.

    python examples/spmv_torch.py -m datasets/chesapeake.mtx \
        --schedule merge_path --validate --rigorous
    python examples/spmv_torch.py --format auto --validate

The single-strategy formats take ``row_mapped`` only (csc, dia, bcsr) and
the torch ops only (csc, dia, coo and ell); other ``--schedule`` /
``--impl`` values are overridden with a note on stderr, as the JAX CLI
does. bcsr keeps ``--impl`` (``pallas`` is kernel K6). ``--matrix`` names
one of ``utils/generate.SCALE_MATRICES``.

``--device cuda`` (the default) fails when no card is visible; it never
falls back to the CPU.
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from loops_tpu_torch.formats import BCSR, CSC, DIA, ELL, advise  # noqa: E402
from loops_tpu_torch.io import filepath, market  # noqa: E402
from loops_tpu_torch.ops.spmv import SpMVOperator  # noqa: E402
from loops_tpu_torch.utils import generate, reference  # noqa: E402
from loops_tpu_torch.utils.bench import apply_ms  # noqa: E402
from loops_tpu_torch.utils.equal import count_mismatches  # noqa: E402
from loops_tpu_torch.utils.platform import ensure_platform  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-m", "--market", help="Matrix Market file")
    p.add_argument("--matrix", choices=sorted(generate.SCALE_MATRICES),
                   help="a named generated matrix at the card's scale")
    p.add_argument("--rows", type=int, default=1024)
    p.add_argument("--cols", type=int, default=1024)
    p.add_argument("--sparsity", type=float, default=0.01)
    p.add_argument("--schedule", default="merge_path",
                   choices=["row_mapped", "group_mapped", "work_oriented",
                            "merge_path", "sorted_flat", "auto"])
    p.add_argument("--format", default="csr",
                   choices=["csr", "csc", "coo", "ell", "bcsr", "dia",
                            "auto"])
    p.add_argument("--impl", default="xla",
                   choices=["xla", "pallas", "pallas2", "pallas3"])
    p.add_argument("--block", type=int, default=512)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--validate", action="store_true")
    p.add_argument("--rigorous", action="store_true")
    p.add_argument("-v", "--verbose", action="store_true")
    args = p.parse_args(argv)

    device = ensure_platform(args.device)

    if args.market:
        csr = market.load_csr(args.market)
        dataset = filepath.extract_dataset(args.market)
    elif args.matrix:
        csr = generate.SCALE_MATRICES[args.matrix]()
        dataset = args.matrix
    else:
        csr = generate.random_csr(args.rows, args.cols, args.sparsity)
        dataset = "random"

    if args.format == "auto":
        adv = advise(csr, device=device)
        args.format = adv.recommended
        print(f"Advisor: {adv.recommended} — {adv.why}", file=sys.stderr)

    mat = {
        "csr": lambda: csr,
        "coo": lambda: csr.to_coo(),
        "csc": lambda: CSC.from_csr(csr),
        "ell": lambda: ELL.from_csr(csr),
        "bcsr": lambda: BCSR.from_csr(csr, 8, 128),
        "dia": lambda: DIA.from_csr(csr),
    }[args.format]()

    # single-strategy formats implement row_mapped only (the operator
    # rejects knobs it would otherwise silently ignore); coerce the CLI
    # default with a notice. bcsr keeps --impl (pallas = kernel K6);
    # csc/dia run torch ops only.
    if args.format in ("csc", "dia", "bcsr"):
        if args.schedule != "row_mapped":
            print(f"note: {args.format} implements row_mapped only; "
                  f"overriding --schedule {args.schedule}",
                  file=sys.stderr)
            args.schedule = "row_mapped"
        if args.format != "bcsr" and args.impl != "xla":
            print(f"note: {args.format} is XLA-only; overriding --impl",
                  file=sys.stderr)
            args.impl = "xla"
    if args.format in ("coo", "ell") and args.impl != "xla":
        print(f"note: {args.format} is XLA-only; overriding --impl",
              file=sys.stderr)
        args.impl = "xla"

    x = generate.make_input_vector(csr.shape[1])
    op = SpMVOperator(mat, args.schedule, block=args.block, impl=args.impl,
                      device=device)
    y = op(x).cpu().numpy()
    print(f"impl_used: {op.impl_used} launches: {op.launches}",
          file=sys.stderr)

    elapsed = apply_ms(op, op.stage(x), iters=10, repeats=3)

    kernel = f"{args.format}_{args.schedule}" + (
        "_pallas" if args.impl == "pallas" else "")
    print(f"{kernel},{dataset},{csr.shape[0]},{csr.shape[1]},{csr.nnz},"
          f"{elapsed:.5f}")

    status = 0
    if args.validate or args.rigorous:
        y_ref = reference.spmv(csr, x)
        errors = count_mismatches(y, y_ref, verbose=args.verbose)
        print(f"Matrix: {dataset}")
        print(f"Dimensions: {csr.shape[0]} x {csr.shape[1]} "
              f"({csr.nnz} nnz)")
        print(f"Errors: {errors}")
        status = 1 if errors else 0
    if args.rigorous:
        rep = reference.rigorously_validate_spmv(csr, x, y)
        print(f"WilkinsonK: {rep.wilkinson_k}")
        print(f"NaiveMismatches: {rep.naive_mismatches}")
        print(f"F32BaselineOverruns: {rep.f32_baseline_overruns}")
        print(f"GPUOverruns: {rep.kernel_overruns}")
        print(f"MaxAbsError: {rep.max_abs_error:.3e}")
        print(f"MaxRelError: {rep.max_rel_error:.3e}")
        print(f"Verdict: {rep.verdict}")
        status = status or int(rep.verdict != "NOT_A_BUG")
    return status


if __name__ == "__main__":
    sys.exit(main())
