"""One run of one cell of the benchmark of ``loops_tpu_torch``.

    python3 -m loopsbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for. Prints, as the last line of standard output, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``, each
number the check compared beside its limit, which also end standard
error. Exits 2 without the cards, and 3 when a module of JAX or of the
JAX package is loaded once the window has closed; neither prints a
result.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# build and kernel caches at fixed paths inside the checkout, so that
# only a checkout's first run builds
CACHE = os.path.join(ROOT, ".loopsbench_cache")
CACHE_VARS = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
              "TRITON_CACHE_DIR": "triton",
              "PYTORCH_KERNEL_CACHE_PATH": "torch_kernels",
              "CUDA_CACHE_PATH": "cuda"}


def _merge(base: dict, over: dict) -> None:
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            _merge(base[k], v)
        else:
            base[k] = v


def _finite(x):
    """A JSON-safe number: a non-finite float as its name."""
    return x if not isinstance(x, float) or math.isfinite(x) else repr(x)


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, device=None, tiny=False) -> int:
    """``device=None`` looks for the cards the cell asks for; a test
    passes ``"cpu"``, and ``tiny=True`` to run at the traffic file's
    ``tiny`` sizes."""
    args = parse(argv)
    for var, sub in CACHE_VARS.items():
        os.environ[var] = os.path.join(CACHE, sub)
    from loopsbench import harness, spec

    cell = spec.resolve(args.workload)
    if tiny:
        _merge(cell.config, cell.traffic.get("tiny", {}).get("config", {}))
        _merge(cell.traffic, cell.traffic.get("tiny", {}).get("traffic", {}))
    import torch

    if device is None:
        if (not torch.cuda.is_available()
                or torch.cuda.device_count() < cell.chips):
            print(f"{args.workload} needs {cell.chips} CUDA card(s); "
                  f"{torch.cuda.device_count()} visible", file=sys.stderr)
            return 2
        device = "cuda"
    result, _ = harness.execute(cell, args.seed, args.seconds,
                                bool(args.trace), device, T0)
    found = harness.banned_modules()
    if found:
        print(f"modules loaded by the run: {found}", file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        c["value"] = _finite(c["value"])
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result, allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
