#!/usr/bin/env python3
"""K12's body one design choice at a time, on the card: each variant of
``scripts/saxpy_variants_torch.cu`` built with its switches, held bit for
bit to ``a * x + y`` and timed beside the port's K12 and ``torch.add``.

    python scripts/saxpy_variants_torch.py [--turns 5]

``saxpy_variants_torch.cu`` is K12's body (``loops_tpu_torch/csrc/
saxpy.cu``) with four macros (``K12_THREADS``, ``K12_CTAS_PER_SM``,
``K12_UNROLL``, ``K12_STREAMING``); the port's own source has none. Each
variant of ``VARIANTS`` is built with its ``-D`` flags into a library of
its own (one nvcc each, all started together, ``-Xptxas -v`` printed),
bound through the port's launch binding (its ``bind``), and launched on
each grid of ``GRIDS``: at most ``ctas`` CTAs an SM (the port's grid
before it ran one pass), or one pass, one float4 of each of ``unroll``
slots a thread. Each is held bit for bit to ``saxpy_plain`` at 2^26
elements, aligned and on views one float past 16 bytes (the scalar
loop), then timed at 2^26 and at the example's [8, 8192]: ms per call by
the slope of 20 calls over 4 (``probes/common.launch_ms``), in
``--turns`` rounds, the order reversed every other round, the port's
``saxpy_cuda`` and ``torch.add`` in each. Prints each one's least,
median and largest time, the card's name and power limit, then one JSON
line. Needs an NVIDIA card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from loops_tpu_torch.ops.kernels import _build, saxpy  # noqa: E402
from loops_tpu_torch.probes.common import launch_ms  # noqa: E402
from loops_tpu_torch.utils import counters  # noqa: E402

# name -> (threads, CTAs an SM, float4 in flight a thread, streaming)
VARIANTS = {
    "pr5 (256x4, 1, plain)": (256, 4, 1, 0),
    "pr5+b (256x4, 1, streaming)": (256, 4, 1, 1),
    "a (512x4, 1, plain)": (512, 4, 1, 0),
    "a' (256x8, 1, plain)": (256, 8, 1, 0),
    "a+b (512x4, 1, streaming)": (512, 4, 1, 1),
    "a+b+c2 (512x4, 2, streaming)": (512, 4, 2, 1),
    "a+b+c4 (512x4, 4, streaming)": (512, 4, 4, 1),
    "a+c4 (512x4, 4, plain)": (512, 4, 4, 0),
}
GRIDS = ("persistent", "one-pass")


def build(tmp: str) -> dict:
    """name -> (library path, ptxas lines), one nvcc per variant, all
    started together."""
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "saxpy_variants_torch.cu")
    procs = {}
    for k, (name, (th, ctas, un, st)) in enumerate(VARIANTS.items()):
        so = os.path.join(tmp, f"libsaxpy_{k}.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
               f"-DK12_THREADS={th}", f"-DK12_CTAS_PER_SM={ctas}",
               f"-DK12_UNROLL={un}", f"-DK12_STREAMING={st}", "-shared",
               "-o", so, src]
        procs[name] = (so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    out = {}
    for name, (so, proc) in procs.items():
        _, err = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{err[-4000:]}")
        out[name] = (so, [ln.strip() for ln in err.splitlines()
                          if "registers" in ln or "spill" in ln])
    return out


def launcher(so: str, shape: tuple, grid: str, sms: int):
    """``fn(a, x, y) -> out``: the variant's entry point through the
    launch binding, on its grid (``lib`` stays open while it is
    referenced)."""
    lib = ctypes.CDLL(so)
    fn = _build.load_binding().bind(saxpy.ENTRY, ctypes.cast(
        getattr(lib, saxpy.ENTRY), ctypes.c_void_p).value)
    th, ctas, un, _ = shape

    def call(a, x, y):
        out = torch.empty_like(x)
        n = x.numel()
        if grid == "persistent":
            g = max(1, min(-(-n // (4 * th)), ctas * sms))
        else:
            g = max(1, -(-n // (4 * th * un)))
        err = fn(a, x.data_ptr(), y.data_ptr(), out.data_ptr(), n, g,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"CUDA error {err}")
        return out
    call.lib = lib
    return call


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--turns", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("saxpy_variants_torch: needs an NVIDIA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    sms = _build.sm_count(dev)
    g = torch.Generator(device=dev).manual_seed(12)
    big = [torch.randn(1 << 26, device=dev, generator=g) for _ in range(2)]
    small = [torch.randn(8, 8192, device=dev, generator=g) for _ in range(2)]
    res = {"card": smi, "bound_ms": counters.bound_of(
        counters.saxpy_work(1 << 26))[0], "variants": {}}
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(tmp)
        calls = {}
        for name, (so, ptxas) in libs.items():
            for grid in GRIDS:
                f = launcher(so, VARIANTS[name], grid, sms)
                for off in (0, 1):  # 1: the scalar loop
                    xs = [b[off:] for b in big]
                    got = f(-0.75, *xs)
                    if not torch.equal(got, saxpy.saxpy_plain(-0.75, *xs)):
                        raise AssertionError(f"{name} {grid}: not a * x + y")
                del xs, got
                key = f"{name} {grid}"
                calls[key] = f
                res["variants"][key] = {"ptxas": ptxas, "2^26 ms": [],
                                        "[8, 8192] ms": []}
        calls["port saxpy_cuda"] = saxpy.saxpy_cuda
        calls["torch.add"] = lambda a, x, y: torch.add(y, x, alpha=a)
        for key in ("port saxpy_cuda", "torch.add"):
            res["variants"][key] = {"2^26 ms": [], "[8, 8192] ms": []}
        order = list(calls)
        for turn in range(args.turns):
            for key in (order if turn % 2 == 0 else order[::-1]):
                f = calls[key]
                r = res["variants"][key]
                r["2^26 ms"].append(launch_ms(lambda: f(2.5, *big), dev))
                r["[8, 8192] ms"].append(launch_ms(lambda: f(2.5, *small),
                                                   dev))
    def spread(ms):
        return (f"{min(ms):.4f} / {statistics.median(ms):.4f} / "
                f"{max(ms):.4f}")
    for key, r in res["variants"].items():
        r["share of the bound"] = res["bound_ms"] / statistics.median(
            r["2^26 ms"])
        print(f"{key}: 2^26 least / median / largest {spread(r['2^26 ms'])}"
              f" ms (median {r['share of the bound']:.1%} of "
              f"{res['bound_ms']:.4f}), [8, 8192] "
              f"{spread(r['[8, 8192] ms'])} ms {r.get('ptxas', '')}")
    print(smi)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
