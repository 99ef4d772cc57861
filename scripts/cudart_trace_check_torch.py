#!/usr/bin/env python
"""Whether ``torch.profiler``'s kernel list holds every launch of the
port's kernels, by how their library links the CUDA runtime.

``nvcc -shared`` links nvcc's static CUDA runtime into the kernels'
library, so the process holds two runtimes: torch's ``libcudart.so`` and
the library's own copy. ``--cudart shared`` builds the library with
``-cudart shared`` instead, into a directory of its own, so its launches
go through the runtime torch loaded; the port's own build is left as it
is. Each build then runs K1 on the
bench_32768 matrix (``sorted_flat``):

* ``rounds`` windows of ``applies`` applies through
  ``utils/profile_spmv.profile_applies``, each read against the launch
  counters (``trace_gaps``: whole, or what the list lacked);
* one ``utils/trace.profile`` window of 5 applies (the port's own record
  against the profiler's list);
* K1's ms per apply (``apply_ms``) and card ms (``device_ms``), and K12's
  ms per call at [8, 8192] (slope of 20 calls over 4) beside
  ``torch.add``'s;
* the ``libcudart`` files the process has mapped.

    python scripts/cudart_trace_check_torch.py --cudart static|shared
        [--applies 50] [--rounds 3]

Prints one JSON line. Compare two builds in one chip call, in turns
(static, shared, shared, static). Needs an NVIDIA card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from unittest import mock

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from loops_tpu_torch.ops.kernels import _build, saxpy  # noqa: E402
from loops_tpu_torch.ops.spmv import SpMVOperator  # noqa: E402
from loops_tpu_torch.probes.common import launch_ms  # noqa: E402
from loops_tpu_torch.utils import generate, libbuild, trace  # noqa: E402
from loops_tpu_torch.utils.bench import apply_ms, device_ms  # noqa: E402
from loops_tpu_torch.utils.platform import ensure_platform  # noqa: E402
from loops_tpu_torch.utils.profile_spmv import profile_applies  # noqa: E402

CUDART = {"static": (), "shared": ("-cudart", "shared")}


def build_linked(link_flags: tuple):
    """``_build._build`` with ``link_flags`` on its link step: one nvcc per
    source, then ``nvcc -shared <link_flags>``."""
    def build(files, so_path):
        nvcc = _build._nvcc()

        def make(tmp, tag):
            objs = [f"{so_path}.{os.path.basename(f)}.{tag}.o" for f in files]
            try:
                _build._run([_build._start([nvcc, *_build.NVCC_FLAGS, "-c",
                                            "-o", o, f])
                             for f, o in zip(files, objs)])
                _build._run([_build._start([nvcc, "-shared", *link_flags,
                                            "-o", tmp, *objs])])
            finally:
                for o in objs:
                    if os.path.exists(o):
                        os.remove(o)
        libbuild.publish(so_path, make)
    return build


def mapped_cudart() -> list:
    """The ``libcudart`` files mapped into this process."""
    with open("/proc/self/maps") as f:
        return sorted({ln.split()[-1] for ln in f if "libcudart" in ln})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cudart", choices=sorted(CUDART), default="static")
    ap.add_argument("--applies", type=int, default=50)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    device = ensure_platform("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as build_dir:
        if CUDART[args.cudart]:  # its own copy, in a directory of its own
            with mock.patch.object(_build, "BUILD_DIR", build_dir), \
                    mock.patch.object(_build, "_build",
                                      build_linked(CUDART[args.cudart])):
                _build.load_library()
        else:
            _build.load_library()
        build_s = time.perf_counter() - t0
        return measure(args, device, smi, build_s)


def measure(args, device, smi: str, build_s: float) -> int:
    csr = generate.SCALE_MATRICES["bench_32768"]()
    x = torch.from_numpy(generate.make_input_vector(csr.shape[1])).to(device)
    op = SpMVOperator(csr, "sorted_flat", device=device)
    if op.impl_used != "sorted_spmv":
        raise SystemExit(f"sorted_flat took {op.impl_used}, not K1")
    windows = []
    for _ in range(args.rounds):
        r = profile_applies(op, x, applies=args.applies)
        windows.append({"gaps": r["not_measured"],
                        "device_ms": r["device_ms"], "wall_ms": r["wall_ms"]})
    with tempfile.TemporaryDirectory() as d:
        with trace.profile(d):
            for i in range(5):
                with trace.annotate(f"apply{i}"):
                    op(x)
        rec = trace.read_record(d)
    sx, sy = (torch.randn(8, 8192, device=device) for _ in range(2))
    out = {
        "card": smi, "cudart": args.cudart, "link_flags": list(
            CUDART[args.cudart]), "library": os.path.basename(
                _build.BUILD_INFO["path"]), "build_s": build_s,
        "mapped_cudart": mapped_cudart(), "applies": args.applies,
        "windows": windows,
        "whole_windows": sum(not w["gaps"] for w in windows),
        "record": {k: rec[k] for k in ("profiler_list_whole",
                                       "profiler_gaps", "device_ms",
                                       "wall_ms")},
        "k1_apply_ms": apply_ms(op, x), "k1_device_ms": device_ms(op, x),
        "k12_call_ms": launch_ms(lambda: saxpy.saxpy_cuda(2.5, sx, sy),
                                 device),
        "torch_add_ms": launch_ms(lambda: torch.add(sy, sx, alpha=2.5),
                                  device),
    }
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
