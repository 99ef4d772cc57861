#!/usr/bin/env python3
"""Smoke run of loops_tpu_torch, the PyTorch + CUDA port, on one NVIDIA card.

    python3 chip_smoke.py

Phases, one line each with its time:

1. card:   ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build:  nvcc builds the three CSR SpMV kernels from ``loops_tpu_torch/csrc``;
3. kernels vs plain: K1 (``sorted_spmv``), K2 (``flat_spmv_v2``) and K3
   (``flat_spmv``) against their plain PyTorch versions on the same staged
   buffers, on the 9-matrix battery (blocks 8 and 1024), on the bench
   matrix (32768^2, ~4.39M nnz) and, for K3, on a 157 KB row window (past
   the default 48 KB of shared memory): agreement, the Wilkinson verdict,
   two runs bitwise equal, the launch counter;
4. main path: ``examples/spmv_torch.py`` on ``datasets/chesapeake.mtx`` with
   ``--validate --rigorous`` for every schedule and kernel impl;
5. at scale: ``SpMVOperator`` with each kernel on the bench matrix and on
   2097152^2 with ~33.5M nnz, each result validated. The launch counters are
   set to 0 before phase 4 and read after phase 5: every kernel must have
   launched on the main path;
6. timing: per apply, the median of CUDA-event timings, of each kernel, its
   plain version and cuSPARSE's CSR SpMV (the paper's opponent, timed only),
   with the host plan time.

The kernel-vs-plain tolerance is twice the Wilkinson bound the validator
uses (``2 * 4 * nnz_row * u * sum|a*x|``, floor 1e-6): both results lie
within one bound of the exact row sum, whatever their summation order.

It exits non-zero, and prints no result, when no card is visible or any
phase fails. The line before the last is a JSON object with one entry per
kernel; the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SOURCE = "loops_tpu_torch/csrc/spmv.cu"
KERNELS = {
    # name -> (TPU kernel it replaces, SpMVOperator schedule, impl)
    "sorted_spmv": ("loops_tpu/ops/kernels/spmv_sorted.py:325",
                    "sorted_flat", "xla"),
    "flat_spmv_v2": ("loops_tpu/ops/kernels/spmv_flat_v2.py:88",
                     "merge_path", "pallas2"),
    "flat_spmv": ("loops_tpu/ops/kernels/spmv_flat.py:41",
                  "merge_path", "pallas"),
}
CLI_CASES = [
    ["--schedule", "row_mapped"], ["--schedule", "group_mapped"],
    ["--schedule", "work_oriented"], ["--schedule", "merge_path"],
    ["--schedule", "merge_path", "--impl", "pallas"],
    ["--schedule", "merge_path", "--impl", "pallas2"],
    ["--schedule", "sorted_flat"], ["--schedule", "auto"],
]
BENCH_BLOCK = 1024


class PhaseFailed(RuntimeError):
    pass


def require(cond, msg):
    if not cond:
        raise PhaseFailed(msg)


def phase(n, name, t0, detail=""):
    print(f"phase {n} {name}: ok {detail}({time.perf_counter() - t0:.2f} s)",
          flush=True)


def pair_tolerance(csr, x):
    """Twice the validator's Wilkinson bound per row, floor 1e-6."""
    from loops_tpu_torch.utils import reference

    l1 = reference.row_l1_products(csr, x)
    nnz_r = csr.row_sizes().astype(np.float64)
    u = reference.unit_roundoff(np.float32)
    return np.maximum(1e-6, 2 * reference.DEFAULT_WILKINSON_K * nnz_r * u * l1)


def kernel_vs_plain(kname, csr, x, block, device, schedule="merge_path"):
    """Build one kernel's buffers, run kernel twice and plain once; return
    the max abs difference."""
    import torch

    from loops_tpu_torch.layout import CsrLayout
    from loops_tpu_torch.ops.kernels import _build, spmv_flat, spmv_flat_v2, spmv_sorted
    from loops_tpu_torch.schedule.plans import make_plan
    from loops_tpu_torch.utils import reference

    if kname == "sorted_spmv":
        b, fn = spmv_sorted.sorted_spmv(
            csr, device=device, **({"block_atoms": block} if block else {}))
        plain = lambda xd: spmv_sorted.sorted_spmv_plain(b, xd, None)  # noqa: E731
    else:
        block = block or BENCH_BLOCK
        plan = make_plan(CsrLayout.from_csr(csr), schedule,
                         **({"block_work": block} if schedule == "merge_path"
                            else {"block_atoms": block}))
        if kname == "flat_spmv_v2":
            b, fn = spmv_flat_v2.flat_spmv_v2(csr, plan, device=device)
            plain = lambda xd: spmv_flat_v2.flat_spmv_v2_plain(  # noqa: E731
                b, xd, csr.shape)
        else:
            b, fn = spmv_flat.flat_spmv(csr, plan, device=device)
            plain = lambda xd: spmv_flat.flat_spmv_plain(  # noqa: E731
                b, xd, csr.shape, fn.meta["R"])
    xd = torch.from_numpy(x).to(device)
    before = _build.LAUNCHES[kname]
    y1 = fn(b, xd)
    y2 = fn(b, xd)
    torch.cuda.synchronize()
    require(_build.LAUNCHES[kname] == before + 2,
            f"{kname}: launch counter did not go up by 2")
    require(torch.equal(y1, y2), f"{kname}: two runs are not bitwise equal")
    y = y1.cpu().numpy()
    yp = plain(xd).cpu().numpy()
    diff = np.abs(y.astype(np.float64) - yp)
    require(np.all(np.isfinite(y)), f"{kname}: non-finite output")
    require(np.all(diff <= pair_tolerance(csr, x)),
            f"{kname}: kernel and plain differ by {diff.max():.3e}")
    rep = reference.rigorously_validate_spmv(csr, x, y)
    require(rep.verdict == "NOT_A_BUG", f"{kname}: {rep}")
    return float(diff.max(initial=0.0))


def run_cli(args):
    """``examples/spmv_torch.py`` main() in this process; returns
    (status, stdout, stderr)."""
    spec = importlib.util.spec_from_file_location(
        "spmv_torch_example", os.path.join(REPO, "examples", "spmv_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        status = mod.main(args)
    return status, out.getvalue(), err.getvalue()


def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from loops_tpu_torch.ops.kernels import _build
    from loops_tpu_torch.ops.spmv import SpMVOperator
    from loops_tpu_torch.utils import generate, reference
    from loops_tpu_torch.utils.bench import apply_ms
    from loops_tpu_torch.utils.equal import count_mismatches
    from loops_tpu_torch.utils.profile_spmv import MATRICES

    device = torch.device("cuda", 0)

    # ---- 1. card
    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi)
    kind = torch.cuda.get_device_name(0)
    phase(1, "card", t0, f"{kind}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; {torch.cuda.device_count()} visible ")

    # ---- 2. build
    t0 = time.perf_counter()
    _build.load_library()
    phase(2, "build", t0, f"nvcc {' '.join(_build.NVCC_FLAGS)} -> "
          f"{os.path.relpath(_build.BUILD_INFO['path'], REPO)} in "
          f"{_build.BUILD_INFO['seconds']:.2f} s ")

    # ---- 3. kernels vs plain
    t0 = time.perf_counter()
    max_err = {k: 0.0 for k in KERNELS}
    n_cases = 0
    for name, make in generate.BATTERY.items():
        csr = make()
        x = generate.make_input_vector(csr.shape[1])
        for block in (8, 1024):
            for kname in KERNELS:
                max_err[kname] = max(max_err[kname],
                                     kernel_vs_plain(kname, csr, x, block,
                                                     device))
                n_cases += 1
    bench = MATRICES["bench_32768"]()
    x_bench = generate.make_input_vector(bench.shape[1])
    for kname in KERNELS:
        max_err[kname] = max(max_err[kname],
                             kernel_vs_plain(kname, bench, x_bench, None,
                                             device))
        n_cases += 1
    wide = generate.wide_span_csr(40_000)
    max_err["flat_spmv"] = max(max_err["flat_spmv"], kernel_vs_plain(
        "flat_spmv", wide, generate.make_input_vector(wide.shape[1]), 8,
        device, schedule="work_oriented"))
    n_cases += 1
    phase(3, "kernels vs plain", t0,
          f"{n_cases} cases, max |kernel - plain| "
          + ", ".join(f"{k} {v:.3e}" for k, v in max_err.items()) + " ")

    # ---- 4. main path: the example CLI
    t0 = time.perf_counter()
    _build.reset_launches()
    mtx = os.path.join(REPO, "datasets", "chesapeake.mtx")
    for case in CLI_CASES:
        status, out, err = run_cli(["-m", mtx, "--validate", "--rigorous",
                                    "--device", "cuda", *case])
        label = " ".join(case)
        csv = [ln for ln in out.splitlines() if ln.startswith("csr_")]
        print(f"  spmv_torch {label}: {csv[0] if csv else '?'} | "
              f"{err.strip()}")
        require(status == 0, f"spmv_torch {label}: exit status {status}\n"
                f"{out}{err}")
        require("Errors: 0" in out, f"spmv_torch {label}: {out}")
        require("Verdict: NOT_A_BUG" in out, f"spmv_torch {label}: {out}")
        if "auto" in case:
            require("impl_used: sorted_spmv" in err,
                    f"auto did not take K1: {err}")
    phase(4, "main path (examples/spmv_torch.py)", t0,
          f"{len(CLI_CASES)} cases ")

    # ---- 5. at scale, through SpMVOperator
    t0 = time.perf_counter()
    big = MATRICES["big_2097152"]()
    x_big = generate.make_input_vector(big.shape[1])
    mats = {"bench_32768": (bench, x_bench), "big_2097152": (big, x_big)}
    ops = {}
    for mname, (csr, x) in mats.items():
        for kname, (_, schedule, impl) in KERNELS.items():
            th = time.perf_counter()
            op = SpMVOperator(csr, schedule, block=BENCH_BLOCK, impl=impl,
                              device=device)
            build_s = time.perf_counter() - th
            require(op.impl_used == kname,
                    f"{mname}/{kname}: took {op.impl_used}")
            y = op(x).cpu().numpy()
            require(op.launches == 1, f"{mname}/{kname}: {op.launches} "
                    "launches")
            require(y.shape == (csr.shape[0],) and np.all(np.isfinite(y)),
                    f"{mname}/{kname}: bad output")
            errors = count_mismatches(y, reference.spmv(csr, x))
            rep = reference.rigorously_validate_spmv(csr, x, y)
            print(f"  {mname} ({csr.shape[0]}x{csr.shape[1]}, {csr.nnz} nnz) "
                  f"{kname}: Errors {errors}, Verdict {rep.verdict}, "
                  f"plan_ms {op.meta['plan_ms']:.1f}, operator build "
                  f"{build_s:.2f} s")
            require(errors == 0 and rep.verdict == "NOT_A_BUG",
                    f"{mname}/{kname}: {errors} errors, {rep}")
            ops[mname, kname] = op
    launches = dict(_build.LAUNCHES)
    for kname in KERNELS:
        require(launches[kname] > 0,
                f"{kname} never launched on the main path")
    phase(5, "at scale (SpMVOperator)", t0,
          "main-path launches " + json.dumps(launches) + " ")

    # ---- 6. timing: plain, kernel, kernel, plain; cuSPARSE once
    t0 = time.perf_counter()
    from loops_tpu_torch.ops.kernels import spmv_flat, spmv_flat_v2, spmv_sorted

    plains = {
        "sorted_spmv": lambda op: (lambda xd: spmv_sorted.sorted_spmv_plain(
            op._bufs, xd, None)),
        "flat_spmv_v2": lambda op: (lambda xd: spmv_flat_v2.flat_spmv_v2_plain(
            op._bufs, xd, op.mat.shape)),
        "flat_spmv": lambda op: (lambda xd: spmv_flat.flat_spmv_plain(
            op._bufs, xd, op.mat.shape, op.meta["R"])),
    }
    times = {}
    for mname, (csr, x) in mats.items():
        xd = torch.from_numpy(x).to(device)
        A = torch.sparse_csr_tensor(
            torch.from_numpy(csr.offsets).to(device),
            torch.from_numpy(csr.indices).to(device),
            torch.from_numpy(csr.vals).to(device), size=csr.shape)
        y_cs = torch.mv(A, xd)
        require(bool(torch.isfinite(y_cs).all()), "cuSPARSE: bad output")
        cusparse_ms = apply_ms(lambda v: torch.mv(A, v), xd)
        for kname in KERNELS:
            op = ops[mname, kname]
            plain = plains[kname](op)
            if mname == "big_2097152":
                diff = np.abs(op(xd).cpu().numpy().astype(np.float64)
                              - plain(xd).cpu().numpy())
                require(np.all(diff <= pair_tolerance(csr, x)),
                        f"{kname}: kernel and plain differ by {diff.max()}")
                max_err[kname] = max(max_err[kname],
                                     float(diff.max(initial=0.0)))
            p1 = apply_ms(plain, xd)
            k1 = apply_ms(op, xd)
            k2 = apply_ms(op, xd)
            p2 = apply_ms(plain, xd)
            times[mname, kname] = dict(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
                                       cusparse_ms=cusparse_ms,
                                       plan_ms=op.meta["plan_ms"])
            print(f"  {mname} {kname}: kernel {k1:.4f}/{k2:.4f} ms, plain "
                  f"{p1:.4f}/{p2:.4f} ms, cuSPARSE {cusparse_ms:.4f} ms, "
                  f"host plan {op.meta['plan_ms']:.1f} ms  [{smi}]")
        del A
    phase(6, "timing (CUDA events, median per apply)", t0)

    print(f"total {time.perf_counter() - t_start:.1f} s; card: {smi}")
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": SOURCE, "replaces": rep_at,
         "launches": launches[k], "max_abs_err": max_err[k],
         "ms": times["big_2097152", k]["ms"],
         "plain_ms": times["big_2097152", k]["plain_ms"]}
        for k, (rep_at, _, _) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
