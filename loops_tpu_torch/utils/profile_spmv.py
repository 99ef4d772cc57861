"""Where the time of a CSR SpMV apply goes on the card: device time per
kernel, wall time per apply, the device's idle share, and a measured
HBM stream to hold the kernels' byte rates against.

    python -m loops_tpu_torch.utils.profile_spmv [--out profile.json]

For each matrix (the ones ``chip_smoke.py`` times) and each path (the
three CUDA kernels through ``SpMVOperator``, cuSPARSE's CSR SpMV through
``torch.mv``, and two torch-op executors), it runs ``warmup`` (5) applies,
then:

* ``wall_ms``: host clock over ``applies`` (50) back-to-back applies and
  one synchronize, divided by ``applies``, without the profiler;
* ``device_ms`` and ``kernels``: ``torch.profiler`` over another
  ``applies`` applies; each device kernel's summed duration per apply;
* ``idle_share``: ``1 - device_ms / wall_ms``, the share of an apply's
  wall time in which no kernel of it ran.

The trace is read only when it holds every launch (``trace_gaps``): each
kernel of the port as many times as its wrappers counted in
``_build.LAUNCHES`` over the window, and every kernel a whole number of
times per apply. Otherwise ``device_ms``, ``idle_share`` and ``kernels``
are "not measured" (None, None, []) and ``not_measured`` says what the
trace lacked: the profiler on the card has recorded only part of a
window's launches, and a short count divided by ``applies`` understates
the device time.

The stream is ``torch.sum`` (read) and ``Tensor.copy_`` (read + write)
over a 1 GiB float32 tensor, timed with CUDA events (``apply_ms``); it is
a measured bound for bytes per second, not a port of the TPU's stream
kernel. Needs an NVIDIA card.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import time

import torch

from loops_tpu_torch.ops.kernels import _build
from loops_tpu_torch.utils import generate
from loops_tpu_torch.utils.bench import apply_ms

# the bench SpMV matrix of the JAX package (~4.39M nnz, L2-resident) and
# one past L2 and past its single-chip caps (~33.5M nnz)
MATRICES = {k: generate.SCALE_MATRICES[k]
            for k in ("bench_32768", "big_2097152")}
PATHS = {
    # label -> (SpMVOperator schedule, impl)
    "sorted_spmv": ("sorted_flat", "xla"),
    "flat_spmv_v2": ("merge_path", "pallas2"),
    "flat_spmv": ("merge_path", "pallas"),
    "torch_row_mapped": ("row_mapped", "xla"),
    "torch_merge_path": ("merge_path", "xla"),
}
BLOCK = 1024


def _sync(x):
    if x.is_cuda:
        torch.cuda.synchronize(x.device)


# The kernel names a launch counter's launches carry in a trace, where
# they are not "<counter>_kernel" (csrc/*.cu); a name matches a trace
# event's name as a whole identifier.
TRACE_NAMES = {
    "block_dot_f32": ("block_dot_f32_kernel", "block_dot_f32_rows_kernel"),
    "smem_scatter": ("scatter_smem_kernel",),
    "l2_scatter": ("scatter_l2_kernel",),
    **{f"row_gather_{m}_{w}": (k,)
       for m, k in (("sum", "row_gather_sum_kernel"),
                    ("mat", "row_gather_kernel"))
       for w in ("smem", "l2", "hbm")},
    "onehot_expand": ("row_gather_kernel",),
}


def trace_names(counter: str) -> tuple:
    return TRACE_NAMES.get(counter, (f"{counter}_kernel",))


def trace_gaps(counted: dict, recorded: dict, applies: int) -> list:
    """What keeps a trace from being read, as short notes (none: it holds
    every launch). ``counted``: launches per counter of
    ``_build.LAUNCHES`` over the window; ``recorded``: trace event name ->
    times recorded. A gap is an empty trace, a kernel of the port
    recorded fewer times than its wrappers counted, or a kernel recorded
    a number of times that is not a multiple of ``applies``."""
    if not recorded:
        return ["torch.profiler recorded no kernel"]
    want = {}
    for counter, n in counted.items():
        if n:
            names = trace_names(counter)
            want[names] = want.get(names, 0) + n
    gaps = []
    for names, n in want.items():
        pat = re.compile(r"\b(%s)\b" % "|".join(map(re.escape, names)))
        got = sum(k for ev, k in recorded.items() if pat.search(ev))
        if got < n:
            gaps.append(f"{got} of {n} launches of {'/'.join(names)}")
    gaps += [f"{short_name(ev)} x{k}/{applies}"
             for ev, k in recorded.items() if k % applies]
    return gaps


def short_name(ev: str, width: int = 40) -> str:
    """A trace event's kernel name without its return type, anonymous
    namespace and arguments."""
    ev = ev.replace("(anonymous namespace)::", "").removeprefix("void ")
    return ev.split("(", 1)[0][:width]


def read_trace(per_kernel: dict, counted: dict, applies: int,
               wall_ms: float, cuda: bool = True) -> dict:
    """``profile_applies``' result from a window's trace, ``per_kernel``:
    event name -> (times recorded, summed microseconds). On the card it
    is read only without ``trace_gaps``; on the CPU nothing ran on a
    device (``device_ms`` 0)."""
    gaps = trace_gaps(counted, {k: n for k, (n, _) in per_kernel.items()},
                      applies) if cuda else []
    if gaps:
        return dict(wall_ms=wall_ms, device_ms=None, idle_share=None,
                    kernels=[], not_measured=gaps)
    kernels = sorted(([name, n / applies, us / 1e3 / applies]
                      for name, (n, us) in per_kernel.items()),
                     key=lambda k: -k[2])
    device_ms = sum(k[2] for k in kernels)
    return dict(wall_ms=wall_ms, device_ms=device_ms,
                idle_share=max(0.0, 1.0 - device_ms / wall_ms),
                kernels=kernels, not_measured=[])


def profile_applies(fn, x, applies: int = 50, warmup: int = 5) -> dict:
    """Wall and device time per ``fn(x)``, by kernel (see the module
    docstring): ``wall_ms``, ``device_ms``, ``idle_share``, ``kernels``
    ([name, launches per apply, ms per apply]) and ``not_measured``. On
    the CPU no kernel is recorded and ``device_ms`` is 0; on a card whose
    trace lacks launches, ``device_ms`` and ``idle_share`` are None and
    ``not_measured`` names what it lacked."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn(x)
    _sync(x)
    t0 = time.perf_counter()
    for _ in range(applies):
        fn(x)
    _sync(x)
    wall_ms = (time.perf_counter() - t0) * 1e3 / applies
    activities = [ProfilerActivity.CPU]
    if x.is_cuda:
        activities.append(ProfilerActivity.CUDA)
    before = dict(_build.LAUNCHES)
    with profile(activities=activities) as prof:
        for _ in range(applies):
            fn(x)
        _sync(x)
    counted = {k: n - before[k] for k, n in _build.LAUNCHES.items()}
    per_kernel = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, us = per_kernel.get(e.name, (0, 0.0))
            per_kernel[e.name] = (n + 1, us + e.time_range.elapsed_us())
    return read_trace(per_kernel, counted, applies, wall_ms, x.is_cuda)


def stream_gbps(device, nbytes: int = 1 << 30) -> dict:
    """Measured read and copy rates over ``nbytes`` of float32, GB/s."""
    a = torch.ones(nbytes // 4, dtype=torch.float32, device=device)
    b = torch.empty_like(a)
    read_ms = apply_ms(lambda v: v.sum(), a, iters=10)
    copy_ms = apply_ms(lambda v: b.copy_(v), a, iters=10)
    return dict(read_gbps=nbytes / read_ms / 1e6,
                copy_gbps=2 * nbytes / copy_ms / 1e6)


def main(argv=None) -> int:
    from loops_tpu_torch.ops.spmv import SpMVOperator
    from loops_tpu_torch.utils.platform import ensure_platform

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="write the JSON result here as well")
    args = ap.parse_args(argv)
    device = ensure_platform("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    result = {"card": smi, "stream": stream_gbps(device)}
    print(f"stream: {json.dumps(result['stream'])}", flush=True)
    for mname, make in MATRICES.items():
        csr = make()
        x = torch.from_numpy(
            generate.make_input_vector(csr.shape[1])).to(device)
        runs = {}
        for label, (schedule, impl) in PATHS.items():
            op = SpMVOperator(csr, schedule, block=BLOCK, impl=impl,
                              device=device)
            runs[label] = profile_applies(op, x)
            del op
        A = torch.sparse_csr_tensor(
            torch.from_numpy(csr.offsets).to(device),
            torch.from_numpy(csr.indices).to(device),
            torch.from_numpy(csr.vals).to(device), size=csr.shape)
        runs["cusparse"] = profile_applies(lambda v: torch.mv(A, v), x)
        del A
        for label, r in runs.items():
            print(f"{mname} ({csr.nnz} nnz) {label}: wall {r['wall_ms']:.4f} "
                  "ms, " + (f"device time not measured ("
                            f"{'; '.join(r['not_measured'])})"
                            if r["not_measured"] else
                            f"device {r['device_ms']:.4f} ms, idle "
                            f"{r['idle_share']:.3f}; "
                            + "; ".join(f"{k[0][:60]} {k[2]:.4f}"
                                        for k in r["kernels"])),
                  flush=True)
        result[mname] = dict(nnz=int(csr.nnz), runs=runs)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
