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

The stream is ``torch.sum`` (read) and ``Tensor.copy_`` (read + write)
over a 1 GiB float32 tensor, timed with CUDA events (``apply_ms``); it is
a measured bound for bytes per second, not a port of the TPU's stream
kernel. Needs an NVIDIA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from loops_tpu_torch.utils import generate
from loops_tpu_torch.utils.bench import apply_ms

# the bench SpMV matrix of the JAX package (~4.39M nnz, L2-resident) and
# one past L2 and past its single-chip caps (~33.5M nnz)
MATRICES = {
    "bench_32768": lambda: generate.random_csr(32768, 32768, 4e-6 * 1024,
                                               seed=3),
    "big_2097152": lambda: generate.random_csr(2_097_152, 2_097_152,
                                               16 / 2_097_152, seed=5),
}
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


def profile_applies(fn, x, applies: int = 50, warmup: int = 5) -> dict:
    """Wall and device time per ``fn(x)``, by kernel (see the module
    docstring). On the CPU no kernel is recorded and ``device_ms`` is 0."""
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
    with profile(activities=activities) as prof:
        for _ in range(applies):
            fn(x)
        _sync(x)
    per_kernel = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, us = per_kernel.get(e.name, (0, 0.0))
            per_kernel[e.name] = (n + 1, us + e.time_range.elapsed_us())
    kernels = sorted(([name, n / applies, us / 1e3 / applies]
                      for name, (n, us) in per_kernel.items()),
                     key=lambda k: -k[2])
    device_ms = sum(k[2] for k in kernels)
    return dict(wall_ms=wall_ms, device_ms=device_ms,
                idle_share=max(0.0, 1.0 - device_ms / wall_ms),
                kernels=kernels)


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
                  f"ms, device {r['device_ms']:.4f} ms, idle "
                  f"{r['idle_share']:.3f}; "
                  + "; ".join(f"{k[0][:60]} {k[2]:.4f}" for k in r["kernels"]),
                  flush=True)
        result[mname] = dict(nnz=int(csr.nnz), runs=runs)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
