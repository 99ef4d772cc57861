"""Per-apply benchmark timing.

On a CUDA device ``apply_ms`` warms up, records one event before and one
after ``iters`` back-to-back applies on the current stream, synchronizes,
and divides; it repeats that and reports the median. PyTorch launches
asynchronously, so the events bracket exactly the device work of the
``iters`` applies. On the CPU the same loop runs under the host clock.
"""
from __future__ import annotations

import statistics
import time

import torch


def apply_ms(fn, x, iters: int = 20, repeats: int = 5,
             warmup: int = 3) -> float:
    """Median over ``repeats`` of the milliseconds per ``fn(x)``."""
    for _ in range(warmup):
        fn(x)
    cuda = x.is_cuda
    if cuda:
        torch.cuda.synchronize(x.device)
    samples = []
    for _ in range(repeats):
        if cuda:
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            for _ in range(iters):
                fn(x)
            t1.record()
            t1.synchronize()
            samples.append(t0.elapsed_time(t1) / iters)
        else:
            h0 = time.perf_counter()
            for _ in range(iters):
                fn(x)
            samples.append((time.perf_counter() - h0) * 1e3 / iters)
    return float(statistics.median(samples))
