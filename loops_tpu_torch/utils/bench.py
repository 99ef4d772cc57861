"""Per-apply benchmark timing.

On a CUDA device ``apply_ms`` warms up, records one event before and one
after ``iters`` back-to-back applies on the current stream, synchronizes,
and divides; it repeats that and reports the median. PyTorch launches
asynchronously, so the events bracket exactly the device work of the
``iters`` applies. On the CPU the same loop runs under the host clock.

``slope_ms`` ports ``loops_tpu/utils/bench.py`` ``slope_ms``: ``fn``
chained ``lo`` and ``hi`` times, the slope over the difference. On the
TPU it cancelled the dispatch round trip; here it cancels the launch and
ramp costs that a run of launches pays once. ``run_slope_ms`` is the same
slope over any ``run(n)``, such as a kernel that loops ``n`` passes inside
one launch (``utils/stream.pass_ms``, the K14 probes).
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


def _run_ms(run, n: int, cuda: bool) -> float:
    """Milliseconds of ``run(n)``: CUDA events on the card, the host clock
    on the CPU."""
    if cuda:
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        run(n)
        t1.record()
        t1.synchronize()
        return t0.elapsed_time(t1)
    h0 = time.perf_counter()
    run(n)
    return (time.perf_counter() - h0) * 1e3


def run_slope_ms(run, lo: int, hi: int, repeats: int = 3,
                 cuda: bool = True) -> float:
    """``(least time of run(hi) - least time of run(lo)) / (hi - lo)``,
    each side warmed once first."""
    _run_ms(run, lo, cuda), _run_ms(run, hi, cuda)  # warm
    # min of each side, NOT min of paired deltas (a noisy lo draw would
    # bias the estimate low, even below physical floors)
    t_lo = min(_run_ms(run, lo, cuda) for _ in range(repeats))
    t_hi = min(_run_ms(run, hi, cuda) for _ in range(repeats))
    return (t_hi - t_lo) / (hi - lo)


def slope_ms(fn, x, lo: int = 4, hi: int = 20, repeats: int = 3) -> float:
    """Launch-overhead-free ms per application of shape-preserving
    ``fn``: ``fn`` chained ``lo`` and ``hi`` times from ``x``, the slope
    over the difference."""
    def chain(n):
        v = x
        for _ in range(n):
            v = fn(v)
        return v
    return run_slope_ms(chain, lo, hi, repeats, x.is_cuda)
