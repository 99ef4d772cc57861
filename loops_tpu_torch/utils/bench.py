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

Back-to-back applies, chained or not, run at the pace of the slower of
host and card: when the host's launch path is the slower, ``apply_ms``
and ``slope_ms`` both read it. ``device_ms`` reads the card alone: a
sleep kernel holds the card while the host queues the applies, so they
run with no gap between them. ``1 - device_ms / apply_ms`` is then the
share of an apply in which the card waits for the host. ``host_us`` times
the host's side of a call the same way, with the card held so that it
never makes the host wait.

``cold_ms`` times one call whose operands would otherwise sit in the L2
from the call before: each call follows a write of ``FLUSH_BYTES`` and a
read of as many from a second buffer, and the events bracket the call
alone.
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


# clock cycles the card sleeps while the host queues work (~25 ms at the
# H100's 1.98 GHz), longer than the host takes to queue a timing's calls
HOLD_CYCLES = 50_000_000


def device_ms(fn, x, applies: int = 50, repeats: int = 3) -> float:
    """Median over ``repeats`` of the card's milliseconds per ``fn(x)``,
    ``applies`` applies queued behind a sleep kernel (CUDA tensors)."""
    fn(x)
    samples = []
    for _ in range(repeats):
        torch.cuda.synchronize(x.device)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(HOLD_CYCLES)
        t0.record()
        for _ in range(applies):
            fn(x)
        t1.record()
        t1.synchronize()
        samples.append(t0.elapsed_time(t1) / applies)
    return float(statistics.median(samples))


def host_us(fn, calls: int = 100, repeats: int = 5) -> float:
    """Median over ``repeats`` of the host microseconds per ``fn()`` over
    ``calls`` calls in a row; with a card, each run queues behind a sleep
    kernel, so no launch waits for the card."""
    cuda = torch.cuda.is_available()
    fn()
    runs = []
    for _ in range(repeats):
        if cuda:
            torch.cuda.synchronize()
            torch.cuda._sleep(HOLD_CYCLES)
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        runs.append((time.perf_counter() - t0) / calls * 1e6)
    if cuda:
        torch.cuda.synchronize()
    return float(statistics.median(runs))


# bytes a flush writes and then reads: over twice the H100's 50 MB L2
FLUSH_BYTES = 256 << 20


def cold_ms(fn, device, repeats: int = 5,
            flush_bytes: int = FLUSH_BYTES) -> float:
    """Median over ``repeats`` of the milliseconds of one ``fn()`` with
    the L2 emptied of its operands first: a write of ``flush_bytes``, then
    a read of as many from a second buffer, so that the L2 holds clean
    lines of the flush alone and none is written back while ``fn`` runs.
    CUDA events bracket ``fn`` alone; on the CPU the host clock times it,
    with no flush."""
    fn()
    cuda = torch.device(device).type == "cuda"
    if cuda:
        n = flush_bytes // 4
        dirty = torch.empty(n, device=device)
        clean = torch.ones(n, device=device)
    samples = []
    for _ in range(repeats):
        if not cuda:
            h0 = time.perf_counter()
            fn()
            samples.append((time.perf_counter() - h0) * 1e3)
            continue
        dirty.fill_(0.0)
        clean.sum()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        samples.append(t0.elapsed_time(t1))
    return float(statistics.median(samples))
