"""Device timing (reference: util/timer.hxx:19-52).

Like the reference, a CUDA run is timed with device events recorded on
the current stream; a CPU run (no events) with the host clock around a
finished computation.
"""
from __future__ import annotations

import time

import torch

from loops_tpu_torch.utils.platform import ensure_platform


class Timer:
    """Start/stop timer: CUDA events for ``device.type == 'cuda'``, the
    host clock otherwise."""

    def __init__(self, device="cuda"):
        self.cuda = ensure_platform(device).type == "cuda"
        self._t0 = None
        self.milliseconds = 0.0

    def start(self):
        if self.cuda:
            self._t0 = torch.cuda.Event(enable_timing=True)
            self._t0.record()
        else:
            self._t0 = time.perf_counter()
        return self

    def stop(self):
        if self.cuda:
            t1 = torch.cuda.Event(enable_timing=True)
            t1.record()
            t1.synchronize()
            self.milliseconds = self._t0.elapsed_time(t1)
        else:
            self.milliseconds = (time.perf_counter() - self._t0) * 1e3
        return self.milliseconds

    @property
    def seconds(self):
        return self.milliseconds / 1e3


def time_fn(fn, *args, device="cuda", warmup: int = 1, iters: int = 10,
            reduction=min) -> float:
    """Milliseconds per call of ``fn(*args)``: ``warmup`` untimed calls,
    then ``reduction`` (default min) over ``iters`` timed calls."""
    t = Timer(device)
    for _ in range(max(warmup, 1)):
        fn(*args)
    times = []
    for _ in range(iters):
        t.start()
        fn(*args)
        times.append(t.stop())
    return float(reduction(times))
