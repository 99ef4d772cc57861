"""Tracing and profiling helpers — the port of ``loops_tpu/utils/trace.py``.

* ``profile(logdir)``: a context that writes two files into ``logdir``:
  ``trace.json``, a Chrome trace from ``torch.profiler`` (CPU, and CUDA
  activity on a card) holding the ``annotate`` ranges; and
  ``kernels.json``, the port's own record of every kernel launched in the
  window, which does not depend on that trace's kernel list (on the card
  the profiler has dropped launches: ``utils/profile_spmv.trace_gaps``).
  While the window is open, ``_build.launch`` brackets each kernel with a
  CUDA event pair on its stream; the record lists each launch with its
  counter, its device ms and the ``annotate`` range it fell in. On
  leaving, the record is held against ``_build.LAUNCHES``: a counter whose
  launches the record lacks raises, and nothing is written as if whole.
  The record file also says whether the profiler's own kernel list held
  every launch of the same window.
* ``annotate(name)``: a named range in both, as a decorator or a context
  (``torch.profiler.record_function``, and an NVTX range on a card).
* ``csv_row``: the examples' CSV line, ``kernel,dataset,rows,cols,nnzs,
  elapsed``.
"""
from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time

import torch

from loops_tpu_torch.ops.kernels import _build
from loops_tpu_torch.utils.profile_spmv import trace_gaps

TRACE_FILE = "trace.json"
KERNELS_FILE = "kernels.json"
# the event class the launches are timed with (torch.cuda.Event when
# None); a stand-in may take its place where no card is present
EVENT = None
# the open annotate ranges, outermost first
_RANGES: list = []


def _default_logdir() -> str:
    return os.path.join(tempfile.gettempdir(), "loops_tpu_torch_trace")


class annotate(contextlib.ContextDecorator):
    """Named span visible in the profiler's trace, the kernel record and,
    on a card, NVTX (decorator/context)."""

    def __init__(self, name: str):
        self.name = name
        self._rf = None

    def _recreate_cm(self):  # each decorated call its own range
        return annotate(self.name)

    def __enter__(self):
        self._nvtx = torch.cuda.is_available()
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        _RANGES.append(self.name)
        if self._nvtx:
            torch.cuda.nvtx.range_push(self.name)
        return self

    def __exit__(self, *exc):
        if self._nvtx:
            torch.cuda.nvtx.range_pop()
        _RANGES.pop()
        self._rf.__exit__(*exc)
        return False


class _Recorder:
    """``_build.RECORDER`` while a profile is open: launches a kernel
    between two events recorded on the current stream (the stream
    ``_build.launch`` passes it) and keeps (counter, range, start, end)
    of each launch that returned no error."""

    def __init__(self, event):
        self.event = event
        self.launches = []

    def __call__(self, counter, fn, c_args, index):
        start = self.event(enable_timing=True)
        end = self.event(enable_timing=True)
        start.record()
        err = fn(*c_args, _build._raw_stream(index))
        end.record()
        if err == 0:
            self.launches.append((counter, "/".join(_RANGES), start, end))
        return err


def _profiler_kernels(prof) -> dict:
    """Kernel name -> times the profiler's trace recorded it."""
    from torch.autograd import DeviceType

    got = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            got[e.name] = got.get(e.name, 0) + 1
    return got


@contextlib.contextmanager
def profile(logdir: str | None = None):
    """Capture a ``torch.profiler`` trace and the port's own kernel
    record into ``logdir`` (a directory under the temporary directory by
    default); yields ``logdir``. Raises ``RuntimeError`` on leaving when
    the record lacks a launch that ``_build.LAUNCHES`` counted."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    logdir = logdir or _default_logdir()
    os.makedirs(logdir, exist_ok=True)
    if _build.RECORDER is not None:
        raise RuntimeError("a trace.profile window is already open")
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    rec = _Recorder(EVENT or torch.cuda.Event)
    before = dict(_build.LAUNCHES)
    with torch_profile(activities=activities) as prof:
        t0 = time.perf_counter()
        _build.RECORDER = rec
        try:
            yield logdir
        finally:
            _build.RECORDER = None
            if cuda:
                torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))
    counted = {k: n - before[k] for k, n in _build.LAUNCHES.items()
               if n != before[k]}
    recorded = {}
    for counter, *_ in rec.launches:
        recorded[counter] = recorded.get(counter, 0) + 1
    short = {k: (recorded.get(k, 0), n) for k, n in counted.items()
             if recorded.get(k, 0) != n}
    if short:
        raise RuntimeError(
            "trace.profile: the kernel record does not hold every counted "
            "launch: " + "; ".join(f"{k} {got} of {n}"
                                   for k, (got, n) in sorted(short.items())))
    launches = [{"counter": counter, "range": rng,
                 "device_ms": float(start.elapsed_time(end))}
                for counter, rng, start, end in rec.launches]
    gaps = trace_gaps(counted, _profiler_kernels(prof), 1) if counted else []
    record = {
        "wall_ms": wall_ms,
        "device_ms": sum(x["device_ms"] for x in launches),
        "counted": counted,
        "launches": launches,
        "profiler_list_whole": not gaps,
        "profiler_gaps": gaps,
    }
    with open(os.path.join(logdir, KERNELS_FILE), "w") as f:
        json.dump(record, f, indent=1)


def read_record(logdir: str) -> dict:
    """The kernel record a ``profile`` wrote into ``logdir``."""
    with open(os.path.join(logdir, KERNELS_FILE)) as f:
        return json.load(f)


def csv_row(kernel: str, dataset: str, rows: int, cols: int, nnz: int,
            elapsed_ms: float, **extra) -> str:
    """The sweep-log CSV contract (reference:
    examples/spmv/thread_mapped.cu:42-44)."""
    base = f"{kernel},{dataset},{rows},{cols},{nnz},{elapsed_ms:.5f}"
    if extra:
        base += "," + ",".join(str(v) for v in extra.values())
    return base
