"""Tracing and profiling helpers — the port of ``loops_tpu/utils/trace.py``.

* ``profile(logdir)``: a context that writes two files into ``logdir``:
  ``trace.json``, a Chrome trace from ``torch.profiler`` (CPU, and CUDA
  activity on a card) holding the ``annotate`` ranges inside one
  ``trace.window`` range; and ``kernels.json``, the port's own record of
  every kernel launched in the window, which does not depend on that
  trace's kernel list (on the card the profiler has dropped launches:
  ``utils/profile_spmv.trace_gaps``). While the window is open,
  ``_build.launch`` brackets each kernel with a CUDA event pair on its
  stream, inside a ``launch.<counter>`` range; the record lists each
  launch with its counter, its device ms and the ``annotate`` path it
  fell in, and what the kernels counted on the card in the window
  (``_build.window_counter``: K1's ``k1.gathers_ready_share`` and
  ``k1.gather_depth``). On leaving, the record is held against
  ``_build.LAUNCHES``: a
  counter whose launches the record lacks raises, and nothing is written
  as if whole. The record file also says whether the profiler's own
  kernel list held every launch of the same window, and holds the
  ``spans`` table (``span_table``): what each ``annotate`` path cost on
  the host and on the card, and each idle gap of the card as host wait
  or queued time.
* ``annotate(name)``: a named span, as a decorator or a context. While a
  profiler collects (a ``profile`` window, or any ``torch.profiler``
  session) it is a ``torch.profiler.record_function`` range and its name
  joins the path the record gives each launch; otherwise it costs one
  test of the profiler's flag.
* ``csv_row``: the examples' CSV line, ``kernel,dataset,rows,cols,nnzs,
  elapsed``.
"""
from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
import time

import torch
from torch.autograd import profiler as _autograd_profiler

TRACE_FILE = "trace.json"
KERNELS_FILE = "kernels.json"
# the range around a profile window's body, on the profiler's clock
WINDOW = "trace.window"
# kernels run, each followed by a sync and a pause of PRIME_S, between the
# profiler's start and the window
PRIME_KERNELS = 4
PRIME_S = 0.003
# the range around each launch of the port's kernels in a profile window
LAUNCH_PREFIX = "launch."
# the device's operations, and the host's calls into the CUDA runtime and
# driver, in a Chrome trace from torch.profiler
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
CALL_CATS = ("cuda_runtime", "cuda_driver")
# the event class the launches are timed with (torch.cuda.Event when
# None); a stand-in may take its place where no card is present
EVENT = None
# the open annotate ranges, outermost first, shared by every thread:
# autograd runs the backward's spans on its own device thread while the
# main thread waits inside its span
_RANGES: list = []
# the names annotate opened while a profiler collected: the record takes
# these ranges of the trace as the program's spans
_NAMES: set = set()


def _default_logdir() -> str:
    return os.path.join(tempfile.gettempdir(), "loops_tpu_torch_trace")


def annotate(name: str):
    """Named span (decorator/context). Made while a profiler collects, it
    is a ``record_function`` range and a step of the kernel record's
    path; otherwise it is the name's shared span that does nothing. Each
    ``with annotate(...)`` and each call of a decorated function decides
    anew."""
    if _autograd_profiler._is_profiler_enabled:
        return _Span(name)
    quiet = _QUIET.get(name)
    if quiet is None:
        quiet = _QUIET[name] = _Quiet(name)
    return quiet


class _Span(contextlib.ContextDecorator):
    """A span while a profiler collects."""

    def __init__(self, name: str):
        self.name = name
        self._rf = None

    def _recreate_cm(self):  # each decorated call its own range
        return annotate(self.name)

    def __enter__(self):
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        _RANGES.append(self.name)
        _NAMES.add(self.name)
        return self

    def __exit__(self, *exc):
        _RANGES.pop()
        self._rf.__exit__(*exc)
        return False


class _Quiet(contextlib.ContextDecorator):
    """A span while no profiler collects: no state, so one a name serves
    every thread and every depth."""

    def __init__(self, name: str):
        self.name = name

    def _recreate_cm(self):
        return annotate(self.name)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


# name -> its _Quiet span
_QUIET: dict = {}


class _Recorder:
    """``_build.RECORDER`` while a profile is open: launches a kernel
    between two events recorded on the current stream (the stream
    ``_build.launch`` passes it), inside a ``launch.<counter>`` range,
    and keeps (counter, path, start, end) of each launch that returned
    no error."""

    def __init__(self, event, build):
        self.event, self.build = event, build
        self.launches = []

    def __call__(self, counter, fn, c_args, index):
        with torch.profiler.record_function(LAUNCH_PREFIX + counter):
            start = self.event(enable_timing=True)
            end = self.event(enable_timing=True)
            start.record()
            err = fn(*c_args, self.build._raw_stream(index))
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


def _innermost(spans, times) -> list:
    """For each of ``times``, the index in ``spans`` (``(start, end,
    ...)``, nested in time) of the innermost span open at it, or -1: one
    sweep, a span open at both its ends."""
    marks = [(a, 0, -b, i) for i, (a, b, *_) in enumerate(spans)]
    marks += [(b, 2, 0, i) for i, (_, b, *_) in enumerate(spans)]
    marks += [(t, 1, 0, j) for j, t in enumerate(times)]
    marks.sort()
    open_, out = [], [-1] * len(times)
    for _, kind, _, i in marks:
        if kind == 0:
            open_.append(i)
        elif kind == 2:
            open_.remove(i)
        else:
            out[i] = open_[-1] if open_ else -1
    return out


def _covered(intervals) -> float:
    """The length of the union of ``(start, end)`` intervals."""
    total, cur = 0.0, None
    for a, b in sorted(intervals):
        if cur is None or a > cur[1]:
            if cur is not None:
                total += cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    return total + (cur[1] - cur[0] if cur is not None else 0.0)


def _empty_row() -> dict:
    return {"calls": 0, "host_ms": 0.0, "self_ms": 0.0, "device_ms": 0.0,
            "launches": 0, "host_wait_ms": 0.0}


def span_table(events, names, launches, whole: bool) -> dict:
    """The record's spans from a Chrome trace's ``events`` (one clock for
    the host's ranges and the device's operations): ``names`` are the
    program's span names, ``launches`` the record's launch list, and
    ``whole`` whether the profiler's kernel list held every launch.

    Spans nest by time, whatever their thread: autograd's thread opens
    its spans inside the main thread's. Each path (``train.backward/
    spmm``) has its ``calls``, ``host_ms`` and ``self_ms`` (less what its
    child spans cover), and, with its children's, ``device_ms``,
    ``launches`` and ``host_wait_ms``. ``device_ms``: each device
    operation by its ``correlation`` id to its launch call, then to the
    innermost span open at that call, whatever its thread. The port's
    kernels are those launched inside a ``launch.<counter>`` range, the
    k-th range the record's k-th launch: one the trace dropped counts
    its event pair's ms under the record's path, once. (An event pair
    also times the host's launch where the card waits for it, so a
    kernel the trace holds counts the trace's duration.) ``launches``:
    the runtime and driver launch calls under the path.

    The gap rule: each gap in the union of the device's operations inside
    the ``trace.window`` range is host wait, put down to the innermost
    span open at the launch call of the operation that ends it (or to
    ``outside``), where that call had not returned when the gap opened;
    else it is queued time between operations already enqueued. A
    trailing gap is host wait under the span open at its start. Without
    a ``whole`` kernel list, where a launch of the port's has no kernel in
    the trace, or where an operation that ends a gap has no launch call
    in it, the gap fields are None. (On an H100 every device operation of
    the benchmark's windows had its launch call; an operation without one
    would count as ``outside``.)
    """
    window = next((e for e in events if e.get("name") == WINDOW
                   and e.get("cat") == "user_annotation"), None)
    if window is None:
        raise RuntimeError(f"the trace has no {WINDOW} range")
    w0 = float(window["ts"])
    w1 = w0 + float(window["dur"])
    spans, guards, calls, ops = [], [], {}, []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a = float(e["ts"])
        b = a + float(e["dur"])
        cat, name = e.get("cat"), e.get("name", "")
        if cat == "user_annotation":
            if name in names:
                spans.append((a, b, name))
            elif name.startswith(LAUNCH_PREFIX):
                guards.append((a, b))
        elif cat in CALL_CATS:
            c = e.get("args", {}).get("correlation")
            calls[c] = (a, b, "Launch" in name)
        elif cat in DEVICE_CATS:
            a, b = max(a, w0), min(b, w1)
            if b > a:
                ops.append((a, b, e.get("args", {}).get("correlation")))
    spans.sort(key=lambda s: (s[0], -s[1]))
    guards.sort()
    guard_starts = [a for a, _ in guards]

    # each span's path, and the spans that are its direct children
    paths, kids, stack = [], [[] for _ in spans], []
    for i, (a, b, name) in enumerate(spans):
        while stack and spans[stack[-1]][1] < b:
            stack.pop()
        parent = stack[-1] if stack else -1
        paths.append(name if parent < 0 else paths[parent] + "/" + name)
        if parent >= 0:
            kids[parent].append((a, b))
        stack.append(i)

    table: dict = {}
    outside = {"device_ms": 0.0, "launches": 0, "host_wait_ms": 0.0}

    def row(i):
        if i < 0:
            return outside
        return table.setdefault(paths[i], _empty_row())

    for i, (a, b, _) in enumerate(spans):
        r = row(i)
        r["calls"] += 1
        r["host_ms"] += (b - a) * 1e-3
        r["self_ms"] += (b - a - _covered(kids[i])) * 1e-3

    def guard(t) -> int:
        """The launch range open at ``t``, or -1."""
        k = bisect.bisect_right(guard_starts, t) - 1
        return k if k >= 0 and t <= guards[k][1] else -1

    launch_calls = [a for a, _, is_launch in calls.values() if is_launch]
    for i in _innermost(spans, launch_calls):
        row(i)["launches"] += 1
    timed, seen = [], set()
    for a, b, c in ops:
        if c not in calls:  # no launch call in the trace: outside
            outside["device_ms"] += (b - a) * 1e-3
            continue
        timed.append((b - a, calls[c][0]))
        seen.add(guard(calls[c][0]))
    for (us, _), i in zip(timed, _innermost(spans, [t for _, t in timed])):
        row(i)["device_ms"] += us * 1e-3
    # a launch of the port's that the trace dropped: its event pair (the
    # k-th launch range is the record's k-th launch)
    dropped = 0
    if len(guards) == len(launches):
        for k, x in enumerate(launches):
            if k not in seen:
                dropped += 1
                r = (table.setdefault(x["range"], _empty_row())
                     if x["range"] else outside)
                r["device_ms"] += x["device_ms"]

    # the gaps of the device's operations, each with what ended it
    ops.sort(key=lambda o: (o[0], calls[o[2]][1] if o[2] in calls else 0))
    busy, gaps, end = 0.0, [], w0
    for a, b, c in ops:
        if a > end:
            gaps.append((end, a, c))
        if b > end:
            busy += b - max(a, end)
            end = b
    gap_fields = whole and not dropped
    host_wait = queued = 0.0
    waits = []  # (gap us, time whose innermost span the wait goes to)
    for a, b, c in gaps:
        if c not in calls:
            gap_fields = False
            continue
        call_start, call_end, _ = calls[c]
        if call_end > a:
            waits.append((b - a, call_start))
        else:
            queued += b - a
    if w1 > end:
        waits.append((w1 - end, end))
    for (us, _), i in zip(waits, _innermost(spans, [t for _, t in waits])):
        row(i)["host_wait_ms"] += us * 1e-3
        host_wait += us

    # each path with its children's device ms, launches and host wait
    own = {p: dict(r) for p, r in table.items()}
    for p, r in own.items():
        parts = p.split("/")
        for k in range(1, len(parts)):
            anc = table.setdefault("/".join(parts[:k]), _empty_row())
            for key in ("device_ms", "launches", "host_wait_ms"):
                anc[key] += r[key]
    if not gap_fields:
        for r in table.values():
            r["host_wait_ms"] = None
        outside["host_wait_ms"] = None
    return {
        "spans": dict(sorted(table.items())),
        "outside": outside,
        "window_ms": (w1 - w0) * 1e-3,
        "busy_ms": busy * 1e-3,
        "idle_ms": (w1 - w0 - busy) * 1e-3 if gap_fields else None,
        "host_wait_ms": host_wait * 1e-3 if gap_fields else None,
        "queued_ms": queued * 1e-3 if gap_fields else None,
    }


@contextlib.contextmanager
def profile(logdir: str | None = None):
    """Capture a ``torch.profiler`` trace and the port's own kernel
    record into ``logdir`` (a directory under the temporary directory by
    default); yields ``logdir``. Raises ``RuntimeError`` on leaving when
    the record lacks a launch that ``_build.LAUNCHES`` counted."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    # imported here: the operators import this module for annotate
    from loops_tpu_torch.ops.kernels import _build
    from loops_tpu_torch.utils.profile_spmv import trace_gaps

    logdir = logdir or _default_logdir()
    os.makedirs(logdir, exist_ok=True)
    if _build.RECORDER is not None:
        raise RuntimeError("a trace.profile window is already open")
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    rec = _Recorder(EVENT or torch.cuda.Event, _build)
    before = dict(_build.LAUNCHES)
    _NAMES.clear()
    with torch_profile(activities=activities) as prof:
        if cuda:
            # the profiler has lost the device records of the first one or
            # two kernels of its session, even 11 ms in (an H100, torch
            # 2.11): kernels waited for here, outside the window, take
            # their place
            for _ in range(PRIME_KERNELS):
                torch.zeros(1, device="cuda")
                torch.cuda.synchronize()
                time.sleep(PRIME_S)
        for counter in _build.WINDOW_COUNTERS:
            counter.start()
        t0 = time.perf_counter()
        _build.RECORDER = rec
        try:
            with torch.profiler.record_function(WINDOW):
                try:
                    yield logdir
                finally:
                    if cuda:
                        torch.cuda.synchronize()
        finally:
            _build.RECORDER = None
        wall_ms = (time.perf_counter() - t0) * 1e3
    path = os.path.join(logdir, TRACE_FILE)
    prof.export_chrome_trace(path)
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
    for counter in _build.WINDOW_COUNTERS:
        record.update(counter.read())
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    record.update(span_table(events, set(_NAMES), launches, not gaps))
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
