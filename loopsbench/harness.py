"""One run of one cell: set-up, the measured window, the traced window,
the check against the plain reference, and the result line.

A driver (``loopsbench/drivers/<name>.py``) gives four functions:

* ``setup(run, cell, seed, device) -> state``: makes the inputs from the
  seed, builds the program's objects, drives its first units (the ones
  the check compares) and warms up every shape the window uses; sets
  ``run.plan_s`` and the work of one unit (``run.unit_work``,
  ``run.unit_flops``, ``run.unit_bound_s``);
* ``unit(run, state) -> bool``: one closed-loop unit (an epoch, a solve)
  ending in a host read; False where its answer is not finite;
* ``check(run, state) -> {name: value}``: frees the program's state, runs
  the reference, and gives each number it can compare; those the traffic
  file's ``limits`` name are compared, each with its limit;
* ``control(cell, seed, device) -> {name: value}``: the reference in a
  lower precision in the program's place (``loopsbench/calibrate.py``).

Host spans (``run.span``) time each part of a unit; in the traced window
they are also ``torch.profiler`` ranges, by which the idle gaps of the
device are labelled.
"""
from __future__ import annotations

import contextlib
import gc
import hashlib
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from collections import defaultdict

import torch

# whole top-level module names that no run may hold once its window closed
BANNED_MODULES = ("jax", "jaxlib", "flax", "loops_tpu")
# the range around the traced window, and the device's activity in a trace
WINDOW_RANGE = "loopsbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


def sub_seed(seed: int, tag: str) -> int:
    """A seed for one stream of draws of a run (``seed`` may be any whole
    number): 63 bits of a hash of both."""
    h = hashlib.sha256(f"{seed}:{tag}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Run:
    """What a run measured, for the metric readers."""

    def __init__(self, cell, device):
        self.cell, self.device = cell, torch.device(device)
        self.setup_s = None
        self.plan_s = None
        self.units = []             # host seconds of each unit of the window
        self.window_s = None
        self.spans = defaultdict(list)  # name -> host seconds, window only
        self.unit_work = {}         # kernel counter -> [Work of each launch]
        self.unit_flops = None      # flops of one unit
        self.unit_bound_s = None    # the least time for one unit's work
        self.trace = None           # the traced window (read_trace)
        self.setup_parts = {}       # set-up phase -> host seconds
        self.attempted = 0
        self.failed = 0
        self._timing = False
        self._ranges = False

    @contextlib.contextmanager
    def phase(self, name: str):
        """Time a part of set-up (printed on standard error)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            sync(self.device)
            self.setup_parts[name] = time.perf_counter() - t0

    @contextlib.contextmanager
    def span(self, name: str):
        rf = None
        if self._ranges:
            rf = torch.profiler.record_function(name)
            rf.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self._timing:
                self.spans[name].append(time.perf_counter() - t0)
            if rf is not None:
                rf.__exit__(None, None, None)

    def window(self, unit, seconds: float) -> None:
        """Units back to back until ``seconds`` have passed; the window
        ends with the last unit's host read."""
        self._timing = True
        start = time.perf_counter()
        end = t = start
        while t - start < seconds:
            ok = unit()
            t = time.perf_counter()
            self.units.append(t - end)
            end = t
            self.attempted += 1
            self.failed += not ok
        self.window_s = end - start
        self._timing = False

    def traced(self, unit, count: int, logdir: str) -> None:
        """``count`` units under ``trace.profile`` (the program's kernel
        record and a ``torch.profiler`` trace), then read the trace."""
        from loops_tpu_torch.utils import trace

        self._ranges = True
        try:
            with trace.profile(logdir):
                with torch.profiler.record_function(WINDOW_RANGE):
                    for _ in range(count):
                        ok = unit()
                        self.attempted += 1
                        self.failed += not ok
                sync(self.device)
        finally:
            self._ranges = False
        self.trace = read_trace(logdir, count)


def _union(intervals):
    """Total length of the union of ``(start, end)`` intervals, and the
    gaps between them as ``(start, end)``."""
    total, gaps, cur = 0.0, [], None
    for a, b in sorted(intervals):
        if cur is None:
            cur = [a, b]
        elif a > cur[1]:
            total += cur[1] - cur[0]
            gaps.append((cur[1], a))
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    if cur is not None:
        total += cur[1] - cur[0]
    return total, gaps


def read_trace(logdir: str, units: int) -> dict:
    """The traced window: the program's kernel record, the device's busy
    seconds (the union of its operations in the profiler's timeline) over
    the window, the operations that took most time, and the idle gaps by
    the host span that was open in their middle."""
    from loops_tpu_torch.utils import trace

    record = trace.read_record(logdir)
    with open(os.path.join(logdir, trace.TRACE_FILE)) as f:
        events = json.load(f).get("traceEvents", [])
    window = next((e for e in events if e.get("name") == WINDOW_RANGE
                   and e.get("cat") == "user_annotation"), None)
    if window is None:
        raise RuntimeError("the trace has no window range")
    w0 = float(window["ts"])
    w1 = w0 + float(window["dur"])
    ops, busy, spans = defaultdict(float), [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a = float(e["ts"])
        b = a + float(e["dur"])
        if e.get("cat") in DEVICE_CATS:
            a, b = max(a, w0), min(b, w1)
            if b > a:
                busy.append((a, b))
                ops[e["name"][:120]] += (b - a) * 1e-6
        elif (e.get("cat") == "user_annotation"
              and e.get("name") != WINDOW_RANGE):
            spans.append((a, b, e["name"]))
    busy_us, gaps = _union(busy)
    if busy:
        first, last = min(a for a, _ in busy), max(b for _, b in busy)
        gaps = [(w0, first)] + gaps + [(last, w1)]
    else:
        gaps = [(w0, w1)]
    idle = defaultdict(float)
    for a, b in gaps:
        mid = (a + b) / 2
        open_ = [s for s in spans if s[0] <= mid <= s[1]]
        # the innermost span open in the gap's middle, else none
        name = (min(open_, key=lambda s: s[1] - s[0])[2] if open_
                else "outside any span")
        idle[name] += (b - a) * 1e-6
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:TOP]
    gaps_top = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
    return dict(record=record, units=units, window_s=(w1 - w0) * 1e-6,
                busy_s=busy_us * 1e-6, device_ops=[list(x) for x in top],
                idle_gaps=[list(x) for x in gaps_top])


def banned_modules(names=None) -> list:
    """The banned top-level names among ``names`` (``sys.modules``),
    compared whole: ``loops_tpu_torch`` is not ``loops_tpu``."""
    held = {name.split(".")[0] for name in list(names or sys.modules)}
    return sorted(held.intersection(BANNED_MODULES))


def power_limit_w():
    """The card's power limit from ``nvidia-smi``, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20, check=True).stdout.split()
        return float(out[0]) if out else None
    except (OSError, subprocess.SubprocessError, ValueError):
        return None


def execute(cell, seed: int, seconds: float, traced: bool, device,
            t0: float) -> tuple[dict, dict]:
    """One run; returns the result line's object, whose last key is
    ``checks`` (``{name: {"value", "limit"}}``), and every number the
    check read, compared or not."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    driver = cell.driver
    run = Run(cell, device)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    run.setup_parts["start"] = time.perf_counter() - t0
    state = driver.setup(run, cell, seed, device)
    sync(device)
    run.setup_s = time.perf_counter() - t0
    print("setup_s parts: " + ", ".join(
        f"{k} {v:.3f}" for k, v in run.setup_parts.items()), file=sys.stderr)
    run.window(lambda: driver.unit(run, state), seconds)
    if traced:
        logdir = tempfile.mkdtemp(prefix="loopsbench_trace_")
        try:
            run.traced(lambda: driver.unit(run, state),
                       int(cell.traffic["trace_units"]), logdir)
        finally:
            shutil.rmtree(logdir, ignore_errors=True)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    readings = driver.check(run, state)
    del state
    gc.collect()
    limits = cell.traffic["limits"]
    checks = {k: (readings.get(k, math.inf), float(lim))
              for k, lim in limits.items()}
    correct = run.failed == 0 and all(
        math.isfinite(v) and v <= lim for v, lim in checks.values())
    from loopsbench import spec

    metrics = {}
    for m in cell.per_layer if traced else cell.end_to_end:
        value = spec.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell.chips if cuda else 1,
           "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics, "device": dev}
    for k, v in readings.items():
        if k not in limits:
            print(f"reading {k} {v!r}", file=sys.stderr)
    if traced:
        dev["busy_s"] = run.trace["busy_s"]
        dev["window_s"] = run.trace["window_s"]
        out["breakdown"] = {"device_ops": run.trace["device_ops"],
                            "idle_gaps": run.trace["idle_gaps"]}
        if not run.trace["record"].get("profiler_list_whole", True):
            print("profiler_list_whole: false "
                  f"{run.trace['record'].get('profiler_gaps')}",
                  file=sys.stderr)
        if cuda:
            out["power_limit_w"] = power_limit_w()
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in checks.items()}
    return out, readings
