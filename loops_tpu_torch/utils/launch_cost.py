"""Host microseconds per call of each part of a kernel's launch path.

    python -m loops_tpu_torch.utils.launch_cost [--calls 100]

At small sizes a kernel apply costs its host launch path, not its device
time (K12 on [8, 8192]; K1 on the 32768^2 bench matrix). This module takes
that path apart: each part is timed alone by the host clock over ``calls``
calls in a row (``utils/bench.host_us``, queued behind a sleep kernel so
that the card never holds the host back), less the cost of an empty
call. The parts are the operations the
wrappers run now:

* ``SpMVOperator.__call__``: ``stage(x)`` of a staged ``x`` and the
  launch-counter bookkeeping;
* K1's bound function: the test that its buffers are those checked and
  packed at bind (identity, version counters, addresses), and its
  ``SortedLaunch``: the check of ``x``, the ``torch.empty`` of y, the
  lookup of the current stream's scratch;
* the launch (``_build.call``): ``current_device()``, the raw stream
  query, the two tensor arguments as plain ints and the C call itself,
  one kernel on the packed plan (four pointers and the stream), through
  the launch binding (``_build._FNS``) and, for comparison only, through
  a ctypes handle this module opens on the same library with the
  entry point's ``_SIGNATURES`` as argtypes (the launch path before the
  binding);
* the program's span (``utils/trace.annotate``, as ``op(x)`` opens
  ``spmv``) with no profiler collecting: its enter and exit;
* K12: its one-pass check, the output's allocation three ways
  (``torch.empty_like``, ``torch.empty(shape, ...)``, ``x.new_empty``),
  the grid, its C call (binding and ctypes) and, in
  ``saxpy()``, the device asked once and the test that the operands are
  staged (beside ``ensure_platform``, which it asked on every call
  before).

The whole calls (``op(x)``, ``saxpy_cuda``, ``saxpy``, ``torch.add``) are
timed the same way beside the parts, and ``op(x)`` and ``saxpy_cuda`` once
more with their C call through the ctypes handle, so the binding's gain
shows end to end. Each round times every part and call once, in turn, and
a label's figure is its median over ``repeats`` rounds: the host's pace,
which drifts within a run, weighs on every label alike. Needs an NVIDIA
card.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import statistics

import torch

from loops_tpu_torch.ops.kernels import _build, saxpy, spmv_sorted
from loops_tpu_torch.utils import generate
from loops_tpu_torch.utils.bench import host_us
from loops_tpu_torch.utils.platform import ensure_platform
from loops_tpu_torch.utils.trace import annotate


def ctypes_handle(name: str):
    """The C entry point ``name`` of the loaded kernels' library through
    ctypes, argtypes from ``_build._SIGNATURES``: for comparison with the
    launch binding only; no launch of the port goes through it."""
    _build.load_library()
    fn = getattr(ctypes.CDLL(_build.BUILD_INFO["path"]), name)
    fn.argtypes, fn.restype = _build._SIGNATURES[name], ctypes.c_int
    return fn


@contextlib.contextmanager
def _swapped(holder, key, value):
    """``holder[key]`` (a dict) or ``holder.key`` set to ``value`` inside
    the block."""
    get, put = ((holder.__getitem__, holder.__setitem__)
                if isinstance(holder, dict) else
                (lambda k: getattr(holder, k),
                 lambda k, v: setattr(holder, k, v)))
    before = get(key)
    put(key, value)
    try:
        yield
    finally:
        put(key, before)


def launch_path_parts(device, calls: int = 100, repeats: int = 5) -> dict:
    """``{"parts": {label: us}, "calls": {label: us}, "empty_us": us}``:
    each part's and each whole call's host microseconds per call, less
    ``empty_us``, the cost of calling an empty function."""
    from loops_tpu_torch.ops.spmv import SpMVOperator

    if device.index is None:  # as a tensor's device reads
        device = torch.device(device.type, torch.cuda.current_device())
    csr = generate.random_csr(4096, 4096, 16 / 4096, seed=3)
    op = SpMVOperator(csr, "sorted_flat", device=device)
    b, params, k1 = op._bufs, op._raw.params, op._raw.launch
    xd = torch.from_numpy(generate.make_input_vector(csr.shape[1])).to(device)
    rows = params["rows"]
    y = torch.empty(rows, device=device)
    k1_name = "loops_sorted_spmv_f32"
    k1_fn = _build._function(k1_name)
    k1_ct = ctypes_handle(k1_name)
    idx = device.index
    stream = _build._raw_stream(idx)
    k1(xd)  # the current stream's scratch, the resolved k1.fn
    scratch = k1.scratch[stream][1]
    staged = tuple(b.values())
    fingerprint = spmv_sorted.staged_fingerprint(b)
    sx, sy = (torch.randn(8, 8192, device=device) for _ in range(2))
    sout = torch.empty_like(sx)
    sax_fn = _build._function(saxpy.ENTRY)
    sax_ct = ctypes_handle(saxpy.ENTRY)
    sax_blocks = saxpy.grid(sx.numel())
    f32 = torch.float32
    shape = sx.shape
    counter = {"n": 0}

    def bookkeeping():
        before = _build.LAUNCHES["sorted_spmv"]
        counter["n"] += _build.LAUNCHES["sorted_spmv"] - before

    def one_span():
        with annotate("spmv"):
            pass

    def saxpy_checks():
        if not sx.is_cuda:
            raise AssertionError
        index = sx.get_device()
        if not (sx.dtype is f32 and sy.dtype is f32 and sy.is_cuda
                and sy.get_device() == index and sx.is_contiguous()
                and sy.is_contiguous() and sy.shape == sx.shape):
            raise AssertionError

    parts = {
        "SpMVOperator.stage(x), x staged": lambda: op.stage(xd),
        "SpMVOperator counter bookkeeping": bookkeeping,
        "K1 staged buffers unchanged (identity, versions, addresses)":
            lambda: spmv_sorted.staged_unchanged(b, staged, fingerprint),
        "annotate, no profiler: one span (enter, exit)": one_span,
        "K1 check of x": lambda: _build.check(xd, "x", f32, device,
                                              params["cols_n"]),
        "K1 torch.empty(rows) (y)": lambda: torch.empty(rows, device=device),
        "K1 the stream's scratch (dict lookup)":
            lambda: k1.scratch.get(stream),
        "launch: torch.cuda.current_device()": torch.cuda.current_device,
        "launch: raw stream query": lambda: _build._raw_stream(idx),
        "launch: plain int arguments (K1: x, y)": lambda: (
            k1.plan_ptr, xd.data_ptr(), y.data_ptr(), scratch),
        "launch: C call, K1 (one kernel, packed plan)":
            lambda: k1_fn(k1.plan_ptr, xd.data_ptr(), y.data_ptr(), scratch,
                          stream),
        "launch: C call, K1, through ctypes (comparison only)":
            lambda: k1_ct(k1.plan_ptr, xd.data_ptr(), y.data_ptr(), scratch,
                          stream),
        "K12 one-pass check of x and y": saxpy_checks,
        "K12 torch.empty_like (out)": lambda: torch.empty_like(sx),
        "K12 torch.empty(shape, ...) (out)":
            lambda: torch.empty(shape, dtype=f32, device=device),
        "K12 x.new_empty(shape) (out)": lambda: sx.new_empty(shape),
        "K12 the grid": lambda: saxpy.grid(sx.numel()),
        "launch: C call, K12": lambda: sax_fn(2.5, sx.data_ptr(),
                                              sy.data_ptr(),
                                              sout.data_ptr(), sx.numel(),
                                              sax_blocks, stream),
        "launch: C call, K12, through ctypes (comparison only)":
            lambda: sax_ct(2.5, sx.data_ptr(), sy.data_ptr(),
                           sout.data_ptr(), sx.numel(), sax_blocks, stream),
        "K12 saxpy(): the device asked once, operands staged":
            lambda: saxpy._staged(sx, sy, saxpy._device("cuda")),
        "ensure_platform('cuda') (saxpy() before)":
            lambda: ensure_platform("cuda"),
    }
    whole = {
        "K1 apply, SpMVOperator op(x)": lambda: op(xd),
        "K1 apply, op(x), its C call through ctypes (comparison only)":
            (lambda: op(xd), lambda: _swapped(k1, "fn", k1_ct)),
        "K1 wrapper through the bound function": lambda: op._raw(b, xd),
        "K1 SortedLaunch alone": lambda: k1(xd),
        "K12 saxpy_cuda": lambda: saxpy.saxpy_cuda(2.5, sx, sy),
        "K12 saxpy_cuda, its C call through ctypes (comparison only)":
            (lambda: saxpy.saxpy_cuda(2.5, sx, sy),
             lambda: _swapped(_build._FNS, saxpy.ENTRY, sax_ct)),
        "K12 saxpy(..., device)": lambda: saxpy.saxpy(2.5, sx, sy, device),
        "torch.add(y, x, alpha=2.5)": lambda: torch.add(sy, sx, alpha=2.5),
    }
    runs = [("empty", None, lambda: None, contextlib.nullcontext)]
    for key, group in (("parts", parts), ("calls", whole)):
        for label, fn in group.items():
            fn, swap = fn if isinstance(fn, tuple) else (
                fn, contextlib.nullcontext)
            runs.append((key, label, fn, swap))
    samples = {(key, label): [] for key, label, _, _ in runs}
    for _ in range(repeats):
        for key, label, fn, swap in runs:
            with swap():
                samples[key, label].append(host_us(fn, calls, 1))
    empty = statistics.median(samples.pop(("empty", None)))
    res = {"empty_us": empty, "parts": {}, "calls": {}}
    for (key, label), us in samples.items():
        res[key][label] = max(0.0, statistics.median(us) - empty)
    torch.cuda.synchronize(device)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--calls", type=int, default=100)
    args = ap.parse_args(argv)
    device = ensure_platform("cuda")
    res = launch_path_parts(device, args.calls)
    for key in ("parts", "calls"):
        for label, us in res[key].items():
            print(f"{label}: {us:.2f} us")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
