"""K13: K2's segmented scan and its constructs, probed in isolation.

Ports ``scripts/tpu_mosaic_probe2.py`` (``scan_kernel``) and
``scripts/tpu_mosaic_probe.py`` (``run`` over ``k_reshape_s1`` ...
``k_dynbase``). On the TPU they held Mosaic's compiled kernels against
interpret mode; here each CUDA probe kernel (``csrc/probes.cu``) is held
against its plain PyTorch version on the scripts' own seeded inputs.

- ``seg_scan`` runs ``loops_scan::block_seg_scan`` (``csrc/seg_scan.cuh``),
  the scan K2 runs, over [GS=32, LANES=128] f32 with keep flags (keep == 0
  starts a segment), restarting at every SUB=4-row block in row-major
  order (the script's ``np_reference``). Held at the script's ``atol
  1e-4`` (the kernel adds in a shuffle tree, the plain version in order),
  and exactly on integer values.
- ``construct(name, ...)`` computes one of the eight constructs, each a
  case of ``construct_probe_kernel``. Data movement is exact; ``dot0``, a
  4-term f32 sum, is held at the script's ``atol 1e-5``.
- ``seg_scan_bind`` and ``construct_bind`` stage the inputs once and check
  them there (``_build.staged_guard``); their calls take ``out=``
  (``_build.output``), so a call is the launch and little else. The
  unbound ``seg_scan_cuda`` and ``construct_cuda`` check every call.

What bounds both is the launch: the inputs are a few KB. ``launch_floor``
measures it: ``launch_floor_kernel``, one CTA of 32 threads that writes
one word, timed on the card's clock (``probe_floor``).
"""
from __future__ import annotations

import numpy as np
import torch

from loops_tpu_torch.ops.kernels import _build
from loops_tpu_torch.probes.common import (
    hold,
    launch_ms,
    launch_twice,
    record,
)
from loops_tpu_torch.utils.bench import device_ms
from loops_tpu_torch.utils.platform import ensure_platform

# tpu_mosaic_probe.py:18-21, :52
S, SUB, LANES, GS, R = 128, 4, 128, 32, 512
HOT, Y_ROWS = 16, 16
SCAN_ATOL = 1e-4
CONSTRUCTS = ("reshape_s1", "out_reshape", "shift_sub", "shift_lane",
              "iota_mod", "lane_bcast", "dot0", "dynbase")
# the scripts' own labels (tpu_mosaic_probe.py:48-129)
LABELS = {
    "reshape_s1": "row-slice reshape (S,1) + one-hot",
    "out_reshape": "[1,R] -> [R/128,128] reshape",
    "shift_sub": "sublane shift pad+slice",
    "shift_lane": "lane shift pad+slice",
    "iota_mod": "broadcasted_iota %SUB gate",
    "lane_bcast": "last-lane broadcast",
    "dot0": "dot_general contract dim0 (SUBxLANES . SUBxS)",
    "dynbase": "dynamic-base accumulate",
}
ATOL = {"dot0": 1e-5}


# ------------------------------------------------------------------ scan
def scan_inputs(integer: bool = False):
    """``tpu_mosaic_probe2.py``'s inputs: ``default_rng(0)`` normal values
    [GS, LANES] and ``keep = random < 0.9`` (float32); ``integer`` rounds
    8x the values to integers, whose every f32 sum here is exact."""
    rng = np.random.default_rng(0)
    v0 = rng.normal(size=(GS, LANES)).astype(np.float32)
    keep0 = (rng.random((GS, LANES)) < 0.9).astype(np.float32)
    if integer:
        v0 = np.rint(v0 * 8).astype(np.float32)
    return v0, keep0


def _check_scan(v, keep, sub):
    if v.dim() != 2 or keep.shape != v.shape or v.shape[0] % sub:
        raise ValueError(f"seg_scan needs v and keep of one [rows, lanes] "
                         f"shape with rows % {sub} == 0, got "
                         f"{tuple(v.shape)} and {tuple(keep.shape)}")


def check_scan(b: dict, t: dict, device) -> None:
    """Raise ``ValueError`` unless ``b``'s ``v`` and ``keep`` are what the
    scan probe reads: contiguous float32 tensors of one [rows, lanes]
    shape on ``device``, rows a multiple of ``t["sub"]``."""
    _check_scan(b["v"], b["keep"], t["sub"])
    _build.check(b["v"], "v", torch.float32, device)
    _build.check(b["keep"], "keep", torch.float32, device, b["v"].numel())


def _launch_scan(b: dict, sub: int, dev, out=None) -> torch.Tensor:
    v = b["v"]
    o = _build.output(out, tuple(v.shape), dev)
    if v.numel():
        _build.launch("loops_seg_scan_probe", "seg_scan_probe", dev, v,
                      b["keep"], o, v.shape[0] // sub, sub * v.shape[1])
    return o


def seg_scan_cuda(v: torch.Tensor, keep: torch.Tensor, sub: int = SUB,
                  out=None) -> torch.Tensor:
    """Launch the scan probe, one CTA per block of ``sub`` rows, its
    inputs checked on this call; into ``out`` when given."""
    dev = v.device
    if dev.type != "cuda":
        raise ValueError(f"seg_scan_cuda needs a CUDA tensor, got {dev}")
    b = {"v": v, "keep": keep}
    check_scan(b, {"sub": sub}, dev)
    return _launch_scan(b, sub, dev, out)


def seg_scan_bind(v, keep, sub: int = SUB, device="cuda"):
    """Build ``(bufs, fn(bufs, out=None))`` for the scan probe over ``v``
    and ``keep`` (arrays or tensors): both staged on ``device`` and
    checked there once (``_build.staged_guard``); ``fn`` launches the
    kernel, into ``out`` when given, on a card and runs
    ``seg_scan_plain`` on the CPU."""
    device = ensure_platform(device)
    bufs = {"v": _staged(v, device), "keep": _staged(keep, device)}
    t = {"sub": sub}
    staged_on = _build.staged_guard(bufs, t, check_scan)

    def fn(b, out=None):
        if b["v"].device.type == "cpu":
            return seg_scan_plain(b["v"], b["keep"], sub)
        dev = staged_on(b)
        if dev is None:
            dev = b["v"].device
            check_scan(b, t, dev)
        return _launch_scan(b, sub, dev, out)
    fn.staged_on = staged_on
    fn.meta = dict(t)
    return bufs, fn


def seg_scan_plain(v: torch.Tensor, keep: torch.Tensor, sub: int = SUB
                   ) -> torch.Tensor:
    """The plain version: the script's ``np_reference``, in order, over
    all blocks at once (``acc = 0`` where keep == 0, then ``acc += v``)."""
    _check_scan(v, keep, sub)
    L = sub * v.shape[1]
    vb, kb = v.reshape(-1, L), keep.reshape(-1, L)
    out = torch.empty_like(vb)
    acc = vb.new_zeros(vb.shape[0])
    for j in range(L):
        acc = torch.where(kb[:, j] == 0, 0.0, acc) + vb[:, j]
        out[:, j] = acc
    return out.reshape(v.shape)


def seg_scan(v: torch.Tensor, keep: torch.Tensor, sub: int = SUB
             ) -> torch.Tensor:
    """The scan probe on a CUDA tensor, its plain version on a CPU one."""
    if v.device.type == "cpu":
        return seg_scan_plain(v, keep, sub)
    return seg_scan_cuda(v, keep, sub)


# ------------------------------------------------------------ constructs
def construct_inputs() -> dict:
    """Each construct's arguments, drawn as ``tpu_mosaic_probe.py`` draws
    them from one ``default_rng(0)``, in its order."""
    rng = np.random.default_rng(0)
    idx_row = rng.integers(0, 16, size=(8, S)).astype(np.int32)
    vec = rng.normal(size=(1, R)).astype(np.float32)
    mat = rng.normal(size=(GS, LANES)).astype(np.float32)
    sc = rng.normal(size=(SUB, LANES)).astype(np.float32)
    su = rng.integers(0, 2, size=(SUB, S)).astype(np.float32)
    v8 = rng.normal(size=(4, LANES)).astype(np.float32)
    return {"reshape_s1": (idx_row,), "out_reshape": (vec,),
            "shift_sub": (mat,), "shift_lane": (mat,), "iota_mod": (mat,),
            "lane_bcast": (mat,), "dot0": (sc, su), "dynbase": (v8, 3)}


OUT_SHAPES = {"reshape_s1": (S, HOT), "out_reshape": (R // LANES, LANES),
              "dot0": (LANES, S), "dynbase": (Y_ROWS, LANES)}
IN_SHAPES = {"reshape_s1": [(8, S)], "out_reshape": [(1, R)],
             "dot0": [(SUB, LANES), (SUB, S)], "dynbase": [(4, LANES)]}


def check_construct(b: dict, t: dict, device) -> None:
    """Raise ``ValueError`` unless ``b``'s tensors are the inputs of
    construct ``t["name"]``: its shapes (``IN_SHAPES``), int32 for
    ``reshape_s1`` and float32 else, contiguous on ``device``."""
    name = t["name"]
    for x, shape in zip(b.values(), IN_SHAPES.get(name, [(GS, LANES)])):
        if tuple(x.shape) != shape:
            raise ValueError(f"{name}: input of shape {tuple(x.shape)}, "
                             f"expected {shape}")
        _build.check(x, name, torch.int32 if name == "reshape_s1"
                     else torch.float32, device)


def _construct_parts(name: str, args) -> tuple[dict, dict]:
    """A construct's tensors (``a``, and ``b`` for ``dot0``) and its
    parameters (``name``, ``which``, ``base``) from its arguments;
    ``ValueError`` on another name or ``dynbase``'s base outside its
    window."""
    if name not in CONSTRUCTS:
        raise ValueError(f"construct {name!r}: one of {CONSTRUCTS}")
    b = {"a": args[0]}
    if name == "dot0":
        b["b"] = args[1]
    base = int(args[1]) if name == "dynbase" else 0
    if not 0 <= base <= Y_ROWS - 4:
        raise ValueError(f"dynbase: base {base} outside [0, {Y_ROWS - 4}]")
    return b, {"name": name, "which": CONSTRUCTS.index(name), "base": base}


def _launch_construct(b: dict, t: dict, dev, out=None) -> torch.Tensor:
    o = _build.output(out, OUT_SHAPES.get(t["name"], (GS, LANES)), dev)
    a = b["a"]
    _build.launch("loops_construct_probe", "construct_probe", dev, t["which"],
                  a, b.get("b", a), a, o, t["base"])
    return o


def construct_cuda(name: str, *args, out=None) -> torch.Tensor:
    """Launch one case of the construct probe on CUDA tensors (``dynbase``
    takes ``(v, base)`` with an int base), its inputs checked on this
    call; into ``out`` when given."""
    dev = args[0].device
    if dev.type != "cuda":
        raise ValueError(f"construct_cuda needs a CUDA tensor, got {dev}")
    b, t = _construct_parts(name, args)
    check_construct(b, t, dev)
    return _launch_construct(b, t, dev, out)


def construct_bind(name: str, *args, device="cuda"):
    """Build ``(bufs, fn(bufs, out=None))`` for one construct on ``args``
    (arrays or tensors; ``dynbase``'s base an int): the tensors staged on
    ``device`` and checked there once (``_build.staged_guard``); ``fn``
    launches the kernel, into ``out`` when given, on a card and runs
    ``construct_plain`` on the CPU."""
    device = ensure_platform(device)
    b, t = _construct_parts(name, args)
    bufs = {k: _staged(x, device) for k, x in b.items()}
    staged_on = _build.staged_guard(bufs, t, check_construct)
    rest = (t["base"],) if name == "dynbase" else ()

    def fn(b, out=None):
        if b["a"].device.type == "cpu":
            return construct_plain(name, *b.values(), *rest)
        dev = staged_on(b)
        if dev is None:
            dev = b["a"].device
            check_construct(b, t, dev)
        return _launch_construct(b, t, dev, out)
    fn.staged_on = staged_on
    fn.meta = dict(t)
    return bufs, fn


def construct_plain(name: str, *args) -> torch.Tensor:
    """The plain PyTorch version of one construct."""
    a = args[0]
    if name == "reshape_s1":
        return (a[0].reshape(S, 1) == torch.arange(HOT, device=a.device)
                ).float()
    if name == "out_reshape":
        return a.reshape(R // LANES, LANES).clone()
    if name == "shift_sub":
        return torch.cat([a.new_zeros(2, LANES), a[:-2]])
    if name == "shift_lane":
        return torch.cat([a.new_zeros(GS, 3), a[:, :-3]], dim=1)
    if name == "iota_mod":
        rows = torch.arange(GS, device=a.device)[:, None]
        return torch.where(rows % SUB >= 1, a, 0.0)
    if name == "lane_bcast":
        return a[:, LANES - 1:LANES].expand(GS, LANES).clone()
    if name == "dot0":
        return a.t() @ args[1]
    base = int(args[1])
    y = a.new_zeros(Y_ROWS, LANES)
    y[base:base + 4] += a
    return y


def construct(name: str, *args) -> torch.Tensor:
    if args[0].device.type == "cpu":
        return construct_plain(name, *args)
    return construct_cuda(name, *args)


def _staged(x, device) -> torch.Tensor:
    """An array or tensor as a contiguous tensor on ``device``."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x)
    return x.to(device).contiguous()


def _on(args, device):
    return tuple(_staged(a, device) if isinstance(a, np.ndarray) else a
                 for a in args)


# ------------------------------------------------------------- the floor
def launch_floor_cuda(out: torch.Tensor, v: int = 1) -> torch.Tensor:
    """Launch the floor kernel: one CTA of 32 threads sets ``out`` (one
    int32 on the card) to ``v``. Its device time is the least a launch
    costs the card."""
    if not out.is_cuda:
        raise ValueError(f"launch_floor_cuda needs a CUDA tensor, got "
                         f"{out.device}")
    _build.check(out, "out", torch.int32, out.device, 1)
    _build.launch("loops_launch_floor", "launch_floor", out.device, out, v)
    return out


def launch_floor_plain(out: torch.Tensor, v: int = 1) -> torch.Tensor:
    """The plain version: ``out.fill_(v)``."""
    return out.fill_(v)


def launch_floor(out: torch.Tensor, v: int = 1) -> torch.Tensor:
    if out.device.type == "cpu":
        return launch_floor_plain(out, v)
    return launch_floor_cuda(out, v)


# launches of the floor kernel a measurement takes
FLOOR_LAUNCHES = 400


def profiled_us(fn, name: str, launches: int = FLOOR_LAUNCHES):
    """``(median µs, events)`` of the durations ``torch.profiler`` records
    for the kernel ``name`` over ``launches`` calls of ``fn()``: the card's
    clock, as the K13 kernels' device times are read. ``(None, 0)`` when
    the trace holds none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(launches):
            fn()
        torch.cuda.synchronize()
    us = sorted(e.time_range.elapsed_us() for e in prof.events()
                if e.device_type == DeviceType.CUDA and name in e.name)
    if not us:
        return None, 0
    return float(np.median(us)), len(us)


def probe_floor(device, out=print, timed=True) -> dict:
    """The floor kernel against its plain version, then its time per
    launch on the card's clock two ways: the median duration
    ``torch.profiler`` records over ``FLOOR_LAUNCHES`` launches, and CUDA
    events around as many launches queued back to back behind a sleep
    kernel (``utils/bench.device_ms``); and per call (``launch_ms``, the
    host's pace). The record's ``floor_ms`` is the profiler's median (the
    events' time where the trace holds no launch): the bound of a kernel
    whose bytes and operations take less."""
    buf = torch.zeros(1, dtype=torch.int32, device=device)
    err = hold("launch_floor", launch_twice(lambda: launch_floor(buf, 7)),
               torch.tensor([7], dtype=torch.int32, device=device))
    ms = plain_ms = prof_us = events_us = floor_ms = None
    n_prof = 0
    if timed:
        ms = launch_ms(lambda: launch_floor(buf), device)
        plain_ms = launch_ms(lambda: launch_floor_plain(buf), device)
        if buf.is_cuda:
            prof_us, n_prof = profiled_us(lambda: launch_floor_cuda(buf),
                                          "launch_floor_kernel")
            events_us = 1e3 * device_ms(lambda x: launch_floor_cuda(x), buf,
                                        applies=FLOOR_LAUNCHES)
            floor_ms = (prof_us if prof_us is not None else events_us) / 1e3
    line = ("launch floor (one CTA of 32 threads, one word): exact=True"
            + (f"; device {prof_us:.3f} us a launch (torch.profiler median "
               f"of {n_prof}), {events_us:.3f} us (CUDA events over "
               f"{FLOOR_LAUNCHES} launches queued)" if floor_ms is not None
               and prof_us is not None else "")
            + (f"; device {events_us:.3f} us (CUDA events; the trace held no "
               "launch)" if floor_ms is not None and prof_us is None else "")
            + (f"; {ms * 1e3:.3f} us a call" if timed else ""))
    out(line)
    rec = record("launch_floor", "one word", ms, plain_ms, plain_ms, 4, 0,
                 "f32", err, line)
    rec.update(floor_ms=floor_ms, profiler_us=prof_us, profiler_n=n_prof,
               events_us=events_us)
    return rec


# ----------------------------------------------------------------- probes
def _device_us(fn, kernel: str, on_card: bool):
    return profiled_us(fn, kernel) if on_card else (None, 0)


def probe_scan(device, out=print, timed=True) -> dict:
    """The scan at the script's size, normal and integer-valued, against
    its plain version, unbound and bound (the two bitwise equal); then
    the time of a call of each (``launch_ms``; the bound one into a given
    ``out``) and the kernel's device time (``profiled_us``); one line."""
    v, keep = _on(scan_inputs(), device)
    got = launch_twice(lambda: seg_scan(v, keep))
    err = hold("seg_scan", got, seg_scan_plain(v, keep), SCAN_ATOL)
    vi, _ = _on(scan_inputs(integer=True), device)
    exact = hold("seg_scan integer", launch_twice(lambda: seg_scan(vi, keep)),
                 seg_scan_plain(vi, keep)) == 0.0
    bufs, fn = seg_scan_bind(v, keep, device=device)
    o = torch.full_like(v, float("nan"))
    hold("seg_scan bound", fn(bufs, out=o), got)
    ms = plain_ms = unbound_ms = dev_us = None
    n_dev = 0
    if timed:
        unbound_ms = launch_ms(lambda: seg_scan(v, keep), device)
        ms = launch_ms(lambda: fn(bufs, out=o), device)
        plain_ms = launch_ms(lambda: seg_scan_plain(v, keep), device, 1, 3)
        dev_us, n_dev = _device_us(lambda: fn(bufs, out=o),
                                   "seg_scan_probe_kernel", v.is_cuda)
    line = (f"seg_scan [{GS}x{LANES}] SUB={SUB}: kernel vs plain OK "
            f"maxdiff={err:.2e} (atol {SCAN_ATOL:g}); integer-valued "
            f"exact={exact}; bound form bitwise equal"
            + (f"; {unbound_ms * 1e3:.3f} us a call, bound "
               f"{ms * 1e3:.3f} us" if timed else "")
            + (f"; device {dev_us:.3f} us a launch (torch.profiler median "
               f"of {n_dev})" if dev_us is not None else ""))
    out(line)
    n = v.numel()
    rec = record("seg_scan_probe", "seg_scan", ms, plain_ms, None, 12 * n,
                 n, "f32", err, line)
    rec.update(unbound_ms=unbound_ms, device_us=dev_us)
    return rec


def construct_library(name: str, *args):
    """The one PyTorch call that computes construct ``name``, where there
    is one (``clone`` of the reshape for ``out_reshape``, ``torch.matmul``
    for ``dot0``); None elsewhere."""
    if name == "out_reshape":
        return lambda: args[0].reshape(R // LANES, LANES).clone()
    if name == "dot0":
        return lambda: torch.matmul(args[0].t(), args[1])
    return None


def probe_constructs(device, out=print, timed=True) -> dict:
    """The eight constructs on the script's inputs, each against its plain
    version, unbound and bound (bitwise equal); one line each with its
    call times (unbound and bound into a given ``out``), its device time
    (``profiled_us``) and its library call's time where there is one;
    then the means."""
    args = {k: _on(v, device) for k, v in construct_inputs().items()}
    worst = 0.0
    binds = {}
    cases = {}
    on_card = torch.device(device).type == "cuda"
    for name in CONSTRUCTS:
        got = launch_twice(lambda: construct(name, *args[name]))
        atol = ATOL.get(name, 0.0)
        err = hold(name, got, construct_plain(name, *args[name]), atol)
        worst = max(worst, err)
        bufs, fn = construct_bind(name, *args[name], device=device)
        o = torch.full_like(got, float("nan"))
        hold(f"{name} bound", fn(bufs, out=o), got)
        binds[name] = (bufs, fn, o)
        c = {}
        if timed:
            lib = construct_library(name, *args[name])
            c = dict(unbound_ms=launch_ms(lambda: construct(name, *args[name]),
                                          device),
                     ms=launch_ms(lambda: fn(bufs, out=o), device),
                     library_ms=lib and launch_ms(lib, device))
            c["device_us"], _ = _device_us(lambda: fn(bufs, out=o),
                                           "construct_probe_kernel", on_card)
        cases[name] = c
        out(f"{LABELS[name]:48s} OK  "
            + (f"maxdiff={err:.2e} (atol {atol:g})" if atol
               else "exact=True")
            + (f"; {c['unbound_ms'] * 1e3:.3f} us a call, bound "
               f"{c['ms'] * 1e3:.3f} us" if timed else "")
            + (f", device {c['device_us']:.3f} us" if c.get("device_us")
               is not None else "")
            + (f"; {'clone' if name == 'out_reshape' else 'torch.matmul'} "
               f"{c['library_ms'] * 1e3:.3f} us" if c.get("library_ms")
               is not None else ""))

    def all_cases(fn):
        return lambda: [fn(k, *args[k]) for k in CONSTRUCTS][-1]
    ms = plain_ms = unbound_ms = None
    if timed:
        n = len(CONSTRUCTS)
        unbound_ms = sum(c["unbound_ms"] for c in cases.values()) / n
        ms = sum(c["ms"] for c in cases.values()) / n
        plain_ms = launch_ms(all_cases(construct_plain), device) / n
    nbytes = flops = 0
    for name in CONSTRUCTS:
        ins = [a for a in args[name] if isinstance(a, torch.Tensor)]
        nbytes += sum(4 * a.numel() for a in ins)
        nbytes += 4 * int(np.prod(OUT_SHAPES.get(name, (GS, LANES))))
    flops = 2 * SUB * LANES * S  # dot0's products and sums
    line = (f"constructs: {len(CONSTRUCTS)} cases OK, max |kernel - plain| "
            f"{worst:.2e}"
            + (f"; {unbound_ms * 1e3:.3f} us a call (mean), bound "
               f"{ms * 1e3:.3f} us" if timed else ""))
    out(line)
    n = len(CONSTRUCTS)
    rec = record("construct_probe", "constructs", ms, plain_ms, None,
                 nbytes / n, flops / n, "f32", worst, line)
    rec.update(unbound_ms=unbound_ms, cases=cases)
    return rec


def run(device="cuda", quick: bool = False, out=print, timed=True
        ) -> list:
    """Every K13 probe and the launch floor (the scripts' sizes are small:
    ``quick`` changes nothing)."""
    device = ensure_platform(device)
    return [probe_scan(device, out, timed),
            probe_constructs(device, out, timed),
            probe_floor(device, out, timed)]
