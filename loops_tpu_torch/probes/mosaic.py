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

What bounds both is the launch: the inputs are a few KB.
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


def seg_scan_cuda(v: torch.Tensor, keep: torch.Tensor, sub: int = SUB
                  ) -> torch.Tensor:
    """Launch the scan probe: one CTA per block of ``sub`` rows."""
    dev = v.device
    if dev.type != "cuda":
        raise ValueError(f"seg_scan_cuda needs a CUDA tensor, got {dev}")
    _check_scan(v, keep, sub)
    _build.check(v, "v", torch.float32, dev)
    _build.check(keep, "keep", torch.float32, dev, v.numel())
    out = torch.empty_like(v)
    if v.numel() == 0:
        return out
    _build.launch("loops_seg_scan_probe", "seg_scan_probe", dev, v, keep, out,
                  v.shape[0] // sub, sub * v.shape[1])
    return out


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


def construct_cuda(name: str, *args) -> torch.Tensor:
    """Launch one case of the construct probe on CUDA tensors (``dynbase``
    takes ``(v, base)`` with an int base)."""
    which = CONSTRUCTS.index(name)
    a = args[0]
    dev = a.device
    if dev.type != "cuda":
        raise ValueError(f"construct_cuda needs a CUDA tensor, got {dev}")
    tensors = [t for t in args if isinstance(t, torch.Tensor)]
    for t, shape in zip(tensors, IN_SHAPES.get(name, [(GS, LANES)])):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: input of shape {tuple(t.shape)}, "
                             f"expected {shape}")
        _build.check(t, name, torch.int32 if name == "reshape_s1"
                     else torch.float32, dev)
    base = int(args[1]) if name == "dynbase" else 0
    if not 0 <= base <= Y_ROWS - 4:
        raise ValueError(f"dynbase: base {base} outside [0, {Y_ROWS - 4}]")
    out = torch.empty(OUT_SHAPES.get(name, (GS, LANES)), dtype=torch.float32,
                      device=dev)
    b = args[1] if name == "dot0" else a
    _build.launch("loops_construct_probe", "construct_probe", dev, which,
                  a, b, a, out, base)
    return out


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


def _on(args, device):
    return tuple(torch.from_numpy(a).to(device) if isinstance(a, np.ndarray)
                 else a for a in args)


# ----------------------------------------------------------------- probes
def probe_scan(device, out=print, timed=True) -> dict:
    """The scan at the script's size, normal and integer-valued, against
    its plain version; one line."""
    v, keep = _on(scan_inputs(), device)
    got = launch_twice(lambda: seg_scan(v, keep))
    err = hold("seg_scan", got, seg_scan_plain(v, keep), SCAN_ATOL)
    vi, _ = _on(scan_inputs(integer=True), device)
    exact = hold("seg_scan integer", launch_twice(lambda: seg_scan(vi, keep)),
                 seg_scan_plain(vi, keep)) == 0.0
    ms = plain_ms = None
    if timed:
        ms = launch_ms(lambda: seg_scan(v, keep), device)
        plain_ms = launch_ms(lambda: seg_scan_plain(v, keep), device, 1, 3)
    line = (f"seg_scan [{GS}x{LANES}] SUB={SUB}: kernel vs plain OK "
            f"maxdiff={err:.2e} (atol {SCAN_ATOL:g}); integer-valued "
            f"exact={exact}"
            + (f"; {ms * 1e3:.3f} us/launch" if timed else ""))
    out(line)
    n = v.numel()
    return record("seg_scan_probe", "seg_scan", ms, plain_ms, None, 12 * n,
                  n, "f32", err, line)


def probe_constructs(device, out=print, timed=True) -> dict:
    """The eight constructs on the script's inputs, each against its plain
    version; one line each, then the mean launch time."""
    args = {k: _on(v, device) for k, v in construct_inputs().items()}
    worst = 0.0
    for name in CONSTRUCTS:
        got = launch_twice(lambda: construct(name, *args[name]))
        atol = ATOL.get(name, 0.0)
        err = hold(name, got, construct_plain(name, *args[name]), atol)
        worst = max(worst, err)
        out(f"{LABELS[name]:48s} OK  "
            + (f"maxdiff={err:.2e} (atol {atol:g})" if atol
               else "exact=True"))

    def all_cases(fn):
        return lambda: [fn(k, *args[k]) for k in CONSTRUCTS][-1]
    ms = plain_ms = None
    if timed:
        ms = launch_ms(all_cases(construct), device) / len(CONSTRUCTS)
        plain_ms = launch_ms(all_cases(construct_plain), device
                             ) / len(CONSTRUCTS)
    nbytes = flops = 0
    for name in CONSTRUCTS:
        ins = [a for a in args[name] if isinstance(a, torch.Tensor)]
        nbytes += sum(4 * a.numel() for a in ins)
        nbytes += 4 * int(np.prod(OUT_SHAPES.get(name, (GS, LANES))))
    flops = 2 * SUB * LANES * S  # dot0's products and sums
    line = (f"constructs: {len(CONSTRUCTS)} cases OK, max |kernel - plain| "
            f"{worst:.2e}"
            + (f"; {ms * 1e3:.3f} us/launch (mean)" if timed else ""))
    out(line)
    n = len(CONSTRUCTS)
    return record("construct_probe", "constructs", ms, plain_ms, None,
                  nbytes / n, flops / n, "f32", worst, line)


def run(device="cuda", quick: bool = False, out=print, timed=True
        ) -> list:
    """Every K13 probe (the scripts' sizes are small: ``quick`` changes
    nothing)."""
    device = ensure_platform(device)
    return [probe_scan(device, out, timed), probe_constructs(device, out,
                                                             timed)]
