"""K14: the port of ``scripts/tpu_r2_probe.py``, the quantities the BCSR
SpMM kernels (K7-K9) and their tensor-core redesign hang on.

- **stream** (``stream_probe``, ``:60``): the read rate over the script's
  [32768, 512] f32 array. It is K11 (``utils/stream.pass_ms``): no second
  stream kernel.
- **block dot** (``dot_probe``, ``:90``): ``acc += A[c] @ B`` over NCH =
  32768 / M chunks of A [M, 128], M in {8, 64, 128}, with B [128, 512]
  resident or, for M in {64, 128}, a distinct B[c] streamed per chunk;
  microseconds per chunk by the slope over passes inside one launch.
  ``mode="f32"``: IEEE fmaf on the CUDA cores (K7's and K9's unit);
  ``mode="bf16"``: bf16 A and B, f32 sums, ``mma.sync`` m16n8k16 on the
  tensor cores (the TPU's MXU at default precision). Every product is
  consumed: the result is the whole [M, 512] sum.
- **scatter** (``scatter_probe``, ``:148``): KCH = 8 accumulates of an
  (R = 8, 512) slab per chunk into a resident accumulator at random
  multiples of R; one thread per (row in block, feature), no atomics. The
  TPU held [4096, 512] f32 in VMEM; a CTA holds K7's 256 x 64 in shared
  memory (``smem=True``, 512 features as 8 column tiles), and the TPU's
  [4096, 512] runs in device memory, where it lies in L2 (``smem=False``).
- **dispatch** (``dispatch_probe``, ``:200``): the host microseconds of one
  launch of K12 on [8, 128] through ``_build.launch`` (ctypes), beside
  ``torch.add`` on the same tensors.

Checks: integer-valued inputs give exact sums in any order, so the dots
and the scatter are held to their plain versions exactly on them. On the
script's normal inputs the dots are held to the plain version computed in
float64 (``dot_reference``), per output within ``DOT_C`` units of ``u32
sqrt(sum (a b)^2)`` (``sqrt(n) u32 rms|a b|`` over the n = 128 NCH terms;
bf16 products are exact in f32). That is a statistical bound: an IEEE f32
sum of random terms stays within it, while rounding the operands to TF32
(10 mantissa bits) moves an output by about 6,700 units rms.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from loops_tpu_torch.ops.kernels import _build
from loops_tpu_torch.ops.kernels.saxpy import saxpy_cuda, saxpy_plain
from loops_tpu_torch.probes.common import (
    ProbeMismatch,
    hold,
    launch_ms,
    launch_twice,
    record,
    sync,
)
from loops_tpu_torch.utils.bench import run_slope_ms
from loops_tpu_torch.utils.platform import ensure_platform
from loops_tpu_torch.utils.stream import pass_ms, stream_input

K, N = 128, 512
NCH_ROWS = 32768
# tpu_r2_probe.py main(): (M, stream B)
DOT_CASES = ((8, False), (64, False), (128, False), (64, True), (128, True))
MODES = ("f32", "bf16")
# tpu_r2_probe.py scatter_probe defaults
KCH, RR, FT, NCH_SCATTER = 8, 8, 512, 512
SMEM_ROWS, L2_ROWS = 256, 4096
SMEM_FT = 64
U32 = 2.0 ** -24
# The dots' bound, in units of u32 sqrt(sum (a b)^2) per output: several
# times the largest reading of the f32 and bf16 kernels on the card, and
# a small fraction of what TF32 operands give (``dot_units``).
DOT_C = 1024


def _sms(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


# ------------------------------------------------------------------ dot
def dot_inputs(M: int, stream_b: bool, integer: bool = False,
               nch_rows: int = NCH_ROWS):
    """The script's inputs (``default_rng(1)``: A [NCH, M, 128], then B
    [128, 512] or [NCH, 128, 512], normal); ``integer`` draws integers in
    [-4, 4] instead, whose sums here are exact in f32."""
    nch = nch_rows // M
    rng = np.random.default_rng(1)
    bsh = (nch, K, N) if stream_b else (K, N)
    if integer:
        return (rng.integers(-4, 5, size=(nch, M, K)).astype(np.float32),
                rng.integers(-4, 5, size=bsh).astype(np.float32))
    return (rng.normal(size=(nch, M, K)).astype(np.float32),
            rng.normal(size=bsh).astype(np.float32))


def _dot_shapes(A, B, mode):
    want = torch.float32 if mode == "f32" else torch.bfloat16
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: 'f32' or 'bf16'")
    if A.dim() != 3 or A.shape[2] != K or A.shape[1] not in (8, 64, 128):
        raise ValueError(f"A must be [nch, M, 128] with M in (8, 64, 128), "
                         f"got {tuple(A.shape)}")
    nch = A.shape[0]
    if tuple(B.shape) not in ((K, N), (nch, K, N)):
        raise ValueError(f"B must be [128, 512] or [{nch}, 128, 512], got "
                         f"{tuple(B.shape)}")
    return want, nch, B.dim() == 3


def block_dot_cuda(A: torch.Tensor, B: torch.Tensor, mode: str = "f32",
                   passes: int = 1) -> torch.Tensor:
    """Launch the block-dot probe: ``passes`` times the sum over chunks of
    ``A[c] @ B`` (or ``B[c]``), [M, 512] f32."""
    dev = A.device
    if dev.type != "cuda":
        raise ValueError(f"block_dot_cuda needs a CUDA tensor, got {dev}")
    want, nch, stream_b = _dot_shapes(A, B, mode)
    _build.check(A, "A", want, dev)
    _build.check(B, "B", want, dev)
    M = A.shape[1]
    grid_x = N // (64 if M >= 64 else 256) if mode == "bf16" else \
        N // (64 if M >= 16 else 128)
    groups = min(nch, -(-4 * _sms(dev) // grid_x))
    partial = torch.empty(groups, M, N, dtype=torch.float32, device=dev)
    _build.launch("loops_block_dot", f"block_dot_{mode}", dev, A, B, partial,
                  nch, M, int(stream_b), passes, groups, int(mode == "bf16"))
    return partial.sum(0)


def _chunk_sum(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """The sum over chunks of ``A[c] @ B`` (or ``B[c]``), in A's type."""
    return torch.einsum("cmk,ckn->mn" if B.dim() == 3 else "cmk,kn->mn", A, B)


def block_dot_plain(A: torch.Tensor, B: torch.Tensor, mode: str = "f32",
                    passes: int = 1) -> torch.Tensor:
    """The plain version in f32 (bf16 values widened: their products are
    exact): one einsum per pass, summed."""
    _dot_shapes(A, B, mode)
    Af, Bf = A.float(), B.float()
    acc = Af.new_zeros(A.shape[1], N)
    for _ in range(passes):
        acc += _chunk_sum(Af, Bf)
    return acc


def block_dot(A, B, mode="f32", passes=1) -> torch.Tensor:
    if A.device.type == "cpu":
        return block_dot_plain(A, B, mode, passes)
    return block_dot_cuda(A, B, mode, passes)


def block_dot_library(A, B_stacked) -> torch.Tensor:
    """One ``torch.matmul`` over the chunks: A's chunks side by side, [M,
    NCH * 128], times ``B_stacked``, B[c] (or B, repeated) stacked as
    [NCH * 128, 512]."""
    return torch.matmul(A.transpose(0, 1).reshape(A.shape[1], -1), B_stacked)


def dot_reference(A, B) -> torch.Tensor:
    """The plain version in float64: the reference the dots are held to."""
    return _chunk_sum(A.double(), B.double())


def _dot_unit(A, B) -> torch.Tensor:
    """``u32 sqrt(sum (a b)^2)`` per output: the spread of an f32 sum of
    the products with random rounding errors."""
    A2, B2 = A.double() ** 2, B.double() ** 2
    return U32 * _chunk_sum(A2, B2).sqrt().clamp_min(1e-300)


def dot_units(got, A, B) -> torch.Tensor:
    """``|got - dot_reference|`` per output in units of ``_dot_unit``."""
    return (got.double() - dot_reference(A, B)).abs() / _dot_unit(A, B)


def hold_dot(tag, got, A, B) -> tuple[float, float]:
    """Raise unless ``got`` is finite and within ``DOT_C`` units of the
    float64 reference everywhere. Returns the max abs difference and the
    max in units."""
    diff = (got.double() - dot_reference(A, B)).abs()
    worst = float((diff / _dot_unit(A, B)).max())
    if not bool(torch.isfinite(got).all()) or not worst <= DOT_C:
        raise ProbeMismatch(f"{tag}: {worst:.0f} units of u32 sqrt(sum "
                            f"(a b)^2) from the float64 reference, past "
                            f"{DOT_C}")
    return float(diff.max()), worst


def _dot_tensors(M, stream_b, mode, device, integer=False,
                 nch_rows=NCH_ROWS):
    dt = torch.float32 if mode == "f32" else torch.bfloat16
    return tuple(torch.from_numpy(a).to(device).to(dt)
                 for a in dot_inputs(M, stream_b, integer, nch_rows))


def tf32_units(A, B) -> float:
    """The most units (``dot_units``) of ``block_dot_library`` in f32 with
    TF32 allowed: what a kernel that quietly rounded its operands to TF32
    would show on the card. ``hold_dot`` must refuse it."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        Bs = B.reshape(-1, N) if B.dim() == 3 else B.repeat(A.shape[0], 1)
        got = block_dot_library(A, Bs)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return float(dot_units(got, A, B).max())


def check_dot(M, stream_b, mode, device, nch_rows=NCH_ROWS
              ) -> tuple[float, float]:
    """Integer-valued: exact. The script's normal inputs: within
    ``DOT_C`` units of the float64 reference (``hold_dot``). Two launches
    bitwise equal. Returns ``hold_dot``'s max abs difference and max
    units on the normal inputs."""
    tag = f"block_dot {mode} M={M} {'streamB' if stream_b else 'residB'}"
    Ai, Bi = _dot_tensors(M, stream_b, mode, device, True, nch_rows)
    hold(tag + " integer", launch_twice(lambda: block_dot(Ai, Bi, mode)),
         block_dot_plain(Ai, Bi, mode))
    del Ai, Bi
    A, B = _dot_tensors(M, stream_b, mode, device, False, nch_rows)
    return hold_dot(tag, launch_twice(lambda: block_dot(A, B, mode)), A, B)


def probe_dot(M, stream_b, mode, device, out=print, timed=True,
              nch_rows=NCH_ROWS) -> dict:
    """Check one case, then time it by the slope over passes (2 and 10)
    and print the script's line."""
    err, units = check_dot(M, stream_b, mode, device, nch_rows)
    A, B = _dot_tensors(M, stream_b, mode, device, False, nch_rows)
    nch = A.shape[0]
    ms = plain_ms = lib_ms = None
    if timed:
        cuda = A.is_cuda
        ms = run_slope_ms(lambda n: block_dot(A, B, mode, n), 2, 10, 3, cuda)
        plain_ms = run_slope_ms(lambda n: block_dot_plain(A, B, mode, n),
                                1, 3, 3, cuda)
        Bs = B.reshape(-1, N) if stream_b else B.repeat(nch, 1)
        lib_ms = launch_ms(lambda: block_dot_library(A, Bs), device)
        del Bs
    tag = "streamB" if stream_b else "residB "
    line = (f"dot {mode:4s} M={M:3d} {tag}: "
            + (f"{ms * 1e3 / nch:.3f} us/chunk  ({nch} chunks, {ms:.3f} ms "
               f"per 32768-row pass)" if timed else f"({nch} chunks)")
            + f"  max|kernel-f64|={err:.2e}: {units:.0f} units, within "
            f"{DOT_C}")
    out(line)
    es = A.element_size()
    nbytes = es * (A.numel() + B.numel()) + 4 * M * N
    # with B resident the function is (sum_c A[c]) @ B: the chunks' sum
    # and one product are all the operations it needs
    flops = (2 * nch * M * K * N if stream_b
             else (nch - 1) * M * K + 2 * M * K * N)
    return record(f"block_dot_{mode}", f"M={M} {tag.strip()}", ms, plain_ms,
                  lib_ms, nbytes, flops, mode, err, line)


# -------------------------------------------------------------- scatter
def scatter_inputs(acc_rows: int, nch: int = NCH_SCATTER, kch: int = KCH,
                   rr: int = RR, ft: int = FT):
    """``default_rng(2)`` as the script: block offsets in [0, acc_rows/R -
    1), then the slabs [nch, kch * R, ft], here integers in [-8, 8]."""
    rng = np.random.default_rng(2)
    offs = rng.integers(0, acc_rows // rr - 1, nch * kch).astype(np.int32)
    a = rng.integers(-8, 9, size=(nch, kch * rr, ft)).astype(np.float32)
    return offs, a


def scatter_cuda(offs: torch.Tensor, a: torch.Tensor, acc_rows: int,
                 smem: bool = True, passes: int = 1, rr: int = RR
                 ) -> torch.Tensor:
    """Launch the scatter probe: the accumulator [acc_rows, F] after
    ``passes`` sweeps (shared memory: the sum of the CTAs' own)."""
    dev = a.device
    if dev.type != "cuda":
        raise ValueError(f"scatter_cuda needs a CUDA tensor, got {dev}")
    nch, rows, F = a.shape
    kch = rows // rr
    if rows % rr or acc_rows % rr or (smem and (F % SMEM_FT or rr * SMEM_FT
                                                > 1024)):
        raise ValueError(f"scatter: slabs [{nch}, {rows}, {F}] with R={rr}, "
                         f"{acc_rows} rows")
    if smem and acc_rows * SMEM_FT * 4 > 227 * 1024:
        raise ValueError(f"{acc_rows} x {SMEM_FT} f32 is past a CTA's 227 KB "
                         "of shared memory")
    _build.check(a, "a", torch.float32, dev)
    _build.check(offs, "offs", torch.int32, dev, nch * kch)
    if smem:
        groups = min(nch, max(1, 3 * _sms(dev) // (F // SMEM_FT)))
        part = torch.empty(groups, acc_rows, F, dtype=torch.float32,
                           device=dev)
    else:
        groups, part = 0, torch.empty(acc_rows, F, dtype=torch.float32,
                                      device=dev)
    _build.launch("loops_scatter_probe",
                  "smem_scatter" if smem else "l2_scatter", dev, offs, a,
                  part, nch, kch, rr, F, acc_rows, passes, groups, int(smem))
    return part.sum(0) if smem else part


def scatter_plain(offs: torch.Tensor, a: torch.Tensor, acc_rows: int,
                  passes: int = 1, rr: int = RR) -> torch.Tensor:
    """The plain version: ``index_add_`` of every slab row into row
    ``off * R + j``, ``passes`` times."""
    F = a.shape[2]
    rows = (offs.long()[:, None] * rr
            + torch.arange(rr, device=a.device)).reshape(-1)
    acc = a.new_zeros(acc_rows, F)
    for _ in range(passes):
        acc.index_add_(0, rows, a.reshape(-1, F))
    return acc


def scatter(offs, a, acc_rows, smem=True, passes=1) -> torch.Tensor:
    if a.device.type == "cpu":
        return scatter_plain(offs, a, acc_rows, passes)
    return scatter_cuda(offs, a, acc_rows, smem, passes)


def probe_scatter(smem: bool, device, out=print, timed=True,
                  nch: int = NCH_SCATTER) -> dict:
    acc_rows = SMEM_ROWS if smem else L2_ROWS
    offs, a = (torch.from_numpy(v).to(device)
               for v in scatter_inputs(acc_rows, nch))
    err = hold(f"scatter {'smem' if smem else 'l2'}",
               launch_twice(lambda: scatter(offs, a, acc_rows, smem)),
               scatter_plain(offs, a, acc_rows))
    ms = plain_ms = None
    if timed:
        cuda = a.is_cuda
        ms = run_slope_ms(lambda n: scatter(offs, a, acc_rows, smem, n),
                          2, 10, 3, cuda)
        plain_ms = run_slope_ms(
            lambda n: scatter_plain(offs, a, acc_rows, n), 1, 3, 3, cuda)
    where = (f"smem acc [{acc_rows}x{SMEM_FT}] per CTA" if smem
             else f"L2 acc [{acc_rows}x{FT}] in device memory")
    us = ms * 1e3 / nch if timed else None
    line = (f"scatter kch={KCH} R={RR} FT={FT} {where}: "
            + (f"{us:.3f} us/chunk ({us / KCH * 1e3:.1f} ns per (R,FT) "
               "add)" if timed else f"({nch} chunks)")
            + "  exact=True")
    out(line)
    nbytes = 4 * (a.numel() + offs.numel() + acc_rows * FT)
    return record("smem_scatter" if smem else "l2_scatter",
                  "smem 256x64" if smem else "L2 4096x512", ms, plain_ms,
                  plain_ms, nbytes, a.numel(), "f32", err, line)


# ------------------------------------------------------------- dispatch
def probe_dispatch(device, out=print, launches: int = 200) -> dict:
    """Host microseconds per call of K12 on [8, 128] through
    ``_build.launch``, and of ``torch.add`` on the same tensors: the
    enqueue of ``launches`` calls in a row by the host clock, and the
    least and median of 10 single calls each followed by a synchronize."""
    x = torch.zeros(8, 128, device=device)
    y = torch.ones(8, 128, device=device)
    calls = {"K12 _build.launch": (lambda: saxpy_cuda(1.0, x, y))
             if device.type == "cuda" else (lambda: saxpy_plain(1.0, x, y)),
             "torch.add": lambda: torch.add(y, x, alpha=1.0)}
    res = {}
    for label, fn in calls.items():
        sync(fn())
        t0 = time.perf_counter()
        for _ in range(launches):
            r = fn()
        enqueue_us = (time.perf_counter() - t0) / launches * 1e6
        sync(r)
        single = []
        for _ in range(10):
            t0 = time.perf_counter()
            sync(fn())
            single.append((time.perf_counter() - t0) * 1e6)
        single.sort()
        res[label] = dict(enqueue_us=enqueue_us, min_us=single[0],
                          median_us=single[5])
        out(f"dispatch {label} [8,128]: enqueue {enqueue_us:.2f} us/launch "
            f"(host); launch+sync min {single[0]:.2f} us median "
            f"{single[5]:.2f} us")
    return res


def probe_stream(device, out=print, rows: int = 32768) -> float:
    """K11 over the script's [32768, 512] f32 array (64 MiB)."""
    x = stream_input(rows, 512, device)
    ms = pass_ms(x)
    gbps = x.numel() * 4 / ms / 1e6
    out(f"stream_read (K11): {ms:.3f} ms per {x.numel() * 4 / 2**20:.0f}MB "
        f"pass -> {gbps:.1f} GB/s achievable")
    return gbps


def run(device="cuda", quick: bool = False, out=print, timed=True
        ) -> list:
    """Every K14 probe at the script's sizes (``quick``: 1/32 of the rows
    and chunks); returns the kernels' records."""
    device = ensure_platform(device)
    nch_rows = NCH_ROWS // 32 if quick else NCH_ROWS
    if timed:
        probe_dispatch(device, out)
        probe_stream(device, out, 1024 if quick else 32768)
    recs = [probe_dot(M, sb, mode, device, out, timed, nch_rows)
            for mode in MODES for M, sb in DOT_CASES]
    nch = NCH_SCATTER // 32 if quick else NCH_SCATTER
    recs += [probe_scatter(smem, device, out, timed, nch)
             for smem in (True, False)]
    return recs
