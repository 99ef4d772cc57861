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
  multiples of R, no atomics. The TPU held [4096, 512] f32 in VMEM; a CTA
  holds K7's 256 x 64 in shared memory (``smem_scatter``, 512 features
  as 8 column tiles, one thread per (row in block, feature)), and the
  TPU's [4096, 512] runs in device memory as a segment sum
  (``l2_scatter``): ``scatter_plan`` sorts the slabs stably by
  destination block once, on the host, and the kernel sums each block's
  slabs in that order, so each output's terms keep the (pass, chunk,
  slab) order of a sequential loop (``scatter_sequential``), bit for bit
  on any input. The smem kernel shares a tile's chunks over
  ``SMEM_GROUPS`` CTAs, the slabs brought by 2-D TMA copies into a ring
  of ``SMEM_STAGES`` stages, and sums the groups' accumulators in the same
  launch from a cluster's distributed shared memory, in group (then
  cluster) order (``scatter_smem_order``), bit for bit. Both are bound
  once at their block offsets, the offsets (or the plan) staged and
  checked there. Both accumulators are timed by one pass with the L2
  emptied first (``utils/bench.cold_ms``): their bound charges all 67 MB
  of slabs at device memory's rate, and a later pass of a run finds part
  of them still in the 50 MB L2 (the slope over passes is printed
  beside, as the warm time).
- **dispatch** (``dispatch_probe``, ``:200``): the host microseconds of one
  launch of K12 on [8, 128] through ``saxpy_cuda`` (its checks, the
  output's allocation and one call of the launch binding), beside
  ``torch.add`` on the same tensors.

Checks: integer-valued inputs give exact sums in any order, so the dots
and the scatters are held to their plain versions exactly on them; on
the script's normal inputs the L2 scatter is also held bit for bit to
``scatter_sequential`` and the smem one to ``scatter_smem_order``. On
those the dots are held to the plain version
computed in float64 (``dot_reference``), per output within ``DOT_C``
units of ``u32 sqrt(sum (a b)^2)`` (``sqrt(n) u32 rms|a b|`` over the n
= 128 NCH terms; bf16 products are exact in f32). That is a statistical
bound: an IEEE f32 sum of random terms stays within it, while rounding
the operands to TF32 (10 mantissa bits) moves an output by about 6,700
units rms.
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
from loops_tpu_torch.utils import counters
from loops_tpu_torch.utils.bench import cold_ms, run_slope_ms
from loops_tpu_torch.utils.platform import ensure_platform
from loops_tpu_torch.utils.stream import pass_ms, stream_input, stream_read

K, N = 128, 512
NCH_ROWS = 32768
# tpu_r2_probe.py main(): (M, stream B)
DOT_CASES = ((8, False), (64, False), (128, False), (64, True), (128, True))
MODES = ("f32", "bf16")
# tpu_r2_probe.py scatter_probe defaults
KCH, RR, FT, NCH_SCATTER = 8, 8, 512, 512
SMEM_ROWS, L2_ROWS = 256, 4096
SMEM_FT = 64
# the smem scatter's launch (csrc/probes_r2.cu): CTAs a 64-feature tile
# (a multiple of the cluster, up to 8 clusters); its kernel's CTAs a
# cluster and stages of its ring
SMEM_GROUPS = 12
SMEM_CLUSTER, SMEM_STAGES = 4, 4
# the L2 scatter's feature tile (csrc/probes_r2.cu) and CTAs an SM
L2_FT, L2_CTAS_PER_SM = 128, 8
U32 = 2.0 ** -24
# The dots' bound, in units of u32 sqrt(sum (a b)^2) per output: several
# times the largest reading of the f32 and bf16 kernels on the card, and
# a small fraction of what TF32 operands give (``dot_units``).
DOT_C = 1024


def _sms(dev) -> int:
    return _build.sm_count(dev)


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


def dot_grid(M: int, mode: str) -> tuple[int, int]:
    """``(column tiles, CTAs per SM)`` of the dot kernel for ``M``
    (``csrc/probes_r2.cu``): bf16 64 columns a CTA (256 at M = 8); f32 the
    8 x 8 tiles' 128 columns at M = 128 and 256 at M = 64, two CTAs an SM,
    and the one-row kernel's 128 at M = 8."""
    if mode == "bf16":
        return N // (64 if M >= 64 else 256), 4
    if M == 8:
        return N // 128, 4
    return N // (128 if M == 128 else 256), 2


def block_dot_cuda(A: torch.Tensor, B: torch.Tensor, mode: str = "f32",
                   passes: int = 1, out=None) -> torch.Tensor:
    """Launch the block-dot probe: ``passes`` times the sum over chunks of
    ``A[c] @ B`` (or ``B[c]``), [M, 512] f32, into ``out`` when given.
    The CTAs' partial sums (a ``torch.empty`` the kernel fills) are added
    in group order."""
    dev = A.device
    if dev.type != "cuda":
        raise ValueError(f"block_dot_cuda needs a CUDA tensor, got {dev}")
    want, nch, stream_b = _dot_shapes(A, B, mode)
    _build.check(A, "A", want, dev)
    _build.check(B, "B", want, dev)
    M = A.shape[1]
    o = _build.output(out, (M, N), dev)
    grid_x, per_sm = dot_grid(M, mode)
    groups = min(nch, -(-per_sm * _sms(dev) // grid_x))
    partial = torch.empty(groups, M, N, dtype=torch.float32, device=dev)
    _build.launch("loops_block_dot", f"block_dot_{mode}", dev, A, B, partial,
                  nch, M, int(stream_b), passes, groups, int(mode == "bf16"))
    return torch.sum(partial, 0, out=o)


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


def block_dot(A, B, mode="f32", passes=1, out=None) -> torch.Tensor:
    if A.device.type == "cpu":
        return block_dot_plain(A, B, mode, passes)
    return block_dot_cuda(A, B, mode, passes, out)


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
                   rr: int = RR, ft: int = FT, normal: bool = False):
    """``default_rng(2)`` as the script: block offsets in [0, acc_rows/R -
    1), then the slabs [nch, kch * R, ft], integers in [-8, 8] (exact
    sums in any order), or with ``normal`` the script's own normal
    draws."""
    rng = np.random.default_rng(2)
    offs = rng.integers(0, acc_rows // rr - 1, nch * kch).astype(np.int32)
    size = (nch, kch * rr, ft)
    a = rng.normal(size=size) if normal else rng.integers(-8, 9, size=size)
    return offs, a.astype(np.float32)


def _block_offsets(offs, acc_rows: int, rr: int = RR) -> np.ndarray:
    """The slabs' block offsets as int32 on the host; ``ValueError`` on
    an accumulator of part blocks or an offset past it."""
    if isinstance(offs, torch.Tensor):
        offs = offs.cpu().numpy()
    off = np.asarray(offs).astype(np.int64).reshape(-1)
    if acc_rows % rr:
        raise ValueError(f"{acc_rows} rows are not whole blocks of R={rr}")
    blocks = acc_rows // rr
    if off.size and (off.min() < 0 or off.max() >= blocks):
        raise ValueError(f"block offsets must lie in [0, {blocks}), got "
                         f"[{off.min()}, {off.max()}]")
    return off.astype(np.int32)


def scatter_plan(offs, acc_rows: int, rr: int = RR
                 ) -> tuple[np.ndarray, np.ndarray]:
    """The L2 scatter's plan from the slabs' block offsets (in (chunk,
    slab) order): ``perm``, the slab indices sorted stably by destination
    block, and ``seg``, where each block's run starts in ``perm``
    (``acc_rows / rr + 1`` entries), both int32. Raises ``ValueError`` on
    an offset past the accumulator."""
    off = _block_offsets(offs, acc_rows, rr)
    perm = np.argsort(off, kind="stable")
    seg = np.searchsorted(off[perm], np.arange(acc_rows // rr + 1))
    return perm.astype(np.int32), seg.astype(np.int32)


def check_plan(b: dict, t: dict, device) -> None:
    """Raise ``ValueError`` unless the staged plan ``b`` is what the L2
    scatter reads: contiguous int32 tensors on ``device`` of the plan's
    sizes."""
    _build.check(b["perm"], "perm", torch.int32, device, t["slabs"])
    _build.check(b["seg"], "seg", torch.int32, device, t["blocks"] + 1)


def scatter_l2_cuda(b: dict, a: torch.Tensor, t: dict, staged_on=None,
                    passes: int = 1, out=None) -> torch.Tensor:
    """Launch the L2 scatter on the staged plan ``b``: the accumulator
    [acc_rows, F] after ``passes`` sweeps, into ``out`` when given (every
    element written). ``staged_on``: the device on which ``check_plan``
    has accepted ``b`` (at bind); it is then not checked again."""
    if not a.is_cuda:
        raise ValueError(f"scatter_l2_cuda needs a CUDA tensor, got "
                         f"{a.device}")
    dev = a.device if staged_on is None else staged_on
    rr, F = t["rr"], a.shape[-1]
    if a.dim() != 3 or a.shape[1] % rr or F % L2_FT or \
            a.shape[0] * a.shape[1] // rr != t["slabs"]:
        raise ValueError(f"scatter: slabs {tuple(a.shape)} for a plan of "
                         f"{t['slabs']} slabs of R={rr} rows, F a multiple "
                         f"of {L2_FT}")
    _build.check(a, "a", torch.float32, dev)
    if staged_on is None:
        check_plan(b, t, dev)
    o = _build.output(out, (t["blocks"] * rr, F), dev)
    if passes == 0:
        return o.zero_()
    ctas = min(t["blocks"] * (F // L2_FT), L2_CTAS_PER_SM * _sms(dev))
    _build.launch("loops_scatter_l2", "l2_scatter", dev, b["perm"], b["seg"],
                  a, o, t["blocks"], rr, F, passes, ctas)
    return o


def l2_scatter(offs, acc_rows: int, rr: int = RR, device="cuda"):
    """Build ``(bufs, fn(bufs, a, passes=1, out=None))`` for the L2
    scatter at the block offsets ``offs``: the plan (``scatter_plan``)
    staged on ``device`` and checked there once (``_build.staged_guard``);
    ``fn`` runs the kernel on CUDA tensors and ``scatter_plain`` on CPU
    ones."""
    device = ensure_platform(device)
    off = _block_offsets(offs, acc_rows, rr)
    perm, seg = scatter_plan(off, acc_rows, rr)
    bufs = {"perm": torch.from_numpy(perm).to(device),
            "seg": torch.from_numpy(seg).to(device)}
    t = dict(slabs=len(perm), blocks=acc_rows // rr, rr=rr)
    staged_on = _build.staged_guard(bufs, t, check_plan)
    off_cpu = torch.from_numpy(off)

    def fn(b, a, passes=1, out=None):
        if a.device.type == "cpu":
            return scatter_plain(off_cpu, a, acc_rows, passes, rr)
        return scatter_l2_cuda(b, a, t, staged_on(b), passes, out)
    fn.staged_on = staged_on
    fn.meta = dict(t)
    return bufs, fn


def _smem_shapes(a: torch.Tensor, acc_rows: int, rr: int = RR
                 ) -> tuple[int, int]:
    """``(chunks, F)`` of the slabs ``a`` [nch, KCH * R, F]; raises
    ``ValueError`` on what the smem kernel does not take: other than KCH
    slabs of R rows a chunk, F not a multiple of ``SMEM_FT``, rows not
    whole blocks, or an accumulator and ring past a CTA's 227 KB."""
    if a.dim() != 3 or rr != RR or a.shape[1] != KCH * RR or \
            a.shape[2] % SMEM_FT or acc_rows <= 0 or acc_rows % rr:
        raise ValueError(f"scatter: slabs {tuple(a.shape)} with R={rr}, "
                         f"{acc_rows} rows; the smem kernel takes chunks of "
                         f"{KCH} slabs of R={RR} rows, F a multiple of "
                         f"{SMEM_FT}")
    if (acc_rows + SMEM_STAGES * KCH * RR) * SMEM_FT * 4 > 227 * 1024:
        raise ValueError(f"{acc_rows} x {SMEM_FT} f32 and a ring of "
                         f"{SMEM_STAGES} stages are past a CTA's 227 KB of "
                         "shared memory")
    return a.shape[0], a.shape[2]


def check_offs(b: dict, t: dict, device) -> None:
    """Raise ``ValueError`` unless the staged offsets ``b`` are what the
    smem scatter reads: a contiguous, 16-byte aligned int32 tensor on
    ``device``, one offset a slab."""
    _build.check(b["offs"], "offs", torch.int32, device, t["slabs"])
    if b["offs"].data_ptr() % 16:
        raise ValueError("offs must be 16-byte aligned")


def _cluster_workspace(ws: dict, t: dict, F: int, device):
    """The smem scatter's cluster rows and tickets at width ``F``, made
    once into ``ws`` (the tickets zeros, which the kernel leaves zero)."""
    key = (F, device)
    if key not in ws:
        ws[key] = (torch.empty(t["groups"] // t["cluster"], t["acc_rows"], F,
                               device=device),
                   torch.zeros(F // SMEM_FT * t["cluster"], dtype=torch.int32,
                               device=device))
    return ws[key]


def scatter_smem_cuda(b: dict, a: torch.Tensor, t: dict, staged_on=None,
                      passes: int = 1, out=None, ws=None) -> torch.Tensor:
    """Launch the smem scatter on the staged offsets ``b``: the
    accumulator [acc_rows, F] after ``passes`` sweeps, into ``out`` when
    given (every element written), in the order ``scatter_smem_order``
    gives. ``staged_on``: the device on which ``check_offs`` has accepted
    ``b`` (at bind); ``ws``: where the cluster rows are kept between
    calls."""
    if not a.is_cuda:
        raise ValueError(f"scatter_smem_cuda needs a CUDA tensor, got "
                         f"{a.device}")
    dev = a.device if staged_on is None else staged_on
    nch, F = _smem_shapes(a, t["acc_rows"], t["rr"])
    if nch * KCH != t["slabs"]:
        raise ValueError(f"scatter: {nch} chunks of slabs for {t['slabs']} "
                         "offsets")
    _build.check(a, "a", torch.float32, dev)
    if a.data_ptr() % 16:
        raise ValueError("a must be 16-byte aligned")
    if staged_on is None:
        check_offs(b, t, dev)
    o = _build.output(out, (t["acc_rows"], F), dev)
    cpart, tickets = _cluster_workspace({} if ws is None else ws, t, F, dev)
    _build.launch("loops_scatter_smem", "smem_scatter", dev, b["offs"], a, o,
                  cpart, tickets, nch, F, t["acc_rows"], passes, t["groups"])
    return o


def smem_scatter(offs, acc_rows: int, rr: int = RR, device="cuda"):
    """Build ``(bufs, fn(bufs, a, passes=1, out=None))`` for the smem
    scatter at the block offsets ``offs`` (checked on the host to lie in
    the accumulator): the offsets staged on ``device`` and checked there
    once (``_build.staged_guard``); ``fn`` runs the kernel on CUDA tensors
    and ``scatter_plain`` on CPU ones. ``fn.meta`` holds the launch:
    ``groups`` and ``cluster``."""
    device = ensure_platform(device)
    off = _block_offsets(offs, acc_rows, rr)
    bufs = {"offs": torch.from_numpy(off).to(device)}
    t = dict(slabs=len(off), acc_rows=acc_rows, rr=rr, groups=SMEM_GROUPS,
             cluster=SMEM_CLUSTER)
    staged_on = _build.staged_guard(bufs, t, check_offs)
    off_cpu = torch.from_numpy(off)
    ws = {}

    def fn(b, a, passes=1, out=None):
        if a.device.type == "cpu":
            return scatter_plain(off_cpu, a, acc_rows, passes, rr)
        return scatter_smem_cuda(b, a, t, staged_on(b), passes, out, ws)
    fn.staged_on = staged_on
    fn.meta = dict(t)
    return bufs, fn


def smem_clusters(acc_rows: int = SMEM_ROWS, device="cuda") -> int:
    """How many clusters of the smem scatter (``SMEM_CLUSTER`` CTAs each)
    the card runs at once (``cudaOccupancyMaxActiveClusters``)."""
    device = ensure_platform(device)
    with torch.cuda.device(device):
        n = _build._function("loops_scatter_smem_clusters")(acc_rows)
    if n < 0:
        raise RuntimeError(f"loops_scatter_smem_clusters: CUDA error {-n}")
    return n


def scatter_cuda(offs, a: torch.Tensor, acc_rows: int, passes: int = 1,
                 rr: int = RR) -> torch.Tensor:
    """One call of the smem scatter (bound for this call through
    ``smem_scatter``): the accumulator [acc_rows, F] after ``passes``
    sweeps."""
    if a.device.type != "cuda":
        raise ValueError(f"scatter_cuda needs a CUDA tensor, got {a.device}")
    _smem_shapes(a, acc_rows, rr)
    bufs, fn = smem_scatter(offs, acc_rows, rr, a.device)
    return fn(bufs, a, passes)


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


def scatter_sequential(offs, a, acc_rows: int, passes: int = 1,
                       rr: int = RR) -> np.ndarray:
    """The sequential loop in numpy f32: for each pass, chunk and slab in
    order, its R rows added into the block at its offset. The order the
    L2 scatter keeps: its result equals this bit for bit."""
    off = np.asarray(offs).reshape(-1)
    a = np.asarray(a, np.float32)
    slabs = a.reshape(len(off), rr, a.shape[-1])
    acc = np.zeros((acc_rows, a.shape[-1]), np.float32)
    for _ in range(passes):
        for s, o in enumerate(off):
            acc[o * rr:(o + 1) * rr] += slabs[s]
    return acc


def scatter_smem_order(offs, a, acc_rows: int, passes: int = 1,
                       groups: int = SMEM_GROUPS, cluster: int = SMEM_CLUSTER,
                       rr: int = RR) -> np.ndarray:
    """The order the smem scatter keeps, in numpy f32: group g's
    accumulator is the sequential loop (``scatter_sequential``) over its
    chunks g, g + groups, ...; a cluster's sum is its groups'
    accumulators added in rank order from the first, and the result the
    clusters' sums added in cluster order. The kernel's result equals
    this bit for bit."""
    a = np.asarray(a, np.float32)
    per = np.asarray(offs).reshape(a.shape[0], -1)
    accs = [scatter_sequential(per[g::groups], a[g::groups], acc_rows,
                               passes, rr) for g in range(groups)]
    sums = []
    for k in range(0, groups, cluster):
        s = accs[k]
        for q in range(k + 1, k + cluster):
            s = s + accs[q]
        sums.append(s)
    out = sums[0]
    for s in sums[1:]:
        out = out + s
    return out


def scatter(offs, a, acc_rows, smem=True, passes=1) -> torch.Tensor:
    """One call of either accumulator (bound for this call through
    ``smem_scatter`` or ``l2_scatter``); the plain version on CPU
    tensors."""
    if a.device.type == "cpu":
        return scatter_plain(offs, a, acc_rows, passes)
    bufs, fn = (smem_scatter if smem else l2_scatter)(offs, acc_rows,
                                                      device=a.device)
    return fn(bufs, a, passes)


def probe_scatter(smem: bool, device, out=print, timed=True,
                  nch: int = NCH_SCATTER) -> dict:
    """Check one accumulator: exact on integer slabs, and bit for bit on
    the script's normal slabs over 1 and 3 passes against the order it
    keeps (the L2 one ``scatter_sequential``, the smem one
    ``scatter_smem_order``; on the CPU the plain version runs, and is held
    to the sequential loop it computes); the record then has
    ``order_checked``. Then time one pass with the L2 emptied first
    (``cold_ms``) beside its plain version and the library call
    (``index_add_`` into a zeroed accumulator), and the slope over passes
    2 and 10 (warm: part of the slabs still in the L2 from the pass
    before)."""
    acc_rows = SMEM_ROWS if smem else L2_ROWS
    offs, a = (torch.from_numpy(v).to(device)
               for v in scatter_inputs(acc_rows, nch))
    plan, fn = (smem_scatter if smem else l2_scatter)(offs, acc_rows,
                                                      device=device)

    def run(n):
        return fn(plan, a, n)
    name = "smem_scatter" if smem else "l2_scatter"
    err = hold(name, launch_twice(lambda: run(1)),
               scatter_plain(offs, a, acc_rows))
    offs_n, a_n = scatter_inputs(acc_rows, nch, normal=True)
    an = torch.from_numpy(a_n).to(device)
    on_card = an.is_cuda
    for passes in (1, 3):
        if smem and on_card:
            want = scatter_smem_order(offs_n, a_n, acc_rows, passes,
                                      fn.meta["groups"], fn.meta["cluster"])
        else:
            want = scatter_sequential(offs_n, a_n, acc_rows, passes)
        hold(f"{name} normal, {passes} passes", fn(plan, an, passes),
             torch.from_numpy(want).to(device))
    del an
    order = ("  group order bit for bit (normal, 1 and 3 passes)"
             if smem and on_card else
             "  sequential order bit for bit (normal, 1 and 3 passes)")
    ms = plain_ms = lib_ms = warm = None
    if timed:
        ms = cold_ms(lambda: run(1), device)
        plain_ms = cold_ms(lambda: scatter_plain(offs, a, acc_rows), device)
        rows = (offs.long()[:, None] * RR
                + torch.arange(RR, device=a.device)).reshape(-1)
        acc, flat = a.new_zeros(acc_rows, FT), a.reshape(-1, FT)
        lib_ms = cold_ms(lambda: acc.index_add_(0, rows, flat), device)
        del acc, rows
        warm = run_slope_ms(run, 2, 10, 3, a.is_cuda)
    where = (f"smem acc [{acc_rows}x{SMEM_FT}] per CTA" if smem
             else f"L2 acc [{acc_rows}x{FT}] in device memory")
    us = ms * 1e3 / nch if timed else None
    line = (f"scatter kch={KCH} R={RR} FT={FT} {where}: "
            + (f"{us:.3f} us/chunk ({us / KCH * 1e3:.1f} ns per (R,FT) "
               f"add), one pass from an empty L2 {ms:.4f} ms, warm "
               f"{warm:.4f} ms a pass (slope over passes)" if timed
               else f"({nch} chunks)")
            + "  exact=True" + order)
    out(line)
    nbytes = 4 * (a.numel() + offs.numel() + acc_rows * FT)
    rec = record(name, "smem 256x64" if smem else "L2 4096x512", ms,
                 plain_ms, lib_ms, nbytes, a.numel(), "f32", err, line)
    rec["order_checked"] = True
    return rec


# ------------------------------------------------------------- dispatch
def probe_dispatch(device, out=print, launches: int = 200) -> dict:
    """Host microseconds per call of K12 on [8, 128] through
    ``saxpy_cuda`` (``_build.call``, the launch binding), and of
    ``torch.add`` on the same tensors: the enqueue of ``launches`` calls
    in a row by the host clock, and the least and median of 10 single
    calls each followed by a synchronize."""
    x = torch.zeros(8, 128, device=device)
    y = torch.ones(8, 128, device=device)
    calls = {"K12 saxpy_cuda": (lambda: saxpy_cuda(1.0, x, y))
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
    """K11 over the script's [32768, 512] f32 array (64 MiB): the warm
    slope over passes (partly read from the 50 MB L2) and one pass from an
    empty L2 (``cold_ms``), beside the byte bound; returns the warm
    rate."""
    x = stream_input(rows, 512, device)
    ms = pass_ms(x)
    cold = cold_ms(lambda: stream_read(x), device)
    work = counters.stream_read_work(x.numel() * 4)
    bound, _ = counters.bound_of(work)
    gbps = x.numel() * 4 / ms / 1e6
    out(f"stream_read (K11): {ms:.4f} ms per {x.numel() * 4 / 2**20:.0f}MB "
        f"pass warm (slope over passes) -> {gbps:.1f} GB/s achievable; "
        f"{cold:.4f} ms one pass from an empty L2; byte bound "
        f"{bound:.4f} ms")
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
