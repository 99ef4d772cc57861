#!/usr/bin/env python3
"""Smoke run of loops_tpu_torch, the PyTorch + CUDA port, on one NVIDIA card.

    python3 chip_smoke.py

Phases, one line each with its time:

1. card:   ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build:  nvcc builds the kernels from ``loops_tpu_torch/csrc`` (one nvcc
   per source, in parallel, then one link): K1–K3, K4, K6–K9, K5, K10
   and K11;
3. kernels vs plain: K1 (``sorted_spmv``), K2 (``flat_spmv_v2``) and K3
   (``flat_spmv``) against their plain PyTorch versions on the same staged
   buffers, on the 9-matrix battery (blocks 8 and 1024), on the bench
   matrix (32768^2, ~4.39M nnz), on ``generate.SPMV_EDGE_CASES`` (empty
   rows between blocks, before the first, after the last; blocks 8 and
   64) and, for K2 and K3, on one work_oriented block over a 40064-row
   window: agreement, the Wilkinson verdict, two runs bitwise equal, the
   launch counter, and each kernel once more into a y filled with NaN
   (each writes every row of a ``torch.empty`` y);
4. main path: ``examples/spmv_torch.py`` on ``datasets/chesapeake.mtx`` with
   ``--validate --rigorous`` for every schedule and kernel impl;
5. at scale: ``SpMVOperator`` with each kernel on the bench matrix and on
   2097152^2 with ~33.5M nnz, each result validated. The launch counters are
   set to 0 before phase 4 and read after phase 5: every kernel must have
   launched on the main path;
6. timing: per apply, the median of CUDA-event timings, of each kernel, its
   plain version and cuSPARSE's CSR SpMV (the paper's opponent, timed only),
   with the host plan time; each kernel's time on the card alone
   (``utils/bench.device_ms``: the applies queued behind a sleep kernel)
   and its host share ``1 - device / apply``; and the host launch path
   taken apart (``utils/launch_cost.py``: host microseconds per call of
   each part and of the whole calls of K1, K12 and ``torch.add``);
7. K4 vs plain: K4 (``flat_spmm``) against its plain PyTorch version on the
   battery, the merge-path edge cases (``generate.SPMM_EDGE_CASES``: a row
   over several warps and blocks, a run of empty rows past a block's work,
   empty rows at the end), the bench matrix and the full-width
   arxiv-shaped GCN adjacency (169,343 nodes, 2,465,171 nonzeros), F in
   {5, 40, 128}, f32 and bf16, blocks 8 and 512, and its backward (K4
   over the transpose of the masked ``A[train_rows, :]``, through
   autograd): bit for bit, with the memory C reuses filled with NaN first
   (so a row the kernel skips shows), the Wilkinson verdict (over 256
   sampled rows past 10^6 nonzeros), two applies bitwise equal, the
   launch counter;
8. GCN inference at full width: ``models.train.evaluate`` (dims
   [128, 128, 128, 40]) on the val and test masks through K4, its logits
   held against the same weights on ``schedule="group_mapped"``;
9. GCN training at full width: the bench's throughput form (bf16,
   ``precompute_first``, ``loss_rows``) for 10 steps of
   ``make_train_step``, then ``examples/train_gcn_torch.py --dataset
   ogbn-arxiv --scale 1.0 --epochs 20``. The launch counters are set to 0
   before phase 8 and read after phase 9: K4 must have launched, and every
   operator of the models must have taken it;
10. timing on the arxiv adjacency at F = 128, f32 and bf16: K4, its plain
   version, ``group_mapped``, ``row_mapped`` and cuSPARSE
   (``torch.sparse.mm``, timed only), with the host plan time; one GCN
   train step of each form and one full-graph ``evaluate`` (CUDA events
   around each call, median), a ``torch.profiler`` breakdown of a step
   and an ``evaluate`` (read only where the trace holds every launch the
   counters saw, else "not measured"), and the step's card time by
   ``utils/bench.device_ms`` beside ``apply_ms`` of the same calls
   queued, and the share in which the card waits;
11. K6–K9 vs plain: K6 (``bcsr_spmv``), K9 (``bcsr_spmm``), K8
   (``bcsr_spmm_v2``) and K7 (``bcsr_spmm_v3``) against their plain PyTorch
   versions on the same staged buffers: the five matrices of
   ``tests/test_bcsr_kernels.py`` in blocks 8x128 and 16x128, F in {20,
   300, 513} at ``block_f`` 128, f32 and (K7, K8) bf16; K7, K8 and K9
   also on the edge cases of ``tests/test_torch_cuda_bcsr.py`` (``cols``
   not a multiple of C, empty block rows and empty super-rows, chunks of
   one block, super-rows of two block rows, F in {20, 513}), and each
   (K6 on every matrix) into a NaN-filled ``out=``; then the
   bench's two regimes (16384^2 in 8x128 blocks at ~6% fill, F = 512;
   32768^2 at 1.5% for K6): agreement, the Wilkinson verdict (over sampled
   rows at bench scale), two applies bitwise equal, the launch counter;
12. the BCSR main path: ``examples/spmm_torch.py --format bcsr`` with
   ``--impl pallas`` and with the torch path, ``SpMVOperator(bcsr,
   impl="pallas")`` on the 32768^2 regime, and ``SpMMOperator`` with
   ``pallas3`` (f32 and bf16), ``pallas2`` (f32 and bf16) and ``pallas``
   on the 16384^2, F = 512 regime, each checked in f64 on 256 sampled
   rows. The launch counters are set to 0 before and read after: each of
   K6–K9 must have launched;
13. timing of K6–K9 (plain, kernel, kernel, plain), cuSPARSE on the CSR
   form of the same matrix and ``torch.sparse_bsr_tensor`` (timed only),
   the host staging time, GFLOP/s as the JAX bench reports it, and the
   bound; K6's card time warm (``utils/bench.device_ms``) and from an
   empty L2 (``cold_ms``, the regime of its byte bound: its 64 MB of
   blocks are 1.3 times the L2) beside its apply and cuSPARSE's CSR SpMV
   from an empty L2; a ``torch.profiler`` breakdown of each f32 apply;
14. stream: K11 (``stream_read``) against its plain version
   (``torch.sum``) over 64 MiB (the JAX bench's array) and 1 GiB of
   integers in [-8, 8], where both must give the integer total exactly,
   and the read rate of each by the slope of 616 passes against 16; the
   1 GiB rate
   is the measured bound printed beside the nominal one;
15. K5 and K10 vs plain: K5 (``sddmm_flat``) on the three matrices of
   ``tests/test_spmm_sddmm.py:191-198`` and the SpMV battery, F in {1, 20,
   33, 64, 128, 300}, and with an A one float off 16-byte alignment; K10
   (``sddmm_bcsr``) on the five BCSR matrices in 8x128 and 16x128 blocks,
   F in {20, 300}, and on the edge cases (``cols`` not a multiple of C,
   empty block rows; blocks of 8, 16, 24 and 72 rows and 256 columns; F
   in {1, 20, 513}), each also into a NaN-filled ``out=``; then the
   regimes of phase 16 (over 4096 sampled nonzeros): agreement, the
   Wilkinson verdict, two applies bitwise equal, the launch counter;
16. the SDDMM main path at full size: ``measure_stream_gbps`` at 64 MiB
   (the JAX bench's first step) and at 1 GiB,
   ``sddmm(..., impl="pallas", dtype="bfloat16")`` on the JAX bench's 65536^2 regime (2,469,272 nonzeros, F = 128) and on the
   arxiv adjacency, ``sddmm(bcsr, impl="pallas", block_f=512)`` on the
   16384^2 BCSR regime (F = 512), COO and ``xla`` on the arxiv adjacency,
   and ``scripts/primitives_torch.py``, each checked in f64 on sampled
   nonzeros. The launch counters are set to 0 before and read after: K5,
   K10 and K11 must have launched;
17. timing of K5 and K10 (plain, kernel, kernel, plain), the torch
   ``xla`` paths, cuSPARSE's SDDMM (``torch.sparse.sampled_addmm`` times
   vals, timed only), the host staging time, the bound at the nominal and
   the measured rate, a ``torch.profiler`` breakdown of one apply (or "not
   measured") and the apply's card time by ``utils/bench.device_ms``
   beside ``apply_ms`` of the same calls queued, and the share in which
   the card waits;
18. K12 and K2 vs plain: K12 (``saxpy``) bitwise against ``a * x + y``
   at the example's [8, 8192], at odd sizes and on an unaligned view; K2
   against its plain version again, its scan now in
   ``csrc/seg_scan.cuh``; and ``torch.matmul`` with TF32 allowed, which
   the dots' check (below) must refuse;
19. the tier's path: ``examples/saxpy_torch.py``, ``range_torch.py``,
   ``custom_layout_torch.py`` and ``scripts/h100_probes.py`` at the TPU
   scripts' sizes. Each probe holds its kernels (K13 ``seg_scan_probe``
   and ``construct_probe``, K14 ``block_dot_f32``/``_bf16``,
   ``smem_scatter``, ``l2_scatter``, K15 ``gather_axis0``/``1``,
   ``row_gather_*`` per residency, ``onehot_expand``) to their plain
   versions on the TPU scripts' seeded inputs: exact (constructs,
   gathers, scatters, one-hot expand, the scan and the dots on integer
   values), the scan at ``atol 1e-4``, ``dot0`` at ``1e-5``, the dots on
   normal values within ``r2.DOT_C`` units of ``u32 sqrt(sum (a b)^2)``
   of their float64 reference, ``l2_scatter`` on the script's normal
   values bit for bit against the sequential (pass, chunk, slab) order
   computed on the CPU and ``smem_scatter`` against its group order
   (``r2.scatter_smem_order``; 1 and 3 passes); K13's bound forms
   (``seg_scan_bind``, ``construct_bind``) bitwise equal to the unbound
   calls; ``launch_floor`` (one CTA of 32 threads writing one word)
   exact; two launches bitwise equal.
   G1 (``row_gather_sum_*``) is held bit for bit on the script's normal
   slab as well as on its integer one.
   Then it times each by slope (launches or passes; the scatters and
   ``gather_axis0`` by one call from an empty L2, as their byte bounds
   assume) beside its plain
   version and its library call, prints the launch floor by
   ``torch.profiler`` (median over 400 launches) and by CUDA events over
   400 launches queued back to back, K13's calls unbound and bound (into
   ``out=``) with each kernel's device time against the floor and each
   construct's library call (``clone``, ``torch.matmul``, else none), the
   smem scatter from an empty L2 against its byte bound and
   ``index_add_`` with its clusters, ``onehot_expand`` at W = 128, 512
   and 2048 against ``index_select`` and its byte bound, G1 (K = 128 f32)
   at each residency against ``embedding_bag`` and its byte bound, with
   its rate of row reads beside K11's at 64 MiB, ``gather_axis0`` at each
   S against ``take_along_dim`` and its byte bound, and the two
   kernels redesigned last (``onehot_expand`` at W = 512 against
   ``index_select``; ``bcsr_spmv`` from an empty L2 against cuSPARSE's
   CSR SpMV and ``torch.sparse_bsr_tensor``). The launch counters are set
   to 0 before and read after: every K12-K15 kernel must have launched.

Each kernel's bound is the larger of its bytes (each input read once,
each output written once) over 3.35 TB/s and its flops over the H100
SXM's peak for its type (67 TFLOP/s f32 on the CUDA cores, 989 bf16)
(``bound_ms`` in the kernels line), and of the launch floor measured in
phase 19 (``launch_floor_ms`` beside it): the check below and the printed
shares take the larger. Every time compared with it is per call or per
pass, never under the device time of one launch.

The kernel-vs-plain tolerance is twice the Wilkinson bound the validator
uses (``2 * 4 * nnz_row * u * sum|a*x|``, floor 1e-6): both results lie
within one bound of the exact row sum, whatever their summation order.
For K4 in bf16 the bound is over the bf16-rounded products, which both
sides form identically; for K7/K8 in bf16 over the bf16-rounded A and B,
whose products are exact in f32. For K5 and K10 the bound is per output,
``2 * 4 * F * u * sum_f |term|`` (floor 1e-6), over K5's bf16-rounded
terms, which both sides form identically.

It exits non-zero, and prints no result, when no card is visible, any
phase fails or a kernel's time is under its nominal bound. The line before the last is a JSON object with one entry per
kernel; the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SOURCE = "loops_tpu_torch/csrc/spmv.cu"
KERNELS = {
    # name -> (TPU kernel it replaces, SpMVOperator schedule, impl)
    "sorted_spmv": ("loops_tpu/ops/kernels/spmv_sorted.py:325",
                    "sorted_flat", "xla"),
    "flat_spmv_v2": ("loops_tpu/ops/kernels/spmv_flat_v2.py:88",
                     "merge_path", "pallas2"),
    "flat_spmv": ("loops_tpu/ops/kernels/spmv_flat.py:41",
                  "merge_path", "pallas"),
}
CLI_CASES = [
    ["--schedule", "row_mapped"], ["--schedule", "group_mapped"],
    ["--schedule", "work_oriented"], ["--schedule", "merge_path"],
    ["--schedule", "merge_path", "--impl", "pallas"],
    ["--schedule", "merge_path", "--impl", "pallas2"],
    ["--schedule", "sorted_flat"], ["--schedule", "auto"],
]
BENCH_BLOCK = 1024
SPMM_SOURCE = "loops_tpu_torch/csrc/spmm.cu"
SPMM_REPLACES = "loops_tpu/ops/kernels/spmm_flat.py:48"
SPMM_FS = (5, 40, 128)
SPMM_BLOCKS = (8, 512)
DTYPES = (None, "bfloat16")
GCN_HIDDEN = 128
BCSR_SOURCE = "loops_tpu_torch/csrc/bcsr.cu"
BCSR_KERNELS = {
    # name -> (TPU kernel it replaces, operator impl, modes)
    "bcsr_spmv": ("loops_tpu/ops/kernels/spmv_bcsr.py:43", "pallas", (None,)),
    "bcsr_spmm": ("loops_tpu/ops/kernels/spmm_bcsr.py:60", "pallas", (None,)),
    "bcsr_spmm_v2": ("loops_tpu/ops/kernels/spmm_bcsr_v2.py:33", "pallas2",
                     DTYPES),
    "bcsr_spmm_v3": ("loops_tpu/ops/kernels/spmm_bcsr_v3.py:100", "pallas3",
                     DTYPES),
}
BCSR_BLOCKS = ((8, 128), (16, 128))
BCSR_FS = (20, 300, 513)
# K7's, K8's and K9's edge cases (tests/test_torch_cuda_bcsr.py): B's rows
# past the last full block column, empty block rows and, at two block rows
# a super-row, empty super-rows; chunks of one and of two blocks (K7)
BCSR_EDGE_FS = (20, 513)
K7_EDGE_TILES = ({}, {"super_rows": 2, "chunk_blocks": 1},
                 {"super_rows": 2, "chunk_blocks": 2})
K8_EDGE_TILES = ({}, {"super_rows": 2})
# the JAX bench's regimes (bench.py:226-228, :371-372)
SPMM_REGIME = dict(N=16384, R=8, C=128, block_density=0.06)
SPMM_F = 512
SPMV_REGIME = dict(N=32768, R=8, C=128, block_density=0.015)
SDDMM_SOURCE = "loops_tpu_torch/csrc/sddmm.cu"
SDDMM_KERNELS = {
    # name -> TPU kernel it replaces
    "sddmm_flat": "loops_tpu/ops/kernels/sddmm_flat.py:49",
    "sddmm_bcsr": "loops_tpu/ops/kernels/sddmm_bcsr.py:24",
}
K5_FS = (1, 20, 33, 64, 128, 300)
K10_FS = (20, 300)
# K10's edge cases (tests/test_torch_cuda_sddmm.py) on the BCSR edge
# matrices: blocks of 24 rows (part of a CTA's rows unused), 72 (one block
# over two CTA row slices) and 256 columns (two column slices), F ragged
# and past the feature tile
K10_EDGE_BLOCKS = ((8, 128), (16, 128), (24, 128), (72, 128), (8, 256))
K10_EDGE_FS = (1, 20, 513)
# bench.py:423-432: the SDDMM regime, nothing reduced
SDDMM_REGIME = dict(rows=65536, cols=65536, sparsity=2.47e6 / 65536 ** 2,
                    seed=6)
SDDMM_F = 128
STREAM_SOURCE = "loops_tpu_torch/csrc/stream.cu"
STREAM_REPLACES = "bench.py:122"
# the JAX bench's 64 MiB array, and 1 GiB, far past the 50 MB L2
STREAM_SHAPES = {"64 MiB": (32768, 512), "1 GiB": (524288, 512)}
# K12-K15: kernel -> (source, the TPU kernel it replaces)
PROBE_KERNELS = {
    "saxpy": ("loops_tpu_torch/csrc/saxpy.cu", "examples/saxpy.py:26"),
    "seg_scan_probe": ("loops_tpu_torch/csrc/probes.cu",
                       "scripts/tpu_mosaic_probe2.py:23"),
    "construct_probe": ("loops_tpu_torch/csrc/probes.cu",
                        "scripts/tpu_mosaic_probe.py:24"),
    # the launch K13's kernels are bound by; the TPU scripts timed it as
    # dispatch_probe
    "launch_floor": ("loops_tpu_torch/csrc/probes.cu",
                     "scripts/tpu_r2_probe.py:200"),
    **{k: ("loops_tpu_torch/csrc/probes_r2.cu", "scripts/tpu_r2_probe.py:90")
       for k in ("block_dot_f32", "block_dot_bf16")},
    **{k: ("loops_tpu_torch/csrc/probes_r2.cu", "scripts/tpu_r2_probe.py:148")
       for k in ("smem_scatter", "l2_scatter")},
    "gather_axis0": ("loops_tpu_torch/csrc/probes_gather.cu",
                     "scripts/tpu_r3_gather_probe.py:37"),
    "gather_axis1": ("loops_tpu_torch/csrc/probes_gather.cu",
                     "scripts/tpu_r3_gather_probe.py:77"),
    **{f"row_gather_{m}_{w}": ("loops_tpu_torch/csrc/probes_gather.cu",
                               "scripts/tpu_r4_gather_probe.py:56")
       for m in ("sum", "mat") for w in ("smem", "l2", "hbm")},
    "onehot_expand": ("loops_tpu_torch/csrc/probes_gather.cu",
                      "scripts/tpu_r4_gather_probe.py:121"),
}
# the case of each probe kernel that stands for it in the kernels line:
# the block dots with B streamed, where every chunk's product is needed
PROBE_ENTRIES = {"seg_scan_probe": "seg_scan", "construct_probe": "constructs",
                 "launch_floor": "one word",
                 "block_dot_f32": "M=128 streamB",
                 "block_dot_bf16": "M=128 streamB",
                 "smem_scatter": "smem 256x64", "l2_scatter": "L2 4096x512",
                 "gather_axis0": "S=256", "gather_axis1": "S=256",
                 "row_gather_sum_smem": "S=256 K=128 f32",
                 "row_gather_sum_l2": "S=4096 K=128 f32",
                 "row_gather_sum_hbm": "S=2097152 K=128 f32",
                 "row_gather_mat_smem": "S=256 K=64 f32",
                 "row_gather_mat_l2": "S=4096 K=64 f32",
                 "row_gather_mat_hbm": "S=2097152 K=64 f32",
                 "onehot_expand": "W=512"}
SAXPY_SHAPE = (8, 8192)  # examples/saxpy.py: n = 1 << 16 as [8, n / 8]
# H100 SXM at 700 W (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {None: 67e12, "bfloat16": 989e12}


class PhaseFailed(RuntimeError):
    pass


def require(cond, msg):
    if not cond:
        raise PhaseFailed(msg)


def phase(n, name, t0, detail=""):
    print(f"phase {n} {name}: ok {detail}({time.perf_counter() - t0:.2f} s)",
          flush=True)


def profile_text(r, top, width=40):
    """A ``profile_applies`` result as one line; where the profiler's
    trace lacks launches (empty, fewer than the wrappers counted, or not
    a whole number per apply), only the wall time stands."""
    wall = f"wall {r['wall_ms']:.4f} ms"
    if r["not_measured"]:
        return (f"{wall}, device time not measured ("
                + "; ".join(r["not_measured"][:4]) + ")")
    return (f"{wall}, device {r['device_ms']:.4f} ms, idle "
            f"{r['idle_share']:.1%}; "
            + "; ".join(f"{name[:width]} x{n:g} {ms:.4f} ms"
                        for name, n, ms in r["kernels"][:top]))


def card_text(fn, x):
    """The card's own ms per ``fn(x)`` (``utils/bench.device_ms``: calls
    queued behind a sleep kernel) beside the ms per call of the same calls
    queued back to back (``apply_ms``), and the share of the latter in
    which the card waits for the host: a device time that no dropped
    trace event can shorten. A negative share shows the pair disagrees."""
    from loops_tpu_torch.utils.bench import apply_ms, device_ms

    card = device_ms(fn, x, applies=10)
    queued = apply_ms(fn, x, iters=10)
    return (f"card {card:.4f} ms (device_ms), queued {queued:.4f} ms "
            f"(apply_ms), card waits {1 - card / queued:.1%}")


def pair_tolerance(csr, x):
    """Twice the validator's Wilkinson bound per row, floor 1e-6."""
    from loops_tpu_torch.utils import reference

    l1 = reference.row_l1_products(csr, x)
    nnz_r = csr.row_sizes().astype(np.float64)
    u = reference.unit_roundoff(np.float32)
    return np.maximum(1e-6, 2 * reference.DEFAULT_WILKINSON_K * nnz_r * u * l1)


def kernel_vs_plain(kname, csr, x, block, device, schedule="merge_path"):
    """Build one kernel's buffers, run kernel twice and plain once; return
    the max abs difference."""
    import torch

    from loops_tpu_torch.layout import CsrLayout
    from loops_tpu_torch.ops.kernels import _build, spmv_flat, spmv_flat_v2, spmv_sorted
    from loops_tpu_torch.schedule.plans import make_plan
    from loops_tpu_torch.utils import reference

    if kname == "sorted_spmv":
        b, fn = spmv_sorted.sorted_spmv(
            csr, device=device, **({"block_atoms": block} if block else {}))
        plain = lambda xd: spmv_sorted.sorted_spmv_plain(b, xd, None)  # noqa: E731
    else:
        block = block or BENCH_BLOCK
        plan = make_plan(CsrLayout.from_csr(csr), schedule,
                         **({"block_work": block} if schedule == "merge_path"
                            else {"block_atoms": block}))
        if kname == "flat_spmv_v2":
            b, fn = spmv_flat_v2.flat_spmv_v2(csr, plan, device=device)
            plain = lambda xd: spmv_flat_v2.flat_spmv_v2_plain(  # noqa: E731
                b, xd, csr.shape)
        else:
            b, fn = spmv_flat.flat_spmv(csr, plan, device=device)
            plain = lambda xd: spmv_flat.flat_spmv_plain(  # noqa: E731
                b, xd, csr.shape, fn.meta["R"])
    xd = torch.from_numpy(x).to(device)
    before = _build.LAUNCHES[kname]
    y1 = fn(b, xd)
    y2 = fn(b, xd)
    torch.cuda.synchronize()
    require(_build.LAUNCHES[kname] == before + 2,
            f"{kname}: launch counter did not go up by 2")
    require(torch.equal(y1, y2), f"{kname}: two runs are not bitwise equal")
    # the kernels allocate y with torch.empty: run into NaN-filled
    # memory, a row one leaves unwritten shows (NaN never compares equal)
    into = {"sorted_spmv": spmv_sorted.sorted_spmv_cuda,
            "flat_spmv_v2": spmv_flat_v2.flat_spmv_v2_cuda,
            "flat_spmv": spmv_flat.flat_spmv_cuda}[kname]
    nan = torch.full((csr.shape[0],), float("nan"), device=device)
    y3 = into(b, xd, fn.params, out=nan)
    require(y3.data_ptr() == nan.data_ptr() and torch.equal(y1, y3),
            f"{kname}: the apply into NaN-filled memory differs")
    y = y1.cpu().numpy()
    yp = plain(xd).cpu().numpy()
    diff = np.abs(y.astype(np.float64) - yp)
    require(np.all(np.isfinite(y)), f"{kname}: non-finite output")
    require(np.all(diff <= pair_tolerance(csr, x)),
            f"{kname}: kernel and plain differ by {diff.max():.3e}")
    rep = reference.rigorously_validate_spmv(csr, x, y)
    require(rep.verdict == "NOT_A_BUG", f"{kname}: {rep}")
    return float(diff.max(initial=0.0))


def spmm_pair_tolerance(csr, B, dtype):
    """Twice the Wilkinson bound over the products the mode forms, floor
    1e-6. In bf16, ``|bf16(a*b)| <= (1 + 2**-8) |a| |b|`` for the rounded
    ``a``, ``b`` bounds the rounded products' sum of magnitudes."""
    from loops_tpu_torch.formats import CSR
    from loops_tpu_torch.utils import reference

    if dtype is None:
        l1 = reference.spmm_l1_products(csr, B)
    else:
        rounded = CSR(csr.shape, csr.offsets, csr.indices,
                      reference.bf16_round(csr.vals))
        l1 = (1 + 2.0 ** -8) * reference.spmm_l1_products(
            rounded, reference.bf16_round(B))
    nnz_r = csr.row_sizes().astype(np.float64)[:, None]
    u = reference.unit_roundoff(np.float32)
    return np.maximum(1e-6, 2 * reference.DEFAULT_WILKINSON_K * nnz_r * u * l1)


def spmm_verdict(csr, B, C, dtype):
    from loops_tpu_torch.utils import reference

    if dtype is None:
        return reference.rigorously_validate_spmm(csr, B, C, mxu_bf16=False)
    return reference.rigorously_validate_spmm_bf16(csr, B, C)


def check_spmm(label, csr, B, C, C_plain, dtype):
    """K4's result against its plain version and the validator; returns
    the max abs difference."""
    require(C.shape == (csr.shape[0], B.shape[1]) and np.all(np.isfinite(C)),
            f"{label}: bad output")
    diff = np.abs(C.astype(np.float64) - C_plain)
    require(np.all(diff <= spmm_pair_tolerance(csr, B, dtype)),
            f"{label}: kernel and plain differ by {diff.max():.3e}")
    rep = spmm_verdict(csr, B, C, dtype)
    require(rep.verdict == "NOT_A_BUG", f"{label}: {rep}")
    return float(diff.max(initial=0.0))


# past this many nonzeros K4's checks hold it to its plain version bit for
# bit and validate 256 sampled rows: the full host validators take minutes
SAMPLED_NNZ = 1_000_000


def check_spmm_at_scale(label, csr, B, C, dtype):
    """K4's result (a card tensor, already equal to its plain version)
    against the f64 sums of 256 sampled rows; returns 0.0, the max
    |kernel - plain|."""
    from loops_tpu_torch.utils import reference

    require(tuple(C.shape) == (csr.shape[0], B.shape[1])
            and bool(C.isfinite().all()), f"{label}: bad output")
    rep = reference.validate_sampled_rows(csr, B, C,
                                          bf16_products=dtype is not None)
    require(rep.overruns == 0, f"{label}: {rep}")
    return 0.0


def spmm_vs_plain(label, csr, B, block, dtype, device):
    """K4 twice and its plain version once on the same staged buffers: bit
    for bit, and every row written (the memory C reuses holds NaN first).
    Returns the max abs difference from ``check_spmm``."""
    import torch

    from loops_tpu_torch.layout import CsrLayout
    from loops_tpu_torch.ops.kernels import _build, spmm_flat
    from loops_tpu_torch.schedule.plans import make_plan

    plan = make_plan(CsrLayout.from_csr(csr), "merge_path", block_work=block)
    b, fn = spmm_flat.flat_spmm(csr, plan, dtype=dtype, device=device)
    Bd = torch.from_numpy(B).to(device)
    torch.full((2 * csr.shape[0] * B.shape[1] + 1024,), float("nan"),
               device=device)
    before = _build.LAUNCHES["flat_spmm"]
    C1 = fn(b, Bd)
    C2 = fn(b, Bd)
    torch.cuda.synchronize()
    require(_build.LAUNCHES["flat_spmm"] == before + 2,
            f"{label}: launch counter did not go up by 2")
    require(torch.equal(C1, C2), f"{label}: two applies are not bitwise equal")
    plain = spmm_flat.flat_spmm_plain(b, Bd, csr.shape, dtype)
    require(torch.equal(C1, plain),
            f"{label}: K4 and its plain version differ by "
            f"{float((C1 - plain).abs().max()):.3e}")
    if csr.nnz > SAMPLED_NNZ:
        return check_spmm_at_scale(label, csr, B, C1, dtype)
    return check_spmm(label, csr, B, C1.cpu().numpy(), plain.cpu().numpy(),
                      dtype)


def backward_vs_plain(graph, rows, F, dtype, device):
    """The masked last layer's gradient through autograd: K4 over the
    transpose of ``A[rows, :]``, against its plain version."""
    import torch

    from loops_tpu_torch.models.message_passing import masked_aggregate_operator
    from loops_tpu_torch.ops.kernels import spmm_flat

    op = masked_aggregate_operator(graph, rows, dtype=dtype, device=device)
    bwd = op._vjp_op
    require(op.impl_used == bwd.impl_used == "flat_spmm",
            f"masked operator took {op.impl_used}/{bwd.impl_used}")
    rng = np.random.default_rng(F)
    h = torch.from_numpy(rng.normal(size=(graph.num_nodes, F)).astype(
        np.float32)).to(device).requires_grad_(True)
    dy = rng.normal(size=(len(op.rows), F)).astype(np.float32)
    op._fn(h).backward(torch.from_numpy(dy).to(device))
    torch.cuda.synchronize()
    require(op.launches == 1 and bwd.launches == 1,
            f"backward: launches {op.launches}/{bwd.launches}")
    plain = spmm_flat.flat_spmm_plain(
        bwd._bufs, torch.from_numpy(dy).to(device), bwd.mat.shape, dtype)
    label = f"backward F={F} {dtype or 'f32'}"
    require(torch.equal(h.grad, plain),
            f"{label}: K4 and its plain version differ")
    if bwd.mat.nnz > SAMPLED_NNZ:
        return check_spmm_at_scale(label, bwd.mat, dy, h.grad, dtype)
    return check_spmm(label, bwd.mat, dy, h.grad.cpu().numpy(),
                      plain.cpu().numpy(), dtype)


def bound(nbytes, flops, dtype=None, rate=HBM_BYTES_PER_S, floor=0.0):
    """``(ms, "bytes", "operations" or "launch")``: the least time the card
    could take to move ``nbytes`` at ``rate`` bytes/s (the nominal 3.35
    TB/s, or K11's measured rate), do ``flops`` and launch a kernel
    (``floor`` ms, the launch floor of phase 19; 0 before it is
    measured)."""
    t_bytes = nbytes / rate * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max((t_bytes, "bytes"), (t_ops, "operations"), (floor, "launch"),
               key=lambda b: b[0])


def csr_spmv_bound(csr, rate=HBM_BYTES_PER_S):
    """y = A x over CSR: offsets, cols, vals and x read, y written."""
    rows, cols = csr.shape
    nbytes = 4 * (rows + 1) + 8 * csr.nnz + 4 * cols + 4 * rows
    return bound(nbytes, 2 * csr.nnz, rate=rate)


def csr_spmm_bound(csr, F, rate=HBM_BYTES_PER_S):
    rows, cols = csr.shape
    nbytes = 4 * (rows + 1) + 8 * csr.nnz + 4 * F * (cols + rows)
    return bound(nbytes, 2 * csr.nnz * F, rate=rate)


def bcsr_bound(bcsr, F=None, dtype=None, rate=HBM_BYTES_PER_S):
    """BCSR SpMV (``F`` None) or SpMM: the stored blocks, block columns
    and offsets, x or B read (in the stream type), y or C (f32) written;
    2 flops per stored value and feature."""
    rows, cols = bcsr.shape
    es = 2 if dtype else 4
    index = 4 * (bcsr.num_blocks + bcsr.num_block_rows + 1)
    if F is None:
        return bound(index + 4 * bcsr.nnz + 4 * (cols + rows), 2 * bcsr.nnz,
                     rate=rate)
    return bound(index + es * (bcsr.nnz + F * cols) + 4 * F * rows,
                 2 * bcsr.nnz * F, dtype, rate)


def sddmm_flat_bound(csr, F, rate=HBM_BYTES_PER_S):
    """K5: offsets, cols, vals, A and B (f32, rounded in registers) read,
    out written; 2 flops per nonzero and feature."""
    rows, cols = csr.shape
    nbytes = 4 * (rows + 1) + 12 * csr.nnz + 4 * F * (rows + cols)
    return bound(nbytes, 2 * csr.nnz * F, rate=rate)


def sddmm_bcsr_bound(bcsr, F, rate=HBM_BYTES_PER_S):
    """K10: block rows and columns, vals, A and B read, out written; 2
    flops per stored value and feature."""
    rows, cols = bcsr.shape
    nbytes = 8 * bcsr.num_blocks + 8 * bcsr.nnz + 4 * F * (rows + cols)
    return bound(nbytes, 2 * bcsr.nnz * F, rate=rate)


def bcsr_plain(kname, op):
    """The plain version of ``op``'s kernel over ``op``'s staged
    buffers."""
    from loops_tpu_torch.ops.kernels import (
        spmm_bcsr,
        spmm_bcsr_v2,
        spmm_bcsr_v3,
        spmv_bcsr,
    )

    b, shape = op._bufs, op.mat.shape
    if kname == "bcsr_spmv":
        return lambda x: spmv_bcsr.bcsr_spmv_plain(b, x, shape)
    if kname == "bcsr_spmm":
        return lambda B: spmm_bcsr.bcsr_spmm_plain(b, B, shape)
    if kname == "bcsr_spmm_v2":
        return lambda B: spmm_bcsr_v2.bcsr_spmm_v2_plain(b, B, shape,
                                                         op.dtype)
    return lambda B: spmm_bcsr_v3.bcsr_spmm_v3_plain(b, B, shape, op.meta,
                                                     op.dtype)


def rounded_operands(csr, B, dtype):
    """The CSR and B a mode multiplies: bf16-rounded in bf16 mode."""
    from loops_tpu_torch.formats import CSR
    from loops_tpu_torch.utils import reference

    if dtype is None:
        return csr, B
    return (CSR(csr.shape, csr.offsets, csr.indices,
                reference.bf16_round(csr.vals)), reference.bf16_round(B))


def run_twice(kname, op, x):
    """Two applies of ``op``: the launch counter goes up by 2 and the
    results are bitwise equal; returns the first."""
    import torch

    from loops_tpu_torch.ops.kernels import _build

    before = _build.LAUNCHES[kname]
    y1, y2 = op(x), op(x)
    torch.cuda.synchronize()
    require(_build.LAUNCHES[kname] == before + 2,
            f"{kname}: launch counter did not go up by 2")
    require(torch.equal(y1, y2), f"{kname}: two applies are not bitwise "
            "equal")
    return y1


def bcsr_spmv_vs_plain(label, csr, bcsr, device):
    """K6 twice, once more into a NaN-filled ``out=``, and its plain
    version once; the full validator."""
    import torch

    from loops_tpu_torch.ops.spmv import SpMVOperator
    from loops_tpu_torch.utils import reference

    op = SpMVOperator(bcsr, impl="pallas", device=device)
    require(op.impl_used == "bcsr_spmv", f"{label}: took {op.impl_used}")
    x = np.random.default_rng(5).normal(size=csr.shape[1]).astype(
        np.float32)
    xd = torch.from_numpy(x).to(device)
    yd = run_twice("bcsr_spmv", op, xd)
    # K6 writes every row: into NaN-filled memory, a row it skips shows
    out = torch.full_like(yd, float("nan"))
    op._raw(op._bufs, xd, out=out)
    torch.cuda.synchronize()
    require(torch.equal(out, yd), f"{label}: out= differs from y")
    y = yd.cpu().numpy()
    yp = bcsr_plain("bcsr_spmv", op)(xd).cpu().numpy()
    require(y.shape == (csr.shape[0],) and np.all(np.isfinite(y)),
            f"{label}: bad output")
    diff = np.abs(y.astype(np.float64) - yp)
    require(np.all(diff <= pair_tolerance(csr, x)),
            f"{label}: kernel and plain differ by {diff.max():.3e}")
    rep = reference.rigorously_validate_spmv(csr, x, y)
    require(rep.verdict == "NOT_A_BUG", f"{label}: {rep}")
    return float(diff.max(initial=0.0))


def bcsr_spmm_vs_plain(label, kname, csr, bcsr, B, dtype, device,
                       block_f=128, sampled=False):
    """One SpMM kernel twice and its plain version once on the same
    staged buffers. Small matrices take the full validator; at bench
    scale (``sampled``) the pair tolerance is formed on the card and the
    validator checks 256 sampled rows."""
    import torch

    from loops_tpu_torch.ops.kernels import spmm_bcsr
    from loops_tpu_torch.ops.spmm import SpMMOperator
    from loops_tpu_torch.utils import reference

    impl = BCSR_KERNELS[kname][1]
    op = SpMMOperator(bcsr, "row_mapped", impl, block_f=block_f,
                      dtype=dtype, device=device)
    require(op.impl_used == kname, f"{label}: took {op.impl_used}")
    Bd = torch.from_numpy(B).to(device)
    C = run_twice(kname, op, Bd)
    # K7, K8 and K9 write every row of C: into NaN-filled memory, a row
    # one leaves unwritten shows
    out = torch.full_like(C, float("nan"))
    op._raw(op._bufs, Bd, out=out)
    torch.cuda.synchronize()
    require(torch.equal(out, C), f"{label}: out= differs from C")
    plain = bcsr_plain(kname, op)(Bd)
    require(tuple(C.shape) == (csr.shape[0], B.shape[1])
            and bool(torch.isfinite(C).all()), f"{label}: bad output")
    ops_csr, ops_B = rounded_operands(csr, B, dtype)
    diff = (C.double() - plain.double()).abs()
    if sampled:
        vals = np.abs(bcsr.vals)
        vals = reference.bf16_round(vals) if dtype else vals
        absolute = {k: torch.from_numpy(a).to(device) for k, a in (
            ("offsets", bcsr.block_offsets), ("bcols", bcsr.block_cols),
            ("vals", vals))}
        l1 = spmm_bcsr.bcsr_spmm_plain(
            absolute, torch.from_numpy(np.abs(ops_B)).to(device),
            bcsr.shape)
        nnz_r = torch.from_numpy(csr.row_sizes().astype(np.float32)).to(
            device)[:, None]
        tol = torch.clamp(2 * reference.DEFAULT_WILKINSON_K * nnz_r
                          * reference.unit_roundoff(np.float32) * l1,
                          min=1e-6)
        require(bool((diff <= tol).all()),
                f"{label}: kernel and plain differ by {diff.max():.3e}")
        rep = reference.validate_sampled_rows(ops_csr, ops_B, C)
        require(rep.overruns == 0, f"{label}: {rep}")
    else:
        C = C.cpu().numpy()
        diff = diff.cpu().numpy()
        require(np.all(diff <= spmm_pair_tolerance(ops_csr, ops_B, None)),
                f"{label}: kernel and plain differ by {diff.max():.3e}")
        rep = reference.rigorously_validate_spmm(ops_csr, ops_B, C,
                                                 mxu_bf16=False)
        require(rep.verdict == "NOT_A_BUG", f"{label}: {rep}")
    return float(diff.max())


def bcsr_edges_vs_plain(device):
    """K9, K7 (f32, bf16; at the card's tiles and at two block rows a
    super-row, chunks of one and two blocks) and K8 (f32, bf16; at one
    block row a super-row and at two) on ``bcsr_edge_matrices()``, blocks
    8 and 16 rows: two applies bitwise equal and into NaN-filled
    ``out=``, the pair tolerance against the plain version, the Wilkinson
    verdict. Returns the max |kernel - plain| per kernel and the case
    count."""
    import torch

    from loops_tpu_torch.formats import BCSR
    from loops_tpu_torch.ops.kernels import (
        spmm_bcsr,
        spmm_bcsr_v2,
        spmm_bcsr_v3,
    )
    from loops_tpu_torch.utils import reference

    err = {"bcsr_spmm": 0.0, "bcsr_spmm_v2": 0.0, "bcsr_spmm_v3": 0.0}
    n = 0
    for name, csr in bcsr_edge_matrices().items():
        for block in BCSR_BLOCKS:
            bcsr = BCSR.from_csr(csr, *block)
            builds = [("bcsr_spmm", None, {},
                       spmm_bcsr.bcsr_spmm(bcsr, device=device))]
            for dtype in DTYPES:
                for kw in K7_EDGE_TILES:
                    builds.append(("bcsr_spmm_v3", dtype, kw,
                                   spmm_bcsr_v3.bcsr_spmm_v3(
                                       bcsr, dtype=dtype, device=device,
                                       **kw)))
                for kw in K8_EDGE_TILES:
                    builds.append(("bcsr_spmm_v2", dtype, kw,
                                   spmm_bcsr_v2.bcsr_spmm_v2(
                                       bcsr, dtype=dtype, device=device,
                                       **kw)))
            for F in BCSR_EDGE_FS:
                B = np.random.default_rng(F).normal(
                    size=(csr.shape[1], F)).astype(np.float32)
                Bd = torch.from_numpy(B).to(device)
                for kname, dtype, kw, (b, fn) in builds:
                    label = (f"edge {name} {block[0]}x{block[1]} F={F} "
                             f"{kname} {dtype or 'f32'} {kw}")
                    C1, C2 = fn(b, Bd), fn(b, Bd)
                    out = torch.full_like(C1, float("nan"))
                    fn(b, Bd, out=out)
                    torch.cuda.synchronize()
                    require(torch.equal(C1, C2) and torch.equal(out, C1),
                            f"{label}: applies differ")
                    if kname == "bcsr_spmm":
                        plain = spmm_bcsr.bcsr_spmm_plain(b, Bd, csr.shape)
                    elif kname == "bcsr_spmm_v2":
                        plain = spmm_bcsr_v2.bcsr_spmm_v2_plain(
                            b, Bd, csr.shape, dtype)
                    else:
                        plain = spmm_bcsr_v3.bcsr_spmm_v3_plain(
                            b, Bd, csr.shape, fn.meta, dtype)
                    ops_csr, ops_B = rounded_operands(csr, B, dtype)
                    C = C1.cpu().numpy()
                    diff = np.abs(C.astype(np.float64)
                                  - plain.cpu().numpy())
                    require(np.all(diff <= spmm_pair_tolerance(
                        ops_csr, ops_B, None)),
                        f"{label}: kernel and plain differ by "
                        f"{diff.max():.3e}")
                    rep = reference.rigorously_validate_spmm(
                        ops_csr, ops_B, C, mxu_bf16=False)
                    require(rep.verdict == "NOT_A_BUG", f"{label}: {rep}")
                    err[kname] = max(err[kname], float(diff.max(initial=0)))
                    n += 1
    return err, n


def bcsr_edge_matrices():
    """The BCSR edge cases (``tests/test_torch_cuda_bcsr.py``): B's rows
    past the last full block column, and empty block rows, which at two
    block rows a super-row make empty super-rows."""
    from loops_tpu_torch.utils import generate

    return {"ragged_cols": generate.random_csr(100, 300, 0.04, seed=21),
            "empty_super_rows": generate.sized_csr(
                [3] * 16 + [0] * 40 + [2] * 16 + [0] * 9, 390, seed=22)}


def run_example(name, args):
    """``examples/<name>`` main() in this process; returns (status,
    stdout, stderr)."""
    spec = importlib.util.spec_from_file_location(
        name.replace(".py", "_example"), os.path.join(REPO, "examples", name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        status = mod.main(args)
    return status, out.getvalue(), err.getvalue()


def bcsr_phases(device, smi):
    """Phases 11-13 (the BCSR tier); returns the max |kernel - plain| per
    kernel, the main path's launch counts and the timings."""
    import torch

    from loops_tpu_torch.formats import BCSR
    from loops_tpu_torch.ops.kernels import _build
    from loops_tpu_torch.ops.spmm import SpMMOperator
    from loops_tpu_torch.ops.spmv import SpMVOperator
    from loops_tpu_torch.utils import generate, reference
    from loops_tpu_torch.utils.bench import apply_ms, cold_ms, device_ms
    from loops_tpu_torch.utils.equal import count_mismatches
    from loops_tpu_torch.utils.profile_spmv import profile_applies

    # ---- 11. K6-K9 vs plain
    t0 = time.perf_counter()
    bcsr_err = {k: 0.0 for k in BCSR_KERNELS}
    n_cases = 0
    for mname, make in generate.BCSR_CASES.items():
        csr = make()
        B_all = np.random.default_rng(9).normal(
            size=(csr.shape[1], max(BCSR_FS))).astype(np.float32)
        for block in BCSR_BLOCKS:
            bcsr = BCSR.from_csr(csr, *block)
            label = f"{mname} {block[0]}x{block[1]}"
            bcsr_err["bcsr_spmv"] = max(bcsr_err["bcsr_spmv"],
                                        bcsr_spmv_vs_plain(label, csr, bcsr,
                                                           device))
            n_cases += 1
            for F in BCSR_FS:
                B = np.ascontiguousarray(B_all[:, :F])
                for kname, (_, _, modes) in BCSR_KERNELS.items():
                    for dtype in modes if kname != "bcsr_spmv" else ():
                        bcsr_err[kname] = max(bcsr_err[kname],
                                              bcsr_spmm_vs_plain(
                            f"{label} F={F} {kname} {dtype or 'f32'}",
                            kname, csr, bcsr, B, dtype, device))
                        n_cases += 1
    edge_err, n_edge = bcsr_edges_vs_plain(device)
    for k, v in edge_err.items():
        bcsr_err[k] = max(bcsr_err[k], v)
    n_cases += n_edge
    th = time.perf_counter()
    spmv_csr, spmv_bcsr = generate.build_block_sparse(**SPMV_REGIME)
    spmm_csr, spmm_bcsr = generate.build_block_sparse(**SPMM_REGIME)
    regime_s = time.perf_counter() - th
    print(f"  bench regimes built in {regime_s:.2f} s: SpMM "
          f"{spmm_csr.shape[0]}^2, {spmm_bcsr.num_blocks} blocks of "
          f"{spmm_bcsr.block_shape}, {spmm_csr.nnz} stored values; SpMV "
          f"{spmv_csr.shape[0]}^2, {spmv_bcsr.num_blocks} blocks, "
          f"{spmv_csr.nnz} stored values")
    bcsr_err["bcsr_spmv"] = max(bcsr_err["bcsr_spmv"], bcsr_spmv_vs_plain(
        "bench 32768", spmv_csr, spmv_bcsr, device))
    n_cases += 1
    B_bench = np.random.default_rng(1).normal(
        size=(spmm_csr.shape[1], SPMM_F)).astype(np.float32)
    for kname, (_, _, modes) in BCSR_KERNELS.items():
        for dtype in modes if kname != "bcsr_spmv" else ():
            bcsr_err[kname] = max(bcsr_err[kname], bcsr_spmm_vs_plain(
                f"bench 16384 F={SPMM_F} {kname} {dtype or 'f32'}", kname,
                spmm_csr, spmm_bcsr, B_bench, dtype, device, block_f=SPMM_F,
                sampled=True))
            n_cases += 1
    phase(11, "K6-K9 vs plain", t0,
          f"{n_cases} cases, max |kernel - plain| "
          + ", ".join(f"{k} {v:.3e}" for k, v in bcsr_err.items()) + " ")

    # ---- 12. the BCSR main path
    t0 = time.perf_counter()
    _build.reset_launches()
    for case in (["--impl", "pallas"], []):
        status, out, err = run_example(
            "spmm_torch.py", ["--format", "bcsr", "--validate", "--device",
                              "cuda", *case])
        csv = [ln for ln in out.splitlines() if ln.startswith("spmm_")]
        print(f"  spmm_torch --format bcsr {' '.join(case)}: "
              f"{csv[0] if csv else '?'} | {err.strip()}")
        require(status == 0 and "Errors: 0" in out,
                f"spmm_torch {case}: exit status {status}\n{out}{err}")
        want = "bcsr_spmm" if case else "torch"
        require(f"impl_used: {want}" in err, f"spmm_torch {case}: {err}")
    x_spmv = generate.make_input_vector(spmv_csr.shape[1])
    th = time.perf_counter()
    spmv_op = SpMVOperator(spmv_bcsr, impl="pallas", device=device)
    spmv_build_ms = (time.perf_counter() - th) * 1e3
    y = spmv_op(x_spmv).cpu().numpy()
    errors = count_mismatches(y, reference.spmv(spmv_csr, x_spmv))
    rep = reference.rigorously_validate_spmv(spmv_csr, x_spmv, y)
    print(f"  SpMVOperator(bcsr, impl='pallas') at {spmv_csr.shape[0]}^2: "
          f"Errors: {errors}, Verdict {rep.verdict}, launches "
          f"{spmv_op.launches}, host staging {spmv_build_ms:.1f} ms")
    require(errors == 0 and rep.verdict == "NOT_A_BUG" and
            spmv_op.launches == 1, f"bcsr SpMV: {errors} errors, {rep}")
    Bd = torch.from_numpy(B_bench).to(device)
    spmm_ops = {}
    for kname, (_, impl, modes) in BCSR_KERNELS.items():
        for dtype in modes if kname != "bcsr_spmv" else ():
            th = time.perf_counter()
            op = SpMMOperator(spmm_bcsr, "row_mapped", impl, block_f=SPMM_F,
                              dtype=dtype, device=device)
            build_ms = (time.perf_counter() - th) * 1e3
            C = op(Bd)
            torch.cuda.synchronize()
            ops_csr, ops_B = rounded_operands(spmm_csr, B_bench, dtype)
            rep = reference.validate_sampled_rows(ops_csr, ops_B, C)
            print(f"  SpMMOperator(bcsr, {impl!r}, dtype={dtype}) at "
                  f"{spmm_csr.shape[0]}^2 F={SPMM_F}: {op.impl_used}, "
                  f"launches {op.launches}, {rep}, host staging "
                  f"{build_ms:.1f} ms, tiles "
                  + json.dumps({k: v for k, v in op.meta.items()
                                if k != "num_blocks"}))
            require(op.impl_used == kname and op.launches == 1,
                    f"{kname}: took {op.impl_used}, {op.launches} launches")
            require(C.shape == (spmm_csr.shape[0], SPMM_F)
                    and bool(torch.isfinite(C).all()) and rep.overruns == 0
                    and rep.rel_error < 1e-5, f"{kname} {dtype}: {rep}")
            op.build_ms = build_ms
            spmm_ops[kname, dtype] = op
            del C
    bcsr_launches = dict(_build.LAUNCHES)
    for kname in BCSR_KERNELS:
        require(bcsr_launches[kname] > 0,
                f"{kname} never launched on the BCSR main path")
    phase(12, "BCSR main path", t0, "main-path launches "
          + json.dumps({k: bcsr_launches[k] for k in BCSR_KERNELS})
          + f" [{smi}] ")

    # ---- 13. timing: plain, kernel, kernel, plain; cuSPARSE; bounds
    t0 = time.perf_counter()

    def library(A, fn, v, cold=False):
        try:
            if cold:
                return cold_ms(lambda: fn(A, v), device)
            return apply_ms(lambda u: fn(A, u), v)
        except (RuntimeError, NotImplementedError) as e:
            # timed only: a format or type torch refuses
            print(f"  library call not run ({str(e).splitlines()[0]})")
            return None

    def csr_on_card(csr):
        return torch.sparse_csr_tensor(
            *(torch.from_numpy(a).to(device)
              for a in (csr.offsets, csr.indices, csr.vals)),
            size=csr.shape)

    def bsr_on_card(bcsr):
        return torch.sparse_bsr_tensor(
            *(torch.from_numpy(a).to(device)
              for a in (bcsr.block_offsets, bcsr.block_cols, bcsr.vals)),
            size=bcsr.shape)

    bcsr_times = {}
    xd = torch.from_numpy(x_spmv).to(device)
    runs = [("bcsr_spmv", None, spmv_op, xd, spmv_csr, spmv_bcsr)] + [
        (k, d, op, Bd, spmm_csr, spmm_bcsr)
        for (k, d), op in spmm_ops.items()]
    lib = {}
    for csr, mat, v, fn in ((spmv_csr, spmv_bcsr, xd, torch.mv),
                            (spmm_csr, spmm_bcsr, Bd, torch.matmul)):
        A = csr_on_card(csr)
        lib[mat.shape, "csr"] = library(A, fn, v)
        if mat is spmv_bcsr:  # K6 is timed from an empty L2 too
            lib[mat.shape, "csr_cold"] = library(A, fn, v, cold=True)
        del A
        A = bsr_on_card(mat)
        lib[mat.shape, "bsr"] = library(A, fn, v)
        del A
    # K7/K8's bf16 mode: cuSPARSE over bf16 vals and B (its output is
    # bf16, where K7/K8 write f32; timed only)
    A = torch.sparse_csr_tensor(
        *(torch.from_numpy(a).to(device) for a in (spmm_csr.offsets,
                                                    spmm_csr.indices)),
        torch.from_numpy(spmm_csr.vals).to(device, torch.bfloat16),
        size=spmm_csr.shape)
    lib[spmm_bcsr.shape, "csr_bf16"] = library(A, torch.matmul,
                                               Bd.to(torch.bfloat16))
    del A
    for kname, dtype, op, v, csr, mat in runs:
        plain = bcsr_plain(kname, op)
        p1 = apply_ms(plain, v)
        k1 = apply_ms(op, v)
        k2 = apply_ms(op, v)
        p2 = apply_ms(plain, v)
        F = None if kname == "bcsr_spmv" else SPMM_F
        b_ms, b_by = bcsr_bound(mat, F, dtype)
        ms = (k1 + k2) / 2
        work = 2 * csr.nnz * (F or 1)
        lib_csr = lib[mat.shape, "csr_bf16" if dtype else "csr"]
        lib_bsr = lib[mat.shape, "bsr"]
        bcsr_times[kname, dtype] = dict(
            ms=ms, plain_ms=(p1 + p2) / 2, bound_ms=b_ms, bound_by=b_by,
            library_ms=lib_csr)
        staging = getattr(op, "build_ms", spmv_build_ms)
        lib_csr_s = "not run" if lib_csr is None else f"{lib_csr:.4f} ms"
        lib_bsr_s = "not run" if lib_bsr is None else f"{lib_bsr:.4f} ms"
        print(f"  {kname} {dtype or 'f32'} at {csr.shape[0]}^2"
              + (f" F={F}" if F else "") + f": kernel {k1:.4f}/{k2:.4f} ms, "
              f"plain {p1:.4f}/{p2:.4f} ms, cuSPARSE CSR {lib_csr_s}, "
              f"torch BSR {lib_bsr_s}"
              f"; bound {b_ms:.4f} ms ({b_by}), {b_ms / ms:.1%} of it; "
              f"{work / ms / 1e6:.0f} GFLOP/s; host staging {staging:.1f} ms"
              f"  [{smi}]")
    # K6's card time: its 64 MB of blocks are 1.3 times the L2, so a warm
    # apply finds part of them there; its byte bound assumes they come
    # from device memory, as one apply from an empty L2 does
    k6 = bcsr_times["bcsr_spmv", None]
    k6.update(apply_ms=k6["ms"], warm_ms=device_ms(spmv_op, xd),
              cold_ms=cold_ms(lambda: spmv_op(xd), device),
              library_apply_ms=k6["library_ms"],
              library_ms=lib[spmv_bcsr.shape, "csr_cold"],
              bsr_ms=lib[spmv_bcsr.shape, "bsr"])
    k6["ms"] = k6["cold_ms"]
    lib_s = ("not run" if k6["library_ms"] is None
             else f"{k6['library_ms']:.4f} ms")
    print(f"  bcsr_spmv card time at {spmv_csr.shape[0]}^2: "
          f"{k6['warm_ms']:.4f} ms warm (device_ms), {k6['cold_ms']:.4f} ms "
          f"from an empty L2 (cold_ms), apply {k6['apply_ms']:.4f} ms; "
          f"cuSPARSE CSR from an empty L2 {lib_s}; bound "
          f"{k6['bound_ms']:.4f} ms (bytes), {k6['bound_ms'] / k6['ms']:.1%} "
          f"of it cold; its plan "
          + json.dumps({k: spmv_op.meta[k] for k in (
              "run_blocks", "runs", "cut_block_rows")}) + f"  [{smi}]")
    for kname, dtype, op, v, csr, mat in runs:
        if dtype is None:
            r = profile_applies(op, v, applies=10, warmup=2)
            print(f"  profile {kname}: {profile_text(r, 4)}")
    phase(13, "BCSR timing (CUDA events, median per apply)", t0)
    return bcsr_err, bcsr_launches, bcsr_times, (spmv_bcsr, spmm_bcsr)


def stream_phase(device, smi):
    """Phase 14: K11 against its plain version (``torch.sum``) at 64 MiB
    and 1 GiB, and the read rate of each; returns them by size."""
    import torch

    from loops_tpu_torch.ops.kernels import _build
    from loops_tpu_torch.utils import stream
    from loops_tpu_torch.utils.bench import apply_ms

    t0 = time.perf_counter()
    res = {}
    for label, (rows, cols) in STREAM_SHAPES.items():
        # integers in [-8, 8]: every f32 partial sum of K11 and torch.sum is
        # exact, so both must give the integer total exactly
        x = stream.stream_input(rows, cols, device)
        exact = int(x.sum(dtype=torch.float64))
        require(exact != 0, f"stream {label}: the total is 0, so a kernel "
                "that read nothing would pass")
        before = _build.LAUNCHES["stream_read"]
        p1, p2 = stream.stream_read(x), stream.stream_read(x)
        torch.cuda.synchronize()
        require(_build.LAUNCHES["stream_read"] == before + 2,
                f"stream {label}: launch counter did not go up by 2")
        require(torch.equal(p1, p2), f"stream {label}: two runs differ")
        total = float(p1.double().sum())
        plain = float(stream.stream_read_plain(x).double().sum())
        err = abs(total - plain)
        require(total == exact and plain == exact,
                f"stream {label}: K11 {total}, plain {plain}, exact {exact}")
        ms = stream.pass_ms(x)
        plain_ms = apply_ms(lambda v: v.sum(), x, iters=10)
        nbytes = x.numel() * 4
        gbps = nbytes / ms / 1e6
        res[label] = dict(ms=ms, plain_ms=plain_ms, gbps=gbps, err=err,
                          nbytes=nbytes)
        print(f"  stream {label}: K11 {ms:.4f} ms per pass = {gbps:.1f} "
              f"GB/s ({gbps * 1e9 / HBM_BYTES_PER_S:.1%} of the nominal "
              f"3.35 TB/s); torch.sum {plain_ms:.4f} ms = "
              f"{nbytes / plain_ms / 1e6:.1f} GB/s; |K11 - plain| "
              f"{err:.3e}  [{smi}]")
        del x, p1, p2
    phase(14, "stream (K11 vs plain, read rate)", t0)
    return res


def sddmm_pair_tolerance(l1, F):
    """Twice the Wilkinson bound of each f32 dot, ``2 * 4 * F * u32 *
    sum_f |term|``, floor 1e-6; ``l1`` is that sum, from the plain version
    over |vals|, |A| and |B|."""
    import torch

    from loops_tpu_torch.utils import reference

    return torch.clamp(2 * reference.DEFAULT_WILKINSON_K * F
                       * reference.unit_roundoff(np.float32) * l1.double(),
                       min=1e-6)


def sddmm_plain(kname, b, mat):
    """The plain version of K5 or K10 over the buffers ``b``."""
    from loops_tpu_torch.ops.kernels import sddmm_bcsr, sddmm_flat

    if kname == "sddmm_flat":
        return lambda bb, A, B: sddmm_flat.sddmm_flat_plain(bb, A, B, mat.nnz)
    return lambda bb, A, B: sddmm_bcsr.sddmm_bcsr_plain(bb, A, B, mat.shape)


def sddmm_vs_plain(label, kname, mat, A, B, device, sampled=False,
                   unaligned=False):
    """K5 (CSR ``mat``, bf16 operands) or K10 (BCSR ``mat``) twice and its
    plain version once on the same staged buffers: agreement within twice
    the Wilkinson bound, formed on the card from the plain version over
    the terms' magnitudes; the validator over every nonzero, or over 4096
    sampled ones (``sampled``). ``unaligned``: A lies one float past a
    16-byte boundary. Returns the max |kernel - plain|."""
    import torch

    from loops_tpu_torch.ops.kernels import _build, sddmm_bcsr, sddmm_flat
    from loops_tpu_torch.utils import reference

    flat = kname == "sddmm_flat"
    Ad, Bd = (torch.from_numpy(a).to(device) for a in (A, B))
    if unaligned:
        Ad = torch.cat([Ad.new_zeros(1), Ad.reshape(-1)])[1:].view(A.shape)
        require(Ad.data_ptr() % 16 != 0, f"{label}: A is still aligned")
    build = sddmm_flat.sddmm_flat if flat else sddmm_bcsr.sddmm_bcsr
    b, fn = build(mat, device=device)
    plain = sddmm_plain(kname, b, mat)
    before = _build.LAUNCHES[kname]
    o1, o2 = fn(b, Ad, Bd), fn(b, Ad, Bd)
    torch.cuda.synchronize()
    require(_build.LAUNCHES[kname] == before + 2,
            f"{label}: launch counter did not go up by 2")
    require(torch.equal(o1, o2), f"{label}: two applies are not bitwise "
            "equal")
    if not flat:
        # K10 writes every element of every block: into NaN-filled
        # memory, one it leaves unwritten shows
        o2 = torch.full_like(o1, float("nan"))
        fn(b, Ad, Bd, out=o2)
        torch.cuda.synchronize()
        require(torch.equal(o2, o1), f"{label}: out= differs")
    shape = (mat.nnz,) if flat else tuple(mat.vals.shape)
    require(tuple(o1.shape) == shape and bool(torch.isfinite(o1).all()),
            f"{label}: bad output")
    diff = (o1.double() - plain(b, Ad, Bd).double()).abs()
    mags = {k: v.abs() if v.is_floating_point() else v for k, v in b.items()}
    tol = sddmm_pair_tolerance(plain(mags, Ad.abs(), Bd.abs()), A.shape[1])
    require(bool((diff <= tol).all()),
            f"{label}: kernel and plain differ by {float(diff.max()):.3e}")
    del o2
    if flat:
        pattern, out, operands = mat, o1, "bfloat16"
    else:
        pattern, slot = mat.stored_pattern()
        out = o1.reshape(-1)[torch.from_numpy(slot).to(device)]
        operands = None
    if sampled:
        rep = reference.validate_sampled_sddmm(pattern, A, B, out,
                                               operands=operands)
        require(rep.overruns == 0, f"{label}: {rep}")
    else:
        rep = reference.rigorously_validate_sddmm(
            pattern, A, B, out.cpu().numpy(), operands)
        require(rep.verdict == "NOT_A_BUG", f"{label}: {rep}")
    return float(diff.max())


def sddmm_phases(device, smi, adj, rate):
    """Phases 15-17 (the SDDMM tier, K5 and K10); ``rate`` is K11's
    measured read rate in bytes/s. Returns the max |kernel - plain| per
    kernel, the main path's launch counts and the timings."""
    import torch

    from loops_tpu_torch.formats import BCSR
    from loops_tpu_torch.ops.kernels import _build
    from loops_tpu_torch.ops.sddmm import SDDMMOperator, sddmm
    from loops_tpu_torch.utils import generate, reference
    from loops_tpu_torch.utils.bench import apply_ms
    from loops_tpu_torch.utils.profile_spmv import profile_applies
    from loops_tpu_torch.utils.stream import measure_stream_gbps

    BF = "bfloat16"

    def operands(shape, F, seed):
        rng = np.random.default_rng(seed)
        return (rng.normal(size=(shape[0], F)).astype(np.float32),
                rng.normal(size=(shape[1], F)).astype(np.float32))

    # ---- 15. K5 and K10 vs plain
    t0 = time.perf_counter()
    err = {k: 0.0 for k in SDDMM_KERNELS}
    n_cases = 0
    k5_mats = {
        # tests/test_spmm_sddmm.py:191-198, then the SpMV battery
        "uniform": generate.random_csr(1024, 1024, 0.01, seed=2),
        "rect": generate.random_csr(768, 1536, 0.01, seed=3),
        "skewed_512": generate.skewed_csr(512, 512, heavy_rows=4),
        **{k: make() for k, make in generate.BATTERY.items()}}
    for mname, csr in k5_mats.items():
        for F in K5_FS:
            A, B = operands(csr.shape, F, F)
            err["sddmm_flat"] = max(err["sddmm_flat"], sddmm_vs_plain(
                f"K5 {mname} F={F}", "sddmm_flat", csr, A, B, device))
            n_cases += 1
    for F in (20, 33, 64):
        A, B = operands(k5_mats["uniform"].shape, F, F)
        err["sddmm_flat"] = max(err["sddmm_flat"], sddmm_vs_plain(
            f"K5 uniform F={F} unaligned A", "sddmm_flat",
            k5_mats["uniform"], A, B, device, unaligned=True))
        n_cases += 1
    for mname, make in generate.BCSR_CASES.items():
        csr = make()
        for block in BCSR_BLOCKS:
            bcsr = BCSR.from_csr(csr, *block)
            for F in K10_FS:
                A, B = operands(csr.shape, F, F)
                err["sddmm_bcsr"] = max(err["sddmm_bcsr"], sddmm_vs_plain(
                    f"K10 {mname} {block[0]}x{block[1]} F={F}", "sddmm_bcsr",
                    bcsr, A, B, device))
                n_cases += 1
    for mname, csr in bcsr_edge_matrices().items():
        for block in K10_EDGE_BLOCKS:
            bcsr = BCSR.from_csr(csr, *block)
            for F in K10_EDGE_FS:
                A, B = operands(csr.shape, F, F)
                err["sddmm_bcsr"] = max(err["sddmm_bcsr"], sddmm_vs_plain(
                    f"K10 edge {mname} {block[0]}x{block[1]} F={F}",
                    "sddmm_bcsr", bcsr, A, B, device))
                n_cases += 1
    th = time.perf_counter()
    bench = generate.random_csr(**SDDMM_REGIME)
    _, bcsr = generate.build_block_sparse(**SPMM_REGIME)
    print(f"  regimes built in {time.perf_counter() - th:.2f} s: SDDMM "
          f"{bench.shape[0]}^2, {bench.nnz} nnz, longest row "
          f"{int(bench.row_sizes().max())}; BCSR {bcsr.shape[0]}^2, "
          f"{bcsr.num_blocks} blocks, {bcsr.nnz} stored values")
    # bench.py:425-432: A and B from default_rng(8), in that order
    rng = np.random.default_rng(8)
    A_bench = rng.normal(size=(bench.shape[0], SDDMM_F)).astype(np.float32)
    B_bench = rng.normal(size=(bench.shape[1], SDDMM_F)).astype(np.float32)
    A_arx, B_arx = operands(adj.shape, SDDMM_F, 0)
    A_blk, B_blk = operands(bcsr.shape, SPMM_F, 1)
    regimes = [
        ("bench 65536^2 F=128", "sddmm_flat", bench, A_bench, B_bench),
        ("arxiv_gcn F=128", "sddmm_flat", adj, A_arx, B_arx),
        ("bcsr 16384^2 F=512", "sddmm_bcsr", bcsr, A_blk, B_blk)]
    for label, kname, mat, A, B in regimes:
        err[kname] = max(err[kname], sddmm_vs_plain(
            f"{kname} {label}", kname, mat, A, B, device, sampled=True))
        n_cases += 1
        torch.cuda.empty_cache()
    phase(15, "K5 and K10 vs plain", t0,
          f"{n_cases} cases, max |kernel - plain| "
          + ", ".join(f"{k} {v:.3e}" for k, v in err.items()) + " ")

    # ---- 16. the SDDMM main path at full size
    t0 = time.perf_counter()
    _build.reset_launches()
    for label, (rows, cols) in STREAM_SHAPES.items():
        gbps = measure_stream_gbps(device, rows, cols)
        print(f"  measure_stream_gbps ({label}; 64 MiB is bench.py's first "
              f"step): {gbps:.1f} GB/s  [{smi}]")
    pattern, slot = bcsr.stored_pattern()
    slot_d = torch.from_numpy(slot).to(device)
    runs = [
        # label, matrix, A, B, sddmm keywords, the validator's (csr, A, B,
        # operands)
        ("K5 bench 65536^2 F=128", bench, A_bench, B_bench,
         dict(impl="pallas", dtype=BF), (bench, A_bench, B_bench, BF)),
        ("K5 arxiv_gcn F=128", adj, A_arx, B_arx,
         dict(impl="pallas", dtype=BF), (adj, A_arx, B_arx, BF)),
        ("K10 bcsr 16384^2 F=512", bcsr, A_blk, B_blk,
         dict(impl="pallas", block_f=SPMM_F), (pattern, A_blk, B_blk, None)),
        ("COO xla f32 arxiv_gcn F=128", adj.to_coo(), A_arx, B_arx, {},
         (adj, A_arx, B_arx, None)),
        ("CSR xla f32 arxiv_gcn F=128", adj, A_arx, B_arx, {},
         (adj, A_arx, B_arx, None)),
        ("CSR xla bf16 arxiv_gcn F=128", adj, A_arx, B_arx, dict(dtype=BF),
         (adj, reference.bf16_round(A_arx), reference.bf16_round(B_arx),
          None)),
    ]
    ops = {}
    for label, mat, A, B, kw, (vcsr, vA, vB, vop) in runs:
        th = time.perf_counter()
        out = sddmm(mat, A, B, device=device, **kw)
        torch.cuda.synchronize()
        call_s = time.perf_counter() - th
        op = list(mat._sddmm_ops.values())[-1]
        flat = out.reshape(-1)[slot_d] if out.dim() == 3 else out
        rep = reference.validate_sampled_sddmm(vcsr, vA, vB, flat,
                                               operands=vop)
        print(f"  sddmm {label}: {op.impl_used}, launches {op.launches}, "
              f"{rep}; first call {call_s:.2f} s (host staging "
              f"{op.meta['build_ms']:.1f} ms)")
        require(bool(torch.isfinite(out).all()) and rep.overruns == 0
                and rep.rel_error < 1e-5, f"{label}: {rep}")
        want = "torch" if "xla" in label else (
            "sddmm_flat" if label.startswith("K5") else "sddmm_bcsr")
        require(op.impl_used == want
                and op.launches == int(want != "torch"),
                f"{label}: took {op.impl_used}, {op.launches} launches")
        ops[label] = op
        del out, flat
    spec = importlib.util.spec_from_file_location(
        "primitives_torch", os.path.join(REPO, "scripts",
                                         "primitives_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    buf, ebuf = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(ebuf):
        status = mod.main(["--device", "cuda"])
    for ln in buf.getvalue().splitlines() + ebuf.getvalue().splitlines():
        print(f"  primitives_torch: {ln}")
    rows = [ln for ln in buf.getvalue().splitlines() if ln.startswith("| ")
            and ln.split("|")[1].strip().isdigit()]
    require(status == 0 and len(rows) == 3 and "impl_used: sddmm_flat"
            in ebuf.getvalue(), "scripts/primitives_torch.py failed")
    launches = dict(_build.LAUNCHES)
    for kname in (*SDDMM_KERNELS, "stream_read"):
        require(launches[kname] > 0,
                f"{kname} never launched on the SDDMM main path")
    phase(16, "SDDMM main path at full size", t0, "main-path launches "
          + json.dumps({k: launches[k] for k in (*SDDMM_KERNELS,
                                                 "stream_read")})
          + f" [{smi}] ")
    torch.cuda.empty_cache()

    # ---- 17. timing: plain, kernel, kernel, plain; torch paths; cuSPARSE
    t0 = time.perf_counter()

    def on_card(csr, dt):
        return torch.sparse_csr_tensor(
            *(torch.from_numpy(a).to(device) for a in (
                csr.offsets, csr.indices)),
            torch.from_numpy(csr.vals).to(device, dt), size=csr.shape)

    def cusparse_ms(csr, A, B):
        """``torch.sparse.sampled_addmm`` (cuSPARSE's SDDMM) times vals:
        bf16 where it runs, else f32; timed only."""
        for dt in (torch.bfloat16, torch.float32):
            S = on_card(csr, dt)
            v = S.values()
            Ad, Bt = (torch.from_numpy(a).to(device, dt) for a in (A, B))
            Bt = Bt.t()
            try:
                ms = apply_ms(lambda a: torch.sparse.sampled_addmm(
                    S, a, Bt, beta=0.0).values() * v, Ad, iters=10)
                return ms, str(dt).split(".")[-1]
            except (RuntimeError, NotImplementedError) as e:
                print(f"  cuSPARSE SDDMM {dt}: not run "
                      f"({str(e).splitlines()[0]})")
            finally:
                del S, v, Ad, Bt
        return None, None

    times = {}
    timed = [("bench_65536 F=128", "sddmm_flat", bench, A_bench, B_bench,
              ops["K5 bench 65536^2 F=128"]),
             ("arxiv_gcn F=128", "sddmm_flat", adj, A_arx, B_arx,
              ops["K5 arxiv_gcn F=128"]),
             ("bcsr_16384 F=512", "sddmm_bcsr", bcsr, A_blk, B_blk,
              ops["K10 bcsr 16384^2 F=512"])]
    for label, kname, mat, A, B, op in timed:
        Ad, Bd = (torch.from_numpy(a).to(device) for a in (A, B))
        raw = sddmm_plain(kname, op._bufs, mat)

        def plain(a, raw=raw, b=op._bufs, Bd=Bd):
            return raw(b, a, Bd)

        def kernel(a, op=op, Bd=Bd):
            return op(a, Bd)
        p1 = apply_ms(plain, Ad, iters=10)
        k1 = apply_ms(kernel, Ad)
        k2 = apply_ms(kernel, Ad)
        p2 = apply_ms(plain, Ad, iters=10)
        torch_ms = {}
        if kname == "sddmm_flat":
            for dt in (None, BF):
                x = SDDMMOperator(mat, dtype=dt, device=device)
                torch_ms[dt or "f32"] = apply_ms(lambda a, x=x: x(a, Bd), Ad,
                                                 iters=10)
                del x
        lib_ms, lib_dt = cusparse_ms(
            mat if kname == "sddmm_flat" else pattern, A, B)
        F = A.shape[1]
        bmake = sddmm_flat_bound if kname == "sddmm_flat" else \
            sddmm_bcsr_bound
        b_ms, b_by = bmake(mat, F)
        m_ms, m_by = bmake(mat, F, rate=rate)
        ms = (k1 + k2) / 2
        times[label] = dict(ms=ms, plain_ms=(p1 + p2) / 2, bound_ms=b_ms,
                            bound_by=b_by, library_ms=lib_ms)
        print(f"  {kname} {label}: kernel {k1:.4f}/{k2:.4f} ms, plain "
              f"{p1:.4f}/{p2:.4f} ms, torch xla "
              + (", ".join(f"{k} {v:.4f} ms" for k, v in torch_ms.items())
                 or "= plain")
              + ", cuSPARSE sampled_addmm "
              + ("not run" if lib_ms is None else f"{lib_dt} {lib_ms:.4f} ms")
              + f"; bound {b_ms:.4f} ms ({b_by}) nominal, {m_ms:.4f} ms "
              f"({m_by}) at the measured stream; {b_ms / ms:.1%} of the "
              f"nominal bound; host staging {op.meta['build_ms']:.1f} ms"
              f"  [{smi}]")
        r = profile_applies(kernel, Ad, applies=10, warmup=2)
        print(f"  profile {kname} {label}: {profile_text(r, 4)}")
        print(f"  {kname} {label}: {card_text(kernel, Ad)}  [{smi}]")
        del Ad, Bd
        torch.cuda.empty_cache()
    phase(17, "SDDMM timing (CUDA events, median per apply)", t0)
    bounds = {"sddmm_flat": lambda r: sddmm_flat_bound(bench, SDDMM_F, r),
              "sddmm_bcsr": lambda r: sddmm_bcsr_bound(bcsr, SPMM_F, r)}
    return err, launches, times, bounds


def probe_phases(device, smi, rate, k6, rate64):
    """Phases 18-19 (K12-K15); ``rate`` is K11's measured read rate in
    bytes/s at 1 GiB and ``rate64`` at 64 MiB, ``k6`` K6's times from
    phase 13 (the line of the two kernels redesigned last names it).
    Returns the max |kernel - plain| per
    kernel, the main path's launch counts and each kernel's timed
    record."""
    import torch

    from loops_tpu_torch.ops.kernels import _build, saxpy
    from loops_tpu_torch.probes import common, gather, mosaic, r2
    from loops_tpu_torch.utils import generate
    from loops_tpu_torch.utils.profile_spmv import profile_applies

    # ---- 18. K12 and K2 vs plain; the dot check refuses TF32
    t0 = time.perf_counter()
    err = {k: 0.0 for k in PROBE_KERNELS}
    rng = np.random.default_rng(0)
    for n in (SAXPY_SHAPE[0] * SAXPY_SHAPE[1], 1, 4099, (1 << 22) + 3):
        x, y = (torch.from_numpy(rng.normal(size=n).astype(np.float32)).to(
            device) for _ in range(2))
        before = _build.LAUNCHES["saxpy"]
        out = common.launch_twice(lambda: saxpy.saxpy(2.5, x, y, device))
        require(_build.LAUNCHES["saxpy"] == before + 2,
                "saxpy: launch counter did not go up by 2")
        common.hold(f"saxpy n={n}", out, saxpy.saxpy_plain(2.5, x, y))
        xb = torch.zeros(n + 1, device=device)
        xb[1:] = x  # one float into its buffer: the unaligned path
        common.hold(f"saxpy unaligned n={n}", saxpy.saxpy_cuda(2.5, xb[1:], y),
                    saxpy.saxpy_plain(2.5, x, y))
    # a dot that quietly used TF32 must fail the dots' check
    tf32 = {}
    for case in ((128, True), (8, False)):
        A, B = r2._dot_tensors(*case, "f32", device)
        tf32[case] = r2.tf32_units(A, B)
        require(tf32[case] > r2.DOT_C, f"the dot check passes a TF32 product "
                f"at M={case[0]}: {tf32[case]:.0f} units")
    del A, B
    k2 = 0.0
    for make in generate.BATTERY.values():
        csr = make()
        for block in (8, 1024):
            k2 = max(k2, kernel_vs_plain("flat_spmv_v2", csr,
                                         generate.make_input_vector(
                                             csr.shape[1]), block, device))
    torch.cuda.empty_cache()
    phase(18, "K12 and K2 vs plain", t0,
          f"saxpy: 8 cases, exact; K2 after the scan moved into seg_scan.cuh: "
          f"{2 * len(generate.BATTERY)} cases, max |kernel - plain| "
          f"{k2:.3e}; TF32 dots "
          + ", ".join(f"M={c[0]} {v:.0f}" for c, v in tf32.items())
          + f" units, past the dots' {r2.DOT_C} ")

    # ---- 19. the tier's path: the examples and scripts/h100_probes.py
    t0 = time.perf_counter()
    _build.reset_launches()
    for name, args in (("saxpy_torch.py", ["--device", "cuda"]),
                       ("range_torch.py", []),
                       ("custom_layout_torch.py", ["--device", "cuda"])):
        status, out, errs = run_example(name, args)
        for ln in out.splitlines():
            print(f"  {name}: {ln}")
        require(status == 0, f"{name}: exit status {status}\n{out}{errs}")
        require(name == "range_torch.py" or "Errors: 0" in out,
                f"{name}: {out}")
    spec = importlib.util.spec_from_file_location(
        "h100_probes", os.path.join(REPO, "scripts", "h100_probes.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    # every probe holds its kernel to the plain version before it times it
    status, recs = mod.main(["--device", "cuda"],
                            out=lambda ln: print(f"  h100_probes: {ln}"))
    require(status == 0, "scripts/h100_probes.py failed")
    for k in ("smem_scatter", "l2_scatter"):
        require(any(r["name"] == k and r.get("order_checked") for r in recs),
                f"{k} was not held to the order it keeps")
    launches = dict(_build.LAUNCHES)
    for k in PROBE_KERNELS:
        require(launches[k] > 0, f"{k} never launched on the tier's path")
    entries = {}
    for rec in recs:
        err[rec["name"]] = max(err[rec["name"]], rec["max_abs_err"])
        if rec["label"] == PROBE_ENTRIES[rec["name"]]:
            entries[rec["name"]] = rec
    # K12 at the example's shape (what its path launches) and at 2^26
    x, y = (torch.from_numpy(rng.normal(size=SAXPY_SHAPE).astype(
        np.float32)).to(device) for _ in range(2))
    entries["saxpy"] = common.record(
        "saxpy", "[8, 8192]", common.launch_ms(lambda: saxpy.saxpy_cuda(
            2.5, x, y), device),
        common.launch_ms(lambda: saxpy.saxpy_plain(2.5, x, y), device),
        common.launch_ms(lambda: torch.add(y, x, alpha=2.5), device),
        12 * x.numel(), 2 * x.numel(), "f32", err["saxpy"], "")
    xl, yl = (torch.randn(1 << 26, device=device) for _ in range(2))
    big_ms = common.launch_ms(lambda: saxpy.saxpy_cuda(2.5, xl, yl), device)
    add_ms = common.launch_ms(lambda: torch.add(yl, xl, alpha=2.5), device)
    print(f"  saxpy [8, 8192]: {entries['saxpy']['ms']:.4f} ms (plain "
          f"{entries['saxpy']['plain_ms']:.4f}, torch.add "
          f"{entries['saxpy']['library_ms']:.4f}); 2^26 elements: "
          f"{big_ms:.4f} ms = {12 * xl.numel() / big_ms / 1e6:.1f} GB/s "
          f"(torch.add {add_ms:.4f} ms)  [{smi}]")
    del xl, yl
    # at this size a call is the host's launch path: the device time of
    # one launch, from the profiler, beside the wall time of one call
    r = profile_applies(lambda _: saxpy.saxpy_cuda(2.5, x, y), x, applies=20,
                        warmup=3)
    if r["not_measured"]:
        print(f"  saxpy: {profile_text(r, 0)}  [{smi}]")
    else:
        kname, n, ms = r["kernels"][0]
        print(f"  saxpy: device {ms / n * 1e3:.2f} us per launch of "
              f"{kname[:40]} (torch.profiler), wall {r['wall_ms'] * 1e3:.2f} "
              f"us per call, idle {r['idle_share']:.1%}  [{smi}]")
    # the launch floor, two ways, and K13 against it: a kernel whose device
    # time is at most twice the floor reaches half its bound
    fl = entries["launch_floor"]
    floor = fl["floor_ms"]
    require(floor is not None and floor > 0, "the launch floor was not "
            "measured")
    print("  launch floor (launch_floor_kernel, one CTA of 32 threads): "
          + (f"{fl['profiler_us']:.3f} us (torch.profiler median of "
             f"{fl['profiler_n']} launches)" if fl["profiler_us"] is not None
             else "torch.profiler recorded no launch")
          + f", {fl['events_us']:.3f} us (CUDA events, "
          f"{mosaic.FLOOR_LAUNCHES} launches queued back to back); "
          f"{fl['ms'] * 1e3:.3f} us a call; the bound of a kernel whose bytes "
          f"and operations take less: {floor * 1e3:.3f} us  [{smi}]")
    sc, cn = entries["seg_scan_probe"], entries["construct_probe"]
    for k, c in {"seg_scan": sc, **cn["cases"]}.items():
        us = c["device_us"]
        verdict = ("device not measured (no launch in the trace)"
                   if us is None else
                   f"device {us:.3f} us, {us / (floor * 1e3):.2f}x the floor: "
                   + ("within 2x, half its bound or better" if us <= 2e3 * floor
                      else "past 2x"))
        lib = c.get("library_ms")
        print(f"  K13 {k}: {c['unbound_ms'] * 1e3:.3f} us a call unbound, "
              f"{c['ms'] * 1e3:.3f} us bound into out=; {verdict}"
              + ("" if k == "seg_scan" else "; library " + (
                  "none" if lib is None else f"{lib * 1e3:.3f} us"))
              + f"  [{smi}]")
    print(f"  K13 means: seg_scan {sc['unbound_ms'] * 1e3:.3f} -> "
          f"{sc['ms'] * 1e3:.3f} us a call, constructs "
          f"{cn['unbound_ms'] * 1e3:.3f} -> {cn['ms'] * 1e3:.3f} us (unbound "
          f"-> bound)  [{smi}]")
    # the smem scatter from an empty L2 against its bound and index_add_,
    # held bit for bit to its group order above
    sm = entries["smem_scatter"]
    b_ms, b_by = bound(sm["nbytes"], sm["flops"])
    print(f"  smem_scatter ({sm['label']}): {sm['ms']:.4f} ms one pass from "
          f"an empty L2, {b_ms / sm['ms']:.1%} of its {b_ms:.4f} ms bound "
          f"({b_by}); index_add_ {sm['library_ms']:.4f} ms "
          f"({sm['library_ms'] / sm['ms']:.2f}x); {r2.SMEM_GROUPS} groups a "
          f"tile in clusters of {r2.SMEM_CLUSTER} "
          f"({r2.smem_clusters(device=device)} such clusters run at once; "
          f"{r2.N // r2.SMEM_FT * r2.SMEM_GROUPS // r2.SMEM_CLUSTER} "
          f"needed), {r2.SMEM_STAGES} stages; the group order bit for bit on "
          f"normal slabs, 1 and 3 passes  [{smi}]")
    require(set(entries) == set(PROBE_KERNELS),
            f"no timed record for {set(PROBE_KERNELS) - set(entries)}")
    for k, rec in entries.items():
        dt = "bfloat16" if rec["peak"] == "bf16" else None
        # the kernels line keeps the bound of bytes and operations; the
        # floor stands beside it
        rec.update(zip(("bound_ms", "bound_by"),
                       bound(rec["nbytes"], rec["flops"], dt)))
        b_ms, b_by = bound(rec["nbytes"], rec["flops"], dt, floor=floor)
        m_ms, m_by = bound(rec["nbytes"], rec["flops"], dt, rate, floor)
        print(f"  {k} ({rec['label']}): kernel {rec['ms']:.4f} ms, plain "
              + (f"{rec['plain_ms']:.4f}" if rec["plain_ms"] is not None
                 else "-") + " ms, library "
              + (f"{rec['library_ms']:.4f} ms" if rec["library_ms"]
                 is not None else "none")
              + f"; bound {b_ms:.4f} ms ({b_by}) nominal, {m_ms:.4f} ms "
              f"({m_by}) at the measured stream; {b_ms / rec['ms']:.1%} of "
              f"the nominal bound  [{smi}]")
    # G3 at each W: bit for bit its plain version (held above), against
    # index_select and the bytes the function moves
    for rec in recs:
        if rec["name"] == "onehot_expand":
            b_ms, b_by = bound(rec["nbytes"], rec["flops"], "bfloat16")
            print(f"  onehot_expand ({rec['label']}): {rec['ms']:.4f} ms, "
                  f"index_select {rec['library_ms']:.4f} ms "
                  f"({rec['library_ms'] / rec['ms']:.2f}x); bound "
                  f"{b_ms:.4f} ms ({b_by}), {b_ms / rec['ms']:.1%} of it; "
                  f"exact  [{smi}]")
    # G1 at each residency (K = 128 f32) against embedding_bag, its rate
    # of row reads beside K11's at 64 MiB; P1 at each S against
    # take_along_dim; each beside its byte bound (both held bit for bit
    # above, G1 on normal and on integer slabs)
    for rec in recs:
        g1 = rec["name"].startswith("row_gather_sum_") \
            and rec["label"].endswith("K=128 f32")
        if not (g1 or rec["name"] == "gather_axis0"):
            continue
        b_ms, b_by = bound(rec["nbytes"], rec["flops"])
        row_gbps = gather.N_ROWS * gather.LANES * 4 / rec["ms"] / 1e6
        reads = (f"; row reads {row_gbps:.1f} GB/s (K11 at 64 MiB "
                 f"{rate64 / 1e9:.1f})" if g1 else "")
        print(f"  {rec['name']} ({rec['label']}): {rec['ms']:.4f} ms, "
              f"{'embedding_bag' if g1 else 'take_along_dim'} "
              f"{rec['library_ms']:.4f} ms "
              f"({rec['library_ms'] / rec['ms']:.2f}x); bound {b_ms:.4f} ms "
              f"({b_by}), {b_ms / rec['ms']:.1%} of it{reads}; exact  "
              f"[{smi}]")
    g3 = entries["onehot_expand"]
    print(f"  the two kernels redesigned last: onehot_expand "
          f"({g3['label']}) {g3['ms']:.4f} ms per launch, index_select "
          f"{g3['library_ms']:.4f} ms in this run "
          f"({g3['library_ms'] / g3['ms']:.2f}x); bcsr_spmv (32768^2) "
          f"{k6['cold_ms']:.4f} ms from an empty L2, cuSPARSE csrmv "
          + ("not run" if k6["library_ms"] is None
             else f"{k6['library_ms']:.4f} ms "
             f"({k6['library_ms'] / k6['cold_ms']:.2f}x)")
          + " (warm applies: " + f"{k6['apply_ms']:.4f} against "
          + ("not run" if k6["library_apply_ms"] is None
             else f"{k6['library_apply_ms']:.4f}")
          + "), torch.sparse_bsr_tensor "
          + ("not run" if k6["bsr_ms"] is None
             else f"{k6['bsr_ms']:.4f} ms") + f"  [{smi}]")
    torch.cuda.empty_cache()
    phase(19, "the K12-K15 tier's path", t0, f"{len(recs)} probe cases "
          "held to their plain versions, max |kernel - plain| "
          + ", ".join(f"{k} {v:.3e}" for k, v in err.items() if v)
          + " (the dots against float64); main-path launches "
          + json.dumps({k: launches[k] for k in PROBE_KERNELS}) + " ")
    return err, launches, entries, floor


def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from loops_tpu_torch.ops.kernels import _build
    from loops_tpu_torch.ops.spmv import SpMVOperator
    from loops_tpu_torch.utils import generate, reference
    from loops_tpu_torch.utils import launch_cost
    from loops_tpu_torch.utils.bench import apply_ms, device_ms
    from loops_tpu_torch.utils.equal import count_mismatches
    from loops_tpu_torch.utils.profile_spmv import MATRICES

    device = torch.device("cuda", 0)

    # ---- 1. card
    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi)
    kind = torch.cuda.get_device_name(0)
    phase(1, "card", t0, f"{kind}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; {torch.cuda.device_count()} visible ")

    # ---- 2. build
    t0 = time.perf_counter()
    _build.load_library()
    phase(2, "build", t0, f"nvcc {' '.join(_build.NVCC_FLAGS)}, one per "
          f"source in parallel, then linked -> "
          f"{os.path.relpath(_build.BUILD_INFO['path'], REPO)} in "
          f"{_build.BUILD_INFO['seconds']:.2f} s ")

    # ---- 3. kernels vs plain
    t0 = time.perf_counter()
    max_err = {k: 0.0 for k in KERNELS}
    n_cases = 0
    for name, make in generate.BATTERY.items():
        csr = make()
        x = generate.make_input_vector(csr.shape[1])
        for block in (8, 1024):
            for kname in KERNELS:
                max_err[kname] = max(max_err[kname],
                                     kernel_vs_plain(kname, csr, x, block,
                                                     device))
                n_cases += 1
    bench = MATRICES["bench_32768"]()
    x_bench = generate.make_input_vector(bench.shape[1])
    for kname in KERNELS:
        max_err[kname] = max(max_err[kname],
                             kernel_vs_plain(kname, bench, x_bench, None,
                                             device))
        n_cases += 1
    # each kernel writes every row itself: empty rows between blocks,
    # before the first and after the last
    for make in generate.SPMV_EDGE_CASES.values():
        csr = make()
        for block in (8, 64):
            for kname in KERNELS:
                max_err[kname] = max(max_err[kname], kernel_vs_plain(
                    kname, csr, generate.make_input_vector(csr.shape[1]),
                    block, device))
                n_cases += 1
    # one work_oriented block over 40000 rows, two of them with atoms
    wide = generate.wide_span_csr(40_000)
    for kname in ("flat_spmv_v2", "flat_spmv"):
        max_err[kname] = max(max_err[kname], kernel_vs_plain(
            kname, wide, generate.make_input_vector(wide.shape[1]), 8,
            device, schedule="work_oriented"))
        n_cases += 1
    phase(3, "kernels vs plain", t0,
          f"{n_cases} cases, max |kernel - plain| "
          + ", ".join(f"{k} {v:.3e}" for k, v in max_err.items()) + " ")

    # ---- 4. main path: the example CLI
    t0 = time.perf_counter()
    _build.reset_launches()
    mtx = os.path.join(REPO, "datasets", "chesapeake.mtx")
    for case in CLI_CASES:
        status, out, err = run_example(
            "spmv_torch.py", ["-m", mtx, "--validate", "--rigorous",
                              "--device", "cuda", *case])
        label = " ".join(case)
        csv = [ln for ln in out.splitlines() if ln.startswith("csr_")]
        print(f"  spmv_torch {label}: {csv[0] if csv else '?'} | "
              f"{err.strip()}")
        require(status == 0, f"spmv_torch {label}: exit status {status}\n"
                f"{out}{err}")
        require("Errors: 0" in out, f"spmv_torch {label}: {out}")
        require("Verdict: NOT_A_BUG" in out, f"spmv_torch {label}: {out}")
        if "auto" in case:
            require("impl_used: sorted_spmv" in err,
                    f"auto did not take K1: {err}")
    phase(4, "main path (examples/spmv_torch.py)", t0,
          f"{len(CLI_CASES)} cases ")

    # ---- 5. at scale, through SpMVOperator
    t0 = time.perf_counter()
    big = MATRICES["big_2097152"]()
    x_big = generate.make_input_vector(big.shape[1])
    mats = {"bench_32768": (bench, x_bench), "big_2097152": (big, x_big)}
    ops = {}
    for mname, (csr, x) in mats.items():
        for kname, (_, schedule, impl) in KERNELS.items():
            th = time.perf_counter()
            op = SpMVOperator(csr, schedule, block=BENCH_BLOCK, impl=impl,
                              device=device)
            build_s = time.perf_counter() - th
            require(op.impl_used == kname,
                    f"{mname}/{kname}: took {op.impl_used}")
            y = op(x).cpu().numpy()
            require(op.launches == 1, f"{mname}/{kname}: {op.launches} "
                    "launches")
            require(y.shape == (csr.shape[0],) and np.all(np.isfinite(y)),
                    f"{mname}/{kname}: bad output")
            errors = count_mismatches(y, reference.spmv(csr, x))
            rep = reference.rigorously_validate_spmv(csr, x, y)
            print(f"  {mname} ({csr.shape[0]}x{csr.shape[1]}, {csr.nnz} nnz) "
                  f"{kname}: Errors {errors}, Verdict {rep.verdict}, "
                  f"plan_ms {op.meta['plan_ms']:.1f}, operator build "
                  f"{build_s:.2f} s")
            require(errors == 0 and rep.verdict == "NOT_A_BUG",
                    f"{mname}/{kname}: {errors} errors, {rep}")
            ops[mname, kname] = op
    launches = dict(_build.LAUNCHES)
    for kname in KERNELS:
        require(launches[kname] > 0,
                f"{kname} never launched on the main path")
    phase(5, "at scale (SpMVOperator)", t0,
          "main-path launches " + json.dumps(launches) + " ")

    # ---- 6. timing: plain, kernel, kernel, plain; cuSPARSE once
    t0 = time.perf_counter()
    from loops_tpu_torch.ops.kernels import spmv_flat, spmv_flat_v2, spmv_sorted

    plains = {
        "sorted_spmv": lambda op: (lambda xd: spmv_sorted.sorted_spmv_plain(
            op._bufs, xd, None)),
        "flat_spmv_v2": lambda op: (lambda xd: spmv_flat_v2.flat_spmv_v2_plain(
            op._bufs, xd, op.mat.shape)),
        "flat_spmv": lambda op: (lambda xd: spmv_flat.flat_spmv_plain(
            op._bufs, xd, op.mat.shape, op.meta["R"])),
    }
    times = {}
    for mname, (csr, x) in mats.items():
        xd = torch.from_numpy(x).to(device)
        A = torch.sparse_csr_tensor(
            torch.from_numpy(csr.offsets).to(device),
            torch.from_numpy(csr.indices).to(device),
            torch.from_numpy(csr.vals).to(device), size=csr.shape)
        y_cs = torch.mv(A, xd)
        require(bool(torch.isfinite(y_cs).all()), "cuSPARSE: bad output")
        cusparse_ms = apply_ms(lambda v: torch.mv(A, v), xd)
        for kname in KERNELS:
            op = ops[mname, kname]
            plain = plains[kname](op)
            if mname == "big_2097152":
                diff = np.abs(op(xd).cpu().numpy().astype(np.float64)
                              - plain(xd).cpu().numpy())
                require(np.all(diff <= pair_tolerance(csr, x)),
                        f"{kname}: kernel and plain differ by {diff.max()}")
                max_err[kname] = max(max_err[kname],
                                     float(diff.max(initial=0.0)))
            p1 = apply_ms(plain, xd)
            k1 = apply_ms(op, xd)
            k2 = apply_ms(op, xd)
            p2 = apply_ms(plain, xd)
            times[mname, kname] = dict(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
                                       cusparse_ms=cusparse_ms,
                                       plan_ms=op.meta["plan_ms"])
            print(f"  {mname} {kname}: kernel {k1:.4f}/{k2:.4f} ms, plain "
                  f"{p1:.4f}/{p2:.4f} ms, cuSPARSE {cusparse_ms:.4f} ms, "
                  f"host plan {op.meta['plan_ms']:.1f} ms  [{smi}]")
        # each kernel's host share: the card's own time per apply (the
        # applies queued behind a sleep kernel) against back-to-back
        # applies
        for kname in KERNELS:
            op = ops[mname, kname]
            k_apply = apply_ms(op, xd)
            k_card = device_ms(op, xd)
            print(f"  {mname} {kname}: apply {k_apply:.4f} ms, card "
                  f"{k_card:.4f} ms, host share "
                  f"{1 - k_card / k_apply:.3f}  [{smi}]")
        del A
    parts = launch_cost.launch_path_parts(device)
    print(f"  launch path, host us per call (less {parts['empty_us']:.3f} "
          f"us of an empty call), {smi}:")
    for key in ("parts", "calls"):
        for label, us in parts[key].items():
            print(f"    {label}: {us:.2f}")
    phase(6, "timing (CUDA events, median per apply)", t0)

    # ---- 7. K4 vs plain, forward and backward
    t0 = time.perf_counter()
    from loops_tpu_torch.io import ogb
    from loops_tpu_torch.models import GCN
    from loops_tpu_torch.models import train as T
    from loops_tpu_torch.ops.kernels import spmm_flat
    from loops_tpu_torch.ops.spmm import SpMMOperator
    from loops_tpu_torch.utils.profile_spmv import profile_applies
    from loops_tpu_torch.utils.timer import time_fn

    def median_ms(fn, iters):
        return time_fn(fn, device=device, warmup=2, iters=iters,
                       reduction=statistics.median)

    th = time.perf_counter()
    ds = ogb.load("ogbn-arxiv")
    graph = ds.graph
    adj = graph.gcn_normalized().adj
    ds_s = time.perf_counter() - th
    print(f"  arxiv-shaped dataset: {graph.num_nodes} nodes, "
          f"{graph.num_edges} edges, GCN adjacency {adj.nnz} nnz, longest "
          f"row {int(adj.row_sizes().max())}, {int(ds.train_mask.sum())} "
          f"train rows; built in {ds_s:.2f} s")
    spmm_err = 0.0
    n_cases = 0
    spmm_mats = {**{k: make() for k, make in generate.BATTERY.items()},
                 **{k: make() for k, make in generate.SPMM_EDGE_CASES.items()},
                 "bench_32768": bench, "arxiv_gcn": adj}
    for mname, csr in spmm_mats.items():
        rng = np.random.default_rng(7)
        B_all = rng.normal(size=(csr.shape[1], max(SPMM_FS))).astype(
            np.float32)
        for F in SPMM_FS:
            B = np.ascontiguousarray(B_all[:, :F])
            for dtype in DTYPES:
                for block in SPMM_BLOCKS:
                    label = f"{mname} F={F} {dtype or 'f32'} block={block}"
                    spmm_err = max(spmm_err, spmm_vs_plain(
                        label, csr, B, block, dtype, device))
                    n_cases += 1
    for F in (40, 128):
        for dtype in DTYPES:
            spmm_err = max(spmm_err, backward_vs_plain(
                graph, ds.train_mask, F, dtype, device))
            n_cases += 1
    phase(7, "K4 vs plain", t0, f"{n_cases} cases (incl. 4 backward), "
          f"bit for bit, max |kernel - plain| {spmm_err:.3e} ")

    # ---- 8. GCN inference at full width (the main path starts here)
    t0 = time.perf_counter()
    _build.reset_launches()
    dims = [ds.features.shape[1], GCN_HIDDEN, GCN_HIDDEN, ds.num_classes]
    th = time.perf_counter()
    model = GCN(graph, dims, dropout=0.5, device=device,
                generator=torch.Generator().manual_seed(0))
    gcn_build_s = time.perf_counter() - th
    require(all(op.impl_used == "flat_spmm" for op in model.operators()),
            f"GCN took {[op.impl_used for op in model.operators()]}")
    acc = {m: T.evaluate(model, ds.features, ds.labels, getattr(ds, m))
           for m in ("val_mask", "test_mask")}
    ref = GCN(graph, dims, schedule="group_mapped", device=device)
    ref.load_state_dict(model.state_dict())
    model.eval()
    ref.eval()
    with torch.no_grad():
        lk = model(model.prepare_features(ds.features)).cpu().numpy()
        lg = ref(ref.prepare_features(ds.features)).cpu().numpy()
    require(lk.shape == (graph.num_nodes, ds.num_classes)
            and np.all(np.isfinite(lk)), "evaluate: bad logits")
    scale = float(np.abs(lg).max())
    logit_diff = float(np.abs(lk - lg).max())
    agree = float((lk.argmax(1) == lg.argmax(1)).mean())
    require(logit_diff <= 1e-4 * max(scale, 1.0),
            f"K4 and group_mapped logits differ by {logit_diff:.3e}")
    require(agree >= 0.999, f"argmax agrees on {agree:.4%} of rows")
    acc_ref = {m: T.evaluate(ref, ds.features, ds.labels, getattr(ds, m))
               for m in ("val_mask", "test_mask")}
    print(f"  evaluate (f32, K4): val {acc['val_mask']:.4f} test "
          f"{acc['test_mask']:.4f}; group_mapped: val "
          f"{acc_ref['val_mask']:.4f} test {acc_ref['test_mask']:.4f}; "
          f"max |logit diff| {logit_diff:.3e} (max |logit| {scale:.3e}), "
          f"argmax agree {agree:.6f}; GCN build {gcn_build_s:.2f} s; "
          f"TF32 matmul {torch.backends.cuda.matmul.allow_tf32}")
    phase(8, "GCN inference at full width", t0)

    # ---- 9. GCN training at full width
    t0 = time.perf_counter()
    fast = GCN(graph, dims, dropout=0.5, dtype="bfloat16",
               precompute_first=True, loss_rows=ds.train_mask, device=device,
               generator=torch.Generator().manual_seed(0))
    require(all(op.impl_used == "flat_spmm" for op in fast.operators()),
            f"throughput GCN took {[op.impl_used for op in fast.operators()]}")
    step = T.make_train_step(
        fast, torch.optim.Adam(fast.parameters(), lr=1e-2), ds.features,
        ds.labels, ds.train_mask,
        generator=torch.Generator(device).manual_seed(1))
    losses = [float(step()) for _ in range(10)]
    require(np.all(np.isfinite(losses)), f"train losses {losses}")
    require(fast.launches() > 0, "the train steps launched no K4")
    print(f"  10 bf16 throughput-form steps: losses {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}, K4 launches {fast.launches()}")
    status, out, err = run_example("train_gcn_torch.py", [
        "--dataset", "ogbn-arxiv", "--scale", "1.0", "--epochs", "20",
        "--device", "cuda"])
    for ln in out.splitlines() + err.splitlines():
        print(f"  train_gcn_torch: {ln}")
    require(status == 0, f"train_gcn_torch: exit status {status}")
    require("test_accuracy:" in out, "train_gcn_torch printed no accuracy")
    require("impl_used: flat_spmm" in err,
            f"train_gcn_torch did not take K4: {err}")
    gcn_launches = dict(_build.LAUNCHES)
    require(gcn_launches["flat_spmm"] > 0, "K4 never launched on the GCN path")
    phase(9, "GCN training at full width", t0,
          "main-path launches " + json.dumps(gcn_launches) + " ")

    # ---- 10. timing at F = 128 on the arxiv adjacency; GCN step and eval
    t0 = time.perf_counter()
    B128 = np.random.default_rng(8).normal(size=(adj.shape[1], 128)).astype(
        np.float32)
    Bd = torch.from_numpy(B128).to(device)
    spmm_times = {}
    for dtype in DTYPES:
        name = dtype or "f32"
        k4 = SpMMOperator(adj, "merge_path", "pallas", dtype=dtype,
                          device=device)
        builds = {}
        for sched in ("group_mapped", "row_mapped"):
            th = time.perf_counter()
            builds[sched] = SpMMOperator(adj, sched, dtype=dtype,
                                         device=device)
            builds[sched].build_ms = (time.perf_counter() - th) * 1e3

        def plain(B, op=k4, dtype=dtype):
            return spmm_flat.flat_spmm_plain(op._bufs, B, adj.shape, dtype)
        p1 = apply_ms(plain, Bd)
        k1 = apply_ms(k4, Bd)
        k2 = apply_ms(k4, Bd)
        p2 = apply_ms(plain, Bd)
        gm = apply_ms(builds["group_mapped"], Bd)
        rm = apply_ms(builds["row_mapped"], Bd)
        tdt = torch.float32 if dtype is None else torch.bfloat16
        A = torch.sparse_csr_tensor(
            torch.from_numpy(adj.offsets).to(device),
            torch.from_numpy(adj.indices).to(device),
            torch.from_numpy(adj.vals).to(device, tdt), size=adj.shape)
        Bc = Bd.to(tdt)
        try:
            cs = apply_ms(lambda B: torch.sparse.mm(A, B), Bc)
        except RuntimeError as e:  # timed only: a dtype cuSPARSE refuses
            cs = None
            print(f"  cuSPARSE {name}: not run ({str(e).splitlines()[0]})")
        spmm_times[name] = dict(ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
                                library_ms=cs)
        print(f"  arxiv_gcn F=128 {name}: K4 {k1:.4f}/{k2:.4f} ms, plain "
              f"{p1:.4f}/{p2:.4f} ms, group_mapped {gm:.4f} ms, row_mapped "
              f"{rm:.4f} ms, cuSPARSE "
              f"{'n/a' if cs is None else f'{cs:.4f} ms'}; host plan: K4 "
              f"{k4.meta['plan_ms']:.1f} ms, group_mapped build "
              f"{builds['group_mapped'].build_ms:.1f} ms, row_mapped build "
              f"{builds['row_mapped'].build_ms:.1f} ms  [{smi}]")
        del A, Bc, k4, builds
    slow = GCN(graph, dims, dropout=0.5, device=device,
               generator=torch.Generator().manual_seed(0))
    th = time.perf_counter()
    step_f32 = T.make_train_step(
        slow, torch.optim.Adam(slow.parameters(), lr=1e-2), ds.features,
        ds.labels, ds.train_mask,
        generator=torch.Generator(device).manual_seed(1))
    prep_s = time.perf_counter() - th
    on_card = [torch.from_numpy(a).to(device)
               for a in (ds.features, ds.labels, ds.test_mask)]

    def evaluate_on_card(_=None):
        return T.evaluate(model, *on_card)
    ms_fast = median_ms(step, 10)
    ms_slow = median_ms(step_f32, 10)
    ms_eval = median_ms(lambda: T.evaluate(model, ds.features, ds.labels,
                                           ds.test_mask), 5)
    ms_eval_card = median_ms(evaluate_on_card, 5)
    print(f"  GCN train step: throughput form (bf16, precompute_first, "
          f"loss_rows) {ms_fast:.3f} ms, default form (f32) {ms_slow:.3f} "
          f"ms; evaluate (f32, full graph) {ms_eval:.3f} ms from host "
          f"arrays, {ms_eval_card:.3f} ms from tensors on the card; host "
          f"plan of the models' K4 operators "
          f"{sum(op.meta['plan_ms'] for op in fast.operators()):.1f} ms "
          f"(throughput form), "
          f"{sum(op.meta['plan_ms'] for op in slow.operators()):.1f} ms "
          f"(default form); step set-up {prep_s * 1e3:.1f} ms  [{smi}]")
    for label, fn in (("throughput-form step", lambda _: step()),
                      ("evaluate from tensors on the card",
                       evaluate_on_card)):
        r = profile_applies(fn, Bd, applies=10, warmup=2)
        print(f"  profile {label}: {profile_text(r, 8, width=48)}")
    # (evaluate ends in a host sync: the card alone is not measurable so)
    print(f"  throughput-form step: {card_text(lambda _: step(), Bd)}"
          f"  [{smi}]")
    phase(10, "GCN timing (CUDA events, median)", t0)
    del model, ref, fast, slow, step, step_f32, on_card, Bd
    torch.cuda.empty_cache()

    bcsr_err, bcsr_launches, bcsr_times, bcsr_mats = bcsr_phases(device, smi)
    stream_res = stream_phase(device, smi)
    rate = stream_res["1 GiB"]["gbps"] * 1e9
    sddmm_err, sddmm_launches, sddmm_times, sddmm_bounds = sddmm_phases(
        device, smi, adj, rate)
    probe_err, probe_launches, probe_recs, floor = probe_phases(
        device, smi, rate, bcsr_times["bcsr_spmv", None],
        stream_res["64 MiB"]["gbps"] * 1e9)

    print(f"total {time.perf_counter() - t_start:.1f} s; card: {smi}")
    kernels = []
    big = mats["big_2097152"][0]
    spmv_mat, spmm_mat = bcsr_mats
    bounds = {
        **{k: (lambda r: csr_spmv_bound(big, r)) for k in KERNELS},
        "flat_spmm": lambda r: csr_spmm_bound(adj, 128, r),
        "bcsr_spmv": lambda r: bcsr_bound(spmv_mat, rate=r),
        **{k: (lambda r: bcsr_bound(spmm_mat, SPMM_F, rate=r))
           for k in BCSR_KERNELS if k != "bcsr_spmv"},
        **sddmm_bounds,
        "stream_read": lambda r: bound(stream_res["1 GiB"]["nbytes"], 0,
                                       rate=r),
        **{k: (lambda r, rec=rec: bound(
            rec["nbytes"], rec["flops"],
            "bfloat16" if rec["peak"] == "bf16" else None, r))
           for k, rec in probe_recs.items()},
    }
    for k, (rep_at, _, _) in KERNELS.items():
        b_ms, b_by = csr_spmv_bound(big)
        kernels.append(
            {"name": k, "route": "cuda", "source": SOURCE, "replaces": rep_at,
             "launches": launches[k], "max_abs_err": max_err[k],
             "ms": times["big_2097152", k]["ms"],
             "plain_ms": times["big_2097152", k]["plain_ms"],
             "bound_ms": b_ms, "bound_by": b_by,
             "library_ms": times["big_2097152", k]["cusparse_ms"]})
    b_ms, b_by = csr_spmm_bound(adj, 128)
    kernels.append(
        {"name": "flat_spmm", "route": "cuda", "source": SPMM_SOURCE,
         "replaces": SPMM_REPLACES, "launches": gcn_launches["flat_spmm"],
         "max_abs_err": spmm_err, "ms": spmm_times["f32"]["ms"],
         "plain_ms": spmm_times["f32"]["plain_ms"], "bound_ms": b_ms,
         "bound_by": b_by, "library_ms": spmm_times["f32"]["library_ms"]})
    for k, (rep_at, _, _) in BCSR_KERNELS.items():
        kernels.append(
            {"name": k, "route": "cuda", "source": BCSR_SOURCE,
             "replaces": rep_at, "launches": bcsr_launches[k],
             "max_abs_err": bcsr_err[k],
             **{f: bcsr_times[k, None][f] for f in (
                 "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}})
    for k, label in (("sddmm_flat", "bench_65536 F=128"),
                     ("sddmm_bcsr", "bcsr_16384 F=512")):
        kernels.append(
            {"name": k, "route": "cuda", "source": SDDMM_SOURCE,
             "replaces": SDDMM_KERNELS[k], "launches": sddmm_launches[k],
             "max_abs_err": sddmm_err[k], **sddmm_times[label]})
    # at 1 GiB, where no pass fits the L2, so the byte bound holds;
    # torch.sum is both the plain version and the one library call
    s1g = stream_res["1 GiB"]
    b_ms, b_by = bounds["stream_read"](HBM_BYTES_PER_S)
    kernels.append(
        {"name": "stream_read", "route": "cuda", "source": STREAM_SOURCE,
         "replaces": STREAM_REPLACES,
         "launches": sddmm_launches["stream_read"], "max_abs_err": s1g["err"],
         "ms": s1g["ms"], "plain_ms": s1g["plain_ms"], "bound_ms": b_ms,
         "bound_by": b_by, "library_ms": s1g["plain_ms"]})
    for k, (source, rep_at) in PROBE_KERNELS.items():
        rec = probe_recs[k]
        kernels.append(
            {"name": k, "route": "cuda", "source": source,
             "replaces": rep_at, "launches": probe_launches[k],
             "max_abs_err": probe_err[k], "ms": rec["ms"],
             "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
             "bound_by": rec["bound_by"], "library_ms": rec["library_ms"]})
    print(f"measured stream (K11, 1 GiB): {rate / 1e9:.1f} GB/s; each "
          "kernel's bound at the nominal 3.35 TB/s and at the measured "
          f"rate, and no less than the launch floor, {floor * 1e3:.3f} us  "
          f"[{smi}]")
    for entry in kernels:
        # bound_ms stays the bound of bytes and operations; the floor
        # stands beside it, and the check takes the larger
        entry["launch_floor_ms"] = floor
        nom, by = max(bounds[entry["name"]](HBM_BYTES_PER_S),
                      (floor, "launch"), key=lambda b: b[0])
        meas, mby = max(bounds[entry["name"]](rate), (floor, "launch"),
                        key=lambda b: b[0])
        print(f"  {entry['name']}: {entry['ms']:.4f} ms; bound {nom:.4f} ms "
              f"({by}) nominal, {meas:.4f} ms ({mby}) measured; "
              f"{meas / entry['ms']:.1%} of the measured bound")
        # a time under the least the card could take is a timing or a
        # bound that is wrong
        require(nom <= entry["ms"], f"{entry['name']}: {entry['ms']:.4f} ms "
                f"is under its nominal bound {nom:.4f} ms")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
