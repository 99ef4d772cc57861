#!/usr/bin/env python3
"""Smoke run of loops_tpu_torch, the PyTorch + CUDA port, on one NVIDIA card.

    python3 chip_smoke.py

Phases, one line each with its time:

1. card:   ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build:  nvcc builds the kernels from ``loops_tpu_torch/csrc`` (one nvcc
   per source, in parallel, then one link): K1–K3, K4, K6–K9, K5, K10
   and K11; g++ builds their launch binding (a CPython extension
   generated from ``_build._SIGNATURES``, ``Python.h`` only), through
   which every launch of the run goes;
3. kernels vs plain: K1 (``sorted_spmv``), K2 (``flat_spmv_v2``) and K3
   (``flat_spmv``) against their plain PyTorch versions on the same staged
   buffers, on the 9-matrix battery (blocks 8 and 1024), on the bench
   matrix (32768^2, ~4.39M nnz), on ``generate.SPMV_EDGE_CASES`` (empty
   rows between blocks, before the first, after the last; blocks 8 and
   64) and, for K2 and K3, on one work_oriented block over a 40064-row
   window: agreement, the Wilkinson verdict, two runs bitwise equal, the
   launch counter, and each kernel once more into a y filled with NaN
   (each writes every row of a ``torch.empty`` y); K1, under 200,000
   nonzeros, also bit for bit against its numpy mirror
   (``spmv_sorted.sorted_spmv_mirror``: its CTA ranges, pieces and seams);
4. main path: ``examples/spmv_torch.py`` on ``datasets/chesapeake.mtx`` with
   ``--validate --rigorous`` for every schedule and kernel impl;
5. at scale: ``SpMVOperator`` with each kernel on the bench matrix and on
   2097152^2 with ~33.5M nnz, and K1 on the xl tier's
   ``xl_banded_67108864`` and ``xl_uniform_67108864`` (4194304^2, 67.1M
   nnz; built in two spawned processes from the start of the run), each
   result validated. The launch counters are set to 0 before phase 4 and
   read after phase 5: every kernel must have launched on the main path;
6. timing: per apply, the median of CUDA-event timings, of each kernel, its
   plain version and cuSPARSE's CSR SpMV (the paper's opponent, timed only),
   with the host plan time; each kernel's time on the card alone
   (``utils/bench.device_ms``: the applies queued behind a sleep kernel)
   and its host share ``1 - device / apply``; K1 on the two xl matrices
   beside cuSPARSE, both by apply and by card time, with the byte bound
   of ``utils/counters``; and the host launch path taken apart
   (``utils/launch_cost.py``: host microseconds per call of each part and
   of the whole calls of K1, K12 and ``torch.add``), with K1's and K12's C
   call through the launch binding beside the same entry point through a
   ctypes handle opened for the comparison;
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
   at the example's [8, 8192], at odd sizes and on an unaligned view, and
   at each of ``SAXPY_OFFSET_SIZES`` (0 to 2^20 + 7 elements) with x and
   y 0-3 floats past 16 bytes (NaN-filled buffers: the float4 body and
   its tail at 0, the scalar loop else); K2
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
   to 0 before and read after: every K12-K15 kernel must have launched;
20. GraphSAGE at full width (``models/sage.py``, ``models/sampling.py``;
   torch ops with K4 under them). First K4 through the models' own
   operators at the widths this phase gives it, against its plain version
   bit for bit (the arxiv stand-in's mean-normalized A and Aᵀ at F = 128,
   f32 and bf16; the products stand-in's A at F = 100 and 256, the plain
   version 10 columns at a time), 256 sampled rows each within the
   Wilkinson bound. Then, with the launch counters set to 0: full-graph
   SAGE on the arxiv stand-in of phase 7 (dims [128, 128, 128, 40]) in f32
   and bf16, on ``group_mapped`` and on ``merge_path``/``pallas``
   (K4): the routes' logits within 1e-4 of the largest in f32 and one bf16
   ulp of it (2**-7) in bf16, A hx and the backward Aᵀ ct of both routes
   within twice the Wilkinson bound (in bf16 plus one rounding of each
   product: group_mapped's hub rows are f32), 3 Adam steps run twice from
   one state bitwise equal, the step and ``evaluate`` medians; then
   sampled SAGE on the ``ogbn-products`` stand-in at the real 2,449,029
   nodes (synthetic; ~114.8M directed edges; dims [100, 256, 256, 47],
   fanouts [15, 10, 5], batch 1024, the OGB GraphSAGE-on-products
   settings), the host time of building it printed: 5 steps run twice
   from one generator state bitwise equal, every sampled id checked
   against the CSR on the host, the loss falling over 20 steps, the step
   median, sampled edges a second, the full-graph ``evaluate`` on K4,
   the peak memory, a ``torch.profiler`` breakdown of a step and its card
   time by ``utils/bench.device_ms``. K4 must have launched; its launches
   join phase 9's in the kernels line.
21. GAT and GATv2 at full width (``ops/attention.py``, ``models/gat.py``,
   ``models/gatv2.py``; torch ops, no kernel: the launch counters must
   stay at 0). The arxiv stand-in of phase 7 with self-loops (2,465,171
   edges; its forward and transposed plans built once, their host times
   printed), dims [128, 64, 40] at 4 heads, the JAX package's full-scale
   GAT shape (``scripts/tpu_gat_bench.py:41-46, 64``). GAT on three
   routes (fused with the transposed-plan backward, fused through
   autograd, textbook) and GATv2 on two (fused, textbook), f32 and, on
   the fused routes, bf16: the routes' logits within 1e-4 of the largest
   and their parameter gradients those of the fused route within
   ``1e-4 + 1e-4 |g|`` (the CPU tests' ``rtol = atol``) and within 1e-2
   of the parameter's largest entry, printed beside each difference;
   layer 0's aggregation on 4,096 sampled rows with the hub row within
   ``1e-4 + 1e-4 |ref|`` of the f64 oracle; bf16 within ``0.05 + 0.05 |f32|`` of f32 on the same
   inputs (the JAX package's own bound); 3 Adam steps run twice from one
   state bitwise equal; the step and ``evaluate`` medians, edges a second
   (with self-loops), the peak memory, the bytes a pass reading each
   edge's row once would move, and a ``torch.profiler`` breakdown and
   ``device_ms`` of the fused GAT step;
22. formats at full width (``formats/{ell,dia,advisor}.py``,
   ``layout/reorder.py``; torch ops, and K1, K2, K4 and K6 where a route
   reaches them). big_2097152: COO (row_mapped, merge_path), CSC, ELL
   (row_mapped, merge_path; pitch the largest row), ``flat_partitioned_spmv``
   and ``reorder='degree'`` under ``auto`` (K1) and ``merge_path``/
   ``pallas2`` (K2), beside K1; band_2097152_b4 (9 diagonals): DIA, ELL
   and K1; bcsr_spmv_32768: K6 and K1; the arxiv stand-in:
   ``reorder='bfs'`` under ``auto`` beside K1, COO SpMM at F = 128 beside
   K4; bench_32768: ELL SpMM at F = 128 beside K4; ``--format auto``
   through ``examples/spmv_torch.py`` on big_2097152, band_2097152_b4 and
   bcsr_spmv_32768. Each route: no mismatch against the CPU reference,
   256 sampled rows within the Wilkinson bound, two applies bitwise equal
   on the deterministic routes (COO/CSC row_mapped, ELL's plane, DIA, the
   flat partitioner, COO and ELL SpMM), SpMM within twice the Wilkinson
   bound of K4; then its ms per apply beside K1's (or K4's) on the same
   matrix, its one-pass byte bound (its values and indices, padding
   included, and x/y), host staging ms and peak memory. The advisor's
   pick against the fastest format measured, and the advisor's cost row
   made from these times. The launch counters are set to 0 before the
   routes and read before the timing; K1's, K2's, K4's and K6's launches
   join their rows of the kernels line.
23. the sweep and the refits (``utils/battery.py``, ``utils/statmatch.py``,
   ``tuning/{sweep,fit,autotune}.py``; K1, K2 and cuSPARSE under the
   sweep, K2, K3 and K4 under the autotuner): the sweep in-process over
   one matrix of each synthetic family, the smallest stat-matched replica
   of each family and ``xl_uniform_16777216`` (16.8M nonzeros), the five
   schedules and the vendor, each held to the Wilkinson bound and timed
   (``apply_ms`` and ``device_ms``), no pair refused or wrong; the fitter
   over the committed ``plots/data/h100`` logs, from their
   ``features.csv``, equal to the card's rows in ``schedule/plans.py``
   (``CARD_THRESHOLDS``, ``CARD_SPMM_ROUTES``); ``schedule="auto"`` on a
   matrix of each branch of the card's row taking that branch with the
   impl the sweep timed it with (and SpMM's on the arxiv stand-in);
   ``auto`` on the arxiv stand-in beside K1 and group_mapped (and with
   ``reorder='bfs'``, as phase 22 runs it); ``autotune`` into a temporary
   cache.
   The launch counters are set to 0 before and read after: K1, K2, K3 and
   K4 must have launched; their launches join the kernels line.
24. out-of-core and the plan cache (``native/``, ``io/plan_cache.py``,
   ``io/shards.py``, ``utils/outofcore.py``; K1 and K4): (a) the native
   library builds with g++ and its ``coo_to_csr`` and ``unique_remap``
   equal numpy's stable lexsort and ``np.unique`` on 10M seeded
   nonzeros; (b) ``SpMVOperator(schedule="sorted_flat", plan_cache=)``
   twice on big_2097152 (33.5M nnz): the first plan built, the second
   loaded from the cache, the two ``y`` bitwise equal and the second
   Wilkinson-checked, both ``plan_ms`` printed; (c) the out-of-core
   bench at ``scripts/bench_outofcore.py``'s documented size (10,000,000
   nodes, average degree 15, ~150M edges, 16 shards, F = 128, f32):
   the graph staged into shards on disk, each planned on its own, the
   feature table and the output as memmaps on disk, and the stream
   through K4 (``merge_path``, every shard staged to the store's
   ``pad_groups``/``pad_R``): stage, plan and stream seconds, edges a
   second, each shard's split (staging, host gather, upload, K4 by CUDA
   events, download) beside K4's byte bound for the shard, the padded
   groups and R, the peak device memory; held by the heaviest row (as
   the reference script holds it), ``validate_sampled_rows``' 256 rows,
   and against one unsharded K4 pass of the whole CSR within twice the
   Wilkinson bound on every entry; and for the shards padded the most
   and the least, K4 on the store's padded staging on the card equals,
   bit for bit, K4's plain version on the same buffers, K4 of the same
   shard staged without ``pad_groups``/``pad_R`` or with twice the
   store's blocks, and the rows the stream wrote; (d) K4 in bf16 and ``row_mapped`` at the script's
   default 2,000,000 nodes, each held by the heaviest row and the
   sampled rows, and bf16 K4's padded staging held bit for bit as in
   (c). Its files live in a temporary directory (~13 GB
   at the peak of (c)), removed at the end. Launches of the checks are
   not counted; K1's and K4's main-path launches join the kernels line.
25. the multi-device tier at full width (``parallel/``; K4 in each
   rank's local reduction): a one-rank NCCL group through a file store
   (``parallel/launch.single_rank``) and its meshes, ``(1,)`` over
   ``graph`` and ``(1, 1)`` over ``("host", "chip")``; DistGCN on phase
   7's arxiv stand-in at phase 8's dims [128, 128, 128, 40], f32,
   through the overlapped halo, the all-gather and the hierarchical
   exchange, from the parameters of a single-device GCN (dropout 0):
   logits within ``1e-4 * max(|logit|, 1)`` of that GCN's and 10 Adam
   steps' losses within 1e-3 relative of its own; a one-shard
   ``ShardedCSR`` of the adjacency through ``EdgePartition.from_shards``
   and DistSpMMHier at F = 128 within twice the Wilkinson bound of
   ``SpMMOperator`` (printed: whether bit for bit); DistSpMMHalo's apply
   and DistGCN's train step beside ``SpMMOperator``'s and GCN's, with
   card times. The group is destroyed; then ``dryrun_multichip(8)``: 8
   gloo ranks on the host's CPU (not the card: one card holds one NCCL
   rank). K4 must have launched; its main-path launches join the
   kernels line.
26. tooling and the training record at full width
   (``scripts/train_record_torch.py``, ``utils/trace.py``,
   ``utils/counters.py``, ``scripts/run_torch.sh``; K4, and K1 under the
   counters and the sweep script): the accuracy-matched training record
   (``run_one``) on phase 7's arxiv stand-in, GCN and GraphSAGE, each on
   the exact path (``group_mapped``/``xla``: no launch) and the
   throughput path (``auto``, bf16: K4 launched), ``RECORD_EPOCHS``
   epochs, its table printed, the two paths' test accuracies within
   ``RECORD_ACC_GAP`` for each model; five throughput GCN steps in
   ``trace.profile``, each in ``annotate``: the port's kernel record
   holding every K4 launch the counters saw, its device ms under the
   window's wall time, both files written, the Chrome trace holding every
   step's range, and whether ``torch.profiler``'s own list was whole;
   ``compiled_counters`` and ``achieved`` on one such step, on K1 at
   big_2097152 and on K4 at arxiv F = 128 (f32 and bf16) with this
   phase's timings: bytes and flops equal to the kernels line's, every
   utilization at most 1.05; ``scripts/run_torch.sh`` over ``datasets/``
   on the card: five CSVs of one row each. The record's and the traced
   steps' K4 launches join the kernels line.

Each kernel's bound is the larger of its bytes (each input read once,
each output written once) over 3.35 TB/s and its flops over the H100
SXM's peak for its type (67 TFLOP/s f32 on the CUDA cores, 989 bf16)
(``bound_ms`` in the kernels line), and of the launch floor measured in
phase 19 (``launch_floor_ms`` beside it): the check below and the printed
shares take the larger. The work formulas and the rates live in
``loops_tpu_torch/utils/counters.py``, which ``compiled_counters`` reads
too. Every time compared with it is per call or per
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
from dataclasses import astuple

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
# phases 5 and 6: K1 on the xl tier's two 64M-nonzero matrices, the one
# whose gathers are local and the one whose gathers are random
# (utils/statmatch.xl_battery; built in spawned host processes from the
# start of the run), and the largest matrix K1's mirror is held to in
# phase 3
XL_MATRICES = ("xl_banded_67108864", "xl_uniform_67108864")
MIRROR_NNZ = 200_000
SPMM_SOURCE = "loops_tpu_torch/csrc/spmm.cu"
SPMM_REPLACES = "loops_tpu/ops/kernels/spmm_flat.py:48"
SPMM_FS = (5, 40, 128)
SPMM_BLOCKS = (8, 512)
DTYPES = (None, "bfloat16")
GCN_HIDDEN = 128
# phase 20: the OGB GraphSAGE-on-products settings (widths, fanouts,
# batch) on the ogbn-products stand-in at the real graph's node count
# (200,000 nodes at scale 1, io/ogb.py)
SAGE_STEPS = 3
SAMPLED_HIDDEN, SAMPLED_FANOUTS, SAMPLED_BATCH = 256, [15, 10, 5], 1024
SAMPLED_STEPS, SAMPLED_DESCENT_STEPS = 5, 20
# phase 21: the JAX package's full-scale GAT shape, dims [128, 64, 40] at 4
# heads (scripts/tpu_gat_bench.py:41-46, 64; bench.py:541)
GAT_HIDDEN, GAT_HEADS, GAT_STEPS = 64, 4, 3
GAT_ROWS = 4096
# phase 22: SpMM's width beside K4, and the matrices the CLI's
# --format auto runs on (utils/generate.SCALE_MATRICES)
FORMAT_F = 128
ADVISOR_MATRICES = ("big_2097152", "band_2097152_b4", "bcsr_spmv_32768")
# phase 24: the out-of-core bench at the size scripts/bench_outofcore.py
# documents (--nodes 10000000 --avg-deg 15 --shards 16 --feat 128, ~150M
# edges), and at its default --nodes for bf16 and row_mapped
OOC_NODES, OOC_AVG_DEG, OOC_SHARDS, OOC_FEAT = 10_000_000, 15, 16, 128
OOC_SMALL_NODES = 2_000_000
OOC_NATIVE_NNZ = 10_000_000
# phase 26: scripts/train_record.py's defaults (100 epochs, lr 1e-2, seed
# 0) on the arxiv stand-in; the largest test-accuracy gap between the
# exact and the throughput path; the GCN steps traced; run.sh's schedules
RECORD_EPOCHS, RECORD_LR, RECORD_ACC_GAP = 100, 1e-2, 0.01
TRACE_STEPS = 5
RUN_SH_SCHEDULES = ("row_mapped", "group_mapped", "work_oriented",
                    "merge_path", "sorted_flat")
PRODUCTS_NODES = 2_449_029
PRODUCTS_SCALE = (PRODUCTS_NODES + 0.5) / 200_000
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
# K12's sizes held at each offset 0-3 floats past 16 bytes (phase 18;
# 2^26 in tests/test_torch_cuda_probes.py)
SAXPY_OFFSET_SIZES = (0, 1, 3, 4, 5, 1023, 1024, 1025, 65536, (1 << 20) + 7)


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
    trace event can shorten. Where every hold ended before the calls were
    queued (``HoldExpired``), the card time is "not measured"."""
    from loops_tpu_torch.utils.bench import HoldExpired, apply_ms, device_ms

    queued = apply_ms(fn, x, iters=10)
    try:
        card = device_ms(fn, x, applies=10)
    except HoldExpired as e:
        return (f"card time not measured ({e}), queued {queued:.4f} ms "
                "(apply_ms)")
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
    if kname == "sorted_spmv" and csr.nnz <= MIRROR_NNZ:
        # bit for bit the kernel's numpy mirror at the bound launch shape
        a = {k: v.cpu().numpy() for k, v in b.items()}
        shape = fn.launch.shape
        want = spmv_sorted.sorted_spmv_mirror(a, fn.params, x,
                                              shape["grid"], shape["piece"])
        require(np.array_equal(y.view(np.uint32), want.view(np.uint32)),
                f"{kname}: kernel and mirror differ at grid "
                f"{shape['grid']}, piece {shape['piece']}")
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


def spmm_routes_tolerance(csr, B, dtype):
    """K4 against the group_mapped planes on the same input: in f32
    ``spmm_pair_tolerance``; in bf16 one bf16 rounding of each product
    more (``2**-8 * sum |p|``), because group_mapped's hub-dense rows
    multiply in f32, as ``tests/test_torch_spmm_bf16.py`` allows for the
    torch paths."""
    from loops_tpu_torch.formats import CSR
    from loops_tpu_torch.utils import reference

    tol = spmm_pair_tolerance(csr, B, dtype)
    if dtype is None:
        return tol
    rounded = CSR(csr.shape, csr.offsets, csr.indices,
                  reference.bf16_round(csr.vals))
    return tol + 2.0 ** -8 * (1 + 2.0 ** -8) * reference.spmm_l1_products(
        rounded, reference.bf16_round(B))


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


def bcsr_shape(bcsr):
    """A BCSR's shapes as the formulas take them: rows, cols, stored
    blocks, block rows, stored values."""
    return (*bcsr.shape, bcsr.num_blocks, bcsr.num_block_rows, bcsr.nnz)


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
    from loops_tpu_torch.utils import counters
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
        b_ms, b_by = counters.bound_of(counters.bcsr_work(*bcsr_shape(mat),
                                                          F, dtype))
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
    from loops_tpu_torch.utils import counters
    from loops_tpu_torch.utils import stream
    from loops_tpu_torch.utils.bench import apply_ms, cold_ms

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
        nbytes = counters.stream_read_work(x.numel() * 4).nbytes
        gbps = nbytes / ms / 1e6
        res[label] = dict(ms=ms, plain_ms=plain_ms, gbps=gbps, err=err,
                          nbytes=nbytes)
        # one pass from an empty L2 beside the warm slope over passes,
        # which at 64 MiB (1.3x the 50 MB L2) reads partly from the L2
        cold = cold_ms(lambda: stream.stream_read(x), device)
        bound, _ = counters.bound_of(counters.stream_read_work(
            x.numel() * 4))
        res[label]["cold_ms"] = cold
        print(f"  stream {label}: K11 {ms:.4f} ms per pass (warm, slope "
              f"over passes) = {gbps:.1f} "
              f"GB/s ({gbps * 1e9 / counters.HBM_BYTES_PER_S:.1%} of the "
              f"nominal "
              f"3.35 TB/s), {cold:.4f} ms one pass from an empty L2 "
              f"({bound / cold:.1%} of its {bound:.4f} ms byte bound); "
              f"torch.sum {plain_ms:.4f} ms = "
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
    from loops_tpu_torch.utils import counters
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
        work = (counters.sddmm_flat_work(*mat.shape, mat.nnz, F)
                if kname == "sddmm_flat" else counters.sddmm_bcsr_work(
                    *mat.shape, mat.num_blocks, mat.nnz, F))
        b_ms, b_by = counters.bound_of(work)
        m_ms, m_by = counters.bound_of(work, rate)
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
    works = {"sddmm_flat": counters.sddmm_flat_work(*bench.shape, bench.nnz,
                                                    SDDMM_F),
             "sddmm_bcsr": counters.sddmm_bcsr_work(
                 *bcsr.shape, bcsr.num_blocks, bcsr.nnz, SPMM_F)}
    bounds = {k: (lambda r, w=w: counters.bound_of(w, r))
              for k, w in works.items()}
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
    from loops_tpu_torch.utils import counters
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
    # x and y off 16 bytes by the same floats (0-3), from NaN-filled
    # buffers: the float4 body and its tail at 0, the scalar loop else
    n_off = 0
    g = torch.Generator(device=device).manual_seed(18)
    for n in SAXPY_OFFSET_SIZES:
        x, y = (torch.randn(n, device=device, generator=g) for _ in range(2))
        want = saxpy.saxpy_plain(-0.75, x, y)
        for off in range(4):
            views = []
            for v in (x, y):
                b = torch.full((n + off,), float("nan"), device=device)
                b[off:] = v
                views.append(b[off:])
            got = saxpy.saxpy_cuda(-0.75, *views)
            common.hold(f"saxpy n={n} offset {off}", got, want)
            n_off += 1
        del x, y, want, views, b, got
    torch.cuda.empty_cache()
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
          f"saxpy: {8 + n_off} cases, exact; K2 after the scan moved into "
          f"seg_scan.cuh: "
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
        *astuple(counters.saxpy_work(x.numel()))[:2], "f32", err["saxpy"],
        "")
    xl, yl = (torch.randn(1 << 26, device=device) for _ in range(2))
    big_ms = common.launch_ms(lambda: saxpy.saxpy_cuda(2.5, xl, yl), device)
    add_ms = common.launch_ms(lambda: torch.add(yl, xl, alpha=2.5), device)
    big_bytes = counters.saxpy_work(xl.numel()).nbytes
    big_bound, _ = counters.bound_of(counters.saxpy_work(xl.numel()))
    print(f"  saxpy [8, 8192]: {entries['saxpy']['ms']:.4f} ms (plain "
          f"{entries['saxpy']['plain_ms']:.4f}, torch.add "
          f"{entries['saxpy']['library_ms']:.4f}); 2^26 elements: "
          f"{big_ms:.4f} ms = {big_bytes / big_ms / 1e6:.1f} GB/s, "
          f"{big_bound / big_ms:.1%} of its {big_bound:.4f} ms byte bound "
          f"(torch.add {add_ms:.4f} ms, {big_bound / add_ms:.1%})  [{smi}]")
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
    b_ms, b_by = counters.bound(sm["nbytes"], sm["flops"])
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
                       counters.bound(rec["nbytes"], rec["flops"], dt)))
        b_ms, b_by = counters.bound(rec["nbytes"], rec["flops"], dt,
                                    floor=floor)
        m_ms, m_by = counters.bound(rec["nbytes"], rec["flops"], dt, rate,
                                    floor)
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
            b_ms, b_by = counters.bound(rec["nbytes"], rec["flops"],
                                        "bfloat16")
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
        b_ms, b_by = counters.bound(rec["nbytes"], rec["flops"])
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


def _steps_twice(model, make_step, n):
    """``n`` steps of ``make_step(model)``'s step from the model's state
    now, twice (the state restored, a fresh optimizer and generator made
    between): the two runs' losses and parameters must be bitwise equal.
    The state is restored after. Returns the first run's losses and,
    where the step samples, each of its steps' frontiers on the host."""
    import torch

    start = {k: v.clone() for k, v in model.state_dict().items()}
    losses, params, frontiers = [], [], []
    for _ in range(2):
        model.load_state_dict(start)
        step = make_step(model)
        run = []
        for _ in range(n):
            run.append(step())
            if getattr(step, "frontiers", None) is not None \
                    and len(frontiers) < n:
                frontiers.append([f.cpu().numpy() for f in step.frontiers])
        losses.append(torch.stack(run))
        params.append({k: v.clone() for k, v in model.state_dict().items()})
    require(bool(torch.isfinite(losses[0]).all()),
            f"losses {losses[0].tolist()}")
    require(torch.equal(losses[0], losses[1]), "two runs' losses differ: "
            f"{losses[0].tolist()} vs {losses[1].tolist()}")
    for k in start:
        require(torch.equal(params[0][k], params[1][k]),
                f"two runs' {k} differ")
    model.load_state_dict(start)
    return losses[0].tolist(), frontiers


def check_frontiers(graph, runs, fanouts):
    """Every sampled id is a CSR neighbour of its parent, or the parent
    itself where it has none, checked on the host against the CSR's keys
    ``row * n + col`` (sorted: CSR order). ``runs`` holds each step's
    frontiers. Returns the number of ids checked."""
    adj = graph.adj
    n = graph.num_nodes
    keys = adj.row_ids().astype(np.int64) * n + adj.indices
    require(bool(np.all(keys[1:] > keys[:-1])), "CSR keys out of order")
    deg = adj.row_sizes()
    checked = 0
    for frontiers in runs:
        for d, k in enumerate(fanouts):
            parent = np.repeat(frontiers[d].astype(np.int64), k)
            child = frontiers[d + 1].astype(np.int64)
            require(len(child) == len(parent), f"hop {d}: {len(child)} ids "
                    f"for {len(parent)} draws")
            q = parent * n + child
            pos = np.minimum(np.searchsorted(keys, q), len(keys) - 1)
            ok = np.where(deg[parent] > 0, keys[pos] == q, child == parent)
            require(bool(ok.all()), f"hop {d}: {int((~ok).sum())} sampled "
                    "ids are not neighbours of their parents")
            checked += len(child)
    return checked


def k4_op_vs_plain(label, op, F, device, chunk=None):
    """K4 through a model's operator ``op`` (its staged buffers, at a
    width the main path gives it) against its plain version on the same
    input: bit for bit, two applies bitwise equal, 256 sampled rows
    within the f32 Wilkinson bound of their f64 sums. The plain version
    runs ``chunk`` columns at a time where its [nnz, F] products would not
    fit the card (a column's sums do not depend on the others). Returns
    0.0, the max |kernel - plain|."""
    import torch

    from loops_tpu_torch.ops.kernels import spmm_flat
    from loops_tpu_torch.utils import reference

    require(op.impl_used == "flat_spmm", f"{label}: took {op.impl_used}")
    rng = np.random.default_rng(F)
    B = rng.normal(size=(op.cols, F)).astype(np.float32)
    Bd = torch.from_numpy(B).to(device)
    C1, C2 = op(Bd), op(Bd)
    require(tuple(C1.shape) == (op.rows, F) and bool(C1.isfinite().all()),
            f"{label}: bad output")
    require(torch.equal(C1, C2), f"{label}: two applies differ")
    step = chunk or F
    for j in range(0, F, step):
        plain = spmm_flat.flat_spmm_plain(op._bufs, Bd[:, j:j + step],
                                          op.mat.shape, op.dtype)
        require(torch.equal(C1[:, j:j + step], plain),
                f"{label}: K4 and its plain version differ in columns "
                f"{j}..{j + step}")
        del plain
    rep = reference.validate_sampled_rows(
        op.mat, B, C1, bf16_products=op.dtype is not None)
    require(rep.overruns == 0, f"{label}: {rep}")
    return 0.0


def sage_phase(device, smi, ds):
    """Phase 20: GraphSAGE at full width, full graph on the arxiv stand-in
    (``ds``, built in phase 7) on both routes in f32 and bf16, and the
    sampled minibatch on the ogbn-products stand-in at its real node
    count. Returns the launch counts of its main path and K4's max
    |kernel - plain| at its shapes."""
    import torch

    from loops_tpu_torch.io import ogb
    from loops_tpu_torch.models import GraphSAGE, make_sampled_train_step
    from loops_tpu_torch.models import train as T
    from loops_tpu_torch.ops.kernels import _build
    from loops_tpu_torch.utils.profile_spmv import profile_applies
    from loops_tpu_torch.utils.timer import time_fn

    def median_ms(fn, iters):
        return time_fn(fn, device=device, warmup=1, iters=iters,
                       reduction=statistics.median)

    def adam(m):
        return torch.optim.Adam(m.parameters(), lr=1e-2)

    t0 = time.perf_counter()
    graph = ds.graph
    feats, labels, train_mask, test_mask = (
        torch.from_numpy(a).to(device) for a in (
            ds.features, ds.labels, ds.train_mask, ds.test_mask))
    dims = [ds.features.shape[1], GCN_HIDDEN, GCN_HIDDEN, ds.num_classes]
    # the planes and K4, named: schedule="auto" follows the card's fitted
    # SpMM route, which may be either
    routes = {"group_mapped": {"schedule": "group_mapped"},
              "K4": {"schedule": "merge_path", "impl": "pallas"}}
    models, build_s = {}, {}
    for dtype in DTYPES:
        for route, kw in routes.items():
            th = time.perf_counter()
            models[route, dtype] = GraphSAGE(
                graph, dims, dtype=dtype, device=device,
                generator=torch.Generator().manual_seed(0), **kw)
            build_s[route, dtype] = time.perf_counter() - th
    th = time.perf_counter()
    prod = ogb.load("ogbn-products", scale=PRODUCTS_SCALE)
    prod_s = time.perf_counter() - th
    pg = prod.graph
    require(pg.num_nodes == PRODUCTS_NODES,
            f"the ogbn-products stand-in has {pg.num_nodes} nodes")
    sdims = [prod.features.shape[1], SAMPLED_HIDDEN, SAMPLED_HIDDEN,
             prod.num_classes]
    th = time.perf_counter()
    sm = GraphSAGE(pg, sdims, schedule="merge_path", impl="pallas",
                   device=device, generator=torch.Generator().manual_seed(0))
    sm_build_s = time.perf_counter() - th
    print(f"  ogbn-products stand-in (synthetic, {pg.num_nodes} nodes, "
          f"{pg.num_edges} directed edges, {prod.features.shape[1]} "
          f"features, {prod.num_classes} classes): built on the host in "
          f"{prod_s:.2f} s; its GraphSAGE (K4 forward and over Aᵀ) in "
          f"{sm_build_s:.2f} s; arxiv GraphSAGE builds "
          + ", ".join(f"{r} {d or 'f32'} {s:.2f} s"
                      for (r, d), s in build_s.items()), flush=True)

    # K4 through the models' own operators at the main path's widths,
    # before the counters are set to 0: these launches are checks
    err = 0.0
    for dtype in DTYPES:
        fwd, bwd = models["K4", dtype].operators()
        for label, op in (("A_mean", fwd), ("A_meanᵀ", bwd)):
            err = max(err, k4_op_vs_plain(
                f"arxiv {label} F={GCN_HIDDEN} {dtype or 'f32'}", op,
                GCN_HIDDEN, device))
    for F in (sdims[0], SAMPLED_HIDDEN):
        err = max(err, k4_op_vs_plain(f"products A_mean F={F}", sm.aggregate,
                                      F, device, chunk=10))
    torch.cuda.synchronize()
    print(f"  K4 vs plain at phase 20's shapes (arxiv A_mean and A_meanᵀ "
          f"F={GCN_HIDDEN} f32 and bf16; products A_mean F={sdims[0]} and "
          f"{SAMPLED_HIDDEN}): bit for bit, 256 sampled rows each within "
          f"the Wilkinson bound", flush=True)

    # ---- the main path
    _build.reset_launches()
    for dtype in DTYPES:
        name = dtype or "f32"
        la, agg, at_ct = {}, {}, {}
        gen = torch.Generator(device).manual_seed(5)
        hx = torch.rand(feats.shape, generator=gen, device=device)
        ct = torch.randn(feats.shape, generator=gen, device=device)
        for route in routes:
            m = models[route, dtype]
            m.eval()
            with torch.no_grad():
                la[route] = m(feats)
                agg[route] = m.aggregate(hx)
            x = hx.clone().requires_grad_(True)
            (m.aggregate._fn(x) * ct).sum().backward()
            at_ct[route] = x.grad
        lg, lk = la["group_mapped"], la["K4"]
        require(tuple(lk.shape) == (graph.num_nodes, ds.num_classes)
                and bool(lk.isfinite().all()), f"SAGE {name}: bad logits")
        scale = float(lg.abs().max())
        diff = float((lk - lg).abs().max())
        # f32: 1e-4 of the largest logit. bf16: one bf16 ulp of it, as
        # tests/test_torch_gcn.py holds bf16 logits: the routes' f32 sums
        # differ in order, so a layer's input can round to a neighbouring
        # bf16 value, and that propagates
        rel = 1e-4 if dtype is None else 2.0 ** -7
        require(diff <= rel * max(scale, 1.0),
                f"SAGE {name}: the routes' logits differ by {diff:.3e}")
        # A hx and Aᵀ ct by both routes on the same input: within twice
        # the Wilkinson bound over the products the mode forms (in bf16,
        # and one rounding of each: group_mapped's hub rows are f32)
        for label, op, got, v in (
                ("A hx", models["K4", dtype].aggregate, agg, hx),
                ("Aᵀ ct", models["K4", dtype].aggregate._vjp_op, at_ct, ct)):
            gdiff = (got["K4"] - got["group_mapped"]).abs().cpu().numpy()
            tol = spmm_routes_tolerance(op.mat, v.cpu().numpy(), dtype)
            require(np.all(gdiff <= tol),
                    f"SAGE {name}: K4's {label} differs from group_mapped's "
                    f"by {gdiff.max():.3e}")
            print(f"  GraphSAGE {name} (arxiv): {label} by K4 and by "
                  f"group_mapped, max |diff| {gdiff.max():.3e}, at most "
                  f"{(gdiff / tol).max():.3f} of its bound")
        print(f"  GraphSAGE {name} (arxiv, dims {dims}): group_mapped "
              f"({models['group_mapped', dtype].aggregate.impl_used}) vs K4 "
              f"logits max |diff| {diff:.3e} (max |logit| {scale:.3e}, "
              f"limit {rel:g} of it)", flush=True)
        for route in routes:
            m = models[route, dtype]

            def full_step(model):
                return T.make_train_step(model, adam(model), feats, labels,
                                         train_mask)
            losses, _ = _steps_twice(m, full_step, SAGE_STEPS)
            step = full_step(m)
            ms_step = median_ms(step, 5)
            ms_eval = median_ms(
                lambda: T.evaluate(m, feats, labels, test_mask), 5)
            print(f"  GraphSAGE {name} {route}: {SAGE_STEPS} Adam steps "
                  f"twice, bitwise equal, losses {losses[0]:.4f} -> "
                  f"{losses[-1]:.4f}; step {ms_step:.3f} ms, evaluate "
                  f"{ms_eval:.3f} ms (CUDA events, median of 5); "
                  f"{graph.num_edges / ms_step / 1e3:.2f}M edges/s a step; "
                  f"K4 launches {m.launches()}  [{smi}]", flush=True)
    del models, hx, ct, agg, at_ct, la, x
    torch.cuda.empty_cache()

    # ---- sampled GraphSAGE on ogbn-products
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device) / 2**30
    p_feats, p_labels, p_test = (torch.from_numpy(a).to(device) for a in (
        prod.features, prod.labels, prod.test_mask))

    def sampled_step(model, seed=1):
        return make_sampled_train_step(
            model, adam(model), p_feats, p_labels, SAMPLED_FANOUTS,
            SAMPLED_BATCH, generator=torch.Generator(device).manual_seed(seed))
    losses, frontiers = _steps_twice(sm, sampled_step, SAMPLED_STEPS)
    th = time.perf_counter()
    checked = check_frontiers(pg, frontiers, SAMPLED_FANOUTS)
    check_s = time.perf_counter() - th
    per_step = sum(len(f) for f in frontiers[0][1:])
    require(per_step == SAMPLED_BATCH * (15 + 150 + 750),
            f"{per_step} sampled ids a step")
    step = sampled_step(sm, seed=2)
    descent = [float(step()) for _ in range(SAMPLED_DESCENT_STEPS)]
    first, last = np.mean(descent[:5]), np.mean(descent[-5:])
    require(np.all(np.isfinite(descent)) and last < first,
            f"sampled loss does not fall over {SAMPLED_DESCENT_STEPS} "
            f"steps: {descent}")
    ms_step = median_ms(step, 10)
    ms_eval = median_ms(lambda: T.evaluate(sm, p_feats, p_labels, p_test), 3)
    acc = T.evaluate(sm, p_feats, p_labels, p_test)
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    prof = profile_applies(lambda _: step(), p_feats, applies=5, warmup=1)
    card = card_text(lambda _: step(), p_feats)
    print(f"  sampled GraphSAGE (ogbn-products stand-in, synthetic: "
          f"{pg.num_nodes} nodes, {pg.num_edges} edges; dims {sdims}, "
          f"fanouts {SAMPLED_FANOUTS}, batch {SAMPLED_BATCH}): "
          f"{SAMPLED_STEPS} steps twice, bitwise equal, losses "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}; {SAMPLED_DESCENT_STEPS} "
          f"steps: mean loss of the first 5 {first:.4f}, of the last 5 "
          f"{last:.4f}; {checked} sampled ids checked against the CSR in "
          f"{check_s:.2f} s; step {ms_step:.3f} ms (CUDA events, median of "
          f"10), {per_step} sampled edges a step, "
          f"{per_step / ms_step / 1e3:.2f}M sampled edges/s; full-graph "
          f"evaluate on K4 {ms_eval:.3f} ms, test acc {acc:.4f}; "
          f"max_memory_allocated {peak:.2f} GiB ({base:.2f} held before "
          f"the features)  [{smi}]", flush=True)
    print(f"    profile of a sampled step: {profile_text(prof, 8, width=48)}")
    print(f"    sampled step: {card}  [{smi}]")
    launches = dict(_build.LAUNCHES)
    require(launches["flat_spmm"] > 0, "K4 never launched in phase 20")
    require(sm.aggregate.launches > 0,
            "the products evaluate did not launch K4")
    del sm, p_feats, p_labels, p_test, prod, step
    torch.cuda.empty_cache()
    phase(20, "GraphSAGE at full width", t0,
          "main-path launches " + json.dumps(
              {k: v for k, v in launches.items() if v}) + " ")
    return launches, err


def v2_reference(adj, u, v, a, rows, slope=0.2):
    """GATv2's per-edge oracle in float64 on the destination rows
    ``rows``: the softmax over each row's edges of ``a . leaky_relu(u_j +
    v_i)`` and the weighted sum of ``u_j``. [len(rows), H, D]."""
    src = adj.indices
    out = np.zeros((len(rows),) + u.shape[1:])
    for k, r in enumerate(rows):
        uj = u[src[adj.offsets[r]:adj.offsets[r + 1]]].astype(np.float64)
        pre = uj + v[r].astype(np.float64)
        e = (np.where(pre >= 0, pre, slope * pre) * a).sum(axis=-1)
        z = np.exp(e - e.max(axis=0))
        out[k] = np.einsum("ph,phd->hd", z / z.sum(axis=0), uj)
    return out


def within(got, want, tol):
    """The largest ``|got - want|`` and whether every entry lies within
    ``tol + tol * |want|`` (``np.allclose`` with ``rtol = atol = tol``)."""
    d = np.abs(got - want)
    return float(d.max()), bool(np.all(d <= tol + tol * np.abs(want)))


def gat_phase(device, smi, ds):
    """Phase 21: GAT on three routes and GATv2 on two at the JAX
    package's full-scale GAT shape on the arxiv stand-in (``ds``, built in
    phase 7), f32 and bf16. No kernel lies on this path: the launch
    counters must stay at 0."""
    import torch

    from loops_tpu_torch.models import GAT, GATv2
    from loops_tpu_torch.models import train as T
    from loops_tpu_torch.ops.attention import (
        GroupedAttentionAggregate,
        reference_attention_aggregate,
    )
    from loops_tpu_torch.ops.kernels import _build
    from loops_tpu_torch.utils import counters
    from loops_tpu_torch.utils.profile_spmv import profile_applies
    from loops_tpu_torch.utils.timer import time_fn

    def median_ms(fn, iters):
        return time_fn(fn, device=device, warmup=1, iters=iters,
                       reduction=statistics.median)

    t0 = time.perf_counter()
    _build.reset_launches()
    feats, labels, train_mask, test_mask = (
        torch.from_numpy(a).to(device) for a in (
            ds.features, ds.labels, ds.train_mask, ds.test_mask))
    dims = [ds.features.shape[1], GAT_HIDDEN, ds.num_classes]
    th = time.perf_counter()
    graph = ds.graph.with_self_loops()
    loops_s = time.perf_counter() - th
    adj, n, E = graph.adj, graph.num_nodes, graph.num_edges
    th = time.perf_counter()
    op = GroupedAttentionAggregate(adj, grad=False, device=device)
    fwd_s = time.perf_counter() - th
    th = time.perf_counter()
    GroupedAttentionAggregate(adj, device=device)
    bwd_s = time.perf_counter() - th
    sizes = adj.row_sizes()
    hub = int(sizes.argmax())
    slots = op.planes.slots
    print(f"  arxiv stand-in with self-loops (synthetic): {n} nodes, {E} "
          f"edges, hub row {hub} of {int(sizes[hub])}; self-loops "
          f"{loops_s:.2f} s, forward plan {fwd_s:.2f} s, transposed plan "
          f"{bwd_s:.2f} s on the host, once for every model below; "
          f"{len(slots)} buckets, {sum(slots)} padded plane slots "
          f"({sum(slots) / E:.2f}x the edges), the largest bucket "
          f"{max(slots)}", flush=True)
    rng = np.random.default_rng(21)
    rows = np.unique(np.concatenate([[hub], rng.choice(n, GAT_ROWS - 1,
                                                        replace=False)]))
    row_bytes = GAT_HEADS * GAT_HIDDEN * 4
    one_pass = counters.edge_rows_work(E, GAT_HEADS * GAT_HIDDEN)
    # forward and backward each read an edge's row of either layer once
    step = counters.edge_rows_work(
        E, GAT_HEADS * (GAT_HIDDEN + ds.num_classes), passes=2)
    step_bytes = step.nbytes
    step_bound_ms = counters.bound_of(step)[0]
    print(f"  yardstick: one pass reading each edge's layer-0 row once, "
          f"{E} x {row_bytes} B = {one_pass.nbytes / 1e9:.2f} GB, "
          f"{counters.bound_of(one_pass)[0]:.3f} ms at 3.35 TB/s (f32); a "
          f"step's forward and backward over both layers "
          f"{step_bytes / 1e9:.2f} GB, {step_bound_ms:.3f} ms", flush=True)

    kinds = {
        "GAT": (GAT, {"fused": {}, "autograd": {"vjp": False},
                      "textbook": {"fused": False}}),
        "GATv2": (GATv2, {"fused": {}, "textbook": {"fused": False}}),
    }
    fused_ms = None
    for kind, (cls, routes) in kinds.items():
        models = {}
        for route, kw in routes.items():
            for dtype in DTYPES if route != "textbook" else (None,):
                models[route, dtype] = cls(
                    ds.graph, dims, heads=GAT_HEADS, dtype=dtype,
                    device=device, generator=torch.Generator().manual_seed(0),
                    **kw)
        # the routes from one state: logits and parameter gradients
        logits, grads = {}, {}
        for key, m in models.items():
            m.eval()
            with torch.no_grad():
                logits[key] = m(feats)
            m.zero_grad(set_to_none=True)
            T.cross_entropy(m(feats), labels, train_mask).backward()
            grads[key] = {k: p.grad.cpu().numpy()
                          for k, p in m.named_parameters()
                          if p.grad is not None}
        ref = ("fused", None)
        lf = logits[ref]
        require(tuple(lf.shape) == (n, ds.num_classes)
                and bool(lf.isfinite().all()), f"{kind}: bad logits")
        scale = float(lf.abs().max())
        for key in models:
            if key[1] is not None or key == ref:
                continue
            diff = float((logits[key] - lf).abs().max())
            require(diff <= 1e-4 * max(scale, 1.0), f"{kind} {key[0]}: "
                    f"logits differ from the fused route's by {diff:.3e}")
            require(grads[key].keys() == grads[ref].keys(),
                    f"{kind} {key[0]}: other parameters have gradients")
            # each parameter's max |diff| beside its max |g|, and besides
            # the CPU tests' bound a limit of 1e-2 max |g|: a wrong
            # backward term moves a gradient by the order of max |g|,
            # while the routes' other f32 summation orders, where a small
            # gradient cancels over many edges, stay near 1e-3 of it
            gd, bad = [], []
            for k, g in grads[ref].items():
                d, ok = within(grads[key][k], g, 1e-4)
                gmax = float(np.abs(g).max())
                gd.append(f"{k} {d:.3e} of {gmax:.3e}")
                if not (ok and d <= 1e-2 * gmax):
                    bad.append(k)
            print(f"  {kind} {key[0]} vs fused (f32): logits max |diff| "
                  f"{diff:.3e} (max |logit| {scale:.3e}, limit 1e-4 of "
                  f"it); parameter gradients, max |diff| of max |g| "
                  f"(limit 1e-4 + 1e-4 |g|, the CPU tests' rtol = atol, "
                  f"and 1e-2 max |g|): {', '.join(gd)}")
            require(not bad, f"{kind} {key[0]}: the gradients of {bad} "
                    f"differ from the fused route's")
        for dtype in (d for d in DTYPES if d is not None):
            bdiff = float((logits["fused", dtype] - lf).abs().max())
            print(f"  {kind} fused {dtype} logits vs f32: max |diff| "
                  f"{bdiff:.3e}")
        # layer 0's aggregation against the f64 oracle, and bf16 against
        # f32 on the same inputs (the JAX package's own bound, 0.05)
        m32, mbf = models["fused", None], models["fused", "bfloat16"]
        with torch.no_grad():
            xs = m32.transform(0, feats)
            if kind == "GAT":
                args = xs
                got = m32.attention(*args)
                host = [x.cpu().numpy() for x in xs]
                want = reference_attention_aggregate(adj, *host,
                                                     rows=rows)[rows]
            else:
                u, v = xs
                a = m32.layers[0].a
                args = (u, v, a, u)
                got = m32.attention(*args)
                want = v2_reference(adj, u.cpu().numpy(), v.cpu().numpy(),
                                    a.cpu().numpy().astype(np.float64), rows)
            got_bf = mbf.attention(*args)
        d_ref, ok = within(got[torch.from_numpy(rows).to(device)]
                           .cpu().numpy(), want, 1e-4)
        require(ok, f"{kind}: layer 0's aggregation differs from the f64 "
                f"oracle by {d_ref:.3e}")
        d_bf, ok = within(got_bf.cpu().numpy(), got.cpu().numpy(), 0.05)
        require(ok, f"{kind}: bf16 aggregation differs from f32 by "
                f"{d_bf:.3e}")
        print(f"  {kind} layer 0 (fused, f32) on {len(rows)} sampled rows "
              f"(hub row {hub} among them) vs the f64 oracle: max |diff| "
              f"{d_ref:.3e} (limit 1e-4 + 1e-4 |ref|); bf16 vs f32 on all "
              f"rows: max |diff| {d_bf:.3e} (limit 0.05 + 0.05 |f32|)",
              flush=True)
        del logits, grads, got, got_bf, xs, args

        for (route, dtype), m in models.items():
            name = f"{kind} {route} {dtype or 'f32'}"

            def full_step(model):
                return T.make_train_step(
                    model, torch.optim.Adam(model.parameters(), lr=1e-2),
                    feats, labels, train_mask)
            torch.cuda.reset_peak_memory_stats(device)
            base = torch.cuda.memory_allocated(device) / 2**30
            losses, _ = _steps_twice(m, full_step, GAT_STEPS)
            step = full_step(m)
            ms_step = median_ms(step, 5)
            ms_eval = median_ms(
                lambda: T.evaluate(m, feats, labels, test_mask), 3)
            peak = torch.cuda.max_memory_allocated(device) / 2**30
            print(f"  {name}: {GAT_STEPS} Adam steps twice, bitwise equal, "
                  f"losses {losses[0]:.4f} -> {losses[-1]:.4f}; step "
                  f"{ms_step:.3f} ms, evaluate {ms_eval:.3f} ms (CUDA "
                  f"events, median of 5 and 3); {E / ms_step / 1e3:.2f}M "
                  f"edges/s a step (edges with self-loops); step / one-pass "
                  f"bound {ms_step / step_bound_ms:.1f}x; "
                  f"max_memory_allocated {peak:.2f} GiB ({base:.2f} held "
                  f"before)  [{smi}]",
                  flush=True)
            if (kind, route, dtype) == ("GAT", "fused", None):
                fused_ms = ms_step
                prof = profile_applies(lambda _: step(), feats, applies=3,
                                       warmup=1)
                print(f"    profile of the fused GAT step: "
                      f"{profile_text(prof, 10, width=56)}")
                card = card_text(lambda _: step(), feats)
                print(f"    fused GAT step: {card}  [{smi}]", flush=True)
            del step
        del models, m
        torch.cuda.empty_cache()
    launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    require(not launches, f"phase 21 launched kernels: {launches}")
    del feats, labels, train_mask, test_mask
    torch.cuda.empty_cache()
    phase(21, "GAT and GATv2 at full width", t0, "no kernel on this path; "
          f"fused GAT f32 step {fused_ms:.3f} ms ")


def format_bytes(mat, F=None):
    """One pass over ``mat``'s own arrays: its values and indices, padding
    included, ``x`` (or ``B``, F wide) read and ``y`` (or ``C``) written,
    4 bytes each."""
    from loops_tpu_torch.formats import BCSR, COO, CSC, CSR, DIA, ELL

    rows, cols = mat.shape
    xy = 4 * (rows + cols) * (F or 1)
    if isinstance(mat, CSR):
        return 4 * (rows + 1) + 8 * mat.nnz + xy
    if isinstance(mat, CSC):
        return 4 * (cols + 1) + 8 * mat.nnz + xy
    if isinstance(mat, COO):
        return 12 * mat.nnz + xy
    if isinstance(mat, ELL):
        return 8 * rows * mat.pitch + xy
    if isinstance(mat, DIA):
        return 4 * mat.num_diagonals * (rows + 1) + xy
    if isinstance(mat, BCSR):
        return (4 * (mat.num_blocks + mat.num_block_rows + 1) + 4 * mat.nnz
                + xy)
    raise TypeError(type(mat).__name__)


class FormatCase:
    """One route of phase 22: its operator (a callable of a staged x or
    B), the bytes of its one pass, its host staging and peak memory, and,
    once timed, its ms per apply."""

    def __init__(self, matrix, label, fmt, nbytes, run, staging_ms, peak,
                 held):
        self.matrix, self.label, self.fmt = matrix, label, fmt
        self.nbytes, self.run = nbytes, run
        self.staging_ms, self.peak, self.held = staging_ms, peak, held
        self.ms = None


def build_case(matrix, label, fmt, nbytes, make, v, csr, ref, device,
               deterministic, impl_used=None):
    """Build a route (its host staging timed), apply it once with the
    card's peak memory read, and check it: finite values of the right
    shape, no mismatch against the CPU reference ``ref``, sampled rows
    within the Wilkinson bound, two applies bitwise equal on the
    deterministic routes, and the path ``impl_used`` names. Returns the
    case and its output."""
    import torch

    from loops_tpu_torch.utils import reference
    from loops_tpu_torch.utils.equal import count_mismatches

    torch.cuda.synchronize(device)
    held = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    th = time.perf_counter()
    run = make()
    staging_ms = (time.perf_counter() - th) * 1e3
    out = run(v)
    torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device)
    tag = f"{matrix} {label}"
    if impl_used is not None:
        require(run.impl_used == impl_used,
                f"{tag}: took {run.impl_used}, not {impl_used}")
    require(tuple(out.shape) == ref.shape and bool(torch.isfinite(out).all()),
            f"{tag}: bad output {tuple(out.shape)}")
    errors = count_mismatches(out.cpu().numpy(), ref)
    two_d = out.dim() == 2
    rep = reference.validate_sampled_rows(
        csr, v.cpu().numpy() if two_d else v.cpu().numpy()[:, None],
        out if two_d else out[:, None])
    require(errors == 0 and rep.overruns == 0,
            f"{tag}: {errors} errors, {rep}")
    if deterministic:
        require(torch.equal(out, run(v)),
                f"{tag}: two applies are not bitwise equal")
    print(f"  {tag}: Errors 0, {rep.rows} sampled rows within the Wilkinson "
          f"bound (rel err {rep.rel_error:.2e})"
          + (", twice bitwise equal" if deterministic else "")
          + (f", {run.impl_used}" if impl_used else "")
          + f"; host staging {staging_ms:.1f} ms, peak "
          f"{(peak - held) / 2**30:.3f} GiB above {held / 2**30:.2f} held",
          flush=True)
    return FormatCase(matrix, label, fmt, nbytes, run, staging_ms, peak,
                      held), out


def formats_phase(device, smi, big, x_big, bench, adj, rate):
    """Phase 22: every format at full width. COO, CSC and ELL, the flat
    partitioner and ``reorder='degree'`` on K1 and K2 on big_2097152; DIA,
    ELL and K1 on band_2097152_b4; K6 and K1 on bcsr_spmv_32768;
    ``reorder='bfs'`` on the arxiv stand-in's adjacency (``adj``); COO
    SpMM there and ELL SpMM on bench_32768 at F = 128, each beside K4;
    ``--format auto`` through ``examples/spmv_torch.py`` on three
    matrices. The launch counters are set to 0 before the routes run and
    read after them, before the timing. Returns the main path's launches
    and the advisor's cost row made from this run's times."""
    import torch

    from loops_tpu_torch.formats import BCSR, ELL, FormatCosts
    from loops_tpu_torch.formats.advisor import VALUE_BYTES
    from loops_tpu_torch.ops.kernels import _build
    from loops_tpu_torch.ops.spmm import SpMMOperator
    from loops_tpu_torch.ops.spmv import SpMVOperator, flat_partitioned_spmv
    from loops_tpu_torch.utils import counters
    from loops_tpu_torch.utils import generate, reference
    from loops_tpu_torch.utils.bench import apply_ms

    t0 = time.perf_counter()
    _build.reset_launches()
    cases, host, inputs, parts, last = [], {}, {}, {}, [t0]

    def part(name):
        now = time.perf_counter()
        parts[name] = round(now - last[0], 1)
        last[0] = now

    def op_maker(mat, schedule="row_mapped", impl="xla", **kw):
        return lambda: SpMVOperator(mat, schedule, block=BENCH_BLOCK,
                                    impl=impl, device=device, **kw)

    def converted(name, fn):
        th = time.perf_counter()
        mat = fn()
        host[name] = round((time.perf_counter() - th) * 1e3, 1)
        return mat

    def add(matrix, label, mat_or_bytes, make, det, impl_used=None):
        nbytes = (mat_or_bytes if isinstance(mat_or_bytes, int)
                  else format_bytes(mat_or_bytes))
        csr, v, ref = inputs[matrix]
        case, out = build_case(matrix, label, label.split()[0], nbytes, make,
                               v, csr, ref, device, det, impl_used)
        cases.append(case)
        return case, out

    def spmv_inputs(name, csr):
        x = generate.make_input_vector(csr.shape[1])
        inputs[name] = (csr, torch.from_numpy(x).to(device),
                        reference.spmv(csr, x))

    # ---- big_2097152: COO, CSC, ELL, the flat partitioner, reorder
    spmv_inputs("big_2097152", big)
    coo = converted("coo", big.to_coo)
    csc = converted("csc", big.to_csc)
    pitch = ELL.max_nnz_per_row(big)
    ell = converted("ell", lambda: big.to_ell(max_pitch=pitch))
    print(f"  big_2097152: {big.nnz} nnz; host conversions (ms) "
          + json.dumps(host) + f"; ELL pitch {pitch}, planes "
          f"{8 * big.shape[0] * pitch / 1e9:.3f} GB", flush=True)
    for label, mat, det in (("coo row_mapped", coo, True),
                            ("coo merge_path", coo, False),
                            ("csc row_mapped", csc, True),
                            ("ell row_mapped", ell, True),
                            ("ell merge_path", ell, False)):
        add("big_2097152", label, mat, op_maker(mat, label.split()[1]), det)
    del coo, csc, ell

    def flat_partitioned():
        def run(v):
            return flat_partitioned_spmv(big, v, device=device)
        run(inputs["big_2097152"][1])
        return run
    add("big_2097152", "csr flat_partitioned_spmv", big, flat_partitioned,
        True)
    perm_bytes = 8 * big.shape[0]  # perm and its inverse, read once each
    # auto on the permuted matrix: the degree multiset, so the pick, is
    # big's own
    for label, sched, impl, kname in (
            ("csr reorder=degree auto", "auto", "xla",
             auto_kernel(big, device)[1]),
            ("csr reorder=degree merge_path pallas2", "merge_path",
             "pallas2", "flat_spmv_v2")):
        case, _ = add("big_2097152", label, format_bytes(big) + perm_bytes,
                      op_maker(big, sched, impl, reorder="degree"), False,
                      kname)
        print(f"    host degree_order + permute_csr "
              f"{case.run.meta['reorder_ms']:.1f} ms of the staging",
              flush=True)
    add("big_2097152", "csr K1", big, op_maker(big, "sorted_flat"), False,
        "sorted_spmv")

    part("big_2097152")

    # ---- band_2097152_b4: DIA, ELL and K1
    band = converted("band", generate.SCALE_MATRICES["band_2097152_b4"])
    spmv_inputs("band_2097152_b4", band)
    dia = converted("band dia", band.to_dia)
    ell = converted("band ell", band.to_ell)
    print(f"  band_2097152_b4: {band.nnz} nnz, {dia.num_diagonals} "
          f"diagonals, ELL pitch {ell.pitch}; host (ms) built "
          f"{host['band']}, DIA {host['band dia']}, ELL {host['band ell']}",
          flush=True)
    add("band_2097152_b4", "dia row_mapped", dia, op_maker(dia), True)
    add("band_2097152_b4", "ell row_mapped", ell, op_maker(ell), True)
    add("band_2097152_b4", "csr K1", band, op_maker(band, "sorted_flat"),
        False, "sorted_spmv")
    ndiag = dia.num_diagonals
    del dia, ell

    part("band_2097152_b4")

    # ---- bcsr_spmv_32768: K6 and K1
    blk = converted("bcsr csr", generate.SCALE_MATRICES["bcsr_spmv_32768"])
    blk_b = converted("bcsr", lambda: BCSR.from_csr(blk, 8, 128))
    spmv_inputs("bcsr_spmv_32768", blk)
    add("bcsr_spmv_32768", "bcsr K6", blk_b,
        op_maker(blk_b, impl="pallas"), False, "bcsr_spmv")
    add("bcsr_spmv_32768", "csr K1", blk, op_maker(blk, "sorted_flat"),
        False, "sorted_spmv")

    part("bcsr_spmv_32768")

    # ---- the arxiv stand-in: reorder='bfs'; COO SpMM beside K4
    spmv_inputs("arxiv_gcn", adj)
    case, _ = add("arxiv_gcn", "csr reorder=bfs auto",
                  format_bytes(adj) + 8 * adj.shape[0],
                  op_maker(adj, "auto", reorder="bfs"), False)
    print(f"    host bfs_order + permute_csr "
          f"{case.run.meta['reorder_ms']:.1f} ms ({adj.shape[0]} nodes); "
          f"auto took {case.run.schedule!r}, {case.run.impl_used}",
          flush=True)
    add("arxiv_gcn", "csr K1", adj, op_maker(adj, "sorted_flat"), False,
        "sorted_spmv")
    for mname, csr, fmt in (("arxiv_gcn", adj, "coo"),
                            ("bench_32768", bench, "ell")):
        B = np.random.default_rng(8).normal(
            size=(csr.shape[1], FORMAT_F)).astype(np.float32)
        key = f"{mname} F={FORMAT_F}"
        inputs[key] = (csr, torch.from_numpy(B).to(device),
                       reference.spmm(csr, B))
        mat = converted(f"{mname} {fmt}", getattr(csr, f"to_{fmt}"))
        _, C4 = add(key, "csr K4 SpMM", format_bytes(csr, FORMAT_F),
                    lambda csr=csr: SpMMOperator(csr, "merge_path", "pallas",
                                                 device=device),
                    False, "flat_spmm")
        _, C = add(key, f"{fmt} SpMM", format_bytes(mat, FORMAT_F),
                   lambda mat=mat: SpMMOperator(mat, device=device), True)
        diff = (C - C4).abs().cpu().numpy().astype(np.float64)
        require(np.all(diff <= spmm_pair_tolerance(csr, B, None)),
                f"{key} {fmt} SpMM and K4 differ by {diff.max()}")
        print(f"    {key} {fmt} SpMM against K4: max |diff| "
              f"{diff.max():.3e}", flush=True)
        del mat, C, C4

    part("arxiv_gcn, bench_32768 SpMM")

    # ---- --format auto through the CLI
    picks = {}
    for mname in ADVISOR_MATRICES:
        status, out, err = run_example("spmv_torch.py", [
            "--matrix", mname, "--format", "auto", "--schedule", "auto",
            "--impl", "pallas", "--validate", "--rigorous", "--device",
            "cuda"])
        csv = [ln for ln in out.splitlines() if f",{mname}," in ln]
        adv = [ln for ln in err.splitlines() if ln.startswith("Advisor:")]
        print(f"  spmv_torch --matrix {mname} --format auto: "
              f"{csv[0] if csv else '?'} | {' | '.join(err.splitlines())}",
              flush=True)
        require(status == 0 and "Errors: 0" in out
                and "Verdict: NOT_A_BUG" in out and adv,
                f"spmv_torch --format auto on {mname}: exit status "
                f"{status}\n{out}{err}")
        picks[mname] = adv[0].split()[1]
        built = {"big_2097152": big, "band_2097152_b4": band,
                 "bcsr_spmv_32768": blk}[mname]
        want = {"csr": auto_kernel(built, device)[1],
                "bcsr": "bcsr_spmv"}.get(picks[mname], "torch")
        require(f"impl_used: {want}" in err, f"{mname}: the advisor picked "
                f"{picks[mname]}, the CLI took {err}")
    launches = dict(_build.LAUNCHES)
    for k in ("sorted_spmv", "flat_spmv_v2", "bcsr_spmv"):
        require(launches[k] > 0, f"{k} never launched in phase 22")

    part("the CLI")

    # ---- timing, each route beside K1 on its matrix
    for case in cases:
        case.ms = apply_ms(case.run, inputs[case.matrix][1])
    k1 = {c.matrix: c.ms for c in cases if c.label in ("csr K1",
                                                       "csr K4 SpMM")}
    for case in cases:
        nom = counters.bound(case.nbytes, 0)[0]
        meas = counters.bound(case.nbytes, 0, rate=rate)[0]
        beside = ("" if case.matrix not in k1 or case.ms == k1[case.matrix]
                  else f" ({'K4' if 'F=' in case.matrix else 'K1'} "
                  f"{k1[case.matrix]:.4f} ms)")
        print(f"  {case.matrix} {case.label}: {case.ms:.4f} ms per apply"
              f"{beside}; one pass {case.nbytes / 1e6:.1f} MB, bound "
              f"{nom:.4f} ms at 3.35 TB/s, {meas:.4f} ms at the measured "
              f"{rate / 1e9:.0f} GB/s ({meas / case.ms:.1%} of it); host "
              f"staging {case.staging_ms:.1f} ms; peak "
              f"{(case.peak - case.held) / 2**30:.3f} GiB above "
              f"{case.held / 2**30:.2f} held  [{smi}]", flush=True)
        require(nom <= case.ms, f"{case.matrix} {case.label}: "
                f"{case.ms:.4f} ms is under its bound {nom:.4f} ms")

    part("timing")

    # ---- the advisor's cost row from these times; picks vs measured
    def ms_of(matrix, label):
        return next(c.ms for c in cases
                    if (c.matrix, c.label) == (matrix, label))
    k6_ms = ms_of("bcsr_spmv_32768", "bcsr K6")
    row = FormatCosts(
        csr_ns_per_nnz=ms_of("big_2097152", "csr K1") * 1e6 / big.nnz,
        ell_ns_per_cell=ms_of("big_2097152", "ell row_mapped") * 1e6
        / (big.shape[0] * pitch),
        dia_ns_per_cell=ms_of("band_2097152_b4", "dia row_mapped") * 1e6
        / (band.shape[0] * ndiag),
        bcsr_ns_per_block=max(k6_ms * 1e6 / blk_b.num_blocks
                              - 8 * 128 * VALUE_BYTES / (rate / 1e9), 0.0),
        stream_gbps=rate / 1e9, provenance=f"chip_smoke.py phase 22, {smi}")
    print(f"  advisor cost row from these times: {row}; K1 "
          f"{ms_of('big_2097152', 'csr K1'):.4f} ms over {big.nnz} nnz, ELL "
          f"{ms_of('big_2097152', 'ell row_mapped'):.4f} ms over "
          f"{big.shape[0] * pitch} cells, DIA "
          f"{ms_of('band_2097152_b4', 'dia row_mapped'):.4f} ms over "
          f"{band.shape[0] * ndiag} cells, K6 {k6_ms:.4f} ms over "
          f"{blk_b.num_blocks} blocks, the stream {rate / 1e9:.1f} GB/s",
          flush=True)
    for mname in ADVISOR_MATRICES:
        measured = {}
        for c in cases:
            if c.matrix == mname and "reorder" not in c.label \
                    and "flat" not in c.label:
                measured[c.fmt] = min(c.ms, measured.get(c.fmt, c.ms))
        fastest = min(measured, key=measured.get)
        print(f"  advisor on {mname}: picked {picks[mname]} (the card's "
              f"row); measured fastest {fastest} ("
              + ", ".join(f"{k} {v:.4f} ms" for k, v in measured.items())
              + f"): {'agree' if picks[mname] == fastest else 'differ'}  "
              f"[{smi}]", flush=True)
    del cases, inputs
    torch.cuda.empty_cache()
    part("advisor")
    print("  phase 22 by part (s): " + json.dumps(parts), flush=True)
    phase(22, "formats at full width", t0, "main-path launches "
          + json.dumps({k: v for k, v in launches.items() if v}) + " ")
    return launches, row


def auto_kernel(csr, device):
    """``(schedule, impl_used)`` that ``SpMVOperator(csr, "auto")`` takes
    on ``device``: the card row's pick, run by the impl the sweep timed it
    with (``tuning/sweep.IMPL_USED``)."""
    from loops_tpu_torch.layout import CsrLayout
    from loops_tpu_torch.schedule.plans import choose_schedule, thresholds_for
    from loops_tpu_torch.tuning.sweep import IMPL_USED

    row = thresholds_for(device)
    s = choose_schedule(CsrLayout.from_csr(csr), row)
    impl = row.get("impl", {}).get(s, "pallas3" if s == "sorted_flat"
                                   else "xla")
    return s, IMPL_USED[impl]


def first_of_each(names, key):
    """The first name of each group ``key(name)``, in order."""
    seen = {}
    for n in names:
        seen.setdefault(key(n), n)
    return list(seen.values())


def sweep_phase(device, smi, adj):
    """Phase 23: the sweep and the refits, through the package. Returns
    the launches of its main path."""
    import shutil
    import tempfile

    import torch

    from loops_tpu_torch.layout import CsrLayout
    from loops_tpu_torch.ops.kernels import _build
    from loops_tpu_torch.ops.spmm import SpMMOperator
    from loops_tpu_torch.ops.spmv import SpMVOperator
    from loops_tpu_torch.schedule import plans
    from loops_tpu_torch.tuning import autotune, fit, sweep
    from loops_tpu_torch.utils import generate, reference, statmatch
    from loops_tpu_torch.utils.bench import apply_ms

    t0 = time.perf_counter()
    parts, last = {}, [t0]

    def part(name):
        now = time.perf_counter()
        parts[name] = round(now - last[0], 1)
        last[0] = now

    _build.reset_launches()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_sweep_")
    try:
        # ---- the sweep over a fixed slice: the five schedules and the
        # vendor, each held to the Wilkinson bound
        synth = first_of_each(sweep.population("synthetic")[1],
                              lambda n: n.split("_")[0])
        pop = statmatch.load_population()
        replicas = [f"sm_{m.name}" for m in first_of_each(
            sorted(pop, key=lambda m: m.nnz), lambda m: m.family)]
        xl = [f"xl_uniform_{statmatch.XL_NNZ[0]}"]
        columns = sweep.SCHEDULES + (sweep.VENDOR,)
        for pname, names in (("synthetic", synth), ("statmatched", replicas),
                             ("xl", xl)):
            out = os.path.join(tmp, pname)
            wrong = sweep.sweep(pname, names, out, columns, device,
                                log=lambda line: None)
            require(wrong == 0, f"sweep {pname}: {sweep.wrong_rows(out)}")
            runs = sweep.load_logs(out)
            require(sorted(runs) == sorted(names)
                    and all(len(r) == len(columns) for r in runs.values()),
                    f"sweep {pname}: a pair was refused or not timed: "
                    f"{ {k: sorted(v) for k, v in runs.items()} }")
            dev = sweep.load_logs(out, sweep.DEVICE_COL)
            for n in names:
                best = min(runs[n], key=runs[n].get)
                print(f"  sweep {n}: fastest {best} {runs[n][best]:.4f} ms "
                      "apply; " + ", ".join(
                          f"{c} {runs[n][c]:.4f}/"
                          f"{dev.get(n, {}).get(c, float('nan')):.4f}"
                          for c in columns) + " ms (apply/card)  "
                      f"[{smi}]", flush=True)
            part(f"sweep {pname}")

        # ---- the fitter over the committed logs, from their features
        logs = os.path.join(REPO, "plots", "data", "h100")
        copy = os.path.join(tmp, "committed")
        shutil.copytree(logs, copy)
        cap, best = fit.fit_spmv(os.path.join(copy, "statmatched"))
        row = dict(plans.CARD_THRESHOLDS)["H100"]
        want = {k: v for k, v in row.items() if k != "provenance"}
        require(fit.as_table(best) == want,
                f"refit {fit.as_table(best)} != the card row {want}")
        spmm_dirs = [os.path.join(copy, "spmm", d)
                     for d in sorted(os.listdir(os.path.join(copy, "spmm")))]
        scap, sbest = fit.fit_spmm(spmm_dirs)
        route = dict(plans.CARD_SPMM_ROUTES)["H100"]
        swant = {k: v for k, v in route.items() if k != "provenance"}
        require(fit.as_table(sbest, sweep.SPMM_IMPL) == swant,
                f"SpMM refit {sbest} != the card route {swant}")
        print(f"  refit from the committed logs' features.csv: "
              f"{fit.describe(best)} (capture {cap:.1%}), SpMM route "
              f"{fit.describe(sbest)} (capture {scap:.1%}): equal to the "
              "card's rows", flush=True)
        part("refit")

        # ---- auto runs the swept impl on each branch of the card's row
        on_card = plans.thresholds_for(device)
        require(on_card is row, "thresholds_for gave another row")
        feats = {**fit.read_features(os.path.join(copy, "synthetic")),
                 **fit.read_features(os.path.join(copy, "statmatched"))}
        branches = {}
        for n in sorted(feats, key=lambda n: feats[n]["nnz"]):
            s = fit.pick(feats[n], *fit.as_tuple(row))
            branches.setdefault(s, n)
        for s, n in sorted(branches.items()):
            csr = fit.rebuild(n)
            op = SpMVOperator(csr, "auto", device=device)
            want_used = sweep.IMPL_USED[row["impl"][s]]
            require(op.schedule == s and op.impl_used == want_used,
                    f"auto on {n}: {op.schedule}/{op.impl_used}, the row "
                    f"says {s}/{want_used}")
            x = generate.make_input_vector(csr.shape[1])
            rep = reference.rigorously_validate_spmv(csr, x,
                                                     op(x).cpu().numpy())
            require(rep.verdict == "NOT_A_BUG", f"auto on {n}: {rep}")
            print(f"  auto on {n}: {s} -> {op.impl_used} (swept impl "
                  f"{row['impl'][s]}), {rep.verdict}", flush=True)
        s = plans.choose_schedule(CsrLayout.from_csr(adj), route)
        sop = SpMMOperator(adj, "auto", device=device)
        require(sop.schedule == s and sop.impl_used
                == sweep.SPMM_IMPL_USED[route["impl"][s]],
                f"SpMM auto on arxiv: {sop.schedule}/{sop.impl_used}")
        print(f"  SpMM auto on the arxiv stand-in: {s} -> "
              f"{sop.impl_used}", flush=True)
        del sop
        part("auto branches")

        # ---- auto on the arxiv stand-in against K1 and group_mapped
        x = generate.make_input_vector(adj.shape[1])
        xd = torch.from_numpy(x).to(device)
        judge = reference.spmv_judge(adj, x)
        times = {}
        for label, kw in (("auto", {}), ("auto reorder=bfs",
                                         {"reorder": "bfs"}),
                          ("K1", {"schedule": "sorted_flat"}),
                          ("group_mapped", {"schedule": "group_mapped"})):
            op = SpMVOperator(adj, kw.pop("schedule", "auto"),
                              device=device, **kw)
            rep = judge(op(xd).cpu().numpy())
            require(rep.verdict == "NOT_A_BUG", f"arxiv {label}: {rep}")
            times[label] = (apply_ms(op, xd), op.schedule, op.impl_used)
        print("  arxiv stand-in SpMV (ms per apply): " + ", ".join(
            f"{k} {ms:.4f} ({sched}, {used})"
            for k, (ms, sched, used) in times.items()) + f"  [{smi}]",
            flush=True)
        part("arxiv auto")

        # ---- autotune into a temporary cache, never the user's
        old = os.environ.get("LOOPS_TUNE_CACHE")
        os.environ["LOOPS_TUNE_CACHE"] = os.path.join(tmp, "tune.json")
        try:
            tuned = autotune.autotune(device, verbose=False)
        finally:
            if old is None:
                del os.environ["LOOPS_TUNE_CACHE"]
            else:
                os.environ["LOOPS_TUNE_CACHE"] = old
        print(f"  autotune: spmv_block {tuned['spmv_block']}, spmm_block_f "
              f"{tuned['spmm_block_f']} ({tuned['timing']}; "
              f"{json.dumps(tuned['spmv_ms'])}; "
              f"{json.dumps(tuned['spmm_ms'])})  [{smi}]", flush=True)
        part("autotune")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = dict(_build.LAUNCHES)
    for k in ("sorted_spmv", "flat_spmv_v2", "flat_spmv", "flat_spmm"):
        require(launches[k] > 0, f"{k} never launched in phase 23")
    print("  phase 23 by part (s): " + json.dumps(parts), flush=True)
    phase(23, "sweep and refits", t0, "main-path launches "
          + json.dumps({k: v for k, v in launches.items() if v}) + " ")
    return launches


def sampled_rows_check(csr, X, Y, dtype=None):
    """``reference.validate_sampled_rows(csr, X, Y)`` over the same 256
    rows (seed 7) without widening all of a disk-backed ``X`` to f64: the
    drawn rows as a CSR over the columns they touch, ``X``'s rows of those
    columns and ``Y``'s drawn rows, every row of it checked."""
    from loops_tpu_torch.formats import CSR
    from loops_tpu_torch.utils import reference

    n = min(256, csr.shape[0])
    chk = np.sort(np.random.default_rng(7).choice(csr.shape[0], n,
                                                  replace=False))
    lo = csr.offsets[chk].astype(np.int64)
    hi = csr.offsets[chk + 1].astype(np.int64)
    idx = np.concatenate([np.arange(a, b) for a, b in zip(lo, hi)])
    uniq, local = np.unique(csr.indices[idx], return_inverse=True)
    sub = CSR((n, len(uniq)), np.concatenate([[0], np.cumsum(hi - lo)]),
              local, csr.vals[idx])
    return reference.validate_sampled_rows(
        sub, np.asarray(X[uniq]), np.asarray(Y[chk]), n=n,
        bf16_products=dtype is not None)


def stream_vs_whole(csr, X, Y, device):
    """The streamed ``Y`` against one unsharded K4 pass of the whole CSR
    on the card: ``(overruns, max |Y - C| / bound, K4 ms, K4 launches)``.
    Both lie within the Wilkinson bound ``max(1e-7, 4 nnz_r u32 sum |a
    x|)`` of the exact sum, so they may differ by twice it; ``sum |a x|``
    is K4 over ``|A|`` and ``|X|``."""
    import torch

    from loops_tpu_torch.layout import CsrLayout
    from loops_tpu_torch.ops.kernels import _build, spmm_flat
    from loops_tpu_torch.schedule.plans import FlatBlockPlan
    from loops_tpu_torch.utils import reference

    plan = FlatBlockPlan.merge_path(CsrLayout.from_csr(csr), block_work=512)
    bufs, fn = spmm_flat.flat_spmm(csr, plan, device=device)
    del plan
    Xd = torch.from_numpy(np.asarray(X)).to(device)
    before = _build.LAUNCHES["flat_spmm"]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    C = fn(bufs, Xd)
    ev[1].record()
    torch.cuda.synchronize()
    ms = ev[0].elapsed_time(ev[1])
    bufs["vals"].abs_()
    l1 = fn(bufs, Xd.abs_())
    launches = _build.LAUNCHES["flat_spmm"] - before
    del Xd, bufs
    u = reference.unit_roundoff(np.float32)
    nnz_r = torch.from_numpy(np.diff(csr.offsets).astype(np.float32)).to(
        device)[:, None]
    overruns, worst = 0, 0.0
    step = 1 << 20
    for r0 in range(0, csr.shape[0], step):
        r1 = min(r0 + step, csr.shape[0])
        y = torch.from_numpy(np.asarray(Y[r0:r1])).to(device)
        bound = 2 * torch.clamp(reference.DEFAULT_WILKINSON_K * u
                                * nnz_r[r0:r1] * l1[r0:r1],
                                min=reference.DEFAULT_ATOL_FLOOR)
        ratio = (y - C[r0:r1]).abs() / bound
        overruns += int((ratio > 1).sum())
        worst = max(worst, float(ratio.max()))
    return overruns, worst, ms, launches


def padded_k4_check(op, p, X, Y, device) -> str:
    """K4 at the stream's staged shape for shard ``p`` of ``op`` (a
    ``StreamedSpMM`` on ``merge_path`` that has written ``Y``): the shard
    staged with the store's ``pad_groups``/``pad_R`` on the card, against
    K4's plain version on the same buffers and gathered features, against
    K4 over the same padded shard staged without them or with twice the
    store's blocks, and against the rows the stream wrote, all bit for
    bit. Returns a line to print."""
    import torch

    from loops_tpu_torch.layout import CsrLayout
    from loops_tpu_torch.ops.kernels import _build, spmm_flat
    from loops_tpu_torch.schedule.plans import FlatBlockPlan

    s = op.sharded.shard(p)
    shape = (op.rows_pd, op.gat_pd)
    padded = {k: v.to(device) for k, v in op.stage(p).items()}
    gather = np.asarray(s["gather"])
    xg = torch.zeros(op.gat_pd, X.shape[1], device=device)
    xg[:len(gather)] = torch.from_numpy(np.take(X, gather, axis=0)).to(
        device)
    csr_p = op._padded_shard_csr(p)
    plan = FlatBlockPlan.merge_path(CsrLayout.from_csr(csr_p),
                                    block_work=op.block_work)
    own, fn = spmm_flat.flat_spmm(csr_p, plan, dtype=op.dtype, device=device)
    blocks, R = fn.meta["groups"], fn.meta["R"]
    # and twice the store's blocks, so that empty blocks run at this size
    # even where the store pads this shard with none
    wide, fn_wide = spmm_flat.flat_spmm(csr_p, plan, dtype=op.dtype,
                                        device=device,
                                        pad_groups=2 * op.groups, pad_R=op.R)
    del plan, csr_p
    before = _build.LAUNCHES["flat_spmm"]
    C_pad = spmm_flat.flat_spmm_apply(padded, xg, shape, op.dtype)
    C_own = fn(own, xg)
    C_wide = fn_wide(wide, xg)
    torch.cuda.synchronize()
    label = f"shard {p} {op.dtype or 'f32'}"
    require(_build.LAUNCHES["flat_spmm"] == before + 3,
            f"{label}: K4 did not launch on the three stagings")
    require(torch.equal(C_pad, C_wide), f"{label}: K4 with twice the "
            f"store's blocks differs by "
            f"{float((C_pad - C_wide).abs().max()):.3e}")
    del C_wide, wide
    require(padded["vals"].shape[0] == op.groups >= blocks,
            f"{label}: {padded['vals'].shape[0]} staged blocks, {blocks} "
            f"own, the store's {op.groups}")
    require(torch.equal(C_pad, C_own), f"{label}: padded K4 differs from "
            f"unpadded K4 by {float((C_pad - C_own).abs().max()):.3e}")
    plain = spmm_flat.flat_spmm_plain(padded, xg, shape, op.dtype)
    require(torch.equal(C_pad, plain), f"{label}: padded K4 differs from "
            f"its plain version by {float((C_pad - plain).abs().max()):.3e}")
    del plain, own, padded
    rows = s["rows"]
    y = torch.from_numpy(np.asarray(Y[s["row0"]: s["row0"] + rows])).to(
        device)
    require(torch.equal(C_pad[:rows], y),
            f"{label}: the stream's rows differ from padded K4")
    require(not C_pad[rows:].any(), f"{label}: a padding row is not zero")
    del C_pad, C_own, xg, y
    torch.cuda.empty_cache()
    return (f"padded K4 {label}: {rows:,} rows {len(s['indices']):,} nnz "
            f"{len(gather):,} gathered at the staged {shape[0]:,} x "
            f"{shape[1]:,}; {blocks:,} own blocks padded to the store's "
            f"{op.groups:,} ({op.groups - blocks:,} empty), R {R} raised to "
            f"{op.R}: equal to unpadded K4, to K4 padded to "
            f"{2 * op.groups:,} blocks, to its plain version and to the "
            "stream's rows, bit for bit")


def most_padded_shards(op) -> list:
    """The shards of ``op`` whose own K4 staging is padded the most and
    the least: their merge-path block counts against the store's."""
    from loops_tpu_torch.io.shards import merge_path_extent

    own = [merge_path_extent(op._padded_offsets(p), op.block_work)[0]
           for p in range(op.sharded.num_shards)]
    return sorted({int(np.argmin(own)), int(np.argmax(own))})


def outofcore_phase(device, smi, big, x_big):
    """Phase 24: the native tier, K1's plan cache and the out-of-core
    stream through K4. Returns the launches of its main path."""
    import shutil
    import tempfile

    import torch

    from loops_tpu_torch import native
    from loops_tpu_torch.ops.kernels import _build
    from loops_tpu_torch.ops.spmv import SpMVOperator
    from loops_tpu_torch.utils import counters
    from loops_tpu_torch.utils import outofcore, reference

    t0 = time.perf_counter()
    parts, last = {}, [t0]

    def part(name):
        now = time.perf_counter()
        parts[name] = round(now - last[0], 1)
        last[0] = now

    main = {k: 0 for k in _build.LAUNCHES}

    @contextlib.contextmanager
    def main_path():
        before = dict(_build.LAUNCHES)
        yield
        for k, v in _build.LAUNCHES.items():
            main[k] += v - before[k]

    tmp = tempfile.mkdtemp(prefix="chip_smoke_ooc_")
    try:
        # ---- (a) the native library against numpy, 10M nonzeros
        require(native.load_library() is not None,
                "the native library did not build (g++ missing?)")
        rng = np.random.default_rng(24)
        n, width = OOC_NATIVE_NNZ, 1 << 20
        rows = rng.integers(0, width, n, dtype=np.int32)
        cols = rng.integers(0, width, n, dtype=np.int32)
        vals = rng.standard_normal(n, dtype=np.float32)
        t = time.perf_counter()
        got = native.coo_to_csr(rows, cols, vals, width)
        t_native = time.perf_counter() - t
        t = time.perf_counter()
        order = np.lexsort((cols, rows))
        want = (np.searchsorted(rows[order], np.arange(width + 1)),
                cols[order], vals[order])
        t_numpy = time.perf_counter() - t
        require(got is not None and all(
            np.array_equal(a, b) for a, b in zip(got, want)),
            "native coo_to_csr differs from numpy's stable lexsort")
        t = time.perf_counter()
        uniq, local = native.unique_remap(cols, width)
        t_remap = time.perf_counter() - t
        ref_u, ref_l = np.unique(cols, return_inverse=True)
        require(np.array_equal(uniq, ref_u) and np.array_equal(local, ref_l),
                "native unique_remap differs from np.unique")
        print(f"  native: coo_to_csr {n:,} nonzeros {t_native:.2f} s "
              f"(numpy lexsort {t_numpy:.2f} s), unique_remap "
              f"{t_remap:.2f} s: equal to numpy", flush=True)
        del rows, cols, vals, got, want, order, uniq, local, ref_u, ref_l
        part("native")

        # ---- (b) K1's plan from the cache: built, then loaded
        xd = torch.from_numpy(x_big).to(device)
        cache = os.path.join(tmp, "plans")
        ys, binds = [], []
        for source in ("built", "cache"):
            t = time.perf_counter()
            with main_path():
                op = SpMVOperator(big, "sorted_flat", plan_cache=cache,
                                  device=device)
                ys.append(op(xd))
            torch.cuda.synchronize()
            binds.append(time.perf_counter() - t)
            require(op.meta["plan_source"] == source and op.launches == 1,
                    f"K1 bind {len(ys)}: {op.meta['plan_source']}, "
                    f"{op.launches} launches")
            print(f"  K1 plan {source}: plan_ms {op.meta['plan_ms']:.2f} "
                  f"(built {op.meta['built_plan_ms']:.2f}), the key (shape "
                  f"and offsets) hashed in {op.meta['key_ms']:.2f} ms; bind and one "
                  f"apply {binds[-1]:.2f} s on big_2097152 "
                  f"({big.nnz:,} nnz)  [{smi}]", flush=True)
        require(torch.equal(ys[0], ys[1]),
                "K1 from the cached plan differs from the built plan")
        rep = reference.rigorously_validate_spmv(big, x_big,
                                                 ys[1].cpu().numpy())
        require(rep.verdict == "NOT_A_BUG", f"K1 from the cache: {rep}")
        del op, ys, xd
        part("plan cache")

        # ---- (c) the stream at the reference script's documented size
        csr, dt = outofcore.build_graph(OOC_NODES, OOC_AVG_DEG)
        print(f"  graph: {csr.shape[0]:,} nodes {csr.nnz:,} edges (built "
              f"{dt:.1f} s)", flush=True)
        part("graph")
        work = os.path.join(tmp, "big")
        sharded, dt_stage, nbytes = outofcore.stage(csr, OOC_SHARDS, work)
        blocks, dt_plan = outofcore.plan_all(sharded)
        print(f"  stage: {OOC_SHARDS} shards, {nbytes / 2**20:.0f} MiB in "
              f"{dt_stage:.1f} s; plan: {blocks:,} merge_path blocks in "
              f"{dt_plan:.1f} s", flush=True)
        X = outofcore.feature_table(os.path.join(work, "X.npy"),
                                    csr.shape[1], OOC_FEAT)
        Y = outofcore.output_table(os.path.join(work, "Y.npy"),
                                   csr.shape[0], OOC_FEAT)
        part("stage, plan, tables")
        torch.cuda.reset_peak_memory_stats()
        with main_path():
            op, dt, setup = outofcore.stream(sharded, X, Y, "merge_path",
                                             None, device)
        peak = torch.cuda.max_memory_allocated()
        require(main["flat_spmm"] >= OOC_SHARDS,
                f"K4 launched {main['flat_spmm']} times for "
                f"{OOC_SHARDS} shards")
        split = outofcore.part_seconds(op)
        print(f"  stream: {dt:.1f} s, {csr.nnz / dt / 1e6:.2f} M edges/s "
              f"incl. host gathers (setup {setup:.2f} s); padded groups "
              f"{op.groups:,}, R {op.R}, rows {op.rows_pd:,}, gather rows "
              f"{op.gat_pd:,}; peak device memory {peak / 2**30:.2f} GiB; "
              "by part (s): " + ", ".join(f"{k} {v:.3f}"
                                          for k, v in split.items())
              + f"  [{smi}]", flush=True)
        for p in range(OOC_SHARDS):
            s = sharded.shard(p)
            b_ms, b_by = counters.bound_of(counters.csr_spmm_work(
                s["rows"], len(s["gather"]), len(s["indices"]), OOC_FEAT))
            print(f"    shard {p}: {s['rows']:,} rows {len(s['indices']):,} "
                  f"nnz {len(s['gather']):,} gathered; " + ", ".join(
                      f"{k} {op.times[k][p] * 1e3:.2f}" for k in op.times)
                  + f" ms; K4 bound {b_ms:.3f} ms ({b_by})", flush=True)
        part("stream")
        for p in most_padded_shards(op):
            print("  " + padded_k4_check(op, p, X, Y, device), flush=True)
        part("padded K4")
        ok, nnz = outofcore.heaviest_row(csr, X, Y)
        require(ok, f"heaviest row ({nnz} nnz) mismatches")
        srep = sampled_rows_check(csr, X, Y)
        require(srep.overruns == 0, f"sampled rows: {srep}")
        over, worst, whole_ms, _ = stream_vs_whole(csr, X, Y, device)
        require(over == 0, f"streamed Y against the unsharded K4 pass: "
                f"{over} entries past twice the Wilkinson bound")
        print(f"  checks: heaviest row ({nnz} nnz) OK; {srep.rows} sampled "
              f"rows within the Wilkinson bound (rel {srep.rel_error:.2e}); "
              f"against one unsharded K4 pass ({whole_ms:.2f} ms on the "
              f"card, the stream's K4 {sum(op.times['kernel']) * 1e3:.2f} "
              f"ms): max {worst:.3f} of twice the bound", flush=True)
        del X, Y, op, sharded, csr
        shutil.rmtree(work)
        torch.cuda.empty_cache()
        part("checks")

        # ---- (d) bf16 on K4, and row_mapped, at the script's default size
        csr, dt = outofcore.build_graph(OOC_SMALL_NODES, OOC_AVG_DEG)
        work = os.path.join(tmp, "small")
        sharded, _, _ = outofcore.stage(csr, OOC_SHARDS, work)
        X = outofcore.feature_table(os.path.join(work, "X.npy"),
                                    csr.shape[1], OOC_FEAT)
        Y = outofcore.output_table(os.path.join(work, "Y.npy"),
                                   csr.shape[0], OOC_FEAT)
        for sched, dtype in (("merge_path", "bfloat16"), ("row_mapped", None)):
            k4_before = main["flat_spmm"]
            with main_path():
                op, dt, _ = outofcore.stream(sharded, X, Y, sched, dtype,
                                             device)
            require((main["flat_spmm"] > k4_before) == (sched == "merge_path"),
                    f"{sched}: K4 launches {main['flat_spmm'] - k4_before}")
            if sched == "merge_path":
                for p in most_padded_shards(op):
                    print("  " + padded_k4_check(op, p, X, Y, device),
                          flush=True)
            ok, nnz = outofcore.heaviest_row(csr, X, Y, dtype)
            srep = sampled_rows_check(csr, X, Y, dtype)
            require(ok and srep.overruns == 0,
                    f"{sched} {dtype}: heaviest row ok={ok}, {srep}")
            print(f"  {OOC_SMALL_NODES:,} nodes {csr.nnz:,} edges, {sched} "
                  f"{dtype or 'f32'}: {dt:.2f} s, {csr.nnz / dt / 1e6:.2f} M "
                  "edges/s; by part (s): " + ", ".join(
                      f"{k} {v:.3f}" for k, v in
                      outofcore.part_seconds(op).items())
                  + f"; heaviest row and {srep.rows} sampled rows OK  "
                  f"[{smi}]", flush=True)
        del X, Y, op, sharded, csr
        part("bf16 and row_mapped")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print("  phase 24 by part (s): " + json.dumps(parts), flush=True)
    phase(24, "out-of-core and the plan cache", t0, "main-path launches "
          + json.dumps({k: v for k, v in main.items() if v}) + " ")
    return main


def multidevice_phase(device, smi, ds, adj):
    """Phase 25: the multi-device tier at full width, as one NCCL rank,
    then its 8-rank protocols over gloo on the host's CPU. Returns the
    launches of its main path."""
    import shutil
    import tempfile

    import torch

    from loops_tpu_torch.io.shards import ShardedCSR
    from loops_tpu_torch.models import GCN
    from loops_tpu_torch.models import train as T
    from loops_tpu_torch.ops.kernels import _build
    from loops_tpu_torch.ops.spmm import SpMMOperator
    from loops_tpu_torch.parallel import (
        DistGCN,
        DistSpMMHalo,
        DistSpMMHier,
        EdgePartition,
        HaloPlan,
        HierHaloPlan,
        launch,
        make_mesh,
        make_mesh_hier,
    )
    from loops_tpu_torch.utils.bench import HoldExpired, apply_ms, device_ms

    t0 = time.perf_counter()
    graph, n = ds.graph, ds.graph.num_nodes
    dims = [ds.features.shape[1], GCN_HIDDEN, GCN_HIDDEN, ds.num_classes]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    try:
        with launch.single_rank("nccl"):
            require(torch.distributed.get_backend() == "nccl",
                    "the group is not NCCL's")
            flat = make_mesh(device="cuda")
            hier = make_mesh_hier(1, 1, device="cuda")
            print(f"  one NCCL rank: meshes {tuple(flat.mesh.shape)} "
                  f"{flat.mesh_dim_names}, {tuple(hier.mesh.shape)} "
                  f"{hier.mesh_dim_names}", flush=True)
            # the references run before the count starts: their K4
            # launches are not the tier's
            single = GCN(graph, dims, dropout=0.0, device=device,
                         generator=torch.Generator().manual_seed(25))
            state = {k: v.clone() for k, v in single.state_dict().items()}
            single.eval()
            with torch.no_grad():
                want = single(single.prepare_features(ds.features))
            scale = max(float(want.abs().max()), 1.0)
            sstep = T.make_train_step(
                single, torch.optim.Adam(single.parameters(), lr=1e-2),
                ds.features, ds.labels, ds.train_mask)
            ref_losses = [float(sstep()) for _ in range(10)]
            B = np.random.default_rng(25).normal(
                size=(adj.shape[0], GCN_HIDDEN)).astype(np.float32)
            k4 = SpMMOperator(adj, "merge_path", "pallas", device=device)
            Bd = torch.from_numpy(B).to(device)
            with torch.no_grad():
                ref = k4(Bd).cpu().numpy()

            before = dict(_build.LAUNCHES)
            steps, tier = {}, {}
            for exchange, mesh in (("halo", flat), ("all_gather", flat),
                                   ("hier", hier)):
                th = time.perf_counter()
                model = DistGCN(graph, dims, mesh, exchange=exchange)
                build_s = time.perf_counter() - th
                model.load_state_dict(state)
                require(all(op.impl_used == "flat_spmm"
                            for op in model.operators()),
                        f"DistGCN {exchange} took "
                        f"{[op.impl_used for op in model.operators()]}")
                model.eval()
                with torch.no_grad():
                    got = model(model.local_features(ds.features))
                require(tuple(got.shape) == (model.plan.rows_per_dev,
                                             ds.num_classes)
                        and bool(torch.isfinite(got).all()),
                        f"DistGCN {exchange}: bad logits")
                diff = float((got[:n] - want).abs().max())
                require(diff <= 1e-4 * scale,
                        f"DistGCN {exchange}: logits differ from GCN's by "
                        f"{diff:.3e} (max |logit| {scale:.3e})")
                step = model.make_train_step(
                    torch.optim.Adam(model.parameters(), lr=1e-2),
                    ds.features, ds.labels, ds.train_mask)
                losses = [float(step()) for _ in range(10)]
                rel = max(abs(a - b) / abs(b)
                          for a, b in zip(losses, ref_losses))
                require(rel <= 1e-3, f"DistGCN {exchange}: losses {losses} "
                        f"against GCN's {ref_losses}")
                steps[exchange] = step
                tier[exchange] = model.launches()
                require(tier[exchange] > 0,
                        f"K4 never launched in DistGCN {exchange}")
                print(f"  DistGCN {exchange} (overlap "
                      f"{getattr(model.propagate, 'overlap', False)}): "
                      f"logits within {diff:.3e} of GCN's (max |logit| "
                      f"{scale:.3e}); 10 Adam steps {losses[0]:.4f} -> "
                      f"{losses[-1]:.4f}, max rel. diff {rel:.2e} from "
                      f"GCN's; K4 launches {model.launches()}; built in "
                      f"{build_s:.2f} s", flush=True)

            # from_shards on the card: one shard, one chip
            store = ShardedCSR.build(adj, 1, os.path.join(tmp, "store"))
            part = EdgePartition.from_shards(store, chips_per_shard=1)
            hop = DistSpMMHier(HierHaloPlan.build(part, 1, 1), hier)
            hin = torch.from_numpy(part.local_features(B, 0)).to(device)
            with torch.no_grad():
                got = hop(hin)[:n].cpu().numpy()
            tier["from_shards"] = sum(op.launches for op in hop.operators)
            require(tier["from_shards"] > 0,
                    "K4 never launched in DistSpMMHier")
            diff = np.abs(got.astype(np.float64) - ref)
            require(np.all(diff <= spmm_pair_tolerance(adj, B, None)),
                    f"from_shards DistSpMMHier differs from SpMMOperator by "
                    f"{diff.max():.3e}")
            print(f"  from_shards (1 shard x 1 chip) -> DistSpMMHier at F = "
                  f"{GCN_HIDDEN}: max |diff| from SpMMOperator (K4) "
                  f"{diff.max():.3e}, bit for bit {bool((diff == 0).all())}",
                  flush=True)
            main = {k: v - before[k] for k, v in _build.LAUNCHES.items()}
            require(main["flat_spmm"] == sum(tier.values()),
                    f"K4 launched {main['flat_spmm']} times during the "
                    f"count, the tier's operators {tier}")
            print(f"  K4 launches of the tier's operators: {tier}",
                  flush=True)

            # the distributed wrapper's own cost at one rank, F = 128
            halo = DistSpMMHalo(HaloPlan.build(EdgePartition.build(adj, 1)),
                                flat, overlap=True)

            def card(fn, x):
                try:
                    return f"{device_ms(fn, x):.4f}"
                except HoldExpired:
                    return "not measured"
            with torch.no_grad():
                ms_halo, ms_k4 = apply_ms(halo, hin), apply_ms(k4, Bd)
                card_halo, card_k4 = card(halo, hin), card(k4, Bd)
            ms_dstep = apply_ms(lambda _: steps["halo"](), Bd, iters=10)
            ms_sstep = apply_ms(lambda _: sstep(), Bd, iters=10)
            print(f"  F = {GCN_HIDDEN}, one rank: DistSpMMHalo (overlap) "
                  f"{ms_halo:.4f} ms an apply (card {card_halo}) against "
                  f"SpMMOperator's {ms_k4:.4f} (card {card_k4}); DistGCN "
                  f"(halo) train step {ms_dstep:.3f} ms against GCN's "
                  f"{ms_sstep:.3f}  [{smi}]", flush=True)
        require(not torch.distributed.is_initialized(),
                "the NCCL group outlived the phase")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # the 8-rank protocols, on the host's CPU over gloo
    th = time.perf_counter()
    r = launch.dryrun_multichip(8)
    print(f"  (the line above: 8 gloo ranks on this machine's host CPU, "
          f"{os.cpu_count()} cores, in {time.perf_counter() - th:.1f} s; "
          f"not the card)", flush=True)
    require(r["hier_loss"] is not None, "the dry run ran no hier step")
    phase(25, "multi-device tier at full width", t0, "main-path launches "
          + json.dumps({k: v for k, v in main.items() if v}) + " ")
    return main


def load_script(name):
    """``scripts/<name>`` as a module of this process."""
    spec = importlib.util.spec_from_file_location(
        name.replace(".py", "_script"), os.path.join(REPO, "scripts", name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def tooling_phase(device, smi, ds, adj, big, x_big):
    """Phase 26: the training record at full width, the trace and the
    counters on the card, and ``scripts/run_torch.sh``. Returns the
    launches of its main path (the record and the traced steps)."""
    import shutil
    import tempfile

    import torch

    from loops_tpu_torch.models import GCN
    from loops_tpu_torch.models import train as T
    from loops_tpu_torch.ops.kernels import _build
    from loops_tpu_torch.ops.spmm import SpMMOperator
    from loops_tpu_torch.ops.spmv import SpMVOperator
    from loops_tpu_torch.utils import counters
    from loops_tpu_torch.utils import trace
    from loops_tpu_torch.utils.bench import apply_ms
    from loops_tpu_torch.utils.timer import time_fn

    t0 = time.perf_counter()
    rec_mod = load_script("train_record_torch.py")
    main = {k: 0 for k in _build.LAUNCHES}

    # ---- (a) the accuracy-matched training record, four rows
    print(f"  train record: {rec_mod.dataset_line(ds)}; {RECORD_EPOCHS} "
          f"epochs, hidden {GCN_HIDDEN}, lr {RECORD_LR}, seed 0  [{smi}]",
          flush=True)
    for ln in rec_mod.TABLE_HEAD:
        print(f"  {ln}")
    acc = {}
    for model_name in ("gcn", "sage"):
        for mode in rec_mod.MODES:
            th = time.perf_counter()
            a, ms, eps, launches = rec_mod.run_one(
                ds, model_name, mode, RECORD_EPOCHS, RECORD_LR, GCN_HIDDEN,
                0, device)
            acc[model_name, mode] = a
            for k, n in launches.items():
                main[k] += n
            print(f"  {rec_mod.table_row(model_name, mode, a, ms, eps)} "
                  f"launches {json.dumps(launches)}, "
                  f"{time.perf_counter() - th:.1f} s", flush=True)
            if mode == "exact":
                require(not launches, f"{model_name} exact launched "
                        f"{launches}: the exact path runs torch ops only")
            else:
                require(launches.get("flat_spmm", 0) > 0, f"{model_name} "
                        f"throughput launched no K4 ({launches})")
    for model_name in ("gcn", "sage"):
        gap = abs(acc[model_name, "throughput"] - acc[model_name, "exact"])
        require(gap <= RECORD_ACC_GAP, f"{model_name}: throughput test "
                f"accuracy {acc[model_name, 'throughput']:.4f} is "
                f"{gap:.4f} from exact's {acc[model_name, 'exact']:.4f}")
    print("  accuracy gap, throughput against exact: " + ", ".join(
        f"{m} {abs(acc[m, 'throughput'] - acc[m, 'exact']):.4f}"
        for m in ("gcn", "sage")) + f" (limit {RECORD_ACC_GAP})", flush=True)

    # ---- (b) five throughput GCN steps in trace.profile, each annotated
    dims = [ds.features.shape[1], GCN_HIDDEN, GCN_HIDDEN, ds.num_classes]
    model = GCN(ds.graph, dims, dropout=0.5, device=device,
                generator=torch.Generator().manual_seed(0),
                **rec_mod.model_kwargs("gcn", "throughput"))
    step = T.make_train_step(
        model, torch.optim.Adam(model.parameters(), lr=RECORD_LR),
        ds.features, ds.labels, ds.train_mask,
        generator=torch.Generator(device).manual_seed(1))
    step()
    torch.cuda.synchronize(device)
    names = [f"gcn_step_{i}" for i in range(TRACE_STEPS)]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_trace_")
    try:
        before = dict(_build.LAUNCHES)
        # raises on leaving where its record lacks a counted launch
        with trace.profile(tmp):
            for name in names:
                with trace.annotate(name):
                    step()
        counted = {k: n - before[k] for k, n in _build.LAUNCHES.items()
                   if n != before[k]}
        for k, n in counted.items():
            main[k] += n
        rec = trace.read_record(tmp)
        require(counted.get("flat_spmm", 0) > 0 and rec["counted"] == counted,
                f"trace: counted {counted}, record {rec['counted']}")
        k4 = [x for x in rec["launches"] if x["counter"] == "flat_spmm"]
        require(len(k4) == counted["flat_spmm"], f"trace: {len(k4)} K4 "
                f"launches recorded of {counted['flat_spmm']}")
        require(0 < rec["device_ms"] < rec["wall_ms"], f"trace: the "
                f"record's {rec['device_ms']:.3f} device ms against a "
                f"window of {rec['wall_ms']:.3f} ms")
        path = os.path.join(tmp, trace.TRACE_FILE)
        require(os.path.getsize(path) > 0 and os.path.exists(
            os.path.join(tmp, trace.KERNELS_FILE)), "trace: a file is missing")
        with open(path) as f:
            text = f.read()
        missing = [n for n in names if n not in text]
        require(not missing, f"trace: {missing} not in the Chrome trace")
        # a launch's range is its span path, gcn_step_0/train.forward/spmm
        per_step = [sum(1 for x in k4 if x["range"].split("/")[0] == n)
                    for n in names]
        print(f"  trace: {TRACE_STEPS} throughput GCN steps, K4 launches per "
              f"step {per_step}, all {len(k4)} in the record, K4 device "
              f"{sum(x['device_ms'] for x in k4):.3f} ms of a "
              f"{rec['wall_ms']:.3f} ms window (CUDA events around each "
              f"launch); Chrome trace {os.path.getsize(path) / 1e6:.1f} MB "
              "with every step's range; torch.profiler's own kernel list "
              + ("whole" if rec["profiler_list_whole"] else
                 "not whole (" + "; ".join(rec["profiler_gaps"][:3]) + ")")
              + f"  [{smi}]", flush=True)
        # a whole step by the generic count: K4 by its formula, the rest
        # by the torch ops it issues
        sc = counters.compiled_counters(step)
        step_ms = time_fn(step, device=device, warmup=1, iters=5,
                          reduction=statistics.median)
        su = counters.achieved(sc, step_ms)
        print(f"  counters of one throughput GCN step: {sc['flops'] / 1e9:.3f}"
              f" GFLOP, {sc['bytes accessed'] / 1e9:.3f} GB; at "
              f"{step_ms:.3f} ms a step: " + ", ".join(
                  f"{k} {v:.4f}" for k, v in su.items()) + f"  [{smi}]",
              flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del model, step

    # ---- (c) the counters on K1 and K4, with this phase's timings
    xd = torch.from_numpy(x_big).to(device)
    op = SpMVOperator(big, "sorted_flat", device=device)
    require(op.impl_used == "sorted_spmv", f"K1 expected, got {op.impl_used}")
    B = torch.from_numpy(np.random.default_rng(8).normal(
        size=(adj.shape[1], 128)).astype(np.float32)).to(device)
    cells = [("K1 big_2097152", op, xd,
              counters.csr_spmv_work(*big.shape, big.nnz))]
    for dtype in DTYPES:
        cells.append((f"K4 arxiv_gcn F=128 {dtype or 'f32'}",
                      SpMMOperator(adj, "merge_path", "pallas", dtype=dtype,
                                   device=device), B,
                      counters.csr_spmm_work(*adj.shape, adj.nnz, 128)))
    for label, fn, x, line_work in cells:
        cnt = counters.compiled_counters(fn, x)
        require(cnt["bytes accessed"] == line_work.nbytes
                and cnt["flops"] == line_work.flops, f"{label}: counters "
                f"{cnt} against the kernels line's {line_work}")
        ms = apply_ms(fn, x)
        ach = counters.achieved(cnt, ms)
        worst = max(v for k, v in ach.items() if k.endswith("utilization"))
        require(worst <= 1.05, f"{label}: utilization {ach} past 1.05")
        print(f"  counters {label}: {cnt['bytes accessed'] / 1e6:.1f} MB "
              f"(= the kernels line's), {cnt['flops'] / 1e9:.3f} GFLOP "
              f"{cnt['dtype']}; {ms:.4f} ms an apply: "
              + ", ".join(f"{k} {v:.4f}" for k, v in ach.items())
              + f"  [{smi}]", flush=True)
    del cells, op, xd, B
    torch.cuda.empty_cache()

    # ---- (d) scripts/run_torch.sh over datasets/ (chesapeake.mtx)
    out = tempfile.mkdtemp(prefix="chip_smoke_run_sh_")
    try:
        th = time.perf_counter()
        proc = subprocess.run(
            ["bash", os.path.join(REPO, "scripts", "run_torch.sh"),
             os.path.join(REPO, "datasets"), out], capture_output=True,
            text=True, timeout=900)
        require(proc.returncode == 0, f"run_torch.sh: exit "
                f"{proc.returncode}\n{proc.stderr[-2000:]}")
        files = sorted(os.listdir(out))
        require(files == sorted(f"{s}.csv" for s in RUN_SH_SCHEDULES),
                f"run_torch.sh wrote {files}")
        for sched in RUN_SH_SCHEDULES:
            with open(os.path.join(out, f"{sched}.csv")) as f:
                rows = f.read().splitlines()
            require(len(rows) == 1 and rows[0].split(",")[1:5]
                    == ["chesapeake", "39", "39", "340"],
                    f"run_torch.sh {sched}.csv: {rows}")
            print(f"  run_torch.sh {sched}.csv: {rows[0]}")
        print(f"  run_torch.sh: 5 CSVs of one row in "
              f"{time.perf_counter() - th:.1f} s  [{smi}]", flush=True)
    finally:
        shutil.rmtree(out, ignore_errors=True)
    phase(26, "tooling and the training record at full width", t0,
          "main-path launches "
          + json.dumps({k: v for k, v in main.items() if v}) + " ")
    return main


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from loops_tpu_torch.tuning.sweep import build_matrix

    # the xl matrices take a host core a minute each: built beside the
    # first phases, in processes that import no torch.cuda
    with ProcessPoolExecutor(len(XL_MATRICES), multiprocessing.get_context(
            "spawn")) as pool:
        xl_builds = {n: pool.submit(build_matrix, "xl", n)
                     for n in XL_MATRICES}
        try:
            return run_phases(xl_builds)
        finally:
            for f in xl_builds.values():
                f.cancel()


def run_phases(xl_builds) -> int:
    """Phases 1-26; ``xl_builds``: name -> future of ``(csr, seconds)``
    of each of ``XL_MATRICES``."""
    t_start = time.perf_counter()
    import torch

    from loops_tpu_torch.ops.kernels import _build
    from loops_tpu_torch.ops.spmv import SpMVOperator
    from loops_tpu_torch.utils import counters
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
          f"{_build.BUILD_INFO['seconds']:.2f} s; launch binding -> "
          f"{os.path.relpath(_build.BUILD_INFO['binding_path'], REPO)} in "
          f"{_build.BUILD_INFO['binding_seconds']:.2f} s ")

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
    from loops_tpu_torch.io import market
    chesapeake = market.load_csr(mtx)
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
            want = auto_kernel(chesapeake, device)[1]
            require(f"impl_used: {want}" in err,
                    f"auto did not take {want}, the card row's: {err}")
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
    th = time.perf_counter()
    xl = {n: f.result()[0] for n, f in xl_builds.items()}
    print(f"  xl matrices built in spawned processes, waited "
          f"{time.perf_counter() - th:.1f} s for them")
    xl_ops = {}
    for mname, csr in xl.items():
        x = generate.make_input_vector(csr.shape[1])
        th = time.perf_counter()
        op = SpMVOperator(csr, "sorted_flat", device=device)
        build_s = time.perf_counter() - th
        require(op.impl_used == "sorted_spmv", f"{mname}: {op.impl_used}")
        y = op(x).cpu().numpy()
        require(op.launches == 1, f"{mname}: {op.launches} launches")
        require(y.shape == (csr.shape[0],) and np.all(np.isfinite(y)),
                f"{mname}: bad output")
        errors = count_mismatches(y, reference.spmv(csr, x))
        rep = reference.rigorously_validate_spmv(csr, x, y)
        print(f"  {mname} ({csr.shape[0]}x{csr.shape[1]}, {csr.nnz} nnz) "
              f"sorted_spmv: Errors {errors}, Verdict {rep.verdict}, "
              f"launch shape {op._raw.launch.shape}, plan_ms "
              f"{op.meta['plan_ms']:.1f}, operator build {build_s:.2f} s")
        require(errors == 0 and rep.verdict == "NOT_A_BUG",
                f"{mname}/sorted_spmv: {errors} errors, {rep}")
        xl_ops[mname] = (op, csr, x)
    del xl, y
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
    # K1 on the xl matrices: kernel, plain, cuSPARSE, the card alone,
    # and the byte bound of utils/counters
    for mname, (op, csr, x) in xl_ops.items():
        xd = torch.from_numpy(x).to(device)
        A = torch.sparse_csr_tensor(
            torch.from_numpy(csr.offsets).to(device),
            torch.from_numpy(csr.indices).to(device),
            torch.from_numpy(csr.vals).to(device), size=csr.shape)
        plain = plains["sorted_spmv"](op)
        diff = np.abs(op(xd).cpu().numpy().astype(np.float64)
                      - plain(xd).cpu().numpy())
        require(np.all(diff <= pair_tolerance(csr, x)),
                f"{mname}: kernel and plain differ by {diff.max()}")
        max_err["sorted_spmv"] = max(max_err["sorted_spmv"],
                                     float(diff.max(initial=0.0)))
        require(bool(torch.isfinite(torch.mv(A, xd)).all()),
                f"{mname}: cuSPARSE: bad output")
        p1 = apply_ms(plain, xd)
        k1 = apply_ms(op, xd)
        k2 = apply_ms(op, xd)
        p2 = apply_ms(plain, xd)
        cs = apply_ms(lambda v: torch.mv(A, v), xd)
        card = device_ms(op, xd)
        cs_card = device_ms(lambda v: torch.mv(A, v), xd)
        b_ms, b_by = counters.bound_of(
            counters.csr_spmv_work(*csr.shape, csr.nnz))
        times[mname, "sorted_spmv"] = dict(
            ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2, cusparse_ms=cs,
            card_ms=card, cusparse_card_ms=cs_card, bound_ms=b_ms)
        print(f"  {mname} sorted_spmv: kernel {k1:.4f}/{k2:.4f} ms, plain "
              f"{p1:.4f}/{p2:.4f} ms, cuSPARSE {cs:.4f} ms; card K1 "
              f"{card:.4f} ms ({b_ms / card:.1%} of the bound), cuSPARSE "
              f"{cs_card:.4f} ms ({b_ms / cs_card:.1%}), K1/cuSPARSE "
              f"{card / cs_card:.3f}; bound {b_ms:.4f} ms ({b_by}); host "
              f"plan {op.meta['plan_ms']:.1f} ms  [{smi}]")
        del A
    del xl_ops
    torch.cuda.empty_cache()
    parts = launch_cost.launch_path_parts(device)
    print(f"  launch path, host us per call (less {parts['empty_us']:.3f} "
          f"us of an empty call), {smi}:")
    for key in ("parts", "calls"):
        for label, us in parts[key].items():
            print(f"    {label}: {us:.2f}")
    p = parts["parts"]
    ct = ", through ctypes (comparison only)"
    print(f"  the C call, launch binding / ctypes (comparison only), host "
          f"us: K1 {p['launch: C call, K1 (one kernel, packed plan)']:.2f} "
          f"/ {p['launch: C call, K1' + ct]:.2f}; K12 "
          f"{p['launch: C call, K12']:.2f} / "
          f"{p['launch: C call, K12' + ct]:.2f}  [{smi}]")
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
    sage_launches, sage_err = sage_phase(device, smi, ds)
    gat_phase(device, smi, ds)
    fmt_launches, _ = formats_phase(device, smi, mats["big_2097152"][0],
                                    x_big, bench, adj, rate)
    sweep_launches = sweep_phase(device, smi, adj)
    ooc_launches = outofcore_phase(device, smi, mats["big_2097152"][0], x_big)
    md_launches = multidevice_phase(device, smi, ds, adj)
    tool_launches = tooling_phase(device, smi, ds, adj,
                                  mats["big_2097152"][0], x_big)

    print(f"total {time.perf_counter() - t_start:.1f} s; card: {smi}")
    kernels = []
    big = mats["big_2097152"][0]
    spmv_mat, spmm_mat = bcsr_mats
    big_work = counters.csr_spmv_work(*big.shape, big.nnz)
    adj_work = counters.csr_spmm_work(*adj.shape, adj.nnz, 128)
    bounds = {
        **{k: (lambda r: counters.bound_of(big_work, r)) for k in KERNELS},
        "flat_spmm": lambda r: counters.bound_of(adj_work, r),
        "bcsr_spmv": lambda r: counters.bound_of(
            counters.bcsr_work(*bcsr_shape(spmv_mat)), r),
        **{k: (lambda r: counters.bound_of(counters.bcsr_work(
            *bcsr_shape(spmm_mat), SPMM_F), r))
           for k in BCSR_KERNELS if k != "bcsr_spmv"},
        **sddmm_bounds,
        "stream_read": lambda r: counters.bound(
            stream_res["1 GiB"]["nbytes"], 0, rate=r),
        **{k: (lambda r, rec=rec: counters.bound(
            rec["nbytes"], rec["flops"],
            "bfloat16" if rec["peak"] == "bf16" else None, r))
           for k, rec in probe_recs.items()},
    }
    for k, (rep_at, _, _) in KERNELS.items():
        b_ms, b_by = counters.bound_of(big_work)
        kernels.append(
            {"name": k, "route": "cuda", "source": SOURCE, "replaces": rep_at,
             "launches": (launches[k] + fmt_launches[k] + sweep_launches[k]
                          + ooc_launches[k]),
             "max_abs_err": max_err[k],
             "ms": times["big_2097152", k]["ms"],
             "plain_ms": times["big_2097152", k]["plain_ms"],
             "bound_ms": b_ms, "bound_by": b_by,
             "library_ms": times["big_2097152", k]["cusparse_ms"]})
    b_ms, b_by = counters.bound_of(adj_work)
    kernels.append(
        {"name": "flat_spmm", "route": "cuda", "source": SPMM_SOURCE,
         "replaces": SPMM_REPLACES,
         "launches": (gcn_launches["flat_spmm"] + sage_launches["flat_spmm"]
                      + fmt_launches["flat_spmm"]
                      + sweep_launches["flat_spmm"]
                      + ooc_launches["flat_spmm"]
                      + md_launches["flat_spmm"]
                      + tool_launches["flat_spmm"]),
         "max_abs_err": max(spmm_err, sage_err),
         "ms": spmm_times["f32"]["ms"],
         "plain_ms": spmm_times["f32"]["plain_ms"], "bound_ms": b_ms,
         "bound_by": b_by, "library_ms": spmm_times["f32"]["library_ms"]})
    for k, (rep_at, _, _) in BCSR_KERNELS.items():
        kernels.append(
            {"name": k, "route": "cuda", "source": BCSR_SOURCE,
             "replaces": rep_at,
             "launches": bcsr_launches[k] + fmt_launches[k],
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
    b_ms, b_by = bounds["stream_read"](None)
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
        nom, by = max(bounds[entry["name"]](None),
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
