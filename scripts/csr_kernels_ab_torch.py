#!/usr/bin/env python3
"""Time K1–K3, K12, K4, K5, K7–K10 of one checkout of ``loops_tpu_torch``
on the card, at the cells ``chip_smoke.py`` times them (phases 6, 10, 13,
17 and 19), and print one JSON line.

    python scripts/csr_kernels_ab_torch.py [--tree DIR] [--library]
                                           [--cells spmv,flat,csr,bcsr]

``--tree`` names the checkout whose ``loops_tpu_torch`` is imported and
timed (default: this one). To compare two versions on one card, unpack the
older tree with ``git archive`` into a git-ignored directory and run this
script on each in turns (old, new, new, old) in one command: every tree is
timed by the same calls, the operators a user builds, so the older tree
needs no script of its own:

- K1: ``SpMVOperator(csr, "sorted_flat")`` on bench_32768 and
  big_2097152 (``utils/profile_spmv.MATRICES``): ``apply_ms`` (CUDA events
  over back-to-back applies), ``slope_ms`` (applies chained ``y = A y``),
  ``device_ms`` (the card's time per apply, the applies queued behind a
  sleep kernel) and the host share ``1 - device_ms / apply_ms``, the part
  of an apply in which the card waits for the host (``apply_ms`` and
  ``slope_ms`` both run at the pace of the slower side, so their ratio
  cannot show it); K1's host microseconds per apply on a 4096^2 matrix,
  the card held (``host_us``);
- K3 and K2: ``SpMVOperator(csr, "merge_path", block=1024, impl=
  "pallas")`` and ``impl="pallas2"`` on the same two matrices, timed as K1
  and beside it;
- K12: ``saxpy_cuda`` on the example's [8, 8192], microseconds per call
  by the slope of 450 back-to-back calls over 50 (``probes/common.
  launch_ms``) and by the host clock with the card held;
- K5: ``SDDMMOperator(csr, impl="pallas", dtype="bfloat16")`` on the JAX
  bench's 65536^2 SDDMM regime (``bench.py:414-445``) and on the
  arxiv-shaped GCN adjacency, F = 128;
- K4: ``SpMMOperator(adj, "merge_path", "pallas", dtype)`` at F = 128 and
  at the GCN's last layer, F = 40, f32 and bf16;
- the GCN train step of both forms of phase 10 (bf16 throughput form, f32
  default form), dims [128, 128, 128, 40];
- K7 (f32 and bf16), K9 and K8 (f32 and bf16): ``SpMMOperator(bcsr,
  "row_mapped", impl, block_f=512, dtype)`` on bcsr_spmm_16384_f512
  (``build_block_sparse(16384, 8, 128, 0.06, seed=0)``, B [16384, 512]
  from ``default_rng(1)``), by ``apply_ms`` and ``device_ms``; with
  ``--library`` cuSPARSE's ``torch.matmul`` on the CSR form, f32 and bf16
  (vals and B in bf16);
- K10: ``SDDMMOperator(bcsr, impl="pallas", block_f=512)`` on
  bcsr_sddmm_16384_f512 (the same matrix; A and B [16384, 512] from
  ``default_rng(1)``, as ``chip_smoke.py`` phase 17 draws them), by
  ``apply_ms`` and ``device_ms``; with ``--library`` cuSPARSE's
  ``torch.sparse.sampled_addmm`` over the stored pattern times vals.

Kernels are timed with ``utils.bench.apply_ms`` (CUDA events, median per
apply), steps with ``utils.timer.time_fn`` (median of 30); the K1 and K12
cells with this checkout's ``utils/bench.py``, loaded by path, whatever
the tree. ``--library``
adds the library calls, timed only: cuSPARSE's ``torch.mv`` (apply and
slope), ``torch.add(y, x, alpha=2.5)`` per call, ``torch.sparse.mm`` and
``torch.sparse.sampled_addmm`` times vals. ``--cells`` picks the groups:
``spmv`` (K1, K12), ``flat`` (K3, K2), ``csr`` (K4, K5, the GCN step),
``bcsr`` (K7, K9, K8, K10); ``spmv,csr`` by default. The
line before the JSON is the card's name and power limit from
``nvidia-smi``.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import statistics
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# K12's per-call slope: calls at its two ends
SAXPY_CALLS = (50, 450)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=REPO)
    ap.add_argument("--library", action="store_true")
    ap.add_argument("--cells", default="spmv,csr")
    args = ap.parse_args(argv)
    cells = set(args.cells.split(","))
    import torch

    if not torch.cuda.is_available():
        print("csr_kernels_ab_torch: needs an NVIDIA card", file=sys.stderr)
        return 2
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import loops_tpu_torch

    if not loops_tpu_torch.__file__.startswith(tree):
        raise RuntimeError(f"imported {loops_tpu_torch.__file__}, not the "
                           f"tree {tree}")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    res = {"tree": os.path.relpath(tree, REPO), "card": smi}
    if "spmv" in cells:
        res.update(spmv_cells(dev, args.library))
    if "flat" in cells:
        # K1 beside them, in the same call
        res.update(spmv_kernel_cells(dev, ("K3", "K2", "K1"), args.library))
    if "csr" in cells:
        res.update(csr_cells(dev, args.library))
    if "bcsr" in cells:
        res.update(bcsr_cells(dev, args.library))
    print(smi)
    print(json.dumps(res))
    return 0


def _timing():
    """This checkout's ``utils/bench.py``, loaded by path: the same timing
    code for every tree, the older ones included."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "ab_bench", os.path.join(REPO, "loops_tpu_torch", "utils", "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the SpMV kernels of the spmv and flat cells: name -> SpMVOperator's
# (schedule, impl); K2 and K3 at chip_smoke.py's block of 1024 work items
SPMV_KERNELS = {"K1": ("sorted_flat", "xla"), "K3": ("merge_path", "pallas"),
                "K2": ("merge_path", "pallas2")}
FLAT_BLOCK = 1024


def spmv_kernel_cells(dev, kernels, library: bool) -> dict:
    """``kernels`` (keys of ``SPMV_KERNELS``), and cuSPARSE's ``torch.mv``
    with ``library``, on bench_32768 and big_2097152: apply, slope, the
    card's time alone and the host share."""
    import torch
    from loops_tpu_torch.ops.spmv import SpMVOperator
    from loops_tpu_torch.utils import generate
    from loops_tpu_torch.utils.profile_spmv import MATRICES

    bench = _timing()
    res = {}
    for cell in ("bench_32768", "big_2097152"):
        csr = MATRICES[cell]()
        xd = torch.from_numpy(generate.make_input_vector(csr.shape[1])).to(
            dev)
        calls = {}
        for name in kernels:
            schedule, impl = SPMV_KERNELS[name]
            calls[name] = SpMVOperator(
                csr, schedule, impl=impl, device=dev,
                **({} if name == "K1" else {"block": FLAT_BLOCK}))
        if library:
            A = torch.sparse_csr_tensor(
                *(torch.from_numpy(a).to(dev) for a in (csr.offsets,
                                                        csr.indices,
                                                        csr.vals)),
                size=csr.shape)
            calls["cuSPARSE mv"] = lambda v, A=A: torch.mv(A, v)
        for name, fn in calls.items():
            ap = bench.apply_ms(fn, xd)
            card = bench.device_ms(fn, xd)
            res[f"{name} {cell}"] = dict(
                apply_ms=ap, slope_ms=bench.slope_ms(fn, xd), device_ms=card,
                host_share=1 - card / ap)
        del calls
        torch.cuda.empty_cache()
    return res


def spmv_cells(dev, library: bool) -> dict:
    """K1 on bench_32768 and big_2097152, K12 on [8, 8192]."""
    import torch
    from loops_tpu_torch.ops.kernels import saxpy
    from loops_tpu_torch.ops.spmv import SpMVOperator
    from loops_tpu_torch.probes.common import launch_ms
    from loops_tpu_torch.utils import generate

    bench = _timing()
    res = spmv_kernel_cells(dev, ("K1",), library)
    # the host's launch path alone, with the card held (bench.host_us)
    small = generate.random_csr(4096, 4096, 16 / 4096, seed=3)
    op = SpMVOperator(small, "sorted_flat", device=dev)
    xs = torch.from_numpy(generate.make_input_vector(4096)).to(dev)
    res["K1 4096^2 host us per apply"] = bench.host_us(lambda: op(xs))
    rng = np.random.default_rng(0)
    x, y = (torch.from_numpy(rng.normal(size=(8, 8192)).astype(
        np.float32)).to(dev) for _ in range(2))
    calls = {"K12 saxpy_cuda": lambda: saxpy.saxpy_cuda(2.5, x, y)}
    if library:
        calls["torch.add"] = lambda: torch.add(y, x, alpha=2.5)
    for name, fn in calls.items():
        res[f"{name} [8, 8192] us per call"] = 1e3 * launch_ms(
            fn, dev, *SAXPY_CALLS)
        res[f"{name} [8, 8192] host us per call"] = bench.host_us(fn)
    return res


def csr_cells(dev, library: bool) -> dict:
    """K5, K4 and the GCN train step on their cells."""
    import torch
    from loops_tpu_torch.io import ogb
    from loops_tpu_torch.models import GCN
    from loops_tpu_torch.models import train as T
    from loops_tpu_torch.ops.sddmm import SDDMMOperator
    from loops_tpu_torch.ops.spmm import SpMMOperator
    from loops_tpu_torch.utils import generate
    from loops_tpu_torch.utils.bench import apply_ms
    from loops_tpu_torch.utils.timer import time_fn

    res = {}
    BF = "bfloat16"

    ds = ogb.load("ogbn-arxiv")
    graph = ds.graph
    adj = graph.gcn_normalized().adj
    bench = generate.random_csr(rows=65536, cols=65536,
                                sparsity=2.47e6 / 65536 ** 2, seed=6)
    rng = np.random.default_rng(8)
    A_bench = rng.normal(size=(65536, 128)).astype(np.float32)
    B_bench = rng.normal(size=(65536, 128)).astype(np.float32)
    rng = np.random.default_rng(0)
    A_arx = rng.normal(size=(adj.shape[0], 128)).astype(np.float32)
    B_arx = rng.normal(size=(adj.shape[1], 128)).astype(np.float32)

    def on_card(csr, dt):
        return torch.sparse_csr_tensor(
            *(torch.from_numpy(a).to(dev) for a in (csr.offsets,
                                                    csr.indices)),
            torch.from_numpy(csr.vals).to(dev, dt), size=csr.shape)

    # K5
    for cell, csr, A, B in (("sddmm_65536_f128", bench, A_bench, B_bench),
                            ("arxiv_gcn_f128", adj, A_arx, B_arx)):
        Ad, Bd = (torch.from_numpy(a).to(dev) for a in (A, B))
        op = SDDMMOperator(csr, impl="pallas", dtype=BF, device=dev)
        res[f"K5 {cell}"] = apply_ms(lambda a, op=op, Bd=Bd: op(a, Bd), Ad)
        if library:
            S = on_card(csr, torch.float32)
            v = S.values()
            res[f"cuSPARSE sampled_addmm f32 {cell}"] = apply_ms(
                lambda a, S=S, v=v, Bt=Bd.t(): torch.sparse.sampled_addmm(
                    S, a, Bt, beta=0.0).values() * v, Ad, iters=10)
            del S, v
        del Ad, Bd, op
        torch.cuda.empty_cache()

    # K4, at F = 128 and at the GCN's last layer, F = 40
    B128 = torch.from_numpy(np.random.default_rng(8).normal(
        size=(adj.shape[1], 128)).astype(np.float32)).to(dev)
    for dtype, F in ((None, 128), (BF, 128), (None, 40), (BF, 40)):
        name = f"f{F} {dtype or 'f32'}"
        Bd = B128[:, :F].contiguous()
        op = SpMMOperator(adj, "merge_path", "pallas", dtype=dtype,
                          device=dev)
        res[f"K4 arxiv_gcn_{name}"] = apply_ms(op, Bd)
        if library and F == 128:
            S = on_card(adj, torch.float32 if dtype is None
                        else torch.bfloat16)
            Bc = Bd.to(S.dtype)
            res[f"cuSPARSE sparse.mm {dtype or 'f32'}"] = apply_ms(
                lambda B, S=S: torch.sparse.mm(S, B), Bc)
            del S, Bc
        del op
    torch.cuda.empty_cache()

    # the GCN train step of both forms (chip_smoke.py phase 10)
    dims = [ds.features.shape[1], 128, 128, ds.num_classes]
    forms = {
        "throughput (bf16)": dict(dtype=BF, precompute_first=True,
                                  loss_rows=ds.train_mask),
        "default (f32)": {}}
    for form, kw in forms.items():
        model = GCN(graph, dims, dropout=0.5, device=dev,
                    generator=torch.Generator().manual_seed(0), **kw)
        step = T.make_train_step(
            model, torch.optim.Adam(model.parameters(), lr=1e-2),
            ds.features, ds.labels, ds.train_mask,
            generator=torch.Generator(dev).manual_seed(1))
        res[f"GCN step {form}"] = time_fn(step, device=dev, warmup=3,
                                          iters=30,
                                          reduction=statistics.median)
        del model, step
        torch.cuda.empty_cache()
    return res


# the BCSR SpMM kernels of the bcsr cells: name -> (impl, dtype)
BCSR_KERNELS = {"K7 f32": ("pallas3", None), "K7 bf16": ("pallas3", "bfloat16"),
                "K9 f32": ("pallas", None), "K8 f32": ("pallas2", None),
                "K8 bf16": ("pallas2", "bfloat16")}


def bcsr_cells(dev, library: bool) -> dict:
    """K7, K9 and K8 on bcsr_spmm_16384_f512 (``chip_smoke.py`` phase 13)
    and K10 on bcsr_sddmm_16384_f512 (phase 17): apply and the card's time
    alone."""
    import torch
    from loops_tpu_torch.ops.sddmm import SDDMMOperator
    from loops_tpu_torch.ops.spmm import SpMMOperator
    from loops_tpu_torch.utils import generate

    bench = _timing()
    csr, bcsr = generate.build_block_sparse(16384, 8, 128, 0.06, 0)
    Bd = torch.from_numpy(np.random.default_rng(1).normal(
        size=(16384, 512)).astype(np.float32)).to(dev)
    res = {}
    for name, (impl, dtype) in BCSR_KERNELS.items():
        op = SpMMOperator(bcsr, "row_mapped", impl, block_f=512, dtype=dtype,
                          device=dev)
        res[f"{name} bcsr_spmm_16384_f512"] = dict(
            apply_ms=bench.apply_ms(op, Bd), device_ms=bench.device_ms(op, Bd))
        del op
        torch.cuda.empty_cache()
    if library:
        for dt, label in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            A = torch.sparse_csr_tensor(
                *(torch.from_numpy(a).to(dev) for a in (csr.offsets,
                                                        csr.indices)),
                torch.from_numpy(csr.vals).to(dev, dt), size=csr.shape)
            Bc = Bd.to(dt)
            fn = functools.partial(torch.matmul, A)
            res[f"cuSPARSE {label} bcsr_spmm_16384_f512"] = dict(
                apply_ms=bench.apply_ms(fn, Bc),
                device_ms=bench.device_ms(fn, Bc))
            del A, Bc
    del Bd
    torch.cuda.empty_cache()
    # K10 on the same matrix, A and B as chip_smoke.py phase 17 draws them
    rng = np.random.default_rng(1)
    Ad, Bd = (torch.from_numpy(rng.normal(size=(16384, 512)).astype(
        np.float32)).to(dev) for _ in range(2))
    op = SDDMMOperator(bcsr, impl="pallas", block_f=512, device=dev)
    fn = functools.partial(lambda a, op, Bd: op(a, Bd), op=op, Bd=Bd)
    res["K10 bcsr_sddmm_16384_f512"] = dict(
        apply_ms=bench.apply_ms(fn, Ad), device_ms=bench.device_ms(fn, Ad))
    del op
    if library:
        pattern, _ = bcsr.stored_pattern()
        S = torch.sparse_csr_tensor(
            *(torch.from_numpy(a).to(dev) for a in (
                pattern.offsets, pattern.indices, pattern.vals)),
            size=pattern.shape)
        v = S.values()
        fn = functools.partial(
            lambda a, S, v, Bt: torch.sparse.sampled_addmm(
                S, a, Bt, beta=0.0).values() * v, S=S, v=v, Bt=Bd.t())
        res["cuSPARSE sampled_addmm f32 bcsr_sddmm_16384_f512"] = dict(
            apply_ms=bench.apply_ms(fn, Ad, iters=10),
            device_ms=bench.device_ms(fn, Ad))
        del S, v
    return res


if __name__ == "__main__":
    sys.exit(main())
