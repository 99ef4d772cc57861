#!/usr/bin/env python3
"""Time K1–K10, K12 and K15's P1, G1 and G3 of one checkout of
``loops_tpu_torch`` on the card, at the cells ``chip_smoke.py`` times them
(phases 6, 10, 13, 17 and 19), and print one JSON line.

    python scripts/csr_kernels_ab_torch.py [--tree DIR] [--library]
        [--cells spmv,flat,csr,bcsr,bcsrmv,gather,scatter,xl]
        [--xl-dir DIR] [--y-dir DIR]

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
- K1 on the 8 matrices of the xl tier (``utils/statmatch.xl_battery``:
  four families at 16.8M and 67.1M nonzeros), by ``apply_ms`` and
  ``device_ms``, beside the byte bound of ``utils/counters`` and, with
  ``--library``, cuSPARSE's ``torch.mv``; a matrix is built once (in
  spawned processes, a minute of host core each) into ``--xl-dir``
  (default: ``loops_xl_matrices`` under the temporary directory) and
  loaded from there by every later run, so the turns of an A/B time the
  same matrices;
- K12: ``saxpy_cuda`` on the example's [8, 8192], microseconds per call
  by the slope of 450 back-to-back calls over 50 (``probes/common.
  launch_ms``) and by the host clock with the card held, and on 2^26
  elements, ms per call by the slope of 20 calls over 4, beside the byte
  bound of ``utils/counters``;
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
  ``torch.sparse.sampled_addmm`` over the stored pattern times vals;
- K6: ``SpMVOperator(bcsr, impl="pallas")`` on bcsr_spmv_32768
  (``build_block_sparse(32768, 8, 128, 0.015, seed=0)``, x from
  ``make_input_vector``) by ``apply_ms``, ``device_ms`` and ``cold_ms``
  (one apply from an empty L2, the regime of its byte bound: its 64 MB of
  blocks are 1.3 times the 50 MB L2, so a warm apply finds part of them
  there); with ``--library`` cuSPARSE's ``torch.mv`` on the CSR form and
  on ``torch.sparse_bsr_tensor``, timed the same three ways;
- K15 G3 ``onehot_expand`` at W = 128, 512 and 2048, G1 ``row_gather``
  (sums, K = 128 f32) from shared memory (S = 256), from L2 (S = 4096)
  and from device memory (S = 2,097,152, a control), G2 (materialized
  rows, K = 64 f32, S = 256 and 4096, a control), P1 ``gather_axis0``
  at S = 256 (shared memory) and 1024 (L2) and P2 ``gather_axis1`` at S
  = 256 (a control), at
  ``probes/gather.py``'s sizes (N = 2,097,152 rows, 4,194,304
  elements): ms per launch by the slope of 20 launches over 4
  (``probes/common.launch_ms``), P1 and P2 also by one launch from an
  empty L2 (``cold_ms``: their idx and out fit the L2); with
  ``--library`` ``torch.index_select`` (G3), ``embedding_bag`` (G1) and
  ``torch.take_along_dim`` (P1).

Kernels are timed with ``utils.bench.apply_ms`` (CUDA events, median per
apply), steps with ``utils.timer.time_fn`` (median of 30); the K1 and K12
cells with this checkout's ``utils/bench.py``, loaded by path, whatever
the tree. ``--library``
adds the library calls, timed only: cuSPARSE's ``torch.mv`` (apply and
slope), ``torch.add(y, x, alpha=2.5)`` per call, ``torch.sparse.mm`` and
``torch.sparse.sampled_addmm`` times vals. ``--cells`` picks the groups:
``spmv`` (K1, K12), ``flat`` (K3, K2), ``csr`` (K4, K5, the GCN step),
``bcsr`` (K7, K9, K8, K10), ``bcsrmv`` (K6), ``gather`` (G3, G1, P1),
``scatter`` (K14's scatters, the block dots, G1 at S = 256, K13),
``xl`` (K1 on the xl tier); ``spmv,csr`` by default. The
line before the JSON is the card's name and power limit from
``nvidia-smi``.

``--y-dir DIR`` holds K1's output across trees: the first run saves its
y of each ``spmv`` and ``xl`` matrix there (``K1_<matrix>.npy``), and
every later run, with another ``--tree`` too, reports whether its y is
bit for bit the saved one (``"K1 <matrix> y bitwise"``: true or false).
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import statistics
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# K12's per-call slope: calls at its two ends
SAXPY_CALLS = (50, 450)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=REPO)
    ap.add_argument("--library", action="store_true")
    ap.add_argument("--cells", default="spmv,csr")
    ap.add_argument("--xl-dir", default=os.path.join(
        tempfile.gettempdir(), "loops_xl_matrices"))
    ap.add_argument("--y-dir", default=None)
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
        res.update(spmv_cells(dev, args.library, args.y_dir))
    if "flat" in cells:
        # K1 beside them, in the same call
        res.update(spmv_kernel_cells(dev, ("K3", "K2", "K1"), args.library))
    if "csr" in cells:
        res.update(csr_cells(dev, args.library))
    if "bcsr" in cells:
        res.update(bcsr_cells(dev, args.library))
    if "bcsrmv" in cells:
        res.update(bcsr_spmv_cells(dev, args.library))
    if "gather" in cells:
        res.update(gather_cells(dev, args.library))
    if "scatter" in cells:
        res.update(scatter_cells(dev, args.library))
    if "xl" in cells:
        res.update(xl_cells(dev, args.library, args.xl_dir, args.y_dir))
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


def same_y(y_dir, cell: str, fn, xd) -> dict:
    """K1's y on ``cell`` (``fn(xd)``) saved into ``y_dir`` by the first
    run, or held bit for bit against what it saved; nothing without
    ``y_dir``."""
    if y_dir is None:
        return {}
    y = fn(xd).cpu().numpy()
    path = os.path.join(y_dir, f"K1_{cell}.npy")
    if not os.path.exists(path):
        os.makedirs(y_dir, exist_ok=True)
        np.save(path, y)
        return {f"K1 {cell} y saved": path}
    want = np.load(path)
    return {f"K1 {cell} y bitwise": bool(
        y.shape == want.shape
        and np.array_equal(y.view(np.uint32), want.view(np.uint32)))}


def spmv_kernel_cells(dev, kernels, library: bool, y_dir=None) -> dict:
    """``kernels`` (keys of ``SPMV_KERNELS``), and cuSPARSE's ``torch.mv``
    with ``library``, on bench_32768 and big_2097152: apply, slope, the
    card's time alone and the host share; with ``y_dir``, K1's y held
    across trees (``same_y``)."""
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
        if "K1" in calls:
            res.update(same_y(y_dir, cell, calls["K1"], xd))
        del calls
        torch.cuda.empty_cache()
    return res


def xl_matrices(xl_dir: str, pop: str = "xl", names=None) -> dict:
    """The xl tier's matrices (or ``names`` of population ``pop``), name
    -> CSR: loaded from ``xl_dir``, or built (four spawned processes) and
    saved there first."""
    from loops_tpu_torch.formats import csr_from_arrays
    from loops_tpu_torch.tuning import sweep

    names = names or sweep.population(pop)[1]
    path = {n: os.path.join(xl_dir, f"{n}.npz") for n in names}
    todo = [n for n in names if not os.path.exists(path[n])]
    if todo:
        os.makedirs(xl_dir, exist_ok=True)
        for n, csr, _ in sweep._matrices(pop, todo, 65536, "none", 4):
            tmp = path[n] + ".tmp.npz"
            np.savez(tmp, shape=np.array(csr.shape), offsets=csr.offsets,
                     indices=csr.indices, vals=csr.vals)
            os.replace(tmp, path[n])
    mats = {}
    for n in names:
        with np.load(path[n]) as f:
            mats[n] = csr_from_arrays(tuple(int(v) for v in f["shape"]),
                                      f["offsets"], f["indices"], f["vals"])
    return mats


def xl_cells(dev, library: bool, xl_dir: str, y_dir=None) -> dict:
    """K1, and cuSPARSE's ``torch.mv`` with ``library``, on the 8 xl
    matrices: apply and card ms, and the byte bound (``utils/counters``,
    3.35 TB/s); with ``y_dir``, K1's y held across trees (``same_y``)."""
    import torch
    from loops_tpu_torch.ops.spmv import SpMVOperator
    from loops_tpu_torch.utils import counters, generate

    bench = _timing()
    res = {}
    for name, csr in xl_matrices(xl_dir).items():
        xd = torch.from_numpy(generate.make_input_vector(csr.shape[1])).to(
            dev)
        calls = {"K1": SpMVOperator(csr, "sorted_flat", device=dev)}
        if library:
            A = torch.sparse_csr_tensor(
                *(torch.from_numpy(a).to(dev) for a in (csr.offsets,
                                                        csr.indices,
                                                        csr.vals)),
                size=csr.shape)
            calls["cuSPARSE mv"] = lambda v, A=A: torch.mv(A, v)
        for label, fn in calls.items():
            res[f"{label} {name}"] = dict(apply_ms=bench.apply_ms(fn, xd),
                                          device_ms=bench.device_ms(fn, xd))
        res[f"bound {name}"] = counters.bound_of(
            counters.csr_spmv_work(*csr.shape, csr.nnz))[0]
        res.update(same_y(y_dir, name, calls["K1"], xd))
        del calls
        torch.cuda.empty_cache()
    return res


def spmv_cells(dev, library: bool, y_dir=None) -> dict:
    """K1 on bench_32768 and big_2097152, K12 on [8, 8192] and 2^26."""
    import torch
    from loops_tpu_torch.ops.kernels import saxpy
    from loops_tpu_torch.utils import counters
    from loops_tpu_torch.ops.spmv import SpMVOperator
    from loops_tpu_torch.probes.common import launch_ms
    from loops_tpu_torch.utils import generate

    bench = _timing()
    res = spmv_kernel_cells(dev, ("K1",), library, y_dir)
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
    g = torch.Generator(device=dev).manual_seed(26)
    x, y = (torch.randn(1 << 26, device=dev, generator=g) for _ in range(2))
    calls = {"K12 saxpy_cuda": lambda: saxpy.saxpy_cuda(2.5, x, y)}
    if library:
        calls["torch.add"] = lambda: torch.add(y, x, alpha=2.5)
    for name, fn in calls.items():
        res[f"{name} 2^26 ms per call"] = launch_ms(fn, dev)
    res["K12 2^26 byte bound ms"] = counters.bound_of(
        counters.saxpy_work(1 << 26))[0]
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


def bcsr_spmv_cells(dev, library: bool) -> dict:
    """K6 on bcsr_spmv_32768 (``chip_smoke.py`` phase 13): apply, the
    card's time alone, and one apply from an empty L2."""
    import torch
    from loops_tpu_torch.ops.spmv import SpMVOperator
    from loops_tpu_torch.utils import generate

    bench = _timing()
    csr, bcsr = generate.build_block_sparse(32768, 8, 128, 0.015, 0)
    xd = torch.from_numpy(generate.make_input_vector(32768)).to(dev)
    calls = {"K6": SpMVOperator(bcsr, impl="pallas", device=dev)}
    if library:
        for name, A in (
                ("cuSPARSE csrmv", torch.sparse_csr_tensor(
                    *(torch.from_numpy(a).to(dev) for a in (
                        csr.offsets, csr.indices, csr.vals)),
                    size=csr.shape)),
                ("torch bsr mv", torch.sparse_bsr_tensor(
                    *(torch.from_numpy(a).to(dev) for a in (
                        bcsr.block_offsets, bcsr.block_cols, bcsr.vals)),
                    size=bcsr.shape))):
            calls[name] = functools.partial(torch.mv, A)
    res = {}
    for name, fn in calls.items():
        try:
            res[f"{name} bcsr_spmv_32768"] = dict(
                apply_ms=bench.apply_ms(fn, xd),
                device_ms=bench.device_ms(fn, xd),
                cold_ms=bench.cold_ms(lambda fn=fn: fn(xd), dev))
        except (RuntimeError, NotImplementedError) as e:
            # timed only: a format torch refuses on the card
            res[f"{name} bcsr_spmv_32768"] = str(e).splitlines()[0]
    return res


def gather_cells(dev, library: bool) -> dict:
    """K15 G3 at W = 128, 512 and 2048, G1 (K = 128 f32) from shared
    memory, L2 and device memory, G2 (K = 64 f32) from shared memory and
    L2, P1 at S = 256 and 1024, P2 at S = 256: ms per launch by slope,
    P1's and P2's also from an empty L2."""
    import torch
    from loops_tpu_torch.probes import gather as G
    from loops_tpu_torch.probes.common import launch_ms

    res = {}
    for W in G.G3_W:
        win, idx = (torch.from_numpy(a).to(dev) for a in G.onehot_inputs(W))
        res[f"G3 W={W}"] = launch_ms(lambda: G.onehot_expand(win, idx), dev)
        if library:
            wr = win.to(torch.bfloat16).float()
            rl = G.onehot_rows(idx).long()
            res[f"index_select G3 W={W}"] = launch_ms(
                lambda: torch.index_select(wr, 0, rl), dev)
    for S in (G.SMEM_ROWS, 4096, G.HBM_ROWS):
        slab, idx = G.row_gather_tensors(S, 128, G.N_ROWS, True, dev)
        res[f"G1 S={S} K=128 f32"] = launch_ms(
            lambda: G.row_gather(slab, idx, 128, False), dev)
        if library:
            bags = G.row_gather_bags(idx, 128)
            res[f"embedding_bag G1 S={S}"] = launch_ms(
                lambda: torch.nn.functional.embedding_bag(bags, slab,
                                                          mode="sum"), dev)
        del slab, idx
    for S in (G.SMEM_ROWS, 4096):  # G2, a control
        slab, idx = G.row_gather_tensors(S, 64, G.N_ROWS, False, dev)
        res[f"G2 S={S} K=64 f32"] = launch_ms(
            lambda: G.row_gather(slab, idx, 64, True), dev)
    # P1's and P2's idx and out (33.6 MB) fit the L2, which back-to-back
    # launches find warm: one launch from an empty L2 too, as their byte
    # bounds assume
    bench = _timing()

    def both(name, fn):
        res[name] = launch_ms(fn, dev)
        res[f"{name} cold"] = bench.cold_ms(fn, dev)
    for S in (256, 1024):
        src, idx = (torch.from_numpy(a).to(dev) for a in G.axis0_inputs(S))
        both(f"P1 S={S}", lambda: G.gather_axis0(src, idx))
        if library:
            il = idx.long()
            both(f"take_along_dim P1 S={S}",
                 lambda: torch.take_along_dim(src, il, dim=0))
    src, idx = (torch.from_numpy(a).to(dev) for a in G.axis1_inputs(256))
    both("P2 S=256", lambda: G.gather_axis1(src, idx))
    torch.cuda.empty_cache()
    return res


def _device_us(fn, kernel: str, launches: int = 400):
    """The median duration ``torch.profiler`` records for ``kernel`` over
    ``launches`` calls of ``fn()`` (None when the trace holds none)."""
    import statistics

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(launches):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == DeviceType.CUDA and kernel in e.name]
    return statistics.median(us) if us else None


def scatter_cells(dev, library: bool) -> dict:
    """K14's smem scatter, one pass from an empty L2 (``cold_ms``) and the
    warm slope over passes, through its bind form where the tree has one;
    as controls the L2 scatter (cold), the block dots (M = 128, B
    streamed; slope over passes) and G1 (S = 256, K = 128 f32; slope);
    K13's calls by slope (the scan, and the constructs' mean), unbound
    and, where the tree has them, bound into ``out=``, each kernel's
    device time (``torch.profiler`` median) beside them."""
    import torch
    from loops_tpu_torch.probes import gather as G
    from loops_tpu_torch.probes import mosaic, r2
    from loops_tpu_torch.probes.common import launch_ms

    bench = _timing()
    res = {}
    for smem in (True, False):
        rows = r2.SMEM_ROWS if smem else r2.L2_ROWS
        offs, a = (torch.from_numpy(v).to(dev)
                   for v in r2.scatter_inputs(rows))
        if smem and not hasattr(r2, "smem_scatter"):
            def run(n):
                return r2.scatter_cuda(offs, a, rows, n)
        else:
            b, fn = (r2.smem_scatter if smem else r2.l2_scatter)(
                offs, rows, device=dev)

            def run(n):
                return fn(b, a, n)
        name = "smem_scatter 256x64" if smem else "l2_scatter 4096x512"
        res[name] = dict(cold_ms=bench.cold_ms(lambda: run(1), dev),
                         warm_ms=bench.run_slope_ms(run, 2, 10, 3))
        if library:
            idx = (offs.long()[:, None] * r2.RR + torch.arange(
                r2.RR, device=dev)).reshape(-1)
            acc = a.new_zeros(rows, a.shape[2])
            flat = a.reshape(-1, a.shape[2])
            res[f"index_add_ {name.split()[1]}"] = dict(
                cold_ms=bench.cold_ms(lambda: acc.index_add_(0, idx, flat),
                                      dev))
            del acc, idx
        del offs, a, run
        torch.cuda.empty_cache()
    for mode in r2.MODES:
        A, B = r2._dot_tensors(128, True, mode, dev)
        res[f"block_dot_{mode} M=128 streamB"] = bench.run_slope_ms(
            lambda n: r2.block_dot(A, B, mode, n), 2, 10, 3)
        del A, B
    slab, idx = G.row_gather_tensors(G.SMEM_ROWS, 128, G.N_ROWS, True, dev)
    res["G1 S=256 K=128 f32"] = launch_ms(
        lambda: G.row_gather(slab, idx, 128, False), dev)
    del slab, idx
    v, keep = (torch.from_numpy(x).to(dev) for x in mosaic.scan_inputs())
    args = {k: mosaic._on(x, dev) for k, x in
            mosaic.construct_inputs().items()}
    calls = {"seg_scan": lambda: mosaic.seg_scan_cuda(v, keep),
             **{k: (lambda k=k: mosaic.construct_cuda(k, *args[k]))
                for k in mosaic.CONSTRUCTS}}
    bound = {}
    if hasattr(mosaic, "seg_scan_bind"):
        b, fn = mosaic.seg_scan_bind(v, keep, device=dev)
        o = torch.empty_like(v)
        bound["seg_scan"] = lambda: fn(b, out=o)
        for k in mosaic.CONSTRUCTS:
            bk, fk = mosaic.construct_bind(k, *args[k], device=dev)
            ok = torch.empty_like(calls[k]())
            bound[k] = lambda bk=bk, fk=fk, ok=ok: fk(bk, out=ok)
    for k, call in calls.items():
        kernel = "seg_scan_probe_kernel" if k == "seg_scan" \
            else "construct_probe_kernel"
        res[f"K13 {k}"] = dict(
            unbound_ms=launch_ms(call, dev),
            bound_ms=launch_ms(bound[k], dev) if k in bound else None,
            device_us=_device_us(call, kernel))
    return res


if __name__ == "__main__":
    sys.exit(main())
