#!/usr/bin/env python3
"""Time K4 and K5 of one checkout of ``loops_tpu_torch`` on the card, at
the cells ``chip_smoke.py`` times them (phases 10 and 17), and print one
JSON line.

    python scripts/csr_kernels_ab_torch.py [--tree DIR] [--library]

``--tree`` names the checkout whose ``loops_tpu_torch`` is imported and
timed (default: this one). To compare two versions on one card, unpack the
older tree with ``git archive`` into a git-ignored directory and run this
script on each in turns (old, new, new, old) in one command: every tree is
timed by the same calls, the operators a user builds, so the older tree
needs no script of its own:

- K5: ``SDDMMOperator(csr, impl="pallas", dtype="bfloat16")`` on the JAX
  bench's 65536^2 SDDMM regime (``bench.py:414-445``) and on the
  arxiv-shaped GCN adjacency, F = 128;
- K4: ``SpMMOperator(adj, "merge_path", "pallas", dtype)`` at F = 128 and
  at the GCN's last layer, F = 40, f32 and bf16;
- the GCN train step of both forms of phase 10 (bf16 throughput form, f32
  default form), dims [128, 128, 128, 40].

Kernels are timed with ``utils.bench.apply_ms`` (CUDA events, median per
apply), steps with ``utils.timer.time_fn`` (median of 30). ``--library``
adds cuSPARSE's calls (``torch.sparse.sampled_addmm`` times
vals, ``torch.sparse.mm``), timed only. The line before the JSON is the
card's name and power limit from ``nvidia-smi``.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=REPO)
    ap.add_argument("--library", action="store_true")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("csr_kernels_ab_torch: needs an NVIDIA card", file=sys.stderr)
        return 2
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import loops_tpu_torch
    from loops_tpu_torch.io import ogb
    from loops_tpu_torch.models import GCN
    from loops_tpu_torch.models import train as T
    from loops_tpu_torch.ops.sddmm import SDDMMOperator
    from loops_tpu_torch.ops.spmm import SpMMOperator
    from loops_tpu_torch.utils import generate
    from loops_tpu_torch.utils.bench import apply_ms
    from loops_tpu_torch.utils.timer import time_fn

    if not loops_tpu_torch.__file__.startswith(tree):
        raise RuntimeError(f"imported {loops_tpu_torch.__file__}, not the "
                           f"tree {tree}")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    res = {"tree": os.path.relpath(tree, REPO), "card": smi}
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
        if args.library:
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
        if args.library and F == 128:
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
    print(smi)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
