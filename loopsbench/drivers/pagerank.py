"""PageRank solves, back to back, as LDBC Graphalytics defines them: a
fixed number of iterations from the uniform vector; the dangling nodes'
mass spread evenly.

The transition matrix is a CSR with rows as destinations and the damping
folded into its values, ``P[v, u] = d / out(u)``. Each iteration is the
program's ``SpMVOperator(P, schedule="auto")(x)`` (K1 on an H100), then
its ``saxpy`` (K12) adding the teleport vector, then, where the graph
has dangling nodes, their mass as a plain torch term. A solve ends when
the host reads the last iteration's L1 change.

The graph is the same for every seed (``gen/suitesparse_prior.py``), and
every solve computes the same ranks. The check compares a sample of the
window's solves, drawn from the seed, and its last, with
``reference/pagerank.py``: the largest relative gap of a rank, and the
gap of the L1 change the host read over the ranks' L1 norm.
"""
from __future__ import annotations

import contextlib
import gc
import importlib
import math
import random
import time
from unittest import mock

import torch

from loopsbench import counters
from loopsbench.harness import sub_seed
from loopsbench.reference import pagerank as reference

# the window's solves a run keeps for the check: this many, drawn from the
# first SAMPLE_RANGE, and the last
SAMPLE = 3
SAMPLE_RANGE = 64


class State:
    pass


def make_inputs(cell, seed: int, device) -> dict:
    graph = cell.traffic["graph"]
    gen = importlib.import_module(f"loopsbench.gen.{graph['generator']}")
    return gen.make(graph, seed, device)


def solve_bound_s(n: int, nnz: int, iterations: int, dangling: bool) -> float:
    """The least time for one solve's work: per iteration K1 and K12, and
    with dangling nodes the pass adding their mass; the L1 change."""
    it = (counters.bound_s(counters.csr_spmv_work(n, n, nnz))
          + counters.bound_s(counters.saxpy_work(n)))
    if dangling:
        it += counters.bound_s(counters.vector_pass_work(n, 1, 1))
    return iterations * it + counters.bound_s(
        counters.vector_pass_work(n, 2, 0))


def setup(run, cell, seed: int, device) -> State:
    t0 = time.perf_counter()
    from loops_tpu_torch.formats import CSR
    from loops_tpu_torch.ops.kernels.saxpy import saxpy
    from loops_tpu_torch.ops.spmv import SpMVOperator
    run.setup_parts["imports"] = time.perf_counter() - t0

    cfg, traffic = cell.config, cell.traffic
    st = State()
    with run.phase("graph"):
        g = make_inputs(cell, seed, device)
    n, src, dst = g["num_nodes"], g["src"], g["dst"]
    nnz = src.numel()
    d = float(cfg["damping_factor"])
    st.iterations = int(cfg["iterations"])
    with run.phase("matrix"):
        # the reference's input, on the host: nothing the program can
        # touch
        st.edges = (src.cpu().clone(), dst.cpu().clone(), n)
        # the program's input: P by rows (destinations), columns the
        # sources
        out = torch.bincount(src, minlength=n)
        order = torch.argsort(dst * n + src)
        rows, cols = dst[order], src[order]
        vals = (d / out.to(torch.float32))[cols]
        offsets = torch.zeros(n + 1, dtype=torch.int64, device=device)
        offsets[1:] = torch.cumsum(torch.bincount(rows, minlength=n), 0)
        host = [t.cpu().numpy() for t in (offsets.to(torch.int32),
                                          cols.to(torch.int32), vals)]
        del rows, cols, vals, order, offsets, src, dst, g
        st.dangling = torch.nonzero(out == 0)[:, 0]
        del out
    run.unit_work = {
        "sorted_spmv": [counters.csr_spmv_work(n, n, nnz)] * st.iterations,
        "saxpy": [counters.saxpy_work(n)] * st.iterations}
    run.unit_bound_s = solve_bound_s(n, nnz, st.iterations,
                                     st.dangling.numel() > 0)

    t0 = time.perf_counter()
    st.op = SpMVOperator(CSR((n, n), *host), schedule="auto", device=device)
    run.plan_s = run.setup_parts["plan"] = time.perf_counter() - t0
    del host
    st.saxpy, st.device = saxpy, device
    st.n, st.d = n, d
    st.teleport = torch.full((n,), (1.0 - d) / n, device=device)
    st.x0 = torch.full((n,), 1.0 / n, device=device)
    rng = random.Random(sub_seed(seed, "sample"))
    st.sample = set(rng.sample(range(SAMPLE_RANGE), SAMPLE))
    st.solves = -int(traffic["warm_units"])
    st.kept, st.last = [], None
    with run.phase("warm"):
        for _ in range(int(traffic["warm_units"])):
            unit(run, st)
    return st


def unit(run, st) -> bool:
    x = prev = st.x0
    has_dangling = st.dangling.numel() > 0
    for _ in range(st.iterations):
        with run.span("solve.iter"):
            y = st.saxpy(1.0, st.op(x), st.teleport, st.device)
            if has_dangling:
                y.add_(x[st.dangling].sum() * (st.d / st.n))
        prev, x = x, y
    with run.span("host.read"):
        delta = float((x - prev).abs().sum())
    if st.solves in st.sample:
        st.kept.append((x, delta))
    st.last = (x, delta)
    st.solves += 1
    return math.isfinite(delta)


def compare(results, ref_x: torch.Tensor, ref_delta: float) -> dict:
    """The largest relative gap of a rank, and the largest gap of the L1
    change over the reference ranks' L1 norm, over the solves ``results``
    (``[(ranks, L1 change)]``). The change itself can be at round-off
    after 20 iterations, so its gap is not taken relative to it."""
    rank_gap = delta_gap = 0.0
    ref_l1 = float(ref_x.abs().sum())
    for x, delta in results:
        rel = ((x.to(ref_x.device, torch.float64) - ref_x).abs() / ref_x)
        rank_gap = max(rank_gap, float(rel.max()))
        delta_gap = max(delta_gap, abs(delta - ref_delta) / ref_l1)
    if not results:
        return dict(rank_gap=math.inf, delta_gap=math.inf)
    return dict(rank_gap=rank_gap, delta_gap=delta_gap)


def _reference(cell, edges, device, store=None):
    src, dst, n = edges
    return reference.pagerank(src.to(device), dst.to(device), n,
                              float(cell.config["damping_factor"]),
                              int(cell.config["iterations"]), store=store)


def check(run, st) -> dict:
    results = st.kept + ([st.last] if st.last is not None else [])
    st.op = st.saxpy = None
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    ref_x, ref_delta = _reference(run.cell, st.edges, run.device)
    return compare(results, ref_x, ref_delta)


def control(cell, seed: int, device) -> dict:
    """The reference with bfloat16 values and ranks, in the program's
    place."""
    g = make_inputs(cell, seed, device)
    edges = (g["src"], g["dst"], g["num_nodes"])
    low = _reference(cell, edges, device, store=torch.bfloat16)
    return compare([low], *_reference(cell, edges, device))


# ---------------------------------------------------------------- faults
# planted in the program's timed path by loopsbench/calibrate.py (on the
# card) and the tests (on the CPU), to show the check fails on each; a
# solve has no batch to halve, and no cell spans chips


@contextlib.contextmanager
def unchanged_state():
    """An SpMV that returns its state unchanged."""
    from loops_tpu_torch.ops.spmv import SpMVOperator

    with mock.patch.object(SpMVOperator, "__call__",
                           lambda self, x: self.stage(x).clone()):
        yield


@contextlib.contextmanager
def answer_altered():
    """One rank altered where K12 produces it."""
    from loops_tpu_torch.ops.kernels import saxpy as module

    plain = module.saxpy

    def altered(a, x, y, device="cuda"):
        out = plain(a, x, y, device)
        out[:1] *= 1.01
        return out

    with mock.patch.object(module, "saxpy", altered):
        yield


FAULTS = {"unchanged_state": unchanged_state,
          "answer_altered": answer_altered}
