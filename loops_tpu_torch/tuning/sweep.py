"""Schedule sweep over a matrix population: the heuristic study's driver.

The port of ``scripts/sweep_battery.py``, ``scripts/sweep_vendor.py`` and
``scripts/summarize_sweep.py``: one process builds each matrix of a
population, runs every column (a schedule with the implementation
``schedule="auto"`` runs for it, or the vendor's SpMV) on it, checks the
result and times it, and appends one row per (matrix, column) to
``<out>/<column>.csv``:

    column,dataset,rows,cols,nnz,apply_ms,plan_ms,device_ms

- ``apply_ms`` (the reference's ``elapsed`` column): the median ms of
  ``op(x)`` back to back, host and card together, which is what a caller
  pays (``utils/bench.apply_ms``);
- ``plan_ms``: host milliseconds building the operator (planning and
  staging), paid once;
- ``device_ms``: the card's own ms per apply (``utils/bench.device_ms``).
  Small matrices are host-bound on the card (a K1 ``op(x)`` costs ~36 µs
  of launch path), so it differs from ``apply_ms``. It is empty on the
  CPU, where no device time exists, and where ``device_ms`` refused
  every hold (``HoldExpired``).

Every result is checked before it is timed: SpMV against the Wilkinson
bound (``utils/reference.rigorously_validate_spmv``), SpMM on 256 sampled
rows (``utils/reference.validate_sampled_rows``). A kernel's refusal of
a matrix (``ValueError``: the card never falls back) or a card that
cannot hold its planes is logged as ``REFUSED,<name>,<reason>``; a wrong
result as ``WRONG,<name>,<detail>``, and the run then exits non-zero.
Other errors stop the run. The logs are the resume state: a rerun skips
each (matrix, column) pair that has a row.

The columns (``SCHED_IMPL``) are ``loops_tpu``'s: ``row_mapped`` and
``group_mapped`` run torch ops, ``work_oriented`` and ``merge_path`` kernel
K2 (``pallas2``) and ``sorted_flat`` K1; ``vendor`` is cuSPARSE's csrmv
through ``torch.sparse_csr_tensor``. With ``op="spmm"`` the columns are
``SPMM_IMPL``: K4 (``merge_path``/``pallas``), ``group_mapped`` and
``row_mapped``, at ``feat`` columns of B in f32 or bf16, over the
adjacency as it is or mean-normalized; the population ``gnn`` holds the
battery's GNN-shaped families (``pl_``, ``rmat_``, ``lgn_``) and the
ogbn-arxiv stand-in.

    python scripts/sweep_battery_torch.py OUT [--population P] [--op spmm]
        [--names A,B] [--columns group_mapped]
"""
from __future__ import annotations

import argparse
import math
import os
import time
import warnings
from collections import defaultdict

import numpy as np

SCHED_IMPL = {
    "row_mapped": "xla",
    "group_mapped": "xla",
    "work_oriented": "pallas2",
    "merge_path": "pallas2",
    "sorted_flat": "pallas3",
}
SCHEDULES = tuple(SCHED_IMPL)
VENDOR = "vendor"
SPMM_IMPL = {"merge_path": "pallas", "group_mapped": "xla",
             "row_mapped": "xla"}
POPULATIONS = ("synthetic", "statmatched", "statmatched_rep", "xl", "gnn")
GNN_FAMILIES = ("pl", "rmat", "lgn")
ARXIV = "arxiv"
# the path each impl takes, as SpMVOperator/SpMMOperator name it
IMPL_USED = {"xla": "torch", "pallas2": "flat_spmv_v2",
             "pallas3": "sorted_spmv"}
SPMM_IMPL_USED = {"xla": "torch", "pallas": "flat_spmm"}
# one bf16 rounding of each product: group_mapped's hub-dense rows form
# their products in f32, the other bf16 routes round each one
BF16_SLACK = 2.0 ** -8 * (1 + 2.0 ** -8)


def interleave(names) -> list:
    """Round-robin over the name prefixes (structure families), so a
    budget-limited partial sweep spans every regime."""
    fams = {}
    for n in sorted(names):
        fams.setdefault(n.split("_")[0], []).append(n)
    out = []
    for i in range(max((len(v) for v in fams.values()), default=0)):
        for f in sorted(fams):
            if i < len(fams[f]):
                out.append(fams[f][i])
    return out


def mean_normalized(csr):
    """``csr`` with each row's values ``1 / deg``: the mean aggregation's
    adjacency over the same structure."""
    from loops_tpu_torch.formats import CSR

    deg = np.diff(csr.offsets).astype(np.float64)
    vals = np.repeat(1.0 / np.maximum(deg, 1.0), deg.astype(np.int64))
    return CSR(csr.shape, csr.offsets, csr.indices, vals.astype(np.float32))


def _arxiv(norm: str):
    from loops_tpu_torch.io import ogb

    graph = ogb.load("ogbn-arxiv").graph
    return (graph.mean_normalized() if norm == "mean"
            else graph.gcn_normalized()).adj


def population(name: str, max_rows: int = 65536):
    """``(build functions, ordered names, info)`` of a population."""
    from loops_tpu_torch.utils import battery, statmatch

    if name in ("synthetic", "gnn"):
        mats = battery.battery(max_rows)
        if name == "gnn":
            mats = {k: v for k, v in mats.items()
                    if k.split("_")[0] in GNN_FAMILIES}
            return mats, [ARXIV] + interleave(mats), None
        return mats, interleave(mats), None
    if name == "xl":
        mats, info = statmatch.xl_battery()
    else:
        mats, info = statmatch.statmatched_battery(
            statmatch.LOG_DIR if name == "statmatched"
            else statmatch.REP_LOG_DIR)
    return mats, sorted(mats), info


def build_matrix(pop: str, name: str, max_rows: int = 65536,
                 norm: str = "none"):
    """``(csr, host seconds)`` of one matrix of population ``pop``; the
    arxiv stand-in is GCN-normalized, or mean-normalized with ``norm``
    ``"mean"`` as every other matrix then is."""
    t0 = time.perf_counter()
    if name == ARXIV:
        csr = _arxiv(norm)
    else:
        csr = population(pop, max_rows)[0][name]()
        if norm == "mean":
            csr = mean_normalized(csr)
    return csr, time.perf_counter() - t0


def _matrices(pop, names, max_rows, norm, workers: int):
    """``(name, csr, host seconds)`` in order. With ``workers`` > 0 the
    next matrices are built ahead in that many spawned processes while
    the card runs the current one (a stat-matched banded replica takes
    tens of seconds of one host core)."""
    if workers <= 0:
        for n in names:
            yield (n, *build_matrix(pop, n, max_rows, norm))
        return
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    with ProcessPoolExecutor(workers, multiprocessing.get_context(
            "spawn")) as pool:
        ahead = [pool.submit(build_matrix, pop, n, max_rows, norm)
                 for n in names[:workers]]
        try:
            for i, n in enumerate(names):
                if i + workers < len(names):
                    ahead.append(pool.submit(build_matrix, pop,
                                             names[i + workers], max_rows,
                                             norm))
                yield (n, *ahead[i].result())
                ahead[i] = None
        finally:
            for f in ahead:
                if f is not None:
                    f.cancel()


def done_pairs(out: str, columns) -> set:
    """``(dataset, column)`` pairs that already have a row: timed,
    ``REFUSED`` or ``WRONG``."""
    done = set()
    for c in columns:
        p = os.path.join(out, f"{c}.csv")
        if os.path.exists(p):
            with open(p) as f:
                for line in f:
                    parts = line.strip().split(",")
                    if len(parts) >= 2:
                        done.add((parts[1], c))
    return done


def wrong_rows(out: str) -> list:
    """Every ``WRONG`` row in the logs of ``out``."""
    rows = []
    for fname in sorted(os.listdir(out)):
        if fname.endswith(".csv"):
            with open(os.path.join(out, fname)) as f:
                rows += [f"{fname}: {ln.strip()}" for ln in f
                         if ln.startswith("WRONG,")]
    return rows


def _clean(text: str) -> str:
    return " ".join(str(text).replace(",", ";").split())[:300]


def _spmv_op(csr, column, device):
    import torch

    from loops_tpu_torch.ops.spmv import SpMVOperator

    if column == VENDOR:
        with warnings.catch_warnings():  # sparse CSR's "beta" notices
            warnings.simplefilter("ignore", UserWarning)
            A = torch.sparse_csr_tensor(
                torch.from_numpy(csr.offsets).to(device),
                torch.from_numpy(csr.indices).to(device),
                torch.from_numpy(csr.vals).to(device), size=csr.shape)
        return lambda v: torch.mv(A, v), "cusparse"
    op = SpMVOperator(csr, column, impl=SCHED_IMPL[column], device=device)
    return op, op.impl_used


def _spmm_op(csr, column, device, dtype):
    from loops_tpu_torch.ops.spmm import SpMMOperator

    op = SpMMOperator(csr, column, impl=SPMM_IMPL[column], dtype=dtype,
                      device=device)
    return op, op.impl_used


def _refusals():
    import torch

    return (ValueError, MemoryError, torch.cuda.OutOfMemoryError)


def sweep(pop: str, names, out: str, columns=SCHEDULES + (VENDOR,),
          device="cuda", budget_s: float = 0.0, op: str = "spmv",
          feat: int = 128, dtype=None, norm: str = "none",
          max_rows: int = 65536, workers: int = 0, log=print) -> int:
    """Run every missing (matrix, column) pair of ``names`` (of population
    ``pop``); append each row to ``<out>/<column>.csv`` and each matrix's
    structural features to ``<out>/features.csv``. Returns the number of
    ``WRONG`` rows this run wrote."""
    import torch

    from loops_tpu_torch.tuning.fit import append_features
    from loops_tpu_torch.utils import reference
    from loops_tpu_torch.utils.bench import HoldExpired, apply_ms, device_ms
    from loops_tpu_torch.utils.generate import make_input_vector
    from loops_tpu_torch.utils.platform import ensure_platform

    device = ensure_platform(device)
    cuda = device.type == "cuda"
    os.makedirs(out, exist_ok=True)
    done = done_pairs(out, columns)
    todo_names = [n for n in names
                  if any((n, c) not in done for c in columns)]
    logs = {c: open(os.path.join(out, f"{c}.csv"), "a") for c in columns}
    wrong = 0
    t_start = time.time()
    try:
        for i, (name, csr, build_s) in enumerate(_matrices(
                pop, todo_names, max_rows, norm, workers)):
            if budget_s and time.time() - t_start > budget_s:
                log(f"budget reached after {i} matrices")
                break
            t0 = time.time()
            todo = [c for c in columns if (name, c) not in done]
            append_features(out, name, csr)
            rows, cols = csr.shape
            dims = f"{rows},{cols},{csr.nnz}"
            if op == "spmv":
                x = torch.from_numpy(make_input_vector(cols)).to(device)
                judge = reference.spmv_judge(csr, x.cpu().numpy())
            else:
                B = np.random.default_rng(5).standard_normal(
                    (cols, feat)).astype(np.float32)
                x = torch.from_numpy(B).to(device)
                judge = reference.sampled_rows_judge(
                    csr, B, bf16_products=dtype is not None)
            for c in todo:
                tag = f"[{i + 1}/{len(todo_names)}] {name} {c}"
                t1 = time.perf_counter()
                try:
                    fn, used = (_spmv_op(csr, c, device) if op == "spmv"
                                else _spmm_op(csr, c, device, dtype))
                    plan_ms = (time.perf_counter() - t1) * 1e3
                    y = fn(x)
                    if cuda:
                        torch.cuda.synchronize(device)
                except _refusals() as e:
                    logs[c].write(f"REFUSED,{name},"
                                  f"{_clean(f'{type(e).__name__}: {e}')}\n")
                    logs[c].flush()
                    log(f"{tag}: REFUSED {type(e).__name__}: {e}")
                    continue
                want = (rows,) if op == "spmv" else (rows, feat)
                detail = None
                if tuple(y.shape) != want or not bool(y.isfinite().all()):
                    detail = f"shape {tuple(y.shape)} or non-finite values"
                elif op == "spmv":
                    rep = judge(y.cpu().numpy())
                    if rep.verdict != "NOT_A_BUG":
                        detail = (f"{rep.kernel_overruns} rows past the "
                                  f"Wilkinson bound; max abs error "
                                  f"{rep.max_abs_error:.3e}")
                else:
                    slack = (BF16_SLACK if dtype is not None
                             and c == "group_mapped" else 0.0)
                    rep = judge(y, slack)
                    if rep.overruns:
                        detail = (f"{rep.overruns} entries of {rep.rows} "
                                  f"sampled rows past the Wilkinson bound")
                if detail is not None:
                    wrong += 1
                    logs[c].write(f"WRONG,{name},{_clean(detail)}\n")
                    logs[c].flush()
                    log(f"{tag}: WRONG {detail}")
                    continue
                ms = apply_ms(fn, x)
                dev = ""
                if cuda:
                    try:
                        dev = f"{device_ms(fn, x):.5f}"
                    except HoldExpired as e:  # not measured: left empty
                        log(f"{tag}: card time not measured ({e})")
                logs[c].write(f"{c},{name},{dims},{ms:.5f},{plan_ms:.2f},"
                              f"{dev}\n")
                logs[c].flush()
                log(f"{tag} ({used}): {ms:.4f} ms apply, {dev or '-'} ms "
                    f"card, plan {plan_ms:.1f} ms")
                del fn, y
            del x, judge
            if cuda:
                torch.cuda.empty_cache()
            log(f"  {name}: {dims} built in {build_s:.1f} s, swept in "
                f"{time.time() - t0:.1f} s")
    finally:
        for f in logs.values():
            f.close()
    log(f"sweep done in {time.time() - t_start:.0f} s -> {out}")
    return wrong


def write_info(out: str, info) -> None:
    import json

    if info is not None:
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, "statmatch_info.json"), "w") as f:
            json.dump(info, f, indent=1)


def parser(columns_help: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=columns_help)
    ap.add_argument("out", nargs="?", default="sweep_logs")
    ap.add_argument("--population", choices=POPULATIONS, default=None,
                    help="synthetic (default for SpMV): utils/battery; "
                         "statmatched / statmatched_rep: the replicas of "
                         "loops_tpu's two stat-matched samples (seeds 0 "
                         "and 1); xl: the over-cap tier; gnn (default for "
                         "SpMM): the battery's pl_, rmat_, lgn_ and the "
                         "ogbn-arxiv stand-in")
    ap.add_argument("--max-rows", type=int, default=65536)
    ap.add_argument("--limit", type=int, default=0,
                    help="only the first K matrices (smoke mode)")
    ap.add_argument("--budget-s", type=float, default=0,
                    help="start no matrix after this many seconds")
    ap.add_argument("--device", default="cuda",
                    help="cuda, or cpu for the plain versions")
    ap.add_argument("--workers", type=int, default=0,
                    help="host processes building the next matrices ahead "
                         "(0: build each in turn)")
    ap.add_argument("--names", default="",
                    help="comma-separated matrices of the population to run "
                         "(default: all)")
    ap.add_argument("--columns", default="",
                    help="comma-separated columns to run (default: all)")
    return ap


def run(args, op: str, columns, dtype=None, feat: int = 128,
        norm: str = "none") -> int:
    pop = args.population or ("gnn" if op == "spmm" else "synthetic")
    _, names, info = population(pop, args.max_rows)
    if args.names:
        wanted = args.names.split(",")
        unknown = sorted(set(wanted) - set(names))
        if unknown:
            raise SystemExit(f"not in {pop}: {', '.join(unknown)}")
        names = [n for n in names if n in wanted]
    if args.columns:
        wanted = args.columns.split(",")
        unknown = sorted(set(wanted) - set(columns))
        if unknown:
            raise SystemExit(f"columns not swept here: {', '.join(unknown)}")
        columns = tuple(c for c in columns if c in wanted)
    if args.limit:
        names = names[: args.limit]
    write_info(args.out, info)
    print(f"{pop}: {len(names)} matrices, columns {', '.join(columns)}, "
          f"device {args.device}", flush=True)
    sweep(pop, names, args.out, columns, args.device, args.budget_s, op,
          feat, dtype, norm, args.max_rows, args.workers,
          log=lambda s: print(s, flush=True))
    bad = wrong_rows(args.out)
    for row in bad:
        print(f"WRONG row: {row}", flush=True)
    return 1 if bad else 0


def main(argv=None) -> int:
    """The schedule sweep: the five schedules and the vendor (SpMV), or
    K4 and the two torch routes (``--op spmm``)."""
    ap = parser(main.__doc__)
    ap.add_argument("--op", choices=("spmv", "spmm"), default="spmv")
    ap.add_argument("--feat", type=int, default=128,
                    help="columns of B (--op spmm)")
    ap.add_argument("--dtype", choices=("f32", "bf16"), default="f32",
                    help="SpMM mode (--op spmm)")
    ap.add_argument("--norm", choices=("none", "mean"), default="none",
                    help="mean: each row's values 1/deg (--op spmm)")
    args = ap.parse_args(argv)
    if args.op == "spmm":
        return run(args, "spmm", tuple(SPMM_IMPL),
                   None if args.dtype == "f32" else "bfloat16", args.feat,
                   args.norm)
    return run(args, "spmv", SCHEDULES + (VENDOR,))


def vendor_main(argv=None) -> int:
    """The vendor column alone: cuSPARSE's csrmv
    (``torch.sparse_csr_tensor @ x``) over a population, checked and timed
    as the schedules are."""
    return run(parser(vendor_main.__doc__).parse_args(argv), "spmv",
               (VENDOR,))


# ---------------------------------------------------------------- logs
APPLY_COL, DEVICE_COL = 5, 7


def load_logs(d: str, col: int = APPLY_COL):
    """dataset -> column -> ms, from every ``*.csv`` under ``d`` (column
    ``col`` of each row: 5, ``apply_ms``, the reference's ``elapsed``; 7,
    ``device_ms``). Rows whose first field is not the file's column
    (``REFUSED``/``WRONG``/``TIMEOUT`` markers, other artifacts) and
    non-positive or missing times are skipped."""
    runs = defaultdict(dict)
    for fname in sorted(os.listdir(d)):
        if not fname.endswith(".csv"):
            continue
        sched = fname[:-4]
        with open(os.path.join(d, fname)) as f:
            for line in f:
                parts = line.strip().split(",")
                # col 0 echoes the schedule in every sweep log row, bare
                # or format-prefixed ("{format}_{schedule}")
                if len(parts) <= col or not (
                        parts[0] == sched or parts[0].endswith("_" + sched)):
                    continue
                try:
                    ms = float(parts[col])
                except ValueError:  # an empty device column (CPU rows)
                    continue
                if ms <= 0:
                    continue
                runs[parts[1]][sched] = ms
    return runs


def geomean(v) -> float:
    v = np.asarray(v, np.float64)
    return float(np.exp(np.mean(np.log(np.maximum(v, 1e-12)))))


def summarize(d: str, col: int = APPLY_COL, schedules=SCHEDULES,
              out=print) -> int:
    """Per-schedule geomean and wins, the oracle mix, and the vendor
    speedup of the logs under ``d``."""
    raw = load_logs(d, col)
    vendor = {ds: r[VENDOR] for ds, r in raw.items() if VENDOR in r}
    runs = {ds: {s: v for s, v in r.items() if s in schedules}
            for ds, r in raw.items()}
    runs = {ds: r for ds, r in runs.items() if r}
    if not runs:
        out(f"no sweep logs under {d}")
        return 1
    scheds = sorted({s for r in runs.values() for s in r})
    out(f"{len(runs)} datasets x {len(scheds)} schedules "
        f"({'apply_ms' if col == APPLY_COL else 'device_ms'})\n")
    out(f"{'schedule':16s} {'geomean ms':>12s} {'wins':>6s}")
    wins = defaultdict(int)
    for r in runs.values():
        wins[min(r, key=r.get)] += 1
    for s in scheds:
        vals = [r[s] for r in runs.values() if s in r]
        out(f"{s:16s} {geomean(vals) if vals else math.nan:12.4f} "
            f"{wins[s]:6d}")
    oracle = [min(r.values()) for r in runs.values()]
    out(f"\noracle geomean: {geomean(oracle):.4f} ms")
    both = [ds for ds in vendor if ds in runs]
    if both:
        sp = [vendor[ds] / min(runs[ds].values()) for ds in both]
        out(f"vendor baseline: {len(vendor)} matrices; best-of-schedules "
            f"vs vendor geomean {geomean(sp):.2f}x on {len(both)} joined")
    return 0


def summarize_main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Summarize sweep logs: geomeans, wins, the oracle.")
    ap.add_argument("log_dir", nargs="?", default="sweep_logs")
    ap.add_argument("--device-ms", action="store_true",
                    help="read device_ms (column 8) instead of apply_ms")
    ap.add_argument("--op", choices=("spmv", "spmm"), default="spmv")
    args = ap.parse_args(argv)
    return summarize(args.log_dir, DEVICE_COL if args.device_ms
                     else APPLY_COL,
                     SCHEDULES if args.op == "spmv" else tuple(SPMM_IMPL))
