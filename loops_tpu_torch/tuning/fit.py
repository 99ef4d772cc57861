"""Refit ``choose_schedule``'s thresholds from measured sweep logs.

The port of ``scripts/fit_heuristic.py``. It joins the sweep's logs
(``tuning/sweep.py``) with each matrix's structural features (read from
the log directory's ``features.csv``, which the sweep writes; a matrix
missing there is rebuilt from its deterministic recipe and added),
grid-searches the thresholds of ``schedule/plans.choose_schedule`` (skew
ratio, coefficient of variation, small-tile cutoff, and the schedules of
the flat and skew branches), and reports:

  * per-schedule geomean + win counts (the oracle mix), the oracle's
    speedup over the best fixed schedule, and the four-schedule
    (reference-analog) study;
  * the captured fraction of the oracle for ``loops_tpu``'s table (the
    TPU v5e fit, ``HEURISTIC_THRESHOLDS``) and for the fitted one, on
    ``apply_ms`` (what the fit maximizes) and on ``device_ms``, on the
    population fitted and on each held-out one;
  * the speedup of the heuristic and of the oracle over the vendor;
  * the per-family winner table, and ``heuristics.csv`` (the reference's
    plots/data/heuristics.csv analog) in the log directory.

``--op spmm`` fits the GCN aggregation route instead, over one or more
SpMM log directories (K4, ``group_mapped``, ``row_mapped``).

    python scripts/fit_heuristic_torch.py LOG_DIR [--holdout DIR ...]
    python scripts/fit_heuristic_torch.py --op spmm DIR [DIR ...]
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from loops_tpu_torch.tuning.sweep import (
    APPLY_COL,
    DEVICE_COL,
    SCHED_IMPL,
    SCHEDULES,
    SPMM_IMPL,
    VENDOR,
    geomean,
    load_logs,
)

FEATURES = "features.csv"
FEATURE_FIELDS = ("rows", "nnz", "mean", "mx", "cv")
# the threshold grid (extended below the edge values a first fit landed on)
RATIOS = (1.25, 1.5, 2, 4, 8, 16, 32, 64, 1e18)
CVS = (0.125, 0.25, 0.5, 1.0, 2.0, 4.0, 8.0, 1e18)
SMALLS = (0, 2, 4, 8, 16, 32)
FLATS = ("merge_path", "work_oriented", "sorted_flat")
GROUPS = ("group_mapped", "sorted_flat")
# the SpMM route's grid: K4, the degree-class planes or the row segments
SPMM_FLATS = ("merge_path", "group_mapped", "row_mapped")
SPMM_GROUPS = ("group_mapped", "merge_path")
# one SpMM route for every matrix: K4, or the planes
K4_ALWAYS = (1e18, 1e18, 0, "merge_path", "merge_path")
PLANES_ALWAYS = (1e18, 1e18, 0, "group_mapped", "group_mapped")


def features(csr):
    sizes = np.diff(csr.offsets).astype(np.float64)
    mean = max(float(sizes.mean()), 1e-9)
    return dict(mean=mean, mx=float(sizes.max(initial=0)),
                cv=float(sizes.std()) / mean,
                rows=csr.shape[0], nnz=csr.nnz)


def pick(feat, t_ratio, t_cv, t_small, flat="merge_path",
         group="group_mapped"):
    if feat["nnz"] == 0:
        return "row_mapped"
    if feat["mx"] / feat["mean"] > t_ratio or feat["cv"] > t_cv:
        return group
    if feat["mx"] <= t_small:
        return "row_mapped"
    return flat


def append_features(d: str, name: str, csr) -> None:
    """Add ``name``'s features to ``d/features.csv`` unless it is there."""
    if name in read_features(d):
        return
    path = os.path.join(d, FEATURES)
    new = not os.path.exists(path)
    f = features(csr)
    with open(path, "a") as out:
        if new:
            out.write("dataset," + ",".join(FEATURE_FIELDS) + "\n")
        out.write(f"{name}," + ",".join(repr(f[k]) for k in FEATURE_FIELDS)
                  + "\n")


def read_features(d: str) -> dict:
    """dataset -> features, from ``d/features.csv`` (empty if absent)."""
    path = os.path.join(d, FEATURES)
    feats = {}
    if os.path.exists(path):
        with open(path) as f:
            next(f, None)
            for line in f:
                parts = line.strip().split(",")
                if len(parts) == 1 + len(FEATURE_FIELDS):
                    v = [float(p) for p in parts[1:]]
                    feats[parts[0]] = dict(rows=int(v[0]), nnz=int(v[1]),
                                           mean=v[2], mx=v[3], cv=v[4])
    return feats


def rebuild(ds: str):
    """The CSR of a dataset name: a battery recipe, an ``sm_``/``xl_``
    replica (seed 0, the first stat-matched sample), the arxiv stand-in;
    ``KeyError`` for another name."""
    from loops_tpu_torch.tuning.sweep import ARXIV, build_matrix
    from loops_tpu_torch.utils import battery
    from loops_tpu_torch.utils.statmatch import build_replica_by_name

    if ds == ARXIV:
        return build_matrix("gnn", ds)[0]
    try:
        return battery.build(ds)
    except KeyError:
        return build_replica_by_name(ds)


def feature_table(d: str, names) -> dict:
    """Features of ``names`` from ``d/features.csv``, rebuilding (and
    recording) those it lacks; names no recipe builds are left out."""
    feats = read_features(d)
    for ds in names:
        if ds not in feats:
            try:
                append_features(d, ds, rebuild(ds))
            except (KeyError, OSError):
                continue  # not a battery or replica name
            feats = read_features(d)
    return {ds: feats[ds] for ds in names if ds in feats}


def complete_runs(d: str, col: int = APPLY_COL, scheds=SCHEDULES):
    """``(runs, vendor)``: dataset -> schedule -> ms for the datasets
    every schedule of ``scheds`` timed, and dataset -> vendor ms."""
    raw = load_logs(d, col)
    vendor = {ds: r[VENDOR] for ds, r in raw.items() if VENDOR in r}
    runs = {ds: {s: v for s, v in r.items() if s in scheds}
            for ds, r in raw.items()}
    return {ds: r for ds, r in runs.items() if len(r) == len(scheds)}, vendor


def capture(runs, feats, t) -> float:
    """Oracle geomean over the geomean of the picks of thresholds ``t``
    (``(ratio, cv, small, flat, group)``): 1.0 matches the oracle."""
    names = sorted(runs)
    oracle = geomean([min(runs[ds].values()) for ds in names])
    return oracle / geomean([runs[ds][pick(feats[ds], *t)] for ds in names])


def grid_fit(runs, feats, start, flats=FLATS, groups=GROUPS):
    """``(capture, thresholds)``: the grid point of highest capture, the
    first found winning ties, starting from ``start``."""
    best = (capture(runs, feats, start), tuple(start))
    for t_ratio in RATIOS:
        for t_cv in CVS:
            for t_small in SMALLS:
                for flat in flats:
                    for group in groups:
                        t = (t_ratio, t_cv, t_small, flat, group)
                        c = capture(runs, feats, t)
                        if c > best[0]:
                            best = (c, t)
    return best


def as_tuple(table: dict) -> tuple:
    return (table["ratio"], table["cv"], table["small"],
            table.get("flat", "merge_path"), table.get("group",
                                                       "group_mapped"))


def as_table(t, impls=SCHED_IMPL) -> dict:
    """Thresholds ``t`` as a card row of ``schedule/plans.py``: with the
    impl ``impls`` timed each schedule it can choose with."""
    return dict(ratio=float(t[0]), cv=float(t[1]), small=float(t[2]),
                flat=t[3], group=t[4],
                impl={s: impls[s] for s in sorted({t[3], t[4],
                                                   "row_mapped"})})


def describe(t) -> str:
    return (f"ratio>{t[0]:g} | cv>{t[1]:g} -> {t[4]}; mx<={t[2]:g} -> "
            f"row_mapped; else {t[3]}")


def fit_spmv(log_dir: str, col: int = APPLY_COL):
    """``(capture, thresholds)`` of the SpMV grid fit over ``log_dir``,
    started from ``loops_tpu``'s table (``HEURISTIC_THRESHOLDS``)."""
    from loops_tpu_torch.schedule.plans import HEURISTIC_THRESHOLDS

    runs, _ = complete_runs(log_dir, col)
    feats = feature_table(log_dir, sorted(runs))
    runs = {ds: r for ds, r in runs.items() if ds in feats}
    return grid_fit(runs, feats, as_tuple(HEURISTIC_THRESHOLDS))


def _captures(d: str, tables: dict, out) -> None:
    """Capture of each table on ``d``, by apply_ms and by device_ms."""
    for col, label in ((APPLY_COL, "apply_ms"), (DEVICE_COL, "device_ms")):
        runs, _ = complete_runs(d, col)
        feats = feature_table(d, sorted(runs))
        runs = {ds: r for ds, r in runs.items() if ds in feats}
        if not runs:
            out(f"  {d} ({label}): no complete runs")
            continue
        cells = ", ".join(f"{name} {capture(runs, feats, t):.1%}"
                          for name, t in tables.items())
        out(f"  {d} ({label}, {len(runs)} matrices): {cells}")


def main_spmv(log_dir: str, holdouts=(), out=print) -> int:
    from loops_tpu_torch.schedule.plans import HEURISTIC_THRESHOLDS

    runs, vendor = complete_runs(log_dir)
    if not runs:
        out(f"no complete runs under {log_dir}")
        return 1
    feats = feature_table(log_dir, sorted(runs))
    runs = {ds: r for ds, r in runs.items() if ds in feats}
    names = sorted(runs)
    out(f"{len(names)} matrices with complete schedule coverage\n")

    # per-schedule geomeans + oracle mix
    wins = {s: 0 for s in SCHEDULES}
    for r in runs.values():
        wins[min(r, key=r.get)] += 1
    out(f"{'schedule':16s}{'geomean ms':>12s}{'oracle wins':>13s}")
    gms = {}
    for s in SCHEDULES:
        gms[s] = geomean([runs[ds][s] for ds in names])
        out(f"{s:16s}{gms[s]:12.4f}{wins[s]:13d}")
    fixed = min(gms, key=gms.get)
    oracle = geomean([min(runs[ds].values()) for ds in names])
    out(f"\nbest fixed schedule: {fixed} ({gms[fixed]:.4f} ms geomean)")
    out(f"oracle geomean:      {oracle:.4f} ms "
        f"({gms[fixed]/oracle:.2f}x over fixed {fixed})")

    # the reference-analog four-schedule study: sorted_flat has no
    # reference analog, so the selection value among the four ports too
    ref4 = tuple(s for s in SCHEDULES if s != "sorted_flat")
    gms4 = {s: geomean([runs[ds][s] for ds in names]) for s in ref4}
    fixed4 = min(gms4, key=gms4.get)
    oracle4 = geomean([min(runs[ds][s] for s in ref4) for ds in names])
    wins4 = {s: 0 for s in ref4}
    for r in runs.values():
        wins4[min(ref4, key=lambda s: r[s])] += 1
    mix4 = "/".join(f"{s}:{wins4[s]}" for s in ref4)
    out(f"\nfour-schedule (reference-analog) study: best fixed "
        f"{fixed4} {gms4[fixed4]:.4f} ms; oracle {oracle4:.4f} ms "
        f"({gms4[fixed4]/oracle4:.2f}x over fixed); mix {mix4}")
    out(f"sorted_flat vs four-schedule oracle: "
        f"{oracle4/gms['sorted_flat']:.2f}x geomean")

    cur_t = as_tuple(HEURISTIC_THRESHOLDS)
    out(f"\ncurrent thresholds ({describe(cur_t)}): capture "
        f"{capture(runs, feats, cur_t):.1%} of oracle")
    c, best = grid_fit(runs, feats, cur_t)
    tr, tc, ts, tf, tg = best
    out(f"fitted thresholds: {describe(best)}")
    out(f"fitted capture: {c:.1%} of oracle "
        f"({oracle / (oracle / c):.4f} relative geomean)")

    vds = [ds for ds in names if ds in vendor]
    if vds:
        h_ms = {ds: runs[ds][pick(feats[ds], *best)] for ds in vds}
        o_ms = {ds: min(runs[ds].values()) for ds in vds}
        su_h = [vendor[ds] / h_ms[ds] for ds in vds]
        su_o = [vendor[ds] / o_ms[ds] for ds in vds]
        frac = sum(s > 1 for s in su_h) / len(vds)
        out(f"\nvendor baseline (cuSPARSE csrmv), {len(vds)} matrices:")
        out(f"  vendor geomean:            "
            f"{geomean([vendor[ds] for ds in vds]):.4f} ms")
        out(f"  heuristic speedup vs vendor: geomean "
            f"{geomean(su_h):.2f}x, median {np.median(su_h):.2f}x, "
            f">1x on {frac:.1%}")
        out(f"  oracle speedup vs vendor:    geomean "
            f"{geomean(su_o):.2f}x")

    art = os.path.join(log_dir, "heuristics.csv")
    with open(art, "w") as f:
        f.write("dataset,rows,nnz," + ",".join(SCHEDULES)
                + ",oracle_kernel,heuristic_kernel,speedup_vs_fixed,"
                "vendor_ms,speedup_vs_vendor\n")
        for ds in names:
            r, ft = runs[ds], feats[ds]
            okern = min(r, key=r.get)
            hkern = pick(ft, tr, tc, ts, tf, tg)
            v = vendor.get(ds)
            vcols = (f"{v:.5f},{v / r[hkern]:.4f}" if v is not None
                     else ",")
            f.write(f"{ds},{ft['rows']},{ft['nnz']},"
                    + ",".join(f"{r[s]:.5f}" for s in SCHEDULES)
                    + f",{okern},{hkern},{r[fixed]/r[hkern]:.4f},"
                    + vcols + "\n")
    out(f"\nwrote per-matrix artifact: {art}")

    out("\ncapture of the v5e table and of the fitted one:")
    tables = {"v5e": cur_t, "fitted": best}
    for d in (log_dir, *holdouts):
        _captures(d, tables, out)
    out(f"\ncard row: {as_table(best)!r}")

    fams = {}
    for ds in names:
        fams.setdefault(ds.split("_")[0], []).append(ds)
    out(f"\n{'family':10s}{'n':>4s}  winner mix")
    for fam in sorted(fams):
        w = {}
        for ds in fams[fam]:
            s = min(runs[ds], key=runs[ds].get)
            w[s] = w.get(s, 0) + 1
        mix = ", ".join(f"{s}:{k}" for s, k in
                        sorted(w.items(), key=lambda kv: -kv[1]))
        out(f"{fam:10s}{len(fams[fam]):4d}  {mix}")
    return 0


def spmm_cases(dirs, col: int = APPLY_COL):
    """``(runs, feats)`` keyed ``(dir, dataset)`` over SpMM log dirs."""
    scheds = tuple(SPMM_IMPL)
    runs, feats = {}, {}
    for d in dirs:
        r, _ = complete_runs(d, col, scheds)
        f = feature_table(d, sorted(r))
        for ds in r:
            if ds in f:
                runs[d, ds] = r[ds]
                feats[d, ds] = f[ds]
    return runs, feats


def fit_spmm(dirs, col: int = APPLY_COL):
    """``(capture, thresholds)`` of the SpMM route fit over ``dirs``,
    started from "K4 for every matrix"."""
    runs, feats = spmm_cases(dirs, col)
    return grid_fit(runs, feats, K4_ALWAYS, SPMM_FLATS, SPMM_GROUPS)


def main_spmm(dirs, out=print) -> int:
    runs, feats = spmm_cases(dirs)
    if not runs:
        out(f"no complete SpMM runs under {', '.join(dirs)}")
        return 1
    out(f"{len(runs)} (directory, matrix) cases with K4, group_mapped and "
        "row_mapped timed\n")
    for d in dirs:
        sub = {k: v for k, v in runs.items() if k[0] == d}
        if not sub:
            continue
        wins = {}
        for r in sub.values():
            s = min(r, key=r.get)
            wins[s] = wins.get(s, 0) + 1
        gms = ", ".join(f"{s} {geomean([r[s] for r in sub.values()]):.4f}"
                        for s in SPMM_IMPL)
        out(f"{d}: {len(sub)} matrices; geomean ms {gms}; oracle wins "
            f"{wins}")
    c, best = fit_spmm(dirs)
    out(f"\nfitted route: {describe(best)}")
    out(f"fitted capture: {c:.1%} of oracle")
    tables = {"K4 always": K4_ALWAYS, "group_mapped always": PLANES_ALWAYS,
              "fitted": best}
    for col, label in ((APPLY_COL, "apply_ms"), (DEVICE_COL, "device_ms")):
        r, f = spmm_cases(dirs, col)
        for d in dirs:
            sub = {k: v for k, v in r.items() if k[0] == d}
            if sub:
                cells = ", ".join(f"{n} {capture(sub, f, t):.1%}"
                                  for n, t in tables.items())
                out(f"  {d} ({label}, {len(sub)}): {cells}")
    out(f"\ncard route: {as_table(best, SPMM_IMPL)!r}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("log_dirs", nargs="*", default=["sweep_logs"])
    ap.add_argument("--holdout", nargs="*", default=[],
                    help="log directories to report the capture on, not "
                         "fitted on")
    ap.add_argument("--op", choices=("spmv", "spmm"), default="spmv")
    args = ap.parse_args(argv)
    if args.op == "spmm":
        return main_spmm(args.log_dirs)
    return main_spmv(args.log_dirs[0], args.holdout)
