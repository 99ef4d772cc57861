"""The sweep, its logs and the fitter.

``tuning/sweep.py`` on the CPU (the plain versions): its rows parse, a
rerun resumes from the logs, a planted wrong result logs ``WRONG`` and
exits non-zero, a refusal logs ``REFUSED``; ``load_logs`` equals
``scripts/summarize_sweep.py``'s on the TPU's logs. ``tuning/fit.py``
against ``scripts/fit_heuristic.py`` on the same logs (the 40 smallest
stat-matched matrices): equal thresholds, captures and ``heuristics.csv``
rows. The committed H100 logs reproduce the card's rows in
``schedule/plans.py``, and ``thresholds_for``/``spmm_route_for`` give
them for a card of that name only."""
import functools
import os
import re
import shutil
import sys

import numpy as np
import pytest
import torch

import loops_tpu.utils.statmatch as js
from loops_tpu_torch.schedule import plans
from loops_tpu_torch.tuning import fit, sweep
from loops_tpu_torch.utils import statmatch as ts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import fit_heuristic as jfit  # noqa: E402
import summarize_sweep as jsum  # noqa: E402

CPU = torch.device("cpu")
H100_LOGS = os.path.join(REPO, "plots", "data", "h100")
H100 = "NVIDIA H100 80GB HBM3"


def _cpu_sweep(out, *extra):
    return sweep.main([str(out), "--device", "cpu", *extra])


def _rows(path):
    with open(path) as f:
        return [ln.rstrip("\n").split(",") for ln in f]


def test_sweep_rows_parse_and_resume(tmp_path, capsys):
    out = tmp_path / "logs"
    assert _cpu_sweep(out, "--limit", "3") == 0
    names = sweep.population("synthetic")[1][:3]
    for c in sweep.SCHEDULES + (sweep.VENDOR,):
        rows = _rows(out / f"{c}.csv")
        assert [r[1] for r in rows] == names
        for r in rows:
            assert len(r) == 8 and r[0] == c
            int(r[2]), int(r[3]), int(r[4])
            assert float(r[5]) > 0 and float(r[6]) >= 0
            assert r[7] == ""  # no device time on the CPU
    feats = fit.read_features(str(out))
    assert sorted(feats) == sorted(names)
    assert sweep.summarize_main([str(out)]) == 0
    sizes = {p.name: p.stat().st_size for p in out.iterdir()}
    capsys.readouterr()
    assert _cpu_sweep(out, "--limit", "3") == 0
    assert {p.name: p.stat().st_size for p in out.iterdir()} == sizes
    assert " ms apply" not in capsys.readouterr().out


def test_sweep_logs_wrong_and_refused(tmp_path, monkeypatch):
    real = sweep._spmv_op

    def planted(csr, column, device):
        fn, used = real(csr, column, device)
        if column == "merge_path":
            return (lambda v: fn(v) + 1.0), used
        if column == "sorted_flat":
            raise ValueError("K1 refuses this matrix")
        return fn, used
    monkeypatch.setattr(sweep, "_spmv_op", planted)
    out = tmp_path / "logs"
    assert _cpu_sweep(out, "--limit", "1") == 1
    name = sweep.population("synthetic")[1][0]
    (wrong,) = _rows(out / "merge_path.csv")
    assert wrong[:2] == ["WRONG", name] and "Wilkinson" in wrong[2]
    (refused,) = _rows(out / "sorted_flat.csv")
    assert refused[:2] == ["REFUSED", name] and "K1 refuses" in refused[2]
    assert _rows(out / "work_oriented.csv")[0][0] == "work_oriented"
    assert sweep.wrong_rows(str(out)) == [
        f"merge_path.csv: {','.join(wrong)}"]
    # a resumed run skips the logged pairs and still exits non-zero
    monkeypatch.setattr(sweep, "_spmv_op", real)
    assert _cpu_sweep(out, "--limit", "1") == 1
    assert len(_rows(out / "merge_path.csv")) == 1


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
@pytest.mark.parametrize("norm", ["none", "mean"])
def test_spmm_sweep(tmp_path, dtype, norm):
    names = ["pl_n4096_d4_a1.6", "lgn_n8192_d8_s2.0"]
    wrong = sweep.sweep("gnn", names, str(tmp_path), tuple(sweep.SPMM_IMPL),
                        CPU, op="spmm", feat=8, dtype=dtype, norm=norm,
                        log=lambda s: None)
    assert wrong == 0
    for c in sweep.SPMM_IMPL:
        assert [r[1] for r in _rows(tmp_path / f"{c}.csv")] == names
    if norm == "mean":
        vals = sweep.mean_normalized(sweep.build_matrix("gnn", names[0])[0])
        sums = np.bincount(vals.row_ids(), vals.vals, vals.shape[0])
        np.testing.assert_allclose(sums[np.diff(vals.offsets) > 0], 1.0,
                                   rtol=1e-5)


def test_vendor_sweep_alone(tmp_path):
    assert sweep.vendor_main([str(tmp_path), "--device", "cpu",
                              "--limit", "2"]) == 0
    assert sorted(p.name for p in tmp_path.glob("*.csv")) == [
        "features.csv", "vendor.csv"]


def test_sweep_names_and_columns(tmp_path):
    """``--names`` and ``--columns`` re-time chosen rows alone (the nine
    rows re-timed after ``device_ms``'s repair); unknown ones exit."""
    names = ["pl_n4096_d4_a1.2", "pl_n8192_d4_a1.2"]
    assert _cpu_sweep(tmp_path, "--op", "spmm", "--population", "gnn",
                      "--feat", "8", "--names", ",".join(names),
                      "--columns", "group_mapped") == 0
    assert sorted(p.name for p in tmp_path.glob("*.csv")) == [
        "features.csv", "group_mapped.csv"]
    assert [r[1] for r in _rows(tmp_path / "group_mapped.csv")] == names
    with pytest.raises(SystemExit, match="not in gnn: no_such"):
        _cpu_sweep(tmp_path, "--op", "spmm", "--names", "no_such")
    with pytest.raises(SystemExit, match="not swept here: sorted_flat"):
        _cpu_sweep(tmp_path, "--op", "spmm", "--columns", "sorted_flat")


@pytest.mark.parametrize("d", [ts.LOG_DIR, ts.REP_LOG_DIR])
def test_load_logs_equals_summarize_sweep(d):
    assert sweep.load_logs(d) == jsum.load_logs(d)


def _smallest_logs(tmp_path, k=40):
    """The TPU's stat-matched logs cut to the ``k`` smallest matrices, in
    two copies (one for each fitter), and a reference CSV of their
    dimensions for ``loops_tpu.utils.statmatch``."""
    pop = sorted(ts.load_population(ts.LOG_DIR), key=lambda m: m.nnz)[:k]
    keep = {f"sm_{m.name}" for m in pop}
    dirs = []
    for sub in ("jax", "torch"):
        d = tmp_path / sub
        d.mkdir()
        for f in os.listdir(ts.LOG_DIR):
            if f.endswith(".csv") and f != "heuristics.csv":
                with open(os.path.join(ts.LOG_DIR, f)) as src, \
                        open(d / f, "w") as dst:
                    dst.writelines(ln for ln in src
                                   if ln.split(",")[1].strip() in keep)
        dirs.append(d)
    csv = tmp_path / "population.csv"
    with open(csv, "w") as f:
        f.write("dataset,rows,cols,nnzs\n")
        f.writelines(f"{m.name},{m.rows},{m.cols},{m.nnz}\n" for m in pop)
    return dirs, str(csv)


def _line(out, prefix):
    (ln,) = [ln for ln in out.splitlines() if ln.strip().startswith(prefix)]
    return ln.strip()


def test_fitter_equals_fit_heuristic(tmp_path, monkeypatch, capsys):
    (jdir, tdir), csv = _smallest_logs(tmp_path)
    monkeypatch.setattr(js, "REFERENCE_CSV", csv)
    monkeypatch.setattr(js, "build_replica_by_name", functools.partial(
        js.build_replica_by_name, csv_path=csv))
    assert jfit.main([str(jdir)]) == 0
    jout = capsys.readouterr().out
    assert fit.main([str(tdir)]) == 0
    tout = capsys.readouterr().out
    n = re.search(r"(\d+) matrices with complete", tout).group(1)
    assert f"{n} matrices with complete schedule coverage" in jout
    assert int(n) >= 30
    for prefix in ("fitted thresholds:", "fitted capture:",
                   "best fixed schedule:", "oracle geomean:",
                   "four-schedule", "sorted_flat vs", "heuristic speedup",
                   "oracle speedup", "vendor geomean:"):
        assert _line(tout, prefix) == _line(jout, prefix), prefix
    cap = re.compile(r"capture (\S+) of oracle")
    assert (cap.search(_line(tout, "current thresholds")).group(1)
            == cap.search(_line(jout, "current thresholds")).group(1))
    for s in sweep.SCHEDULES:  # the geomean table's rows
        assert _line(tout, f"{s:16s}") == _line(jout, f"{s:16s}")
    with open(jdir / "heuristics.csv") as a, \
            open(tdir / "heuristics.csv") as b:
        assert a.read() == b.read()
    # the features the port rebuilt are recorded for the next fit
    assert len(fit.read_features(str(tdir))) == int(n)


def _card(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: name)


def test_thresholds_for(monkeypatch):
    assert plans.thresholds_for(CPU) is plans.HEURISTIC_THRESHOLDS
    assert plans.spmm_route_for(CPU) is None
    _card(monkeypatch, H100)
    row = plans.thresholds_for("cuda")
    assert row is dict(plans.CARD_THRESHOLDS)["H100"]
    assert plans.spmm_route_for("cuda") is dict(plans.CARD_SPMM_ROUTES)["H100"]
    for r in (row, plans.spmm_route_for("cuda")):
        assert H100 in r["provenance"] and "700" in r["provenance"]
    _card(monkeypatch, "Other")
    assert plans.thresholds_for("cuda") is plans.HEURISTIC_THRESHOLDS
    assert plans.spmm_route_for("cuda") is None


def test_card_rows_run_the_swept_impl():
    """Every schedule a card row can choose maps to the impl the sweep
    timed it with (``schedule="auto"`` runs that impl on the card)."""
    for _, row in plans.CARD_THRESHOLDS:
        for s in (row["flat"], row["group"], "row_mapped"):
            assert row["impl"][s] == sweep.SCHED_IMPL[s]
    for _, row in plans.CARD_SPMM_ROUTES:
        for s in (row["flat"], row["group"], "row_mapped"):
            assert row["impl"][s] == sweep.SPMM_IMPL[s]


def _committed(tmp_path, sub):
    src = os.path.join(H100_LOGS, sub)
    dst = tmp_path / sub.replace("/", "_")
    shutil.copytree(src, dst)
    return str(dst)


def test_fitter_reproduces_card_row(tmp_path):
    d = _committed(tmp_path, "statmatched")
    before = os.path.getsize(os.path.join(d, fit.FEATURES))
    _, best = fit.fit_spmv(d)
    row = dict(plans.CARD_THRESHOLDS)["H100"]
    assert fit.as_table(best, sweep.SCHED_IMPL) == {
        k: v for k, v in row.items() if k != "provenance"}
    # every feature came from features.csv: nothing was rebuilt
    assert os.path.getsize(os.path.join(d, fit.FEATURES)) == before


def test_fitter_reproduces_card_spmm_route(tmp_path):
    dirs = [_committed(tmp_path, f"spmm/{sub}")
            for sub in sorted(os.listdir(os.path.join(H100_LOGS, "spmm")))]
    _, best = fit.fit_spmm(dirs)
    row = dict(plans.CARD_SPMM_ROUTES)["H100"]
    assert fit.as_table(best, sweep.SPMM_IMPL) == {
        k: v for k, v in row.items() if k != "provenance"}


def test_route_aggregation_on_a_card_takes_the_fitted_route(monkeypatch):
    from loops_tpu_torch.layout import CsrLayout
    from loops_tpu_torch.models.message_passing import _route_aggregation
    from loops_tpu_torch.utils import battery

    csr = battery.build("pl_n4096_d16_a1.6")
    assert _route_aggregation(csr, None, "mean", CPU) == ("group_mapped",
                                                         "xla")
    _card(monkeypatch, H100)
    route = dict(plans.CARD_SPMM_ROUTES)["H100"]
    s = plans.choose_schedule(CsrLayout.from_csr(csr), route)
    for op in ("sum", "gcn", "mean"):
        assert _route_aggregation(csr, None, op, "cuda") == (
            s, route["impl"][s])
    _card(monkeypatch, "Other")
    assert _route_aggregation(csr, None, "gcn", "cuda") == ("merge_path",
                                                          "pallas")
    assert _route_aggregation(csr, None, "mean", "cuda") == ("group_mapped",
                                                           "xla")
