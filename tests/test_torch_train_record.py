"""The port's two record scripts on the CPU, against the JAX package's:
``scripts/train_record_torch.py`` (``scripts/train_record.py``'s dataset
line and table, at the tiny stand-in) and ``scripts/run_torch.sh``
(``scripts/run.sh``'s per-schedule CSVs over ``datasets/*.mtx``).
"""
import importlib.util
import os
import subprocess

import pytest

from loops_tpu.io import ogb as jax_ogb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCHEDULES = ("row_mapped", "group_mapped", "work_oriented", "merge_path",
             "sorted_flat")


def _record_module():
    spec = importlib.util.spec_from_file_location(
        "train_record_torch",
        os.path.join(REPO, "scripts", "train_record_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_train_record_prints_jax_header_and_four_rows(capsys):
    mod = _record_module()
    assert mod.main(["--device", "cpu", "--dataset", "tiny",
                     "--epochs", "3"]) == 0
    out, err = capsys.readouterr()
    lines = out.splitlines()
    ds = jax_ogb.load("tiny")
    assert lines[0] == (f"dataset={ds.name} (synthetic power-law fixture) "
                        f"nodes={ds.graph.num_nodes:,} "
                        f"edges={ds.graph.num_edges:,} "
                        f"classes={ds.num_classes}")
    assert lines[1] == ""
    with open(os.path.join(REPO, "scripts", "train_record.py")) as f:
        jax_src = f.read()
    for head in mod.TABLE_HEAD:
        assert f'"{head}"' in jax_src
    assert lines[2:4] == list(mod.TABLE_HEAD)
    rows = [ln.split("|")[1:-1] for ln in lines[4:]]
    assert [(m.strip(), p.strip()) for m, p, *_ in rows] == [
        ("gcn", "exact"), ("gcn", "throughput"), ("sage", "exact"),
        ("sage", "throughput")]
    for _, _, acc, ms, eps in rows:
        # (edges a second print to one decimal: a slow host may read 0.0)
        assert 0.0 <= float(acc) <= 1.0 and float(ms) > 0 and float(eps) >= 0
    # on the CPU no path launches a kernel
    assert err.count("launches: none") == 4


def test_paths_are_jax_run_one_options():
    mod = _record_module()
    assert mod.model_kwargs("gcn", "exact") == dict(schedule="group_mapped",
                                                   impl="xla")
    assert mod.model_kwargs("sage", "exact") == dict(schedule="group_mapped",
                                                    impl="xla")
    assert mod.model_kwargs("gcn", "throughput") == dict(
        schedule="auto", dtype="bfloat16", precompute_first=True)
    assert mod.model_kwargs("sage", "throughput") == dict(
        schedule="auto", dtype="bfloat16")
    with pytest.raises(ValueError):
        mod.model_kwargs("gcn", "fast")


def _run_sh(tmp_path, *extra, env=None):
    out = str(tmp_path / "logs")
    proc = subprocess.run(
        ["bash", os.path.join(REPO, "scripts", "run_torch.sh"),
         os.path.join(REPO, "datasets"), out, *extra],
        capture_output=True, text=True, timeout=240, env=env)
    assert proc.returncode == 0, proc.stderr
    return out


def test_run_torch_sh_writes_one_row_per_schedule(tmp_path):
    out = _run_sh(tmp_path, "60", "cpu")
    assert sorted(os.listdir(out)) == sorted(f"{s}.csv" for s in SCHEDULES)
    for s in SCHEDULES:
        with open(os.path.join(out, f"{s}.csv")) as f:
            rows = f.read().splitlines()
        assert len(rows) == 1, (s, rows)
        fields = rows[0].split(",")
        assert fields[0].endswith(s) and len(fields) == 6
        assert ",".join(fields[1:5]) == "chesapeake,39,39,340"
        assert float(fields[5]) > 0


def test_run_torch_sh_writes_timeout_rows(tmp_path):
    out = _run_sh(tmp_path, "0.01", "cpu")
    for s in SCHEDULES:
        with open(os.path.join(out, f"{s}.csv")) as f:
            assert f.read().splitlines() == ["TIMEOUT,chesapeake.mtx"]


def test_run_torch_sh_device_defaults_to_cuda(tmp_path):
    # with no card visible each cuda run fails, and never falls back to
    # the CPU, on a machine with cards too
    out = _run_sh(tmp_path, "60",
                  env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    for s in SCHEDULES:
        with open(os.path.join(out, f"{s}.csv")) as f:
            assert f.read().splitlines() == ["TIMEOUT,chesapeake.mtx"]
