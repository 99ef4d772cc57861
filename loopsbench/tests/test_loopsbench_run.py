"""Tiny cells end to end on the CPU, each in a process of its own, as
the benchmark runs them but for the look for a card: the result line's
keys, ``correct``, and no module of JAX or the JAX package loaded."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from loopsbench import spec

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def run_tiny(root, cell, trace, seed=2**33 + 5):
    code = ("import sys; from loopsbench import run; "
            f"sys.exit(run.main(['--workload', {cell!r}, '--seed', "
            f"'{seed}', '--seconds', '0.5', '--trace', '{trace}'], "
            "device='cpu', tiny=True))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_tiny_cell_runs(root, cell, trace):
    p = run_tiny(root, cell, trace)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    extra = ["breakdown"] if trace else []
    assert list(line) == KEYS + extra + ["checks"]
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    c = spec.resolve(cell)
    want = {m["name"] for m in (c.per_layer if trace else c.end_to_end)}
    assert set(line["metrics"]) <= want
    if not trace:
        assert set(line["metrics"]) == want
    # each number compared ends standard error, beside its limit
    tail = p.stderr.strip().splitlines()[-len(line["checks"]):]
    for (name, c), text in zip(line["checks"].items(), tail):
        assert text == f"check {name} {c['value']} limit {c['limit']}"


def test_needs_a_card_without_one(root):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    p = subprocess.run([sys.executable, "-m", "loopsbench.run", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1"], cwd=root,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_alone_in_a_directory(root, tmp_path):
    """Holding only BENCHMARK.json and the benchmark's files, a run fails
    and prints no result."""
    shutil.copy(os.path.join(root, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(root, "loopsbench"), tmp_path / "loopsbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; from loopsbench import run; "
            f"sys.exit(run.main(['--workload', {CELLS[0]!r}, '--seed', '1', "
            "'--seconds', '0.5'], device='cpu', tiny=True))")
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""
