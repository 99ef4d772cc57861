"""The multi-device tier's three CLIs at a tiny size on two gloo ranks
(``--device cpu --world 2``): ``examples/dist_train_torch.py`` through
the overlapped halo, ``scripts/bench_scaling_torch.py`` (rates at 1 and
2 ranks, then ``--volume-model``) and
``scripts/outofcore_mesh_train_torch.py`` (a store of two shards, one a
host, through the hierarchical exchange). Each runs as its own process,
as a user runs it."""
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(*args, timeout=120):
    r = subprocess.run([sys.executable, *args], capture_output=True,
                       text=True, timeout=timeout, cwd=REPO)
    assert r.returncode == 0, r.stdout + r.stderr
    return r.stdout, r.stderr


def test_dist_train_cli():
    out, err = _run("examples/dist_train_torch.py", "--device", "cpu",
                    "--world", "2", "--epochs", "5", "--exchange", "halo")
    assert "devices=2 exchange=halo backend=gloo" in out
    assert "epoch    0 loss" in out and "test_accuracy:" in out
    assert "edges_per_s:" in out
    assert "kernel launches per rank: [0, 0]" in err


def test_bench_scaling_cli():
    out, _ = _run("scripts/bench_scaling_torch.py", "--device", "cpu",
                  "--world", "2", "--nodes", "1500", "--feature-dim", "16",
                  "--iters", "2")
    for proto in ("all_gather", "halo_overlap"):
        for n in (1, 2):
            assert f"{proto:13s} {n:3d} ranks:" in out, out
    assert "device: cpu" in out
    out, _ = _run("scripts/bench_scaling_torch.py", "--volume-model",
                  "--world", "4", "--nodes", "1500", "--graph", "banded")
    assert "per-layer exchange volume model" in out and "2x 2" in out


def test_outofcore_mesh_train_cli():
    out, _ = _run("scripts/outofcore_mesh_train_torch.py", "--device",
                  "cpu", "--world", "2", "--nodes", "3000", "--steps", "2")
    assert "from_shards: P=2 (2x1)" in out
    assert "check: OK" in out
