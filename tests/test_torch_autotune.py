"""The launch box's autotuner on the CPU: ``autotune`` sweeps K2 and K3's
``spmv_block`` and K4's ``block_f`` (their plain versions here) and caches
the winners under the device's name in ``$LOOPS_TUNE_CACHE``;
``launch_params`` takes a cached row only for a card of that name, and
the committed H100 row names its measurement."""
import json

import pytest
import torch

from loops_tpu_torch.tuning import autotune, launch_box

CPU = torch.device("cpu")
H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture
def cache(tmp_path, monkeypatch):
    path = tmp_path / "tune.json"
    monkeypatch.setenv("LOOPS_TUNE_CACHE", str(path))
    return path


def _card(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: name)


def test_autotune_on_cpu_caches_its_winners(cache):
    row = autotune.autotune(CPU, n=1024, density=0.01, verbose=False)
    assert row["spmv_block"] in autotune.SPMV_BLOCKS
    assert row["spmm_block_f"] in autotune.SPMM_BLOCK_FS
    assert row["timing"] == "apply_ms"  # no device time on the CPU
    assert len(row["spmv_ms"]) == 2 * len(autotune.SPMV_BLOCKS)
    assert len(row["spmm_ms"]) == len(autotune.SPMM_BLOCK_FS)
    assert json.loads(cache.read_text())["cpu"] == row
    assert autotune.cached_autotune_row("cpu") == {
        "spmv_block": row["spmv_block"], "spmm_block_f": row["spmm_block_f"]}
    # the CPU keeps its test-size row: the cache is read for cards only
    assert launch_box.launch_params(CPU) == launch_box._CPU


def test_launch_params_reads_the_cache_for_that_card(cache, monkeypatch):
    cache.write_text(json.dumps({H100: {"spmv_block": 4096,
                                        "spmm_block_f": 64, "timing": "x"}}))
    _card(monkeypatch, H100)
    p = launch_box.launch_params("cuda")
    assert (p.spmv_block, p.spmm_block_f) == (4096, 64)
    assert p.provenance == "autotuned"
    assert p.hbm_gbps == dict(launch_box._TABLE)["H100"].hbm_gbps
    _card(monkeypatch, "NVIDIA A100-SXM4-80GB")
    assert launch_box.launch_params("cuda") == launch_box._FALLBACK
    cache.write_text("not json")
    _card(monkeypatch, H100)
    assert launch_box.launch_params("cuda") == dict(launch_box._TABLE)["H100"]


def test_cache_path(monkeypatch, tmp_path):
    monkeypatch.delenv("LOOPS_TUNE_CACHE", raising=False)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    assert autotune.cache_path() == (tmp_path / "loops_tpu_torch"
                                     / "autotune.json")
    monkeypatch.setenv("LOOPS_TUNE_CACHE", str(tmp_path / "x.json"))
    assert autotune.cache_path() == tmp_path / "x.json"


def test_committed_h100_row_is_measured(cache, monkeypatch):
    _card(monkeypatch, H100)
    p = launch_box.launch_params("cuda")
    assert p.spmv_block in autotune.SPMV_BLOCKS
    assert p.spmm_block_f in autotune.SPMM_BLOCK_FS
    assert H100 in p.provenance and "700" in p.provenance
    assert "v5e" not in p.provenance
