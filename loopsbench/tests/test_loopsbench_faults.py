"""The check of a tiny run on the CPU, with the timed path broken
underneath by each fault of its driver's ``FAULTS``, reads
``correct`` false; and the control (the reference below the
configuration's precision) fails a limit where the CPU has that
precision."""
import time

import pytest

from loopsbench import harness, run, spec

CASES = [(w["name"], f) for w in spec.load_benchmark()["workloads"]
         for f in spec.resolve(w["name"]).driver.FAULTS]


def tiny(cell):
    c = spec.resolve(cell)
    run._merge(c.config, c.traffic.get("tiny", {}).get("config", {}))
    run._merge(c.traffic, c.traffic.get("tiny", {}).get("traffic", {}))
    return c


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_fails_the_check(cell, fault):
    c = tiny(cell)
    with c.driver.FAULTS[fault]():
        out, _ = harness.execute(c, 7, 0.3, False, "cpu",
                                 time.perf_counter())
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  spec.load_benchmark()["workloads"]])
def test_sound_tiny_run_is_correct(cell):
    out, _ = harness.execute(tiny(cell), 8, 0.3, False, "cpu",
                             time.perf_counter())
    assert out["correct"] is True, out["checks"]


@pytest.mark.parametrize("cell", ["pagerank.soc-livejournal1",
                                  "pagerank.road_usa"])
def test_bf16_control_fails_a_limit(cell):
    c = tiny(cell)
    got = c.driver.control(c, 9, "cpu")
    limits = c.traffic["limits"]
    assert any(got[k] > limits[k] for k in limits), got


@pytest.mark.cuda
def test_tf32_control_fails_a_limit(cuda):
    c = tiny("gcn_arxiv.train")
    got = c.driver.control(c, 9, cuda)
    limits = c.traffic["limits"]
    assert any(got[k] > limits[k] for k in limits), got


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  spec.load_benchmark()["workloads"]])
def test_tiny_cell_on_the_card(cuda, cell):
    out, _ = harness.execute(tiny(cell), 10, 0.5, True, cuda,
                             time.perf_counter())
    assert out["correct"] is True, out["checks"]
    assert out["device"]["busy_s"] > 0
