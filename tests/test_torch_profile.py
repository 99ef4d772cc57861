"""``utils/profile_spmv``'s reading of a ``torch.profiler`` trace, on the
CPU with synthetic traces: a device time is read only from a trace that
holds every launch the port's wrappers counted over the window (and every
kernel a whole number of times per apply); from any other it is "not
measured", never a short count divided by the applies.
"""
import os
import re

import pytest
import torch

from loops_tpu_torch.ops.kernels import _build
from loops_tpu_torch.utils import profile_spmv
from loops_tpu_torch.utils.profile_spmv import read_trace, trace_gaps

APPLIES = 10
K4 = "void (anonymous namespace)::flat_spmm_kernel<8, false, true>(float const*)"
SEAM = "void (anonymous namespace)::spmm_seam_kernel(int const*, int const*)"
EW = "void at::native::vectorized_elementwise_kernel<4, at::native::Fill>"


def _trace(n_k4, n_seam=APPLIES, n_ew=2 * APPLIES):
    """event name -> (times recorded, summed microseconds)"""
    return {K4: (n_k4, 30.0 * n_k4), SEAM: (n_seam, 2.0 * n_seam),
            EW: (n_ew, 1.0 * n_ew)}


def _counted(**kw):
    return {k: kw.get(k, 0) for k in _build.LAUNCHES}


def test_a_full_trace_is_read():
    r = read_trace(_trace(APPLIES), _counted(flat_spmm=APPLIES), APPLIES,
                   wall_ms=0.05)
    assert r["not_measured"] == []
    assert r["device_ms"] == pytest.approx((30 + 2 + 2) / 1e3)
    assert r["idle_share"] == pytest.approx(1 - 0.034 / 0.05)
    assert r["kernels"][0] == [K4, 1.0, pytest.approx(0.03)]


@pytest.mark.parametrize("n_k4,n_seam,n_ew,gap", [
    (7, APPLIES, 2 * APPLIES, "7 of 10 launches of flat_spmm_kernel"),
    (0, APPLIES, 2 * APPLIES, "0 of 10 launches of flat_spmm_kernel"),
    (APPLIES, APPLIES, 2 * APPLIES - 3, "x17/10"),
    (APPLIES, 5, 2 * APPLIES, "spmm_seam_kernel"),
])
def test_a_short_trace_is_not_measured(n_k4, n_seam, n_ew, gap):
    trace = _trace(n_k4, n_seam, n_ew)
    if n_k4 == 0:
        del trace[K4]
    r = read_trace(trace, _counted(flat_spmm=APPLIES), APPLIES, wall_ms=0.05)
    assert r["device_ms"] is None and r["idle_share"] is None
    assert r["kernels"] == []
    assert any(gap in g for g in r["not_measured"]), r["not_measured"]


def test_an_empty_trace_is_not_measured_on_the_card_only():
    r = read_trace({}, _counted(flat_spmm=APPLIES), APPLIES, wall_ms=0.05)
    assert r["device_ms"] is None
    assert r["not_measured"] == ["torch.profiler recorded no kernel"]
    # on the CPU nothing runs on a device: the whole apply is idle
    r = read_trace({}, _counted(), APPLIES, wall_ms=0.05, cuda=False)
    assert r["device_ms"] == 0 and r["idle_share"] == 1.0
    assert r["not_measured"] == []


def test_kernel_names_match_as_whole_identifiers():
    v2 = "void (anonymous namespace)::flat_spmv_v2_kernel<true>(float const*)"
    # K3's counted launches are not found in K2's kernel, nor K2's seam
    # pass in K4's
    gaps = trace_gaps(_counted(flat_spmv=APPLIES), {v2: APPLIES}, APPLIES)
    assert gaps == ["0 of 10 launches of flat_spmv_kernel"]
    assert trace_gaps(_counted(flat_spmv_v2=APPLIES), {v2: APPLIES},
                      APPLIES) == []


def test_counters_that_share_a_kernel_are_summed():
    rows = "void (anonymous namespace)::row_gather_kernel<float, true>(...)"
    counted = _counted(onehot_expand=APPLIES, row_gather_mat_hbm=APPLIES)
    assert trace_gaps(counted, {rows: 2 * APPLIES}, APPLIES) == []
    assert trace_gaps(counted, {rows: APPLIES}, APPLIES) == [
        "10 of 20 launches of row_gather_kernel"]


@pytest.mark.parametrize("where", ["smem", "l2", "hbm"])
def test_g1_launches_are_read_under_the_sum_kernel(where):
    """G1's launches carry ``row_gather_sum_kernel``, G2's
    ``row_gather_kernel``: one name is not counted for the other."""
    sums = ("void (anonymous namespace)::row_gather_sum_kernel<float, true,"
            " 1024, 4>(...)")
    counted = _counted(**{f"row_gather_sum_{where}": APPLIES})
    assert trace_gaps(counted, {sums: APPLIES}, APPLIES) == []
    rows = "void (anonymous namespace)::row_gather_kernel<float, true>(...)"
    assert trace_gaps(counted, {rows: APPLIES}, APPLIES) == [
        "0 of 10 launches of row_gather_sum_kernel"]


def test_every_counter_names_a_kernel_of_the_sources():
    """Each launch counter's trace names are ``__global__`` functions of
    ``csrc/*.cu``, so a launch of the port cannot go unlooked-for."""
    kernels = set()
    for f in os.listdir(_build.SRC_DIR):
        if f.endswith(".cu"):
            with open(os.path.join(_build.SRC_DIR, f)) as fh:
                kernels |= set(re.findall(
                    r"__global__\s+void\s+"
                    r"(?:__launch_bounds__\((?:[^()]|\([^()]*\))*\)\s+)?"
                    r"(\w+)\s*\(", fh.read()))
    for counter in _build.LAUNCHES:
        names = profile_spmv.trace_names(counter)
        assert set(names) <= kernels, (counter, names)


def test_profile_applies_reads_the_counters_of_its_window(monkeypatch):
    """The counts held against the trace are the window's own: launches
    before it (warm-up, the wall-clock applies) are not."""
    seen = {}

    def fake_read(per_kernel, counted, applies, wall_ms, cuda=True):
        seen.update(counted=counted, applies=applies)
        return {}

    def apply(x):
        _build.LAUNCHES["saxpy"] += 1
        return x
    monkeypatch.setattr(profile_spmv, "read_trace", fake_read)
    before = _build.LAUNCHES["saxpy"]
    try:
        profile_spmv.profile_applies(apply, torch.zeros(4), applies=3,
                                     warmup=2)
    finally:
        _build.LAUNCHES["saxpy"] = before
    assert seen["applies"] == 3 and seen["counted"]["saxpy"] == 3
    assert sum(seen["counted"].values()) == 3
