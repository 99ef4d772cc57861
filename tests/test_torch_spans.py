"""The program's spans and the record's ``spans`` table
(``loops_tpu_torch/utils/trace.py``) on the CPU.

``span_table`` is held to synthetic Chrome traces laid out as
``torch.profiler`` writes them on a card: a GEMM launched from autograd's
thread lands under the main thread's ``train.backward``; one of the
port's kernels, launched inside ``launch.<counter>``, is counted once,
from the record; a gap ended by a late launch is host wait under the
span of that launch, one ended by an operation already enqueued is
queued; host wait and queued time sum to the idle time, which equals
``loopsbench.harness.read_trace``'s over the same file; a trace whose
kernel list is not whole gives null gap fields. ``annotate`` records
nothing with no profiler collecting. ``make_train_step``, ``evaluate``,
``SpMVOperator``, ``SpMMOperator`` and ``saxpy`` open exactly the named
spans under ``trace.profile``. Each reader of the benchmark's span
metrics gives a value on a run whose record has a table, and None
without one.
"""
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from loopsbench import harness, spec
from loops_tpu_torch.models import GCN, Graph, train
from loops_tpu_torch.ops.kernels.saxpy import saxpy
from loops_tpu_torch.ops.spmm import SpMMOperator
from loops_tpu_torch.ops.spmv import SpMVOperator
from loops_tpu_torch.utils import generate, trace

CPU = torch.device("cpu")
MAIN, AUTOGRAD = 1, 2
NAMES = {"train.forward", "train.backward", "train.optimizer",
         "eval.forward", "eval.read", "spmm", "spmv", "saxpy"}


def _x(name, cat, ts, dur, tid=MAIN, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": float(ts),
            "dur": float(dur), "pid": 1, "tid": tid, "args": args}


def _span(name, ts, dur, tid=MAIN):
    return _x(name, "user_annotation", ts, dur, tid)


def _call(ts, corr, dur=5, tid=MAIN, name="cudaLaunchKernel"):
    return _x(name, "cuda_runtime", ts, dur, tid, correlation=corr)


def _kernel(ts, dur, corr, name="k"):
    return _x(name, "kernel", ts, dur, 7, correlation=corr, stream=7)


def _window(w0=0, w1=1000):
    return [_span(trace.WINDOW, w0, w1 - w0),
            _span(harness.WINDOW_RANGE, w0, w1 - w0)]


def test_a_gemm_launched_from_autograds_thread_lands_under_backward():
    events = _window() + [
        _span("train.forward", 10, 80),
        _span("train.backward", 100, 500),
        _call(200, 7, tid=AUTOGRAD, name="cudaLaunchKernelExC"),
        _kernel(210, 100, 7, name="sm80_xmma_gemm_f32f32"),
        _call(30, 8),
        _kernel(40, 50, 8, name="elementwise"),
    ]
    t = trace.span_table(events, NAMES, [], True)
    assert t["spans"]["train.backward"]["device_ms"] == pytest.approx(0.1)
    assert t["spans"]["train.backward"]["launches"] == 1
    assert t["spans"]["train.forward"]["device_ms"] == pytest.approx(0.05)
    assert t["outside"]["device_ms"] == 0.0


def test_a_port_kernel_in_its_launch_range_is_counted_once():
    events = _window() + [
        _span("train.backward", 100, 800),
        _span("spmm", 150, 150, tid=AUTOGRAD),
        _span(trace.LAUNCH_PREFIX + "flat_spmm", 160, 40, tid=AUTOGRAD),
        _call(170, 9, tid=AUTOGRAD),
        _kernel(180, 480, 9, name="flat_spmm_kernel<4>"),
        # a second launch whose kernel the profiler dropped
        _span("spmm", 700, 100, tid=AUTOGRAD),
        _span(trace.LAUNCH_PREFIX + "flat_spmm", 710, 40, tid=AUTOGRAD),
        _call(720, 10, tid=AUTOGRAD),
    ]
    # the event pair of the first launch holds the host's launch too
    launches = [{"counter": "flat_spmm", "range": "train.backward/spmm",
                 "device_ms": 0.5},
                {"counter": "flat_spmm", "range": "train.backward/spmm",
                 "device_ms": 0.3}]
    t = trace.span_table(events, NAMES, launches, True)
    spmm = t["spans"]["train.backward/spmm"]
    # the trace's kernel once, the dropped one by its event pair
    assert spmm["device_ms"] == pytest.approx(0.48 + 0.3)
    assert spmm["launches"] == 2 and spmm["calls"] == 2
    # the parent holds its child's device ms and launches
    assert t["spans"]["train.backward"]["device_ms"] == pytest.approx(0.78)
    assert t["spans"]["train.backward"]["launches"] == 2
    # the parent's self time is its duration less its children's
    assert t["spans"]["train.backward"]["host_ms"] == pytest.approx(0.8)
    assert t["spans"]["train.backward"]["self_ms"] == pytest.approx(0.55)
    assert t["busy_ms"] == pytest.approx(0.48)
    assert "flat_spmm" not in "".join(t["spans"])  # not a program span
    # the trace lacks a launch's kernel: its gaps cannot be read
    assert t["idle_ms"] is None and t["host_wait_ms"] is None
    # with both kernels in the trace, both count the trace's durations
    t = trace.span_table(events + [_kernel(730, 100, 10)], NAMES, launches,
                         True)
    assert t["spans"]["train.backward/spmm"]["device_ms"] == pytest.approx(
        0.58)
    assert t["host_wait_ms"] + t["queued_ms"] == pytest.approx(t["idle_ms"])


def _gap_events():
    """Three spmv spans: A's kernel starts the window late (host wait);
    B's kernel was enqueued long before A's ends (queued); C's launch
    comes after B's kernel ends (host wait under spmv); then a trailing
    gap outside any span."""
    return _window() + [
        _span("spmv", 100, 50), _call(110, 1), _kernel(120, 280, 1),
        _span("spmv", 160, 40), _call(170, 2), _kernel(405, 195, 2),
        _span("spmv", 700, 50), _call(710, 3, dur=6), _kernel(720, 80, 3),
    ]


def test_gaps_are_host_wait_or_queued_and_sum_to_idle():
    t = trace.span_table(_gap_events(), NAMES, [], True)
    assert t["window_ms"] == pytest.approx(1.0)
    assert t["busy_ms"] == pytest.approx(0.555)
    assert t["queued_ms"] == pytest.approx(0.005)     # 400 to 405
    assert t["host_wait_ms"] == pytest.approx(0.44)   # 0-120, 600-720, 800-
    assert t["spans"]["spmv"]["host_wait_ms"] == pytest.approx(0.24)
    assert t["outside"]["host_wait_ms"] == pytest.approx(0.2)
    assert t["host_wait_ms"] + t["queued_ms"] == pytest.approx(t["idle_ms"])
    assert t["spans"]["spmv"]["calls"] == 3
    assert t["spans"]["spmv"]["launches"] == 3


def test_a_launch_still_in_flight_when_the_gap_opens_is_host_wait():
    events = _window(0, 300) + [
        _span("spmv", 0, 300), _call(10, 1), _kernel(20, 100, 1),
        # the call starts before the gap opens at 120 and returns after it
        _call(110, 2, dur=30), _kernel(145, 100, 2),
    ]
    t = trace.span_table(events, NAMES, [], True)
    assert t["queued_ms"] == 0.0
    assert t["host_wait_ms"] == pytest.approx(0.02 + 0.025 + 0.055)


def test_a_kernel_list_not_whole_gives_null_gap_fields():
    t = trace.span_table(_gap_events(), NAMES, [], False)
    assert t["idle_ms"] is None and t["host_wait_ms"] is None
    assert t["queued_ms"] is None and t["outside"]["host_wait_ms"] is None
    assert all(r["host_wait_ms"] is None for r in t["spans"].values())
    assert t["busy_ms"] == pytest.approx(0.555)
    assert t["spans"]["spmv"]["device_ms"] == pytest.approx(0.555)


def test_a_gap_ended_by_an_operation_without_its_launch_call_is_null():
    events = _window() + [_span("spmv", 100, 50), _kernel(120, 280, 99)]
    t = trace.span_table(events, NAMES, [], True)
    assert t["idle_ms"] is None and t["host_wait_ms"] is None
    assert t["outside"]["device_ms"] == pytest.approx(0.28)


def test_the_records_idle_equals_read_traces(tmp_path):
    events = _gap_events() + [_x("epoch.train", "user_annotation", 0, 990)]
    with open(tmp_path / trace.TRACE_FILE, "w") as f:
        json.dump({"traceEvents": events}, f)
    record = {"launches": [], "profiler_list_whole": True}
    record.update(trace.span_table(events, NAMES, [], True))
    with open(tmp_path / trace.KERNELS_FILE, "w") as f:
        json.dump(record, f)
    got = harness.read_trace(str(tmp_path), 1)
    idle_s = got["window_s"] - got["busy_s"]
    assert abs(idle_s - got["record"]["idle_ms"] * 1e-3) <= 1e-6


def test_span_table_needs_the_window_range():
    with pytest.raises(RuntimeError, match=trace.WINDOW):
        trace.span_table([_span("spmv", 0, 10)], NAMES, [], True)


def test_annotate_records_nothing_with_no_profiler(monkeypatch):
    made = []
    real = torch.profiler.record_function

    def counted(name, *a):
        made.append(name)
        return real(name, *a)

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    names = set(trace._NAMES)
    with trace.annotate("off") as a:
        assert trace._RANGES == [] and a is trace.annotate("off")

    @trace.annotate("deco_off")
    def f():
        return list(trace._RANGES)
    assert f() == [] and made == [] and trace._NAMES == names
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with trace.annotate("on"):
            assert trace._RANGES == ["on"]
            assert f() == ["on", "deco_off"]
    assert made == ["on", "deco_off"] and trace._RANGES == []
    assert {"on", "deco_off"} <= trace._NAMES


def _tiny_gcn():
    rng = np.random.default_rng(0)
    n = 60
    src, dst = rng.integers(0, n, 240), rng.integers(0, n, 240)
    graph = Graph.from_edges(src, dst, n, make_undirected=True)
    model = GCN(graph, [8, 16, 4], dropout=0.5, device=CPU)
    feats = torch.from_numpy(rng.standard_normal((n, 8)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 4, n))
    mask = torch.from_numpy((rng.random(n) < 0.5).astype(np.float32))
    return model, feats, labels, mask


def _spans_of(fn, tmp_path):
    with trace.profile(str(tmp_path)):
        fn()
    return trace.read_record(str(tmp_path))["spans"]


def test_train_step_and_evaluate_open_the_named_spans(tmp_path):
    model, feats, labels, mask = _tiny_gcn()
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    step = train.make_train_step(model, opt, feats, labels, mask)

    def epoch():
        step()
        train.evaluate(model, feats, labels, mask)

    spans = _spans_of(epoch, tmp_path)
    assert set(spans) == {
        "train.forward", "train.forward/spmm", "train.backward",
        "train.backward/spmm", "train.optimizer", "eval.forward",
        "eval.forward/spmm", "eval.read"}
    assert all(r["calls"] >= 1 for r in spans.values())
    assert spans["train.forward"]["calls"] == 1
    assert spans["eval.read"]["calls"] == 1


def test_operators_and_saxpy_open_their_spans(tmp_path):
    csr = generate.random_csr(64, 48, 0.1, seed=1)
    spmv_op = SpMVOperator(csr, device=CPU)
    spmm_op = SpMMOperator(csr, device=CPU)
    x = torch.ones(48)
    B = torch.ones(48, 3)

    def calls():
        spmv_op(x)
        spmm_op(B)
        spmm_op(B)
        saxpy(2.0, x, x, device="cpu")

    spans = _spans_of(calls, tmp_path)
    assert set(spans) == {"spmv", "spmm", "saxpy"}
    assert [spans[k]["calls"] for k in ("spmv", "spmm", "saxpy")] == [1, 2, 1]
    # with no profiler the same calls open nothing
    assert trace._RANGES == []


READERS = ["fwd_ms.gcn", "bwd_ms.gcn", "adam_ms.gcn", "launches.gcn",
           "host_wait_pct.gcn", "host_wait_pct.pagerank",
           "op_host_us.pagerank"]


def _row(calls, host_ms, device_ms, launches, host_wait_ms=0.0):
    return {"calls": calls, "host_ms": host_ms, "self_ms": host_ms,
            "device_ms": device_ms, "launches": launches,
            "host_wait_ms": host_wait_ms}


def _stub_run(with_spans=True):
    record = {"launches": [], "profiler_list_whole": True}
    if with_spans:
        record.update(
            spans={"train.forward": _row(2, 1.0, 4.0, 40),
                   "train.forward/spmm": _row(6, 0.2, 2.0, 6),
                   "train.backward": _row(2, 1.0, 6.0, 60),
                   "train.backward/spmm": _row(4, 0.2, 3.0, 4),
                   "train.optimizer": _row(2, 0.5, 0.4, 8),
                   "spmv": _row(40, 2.0, 20.0, 40),
                   "saxpy": _row(40, 0.8, 2.0, 40)},
            outside={"device_ms": 1.0, "launches": 0, "host_wait_ms": 0.5},
            window_ms=50.0, busy_ms=45.0, idle_ms=5.0, host_wait_ms=2.0,
            queued_ms=3.0)
    return SimpleNamespace(trace={"units": 2, "record": record})


@pytest.mark.parametrize("name", READERS)
def test_span_readers_read_a_table_and_none_without(name):
    read = spec.reader(name)
    assert read(_stub_run(False)) is None
    assert read(SimpleNamespace(trace=None)) is None
    assert read(_stub_run()) is not None


def test_span_readers_values():
    run = _stub_run()
    got = {name: spec.reader(name)(run) for name in READERS}
    assert got == pytest.approx({
        "fwd_ms.gcn": 2.0, "bwd_ms.gcn": 3.0, "adam_ms.gcn": 0.2,
        "launches.gcn": (40 + 60 + 8 + 40 + 40) / 2,
        "host_wait_pct.gcn": 4.0, "host_wait_pct.pagerank": 4.0,
        "op_host_us.pagerank": 1e3 * 2.8 / 40})


def test_span_metrics_are_in_the_benchmark():
    bench = spec.load_benchmark()
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    for name in READERS:
        m = per_layer[name]
        assert m["source"] == "device_trace" and m["better"] == "lower"
        assert os.path.exists(os.path.join(spec.ROOT, spec.metric_path(name)))
