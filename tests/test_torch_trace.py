"""``loops_tpu_torch.utils.trace`` against ``loops_tpu.utils.trace`` on
the CPU: ``csv_row`` string for string, ``annotate`` as a decorator and a
context, and ``profile``'s two files. Its kernel record is exercised
with a stand-in library and event class (no card here), as
``tests/test_torch_launch_path.py`` stands in for the card: a launch in
the window is recorded with its range and device time, and a counted
launch the record lacks raises.
"""
import contextlib
import json
import os

import pytest
import torch

from loops_tpu.utils import trace as jax_trace
from loops_tpu_torch.ops.kernels import _build
from loops_tpu_torch.utils import trace

CUDA0 = torch.device("cuda", 0)


@pytest.mark.parametrize("args,extra", [
    (("row_mapped", "chesapeake", 39, 39, 340, 0.123456), {}),
    (("sorted_flat", "big", 2097152, 2097152, 33554301, 12.0), {}),
    (("merge_path", "x", 1, 2, 3, 0.0), {"errors": 0}),
    (("k", "d", 5, 5, 7, 1e-7), {"a": 1.5, "b": "TIMEOUT", "c": None}),
])
def test_csv_row_equals_jax(args, extra):
    assert trace.csv_row(*args, **extra) == jax_trace.csv_row(*args, **extra)


def test_annotate_as_context_and_decorator():
    # annotate pushes its path only while a profiler collects
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with trace.annotate("outer") as a:
            assert trace._RANGES == ["outer"]
            with trace.annotate("inner"):
                assert trace._RANGES == ["outer", "inner"]
        assert isinstance(a, contextlib.ContextDecorator) and a.name == "outer"
        assert trace._RANGES == []

        seen = []

        @trace.annotate("deco")
        def f(n):
            seen.append(list(trace._RANGES))
            return f(n - 1) if n else "done"
        assert f(2) == "done"
        assert seen == [["deco"], ["deco", "deco"], ["deco", "deco", "deco"]]
        assert trace._RANGES == []
        with pytest.raises(ValueError):
            with trace.annotate("raises"):
                raise ValueError("passes through")
        assert trace._RANGES == []


def test_profile_writes_trace_with_annotations(tmp_path):
    logdir = str(tmp_path / "t")
    with trace.profile(logdir) as d:
        assert d == logdir
        with trace.annotate("loops_step"):
            torch.ones(64).sum()
    with open(os.path.join(logdir, trace.TRACE_FILE)) as f:
        text = f.read()
    assert "loops_step" in text
    json.loads(text)
    rec = trace.read_record(logdir)
    assert rec["launches"] == [] and rec["counted"] == {}
    assert rec["profiler_list_whole"] and rec["wall_ms"] > 0
    assert _build.RECORDER is None


class _StandInEvent:
    """A CUDA event pair's stand-in: each record() a tick of 0.25 ms."""
    clock = 0.0

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.t = None

    def record(self):
        _StandInEvent.clock += 0.25
        self.t = _StandInEvent.clock

    def elapsed_time(self, other):
        return other.t - self.t


class _Fn:
    def __init__(self, err=0):
        self.err, self.calls = err, []

    def __call__(self, *args):
        self.calls.append(args)
        return self.err


@pytest.fixture
def fake_card(monkeypatch):
    """``_build``'s function table holds stand-ins, and ``torch.cuda``
    answers as a one-card machine's; events are ``_StandInEvent``."""
    fns = {name: _Fn() for name in _build._SIGNATURES}
    monkeypatch.setattr(_build, "_FNS", fns)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(_build, "_raw_stream", lambda index: 4242)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda index: contextlib.nullcontext())
    monkeypatch.setattr(trace, "EVENT", _StandInEvent)
    yield fns


def _fake_launch():
    x, y, out = torch.ones(8), torch.ones(8), torch.empty(8)
    _build.launch("loops_saxpy_f32", "saxpy", CUDA0, 2.5, x, y, out, 8, 1)


def test_profile_records_each_launch_with_its_range(fake_card, tmp_path):
    before = _build.LAUNCHES["saxpy"]
    with trace.profile(str(tmp_path)):
        with trace.annotate("step0"):
            _fake_launch()
        with trace.annotate("step1"):
            with trace.annotate("inner"):
                _fake_launch()
        _fake_launch()
    assert _build.LAUNCHES["saxpy"] == before + 3
    rec = trace.read_record(str(tmp_path))
    assert rec["counted"] == {"saxpy": 3}
    assert [x["range"] for x in rec["launches"]] == ["step0", "step1/inner",
                                                     ""]
    assert [x["device_ms"] for x in rec["launches"]] == [0.25] * 3
    assert rec["device_ms"] == 0.75
    # the stream the kernel went on is the one launch passes outside
    assert all(call[-1] == 4242 for call in fake_card["loops_saxpy_f32"].calls)
    # the CPU profiler saw no kernel of the three: its list is not whole
    assert not rec["profiler_list_whole"] and rec["profiler_gaps"]
    assert _build.RECORDER is None


def test_a_counted_launch_missing_from_the_record_raises(fake_card, tmp_path):
    with pytest.raises(RuntimeError, match="flat_spmm 0 of 1"):
        with trace.profile(str(tmp_path)):
            _fake_launch()
            _build.LAUNCHES["flat_spmm"] += 1  # counted, never launched
    assert not os.path.exists(os.path.join(str(tmp_path), trace.KERNELS_FILE))
    assert _build.RECORDER is None


def test_a_failed_launch_is_neither_counted_nor_recorded(fake_card,
                                                         tmp_path):
    fake_card["loops_saxpy_f32"].err = 700
    before = _build.LAUNCHES["saxpy"]
    with trace.profile(str(tmp_path)):
        with pytest.raises(RuntimeError, match="CUDA error 700"):
            _fake_launch()
    assert _build.LAUNCHES["saxpy"] == before
    assert trace.read_record(str(tmp_path))["launches"] == []


def test_profile_windows_do_not_nest_and_errors_pass(tmp_path):
    with pytest.raises(KeyError):
        with trace.profile(str(tmp_path / "a")):
            raise KeyError("the body's error")
    assert _build.RECORDER is None
    with trace.profile(str(tmp_path / "b")):
        with pytest.raises(RuntimeError, match="already open"):
            with trace.profile(str(tmp_path / "c")):
                pass
    assert _build.RECORDER is None


def test_launch_outside_a_window_skips_the_record(fake_card):
    assert _build.RECORDER is None
    _fake_launch()
    assert len(fake_card["loops_saxpy_f32"].calls) == 1
