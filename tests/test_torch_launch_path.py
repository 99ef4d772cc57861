"""The host launch path of the port's kernels (``ops/kernels/_build.py``
``launch``), on the CPU: no card and no CUDA library are needed.

``launch`` resolves each C entry point once, at load, into ``_FNS`` (the
launch binding's callables); passes tensors as plain integer pointers;
asks for the current stream's handle on every call; and makes the device
current only when it is not already. Here the kernels' library is the
stand-in of ``tests/test_torch_binding.py`` (compiled here, each entry
point recording its arguments), reached through the real launch
binding, and ``torch.cuda``'s device and stream queries answer as a
one-card machine would, so each rule shows without a card. The card
tests (``test_torch_cuda_kernels.py``) hold the same path on the H100: a
launch under ``torch.cuda.stream(s)`` goes on ``s``.
"""
import ctypes
import contextlib

import numpy as np
import pytest
import torch

from loops_tpu_torch.formats import BCSR
from loops_tpu_torch.ops.kernels import (
    _build,
    sddmm_bcsr,
    spmm_bcsr,
    spmm_bcsr_v2,
    spmm_bcsr_v3,
    spmv_bcsr,
    spmv_sorted,
)
from loops_tpu_torch.ops.spmv import SpMVOperator
from loops_tpu_torch.utils import generate
from test_torch_binding import StubRecord, linking, stub_so  # noqa: F401

CPU = torch.device("cpu")
CUDA0 = torch.device("cuda", 0)


@pytest.fixture
def fake_card(monkeypatch, tmp_path, stub_so):
    """The stand-in library loaded through the launch binding, its
    record in ``stub``, and a one-card ``torch.cuda``: current device 0,
    stream handle 4242 (or what ``streams`` maps the device to); device
    switches are recorded in ``switches``."""
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "_FNS", {})
    monkeypatch.setattr(_build, "_SMS", {})
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_build", linking(stub_so))
    state = {"current": 0, "streams": {0: 4242, 1: 5353}, "switches": []}
    monkeypatch.setattr(torch.cuda, "current_device",
                        lambda: state["current"])
    monkeypatch.setattr(_build, "_raw_stream",
                        lambda index: state["streams"][index])

    @contextlib.contextmanager
    def device(index):
        state["switches"].append(index)
        before, state["current"] = state["current"], index
        try:
            yield
        finally:
            state["current"] = before
    monkeypatch.setattr(torch.cuda, "device", device)
    state["stub"] = StubRecord(_build.load_library())
    yield state
    state["stub"].reset()


def test_unknown_counter_raises_before_any_launch(fake_card):
    before = dict(_build.LAUNCHES)
    with pytest.raises(KeyError, match="not a launch counter"):
        _build.launch("loops_saxpy_f32", "no_such_kernel", CUDA0, 1.0)
    assert _build.LAUNCHES == before
    assert fake_card["stub"].calls() == []


def test_unknown_entry_point_raises(fake_card):
    with pytest.raises(KeyError):
        _build.launch("loops_no_such_entry", "saxpy", CUDA0)


def test_function_table_covers_every_signature(fake_card):
    # one launch binding callable per entry point, of the table's types
    assert sorted(_build._FNS) == sorted(_build._SIGNATURES)
    codes = {ctypes.c_void_p: "p", ctypes.c_int: "i", ctypes.c_float: "f"}
    binding = _build.load_binding()
    for name, fn in _build._FNS.items():
        assert fn.__name__ == name and not isinstance(fn, ctypes._CFuncPtr)
        assert binding.SIGNATURES[name] == "".join(
            codes[t] for t in _build._SIGNATURES[name])
    # loaded: later calls take no lock and build nothing
    lib = _build._lib
    assert _build.load_library() is lib


def test_launch_passes_pointers_ints_and_the_current_stream(fake_card):
    x = torch.arange(8, dtype=torch.float32)
    y = torch.ones(8)
    out = torch.empty(8)
    before = _build.LAUNCHES["saxpy"]
    _build.launch("loops_saxpy_f32", "saxpy", CUDA0, 2.5, x, y, out,
                  np.int64(8), 1)
    (args,) = fake_card["stub"].calls("loops_saxpy_f32")
    assert args == (2.5, x.data_ptr(), y.data_ptr(), out.data_ptr(), 8, 1,
                    4242)
    assert _build.LAUNCHES["saxpy"] == before + 1
    # the device was already current: no switch
    assert fake_card["switches"] == []


def test_launch_asks_for_the_stream_on_every_call(fake_card):
    x = torch.zeros(4)
    for handle in (11, 12):
        fake_card["streams"][0] = handle
        _build.launch("loops_stream_read_f32", "stream_read", CUDA0, x, x,
                      1, 1, 1)
    calls = fake_card["stub"].calls("loops_stream_read_f32")
    assert [c[-1] for c in calls] == [11, 12]


def test_launch_switches_to_another_device_and_back(fake_card):
    x = torch.zeros(4)
    _build.launch("loops_stream_read_f32", "stream_read",
                  torch.device("cuda", 1), x, x, 1, 1, 1)
    assert fake_card["switches"] == [1]
    assert fake_card["current"] == 0
    # device 1's own stream
    assert fake_card["stub"].calls("loops_stream_read_f32")[0][-1] == 5353
    # a device without an index is the current one
    _build.launch("loops_stream_read_f32", "stream_read",
                  torch.device("cuda"), x, x, 1, 1, 1)
    assert fake_card["switches"] == [1]


def test_launch_raises_on_a_cuda_error_and_counts_nothing(fake_card):
    fake_card["stub"].set_err("loops_saxpy_f32", 9)
    before = _build.LAUNCHES["saxpy"]
    with pytest.raises(RuntimeError, match="CUDA error 9"):
        _build.launch("loops_saxpy_f32", "saxpy", CUDA0, 1.0, torch.zeros(1),
                      torch.zeros(1), torch.zeros(1), 1, 1)
    assert _build.LAUNCHES["saxpy"] == before


def test_sm_count_is_asked_once_per_device(fake_card, monkeypatch):
    asked = []

    class Props:
        multi_processor_count = 132

    def props(index):
        asked.append(index)
        return Props()
    monkeypatch.setattr(torch.cuda, "get_device_properties", props)
    for _ in range(3):
        assert _build.sm_count(CUDA0) == 132
        assert _build.sm_count(torch.device("cuda")) == 132
    assert _build.sm_count(torch.device("cuda", 1)) == 132
    assert asked == [0, 1]


@pytest.mark.parametrize("case", ["device", "dtype", "contiguity", "size"])
def test_check_raises(case):
    t = torch.zeros(6, dtype=torch.float32)
    args = {
        "device": (t, "t", torch.float32, torch.device("meta")),
        "dtype": (t, "t", torch.int32, CPU),
        "contiguity": (torch.zeros(12)[::2], "t", torch.float32, CPU),
        "size": (t, "t", torch.float32, CPU, 7),
    }[case]
    with pytest.raises(ValueError, match="t "):
        _build.check(*args)
    _build.check(t, "t", torch.float32, CPU, 6)


def test_k1_wrapper_refuses_a_cpu_tensor_before_any_check():
    with pytest.raises(ValueError, match="CUDA tensor"):
        spmv_sorted.sorted_spmv_cuda({}, torch.zeros(4), {})


@pytest.mark.parametrize("change", ["none", "resize", "set", "as_strided",
                                    "replaced", "dropped"])
def test_k1_sees_staged_buffers_changed(change):
    # K1 skips its buffer checks only for the tensors it checked at bind,
    # none of them changed in place since
    csr = generate.random_csr(30, 20, 0.2, seed=4)
    b, fn = spmv_sorted.sorted_spmv(csr, block_atoms=8, device=CPU)
    assert fn.params["rows"] == 30 and fn.params["cols_n"] == 20
    staged = tuple(b.values())
    fingerprint = spmv_sorted.staged_fingerprint(b)
    if change == "resize":
        b["cols"].resize_(0)
    elif change == "set":
        b["vals"].set_(torch.zeros(3))
    elif change == "as_strided":
        b["offsets"].as_strided_((8,), (2,))
    elif change == "replaced":
        b["cuts"] = b["cuts"].clone()
    elif change == "dropped":
        del b["row_last"]
    assert spmv_sorted.staged_unchanged(b, staged, fingerprint) == (
        change == "none")


def test_operator_stages_x_once():
    csr = generate.random_csr(30, 20, 0.2, seed=4)
    op = SpMVOperator(csr, "sorted_flat", device=CPU)
    x = torch.from_numpy(generate.make_input_vector(20))
    # already staged: used as is
    assert op.stage(x) is x
    for other in (x.double(), x.numpy(), torch.zeros(40)[::2]):
        s = op.stage(other)
        assert s.dtype == torch.float32 and s.is_contiguous()
        assert s is not other
    np.testing.assert_array_equal(op(x).numpy(), op(x.numpy()).numpy())


def test_host_us_times_calls_on_the_host_clock():
    from loops_tpu_torch.utils import bench

    calls = []
    us = bench.host_us(lambda: calls.append(1), calls=7, repeats=3)
    assert us > 0 and len(calls) == 1 + 7 * 3


@pytest.mark.parametrize("change", ["none", "resize", "set", "replaced"])
def test_staged_guard_sees_buffers_changed(change):
    # the guard K1, K2 and K3 share: the buffers are checked at bind only
    # on a card, and a call skips its check only for the very tensors
    # checked then, none changed in place since
    checked = []
    bufs = {"vals": torch.zeros(6), "cols": torch.zeros(6, dtype=torch.int32)}
    staged_on = _build.staged_guard(
        bufs, {}, lambda b, p, d: checked.append(d))
    assert checked == []  # on the CPU: nothing to check at bind
    b = dict(bufs)
    if change == "resize":
        b["cols"].resize_(2)
    elif change == "set":
        b["vals"].set_(torch.zeros(3))
    elif change == "replaced":
        b["vals"] = b["vals"].clone()
    assert staged_on(b) == (CPU if change == "none" else None)


@pytest.mark.parametrize("out", ["none", "good", "short", "double"])
def test_output_is_empty_or_a_checked_out(out):
    given = {"none": None, "good": torch.full((5,), float("nan")),
             "short": torch.zeros(4),
             "double": torch.zeros(5, dtype=torch.float64)}[out]
    if out in ("short", "double"):
        with pytest.raises(ValueError, match="out"):
            _build.output(given, 5, CPU)
        return
    y = _build.output(given, 5, CPU)
    assert y.shape == (5,) and y.dtype == torch.float32
    assert (y is given) == (out == "good")


@pytest.mark.parametrize("out", ["none", "good", "rows", "cols", "flat",
                                 "double"])
def test_output_of_a_matrix_is_empty_or_a_checked_out(out):
    # K7 and K9 write every row of C [rows, F]
    given = {"none": None, "good": torch.full((3, 5), float("nan")),
             "rows": torch.zeros(4, 5), "cols": torch.zeros(3, 4),
             "flat": torch.zeros(15),
             "double": torch.zeros(3, 5, dtype=torch.float64)}[out]
    if out not in ("none", "good"):
        with pytest.raises(ValueError, match="out"):
            _build.output(given, (3, 5), CPU)
        return
    C = _build.output(given, (3, 5), CPU)
    assert C.shape == (3, 5) and C.dtype == torch.float32
    assert (C is given) == (out == "good")


def _bcsr_binds():
    """K6, K9, K7 and K8 (f32 and bf16) and K10 bound on the CPU: (name,
    bufs, fn, the wrapper's check of its staged buffers, its
    parameters)."""
    csr = generate.random_csr(40, 300, 0.05, seed=4)
    bcsr = BCSR.from_csr(csr, 8, 128)
    b6, f6 = spmv_bcsr.bcsr_spmv(bcsr, device=CPU)
    yield "K6", b6, f6, spmv_bcsr.check_staged, f6.params
    b9, f9 = spmm_bcsr.bcsr_spmm(bcsr, device=CPU)
    yield "K9", b9, f9, spmm_bcsr.check_staged, f9.params
    for dtype in (None, "bfloat16"):
        b7, f7 = spmm_bcsr_v3.bcsr_spmm_v3(bcsr, dtype=dtype, device=CPU)
        yield f"K7 {dtype}", b7, f7, spmm_bcsr_v3.check_staged, f7.meta
        b8, f8 = spmm_bcsr_v2.bcsr_spmm_v2(bcsr, dtype=dtype, device=CPU)
        yield f"K8 {dtype}", b8, f8, spmm_bcsr_v2.check_staged, f8.meta
    b10, f10 = sddmm_bcsr.sddmm_bcsr(bcsr, device=CPU)
    yield "K10", b10, f10, sddmm_bcsr.check_staged, f10.meta


@pytest.mark.parametrize("change", ["none", "resize", "set", "dtype",
                                    "replaced"])
def test_k7_k9_check_staged_buffers_changed_again(change):
    # each checks its staged buffers once at bind; a call skips the check
    # only for the very tensors checked then, none changed in place since,
    # and the full check then refuses what changed
    names = []
    for name, b, fn, check_staged, params in _bcsr_binds():
        names.append(name)
        check_staged(b, params, CPU)
        key = "ccol" if name.startswith("K7") else "bcols"
        if change == "resize":
            b[key].resize_(b[key].numel() - 1)
        elif change == "set":
            b[key].set_(torch.zeros(2, dtype=torch.int32))
        elif change == "dtype":
            b[key] = b[key].long()
        elif change == "replaced":
            b[key] = b[key].clone()
        assert fn.staged_on(b) == (CPU if change == "none" else None), name
        if change in ("resize", "set", "dtype"):
            with pytest.raises(ValueError, match=key):
                check_staged(b, params, CPU)
        else:
            check_staged(b, params, CPU)
    assert names == ["K6", "K9", "K7 None", "K8 None", "K7 bfloat16",
                     "K8 bfloat16", "K10"]


@pytest.mark.parametrize("kernel,buf", [
    *(("K8", k) for k in ("vals", "bcols", "brow", "offsets")),
    *(("K10", k) for k in ("vals", "bcols", "brow", "perm", "gptr"))])
def test_k8_k10_check_every_staged_buffer(kernel, buf):
    # every buffer the kernel reads is in its check: one of another size
    # or type is refused by name
    binds = [x for x in _bcsr_binds() if x[0].startswith(kernel)]
    assert binds
    for name, b, fn, check_staged, params in binds:
        assert sorted(b) == sorted(
            ("vals", "bcols", "brow", "offsets") if kernel == "K8"
            else ("vals", "bcols", "brow", "perm", "gptr"))
        check_staged(b, params, CPU)
        bad = dict(b)
        bad[buf] = b[buf][:-1]
        assert fn.staged_on(bad) is None
        with pytest.raises(ValueError, match=buf):
            check_staged(bad, params, CPU)
        bad[buf] = b[buf].double()
        with pytest.raises(ValueError, match=buf):
            check_staged(bad, params, CPU)


@pytest.mark.parametrize("buf", ["vals", "bcols", "offsets", "runs",
                                 "splits"])
def test_k6_checks_every_staged_buffer(buf):
    # K6's BCSR arrays and its plan (runs, cut block rows) are all in its
    # check: one of another size or type is refused by name
    (name, b, fn, check_staged, params), = [
        x for x in _bcsr_binds() if x[0] == "K6"]
    assert sorted(b) == ["bcols", "offsets", "runs", "splits", "vals"]
    check_staged(b, params, CPU)
    bad = dict(b)
    bad[buf] = b[buf].reshape(-1)[:-1]
    assert fn.staged_on(bad) is None
    with pytest.raises(ValueError, match=buf):
        check_staged(bad, params, CPU)
    bad[buf] = b[buf].double()
    with pytest.raises(ValueError, match=buf):
        check_staged(bad, params, CPU)


class _PosingAsCuda(torch.Tensor):
    """A CPU tensor that a wrapper's ``x.is_cuda`` takes for a card's."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("out", ["none", "good", "short", "double",
                                 "matrix", "device"])
def test_k6_launch_takes_a_checked_out(fake_card, out):
    # K6 writes y into a torch.empty or a checked out= of rows float32
    # values, and passes its buffers, plan sizes and x's alignment to its
    # entry point; the staged buffers checked at bind are not read again
    csr = generate.sized_csr([2] * 16 + [300] * 8 + [0] * 9, 1500, seed=24)
    b = spmv_bcsr.stage_runs(BCSR.from_csr(csr, 8, 128), CPU, 4)
    p = spmv_bcsr.plan_params(b, csr.shape)
    assert p["nsplit"] >= 1 and p["nruns"] == b["runs"].shape[1] - 1
    x = torch.ones(1500).as_subclass(_PosingAsCuda)
    given = {"none": None, "good": torch.full((33,), float("nan")),
             "short": torch.zeros(32),
             "double": torch.zeros(33, dtype=torch.float64),
             "matrix": torch.zeros(33, 1),
             "device": torch.zeros(33, device="meta")}[out]
    before = _build.LAUNCHES["bcsr_spmv"]
    if out in ("short", "double", "matrix", "device"):
        with pytest.raises(ValueError, match="out"):
            spmv_bcsr.bcsr_spmv_cuda(b, x, csr.shape, CPU, given, p)
        assert _build.LAUNCHES["bcsr_spmv"] == before
        return
    y = spmv_bcsr.bcsr_spmv_cuda(b, x, csr.shape, CPU, given, p)
    assert y.shape == (33,) and (y is given) == (out == "good")
    assert _build.LAUNCHES["bcsr_spmv"] == before + 1
    args = fake_card["stub"].calls("loops_bcsr_spmv_f32")[-1]
    ptrs = [b[k].data_ptr() for k in ("offsets", "bcols", "runs", "splits",
                                      "vals")]
    assert list(args[:5]) == ptrs and args[5] == x.data_ptr()
    assert args[6] == y.data_ptr() and args[7] != y.data_ptr()  # seam
    assert args[8:14] == (p["nruns"], p["nsplit"], 8, 33, 1500, 1)
    assert args[14] == 4242


@pytest.mark.parametrize("buf", ["perm", "seg"])
@pytest.mark.parametrize("change", ["none", "resize", "set", "dtype",
                                    "replaced"])
def test_l2_scatter_checks_its_plan_once(change, buf):
    # K14's L2 scatter checks its staged plan at bind; a call skips the
    # check only for the very tensors checked then, none changed in place
    # since, and the full check then refuses what changed
    from loops_tpu_torch.probes import r2

    offs, _ = r2.scatter_inputs(512, 4)
    b, fn = r2.l2_scatter(offs, 512, device=CPU)
    r2.check_plan(b, fn.meta, CPU)
    if change == "resize":
        b[buf].resize_(b[buf].numel() - 1)
    elif change == "set":
        b[buf].set_(torch.zeros(2, dtype=torch.int32))
    elif change == "dtype":
        b[buf] = b[buf].long()
    elif change == "replaced":
        b[buf] = b[buf].clone()
    assert fn.staged_on(b) == (CPU if change == "none" else None)
    if change in ("resize", "set", "dtype"):
        with pytest.raises(ValueError, match=buf):
            r2.check_plan(b, fn.meta, CPU)
    else:
        r2.check_plan(b, fn.meta, CPU)


@pytest.mark.parametrize("case", ["cpu", "meta"])
def test_k12_keeps_every_refusal(case):
    # saxpy() passes staged operands to saxpy_cuda as they are; its
    # refusals stand, before any launch
    from loops_tpu_torch.ops.kernels import saxpy

    x = torch.ones(8, device=case)
    before = _build.LAUNCHES["saxpy"]
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        saxpy.saxpy_cuda(2.0, x, x)
    assert _build.LAUNCHES["saxpy"] == before


def test_k12_device_is_checked_once_per_value(monkeypatch):
    from loops_tpu_torch.ops.kernels import saxpy

    asked = []

    def ensure(device):
        asked.append(device)
        return torch.device(device)
    monkeypatch.setattr(saxpy, "ensure_platform", ensure)
    monkeypatch.setattr(saxpy, "_DEVICES", {})
    x, y = torch.arange(6.0), torch.ones(6)
    for _ in range(3):
        assert torch.equal(saxpy.saxpy(2.5, x, y, "cpu"),
                           saxpy.saxpy_plain(2.5, x, y))
    saxpy.saxpy(2.5, x.numpy(), y.numpy(), CPU)
    assert asked == ["cpu", CPU]
    # operands already staged on a card go to saxpy_cuda as they are;
    # anything else (CPU tensors, arrays, other types) is converted first
    assert not saxpy._staged(x, y, CUDA0)
    assert not saxpy._staged(x.numpy(), y, CUDA0)


class _PosingAsCuda0(torch.Tensor):
    """A CPU tensor that ``saxpy_cuda`` takes for one on card 0."""

    @property
    def is_cuda(self):
        return True

    def get_device(self):
        return 0


@pytest.mark.parametrize("offset", [0, 1, 3, "differ"])
def test_k12_launch_is_one_c_call_of_plain_ints(fake_card, offset):
    # a, the three addresses, n, the grid and the stream; out a new tensor
    # of its own, on 16 bytes, whatever x's and y's offsets
    from loops_tpu_torch.ops.kernels import saxpy

    n = 5000
    k = 1 if offset == "differ" else offset
    xb, yb = torch.arange(n + 4.0), torch.ones(n + 4)
    assert xb.data_ptr() % 16 == 0 and yb.data_ptr() % 16 == 0
    x = xb[k:k + n].as_subclass(_PosingAsCuda0)
    y = (yb[:n] if offset == "differ" else yb[k:k + n]).as_subclass(
        _PosingAsCuda0)
    before = _build.LAUNCHES["saxpy"]
    out = saxpy.saxpy_cuda(2.5, x, y)
    (args,) = fake_card["stub"].calls("loops_saxpy_f32")
    assert args == (2.5, x.data_ptr(), y.data_ptr(), out.data_ptr(), n,
                    saxpy.grid(n), 4242)
    assert _build.LAUNCHES["saxpy"] == before + 1
    assert out.shape == x.shape and out.data_ptr() not in (
        x.data_ptr(), y.data_ptr())
    assert out.data_ptr() % 16 == 0 and out.storage_offset() == 0
    assert fake_card["switches"] == []


def _k1_launch(monkeypatch):
    """K1 planned and staged on the CPU, and its ``SortedLaunch`` made as
    the bind makes it on a card (132 SMs)."""
    monkeypatch.setitem(_build._SMS, 0, 132)
    csr = generate.random_csr(300, 200, 0.05, seed=4)
    b, fn = spmv_sorted.sorted_spmv(csr, block_atoms=64, device=CPU)
    rows = spmv_sorted.max_block_rows(b["row_first"], b["row_last"])
    return b, fn.params, spmv_sorted.SortedLaunch(b, fn.params, CPU, rows)


def test_k1_packs_the_staged_pointers_once(fake_card, monkeypatch):
    b, p, launch = _k1_launch(monkeypatch)
    plan = launch.plan
    assert [getattr(plan, k) for k in spmv_sorted.PLAN_POINTERS] == [
        b[k].data_ptr() for k in spmv_sorted.PLAN_POINTERS]
    nb = p["num_blocks"]
    assert (plan.rows, plan.nb, plan.lanes_per_row) == (
        300, nb, p["lanes_per_row"])
    assert (plan.grid, plan.piece, plan.window) == (
        min(nb, 3 * 132), launch.shape["piece"], launch.shape["window"])
    assert plan.piece == 64 and plan.window % 4 == 0
    assert launch.plan_ptr == ctypes.addressof(plan)
    # the C struct: six pointers, then six ints
    assert ctypes.sizeof(spmv_sorted._SortedPlan) == 6 * 8 + 6 * 4


@pytest.mark.parametrize("out", ["none", "good", "short"])
def test_k1_apply_is_one_c_call(fake_card, monkeypatch, out):
    # an apply passes the packed plan, x, y and its stream's scratch, and
    # checks only x (and out): four pointers and the stream
    b, p, launch = _k1_launch(monkeypatch)
    x = torch.ones(200).as_subclass(_PosingAsCuda)
    given = {"none": None, "good": torch.full((300,), float("nan")),
             "short": torch.zeros(299)}[out]
    before = _build.LAUNCHES["sorted_spmv"]
    if out == "short":
        with pytest.raises(ValueError, match="out"):
            launch(x, given)
        assert fake_card["stub"].calls() == []
        return
    y = launch(x, given)
    assert y.shape == (300,) and (y is given) == (out == "good")
    (args,) = fake_card["stub"].calls("loops_sorted_spmv_f32")
    scratch, _ = launch.scratch[4242]
    assert args == (launch.plan_ptr, x.data_ptr(), y.data_ptr(),
                    scratch.data_ptr(), 4242)
    assert _build.LAUNCHES["sorted_spmv"] == before + 1
    with pytest.raises(ValueError, match="x has 199"):
        launch(torch.ones(199).as_subclass(_PosingAsCuda))
    assert len(fake_card["stub"].calls()) == 1


def test_k1_scratch_per_stream(fake_card, monkeypatch):
    # one zeroed scratch set (the ticket, the range prefixes, the block
    # partials) per stream, made at the first launch there, kept after
    b, p, launch = _k1_launch(monkeypatch)
    x = torch.ones(200).as_subclass(_PosingAsCuda)
    for handle in (4242, 4242, 11, 4242, 11):
        fake_card["streams"][0] = handle
        launch(x)
    assert sorted(launch.scratch) == [11, 4242]
    calls = fake_card["stub"].calls("loops_sorted_spmv_f32")
    want = {h: launch.scratch[h][0].data_ptr() for h in (11, 4242)}
    assert [c[3] for c in calls] == [want[c[4]] for c in calls]
    assert [c[4] for c in calls] == [4242, 4242, 11, 4242, 11]
    for t, ptr in launch.scratch.values():
        assert t.dtype == torch.int32 and not t.any()
        assert t.numel() == 4 + launch.shape["grid"] + p["num_blocks"]
        assert ptr == t.data_ptr()


@pytest.mark.parametrize("change", ["none", "write", "data", "storage",
                                    "inference"])
def test_staged_guard_sees_memory_moved_or_written(change):
    # the guard's fingerprint is each buffer's version counter and
    # address: an in-place write, a tensor's memory replaced (.data =) or
    # its storage resized all make the wrapper check the buffers again;
    # inference tensors keep no version counter and are fingerprinted by
    # address, size, type and contiguity
    checked = []
    if change == "inference":
        with torch.inference_mode():
            bufs = {"vals": torch.zeros(6),
                    "cols": torch.zeros(6, dtype=torch.int32)}
    else:
        bufs = {"vals": torch.zeros(6),
                "cols": torch.zeros(6, dtype=torch.int32)}
    staged_on = _build.staged_guard(bufs, {},
                                    lambda b, p, d: checked.append(d))
    assert staged_on(bufs) == CPU
    if change == "write":
        bufs["vals"].add_(1)
    elif change == "data":
        bufs["cols"].data = torch.zeros(6, dtype=torch.int32)
    elif change == "storage":
        bufs["vals"].untyped_storage().resize_(0)
    elif change == "inference":
        with torch.inference_mode():
            bufs["vals"].resize_(3)
    assert staged_on(bufs) == (CPU if change == "none" else None)
