"""The CUDA kernels of ``loops_tpu_torch`` on the card: each kernel against
its plain PyTorch version on the same staged buffers, two runs bitwise
equal, the launch counter, and the wrappers' input checks.

Every test here needs an NVIDIA card and skips without one. The file
imports neither JAX nor ``loops_tpu``, so it runs on a machine that has
only PyTorch; ``tests/conftest.py`` imports JAX, so run it there with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

The tolerance against the plain version is ``rtol=1e-5, atol=1e-6``: the
kernels sum each row in f32 in another order (lane-strided partials and
shuffle trees, warp scans) than the plain versions.
"""
import contextlib

import numpy as np
import pytest
import torch

from loops_tpu_torch.layout import CsrLayout
from loops_tpu_torch.ops.kernels import _build, spmv_flat, spmv_flat_v2, spmv_sorted
from loops_tpu_torch.ops.spmv import SpMVOperator
from loops_tpu_torch.schedule.plans import (
    choose_schedule,
    make_plan,
    thresholds_for,
)
from loops_tpu_torch.tuning.sweep import IMPL_USED
from loops_tpu_torch.utils import generate, reference

RTOL, ATOL = 1e-5, 1e-6

# the 9-matrix battery of tests/test_spmv_battery.py, plus a long-row case
BATTERY = {
    **generate.BATTERY,
    "long_rows": lambda: generate.skewed_csr(30, 3000, heavy_rows=2,
                                             heavy_nnz=2500, seed=4),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _builds(csr, block, device):
    plan = make_plan(CsrLayout.from_csr(csr), "merge_path", block_work=block)
    return {
        "sorted_spmv": (spmv_sorted.sorted_spmv(csr, block_atoms=block,
                                                device=device),
                        spmv_sorted.sorted_spmv_plain),
        "flat_spmv_v2": (spmv_flat_v2.flat_spmv_v2(csr, plan, device=device),
                         spmv_flat_v2.flat_spmv_v2_plain),
        "flat_spmv": (spmv_flat.flat_spmv(csr, plan, device=device),
                      spmv_flat.flat_spmv_plain),
    }


def _plain_args(kname, fn, csr):
    if kname == "sorted_spmv":
        return (None,)
    if kname == "flat_spmv_v2":
        return (csr.shape,)
    return (csr.shape, fn.meta["R"])


@pytest.mark.cuda
@pytest.mark.parametrize("block", [8, 1024])
@pytest.mark.parametrize("name", sorted(BATTERY))
def test_kernels_match_plain(cuda_device, name, block):
    csr = BATTERY[name]()
    x = generate.make_input_vector(csr.shape[1])
    xd = torch.from_numpy(x).to(cuda_device)
    for kname, ((b, fn), plain) in _builds(csr, block, cuda_device).items():
        before = _build.LAUNCHES[kname]
        y1 = fn(b, xd)
        y2 = fn(b, xd)
        torch.cuda.synchronize()
        assert _build.LAUNCHES[kname] == before + 2, kname
        assert torch.equal(y1, y2), f"{kname}/{name}: two runs differ"
        y_plain = plain(b, xd, *_plain_args(kname, fn, csr))
        tol = (dict(rtol=1e-4, atol=1e-3) if name == "long_rows"
               else dict(rtol=RTOL, atol=ATOL))
        np.testing.assert_allclose(y1.cpu().numpy(), y_plain.cpu().numpy(),
                                   err_msg=f"{kname}/{name}", **tol)
        rep = reference.rigorously_validate_spmv(csr, x, y1.cpu().numpy())
        assert rep.verdict == "NOT_A_BUG", f"{kname}/{name}: {rep}"


@pytest.mark.cuda
@pytest.mark.parametrize("schedule,impl,kname", [
    ("merge_path", "pallas", "flat_spmv"),
    ("merge_path", "pallas2", "flat_spmv_v2"),
    ("sorted_flat", "xla", "sorted_spmv"),
    ("auto", "xla", None)])
def test_operator_launches_kernel(cuda_device, schedule, impl, kname):
    csr = generate.random_csr(3000, 2500, 0.004, seed=7)
    x = generate.make_input_vector(2500)
    op = SpMVOperator(csr, schedule, impl=impl, device=cuda_device)
    if kname is None:  # auto: the card row's pick, run by its swept impl
        row = thresholds_for(cuda_device)
        pick = choose_schedule(CsrLayout.from_csr(csr), row)
        assert op.schedule == pick
        kname = IMPL_USED[row.get("impl", {}).get(pick, "pallas3")]
        if kname == "torch":
            pytest.skip(f"the card's row runs {pick} with torch ops here")
    assert op.impl_used == kname
    y = op(x).cpu().numpy()
    assert op.launches == 1
    rep = reference.rigorously_validate_spmv(csr, x, y)
    assert rep.verdict == "NOT_A_BUG", rep
    # one launch per apply, from a staged tensor too
    y2 = op(torch.from_numpy(x).to(cuda_device))
    assert op.launches == 2
    assert torch.equal(y2.cpu(), torch.from_numpy(y))


@pytest.mark.cuda
def test_wrappers_check_inputs(cuda_device):
    csr = BATTERY["random"]()
    b, fn = spmv_sorted.sorted_spmv(csr, device=cuda_device)
    with pytest.raises(ValueError):
        fn(b, torch.zeros(csr.shape[1], dtype=torch.float64,
                          device=cuda_device))
    with pytest.raises(ValueError):
        fn(b, torch.zeros(csr.shape[1] + 1, device=cuda_device))
    with pytest.raises(ValueError):
        fn(b, torch.zeros(2 * csr.shape[1], device=cuda_device)[::2])
    # buffers other than the ones checked at bind are checked at the call
    for key, bad in (("vals", b["vals"].double()), ("cols", b["cols"][:-1]),
                     ("cuts", b["cuts"].cpu()),
                     ("offsets", b["offsets"].repeat(2)[::2])):
        with pytest.raises(ValueError, match=key):
            fn({**b, key: bad}, torch.zeros(csr.shape[1], device=cuda_device))
    # and a buffer replaced in the staged dict itself
    b["vals"] = b["vals"].double()
    with pytest.raises(ValueError, match="vals"):
        fn(b, torch.zeros(csr.shape[1], device=cuda_device))
    plan = make_plan(CsrLayout.from_csr(csr), "merge_path", block_work=8)
    b2, fn2 = spmv_flat_v2.flat_spmv_v2(csr, plan, device=cuda_device)
    with pytest.raises(ValueError):
        fn2(b2, torch.zeros(csr.shape[1] + 1, device=cuda_device))
    b3, fn3 = spmv_flat.flat_spmv(csr, plan, device=cuda_device)
    with pytest.raises(ValueError):
        fn3(b3, torch.zeros(2 * csr.shape[1], device=cuda_device)[::2])


@pytest.mark.cuda
@pytest.mark.parametrize("change", ["resize", "set"])
def test_sorted_buffers_changed_in_place_raise(cuda_device, change):
    # a staged buffer changed in place keeps its identity: K1 sees the
    # change and checks its buffers again rather than read past them
    csr = BATTERY["random"]()
    b, fn = spmv_sorted.sorted_spmv(csr, device=cuda_device)
    if change == "resize":
        b["cols"].resize_(0)
    else:
        b["vals"].set_(torch.zeros(3, device=cuda_device))
    with pytest.raises(ValueError, match="cols"):
        fn(b, torch.zeros(csr.shape[1], device=cuda_device))


def _flat_build(kernel, csr, plan, device):
    """K2 or K3 on one plan: ``(bufs, fn, run into out, plain)``."""
    if kernel == "flat_spmv_v2":
        b, fn = spmv_flat_v2.flat_spmv_v2(csr, plan, device=device)
        return (b, fn,
                lambda xd, out: spmv_flat_v2.flat_spmv_v2_cuda(
                    b, xd, fn.params, out=out),
                lambda xd: spmv_flat_v2.flat_spmv_v2_plain(b, xd, csr.shape))
    b, fn = spmv_flat.flat_spmv(csr, plan, device=device)
    return (b, fn,
            lambda xd, out: spmv_flat.flat_spmv_cuda(b, xd, fn.params,
                                                     out=out),
            lambda xd: spmv_flat.flat_spmv_plain(b, xd, csr.shape,
                                                 fn.meta["R"]))


def _flat_holds(kernel, csr, plan, device, label, tol=None):
    """Two applies and one into a NaN-filled ``out`` bitwise equal, every
    row written, the plain version within ``tol``, the Wilkinson verdict,
    one launch an apply."""
    x = generate.make_input_vector(csr.shape[1])
    xd = torch.from_numpy(x).to(device)
    b, fn, into, plain = _flat_build(kernel, csr, plan, device)
    before = _build.LAUNCHES[kernel]
    y1 = fn(b, xd)
    y2 = fn(b, xd)
    out = torch.full((csr.shape[0],), float("nan"), device=device)
    y3 = into(xd, out)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[kernel] == before + 3, label
    assert y3.data_ptr() == out.data_ptr()
    assert torch.equal(y1, y2), f"{label}: two applies differ"
    assert torch.equal(y1, y3), f"{label}: the apply into NaN differs"
    assert not torch.isnan(y3).any(), f"{label}: a row left unwritten"
    np.testing.assert_allclose(
        y3.cpu().numpy(), plain(xd).cpu().numpy(), err_msg=label,
        **(tol or dict(rtol=RTOL, atol=ATOL)))
    rep = reference.rigorously_validate_spmv(csr, x, y3.cpu().numpy())
    assert rep.verdict == "NOT_A_BUG", f"{label}: {rep}"


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["flat_spmv_v2", "flat_spmv"])
@pytest.mark.parametrize("block", [8, 64])
@pytest.mark.parametrize("name", sorted(generate.SPMV_EDGE_CASES))
def test_flat_writes_every_row(cuda_device, kernel, name, block):
    # y comes from torch.empty: K2 and K3 run into NaN-filled memory show
    # a row they leave unwritten (empty rows between blocks, blocks
    # without atoms, before the first and after the last)
    csr = generate.SPMV_EDGE_CASES[name]()
    plan = make_plan(CsrLayout.from_csr(csr), "merge_path", block_work=block)
    _flat_holds(kernel, csr, plan, cuda_device, f"{kernel}/{name}/{block}")


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["flat_spmv_v2", "flat_spmv"])
@pytest.mark.parametrize("block", [4096, 8192])
@pytest.mark.parametrize("name", ["random", "long_rows", "tridiag"])
def test_flat_blocks_past_a_piece(cuda_device, kernel, name, block):
    # blocks of more slots than K3's piece and K2's chunk (2048): runs
    # carried from piece to piece and from chunk to chunk
    csr = {"random": lambda: generate.random_csr(700, 600, 0.03, seed=5),
           "long_rows": lambda: generate.skewed_csr(30, 6000, heavy_rows=2,
                                                    heavy_nnz=5000, seed=6),
           "tridiag": lambda: generate.tridiag_csr(3000)}[name]()
    plan = make_plan(CsrLayout.from_csr(csr), "merge_path", block_work=block)
    assert int(np.diff(plan.atom_starts).max()) > spmv_flat.PIECE
    _flat_holds(kernel, csr, plan, cuda_device, f"{kernel}/{name}/{block}",
                dict(rtol=1e-4, atol=1e-3) if name == "long_rows" else None)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["flat_spmv_v2", "flat_spmv"])
@pytest.mark.parametrize("change", ["resize", "set", "replaced"])
def test_flat_buffers_changed_after_bind_raise(cuda_device, kernel, change):
    # K2 and K3 skip their buffer checks only for the tensors checked at
    # bind, none changed in place since
    csr = BATTERY["random"]()
    plan = make_plan(CsrLayout.from_csr(csr), "merge_path", block_work=32)
    b, fn, _, _ = _flat_build(kernel, csr, plan, cuda_device)
    if change == "resize":
        b["cols"].resize_(0)
    elif change == "set":
        b["cols"].set_(torch.zeros(3, dtype=torch.int32, device=cuda_device))
    else:
        b["cols"] = b["cols"].double()
    with pytest.raises(ValueError, match="cols"):
        fn(b, torch.zeros(csr.shape[1], device=cuda_device))


@pytest.mark.cuda
def test_flat_window_past_default_shared_memory(cuda_device):
    # a 40064-float row window (157 KB of f32), one block over 40000 rows
    # of which two hold atoms
    csr = generate.wide_span_csr(40_000)
    x = generate.make_input_vector(4)
    plan = make_plan(CsrLayout.from_csr(csr), "work_oriented", block_atoms=8)
    b, fn = spmv_flat.flat_spmv(csr, plan, device=cuda_device)
    assert 48 * 1024 < 4 * fn.meta["R"] <= 4 * spmv_flat.MAX_WINDOW
    xd = torch.from_numpy(x).to(cuda_device)
    y = fn(b, xd)
    assert torch.equal(y, spmv_flat.flat_spmv_plain(b, xd, csr.shape,
                                                    fn.meta["R"]))
    rep = reference.rigorously_validate_spmv(csr, x, y.cpu().numpy())
    assert rep.verdict == "NOT_A_BUG", rep
    # K2 on the same plan, and both into NaN: the block zeroes the rows
    # between its two
    for kernel in ("flat_spmv_v2", "flat_spmv"):
        _flat_holds(kernel, csr, plan, cuda_device, f"{kernel}/wide")


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["pallas", "pallas2", "pallas3"])
def test_kernel_refusals_raise_on_cuda(cuda_device, impl):
    # a kernel request the kernels cannot honor never runs torch ops on
    # the card
    f64 = generate.random_csr(20, 18, 0.25, seed=13, dtype=np.float64)
    with pytest.raises(ValueError, match="float64"):
        SpMVOperator(f64, "merge_path", block=8, impl=impl,
                     device=cuda_device)
    wide = generate.wide_span_csr(spmv_flat.MAX_WINDOW + 1)
    if impl == "pallas":
        with pytest.raises(ValueError, match="row window"):
            SpMVOperator(wide, "work_oriented", block=8, impl=impl,
                         device=cuda_device)
    assert SpMVOperator(f64, "merge_path", block=8, impl="xla",
                        device=cuda_device).impl_used == "torch"


@pytest.mark.cuda
def test_auto_on_f64_runs_torch_and_sorted_flat_raises(cuda_device):
    # auto is not a kernel request: on float64 values it warns and runs
    # the torch merge-path executor on the card; an explicit sorted_flat
    # asks for K1, and its refusal names schedule='merge_path'
    f64 = generate.random_csr(20, 18, 0.25, seed=13, dtype=np.float64)
    x = generate.make_input_vector(18, dtype=np.float64)
    row = thresholds_for(cuda_device)
    pick = choose_schedule(CsrLayout.from_csr(f64), row)
    # a pick the card's row runs by a kernel warns and takes torch ops
    kernel = (pick == "sorted_flat"
              or row.get("impl", {}).get(pick, "xla") != "xla")
    with (pytest.warns(UserWarning, match="float64") if kernel
          else contextlib.nullcontext()):
        op = SpMVOperator(f64, "auto", block=8, device=cuda_device)
    assert op.schedule == pick and op.impl_used == "torch"
    before = dict(_build.LAUNCHES)
    y = op(x)
    torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == before and op.launches == 0
    assert y.dtype == torch.float64 and y.device.type == "cuda"
    np.testing.assert_allclose(y.cpu().numpy(),
                               reference.spmv(f64, x, dtype=np.float64),
                               rtol=1e-12, atol=1e-12)
    for impl in ("xla", "pallas3"):
        with pytest.raises(ValueError, match="schedule='merge_path'"):
            SpMVOperator(f64, "sorted_flat", impl=impl, device=cuda_device)


def _sorted_case(csr, block, device):
    x = generate.make_input_vector(csr.shape[1])
    b, fn = spmv_sorted.sorted_spmv(csr, block_atoms=block, device=device)
    return x, torch.from_numpy(x).to(device), b, fn


def _into_nan(b, xd, fn):
    """K1 into a y filled with NaN: a row it leaves unwritten shows."""
    out = torch.full((fn.params["rows"],), float("nan"), device=xd.device)
    y = spmv_sorted.sorted_spmv_cuda(b, xd, fn.params, out=out)
    assert y.data_ptr() == out.data_ptr()
    return y


def _holds_plain(csr, x, y, b, xd, label):
    assert not torch.isnan(y).any(), f"{label}: a row left unwritten"
    np.testing.assert_allclose(
        y.cpu().numpy(), spmv_sorted.sorted_spmv_plain(b, xd, None).cpu()
        .numpy(), rtol=RTOL, atol=ATOL, err_msg=label)
    rep = reference.rigorously_validate_spmv(csr, x, y.cpu().numpy())
    assert rep.verdict == "NOT_A_BUG", f"{label}: {rep}"


@pytest.mark.cuda
@pytest.mark.parametrize("block", [8, 64])
@pytest.mark.parametrize("name", sorted(generate.SPMV_EDGE_CASES))
def test_sorted_writes_every_row(cuda_device, name, block):
    # y comes from torch.empty: K1 run into NaN-filled memory shows a row
    # it leaves unwritten (empty rows between blocks, before the first and
    # after the last)
    csr = generate.SPMV_EDGE_CASES[name]()
    x, xd, b, fn = _sorted_case(csr, block, cuda_device)
    y1 = fn(b, xd)
    y2 = fn(b, xd)
    y3 = _into_nan(b, xd, fn)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2), f"{name}: two applies differ"
    assert torch.equal(y1, y3), f"{name}: the apply into NaN differs"
    _holds_plain(csr, x, y3, b, xd, f"{name}/{block}")


@pytest.mark.cuda
def test_sorted_span_past_the_offsets_window(cuda_device, monkeypatch):
    # no stripe cuts the ladder, so one block outruns the kernel's
    # 1024-row window of offsets, which it then reads from device memory
    monkeypatch.setattr(spmv_sorted, "STRIPE_ROWS", 1 << 30)
    csr = generate.ladder_csr()
    x, xd, b, fn = _sorted_case(csr, 8192, cuda_device)
    assert int((b["row_last"] - b["row_first"]).max()) >= 1024
    _holds_plain(csr, x, _into_nan(b, xd, fn), b, xd, "ladder")


@pytest.mark.cuda
def test_sorted_on_a_side_stream(cuda_device):
    # a launch under torch.cuda.stream(s) goes on s: there it waits for
    # the product that makes its x, which the card holds back on s; on
    # any other stream it would read x before that product is written
    csr = generate.random_csr(3000, 2500, 0.004, seed=7)
    x, xd, b, fn = _sorted_case(csr, 8192, cuda_device)
    y0 = fn(b, xd)
    torch.cuda.synchronize()
    s = torch.cuda.Stream(cuda_device)
    s.wait_stream(torch.cuda.current_stream(cuda_device))
    with torch.cuda.stream(s):
        torch.cuda._sleep(50_000_000)
        x2 = xd * 2.0
        y1 = fn(b, x2)
    s.synchronize()
    # doubling is exact: every product and sum of y0, doubled
    assert torch.equal(y1, y0 * 2.0)


@pytest.mark.cuda
def test_device_ms_sees_the_card_alone(cuda_device):
    # on a small matrix the launch path is slower than the kernel: applies
    # back to back wait for the host, applies queued behind a sleep do not
    from loops_tpu_torch.utils.bench import apply_ms, device_ms

    csr = generate.random_csr(2048, 2048, 4 / 2048, seed=9)
    op = SpMVOperator(csr, "sorted_flat", device=cuda_device)
    xd = torch.from_numpy(generate.make_input_vector(2048)).to(cuda_device)
    card, wall = device_ms(op, xd), apply_ms(op, xd)
    assert 0 < card < wall


def _k1_holds_mirror(csr, block, device, label):
    """K1 at its launch shape into NaN-filled memory: bit for bit
    ``sorted_spmv_mirror``, a second apply bitwise equal, one launch per
    apply. Returns the bound function."""
    x, xd, b, fn = _sorted_case(csr, block, device)
    launch = fn.launch
    before = _build.LAUNCHES["sorted_spmv"]
    out = torch.full((fn.params["rows"],), float("nan"), device=device)
    y1 = launch(xd, out)
    y2 = launch(xd)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["sorted_spmv"] == before + 2, label
    assert y1.data_ptr() == out.data_ptr()
    assert torch.equal(y1, y2), f"{label}: two applies differ"
    a = {k: v.cpu().numpy() for k, v in b.items()}
    want = spmv_sorted.sorted_spmv_mirror(a, fn.params, x,
                                          launch.shape["grid"],
                                          launch.shape["piece"])
    np.testing.assert_array_equal(y1.cpu().numpy().view(np.uint32),
                                  want.view(np.uint32), err_msg=label)
    return fn


# the kernel's own launch shape, and (a card of 1 or 2 SMs, pieces of at
# most 8 atoms) ranges of several blocks with rows cut across ranges and
# across pieces: SMs, PIECE_MAX
K1_SHAPES = {"own": (None, None), "3 CTAs": (1, None),
             "6 CTAs pieces of 8": (2, 8)}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(K1_SHAPES))
@pytest.mark.parametrize("block", [8, 64])
@pytest.mark.parametrize("name", sorted({**BATTERY,
                                         **generate.SPMV_EDGE_CASES}))
def test_sorted_equals_its_mirror(cuda_device, monkeypatch, name, block,
                                  shape):
    sms, piece = K1_SHAPES[shape]
    if sms is not None:
        monkeypatch.setitem(_build._SMS, torch.cuda.current_device(), sms)
    if piece is not None:
        monkeypatch.setattr(spmv_sorted, "PIECE_MAX", piece)
    csr = {**BATTERY, **generate.SPMV_EDGE_CASES}[name]()
    _k1_holds_mirror(csr, block, cuda_device, f"{name}/{block}/{shape}")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random", "hub", "pieces"])
def test_sorted_ranges_of_many_blocks(cuda_device, case):
    # nb several times the grid (3 CTAs on each SM): each CTA carries rows
    # from block to block, and the last one adds the seams between ranges
    # (three 20000-atom rows over many ranges in "hub"); blocks of 4096 atoms
    # are cut into pieces of 1024
    csr, block = {
        "random": (generate.random_csr(20000, 20000, 8 / 20000, seed=11), 64),
        "hub": (generate.skewed_csr(3000, 20000, heavy_rows=3,
                                    heavy_nnz=20000, seed=12), 64),
        "pieces": (generate.random_csr(20000, 20000, 8 / 20000, seed=13),
                   4096)}[case]
    fn = _k1_holds_mirror(csr, block, cuda_device, case)
    shape, nb = fn.launch.shape, fn.params["num_blocks"]
    assert shape["grid"] == min(nb, 3 * _build.sm_count(cuda_device))
    if case == "random":
        assert nb >= 3 * shape["grid"]
    elif case == "hub":  # each heavy row over 312 blocks, ~120 ranges
        assert nb > 2 * shape["grid"] and csr.row_sizes().max() > 300 * 64
    else:
        assert shape["piece"] == 1024 < fn.params["max_atoms"]


@pytest.mark.cuda
def test_sorted_scratch_per_stream(cuda_device):
    # one scratch set per stream K1 runs on, made at its first launch
    # there; a side stream's applies equal the current stream's
    csr = generate.random_csr(3000, 2500, 0.004, seed=7)
    x, xd, b, fn = _sorted_case(csr, 64, cuda_device)
    y0 = fn(b, xd)
    y0b = fn(b, xd)
    assert len(fn.launch.scratch) == 1
    s = torch.cuda.Stream(cuda_device)
    s.wait_stream(torch.cuda.current_stream(cuda_device))
    with torch.cuda.stream(s):
        y1 = fn(b, xd)
        y2 = fn(b, xd)
    s.synchronize()
    assert len(fn.launch.scratch) == 2
    assert s.cuda_stream in fn.launch.scratch
    assert torch.equal(y0, y0b) and torch.equal(y0, y1)
    assert torch.equal(y1, y2)


@pytest.mark.cuda
def test_sorted_one_kernel_per_apply_in_the_trace(cuda_device, tmp_path):
    # the kernel record holds one K1 launch per apply, and the profiler's
    # list has no seam pass beside it
    from loops_tpu_torch.utils import trace

    csr = generate.random_csr(3000, 2500, 0.004, seed=7)
    x, xd, b, fn = _sorted_case(csr, 64, cuda_device)
    fn(b, xd)
    torch.cuda.synchronize()
    with trace.profile(str(tmp_path)):
        for _ in range(3):
            fn(b, xd)
    rec = trace.read_record(str(tmp_path))
    assert rec["counted"] == {"sorted_spmv": 3}
    assert [x["counter"] for x in rec["launches"]] == ["sorted_spmv"] * 3
    with open(tmp_path / trace.TRACE_FILE) as f:
        assert "seam_kernel" not in f.read()
