"""``loops_tpu_torch.utils.counters`` on the CPU: ``achieved`` against
``loops_tpu.utils.counters.achieved`` key for key, ``compiled_counters``
of a matmul against JAX's cost analysis, the port's operators counted by
their problem's work whatever the schedule, a kernel launch that no
formula covers refused (with stand-in kernels, as
``tests/test_torch_trace.py`` stands in for the card), and each work
formula at the shapes of ``PERF.md`` §6's cells with no matrix built.
"""
import contextlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loops_tpu.utils import counters as jax_counters
from loops_tpu_torch.formats import BCSR, COO
from loops_tpu_torch.ops.kernels import _build, saxpy
from loops_tpu_torch.ops.sddmm import SDDMMOperator
from loops_tpu_torch.ops.spmm import SpMMOperator
from loops_tpu_torch.ops.spmv import SpMVOperator
from loops_tpu_torch.utils import counters, generate

CPU = torch.device("cpu")
CUDA0 = torch.device("cuda", 0)


@pytest.mark.parametrize("c,ms", [
    ({}, 1.0),
    ({"flops": 1e9, "bytes accessed": 4e6}, 0.0),
    ({"flops": 1e9, "bytes accessed": 4e6}, -1.0),
    ({"flops": 0.0, "bytes accessed": 0.0}, 2.0),
    ({"bytes accessed": 293600236.0}, 0.3186),
    ({"flops": 16009658368.0}, 1.1991),
    ({"flops": 631083776.0, "bytes accessed": 193805976.0}, 0.3279),
    ({"flops": 3.0, "bytes accessed": 7.0, "transcendentals": 1.0}, 1e-6),
])
@pytest.mark.parametrize("hbm,peak", [(3350.0, 67.0), (819.0, 197.0),
                                      (3350.0, 989.0)])
def test_achieved_equals_jax(c, ms, hbm, peak):
    got = counters.achieved(c, ms, hbm, peak)
    want = jax_counters.achieved(c, ms, hbm, peak)
    assert sorted(got) == sorted(want)
    for k in want:
        assert math.isclose(got[k], want[k], rel_tol=1e-12), k


def test_achieved_defaults_to_the_card_rates_by_type():
    c = {"flops": 2e12, "bytes accessed": 3.35e12, "dtype": "float32"}
    got = counters.achieved(c, 1000.0)
    assert math.isclose(got["hbm_utilization"], 1.0, rel_tol=1e-12)
    assert math.isclose(got["mxu_utilization"], 2e12 / 67e12, rel_tol=1e-12)
    got = counters.achieved(dict(c, dtype="bfloat16"), 1000.0)
    assert math.isclose(got["mxu_utilization"], 2e12 / 989e12, rel_tol=1e-12)


def test_matmul_flops_equal_jax_cost_analysis():
    rng = np.random.default_rng(0)
    a, b = (rng.standard_normal((256, 256)).astype(np.float32)
            for _ in range(2))
    want = jax_counters.compiled_counters(jnp.matmul, jnp.asarray(a),
                                          jnp.asarray(b)).get("flops")
    got = counters.compiled_counters(torch.matmul, torch.from_numpy(a),
                                     torch.from_numpy(b))
    if want:
        assert got["flops"] == want
    else:
        assert got["flops"] >= 0.9 * 2 * 256 ** 3
    # A and B read once, C written once
    assert got["bytes accessed"] == 3 * 256 * 256 * 4
    assert got["dtype"] == "float32"


def test_nothing_counted_is_empty():
    assert counters.compiled_counters(lambda: 3) == {}
    assert counters.compiled_counters(lambda x: x.view(4, 4),
                                      torch.ones(16)) == {}


def _csr():
    return generate.random_csr(700, 500, 0.03, seed=11)


@pytest.mark.parametrize("impl_pairs", [
    [("merge_path", "xla"), ("group_mapped", "xla"), ("sorted_flat", "xla")],
    [("row_mapped", "xla"), ("work_oriented", "xla"),
     ("merge_path", "pallas"), ("merge_path", "pallas2")],
])
def test_spmv_counters_do_not_depend_on_the_schedule(impl_pairs):
    csr = _csr()
    x = torch.from_numpy(generate.make_input_vector(csr.shape[1]))
    want = counters.csr_spmv_work(*csr.shape, csr.nnz).counters()
    for schedule, impl in impl_pairs:
        op = SpMVOperator(csr, schedule, impl=impl, device=CPU)
        assert counters.compiled_counters(op, x) == want, (schedule, impl)
        # the same call inside any function: the formula, not its ops
        assert counters.compiled_counters(lambda v: op(v), x) == want


def test_spmv_counters_count_nonzeros_in_every_format():
    csr = _csr()
    x = torch.from_numpy(generate.make_input_vector(csr.shape[1]))
    want = counters.csr_spmv_work(*csr.shape, csr.nnz).counters()
    coo = COO(csr.shape, csr.row_ids(), csr.indices, csr.vals)
    for mat in (csr, coo):
        assert counters.compiled_counters(
            SpMVOperator(mat, "row_mapped", device=CPU), x) == want


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
@pytest.mark.parametrize("schedule,impl", [("merge_path", "pallas"),
                                           ("group_mapped", "xla"),
                                           ("row_mapped", "xla")])
def test_spmm_counters(schedule, impl, dtype):
    csr = _csr()
    B = torch.randn(csr.shape[1], 24)
    op = SpMMOperator(csr, schedule, impl=impl, dtype=dtype, device=CPU)
    got = counters.compiled_counters(op, B)
    assert got == counters.csr_spmm_work(*csr.shape, csr.nnz, 24,
                                         dtype).counters()
    assert got["dtype"] == ("bfloat16" if dtype else "float32")
    # a step around it adds its own ops' bytes and flops only
    step = counters.compiled_counters(lambda b: (op(b) * 2.0).sum(), B)
    out = csr.shape[0] * 24 * 4
    assert step["flops"] == got["flops"]
    assert step["bytes accessed"] == got["bytes accessed"] + 3 * out + 4
    # the flop counter counts no elementwise op: the type is the SpMM's
    assert step["dtype"] == got["dtype"]
    mixed = counters.compiled_counters(lambda b: op(b) @ b[:24], B)
    assert mixed["dtype"] == "float32"


def test_bcsr_and_sddmm_counters():
    csr, bcsr = generate.build_block_sparse(1024, 8, 128, 0.05, seed=2)
    x = torch.from_numpy(generate.make_input_vector(1024))
    nb, nbr = bcsr.num_blocks, bcsr.num_block_rows
    assert counters.compiled_counters(
        SpMVOperator(bcsr, "row_mapped", device=CPU), x) == \
        counters.bcsr_work(1024, 1024, nb, nbr, bcsr.nnz).counters()
    B = torch.randn(1024, 40)
    for dtype in (None, "bfloat16"):
        op = SpMMOperator(bcsr, "row_mapped", impl="pallas3", dtype=dtype,
                          device=CPU)
        assert counters.compiled_counters(op, B) == counters.bcsr_work(
            1024, 1024, nb, nbr, bcsr.nnz, 40, dtype).counters()
    A = torch.randn(1024, 40)
    assert counters.compiled_counters(
        SDDMMOperator(bcsr, device=CPU), A, B) == counters.sddmm_bcsr_work(
            1024, 1024, nb, bcsr.nnz, 40).counters()
    assert counters.compiled_counters(
        SDDMMOperator(csr, device=CPU), A, B) == counters.sddmm_flat_work(
            1024, 1024, csr.nnz, 40).counters()
    assert isinstance(bcsr, BCSR)


def test_saxpy_counters():
    x, y = torch.ones(8, 8192), torch.ones(8, 8192)
    want = counters.saxpy_work(8 * 8192).counters()
    assert counters.compiled_counters(saxpy.saxpy, 2.5, x, y, CPU) == want
    assert counters.compiled_counters(saxpy.saxpy_plain, 2.5, x, y) == want
    assert counters.compiled_counters(
        lambda: saxpy.saxpy(2.5, x, y, CPU)) == want
    # an entry point bound by name before the count is counted all the same
    plain = saxpy.saxpy_plain
    assert counters.compiled_counters(lambda: plain(2.5, x, y)) == want
    assert counters.HOOK is None  # cleared after the count


@pytest.fixture
def fake_card(monkeypatch):
    """``_build``'s function table holds stand-ins that launch nothing, and
    ``torch.cuda`` answers as a one-card machine's."""
    monkeypatch.setattr(_build, "_FNS",
                        {name: (lambda *a: 0) for name in _build._SIGNATURES})
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(_build, "_raw_stream", lambda index: 4242)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda index: contextlib.nullcontext())


def _bare_launch():
    x, y, out = torch.ones(8), torch.ones(8), torch.empty(8)
    _build.launch("loops_saxpy_f32", "saxpy", CUDA0, 2.5, x, y, out, 8, 1)


def test_a_launch_no_formula_covers_raises(fake_card):
    before = _build.LAUNCHES["saxpy"]
    with pytest.raises(RuntimeError, match="'saxpy': 1"):
        counters.compiled_counters(_bare_launch)
    # beside a counted operator, too: its formula does not cover it
    csr = _csr()
    x = torch.from_numpy(generate.make_input_vector(csr.shape[1]))
    op = SpMVOperator(csr, "row_mapped", device=CPU)
    with pytest.raises(RuntimeError, match="'saxpy': 1"):
        counters.compiled_counters(lambda v: (_bare_launch(), op(v)), x)
    assert _build.LAUNCHES["saxpy"] == before + 2
    assert counters.HOOK is None


def test_a_launch_inside_an_operator_is_its_formulas(fake_card):
    csr = _csr()
    x = torch.from_numpy(generate.make_input_vector(csr.shape[1]))
    op = SpMVOperator(csr, "row_mapped", device=CPU)
    raw = op._raw

    def launching(b, v):  # a kernel launched inside the operator's call
        _bare_launch()
        return raw(b, v)
    op._raw = launching
    want = counters.csr_spmv_work(*csr.shape, csr.nnz).counters()
    assert counters.compiled_counters(op, x) == want
    assert counters.compiled_counters(lambda v: op(v) + 1.0, x)[
        "bytes accessed"] == want["bytes accessed"] + 2 * csr.shape[0] * 4


def test_counts_do_not_nest():
    with pytest.raises(RuntimeError, match="already counting"):
        counters.compiled_counters(counters.compiled_counters, lambda: 3)
    assert counters.HOOK is None


# PERF.md §6's cells, from their shapes alone: (work, MB or GFLOP, bound
# ms, bound by). big_2097152 holds 33,554,301 nonzeros; the BCSR regimes
# 15,617 blocks (32768^2, 4096 block rows) and 15,268 (16384^2, 2048).
K7 = (16384, 16384, 15268, 2048, 15268 * 1024, 512)
CELLS = {
    "K1 big_2097152": (counters.csr_spmv_work(2097152, 2097152, 33554301),
                       "MB", 293.6, 0.0876, "bytes"),
    "K4 arxiv_gcn F=128": (counters.csr_spmm_work(169343, 169343, 2465171,
                                                  128),
                           "MB", 193.8, 0.0579, "bytes"),
    "K5 sddmm_65536_f128": (counters.sddmm_flat_work(65536, 65536, 2469272,
                                                     128),
                            "MB", 97.0, 0.0290, "bytes"),
    "K6 bcsr_spmv_32768": (counters.bcsr_work(32768, 32768, 15617, 4096,
                                              15617 * 1024),
                           "MB", 64.3, 0.0192, "bytes"),
    "K7 bcsr_spmm_16384_f512": (counters.bcsr_work(*K7), "GFLOP", 16.0,
                                0.2390, "operations"),
    "K7 bf16": (counters.bcsr_work(*K7, "bfloat16"), "GFLOP", 16.0, 0.0244,
                "bytes"),
    "K10 bcsr_sddmm_16384_f512": (counters.sddmm_bcsr_work(*K7[:3], K7[4],
                                                           512),
                                  "GFLOP", 16.0, 0.2390, "operations"),
    "K11 stream_1GiB": (counters.stream_read_work(1 << 30), "MB", 1073.7,
                        0.3205, "bytes"),
    "K12 [8, 8192]": (counters.saxpy_work(8 * 8192), "MB", 0.8, 0.0002,
                      "bytes"),
}


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_formulas_reproduce_the_perf_table(cell):
    work, unit, amount, ms, by = CELLS[cell]
    got = work.nbytes / 1e6 if unit == "MB" else work.flops / 1e9
    assert round(got, 1) == amount
    b_ms, b_by = counters.bound_of(work)
    assert (round(b_ms, 4), b_by) == (ms, by)


def test_bound_takes_the_largest_term():
    assert counters.bound(0, 0, floor=0.001) == (0.001, "launch")
    assert counters.bound(3.35e9, 0) == (1.0, "bytes")
    assert counters.bound(0, 67e9) == (1.0, "operations")
    assert counters.bound(0, 989e9, "bfloat16") == (1.0, "operations")
    assert counters.bound(1e9, 0, rate=1e12) == (1.0, "bytes")
    assert counters.bound_of(counters.csr_spmm_work(
        169343, 169343, 2465171, 128)) == counters.bound(
            193805976, 2 * 2465171 * 128)
    assert counters.bound_of(counters.saxpy_work(1), 1e12, 0.5) == \
        counters.bound(12, 2, None, 1e12, 0.5)
