"""The CSR SpMV slice of the port end to end: ``loops_tpu_torch.ops.spmv``
against ``loops_tpu.ops.spmv`` for every CSR schedule and impl on the
9-matrix battery, the example CLI, and the documented refusals.

The battery, the tolerance (``rtol=1e-5, atol=1e-6``: both packages sum
each row in f32, in different orders) and the repo's battery check
(battery tolerance and Wilkinson verdict, which both sides must pass) are
those of ``test_torch_spmv_kernels.py``. The JAX side runs its Pallas
kernels in interpret mode, as its own tests do on the CPU, and the port's
kernel wrappers take their plain versions; the sorted-flat impl is in
``test_torch_spmv_slice_sorted.py`` to keep each file short.
"""
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

import loops_tpu.utils.generate as jgen
import loops_tpu_torch.formats as tf
from loops_tpu.ops.spmv import spmv as jax_spmv
from loops_tpu_torch.ops.spmv import SpMVOperator, spmv
from loops_tpu_torch.utils import generate, reference
from test_torch_spmv_kernels import ATOL, BATTERY, RTOL, _valid

CPU = torch.device("cpu")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def check_slice(name, schedule, impl, block=8):
    """One matrix through both packages' ``spmv`` on the same inputs."""
    j = BATTERY[name]()
    t = tf.csr_from_arrays(j.shape, j.offsets, j.indices, j.vals)
    x = jgen.make_input_vector(j.shape[1])
    y_jax = np.asarray(jax_spmv(j, x, schedule=schedule, block=block,
                                impl=impl))
    y = spmv(t, x, schedule=schedule, block=block, impl=impl,
             device="cpu").numpy()
    label = f"{schedule}/{impl}/{name}"
    assert y.shape == y_jax.shape == (j.shape[0],), label
    assert y.dtype == np.float32
    np.testing.assert_allclose(y, y_jax, rtol=RTOL, atol=ATOL, err_msg=label)
    _valid(y, t, x, f"{label}/port")
    _valid(y_jax, t, x, f"{label}/jax")
    return t


@pytest.mark.parametrize("schedule,impl", [
    ("row_mapped", "xla"), ("group_mapped", "xla"),
    ("work_oriented", "xla"), ("merge_path", "xla"), ("auto", "xla"),
    ("merge_path", "pallas"), ("merge_path", "pallas2"),
    ("work_oriented", "pallas"), ("work_oriented", "pallas2"),
])
@pytest.mark.parametrize("name", sorted(BATTERY))
def test_slice_matches_loops_tpu(name, schedule, impl):
    check_slice(name, schedule, impl)


def test_example_cli_on_cpu():
    r = subprocess.run(
        [sys.executable, "examples/spmv_torch.py", "--device", "cpu", "-m",
         "datasets/chesapeake.mtx", "--validate", "--rigorous"],
        capture_output=True, text=True, timeout=180, cwd=REPO)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "csr_merge_path,chesapeake,39,39,340," in r.stdout
    assert "Errors: 0" in r.stdout
    assert "Verdict: NOT_A_BUG" in r.stdout


@pytest.mark.parametrize("schedule,impl", [
    ("merge_path", "pallas"), ("merge_path", "pallas2"),
    ("merge_path", "pallas3"), ("sorted_flat", "xla")])
def test_f64_refusal_warns_and_validates(schedule, impl):
    csr = generate.random_csr(20, 18, 0.25, seed=13, dtype=np.float64)
    x = generate.make_input_vector(18, dtype=np.float64)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        op = SpMVOperator(csr, schedule, block=8, impl=impl, device=CPU)
    assert any("float64" in str(m.message) for m in w)
    assert op.impl_used == "torch"
    y = op(x).numpy()
    assert y.dtype == np.float64
    np.testing.assert_allclose(y, reference.spmv(csr, x, dtype=np.float64),
                               rtol=1e-12, atol=1e-12)
    _valid(y, csr, x, f"f64/{schedule}/{impl}")


def test_auto_on_f64_takes_torch_merge_path():
    # auto is not a kernel request: where it picks sorted_flat for
    # float64 values, it warns and runs the torch merge-path executor,
    # as loops_tpu does (loops_tpu/ops/spmv.py:262-271)
    csr = generate.random_csr(20, 18, 0.25, seed=13, dtype=np.float64)
    x = generate.make_input_vector(18, dtype=np.float64)
    with pytest.warns(UserWarning, match="float64"):
        op = SpMVOperator(csr, "auto", block=8, device=CPU)
    assert op.schedule == "sorted_flat" and op.impl_used == "torch"
    y = op(x).numpy()
    assert y.dtype == np.float64 and op.launches == 0
    # loops_tpu's CPU table picks its own schedule for auto; the sums agree
    j = jgen.random_csr(20, 18, 0.25, seed=13, dtype=np.float64)
    y_jax = np.asarray(jax_spmv(j, x, schedule="auto", block=8))
    np.testing.assert_allclose(y, y_jax, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(y, reference.spmv(csr, x, dtype=np.float64),
                               rtol=1e-12, atol=1e-12)


def test_sorted_flat_f64_refusal_names_merge_path():
    # an explicit sorted_flat is a request for K1, whatever impl says: the
    # way to the torch executor is schedule='merge_path'
    csr = generate.random_csr(20, 18, 0.25, seed=13, dtype=np.float64)
    with pytest.warns(UserWarning, match="schedule='merge_path'") as w:
        op = SpMVOperator(csr, "sorted_flat", impl="xla", device=CPU)
    assert "impl='xla'" not in str(w[0].message)
    assert op.impl_used == "torch"


def test_span_refusal_takes_torch_executor():
    # work_oriented spans are data dependent: past K3's row window the
    # build warns and, on the CPU, runs the torch executor; K2 has no such
    # bound
    csr = generate.wide_span_csr(70_000)
    x = generate.make_input_vector(4)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        op = SpMVOperator(csr, "work_oriented", block=8, impl="pallas",
                          device=CPU)
    assert any("row window" in str(m.message) for m in w)
    assert op.impl_used == "torch"
    _valid(op(x).numpy(), csr, x, "span/pallas")
    op2 = SpMVOperator(csr, "work_oriented", block=8, impl="pallas2",
                       device=CPU)
    assert op2.impl_used == "flat_spmv_v2"
    _valid(op2(x).numpy(), csr, x, "span/pallas2")


@pytest.mark.parametrize("schedule,impl,used", [
    ("row_mapped", "xla", "torch"), ("group_mapped", "xla", "torch"),
    ("merge_path", "xla", "torch"), ("merge_path", "pallas", "flat_spmv"),
    ("merge_path", "pallas2", "flat_spmv_v2"),
    ("merge_path", "pallas3", "sorted_spmv"),
    ("sorted_flat", "xla", "sorted_spmv"), ("auto", "xla", "sorted_spmv")])
def test_operator_records_impl_used(schedule, impl, used):
    csr = generate.random_csr(50, 40, 0.1, seed=2)
    op = SpMVOperator(csr, schedule, block=16, impl=impl, device=CPU)
    assert op.impl_used == used
    x = generate.make_input_vector(40)
    _valid(op(x).numpy(), csr, x, f"{schedule}/{impl}")
    # on the CPU every wrapper takes its plain version: nothing launches
    assert op.launches == 0
    if used == "sorted_spmv":
        assert op.meta["plan_ms"] >= 0


@pytest.mark.parametrize("schedule,impl", [
    ("row_mapped", "xla"), ("group_mapped", "xla"),
    ("work_oriented", "xla"), ("merge_path", "xla"), ("auto", "xla"),
    ("merge_path", "pallas"), ("merge_path", "pallas2"),
    ("work_oriented", "pallas"), ("work_oriented", "pallas2"),
    ("merge_path", "pallas3"), ("sorted_flat", "xla")])
@pytest.mark.parametrize("shape", [(3, 4), (0, 5), (6, 0)])
def test_empty_matrix_gives_zeros(shape, schedule, impl):
    # nnz == 0: loops_tpu raises IndexError staging the flat executors'
    # buffers; the port stages all-padding blocks and returns zeros
    rows, cols = shape
    empty = tf.CSR(shape, np.zeros(rows + 1, np.int64),
                   np.zeros(0, np.int64), np.zeros(0, np.float32))
    op = SpMVOperator(empty, schedule, block=8, impl=impl, device=CPU)
    y = op(np.ones(cols, np.float32))
    assert tuple(y.shape) == (rows,) and not y.any()
    assert op.launches == 0


def test_unported_knobs_raise():
    csr = generate.random_csr(10, 10, 0.3, seed=1)
    for kw in (dict(reorder="degree"), dict(plan_cache="/nonexistent"),
               dict(bucketed=True)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            SpMVOperator(csr, "merge_path", **kw, device=CPU)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        SpMVOperator(csr.to_coo(), "row_mapped", device=CPU)


def test_bad_schedule_and_impl_rejected():
    csr = generate.random_csr(10, 10, 0.3, seed=1)
    with pytest.raises(ValueError):
        SpMVOperator(csr, "bucketing", device=CPU)
    with pytest.raises(ValueError):
        SpMVOperator(csr, "row_mapped", impl="pallas", device=CPU)
    with pytest.raises(ValueError):
        SpMVOperator(csr, "merge_path", impl="mosaic", device=CPU)


def test_spmv_caches_operator_per_device():
    csr = generate.random_csr(12, 12, 0.3, seed=1)
    x = generate.make_input_vector(12)
    spmv(csr, x, schedule="merge_path", impl="pallas2", device="cpu")
    spmv(csr, x, schedule="merge_path", impl="pallas2", device="cpu")
    assert len(csr._spmv_ops) == 1
