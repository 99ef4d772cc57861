"""The sorted-flat impl of the CSR SpMV slice end to end (K1):
``loops_tpu_torch.ops.spmv`` with ``schedule='sorted_flat'`` and with
``impl='pallas3'`` against ``loops_tpu.ops.spmv`` with ``impl='pallas3'``
on the 9-matrix battery.

The JAX side goes through its own ``spmv`` with the sorted kernel built
as ``tests/test_spmv_sorted.py`` builds it on the CPU
(``vregs_per_block=2``, interpret mode): at its default of 8 the
interpret-mode kernel takes about ten seconds per matrix on the CPU. Its
result is computed once per matrix and compared with both port entry
points. Tolerance and checks are those of ``test_torch_spmv_slice.py``.
"""
import functools

import numpy as np
import pytest

import loops_tpu.ops.kernels.spmv_sorted as jax_sorted
import loops_tpu.utils.generate as jgen
import loops_tpu_torch.formats as tf
from loops_tpu.ops.spmv import spmv as jax_spmv
from loops_tpu_torch.ops.spmv import SpMVOperator
from test_torch_spmv_kernels import ATOL, BATTERY, RTOL, _valid

_JAX_Y = {}


def _jax_sorted_y(name, monkeypatch):
    if name not in _JAX_Y:
        monkeypatch.setattr(
            jax_sorted, "sorted_spmv_pallas",
            functools.partial(jax_sorted.sorted_spmv_pallas,
                              vregs_per_block=2, interpret=True))
        j = BATTERY[name]()
        x = jgen.make_input_vector(j.shape[1])
        _JAX_Y[name] = np.asarray(jax_spmv(j, x, schedule="merge_path",
                                           impl="pallas3"))
    return _JAX_Y[name]


@pytest.mark.parametrize("schedule,impl", [
    ("merge_path", "pallas3"), ("sorted_flat", "xla")])
@pytest.mark.parametrize("name", sorted(BATTERY))
def test_sorted_slice_matches_loops_tpu(name, schedule, impl, monkeypatch):
    j = BATTERY[name]()
    t = tf.csr_from_arrays(j.shape, j.offsets, j.indices, j.vals)
    x = jgen.make_input_vector(j.shape[1])
    y_jax = _jax_sorted_y(name, monkeypatch)
    op = SpMVOperator(t, schedule, block=8, impl=impl, device="cpu")
    assert op.impl_used == "sorted_spmv"
    y = op(x).numpy()
    label = f"{schedule}/{impl}/{name}"
    np.testing.assert_allclose(y, y_jax, rtol=RTOL, atol=ATOL, err_msg=label)
    _valid(y, t, x, f"{label}/port")
    _valid(y_jax, t, x, f"{label}/jax")
