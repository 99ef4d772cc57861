"""The frozen formulas give the program's counters' numbers today."""
import pytest

from loopsbench import counters as frozen
from loops_tpu_torch.utils import counters as program


@pytest.mark.parametrize("rows,cols,nnz", [(1, 1, 1), (7, 5, 11),
                                           (4096, 4096, 65536)])
def test_spmv(rows, cols, nnz):
    a = frozen.csr_spmv_work(rows, cols, nnz)
    b = program.csr_spmv_work(rows, cols, nnz)
    assert (a.nbytes, a.flops) == (b.nbytes, b.flops)
    assert frozen.bound_s(a) * 1e3 == pytest.approx(
        program.bound(b.nbytes, b.flops)[0], rel=1e-12)


@pytest.mark.parametrize("F", [1, 40, 128, 256])
def test_spmm(F):
    a = frozen.csr_spmm_work(169343, 169343, 2465171, F)
    b = program.csr_spmm_work(169343, 169343, 2465171, F)
    assert (a.nbytes, a.flops) == (b.nbytes, b.flops)
    assert frozen.bound_s(a) * 1e3 == pytest.approx(
        program.bound(b.nbytes, b.flops)[0], rel=1e-12)


@pytest.mark.parametrize("n", [1, 8 * 8192, 1 << 26])
def test_saxpy(n):
    a, b = frozen.saxpy_work(n), program.saxpy_work(n)
    assert (a.nbytes, a.flops) == (b.nbytes, b.flops)


def test_peaks():
    assert frozen.HBM_BYTES_PER_S == program.HBM_BYTES_PER_S
    assert frozen.PEAK_F32_FLOPS == program.PEAK_FLOPS[None]
