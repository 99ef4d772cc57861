"""The benchmark's yardstick of work: bytes and flops from shapes, and the
least time an H100 could take for them.

A frozen copy of the formulas in ``loops_tpu_torch/utils/counters.py``
that the cells use (``csr_spmv_work``, ``csr_spmm_work``,
``saxpy_work``, ``bound``), kept here so that a change to the program
cannot move the yardstick it is measured against. A test holds each
formula to the program's at small sizes.

Each formula counts what the problem must move, whatever kernel runs
it: every input byte read once, every output byte written once.
"""
from __future__ import annotations

from dataclasses import dataclass

# H100 SXM at 700 W (NVIDIA's data sheet): HBM3 bandwidth, and the dense
# f32 rate outside the tensor cores (TF32 is off in every cell)
HBM_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12


@dataclass(frozen=True)
class Work:
    """One call's bytes and flops (f32)."""
    nbytes: int
    flops: int


def csr_spmv_work(rows: int, cols: int, nnz: int) -> Work:
    """y = A x over CSR (int32 offsets and columns, f32 values): offsets,
    columns, values and x read, y written; 2 flops a nonzero."""
    return Work(4 * (rows + 1) + 8 * nnz + 4 * cols + 4 * rows, 2 * nnz)


def csr_spmm_work(rows: int, cols: int, nnz: int, F: int) -> Work:
    """C = A B over CSR with f32 B [cols, F]: offsets, columns, values and
    B read once, C [rows, F] written once; 2 flops a nonzero and
    feature."""
    return Work(4 * (rows + 1) + 8 * nnz + 4 * F * (cols + rows),
                2 * nnz * F)


def saxpy_work(n: int) -> Work:
    """a x + y over n f32 elements: x and y read, the result written."""
    return Work(12 * n, 2 * n)


def vector_pass_work(n: int, reads: int, writes: int) -> Work:
    """An element-wise pass over f32 vectors of n: ``reads`` read,
    ``writes`` written, one flop an element read."""
    return Work(4 * n * (reads + writes), n * reads)


def dense_matmul_flops(m: int, k: int, n: int) -> int:
    """[m, k] @ [k, n]: one multiply and one add per term."""
    return 2 * m * k * n


def bound_s(work: Work) -> float:
    """The least time the card could take for ``work``: its bytes at
    3.35 TB/s or its flops at 67 TFLOP/s, whichever is longer."""
    return max(work.nbytes / HBM_BYTES_PER_S, work.flops / PEAK_F32_FLOPS)
