"""Hard-coded sample CSR fixture (reference: util/sample.hxx:58-90), as in
``loops_tpu/utils/sample.py``.

A small fixed 4x4 matrix used in docs and smoke tests:

    [[0, 0, 0, 0],
     [5, 8, 0, 0],
     [0, 0, 3, 0],
     [0, 6, 0, 0]]
"""
from __future__ import annotations

import numpy as np

from loops_tpu_torch.formats import CSR


def csr(dtype=np.float32) -> CSR:
    return CSR(
        shape=(4, 4),
        offsets=[0, 0, 2, 3, 4],
        indices=[0, 1, 2, 1],
        vals=np.array([5, 8, 3, 6], dtype=dtype),
    )
