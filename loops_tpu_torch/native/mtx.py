"""ctypes binding of the native Matrix Market tokenizer
(``src/mtx_parser.cpp``), as ``loops_tpu/native/mtx.py`` has it."""
from __future__ import annotations

import ctypes

import numpy as np

from loops_tpu_torch.native.build import load_library


def _fn():
    lib = load_library()
    if lib is None:
        return None
    try:
        fn = lib.mtx_parse_records
    except AttributeError:
        return None
    fn.restype = ctypes.c_long
    fn.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_long,
                   ctypes.c_int, ctypes.POINTER(ctypes.c_double)]
    return fn


def mtx_parse(body, nnz: int, ncols: int):
    """``nnz`` records of ``ncols`` numbers each, parsed from bytes or a
    zero-copy memoryview of a mapped file, as float64 ``[nnz, ncols]``;
    None when the library is missing, a field is malformed or fewer than
    ``nnz`` records are found."""
    fn = _fn()
    if fn is None:
        return None
    buf = np.frombuffer(body, dtype=np.uint8)  # no copy of a memoryview
    out = np.empty((nnz, ncols), dtype=np.float64)
    got = fn(buf.ctypes.data_as(ctypes.c_char_p), len(buf), nnz, ncols,
             out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    if got != nnz:
        return None
    return out
