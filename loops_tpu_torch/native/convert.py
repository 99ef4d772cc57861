"""ctypes bindings of the native COO -> CSR converter and the shard
column remap (``src/coo_to_csr.cpp``, ``src/unique_remap.cpp``), as
``loops_tpu/native/convert.py`` has them. Each returns None where the
library is missing or the input is outside the native contract (dtypes,
an id out of range): the caller then takes its numpy path."""
from __future__ import annotations

import ctypes

import numpy as np

from loops_tpu_torch.native.build import load_library

_I32P = ctypes.POINTER(ctypes.c_int32)
_F32P = ctypes.POINTER(ctypes.c_float)
_SIGNATURES = {
    "coo_to_csr_f32": (ctypes.c_int, [_I32P, _I32P, _F32P, ctypes.c_int64,
                                      ctypes.c_int32, _I32P, _I32P, _F32P]),
    "unique_remap_i32": (ctypes.c_int64, [_I32P, ctypes.c_int64,
                                          ctypes.c_int64, _I32P, _I32P]),
}


def _fn(name: str):
    """The library's entry point ``name`` with its types set, or None."""
    lib = load_library()
    if lib is None:
        return None
    try:
        fn = getattr(lib, name)
    except AttributeError:
        return None
    fn.restype, fn.argtypes = _SIGNATURES[name]
    return fn


def coo_to_csr(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
               num_rows: int):
    """``(offsets, cols, vals)`` sorted by (row, col), stable within
    (row, col) (duplicates keep their input order: ``COO.sort_by_row``'s
    lexsort order), offsets int32; or None. Inputs int32/int32/float32;
    a row out of ``[0, num_rows)`` gives None."""
    fn = _fn("coo_to_csr_f32")
    if fn is None:
        return None
    if (rows.dtype != np.int32 or cols.dtype != np.int32
            or vals.dtype != np.float32):
        return None
    rows = np.ascontiguousarray(rows)
    cols = np.ascontiguousarray(cols)
    vals = np.ascontiguousarray(vals)
    nnz = len(rows)
    if len(cols) != nnz or len(vals) != nnz:
        raise ValueError("rows, cols and vals differ in length")
    offsets = np.empty(int(num_rows) + 1, np.int32)
    out_cols = np.empty(nnz, np.int32)
    out_vals = np.empty(nnz, np.float32)
    rc = fn(rows.ctypes.data_as(_I32P), cols.ctypes.data_as(_I32P),
            vals.ctypes.data_as(_F32P), nnz, int(num_rows),
            offsets.ctypes.data_as(_I32P), out_cols.ctypes.data_as(_I32P),
            out_vals.ctypes.data_as(_F32P))
    if rc != 0:
        return None
    return offsets, out_cols, out_vals


def unique_remap(cols: np.ndarray, n_cols: int):
    """``(uniq, local)``: the sorted distinct values of ``cols`` and each
    element's index into them, ``np.unique(cols, return_inverse=True)``
    in O(nnz + n_cols); or None (int32 only; a value out of ``[0,
    n_cols)`` gives None)."""
    fn = _fn("unique_remap_i32")
    if fn is None or cols.dtype != np.int32:
        return None
    cols = np.ascontiguousarray(cols)
    nnz = len(cols)
    local = np.empty(nnz, np.int32)
    uniq = np.empty(min(nnz, int(n_cols)), np.int32)
    k = fn(cols.ctypes.data_as(_I32P), nnz, int(n_cols),
           local.ctypes.data_as(_I32P), uniq.ctypes.data_as(_I32P))
    if k < 0:
        return None
    return uniq[:k].copy(), local
