"""Shared helpers for the host-side sparse containers.

Host containers are plain numpy (cheap slicing, conversions, I/O); device
residency is a late, explicit step (``to_device``) that returns torch
tensors. Index dtype is int32 — the kernels address with 32-bit indices —
with an overflow guard at construction (the reference guards at load
time, market.hxx:143-167).
"""
from __future__ import annotations

import numpy as np

INDEX_DTYPE = np.int32
VALUE_DTYPE = np.float32


def as_index_array(a, name: str = "index array") -> np.ndarray:
    """Coerce to the canonical index dtype with an overflow guard."""
    a = np.asarray(a)
    if a.size and (a.max(initial=0) > np.iinfo(INDEX_DTYPE).max):
        raise OverflowError(
            f"{name} exceeds {INDEX_DTYPE.__name__} range; the kernels "
            "address with 32-bit indices")
    return np.ascontiguousarray(a, dtype=INDEX_DTYPE)


def as_value_array(a, dtype=None) -> np.ndarray:
    dtype = dtype or (a.dtype if isinstance(a, np.ndarray) and
                      np.issubdtype(a.dtype, np.floating) else VALUE_DTYPE)
    return np.ascontiguousarray(a, dtype=dtype)


def check_shape(shape) -> tuple:
    rows, cols = int(shape[0]), int(shape[1])
    if rows < 0 or cols < 0:
        raise ValueError(f"invalid matrix shape {shape}")
    return (rows, cols)
