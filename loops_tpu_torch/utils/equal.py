"""Device-host comparison helper (reference: util/equal.hxx:44-67)."""
from __future__ import annotations

import numpy as np

from loops_tpu_torch.utils.reference import DEFAULT_ATOL, DEFAULT_RTOL


def nearly_equal(a, b, atol=1e-3, rtol=1e-4) -> bool:
    """Battery tolerance (reference: unittests/test_helpers.hxx:242-247)."""
    a, b = np.asarray(a), np.asarray(b)
    return bool(np.all(np.abs(a - b) <= atol + rtol * np.abs(b)))


def count_mismatches(result, expected, atol=DEFAULT_ATOL, rtol=DEFAULT_RTOL,
                     verbose: bool = False) -> int:
    """Mismatch counter with optional per-element reporting."""
    result = np.asarray(result)
    expected = np.asarray(expected)
    bad = np.abs(result - expected) > (atol + rtol * np.abs(expected))
    n = int(bad.sum())
    if verbose and n:
        idx = np.nonzero(bad.ravel())[0][:10]
        for i in idx:
            print(f"  mismatch @ {i}: got {result.ravel()[i]!r} "
                  f"expected {expected.ravel()[i]!r}")
        if n > 10:
            print(f"  ... and {n - 10} more")
    return n
