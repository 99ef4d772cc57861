"""Integer math helpers (reference: util/math.hxx:27-31), as in
``loops_tpu/utils/math.py``."""
from __future__ import annotations


def ceil_div(a: int, b: int) -> int:
    """ceil(a / b) without overflow for non-negative ints
    (reference math::ceil_div)."""
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    """Smallest multiple of m >= x."""
    return ceil_div(x, m) * m


def round_down(x: int, m: int) -> int:
    return (x // m) * m
