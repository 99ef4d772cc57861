"""What the probes share: two launches held bitwise equal, a kernel held
to its plain version, slope timing of a launch, and the record each probe
returns.

A probe's record is a dict: ``name`` (its launch counter in
``ops/kernels/_build.LAUNCHES``), ``label``, ``ms`` (the kernel, by
slope), ``plain_ms``, ``library_ms`` (one PyTorch call that computes the
same function, or None), ``nbytes`` and ``flops`` (what its inputs need:
each input read once, each output written once), ``peak`` (``"f32"`` for
the CUDA cores, ``"bf16"`` for the tensor cores), ``max_abs_err`` against
the plain version, and ``line``, the line it printed.
"""
from __future__ import annotations

import torch

from loops_tpu_torch.utils.bench import slope_ms

# launches per timing: the slope of 20 chained launches over 4
LO, HI = 4, 20


class ProbeMismatch(AssertionError):
    """A probe kernel disagreed with its plain version, or with itself."""


def sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def launch_twice(fn):
    """``fn()`` twice; raise unless the two results are bitwise equal.
    Returns the first."""
    a, b = fn(), fn()
    sync(a)
    if not torch.equal(a, b):
        raise ProbeMismatch("two launches gave different results")
    return a


def hold(label: str, got: torch.Tensor, want: torch.Tensor,
         atol: float = 0.0) -> float:
    """Raise unless ``got`` has ``want``'s shape, is finite, and lies
    within ``atol`` of it (``atol`` 0: bitwise equal values). Returns the
    max abs difference."""
    if tuple(got.shape) != tuple(want.shape):
        raise ProbeMismatch(f"{label}: shape {tuple(got.shape)}, expected "
                            f"{tuple(want.shape)}")
    if got.is_floating_point() and not bool(torch.isfinite(got).all()):
        raise ProbeMismatch(f"{label}: non-finite output")
    diff = (got.double() - want.double()).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    if err > atol:
        raise ProbeMismatch(f"{label}: kernel and plain differ by {err:.3e} "
                            f"(allowed {atol:g})")
    return err


def launch_ms(fn, device, lo: int = LO, hi: int = HI) -> float:
    """Milliseconds per ``fn()`` by the slope of ``hi`` back-to-back calls
    over ``lo`` (CUDA events on the card, the host clock on the CPU)."""
    carrier = torch.zeros(1, device=device)
    return slope_ms(lambda v: (fn(), v)[1], carrier, lo=lo, hi=hi)


def record(name, label, ms, plain_ms, library_ms, nbytes, flops, peak,
           max_abs_err, line) -> dict:
    return dict(name=name, label=label, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, nbytes=int(nbytes), flops=int(flops),
                peak=peak, max_abs_err=max_abs_err, line=line)
