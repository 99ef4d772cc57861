"""1-D gather.

``loops_tpu.ops.gather`` routes ``x[idx]`` through a 128-lane row gather
on the TPU, whose scalar gather is issue-bound. A CUDA card gathers
natively, so the port's gather is the plain ``x[idx]`` that the JAX
package already uses off the TPU.
"""
from __future__ import annotations


def gather1d(x, idx):
    """``x[idx]`` for 1-D ``x`` and integer ``idx`` of any shape."""
    return x[idx]
