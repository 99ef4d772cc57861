"""K12: SAXPY, ``a * x + y`` in float32 over any shape.

Replaces ``examples/saxpy.py`` ``saxpy_pallas``, the kernel-authoring
hello world. The CUDA kernel (``csrc/saxpy.cu`` ``saxpy_kernel``) is the
reference's grid-stride loop with 16-byte loads where x, y and the output
are aligned; it rounds the product and the sum separately, so it equals
its plain version ``a * x + y`` bit for bit. What bounds it is bytes: 12
per element.

    saxpy(a, x, y, device="cuda") -> tensor on ``device``

``x`` and ``y`` may be numpy arrays or tensors of one shape; they are
moved to ``device`` as float32. On a CUDA device the wrapper launches
K12; on the CPU it runs the plain version.
"""
from __future__ import annotations

import numpy as np
import torch

from loops_tpu_torch.ops.kernels import _build
from loops_tpu_torch.utils.platform import ensure_platform

BLOCK = 256
CTAS_PER_SM = 4


def saxpy_cuda(a: float, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Launch K12 on CUDA tensors ``x``, ``y`` (float32, contiguous, one
    shape); returns a new tensor."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"saxpy_cuda needs a CUDA tensor, got {dev}")
    _build.check(x, "x", torch.float32, dev)
    _build.check(y, "y", torch.float32, dev, x.numel())
    if y.shape != x.shape:
        raise ValueError(f"y has shape {tuple(y.shape)}, expected "
                         f"{tuple(x.shape)}")
    n = x.numel()
    if n >= 2**31:
        raise ValueError(f"{n} elements: past K12's int32 count")
    out = torch.empty_like(x)
    if n == 0:
        return out  # a grid of 0 blocks is not a launch
    blocks = min(-(-n // (4 * BLOCK)), CTAS_PER_SM * _build.sm_count(dev))
    _build.launch("loops_saxpy_f32", "saxpy", dev, float(a), x, y, out, n,
                  blocks)
    return out


def saxpy_plain(a: float, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """K12's plain version: ``a * x + y`` (the product rounded to float32
    before the sum)."""
    return a * x + y


def _as_tensor(v, device) -> torch.Tensor:
    if isinstance(v, np.ndarray):
        v = torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32))
    return v.to(device=device, dtype=torch.float32).contiguous()


def saxpy(a: float, x, y, device="cuda") -> torch.Tensor:
    """``a * x + y`` on ``device``: K12 on a card, the plain version on
    the CPU."""
    device = ensure_platform(device)
    x, y = _as_tensor(x, device), _as_tensor(y, device)
    if device.type == "cpu":
        return saxpy_plain(float(a), x, y)
    return saxpy_cuda(float(a), x, y)
