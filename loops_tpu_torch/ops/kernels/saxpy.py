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
K12; on the CPU it runs the plain version. At [8, 8192] a call costs
what the host takes to make it, so ``saxpy`` checks ``device`` once per
value asked for and passes float32 contiguous tensors already on the
card to ``saxpy_cuda`` as they are, with no conversion.
"""
from __future__ import annotations

import numpy as np
import torch

from loops_tpu_torch.ops.kernels import _build
from loops_tpu_torch.utils import counters
from loops_tpu_torch.utils.platform import ensure_platform

BLOCK = 256
CTAS_PER_SM = 4
F32 = torch.float32
# device argument of saxpy() -> the device it names, checked once
_DEVICES: dict = {}


def saxpy_cuda(a: float, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Launch K12 on CUDA tensors ``x``, ``y`` (float32, contiguous, one
    shape); returns a new tensor."""
    if counters.HOOK is not None:
        return counters.HOOK(work, saxpy_cuda, a, x, y)
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
    if counters.HOOK is not None:
        return counters.HOOK(work, saxpy_plain, a, x, y)
    return a * x + y


def work(a, x, y, device=None) -> counters.Work:
    """One call's work (``utils/counters.saxpy_work``), whichever entry
    point makes it."""
    n = x.numel() if isinstance(x, torch.Tensor) else np.asarray(x).size
    return counters.saxpy_work(int(n))


def _as_tensor(v, device) -> torch.Tensor:
    if isinstance(v, np.ndarray):
        v = torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32))
    return v.to(device=device, dtype=torch.float32).contiguous()


def _device(device) -> torch.device:
    """``ensure_platform(device)``, asked once per value."""
    try:
        return _DEVICES[device]
    except (KeyError, TypeError):  # a first ask, or an unhashable value
        dev = ensure_platform(device)
        try:
            _DEVICES[device] = dev
        except TypeError:
            pass
        return dev


def _staged(x, y, device: torch.device) -> bool:
    """Whether ``x`` and ``y`` are float32 contiguous tensors already on
    CUDA ``device`` (a bare ``cuda``: the current card), so that
    ``_as_tensor`` would return them as they are."""
    if type(x) is not torch.Tensor or type(y) is not torch.Tensor:
        return False
    dx = x.device
    index = (torch.cuda.current_device() if device.index is None
             else device.index)
    return (dx.type == "cuda" and dx.index == index and y.device == dx
            and x.dtype is F32 and y.dtype is F32 and x.is_contiguous()
            and y.is_contiguous())


def saxpy(a: float, x, y, device="cuda") -> torch.Tensor:
    """``a * x + y`` on ``device``: K12 on a card, the plain version on
    the CPU."""
    if counters.HOOK is not None:
        return counters.HOOK(work, saxpy, a, x, y, device)
    device = _device(device)
    if device.type == "cuda" and _staged(x, y, device):
        return saxpy_cuda(float(a), x, y)
    x, y = _as_tensor(x, device), _as_tensor(y, device)
    if device.type == "cpu":
        return saxpy_plain(float(a), x, y)
    return saxpy_cuda(float(a), x, y)
