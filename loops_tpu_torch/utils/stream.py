"""K11: the measured device-memory read rate, the roofline every
kernel's byte bound is held against.

    measure_stream_gbps(device="cuda", rows=524288, cols=512) -> GB/s

Ports ``bench.py`` ``measure_stream_gbps``: a float32 array of ``rows x
cols`` (1 GiB at the defaults; ``rows=32768`` is the JAX bench's 64 MiB) is
read in
``passes`` sweeps inside one launch of the CUDA kernel
``csrc/stream.cu`` ``stream_read_kernel`` (16-byte loads, every element
folded into a per-CTA sum so no load is dead); the time of 616 passes less
the time of 16, over 600, is the time of one sweep, and the array's bytes
over it the rate. Each time is the least of 5 CUDA-event timings, as the
JAX bench took the least host time.

An array near the 50 MB L2 (as 64 MiB is) may be read partly from L2,
above the memory's own rate, so the default is 1 GiB, twenty times the
L2: ``chip_smoke.py`` reports 64 MiB and 1 GiB and takes the 1 GiB rate as
the measured bound.

The array holds integers in [-8, 8] (``stream_input``). A float32 sum of
them is exact while it stays below 2**24 in magnitude, and one pass's
per-CTA sums over up to 1 GiB do (at most 8 * 2**28 / 528 on an H100's 528
CTAs), so K11's total can be held to the integer total exactly.

The plain version is ``torch.sum`` over the same array. On a CPU tensor
the wrapper runs it (``passes`` times), timed by the host clock.
"""
from __future__ import annotations

import torch

from loops_tpu_torch.ops.kernels import _build
from loops_tpu_torch.utils.bench import run_slope_ms
from loops_tpu_torch.utils.platform import ensure_platform

LO_PASSES, HI_PASSES = 16, 616
CTAS_PER_SM = 4


def stream_input(rows: int, cols: int, device, seed: int = 0
                 ) -> torch.Tensor:
    """A ``rows x cols`` float32 array of integers drawn uniformly from
    [-8, 8], made on ``device`` from ``seed``."""
    g = torch.Generator(device).manual_seed(seed)
    return torch.randint(-8, 9, (rows, cols), generator=g, device=device,
                         dtype=torch.int32).float()


def stream_read_cuda(x: torch.Tensor, passes: int = 1) -> torch.Tensor:
    """Launch K11: ``passes`` sweeps over ``x``; returns the per-CTA sums
    of every element read (float32 [CTAs])."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"stream_read_cuda needs a CUDA tensor, got {dev}")
    _build.check(x, "x", torch.float32, dev)
    n = x.numel()
    if n % 4 or x.data_ptr() % 16:
        raise ValueError("K11 reads 16-byte pieces: x needs a multiple of 4 "
                         "elements and a 16-byte aligned start")
    if n // 4 >= 2**31 or not 0 <= passes < 2**31:
        raise ValueError(f"{n} elements, {passes} passes: past K11's int32 "
                         "counts")
    ctas = CTAS_PER_SM * torch.cuda.get_device_properties(
        dev).multi_processor_count
    out = torch.empty(ctas, dtype=torch.float32, device=dev)
    _build.launch("loops_stream_read_f32", "stream_read", dev, x, out, n // 4,
                  passes, ctas)
    return out


def stream_read_plain(x: torch.Tensor, passes: int = 1) -> torch.Tensor:
    """The plain version: ``torch.sum`` of ``x``, ``passes`` times, summed
    (a [1] tensor)."""
    total = x.new_zeros(1)
    for _ in range(passes):
        total += x.sum()
    return total


def stream_read(x: torch.Tensor, passes: int = 1) -> torch.Tensor:
    """K11 on a CUDA tensor, its plain version on a CPU tensor: partial
    sums whose total is ``passes * x.sum()``."""
    if x.device.type == "cpu":
        return stream_read_plain(x, passes)
    return stream_read_cuda(x, passes)


def pass_ms(x: torch.Tensor, lo: int = LO_PASSES, hi: int = HI_PASSES,
            repeats: int = 5) -> float:
    """Milliseconds of one sweep over ``x``: (least time of ``hi`` passes
    - least time of ``lo``) / (hi - lo); CUDA events on the card, the
    host clock on the CPU."""
    return run_slope_ms(lambda n: stream_read(x, n), lo, hi, repeats,
                        x.is_cuda)


def measure_stream_gbps(device="cuda", rows: int = 524288,
                        cols: int = 512) -> float:
    """Achievable read rate of the device's memory, GB/s, over a
    ``rows x cols`` float32 array (``stream_input``, seed 0); the default
    1 GiB is far past the L2, smaller arrays may read partly from it."""
    device = ensure_platform(device)
    x = stream_input(rows, cols, device)
    return x.numel() * 4 / pass_ms(x) / 1e6
