"""Launch box — kernel tuning keyed by the card's name.

The analog of the reference's arch-keyed ``launch_box_t`` (reference:
include/loops/util/launch_box.hxx:159-214 + algorithms/spmv/
launch_box.hxx:63-90): the row is resolved from
``torch.cuda.get_device_name()`` at run time — first substring match wins,
with an explicit fallback row (launch_box.hxx:176-214's ``fallback``
semantics).

Every row carries ``provenance``: where its numbers come from. A row that
``tuning/autotune.py`` cached for the card's name comes first.
"""
from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class LaunchParams:
    # flat SpMV: atoms (+tiles for merge_path) per block
    spmv_block: int
    # SpMM: widest feature tile one CTA of K4 covers (a multiple of 32)
    spmm_block_f: int
    # device-memory bandwidth (GB/s) for roofline reporting
    hbm_gbps: float
    # peak dense bf16 tensor-core throughput (TFLOP/s)
    peak_tflops: float
    # BCSR block dims (R, C) a CSR matrix is blocked into
    bcsr_block: tuple = (8, 128)
    provenance: str = "fallback"


# substring match on torch.cuda.get_device_name(), first match wins
_TABLE = (
    # spmv_block and spmm_block_f: tuning/autotune.py's winners on NVIDIA
    # H100 80GB HBM3 at 700.00 W by device_ms on a 1.07M-nonzero matrix:
    # K2 0.0113 ms and K3 0.0147 at 1024 (0.0319 and 0.0618 at 16384: fewer
    # blocks than SMs), K4 at F = 512 0.3272 ms at 128 (0.3448 at 256).
    # bcsr_block: the (8, 128) block the BCSR kernels are built for, not
    # swept. Bandwidth and peak are NVIDIA's data-sheet figures for the
    # H100 SXM at its 700 W limit.
    ("H100", LaunchParams(1024, 128, 3350.0, 989.0,
                          provenance="measured: tuning/autotune.py, "
                          "plots/data/h100/autotune.json, on NVIDIA H100 "
                          "80GB HBM3, 700.00 W")),
)

# CPU: tiny blocks so the multi-block paths are exercised in tests
_CPU = LaunchParams(64, 128, 0.0, 0.0, provenance="cpu test size")
_FALLBACK = LaunchParams(1024, 256, 0.0, 0.0, provenance="fallback")


def launch_params(device="cuda") -> LaunchParams:
    """Resolve tuning for ``device`` (a ``torch.device`` or its name).

    On a card, in order: (1) a row that ``tuning/autotune.py`` cached for
    this card's name, (2) the table above, (3) the fallback row. The
    returned row's ``provenance`` says which."""
    import torch

    from loops_tpu_torch.tuning.autotune import cached_autotune_row
    from loops_tpu_torch.utils.platform import ensure_platform

    dev = ensure_platform(device)
    if dev.type != "cuda":
        return _CPU
    name = torch.cuda.get_device_name(dev)
    base = next((params for key, params in _TABLE if key in name),
                _FALLBACK)
    tuned = cached_autotune_row(name)
    if tuned is not None:
        return replace(base, provenance="autotuned", **tuned)
    return base
