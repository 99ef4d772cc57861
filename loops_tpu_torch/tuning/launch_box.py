"""Launch box — kernel tuning keyed by the card's name.

The analog of the reference's arch-keyed ``launch_box_t`` (reference:
include/loops/util/launch_box.hxx:159-214 + algorithms/spmv/
launch_box.hxx:63-90): the row is resolved from
``torch.cuda.get_device_name()`` at run time — first substring match wins,
with an explicit fallback row (launch_box.hxx:176-214's ``fallback``
semantics).

Every row carries ``provenance``: where its numbers come from. No row
here is measured yet.
"""
from __future__ import annotations

from dataclasses import dataclass


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
    # spmv_block: carried from the v5e row's fallback block (1024);
    # spmm_block_f: the v5e row's feature tile (256); bcsr_block: the v5e
    # row's (8, 128). All unmeasured on H100 (ROADMAP A7 sweeps them).
    # Bandwidth and peak are NVIDIA's data-sheet figures for the H100 SXM
    # at its 700 W limit.
    ("H100", LaunchParams(1024, 256, 3350.0, 989.0,
                          provenance="carried from v5e, unmeasured on H100")),
)

# CPU: tiny blocks so the multi-block paths are exercised in tests
_CPU = LaunchParams(64, 128, 0.0, 0.0, provenance="cpu test size")
_FALLBACK = LaunchParams(1024, 256, 0.0, 0.0, provenance="fallback")


def launch_params(device="cuda") -> LaunchParams:
    """Resolve tuning for ``device`` (a ``torch.device`` or its name)."""
    import torch

    from loops_tpu_torch.utils.platform import ensure_platform

    dev = ensure_platform(device)
    if dev.type != "cuda":
        return _CPU
    name = torch.cuda.get_device_name(dev)
    for key, params in _TABLE:
        if key in name:
            return params
    return _FALLBACK
