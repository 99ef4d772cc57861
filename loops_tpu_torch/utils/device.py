"""Memoized device queries (reference: util/device.hxx:25-131).

The reference caches cudaGetDeviceProperties because the ~1 ms query would
dominate small-matrix timings; here the same properties come from
``torch.cuda.get_device_properties`` once per process. Without a card the
description is the host CPU's.
"""
from __future__ import annotations

from functools import lru_cache


@lru_cache(maxsize=None)
def _properties(device_id: int = 0) -> dict:
    import torch

    if not torch.cuda.is_available():
        return {"platform": "cpu", "device_kind": "cpu", "num_devices": 0,
                "sm_count": None, "capability": None, "bytes_limit": None}
    p = torch.cuda.get_device_properties(device_id)
    return {
        "platform": "cuda",
        "device_kind": torch.cuda.get_device_name(device_id),
        "num_devices": torch.cuda.device_count(),
        "sm_count": p.multi_processor_count,
        "capability": (p.major, p.minor),
        "bytes_limit": p.total_memory,
    }


def properties(device_id: int = 0) -> dict:
    return _properties(device_id)


def device_kind(device_id: int = 0) -> str:
    return properties(device_id)["device_kind"]


def num_devices() -> int:
    return properties()["num_devices"]


def clear_cache() -> None:
    _properties.cache_clear()
