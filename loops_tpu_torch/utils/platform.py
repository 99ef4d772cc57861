"""Explicit device choice.

``ensure_platform`` turns a user's device request into a
``torch.device``. Asking for ``cuda`` on a machine without a usable card
raises: a run that asked for the GPU never drops to the CPU quietly.
"""
from __future__ import annotations


def ensure_platform(device="cuda"):
    """Return ``torch.device(device)``; raise ``RuntimeError`` when a CUDA
    device is asked for and ``torch.cuda.is_available()`` is false, or when
    its index is past the visible card count."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but CUDA is not "
                "available (no card, or a CPU-only torch build)")
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {str(device)!r} requested but only "
                f"{torch.cuda.device_count()} CUDA device(s) are visible")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r}; 'cuda' or 'cpu'")
    return dev


def resolve_device(device):
    """``torch.device(device)`` with a bare ``cuda`` resolved to the
    current card's index, so two names of one device compare equal."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev
