"""Checkpoint / resume for model and optimizer state.

The port of ``loops_tpu/models/checkpoint.py``: the state is a dict of
PyTorch state dicts and plain values, for example
``{"model": model.state_dict(), "optimizer": opt.state_dict(),
"step": n}``, written with ``torch.save`` and read back with
``torch.load`` (tensors only, no pickled code).
"""
from __future__ import annotations

import os

import torch


def save(path: str, state) -> None:
    """Write ``state`` to ``path`` (parent directories are created); the
    file is renamed into place, so a reader never sees half of it."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(state, tmp)
    os.replace(tmp, path)


def restore(path: str, map_location="cpu"):
    """Read a state written by :func:`save`; tensors land on
    ``map_location``."""
    return torch.load(path, map_location=map_location, weights_only=True)
