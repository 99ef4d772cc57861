"""Filepath helpers (reference: util/filepath.hxx:18-35)."""
from __future__ import annotations

import os


def extract_filename(path: str) -> str:
    return os.path.basename(path)


def extract_dataset(path: str) -> str:
    """Dataset name = filename without extension."""
    return os.path.splitext(os.path.basename(path))[0]


def is_market(path: str) -> bool:
    return path.endswith(".mtx")


def is_binary_csr(path: str) -> bool:
    return path.endswith((".csr", ".csr.npz"))
