"""The hash-keyed build of a shared library, shared by the port's two
compiled tiers: the CUDA kernels (``ops/kernels/_build.py``, nvcc) and
the native host tier (``native/build.py``, g++).

A library's name holds a hash of its sources and flags, so a change to
either builds a new one and an unchanged tree only loads it. The
compiler writes to a name of its own process, and the file is renamed
into place: processes that build at once never load a half-written
library, and the last rename wins.
"""
from __future__ import annotations

import hashlib
import os


def library_path(build_dir: str, stem: str, sources, flags) -> str:
    """``build_dir/lib<stem>_<hash>.so``, the hash over the bytes of
    ``sources`` and the ``flags``."""
    h = hashlib.sha256()
    for f in sources:
        with open(f, "rb") as fh:
            h.update(fh.read())
    h.update(" ".join(flags).encode())
    return os.path.join(build_dir, f"lib{stem}_{h.hexdigest()[:16]}.so")


def publish(so_path: str, make) -> None:
    """``make(tmp, tag)`` writes the library to ``tmp``, a name of this
    process (``tag`` names its other files, which it removes), and it is
    renamed into ``so_path``."""
    os.makedirs(os.path.dirname(so_path), exist_ok=True)
    tag = f"tmp{os.getpid()}"
    tmp = f"{so_path}.{tag}"
    try:
        make(tmp, tag)
        os.replace(tmp, so_path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
