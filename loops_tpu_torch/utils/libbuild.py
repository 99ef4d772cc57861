"""The hash-keyed build of a shared library, shared by the port's
compiled tiers: the CUDA kernels (``ops/kernels/_build.py``, nvcc), their
launch binding (the same module, g++) and the native host tier
(``native/build.py``, g++).

A library's name holds a hash of its sources and flags, so a change to
either builds a new one and an unchanged tree only loads it. The
compiler writes to a name of its own process, and the file is renamed
into place: processes that build at once never load a half-written
library, and the last rename wins.
"""
from __future__ import annotations

import hashlib
import os
import shutil


def library_path(build_dir: str, stem: str, sources, flags,
                 texts=()) -> str:
    """``build_dir/lib<stem>_<hash>.so``, the hash over the bytes of
    ``sources``, the ``flags`` and ``texts`` (sources generated in
    memory)."""
    h = hashlib.sha256()
    for f in sources:
        with open(f, "rb") as fh:
            h.update(fh.read())
    h.update(" ".join(flags).encode())
    for t in texts:
        h.update(t.encode())
    return os.path.join(build_dir, f"lib{stem}_{h.hexdigest()[:16]}.so")


def host_compiler() -> str:
    """The host C++ compiler, ``g++`` on the path; raises
    ``FileNotFoundError`` without one."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise FileNotFoundError("g++ not found")
    return gxx


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
