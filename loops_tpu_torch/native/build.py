"""Lazy g++ build and ctypes load of the native host tier.

Compiles ``src/*.cpp`` into one shared library,
``_build/libloops_native_<hash>.so``, keyed by a hash of the sources and
the flags, so the first use pays about a second of g++ and every later
one only loads it (``loops_tpu/native/build.py`` does the same), by
``utils/libbuild.py``, as the CUDA kernels are built. No
``-march=native``: a checkout copied to another host must not
load code built for this host's instruction set.

No toolchain, or a build that fails: ``load_library`` returns None and
each call site takes its numpy path.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess

from loops_tpu_torch.utils import libbuild

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_HERE, "src")
BUILD_DIR = os.path.join(_HERE, "_build")
FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lib = None
_tried = False


def _source_files():
    if not os.path.isdir(SRC_DIR):
        return []
    return sorted(os.path.join(SRC_DIR, f) for f in os.listdir(SRC_DIR)
                  if f.endswith(".cpp"))


def library_path(files) -> str:
    """Where the library of these sources and ``FLAGS`` lives."""
    return libbuild.library_path(BUILD_DIR, "loops_native", files, FLAGS)


def _build(files, so_path: str) -> None:
    gxx = shutil.which("g++")
    if gxx is None:
        raise FileNotFoundError("g++ not found")

    def make(tmp, tag):
        subprocess.run([gxx, *FLAGS, "-o", tmp, *files], check=True,
                       capture_output=True, timeout=300)
    libbuild.publish(so_path, make)


def load_library():
    """The native tier's ``ctypes.CDLL``, built at the first call; None
    (remembered) when no compiler is found or the build fails."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    files = _source_files()
    if not files:
        return None
    try:
        so_path = library_path(files)
        if not os.path.exists(so_path):
            _build(files, so_path)
        _lib = ctypes.CDLL(so_path)
    except (OSError, subprocess.SubprocessError):
        _lib = None
    return _lib
