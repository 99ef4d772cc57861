"""Lazy nvcc build + ctypes load of the CUDA kernels, and their launch
counters.

``load_library()`` compiles ``loops_tpu_torch/csrc/*.cu`` with nvcc into
one shared library with a plain C interface, under
``loops_tpu_torch/_build/`` and keyed by a hash of the sources, then
loads it with ctypes — the same lazy-build pattern as
``loops_tpu/native/build.py``. It runs at the first kernel launch (or
when called directly), never at import: the CPU tests import every
module on machines without nvcc or a card.

Each kernel wrapper adds one to its entry of ``LAUNCHES`` where it
launches its kernel and nowhere else, so a run can show which kernels its
main path went through.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

LAUNCHES = {"sorted_spmv": 0, "flat_spmv_v2": 0, "flat_spmv": 0}

# seconds the last build took in this process (0.0 when the library
# came from an earlier build of the same sources)
BUILD_INFO = {"seconds": None, "path": None}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "loops_sorted_spmv_f32": [_P] * 9 + [_I, _I, _P],
    "loops_flat_spmv_v2_f32": [_P] * 11 + [_I, _I, _P],
    "loops_flat_spmv_f32": [_P] * 10 + [_I, _I, _I, _P],
}

_lib = None
_lock = threading.Lock()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _sources():
    return sorted(os.path.join(SRC_DIR, f) for f in os.listdir(SRC_DIR)
                  if f.endswith((".cu", ".cuh")))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home and os.path.exists(os.path.join(cuda_home, "bin", "nvcc")):
        return os.path.join(cuda_home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
        "kernels of loops_tpu_torch are built from csrc/ at first use")


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernels' shared library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        files = _sources()
        h = hashlib.sha256()
        for f in files:
            with open(f, "rb") as fh:
                h.update(fh.read())
        h.update(" ".join(NVCC_FLAGS).encode())
        so_path = os.path.join(BUILD_DIR, f"libloops_spmv_{h.hexdigest()[:16]}.so")
        t0 = time.perf_counter()
        if not os.path.exists(so_path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so_path}.tmp{os.getpid()}"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *files]
            res = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=600)
            if res.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n"
                    f"{res.stderr[-4000:]}")
            os.replace(tmp, so_path)  # atomic when processes build at once
        lib = ctypes.CDLL(so_path)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        BUILD_INFO.update(seconds=time.perf_counter() - t0, path=so_path)
        _lib = lib
        return lib


def check(t, name: str, dtype, device, numel: int | None = None):
    """Raise ``ValueError`` unless ``t`` is a contiguous ``dtype`` tensor
    on ``device`` with ``numel`` elements."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if numel is not None and t.numel() != numel:
        raise ValueError(f"{name} has {t.numel()} elements, expected {numel}")


def launch(fn_name: str, counter: str, device, *args) -> None:
    """Call a C entry point on ``device``'s current stream; tensors in
    ``args`` pass as pointers, ints as C ints. Raises on a nonzero CUDA
    error code."""
    import torch

    lib = load_library()
    c_args = [ctypes.c_void_p(a.data_ptr()) if isinstance(a, torch.Tensor)
              else ctypes.c_int(int(a)) for a in args]
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = getattr(lib, fn_name)(*c_args, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{fn_name}: CUDA error {err} at launch")
    LAUNCHES[counter] += 1
