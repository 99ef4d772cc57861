"""Lazy nvcc build + ctypes load of the CUDA kernels, and their launch
counters.

``load_library()`` compiles each ``loops_tpu_torch/csrc/*.cu`` with its
own nvcc, all started together, and links the objects into one shared
library with a plain C interface, ``libloops_kernels_<hash>.so`` under
``loops_tpu_torch/_build/`` and keyed by a hash of the sources (the
``*.cu`` files and the ``*.cuh`` headers they include) and flags,
then loads it with ctypes — the same lazy-build pattern as
``loops_tpu/native/build.py``, by ``utils/libbuild.py``. It runs at the
first kernel launch (or when called directly), never at import: the CPU
tests import every module on machines without nvcc or a card.

Each kernel wrapper adds one to its entry of ``LAUNCHES`` where it
launches its kernel and nowhere else, so a run can show which kernels its
main path went through.
"""
from __future__ import annotations

import ctypes
import operator
import os
import shutil
import subprocess
import threading
import time

import torch

from loops_tpu_torch.utils import libbuild

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

# per-source compile flags; the objects are then linked with -shared
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

LAUNCHES = {"sorted_spmv": 0, "flat_spmv_v2": 0, "flat_spmv": 0,
            "flat_spmm": 0, "bcsr_spmv": 0, "bcsr_spmm": 0,
            "bcsr_spmm_v2": 0, "bcsr_spmm_v3": 0, "sddmm_flat": 0,
            "sddmm_bcsr": 0, "stream_read": 0, "saxpy": 0,
            "seg_scan_probe": 0, "construct_probe": 0, "launch_floor": 0,
            "block_dot_f32": 0,
            "block_dot_bf16": 0, "smem_scatter": 0, "l2_scatter": 0,
            "gather_axis0": 0, "gather_axis1": 0, "row_gather_sum_smem": 0,
            "row_gather_sum_l2": 0, "row_gather_sum_hbm": 0,
            "row_gather_mat_smem": 0, "row_gather_mat_l2": 0,
            "row_gather_mat_hbm": 0, "onehot_expand": 0}

# seconds the last build took in this process (0.0 when the library
# came from an earlier build of the same sources)
BUILD_INFO = {"seconds": None, "path": None}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "loops_sorted_spmv_f32": [_P] * 9 + [_I] * 4 + [_P],
    "loops_flat_spmv_v2_f32": [_P] * 11 + [_I] * 3 + [_P],
    "loops_flat_spmv_f32": [_P] * 10 + [_I] * 5 + [_P],
    "loops_flat_spmm": [_P] * 11 + [_I] * 6 + [_P],
    "loops_bcsr_spmv_f32": [_P] * 8 + [_I] * 6 + [_P],
    "loops_bcsr_spmm_f32": [_P] * 5 + [_I] * 7 + [_P],
    "loops_bcsr_spmm_v2": [_P] * 6 + [_I] * 11 + [_P],
    "loops_bcsr_spmm_v3": [_P] * 9 + [_I] * 12 + [_P],
    "loops_sddmm_flat": [_P] * 6 + [_I] * 4 + [_P],
    "loops_bcsr_sddmm_f32": [_P] * 8 + [_I] * 9 + [_P],
    "loops_stream_read_f32": [_P] * 2 + [_I] * 3 + [_P],
    "loops_saxpy_f32": [ctypes.c_float] + [_P] * 3 + [_I, _I, _P],
    "loops_seg_scan_probe": [_P] * 3 + [_I, _I, _P],
    "loops_construct_probe": [_I] + [_P] * 4 + [_I, _P],
    "loops_launch_floor": [_P, _I, _P],
    "loops_block_dot": [_P] * 3 + [_I] * 6 + [_P],
    "loops_scatter_smem": [_P] * 5 + [_I] * 5 + [_P],
    "loops_scatter_smem_clusters": [_I],
    "loops_scatter_l2": [_P] * 4 + [_I] * 5 + [_P],
    "loops_gather_axis0": [_P] * 3 + [_I] * 4 + [_P],
    "loops_gather_axis1": [_P] * 3 + [_I] * 2 + [_P],
    "loops_row_gather": [_P] * 3 + [_I] * 7 + [_P],
    "loops_onehot_expand": [_P] * 3 + [_I] * 5 + [_P],
}

_lib = None
_lock = threading.Lock()
# C entry point -> its ctypes function, argtypes set; filled by
# load_library()
_FNS: dict = {}
# device index -> SM count (sm_count)
_SMS: dict = {}
# the current stream's handle without building a torch.cuda.Stream (the
# call PyTorch's own generated launchers make); absent from CPU builds
_CURRENT_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)
# set by utils/trace.profile while its window is open: each launch then
# goes through it, ``RECORDER(counter, fn, c_args, index) -> err``, which
# brackets the kernel with a CUDA event pair; None outside a window
RECORDER = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _sources():
    """Every source the library depends on: ``*.cu`` and the ``*.cuh``
    headers they include (hashed; only the ``*.cu`` are compiled)."""
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
    """Build (if needed) and load the kernels' shared library, and resolve
    each C entry point of ``_SIGNATURES`` once into ``_FNS``."""
    global _lib
    if _lib is not None:  # loaded: no lock on the launch path
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        files = _sources()
        so_path = libbuild.library_path(BUILD_DIR, "loops_kernels", files,
                                        NVCC_FLAGS)
        t0 = time.perf_counter()
        if not os.path.exists(so_path):
            _build([f for f in files if f.endswith(".cu")], so_path)
        lib = ctypes.CDLL(so_path)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _FNS[name] = fn
        BUILD_INFO.update(seconds=time.perf_counter() - t0, path=so_path)
        _lib = lib
        return lib


def _start(cmd):
    return cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)


def _run(procs) -> None:
    """Wait for every ``(cmd, Popen)`` (killing all of them if one
    outlasts its time); raise listing every failure."""
    failed = []
    try:
        for cmd, proc in procs:
            _, err = proc.communicate(timeout=600)
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}): "
                              f"{' '.join(cmd)}\n{err[-4000:]}")
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise RuntimeError("\n".join(failed))


def _build(files, so_path: str) -> None:
    """One nvcc per source, all started together, then one link; the
    library is renamed into place, atomically when processes build at
    once."""
    nvcc = _nvcc()

    def make(tmp, tag):
        objs = [os.path.join(BUILD_DIR, f"{os.path.basename(f)}.{tag}.o")
                for f in files]
        try:
            _run([_start([nvcc, *NVCC_FLAGS, "-c", "-o", o, f])
                  for f, o in zip(files, objs)])
            _run([_start([nvcc, "-shared", "-o", tmp, *objs])])
        finally:
            for o in objs:
                if os.path.exists(o):
                    os.remove(o)
    libbuild.publish(so_path, make)


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


def staged_fingerprint(b: dict) -> tuple:
    """What a wrapper's check of its staged buffers reads of each one and
    an in-place change (``resize_``, ``set_``, ``as_strided_``) can
    alter: its address, its size, its type and whether it is
    contiguous."""
    return tuple((t.data_ptr(), t.numel(), t.dtype, t.is_contiguous())
                 for t in b.values())


def staged_unchanged(b: dict, staged: tuple, fingerprint: tuple) -> bool:
    """Whether ``b`` holds the very tensors ``staged``, none changed in
    place since ``fingerprint`` was taken of them: a kernel whose buffers
    were checked at bind need not check them again."""
    return (len(b) == len(staged)
            and all(map(operator.is_, b.values(), staged))
            and staged_fingerprint(b) == fingerprint)


def staged_guard(bufs: dict, params: dict, check_staged):
    """Check a kernel's staged buffers once, at bind (on a card), with
    ``check_staged(bufs, params, device)``, and return ``staged_on(b)``:
    the device they were checked on while ``b`` holds those very tensors,
    none changed in place since, else None (the wrapper then checks ``b``
    in full)."""
    device = next(iter(bufs.values())).device
    if device.type == "cuda":
        check_staged(bufs, params, device)
    staged = tuple(bufs.values())
    fingerprint = staged_fingerprint(bufs)

    def staged_on(b: dict):
        return device if staged_unchanged(b, staged, fingerprint) else None
    return staged_on


def output(out, shape, device) -> torch.Tensor:
    """``out``, checked to be a contiguous float32 tensor of ``shape`` (an
    int for a vector) on ``device``, or a new ``torch.empty`` of it (for a
    kernel that writes every element: no fill)."""
    if out is None:
        return torch.empty(shape, dtype=torch.float32, device=device)
    check(out, "out", torch.float32, device)
    want = (tuple(shape) if isinstance(shape, (tuple, list))
            else (int(shape),))
    if tuple(out.shape) != want:
        raise ValueError(f"out has shape {tuple(out.shape)}, expected {want}")
    return out


def _function(fn_name: str):
    """The ctypes function of a C entry point of ``_SIGNATURES``, loading
    the library on first use; ``KeyError`` for any other name."""
    fn = _FNS.get(fn_name)
    if fn is None:
        load_library()
        fn = _FNS[fn_name]
    return fn


def _raw_stream(index: int) -> int:
    """The handle of device ``index``'s current CUDA stream, asked anew on
    every launch, so a launch under ``torch.cuda.stream(s)`` goes on
    ``s``."""
    if _CURRENT_RAW_STREAM is not None:
        return _CURRENT_RAW_STREAM(index)
    return torch.cuda.current_stream(index).cuda_stream


def sm_count(device) -> int:
    """The streaming multiprocessors of CUDA ``device``, asked once per
    device."""
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    n = _SMS.get(index)
    if n is None:
        n = _SMS[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return n


def launch(fn_name: str, counter: str, device, *args) -> None:
    """Call a C entry point on ``device``'s current stream; tensors in
    ``args`` pass as pointers, ints and floats as the entry point's
    ``_SIGNATURES`` say. Raises ``KeyError`` on a counter not in
    ``LAUNCHES`` (before launching) and ``RuntimeError`` on a nonzero CUDA
    error code.

    The path is kept short, since at small sizes an apply costs what it
    takes the host to launch: the function is resolved once at load,
    tensors pass as plain ints, the device is made current only when it
    is not already, and outside a ``trace.profile`` window the kernel
    record costs one test of ``RECORDER``."""
    if counter not in LAUNCHES:
        raise KeyError(f"{counter!r} is not a launch counter of _build")
    fn = _function(fn_name)
    c_args = [a.data_ptr() if isinstance(a, torch.Tensor) else a
              for a in args]
    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    if index == current:
        err = (fn(*c_args, _raw_stream(index)) if RECORDER is None
               else RECORDER(counter, fn, c_args, index))
    else:
        with torch.cuda.device(index):
            err = (fn(*c_args, _raw_stream(index)) if RECORDER is None
                   else RECORDER(counter, fn, c_args, index))
    if err != 0:
        raise RuntimeError(f"{fn_name}: CUDA error {err} at launch")
    LAUNCHES[counter] += 1
