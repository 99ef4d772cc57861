"""Lazy nvcc build of the CUDA kernels, their launch binding, and their
launch counters.

``load_library()`` compiles each ``loops_tpu_torch/csrc/*.cu`` with its
own nvcc, all started together, and links the objects into one shared
library with a plain C interface, ``libloops_kernels_<hash>.so`` under
``loops_tpu_torch/_build/`` and keyed by a hash of the sources (the
``*.cu`` files and the ``*.cuh`` headers they include) and flags — the
same lazy-build pattern as ``loops_tpu/native/build.py``, by
``utils/libbuild.py``. It runs at the first kernel launch (or when
called directly), never at import: the CPU tests import every module on
machines without nvcc or a card.

Kernels are called through the launch binding, not ctypes: a CPython
extension, ``libloops_launch_<hash>.so`` in the same directory, whose C
source ``binding_source()`` generates from ``_SIGNATURES`` (one
``METH_FASTCALL`` function per entry point, converting each argument
with ``PyLong_AsVoidPtr``, ``PyLong_AsLong`` or ``PyFloat_AsDouble`` and
calling the entry point through its address). The host compiler
(``utils/libbuild.host_compiler``, g++, as the native tier) builds it
against ``Python.h`` alone, in about a second, keyed by the hash of that
source and its flags. The library is opened once, with ctypes, to read
each entry point's address; ``_FNS`` then holds one binding callable per
entry point, and a launch costs one C-API call. No binding, no launch:
a failed build raises.

Each kernel wrapper adds one to its entry of ``LAUNCHES`` where it
launches its kernel and nowhere else, so a run can show which kernels its
main path went through.
"""
from __future__ import annotations

import ctypes
import importlib.util
import operator
import os
import shutil
import subprocess
import sysconfig
import threading
import time

import torch

from loops_tpu_torch.utils import libbuild

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
# where the launch binding is built: the kernels' directory, fixed at
# import (a build of the kernels elsewhere shares the binding)
BIND_DIR = BUILD_DIR

# per-source compile flags; the objects are then linked with -shared
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")
# the launch binding's host compiler flags (the Python headers' -I is
# added at build time)
BIND_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-fvisibility=hidden")

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

# seconds the last load took in this process (the builds included; small
# when both came from an earlier build of the same sources)
BUILD_INFO = {"seconds": None, "path": None, "binding_seconds": None,
              "binding_path": None}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # the packed plan (spmv_sorted._SortedPlan), x, y, the scratch
    "loops_sorted_spmv_f32": [_P] * 4 + [_P],
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

# the C type of each ctypes type of _SIGNATURES, and its code in the
# binding's SIGNATURES
_C_TYPES = {_P: ("void*", "p"), _I: ("int", "i"),
            ctypes.c_float: ("float", "f")}

_lib = None
_lock = threading.Lock()
# C entry point -> its launch binding callable; filled by load_library()
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
# what kernels count on the card for a trace.profile window, each an
# object with start() and read() -> dict (window_counter)
WINDOW_COUNTERS: list = []


def window_counter(counter):
    """Register ``counter`` with every ``utils/trace.profile`` window:
    ``counter.start()`` runs before the window opens, and the dict
    ``counter.read()`` returns goes into the window's record after it
    closes. Returns ``counter``."""
    WINDOW_COUNTERS.append(counter)
    return counter


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
    """Build (if needed) and load the kernels' shared library and the
    launch binding, and bind each C entry point of ``_SIGNATURES`` once
    into ``_FNS``. Raises when either cannot be built."""
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
        t1 = time.perf_counter()
        binding = load_binding()
        t2 = time.perf_counter()
        lib = ctypes.CDLL(so_path)
        _FNS.update(bind(binding, lib))
        BUILD_INFO.update(seconds=t1 - t0, path=so_path,
                          binding_seconds=t2 - t1,
                          binding_path=binding.__file__)
        _lib = lib
        return lib


def bind(binding, lib: ctypes.CDLL) -> dict:
    """``name -> callable`` for each entry point of ``_SIGNATURES``: the
    launch binding's function of that name, called on the entry point's
    address in ``lib`` (read here, once)."""
    return {name: binding.bind(name, ctypes.cast(getattr(lib, name),
                                                 ctypes.c_void_p).value)
            for name in _SIGNATURES}


def binding_source() -> str:
    """The launch binding's C++ source, generated from ``_SIGNATURES``:
    for each entry point a ``METH_FASTCALL`` function that checks the
    count, converts each argument as ctypes' type of it would (a pointer:
    an int, a numpy integer or None; an ``int``: an int or numpy integer
    in range; a ``float``: any real number), raising ``TypeError`` on
    anything else, and calls the entry point's address (held in the
    callable's capsule) with the GIL held; ``bind(name, address)`` makes
    the callable, ``SIGNATURES`` maps each name to its type codes."""
    defs, funcs, sigs = [], [], []
    for name, argtypes in _SIGNATURES.items():
        ctys = [_C_TYPES[t][0] for t in argtypes]
        codes = "".join(_C_TYPES[t][1] for t in argtypes)
        n = len(argtypes)
        conv = " ||\n      ".join(
            f"arg_{c}(args[{k}], &a{k}, \"{name}\", {k})"
            for k, c in enumerate(codes))
        decl = "\n".join(f"  {c} a{k};" for k, c in enumerate(ctys))
        call = ", ".join(f"a{k}" for k in range(n))
        funcs.append(f"""
typedef int (*t_{name})({", ".join(ctys)});
static PyObject* w_{name}(PyObject* self, PyObject* const* args,
                          Py_ssize_t nargs) {{
  if (nargs != {n}) return wrong_count("{name}", {n}, nargs);
{decl}
  if ({conv}) return NULL;
  void* fn = PyCapsule_GetPointer(self, CAPSULE);
  if (fn == NULL) return NULL;
  return PyLong_FromLong(((t_{name})fn)({call}));
}}""")
        defs.append(f'  {{"{name}", (PyCFunction)(void (*)(void))w_{name}, '
                    f'METH_FASTCALL, "int {name}({", ".join(ctys)})"}},')
        sigs.append(f'  {{"{name}", "{codes}"}},')
    return _BINDING_TEMPLATE.format(funcs="".join(funcs),
                                    defs="\n".join(defs),
                                    sigs="\n".join(sigs))


_BINDING_TEMPLATE = """\
// The launch binding of loops_tpu_torch's kernels, generated from
// _SIGNATURES by ops/kernels/_build.py binding_source(): one
// METH_FASTCALL function per C entry point. Python.h only.
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <climits>
#include <cstring>

namespace {{

const char* const CAPSULE = "loops_tpu_torch entry point";

PyObject* wrong_count(const char* fn, Py_ssize_t want, Py_ssize_t got) {{
  PyErr_Format(PyExc_TypeError, "%s() takes %zd arguments (%zd given)", fn,
               want, got);
  return NULL;
}}

int wrong_type(PyObject* o, const char* fn, int k, const char* want) {{
  PyErr_Format(PyExc_TypeError, "%s() argument %d: expected %s, got %.100s",
               fn, k, want, Py_TYPE(o)->tp_name);
  return -1;
}}

// a conversion that raised TypeError (a float tensor's __index__):
// raised again naming the argument
int retyped(PyObject* o, const char* fn, int k, const char* want) {{
  if (!PyErr_ExceptionMatches(PyExc_TypeError)) return -1;
  PyErr_Clear();
  return wrong_type(o, fn, k, want);
}}

// a pointer: an int, anything with __index__ (numpy integers), or None
int arg_p(PyObject* o, void** out, const char* fn, int k) {{
  if (PyLong_CheckExact(o)) {{
    *out = PyLong_AsVoidPtr(o);
    return (*out == NULL && PyErr_Occurred()) ? -1 : 0;
  }}
  if (o == Py_None) {{
    *out = NULL;
    return 0;
  }}
  const char* want = "an integer or None";
  if (!PyIndex_Check(o)) return wrong_type(o, fn, k, want);
  PyObject* i = PyNumber_Index(o);
  if (i == NULL) return retyped(o, fn, k, want);
  *out = PyLong_AsVoidPtr(i);
  Py_DECREF(i);
  return (*out == NULL && PyErr_Occurred()) ? -1 : 0;
}}

// an int: an int or anything with __index__, within a C int
int arg_i(PyObject* o, int* out, const char* fn, int k) {{
  const char* want = "an integer";
  if (!PyLong_Check(o) && !PyIndex_Check(o)) return wrong_type(o, fn, k, want);
  long v = PyLong_AsLong(o);
  if (v == -1 && PyErr_Occurred()) return retyped(o, fn, k, want);
  if (v < INT_MIN || v > INT_MAX) {{
    PyErr_Format(PyExc_OverflowError, "%s() argument %d: %ld is past a C int",
                 fn, k, v);
    return -1;
  }}
  *out = static_cast<int>(v);
  return 0;
}}

// a float: any real number (__float__ or __index__), rounded to float
int arg_f(PyObject* o, float* out, const char* fn, int k) {{
  double v = PyFloat_AsDouble(o);
  if (v == -1.0 && PyErr_Occurred()) return retyped(o, fn, k, "a real number");
  *out = static_cast<float>(v);
  return 0;
}}
{funcs}

PyMethodDef entries[] = {{
{defs}
  {{NULL, NULL, 0, NULL}}}};

const char* const signatures[][2] = {{
{sigs}
  {{NULL, NULL}}}};

// bind(name, address) -> the entry point's callable at ``address``
PyObject* bind(PyObject*, PyObject* const* args, Py_ssize_t nargs) {{
  if (nargs != 2) return wrong_count("bind", 2, nargs);
  const char* name = PyUnicode_AsUTF8(args[0]);
  if (name == NULL) return NULL;
  void* addr = NULL;
  if (arg_p(args[1], &addr, "bind", 1)) return NULL;
  if (addr == NULL) {{
    PyErr_SetString(PyExc_ValueError, "bind: a null address");
    return NULL;
  }}
  for (PyMethodDef* d = entries; d->ml_name != NULL; ++d) {{
    if (std::strcmp(d->ml_name, name) != 0) continue;
    PyObject* cap = PyCapsule_New(addr, CAPSULE, NULL);
    if (cap == NULL) return NULL;
    PyObject* f = PyCFunction_NewEx(d, cap, NULL);
    Py_DECREF(cap);
    return f;
  }}
  PyErr_Format(PyExc_KeyError, "%s is not an entry point of the binding",
               name);
  return NULL;
}}

PyMethodDef methods[] = {{
  {{"bind", (PyCFunction)(void (*)(void))bind, METH_FASTCALL,
   "bind(name, address) -> the entry point's callable"}},
  {{NULL, NULL, 0, NULL}}}};

PyModuleDef module = {{PyModuleDef_HEAD_INIT, "loops_launch",
                      "The launch binding of loops_tpu_torch's kernels.", -1,
                      methods}};

}}  // namespace

PyMODINIT_FUNC PyInit_loops_launch(void) {{
  PyObject* m = PyModule_Create(&module);
  if (m == NULL) return NULL;
  PyObject* sigs = PyDict_New();
  if (sigs == NULL || PyModule_AddObject(m, "SIGNATURES", sigs) < 0) {{
    Py_XDECREF(sigs);
    Py_DECREF(m);
    return NULL;
  }}
  for (int i = 0; signatures[i][0] != NULL; ++i) {{
    PyObject* v = PyUnicode_FromString(signatures[i][1]);
    if (v == NULL || PyDict_SetItemString(sigs, signatures[i][0], v) < 0) {{
      Py_XDECREF(v);
      Py_DECREF(m);
      return NULL;
    }}
    Py_DECREF(v);
  }}
  return m;
}}
"""


def _python_include() -> str:
    """The directory of this interpreter's ``Python.h``; raises when it
    is missing."""
    inc = sysconfig.get_paths()["include"]
    if not os.path.exists(os.path.join(inc, "Python.h")):
        raise RuntimeError(
            f"Python.h not found under {inc}: the launch binding of "
            "loops_tpu_torch's kernels is built from Python's headers")
    return inc


def load_binding():
    """The launch binding module, built by the host compiler at first use
    into ``BIND_DIR`` and keyed by the hash of its generated source and
    flags; raises ``RuntimeError`` when it cannot be built."""
    src = binding_source()
    flags = BIND_FLAGS + (f"-I{_python_include()}",)
    path = libbuild.library_path(BIND_DIR, "loops_launch", (), flags,
                                 texts=(src,))
    if not os.path.exists(path):
        try:
            cxx = libbuild.host_compiler()
        except FileNotFoundError as e:
            raise RuntimeError(f"the launch binding needs a host compiler: "
                               f"{e}") from e

        def make(tmp, tag):
            cpp = f"{tmp}.cpp"
            try:
                with open(cpp, "w") as fh:
                    fh.write(src)
                proc = subprocess.run([cxx, *flags, "-o", tmp, cpp],
                                      capture_output=True, text=True,
                                      timeout=300)
            finally:
                if os.path.exists(cpp):
                    os.remove(cpp)
            if proc.returncode != 0:
                raise RuntimeError(f"the launch binding failed to build "
                                   f"({proc.returncode}):\n"
                                   f"{proc.stderr[-4000:]}")
        libbuild.publish(path, make)
    spec = importlib.util.spec_from_file_location("loops_launch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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


_VERSION = operator.attrgetter("_version")


def staged_fingerprint(b: dict) -> tuple:
    """What can change a staged buffer after a wrapper's check of it:
    each tensor's version counter, which every in-place change bumps
    (``resize_``, ``set_``, ``as_strided_``, a write), and its address,
    which a change of its memory alone moves (``.data =``, a storage
    resized). An inference tensor keeps no version counter: its address,
    size, type and contiguity then."""
    ts = tuple(b.values())
    try:
        return list(map(_VERSION, ts)), list(map(torch.Tensor.data_ptr, ts))
    except RuntimeError:
        return tuple((t.data_ptr(), t.numel(), t.dtype, t.is_contiguous())
                     for t in ts)


def staged_unchanged(b: dict, staged: tuple, fingerprint: tuple) -> bool:
    """Whether ``b`` holds the very tensors ``staged``, none changed since
    ``fingerprint`` was taken of them: a kernel whose buffers were checked
    at bind need not check them again."""
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
    """The launch binding's callable of a C entry point of
    ``_SIGNATURES``, loading the library on first use; ``KeyError`` for
    any other name."""
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
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    call(fn, fn_name, counter, index, c_args, _raw_stream(index))


def call(fn, fn_name: str, counter: str, index: int, c_args,
         stream: int) -> None:
    """``launch`` past its conversions, for a wrapper that keeps them
    itself: ``fn`` resolved (``_function``), ``c_args`` plain ints,
    ``stream`` the handle of device ``index``'s current stream, asked on
    this call (``_raw_stream``); ``counter`` one of ``LAUNCHES``."""
    if index == torch.cuda.current_device():
        err = (fn(*c_args, stream) if RECORDER is None
               else RECORDER(counter, fn, c_args, index))
    else:
        with torch.cuda.device(index):
            err = (fn(*c_args, stream) if RECORDER is None
                   else RECORDER(counter, fn, c_args, index))
    if err != 0:
        raise RuntimeError(f"{fn_name}: CUDA error {err} at launch")
    LAUNCHES[counter] += 1
