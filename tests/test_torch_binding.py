"""The launch binding of the port's kernels (``ops/kernels/_build.py``
``binding_source``, ``load_binding``, ``bind``), on the CPU.

The binding is a CPython extension generated from ``_SIGNATURES`` and
built here by the host compiler, as on the card's machine. It is bound to
a stand-in kernels library, compiled here from a source generated from
the same table: each entry point records its arguments and returns the
code the test chose, with no CUDA. So each entry point is called through
the binding and through ctypes with the same arguments, and both must
reach the C side as the same values. The launch path's rules on top of
it (``tests/test_torch_launch_path.py``) use the same stand-in.
"""
import ctypes
import os
import subprocess
import types

import numpy as np
import pytest
import torch

from loops_tpu_torch.ops.kernels import _build
from loops_tpu_torch.utils import libbuild

NAMES = list(_build._SIGNATURES)
MAX_ARGS = 32
RING = 256


class _Call(ctypes.Structure):
    """One recorded call of the stand-in: the entry point's index in
    ``NAMES``, its argument count, each argument's bits (pointers and
    ints) or value (floats)."""
    _fields_ = [("fn", ctypes.c_int), ("nargs", ctypes.c_int),
                ("u", ctypes.c_uint64 * MAX_ARGS),
                ("f", ctypes.c_double * MAX_ARGS)]


def stub_source() -> str:
    """The stand-in library's C++ source: every entry point of
    ``_SIGNATURES`` with its C types, recording its call into a ring of
    ``RING`` calls and returning ``stub_err[its index]``."""
    ctype = {ctypes.c_void_p: "void*", ctypes.c_int: "int",
             ctypes.c_float: "float"}
    out = ["#include <cstdint>",
           "struct Call { int fn; int nargs; uint64_t u[%d]; double f[%d]; };"
           % (MAX_ARGS, MAX_ARGS),
           'extern "C" {',
           f"Call stub_calls[{RING}];",
           "int stub_ncalls = 0;",
           f"int stub_err[{len(NAMES)}];"]
    for k, (name, argtypes) in enumerate(_build._SIGNATURES.items()):
        params = ", ".join(f"{ctype[t]} a{i}" for i, t in enumerate(argtypes))
        body = []
        for i, t in enumerate(argtypes):
            if t is ctypes.c_float:
                body.append(f"c->f[{i}] = a{i};")
            elif t is ctypes.c_int:
                body.append(f"c->u[{i}] = (uint64_t)(int64_t)a{i};")
            else:
                body.append(f"c->u[{i}] = (uint64_t)(uintptr_t)a{i};")
        out.append(
            f"int {name}({params}) {{\n"
            f"  Call* c = &stub_calls[stub_ncalls++ % {RING}];\n"
            f"  c->fn = {k}; c->nargs = {len(argtypes)};\n  "
            + "\n  ".join(body) + f"\n  return stub_err[{k}];\n}}")
    out.append('}  // extern "C"')
    return "\n".join(out) + "\n"


class StubRecord:
    """The calls a loaded stand-in library (``lib``) recorded, decoded
    by the entry point's types: a pointer as an unsigned int (0 for
    null), an ``int`` as a signed one, a ``float`` as its value."""

    def __init__(self, lib):
        self.lib = lib
        self.ring = (_Call * RING).in_dll(lib, "stub_calls")
        self.count = ctypes.c_int.in_dll(lib, "stub_ncalls")
        self.err = (ctypes.c_int * len(NAMES)).in_dll(lib, "stub_err")
        self.reset()

    def reset(self):
        self.count.value = 0
        for k in range(len(NAMES)):
            self.err[k] = 0

    def set_err(self, name: str, err: int):
        self.err[NAMES.index(name)] = err

    def calls(self, name: str | None = None) -> list:
        """``[(name, args)]`` of every call, or ``[args]`` of ``name``'s,
        in order."""
        assert self.count.value <= RING
        got = []
        for c in self.ring[:self.count.value]:
            fn = NAMES[c.fn]
            args = []
            for i, t in enumerate(_build._SIGNATURES[fn][:c.nargs]):
                if t is ctypes.c_float:
                    args.append(c.f[i])
                elif t is ctypes.c_int:
                    args.append(ctypes.c_int32(c.u[i] & 0xFFFFFFFF).value)
                else:
                    args.append(c.u[i])
            got.append((fn, tuple(args)))
        if name is None:
            return got
        return [a for fn, a in got if fn == name]


@pytest.fixture(scope="session")
def stub_so(tmp_path_factory):
    """The stand-in library, compiled once by the host compiler."""
    d = tmp_path_factory.mktemp("stub")
    src, so = d / "stub.cpp", d / "libstub.so"
    src.write_text(stub_source())
    subprocess.run([libbuild.host_compiler(), "-O1", "-shared", "-fPIC",
                    "-o", str(so), str(src)], check=True, capture_output=True,
                   timeout=120)
    return str(so)


def linking(stub_so):
    """A stand-in for ``_build._build``: the kernels' library is a link
    to the stand-in library (one file: a process that opens both shares
    its record)."""
    def build(files, so_path):
        os.makedirs(os.path.dirname(so_path), exist_ok=True)
        os.symlink(stub_so, so_path)
    return build


@pytest.fixture
def stub(stub_so):
    """``(binding, ctypes handle, record)``: the launch binding bound to
    the stand-in library (``fns``) and the same library through ctypes,
    argtypes set, for comparison."""
    lib = ctypes.CDLL(stub_so)
    rec = StubRecord(lib)
    fns = _build.bind(_build.load_binding(), lib)
    cfns = {}
    for name, argtypes in _build._SIGNATURES.items():
        f = getattr(lib, name)
        f.argtypes, f.restype = argtypes, ctypes.c_int
        cfns[name] = f
    yield fns, cfns, rec
    rec.reset()


def _sample_args(argtypes, seed):
    """Arguments of every kind the launch path passes: pointers as Python
    ints (addresses past 2^32, the stream) and numpy integers, ints
    (negative, numpy int64, int32, bool), floats (inexact in float32, an
    int, numpy float32)."""
    rng = np.random.default_rng(seed)
    args = []
    for i, t in enumerate(argtypes):
        k = (i + seed) % 3
        if t is ctypes.c_void_p:
            v = int(rng.integers(1, 2**47)) * 16
            args.append([v, np.int64(v), np.uint64(v)][k])
        elif t is ctypes.c_int:
            v = int(rng.integers(-2**31, 2**31))
            args.append([v, np.int64(v), np.int32(v)][k])
        else:
            args.append([2.5, float(rng.normal()), np.float32(-0.75)][k])
    return args


def _expected(argtypes, args):
    """The values ctypes' types of ``argtypes`` make of ``args``."""
    return tuple(
        float(np.float32(a)) if t is ctypes.c_float
        else (0 if a is None else int(a)) for t, a in zip(argtypes, args))


@pytest.mark.parametrize("name", NAMES)
def test_every_entry_point_passes_its_arguments_as_ctypes(stub, name):
    fns, cfns, rec = stub
    argtypes = _build._SIGNATURES[name]
    for seed in range(3):
        args = _sample_args(argtypes, seed)
        # ctypes refuses numpy integers for a pointer: give it the int
        cargs = [int(a) if t is ctypes.c_void_p else a
                 for t, a in zip(argtypes, args)]
        rec.reset()
        rec.set_err(name, 7 + seed)
        assert fns[name](*args) == 7 + seed
        assert cfns[name](*cargs) == 7 + seed
        (via_binding, via_ctypes) = rec.calls(name)
        assert via_binding == via_ctypes == _expected(argtypes, args)


def test_the_binding_has_each_signature_of_the_table(stub):
    fns, _, _ = stub
    codes = {ctypes.c_void_p: "p", ctypes.c_int: "i", ctypes.c_float: "f"}
    binding = _build.load_binding()
    assert binding.SIGNATURES == {
        name: "".join(codes[t] for t in argtypes)
        for name, argtypes in _build._SIGNATURES.items()}
    for name, fn in fns.items():
        assert isinstance(fn, types.BuiltinFunctionType)
        assert fn.__name__ == name
        assert len(_build._SIGNATURES[name]) == fn.__doc__.count(",") + 1


def test_none_is_a_null_pointer(stub):
    fns, cfns, rec = stub
    fns["loops_launch_floor"](None, 3, None)
    cfns["loops_launch_floor"](None, 3, None)
    assert rec.calls("loops_launch_floor") == [(0, 3, 0)] * 2


@pytest.mark.parametrize("case", ["few", "many", "none"])
def test_a_wrong_count_raises(stub, case):
    fns, _, rec = stub
    args = {"few": (1.0, 0, 0), "many": (1.0, 0, 0, 0, 1, 1, 0, 0),
            "none": ()}[case]
    with pytest.raises(TypeError, match="loops_saxpy_f32.. takes 7"):
        fns["loops_saxpy_f32"](*args)
    assert rec.calls() == []


@pytest.mark.parametrize("k,bad,kind", [
    (0, "2.5", TypeError), (0, None, TypeError),         # the float
    (1, 1.5, TypeError), (1, "0x10", TypeError),          # a pointer
    (1, torch.zeros(1), TypeError),
    (4, 8.0, TypeError), (4, None, TypeError),            # an int
    (4, 2**31, OverflowError), (5, -2**31 - 1, OverflowError),
    (1, 2**64, OverflowError)])
def test_a_wrong_argument_raises_and_calls_nothing(stub, k, bad, kind):
    # never a silent 0: what ctypes' type refuses or cuts is refused
    fns, _, rec = stub
    args = [2.5, 16, 32, 48, 8, 1, 4242]
    args[k] = bad
    with pytest.raises(kind, match=f"argument {k}" if kind is TypeError
                       else None):
        fns["loops_saxpy_f32"](*args)
    assert rec.calls() == []


def test_bind_refuses_an_unknown_name_and_a_null_address(stub_so):
    binding = _build.load_binding()
    with pytest.raises(KeyError, match="loops_nope"):
        binding.bind("loops_nope", 4096)
    with pytest.raises(ValueError, match="null"):
        binding.bind("loops_saxpy_f32", 0)


def test_binding_is_keyed_by_its_source(monkeypatch, tmp_path):
    # a change to the table is a new source, so a new library
    monkeypatch.setattr(_build, "BIND_DIR", str(tmp_path))
    a = _build.load_binding().__file__
    assert os.path.dirname(a) == str(tmp_path)
    monkeypatch.setitem(_build._SIGNATURES, "loops_saxpy_f32",
                        [ctypes.c_void_p] * 3)
    assert "t_loops_saxpy_f32)(void*, void*, void*)" in \
        _build.binding_source()
    b = _build.load_binding()
    assert b.__file__ != a and b.SIGNATURES["loops_saxpy_f32"] == "ppp"
    assert sorted(os.listdir(tmp_path)) == sorted(
        os.path.basename(p) for p in (a, b.__file__))


@pytest.mark.parametrize("missing", ["compiler", "headers", "broken"])
def test_a_binding_that_cannot_be_built_raises(monkeypatch, tmp_path,
                                               stub_so, missing):
    # no ctypes fallback: load_library raises and binds nothing
    monkeypatch.setattr(_build, "BIND_DIR", str(tmp_path / "bind"))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "kernels"))
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "_FNS", {})
    monkeypatch.setattr(_build, "_build", linking(stub_so))
    if missing == "compiler":
        def none():
            raise FileNotFoundError("g++ not found")
        monkeypatch.setattr(libbuild, "host_compiler", none)
        match = "host compiler"
    elif missing == "headers":
        monkeypatch.setattr(_build.sysconfig, "get_paths",
                            lambda: {"include": str(tmp_path)})
        match = "Python.h"
    else:
        monkeypatch.setattr(_build, "binding_source", lambda: "int f( {\n")
        match = "failed to build"
    with pytest.raises(RuntimeError, match=match):
        _build.load_library()
    assert _build._FNS == {} and _build._lib is None
    assert not os.path.exists(tmp_path / "bind") or not any(
        f.endswith(".so") for f in os.listdir(tmp_path / "bind"))


def test_load_library_binds_every_entry_point(monkeypatch, tmp_path,
                                              stub_so):
    # every value of _FNS is the binding's callable, none a ctypes one
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "_FNS", {})
    monkeypatch.setattr(_build, "_build", linking(stub_so))
    lib = _build.load_library()
    assert sorted(_build._FNS) == sorted(_build._SIGNATURES)
    for name, fn in _build._FNS.items():
        assert isinstance(fn, types.BuiltinFunctionType), name
        assert not isinstance(fn, ctypes._CFuncPtr), name
        assert fn.__self__.__class__.__name__ == "PyCapsule"
    assert _build.BUILD_INFO["binding_path"].startswith(_build.BIND_DIR)
    assert _build.load_library() is lib
    rec = StubRecord(lib)
    assert _build._FNS["loops_scatter_smem_clusters"](64) == 0
    assert rec.calls() == [("loops_scatter_smem_clusters", (64,))]
    rec.reset()


def test_call_raises_on_a_nonzero_code_and_counts_nothing(stub, monkeypatch):
    fns, _, rec = stub
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    rec.set_err("loops_stream_read_f32", 2)
    before = _build.LAUNCHES["stream_read"]
    with pytest.raises(RuntimeError, match="CUDA error 2"):
        _build.call(fns["loops_stream_read_f32"], "loops_stream_read_f32",
                    "stream_read", 0, (16, 32, 1, 1, 1), 4242)
    assert _build.LAUNCHES["stream_read"] == before
    rec.set_err("loops_stream_read_f32", 0)
    _build.call(fns["loops_stream_read_f32"], "loops_stream_read_f32",
                "stream_read", 0, (16, 32, np.int64(1), 1, 1), 4242)
    assert _build.LAUNCHES["stream_read"] == before + 1
    assert rec.calls("loops_stream_read_f32") == [(16, 32, 1, 1, 1, 4242)] * 2
