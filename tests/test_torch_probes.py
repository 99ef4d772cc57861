"""K12 and the probes K13-K15 of the port on the CPU, against the JAX side
on the same seeded inputs:

- K12's plain version against ``examples/saxpy.py`` ``saxpy_pallas``
  (loaded by path; interpret mode on the CPU). XLA on the CPU contracts
  ``a*x + y`` into one FMA where the plain version (and K12) round the
  product first, so they agree within ``2**-23 (|a x| + |out|)``, one
  rounding of each; against numpy's ``a*x + y`` in float32 bitwise.
- K13: ``scripts/tpu_mosaic_probe{,2}.py`` run compiled calls at import,
  so their kernels (``k_*``, ``scan_kernel``), inputs and ``np_reference``
  are extracted with ``ast`` and run through ``pl.pallas_call(...,
  interpret=True)``; the port's inputs equal the scripts' draws, and its
  plain versions are held to the kernels: the scan at the script's ``atol
  1e-4`` and exactly on integers, the constructs exactly, ``k_dot0`` at
  ``1e-5``.
- K14, K15: the TPU probe functions are driven at small shapes with
  ``pallas_call`` forced to interpret mode and ``jax.jit`` off, recording
  each concrete call. The port's inputs equal the recorded ones, and its
  plain versions are held to the kernels' outputs and to the scripts' own
  numpy checks (``np.take_along_axis``, ``sl[i0]``, ``win0[idx[0]]``).
- Numpy mirrors of the CUDA kernels' thread-to-data maps: the warp scan
  of ``csrc/seg_scan.cuh`` with its warp fold and carry, the row gather
  that G2 and the one-hot expand (G3) share (warp and lane of every
  output value, the index row each reads, shared memory or L2 by size),
  the ``mma.sync`` / ``ldmatrix`` fragment layouts of the bf16 block dot,
  the f32 block dot's 8 x 8 register tiles over
  k-slices (and the one-row tile at M = 8), the L2 scatter's plan
  and segment walk, bit for bit against a sequential loop, G1's sum walk
  (f32 rows 4 a warp loaded, then added in k0 order; bf16 one at a time;
  bit for bit on normal values) and P1's column-permuted table (every
  lane of a warp on its own bank).
"""
import ast
import importlib.util
import os
import re
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from loops_tpu.utils.bench import slope_ms as jax_slope_ms
from loops_tpu_torch.ops.kernels import _build, saxpy
from loops_tpu_torch.probes import gather, mosaic, r2
from loops_tpu_torch.utils import bench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")
CPU = torch.device("cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------------ K12
def _load_example(name):
    spec = importlib.util.spec_from_file_location(
        f"{name}_jax_example", os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("shape,a", [((8, 8192), 2.5), ((8, 128), -0.75),
                                     ((16, 256), 3.0)])
def test_saxpy_plain_matches_the_pallas_kernel(shape, a):
    ex = _load_example("saxpy")
    rng = np.random.default_rng(0)
    x = rng.normal(size=shape).astype(np.float32)
    y = rng.normal(size=shape).astype(np.float32)
    want = np.asarray(ex.saxpy_pallas(a, jnp.asarray(x), jnp.asarray(y)))
    got = saxpy.saxpy(a, x, y, device="cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    ax = np.float32(a) * x
    np.testing.assert_array_equal(got.numpy(), ax + y)
    tol = 2.0 ** -23 * (np.abs(ax) + np.abs(want))
    assert np.all(np.abs(got.numpy().astype(np.float64) - want) <= tol)
    np.testing.assert_array_equal(saxpy.saxpy_plain(a, _t(x), _t(y)).numpy(),
                                  got.numpy())


def test_saxpy_wrapper_refuses_cpu_tensors():
    x = torch.zeros(8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        saxpy.saxpy_cuda(1.0, x, x)


def test_saxpy_grid_is_one_pass():
    # one thread per float4 of x, whatever the card
    per_cta = 4 * saxpy.BLOCK
    assert saxpy.grid(0) == saxpy.grid(1) == 1
    assert saxpy.grid(per_cta) == 1 and saxpy.grid(per_cta + 1) == 2
    assert saxpy.grid(8 * 8192) == 64  # the example's [8, 8192]
    assert saxpy.grid(1 << 26) == 65536
    assert saxpy.grid(2**31 - 1) == 2**21


def test_saxpy_block_is_the_kernels():
    # the grid's CTA width is the one the C entry point launches
    with open(os.path.join(REPO, "loops_tpu_torch", "csrc", "saxpy.cu")) as f:
        src = f.read()
    (threads,) = re.findall(r"constexpr int kSaxpyThreads = (\d+);", src)
    assert int(threads) == saxpy.BLOCK


# ------------------------------------------------------------------ K13
def _script_namespace(path, assigns, functions, extra=None):
    """Exec the module-level ``assigns`` and ``functions`` of a script
    (never its calls), with its imports; ``extra`` names override what
    they import."""
    tree = ast.parse(open(path).read())
    body = []
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            if all(not a.name.startswith("loops_tpu") for a in node.names) \
                    and getattr(node, "module", "") != "loops_tpu.utils.bench":
                body.append(node)
        elif isinstance(node, ast.Assign) and all(
                isinstance(t, ast.Name) and t.id in assigns
                for t in node.targets):
            body.append(node)
        elif isinstance(node, ast.FunctionDef) and node.name in functions:
            body.append(node)
    ns = {}
    exec(compile(ast.Module(body=body, type_ignores=[]), path, "exec"), ns)
    ns.update(extra or {})
    return ns, tree


MOSAIC_INPUTS = ("S", "SUB", "LANES", "GS", "rng", "idx_row", "R", "vec",
                 "mat", "sc", "su", "y0", "v8", "base")


@pytest.fixture(scope="module")
def mosaic_probe():
    path = os.path.join(SCRIPTS, "tpu_mosaic_probe.py")
    ns, tree = _script_namespace(
        path, MOSAIC_INPUTS,
        {n.name for n in ast.walk(ast.parse(open(path).read()))
         if isinstance(n, ast.FunctionDef) and n.name.startswith("k_")})
    # the script's own run(label, kernel, out_shape, *args) calls
    runs = [[eval(compile(ast.Expression(a), path, "eval"), ns)
             for a in node.value.args]
            for node in tree.body if isinstance(node, ast.Expr)
            and isinstance(node.value, ast.Call)
            and getattr(node.value.func, "id", "") == "run"]
    return ns, runs


def test_mosaic_inputs_are_the_scripts(mosaic_probe):
    ns, runs = mosaic_probe
    assert len(runs) == len(mosaic.CONSTRUCTS) == 8
    assert (ns["S"], ns["SUB"], ns["LANES"], ns["GS"], ns["R"]) == (
        mosaic.S, mosaic.SUB, mosaic.LANES, mosaic.GS, mosaic.R)
    mine = mosaic.construct_inputs()
    by_label = {v: k for k, v in mosaic.LABELS.items()}
    for label, _, _, *args in runs:
        name = by_label[label]
        theirs = [np.asarray(a) for a in args]
        if name == "dynbase":  # the script passes (base, v)
            theirs = [theirs[1], int(theirs[0][0])]
        for m, t in zip(mine[name], theirs):
            np.testing.assert_array_equal(np.asarray(m), t)


@pytest.mark.parametrize("name", mosaic.CONSTRUCTS)
def test_construct_plain_matches_the_interpret_kernel(mosaic_probe, name):
    _, runs = mosaic_probe
    label, kernel, out_shape, *args = next(
        r for r in runs if r[0] == mosaic.LABELS[name])
    want = np.asarray(pl.pallas_call(kernel, out_shape=out_shape,
                                     interpret=True)(*args))
    got = mosaic.construct(name, *(_t(a) if isinstance(a, np.ndarray) else a
                                   for a in mosaic.construct_inputs()[name]))
    atol = mosaic.ATOL.get(name, 0.0)
    assert got.shape == want.shape
    if atol:
        np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=0)
    else:
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.fixture(scope="module")
def scan_probe():
    path = os.path.join(SCRIPTS, "tpu_mosaic_probe2.py")
    ns, _ = _script_namespace(path, ("SUB", "LANES", "GS", "rng", "v0",
                                     "keep0"),
                              ("scan_kernel", "np_reference"))
    return ns


def _k13_bind(kind):
    """A K13 bind on the CPU: (bufs, fn, its check of the staged inputs,
    the plain result)."""
    if kind == "seg_scan":
        v, keep = mosaic.scan_inputs()
        bufs, fn = mosaic.seg_scan_bind(v, keep, device=CPU)
        return bufs, fn, mosaic.check_scan, mosaic.seg_scan_plain(_t(v),
                                                                  _t(keep))
    args = mosaic.construct_inputs()[kind]
    bufs, fn = mosaic.construct_bind(kind, *args, device=CPU)
    want = mosaic.construct_plain(kind, *(_t(x) if isinstance(x, np.ndarray)
                                          else x for x in args))
    return bufs, fn, mosaic.check_construct, want


@pytest.mark.parametrize("kind", ["seg_scan", *mosaic.CONSTRUCTS])
def test_k13_bind_forms_stage_once_and_equal_the_plain_versions(kind):
    bufs, fn, check, want = _k13_bind(kind)
    assert fn.staged_on(bufs) == CPU
    check(bufs, fn.meta, CPU)
    assert torch.equal(fn(bufs), want)
    assert all(x.is_contiguous() for x in bufs.values())


@pytest.mark.parametrize("change", ["none", "resize", "set", "dtype",
                                    "replaced"])
@pytest.mark.parametrize("kind", ["seg_scan", "reshape_s1", "dot0",
                                  "dynbase"])
def test_k13_binds_check_staged_inputs_changed_again(kind, change):
    # the inputs are checked once at bind; a call skips the check only for
    # the very tensors checked then, none changed in place since, and the
    # full check then refuses what changed
    bufs, fn, check, _ = _k13_bind(kind)
    b = dict(bufs)
    key = "v" if kind == "seg_scan" else "a"
    if change == "resize":
        b[key].resize_(b[key].shape[0] - 1, b[key].shape[1])
    elif change == "set":
        b[key].set_(torch.zeros(2, 3, dtype=b[key].dtype))
    elif change == "dtype":
        b[key] = b[key].double()
    elif change == "replaced":
        b[key] = b[key].clone()
    assert fn.staged_on(b) == (CPU if change == "none" else None)
    if change in ("resize", "set", "dtype"):
        with pytest.raises(ValueError):
            check(b, fn.meta, CPU)
    else:
        check(b, fn.meta, CPU)


def test_k13_binds_refuse_what_their_kernels_do_not_take():
    with pytest.raises(ValueError, match="base"):
        mosaic.construct_bind("dynbase", np.zeros((4, 128), np.float32), 13,
                              device=CPU)
    with pytest.raises(ValueError, match="one of"):
        mosaic.construct_bind("no_such", np.zeros((4, 128), np.float32),
                              device=CPU)
    bufs, fn = mosaic.construct_bind(
        "shift_sub", np.zeros((16, 128), np.float32), device=CPU)
    with pytest.raises(ValueError, match="expected"):
        mosaic.check_construct(bufs, fn.meta, CPU)
    bufs, fn = mosaic.seg_scan_bind(np.zeros((30, 128), np.float32),
                                    np.zeros((30, 128), np.float32),
                                    device=CPU)
    with pytest.raises(ValueError, match="rows"):
        mosaic.check_scan(bufs, fn.meta, CPU)


def test_launch_floor_plain_and_its_probe_on_the_cpu():
    buf = torch.zeros(1, dtype=torch.int32)
    assert mosaic.launch_floor(buf, 5) is buf and int(buf) == 5
    with pytest.raises(ValueError, match="CUDA tensor"):
        mosaic.launch_floor_cuda(buf)
    lines = []
    rec = mosaic.probe_floor(CPU, out=lines.append)
    assert rec["name"] == "launch_floor" and rec["name"] in _build.LAUNCHES
    assert rec["floor_ms"] is None and rec["nbytes"] == 4
    assert rec["ms"] > 0 and "exact=True" in lines[0]


@pytest.mark.parametrize("integer", [False, True])
def test_seg_scan_plain_matches_the_script(scan_probe, integer):
    """The port's scan is the script's ``np_reference``. The script's
    ``scan_kernel`` in interpret mode agrees with it where the lane scan
    alone decides (the first row of each SUB block, and each lane at or
    after its row's first reset) and departs from it in the carry into
    rows 1-3 of a block (by up to 5.87 on these inputs): held only where
    it agrees."""
    ns = scan_probe
    v, keep = mosaic.scan_inputs(integer)
    np.testing.assert_array_equal(keep, ns["keep0"])
    if not integer:
        np.testing.assert_array_equal(v, ns["v0"])
    shape = jax.ShapeDtypeStruct((ns["GS"], ns["LANES"]), jnp.float32)
    kern = np.asarray(pl.pallas_call(ns["scan_kernel"], out_shape=shape,
                                     interpret=True)(jnp.asarray(v),
                                                     jnp.asarray(keep)))
    ref = ns["np_reference"](v, keep)
    got = mosaic.seg_scan(_t(v), _t(keep)).numpy()
    atol = 0.0 if integer else mosaic.SCAN_ATOL
    np.testing.assert_allclose(got, ref, atol=atol, rtol=0)
    first = np.where((keep == 0).any(1), np.argmax(keep == 0, axis=1),
                     mosaic.LANES)
    lane_scan = (np.arange(mosaic.LANES)[None, :] >= first[:, None]) | (
        np.arange(mosaic.GS)[:, None] % mosaic.SUB == 0)
    np.testing.assert_allclose(got[lane_scan], kern[lane_scan], atol=atol,
                               rtol=0)
    assert np.abs(kern - ref)[~lane_scan].max() > 1.0  # the carry departs


def test_gather_residencies_and_tables():
    assert gather.residency(gather.SMEM_ROWS, 4) == "smem"
    assert gather.residency(4096, 4) == "l2"
    # the arxiv table's rows recur: the L2 serves much of it
    assert gather.residency(gather.ARXIV_ROWS, 4) == "l2"
    assert gather.residency(gather.HBM_ROWS, 2) == "hbm"
    assert gather.HBM_ROWS * 128 * 2 > 4 * gather.L2_BYTES
    slab, idx = gather.row_gather_tensors(64, 8, 64, True, CPU)
    want = gather.row_gather_inputs(64, 8, 64, integer=True)
    np.testing.assert_array_equal(slab.numpy(), want[0])
    np.testing.assert_array_equal(idx.numpy(), want[1])
    # past the arxiv table the table is drawn on the device, seeded
    S = gather.ARXIV_ROWS + 1
    a = gather.row_gather_tensors(S, 8, 64, True, CPU)
    b = gather.row_gather_tensors(S, 8, 64, True, CPU)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert torch.equal(a[0], torch.round(a[0])) and a[1].dtype == torch.int32
    assert int(a[1].min()) >= 0 and int(a[1].max()) < S


def test_probe_wrappers_refuse_cpu_tensors():
    v = torch.zeros(32, 128)
    for call in (lambda: mosaic.seg_scan_cuda(v, v),
                 lambda: mosaic.construct_cuda("shift_sub", v),
                 lambda: r2.block_dot_cuda(torch.zeros(4, 8, 128),
                                           torch.zeros(128, 512)),
                 lambda: r2.scatter_cuda(torch.zeros(8, dtype=torch.int32),
                                         torch.zeros(1, 64, 512), 256),
                 lambda: gather.gather_axis0_cuda(v, v.int()),
                 lambda: gather.gather_axis1_cuda(v, v.int()),
                 lambda: gather.row_gather_cuda(v, v.int()[0], 8, True),
                 lambda: gather.onehot_expand_cuda(v, v.int())):
        with pytest.raises(ValueError, match="CUDA tensor"):
            call()


def test_launch_refuses_an_unknown_counter():
    before = dict(_build.LAUNCHES)
    with pytest.raises(KeyError, match="not a launch counter"):
        _build.launch("loops_saxpy_f32", "no_such_kernel", CPU, 1.0)
    assert _build.LAUNCHES == before
    for name in ("saxpy", "seg_scan_probe", "construct_probe",
                 "block_dot_f32", "block_dot_bf16", "smem_scatter",
                 "l2_scatter", "gather_axis0", "gather_axis1",
                 "onehot_expand"):
        assert name in _build.LAUNCHES
    for mode in ("sum", "mat"):
        for where in ("smem", "l2", "hbm"):
            assert f"row_gather_{mode}_{where}" in _build.LAUNCHES


def _c_entry_points():
    """``name -> [ctypes type per parameter]`` read from the
    ``extern "C"`` entry points of ``csrc/*.cu``: pointers (and the
    stream) as ``c_void_p``, ``int`` as ``c_int``, ``float`` as
    ``c_float``."""
    import ctypes
    import re

    kinds = {"int": ctypes.c_int, "float": ctypes.c_float}
    entries = {}
    for path in _build._sources():
        src = open(path).read()
        for name, params in re.findall(r"^int (loops_\w+)\(([^)]*)\)", src,
                                       re.M):
            entries[name] = [
                ctypes.c_void_p if "*" in p else kinds[p.split()[0]]
                for p in params.split(",")]
    return entries


def test_build_signatures_match_the_c_entry_points():
    # a wrong argtypes list passes the CPU tests and fails at the first
    # launch on the card: hold each to its C declaration
    entries = _c_entry_points()
    assert sorted(entries) == sorted(_build._SIGNATURES)
    for name, argtypes in _build._SIGNATURES.items():
        assert argtypes == entries[name], name


def test_build_hashes_headers_and_compiles_only_sources(tmp_path,
                                                        monkeypatch):
    srcs = _build._sources()
    assert any(f.endswith("seg_scan.cuh") for f in srcs)
    assert all(f.endswith((".cu", ".cuh")) for f in srcs)
    seen = []

    def fake_start(cmd):
        seen.append(cmd)
        if "-shared" in cmd:  # the link: make the library it names
            open(cmd[cmd.index("-o") + 1], "w").close()

        class Done:
            returncode = 0

            def communicate(self, timeout=None):
                return "", ""

            def poll(self):
                return 0
        return cmd, Done()

    monkeypatch.setattr(_build, "_start", fake_start)
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    files = [f for f in srcs if f.endswith(".cu")]
    _build._build(files, str(tmp_path / "lib.so"))
    compiled = [c[-1] for c in seen if "-c" in c]
    assert sorted(compiled) == sorted(files)
    assert not any(c.endswith(".cuh") for c in compiled)
    assert (tmp_path / "lib.so").exists()


def test_saxpy_signature_takes_a_float():
    import ctypes
    assert _build._SIGNATURES["loops_saxpy_f32"][0] is ctypes.c_float


# --------------------------------------------------- K14, K15: the scripts
class _Recorder:
    """``pl`` with ``pallas_call`` forced to interpret mode, recording
    every concrete call: (pallas function, args, output)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, k):
        return getattr(pl, k)

    def pallas_call(self, kernel, **kw):
        kw["interpret"] = True
        f = pl.pallas_call(kernel, **kw)

        def call(*a):
            r = f(*a)
            if not isinstance(r, jax.core.Tracer):
                self.calls.append((f, a, r))
            return r
        return call


class _Eager:
    """``jax`` with ``jit`` off, so the probes' calls run eagerly."""

    def __getattr__(self, k):
        return getattr(jax, k)

    @staticmethod
    def jit(f, **kw):
        return f


def _drive(script, functions, **extra):
    rec = _Recorder()
    ns, _ = _script_namespace(
        os.path.join(SCRIPTS, script), ("LANES",), functions,
        dict(time=time, np=np, jax=_Eager(), jnp=jnp, pl=rec, pltpu=pltpu,
             slope_ms=jax_slope_ms, print=lambda *a, **k: None, **extra))
    # one timed call is enough: the check is of what the kernel computed
    ns["timeit"] = lambda fn, *args, iters=30: (0.0, fn(*args))
    return ns, rec


@pytest.mark.parametrize("S,tiles", [(8, 2), (64, 1)])
def test_axis0_plain_matches_the_tpu_probe(S, tiles):
    ns, rec = _drive("tpu_r3_gather_probe.py", {"timeit", "probe_axis0"})
    ns["probe_axis0"](S, tiles)
    _, (src, idx), out = rec.calls[0]
    src, idx, out = np.asarray(src), np.asarray(idx), np.asarray(out)
    mine = gather.axis0_inputs(S, S * 128 * tiles)
    np.testing.assert_array_equal(mine[0], src)
    np.testing.assert_array_equal(mine[1], idx)
    got = gather.gather_axis0(_t(src), _t(idx)).numpy()
    np.testing.assert_array_equal(got, out)
    np.testing.assert_array_equal(got[:S], np.take_along_axis(src, idx[:S],
                                                              axis=0))


@pytest.mark.parametrize("S,tiles", [(8, 2), (3, 1)])
def test_axis1_plain_matches_the_tpu_probe(S, tiles):
    ns, rec = _drive("tpu_r3_gather_probe.py", {"timeit", "probe_axis1"})
    ns["probe_axis1"](S, tiles)
    _, (src, idx), out = rec.calls[0]
    src, idx, out = np.asarray(src), np.asarray(idx), np.asarray(out)
    mine = gather.axis1_inputs(S, S * 128 * tiles)
    np.testing.assert_array_equal(mine[0], src)
    np.testing.assert_array_equal(mine[1], idx)
    got = gather.gather_axis1(_t(src), _t(idx)).numpy()
    np.testing.assert_array_equal(got, out)
    np.testing.assert_array_equal(got[:S], np.take_along_axis(
        src[:S], idx[:S], axis=1))


@pytest.mark.parametrize("S,K,nblocks", [(16, 16, 2), (40, 32, 3)])
@pytest.mark.parametrize("materialize", [False, True])
def test_row_gather_plain_matches_the_tpu_probe(S, K, nblocks, materialize):
    ns, rec = _drive("tpu_r4_gather_probe.py", {"_dynload_run"})
    ns["_dynload_run"](S, K, nblocks, materialize)
    f, (idx, slab), out = rec.calls[0]
    idx, slab, out = np.asarray(idx), np.asarray(slab), np.asarray(out)
    n = nblocks * K
    mine = gather.row_gather_inputs(S, K, n)
    np.testing.assert_array_equal(mine[0], slab)
    np.testing.assert_array_equal(mine[1], idx)
    got = gather.row_gather(_t(slab), _t(idx), K, materialize).numpy()
    i0 = idx[:K]
    if materialize:
        np.testing.assert_array_equal(got, out)
        np.testing.assert_array_equal(got[:K], slab[i0])     # r4:105
        return
    np.testing.assert_allclose(got, out, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got[:8].sum(axis=0), slab[i0].sum(axis=0),
                               rtol=1e-3)                   # r4:107
    # integer-valued: the f32 sums are exact in any order
    ints = gather.row_gather_inputs(S, K, n, integer=True)[0]
    np.testing.assert_array_equal(
        gather.row_gather(_t(ints), _t(idx), K, False).numpy(),
        np.asarray(f(jnp.asarray(idx), jnp.asarray(ints))))


@pytest.mark.parametrize("S,K", [(16, 16), (40, 32), (64, 128)])
def test_row_gather_library_call_computes_g1(S, K):
    # the library time of G1 is embedding_bag over idx reordered into bags
    # of K/8: on integer rows it gives G1's sums exactly
    slab, idx = (_t(a) for a in gather.row_gather_inputs(S, K, 3 * K,
                                                         integer=True))
    bags = gather.row_gather_bags(idx, K)
    assert tuple(bags.shape) == (3 * 8, K // 8)
    lib = torch.nn.functional.embedding_bag(bags, slab, mode="sum")
    np.testing.assert_array_equal(
        lib.numpy(), gather.row_gather(slab, idx, K, False).numpy())


@pytest.mark.parametrize("W,Kc,nblocks", [(128, 128, 2), (64, 256, 1)])
def test_onehot_plain_matches_the_tpu_probe(W, Kc, nblocks):
    ns, rec = _drive("tpu_r4_gather_probe.py", {"g3_onehot_expand"})
    ns["g3_onehot_expand"](W, Kc, nblocks)
    _, (win, idx), out = rec.calls[0]
    win, idx, out = np.asarray(win), np.asarray(idx), np.asarray(out)
    mine = gather.onehot_inputs(W, Kc, nblocks * Kc)
    np.testing.assert_array_equal(mine[0], win)
    np.testing.assert_array_equal(mine[1], idx)
    got = gather.onehot_expand(_t(win), _t(idx)).numpy()
    np.testing.assert_array_equal(got, out)                  # exact
    np.testing.assert_allclose(got[:Kc], win[idx[0]], atol=1e-2)  # r4:155


@pytest.mark.parametrize("chm,stream_b", [(8, False), (64, True)])
def test_block_dot_plain_matches_the_tpu_probe(chm, stream_b):
    nch_rows = 4 * chm
    captured = {}

    def one_pass(make_fn, lo, hi, *args):
        captured["out"] = np.asarray(make_fn(1)(*args))
        captured["args"] = [np.asarray(a) for a in args]
        return 1.0, 0.0
    ns, rec = _drive("tpu_r2_probe.py", {"dot_probe"})
    ns["slope_ms"] = one_pass
    ns["dot_probe"](chm, 2, stream_b, nch_rows)
    a, b = captured["args"]
    mine = r2.dot_inputs(chm, stream_b, nch_rows=nch_rows)
    np.testing.assert_array_equal(mine[0], a)
    np.testing.assert_array_equal(mine[1], b)
    A, B = _t(a), _t(b)
    got = r2.block_dot(A, B, "f32")
    assert tuple(got.shape) == (chm, 512)
    assert float(r2.dot_units(got, A, B).max()) <= r2.DOT_C
    # the TPU kept the [8, 128] corner of the sum
    tpu = got.clone()
    tpu[:8, :128] = torch.from_numpy(captured["out"].copy())
    assert float(r2.dot_units(tpu, A, B).max()) <= r2.DOT_C


def _tf32(t):
    """``t`` with its f32 mantissa rounded to TF32's 10 bits."""
    bits = t.view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


@pytest.mark.parametrize("M,stream_b", [(8, False), (64, False),
                                        (64, True)])
def test_dot_check_refuses_reduced_precision(M, stream_b):
    """An f32 sum passes ``hold_dot``; TF32 operands, or an output rounded
    to bf16, do not, though integer inputs cannot tell them apart."""
    A, B = (_t(a) for a in r2.dot_inputs(M, stream_b, nch_rows=64 * M))
    err, units = r2.hold_dot("f32", r2.block_dot_plain(A, B), A, B)
    assert units <= r2.DOT_C / 8
    tf32 = r2.dot_reference(_tf32(A), _tf32(B)).float()
    with pytest.raises(r2.ProbeMismatch, match="past"):
        r2.hold_dot("tf32", tf32, A, B)
    with pytest.raises(r2.ProbeMismatch, match="past"):
        r2.hold_dot("bf16 out", r2.block_dot_plain(A, B).bfloat16().float(),
                    A, B)
    Ai, Bi = (_t(a) for a in r2.dot_inputs(M, stream_b, integer=True,
                                           nch_rows=64 * M))
    assert torch.equal(r2.dot_reference(_tf32(Ai), _tf32(Bi)).float(),
                       r2.block_dot_plain(Ai, Bi))


def test_scatter_plain_matches_the_tpu_probe():
    captured = {}

    def one_pass(make_fn, lo, hi, *args):
        captured["out"] = np.asarray(make_fn(1)(*args))
        captured["args"] = [np.asarray(a) for a in args]
        return 1.0, 0.0
    ns, rec = _drive("tpu_r2_probe.py", {"scatter_probe"})
    ns["slope_ms"] = one_pass
    ns["scatter_probe"](kch=2, rr=8, ft=128, acc_rows=64, nch=4, reps_hi=2)
    offs, a = captured["args"]
    mine_offs, _ = r2.scatter_inputs(64, nch=4, kch=2, ft=128)
    np.testing.assert_array_equal(mine_offs, offs)
    got = r2.scatter(_t(offs), _t(a), 64)
    np.testing.assert_allclose(got[:8, :128].numpy(), captured["out"],
                               atol=1e-5, rtol=0)


# ------------------------------------------------------- numpy mirrors
def _mirror_block_seg_scan(v, f, carry, warps):
    """``loops_scan::block_seg_scan`` over one chunk of ``32 * warps``
    lanes, in float32 as the card does: the __shfl_up_sync loop, the warp
    aggregates folded in warp order, the carry."""
    v = v.astype(np.float32).reshape(warps, 32).copy()
    f = f.astype(np.int32).reshape(warps, 32).copy()
    lane = np.arange(32)
    d = 1
    while d < 32:
        pv = np.where(lane >= d, np.roll(v, d, axis=1), v)
        pf = np.where(lane >= d, np.roll(f, d, axis=1), f)
        on = lane >= d
        v = np.where(on & (f == 0), pv + v, v).astype(np.float32)
        f = np.where(on, f | pf, f)
        d <<= 1
    agg_v, agg_f = v[:, 31].copy(), f[:, 31].copy()
    out = np.empty_like(v)
    pre = np.float32(carry)
    for w in range(warps):
        out[w] = np.where(f[w] == 0, pre + v[w], v[w])
        pre = agg_v[w] if agg_f[w] else np.float32(pre + agg_v[w])
    return out.reshape(-1), pre


def _mirror_block_seg_scan_before(v, f, carry, warps):
    """``_mirror_block_seg_scan`` and, per lane, the value before it: the
    lane before's inclusive value (lane 0 of a warp: the fold of the
    warps before, which is the last lane's inclusive value of the warp
    before; of the first warp, the carry)."""
    inc, new_carry = _mirror_block_seg_scan(v, f, carry, warps)
    before = np.concatenate([[np.float32(carry)], inc[:-1]]).astype(
        np.float32)
    return inc, before, new_carry


def _mirror_seg_scan_probe(v, keep, sub, threads=256):
    """``seg_scan_probe_kernel``: one CTA per block of ``sub`` rows, two
    elements a thread folded into one pair (the second's value if it
    starts a segment, else the sum), the pairs scanned, then each thread's
    elements added in order from the value before them; chunks of 512
    linked by the carry."""
    L = sub * v.shape[1]
    vb, kb = v.reshape(-1, L), keep.reshape(-1, L)
    out = np.zeros_like(vb)
    for b in range(vb.shape[0]):
        carry = np.float32(0)
        for c0 in range(0, L, 2 * threads):
            n = min(2 * threads, L - c0)
            x = np.zeros(2 * threads, np.float32)
            f = np.ones(2 * threads, np.int32)
            x[:n] = vb[b, c0:c0 + n]
            f[:n] = kb[b, c0:c0 + n] == 0
            x0, x1, f0, f1 = x[0::2], x[1::2], f[0::2], f[1::2]
            pv = np.where(f1 == 1, x1, x0 + x1).astype(np.float32)
            _, before, carry = _mirror_block_seg_scan_before(
                pv, f0 | f1, carry, threads // 32)
            y0 = np.where(f0 == 1, x0, before + x0).astype(np.float32)
            y1 = np.where(f1 == 1, x1, y0 + x1).astype(np.float32)
            y = np.empty(2 * threads, np.float32)
            y[0::2], y[1::2] = y0, y1
            out[b, c0:c0 + n] = y[:n]
    return out.reshape(v.shape)


@pytest.mark.parametrize("shape,sub", [((32, 128), 4), ((12, 100), 3),
                                       ((16, 64), 16)])
@pytest.mark.parametrize("integer", [False, True])
def test_warp_scan_mirror(scan_probe, shape, sub, integer):
    rng = np.random.default_rng(sum(shape) + sub)
    v = rng.normal(size=shape).astype(np.float32)
    if integer:
        v = np.rint(v * 8).astype(np.float32)
    keep = (rng.random(shape) < 0.9).astype(np.float32)
    got = _mirror_seg_scan_probe(v, keep, sub)
    plain = mosaic.seg_scan_plain(_t(v), _t(keep), sub).numpy()
    if integer:
        np.testing.assert_array_equal(got, plain)
    else:
        np.testing.assert_allclose(got, plain, atol=mosaic.SCAN_ATOL, rtol=0)
    if shape == (32, 128):  # the script's shape: its reference too
        ref = scan_probe["np_reference"](v, keep)
        np.testing.assert_allclose(got, ref, atol=mosaic.SCAN_ATOL, rtol=0)


def _ldmatrix(smem, lane_rows, lane_cols, n_mats, trans):
    """``ldmatrix.m8n8.x{n_mats}[.trans]``: matrix m's row r at the address
    lane 8m + r gives; lane t receives, per matrix, (row t/4, columns 2(t%4)
    and +1), or with .trans (rows 2(t%4) and +1, column t/4)."""
    regs = np.zeros((32, n_mats, 2), np.float32)
    for m in range(n_mats):
        rows = [smem[lane_rows[8 * m + r], lane_cols[8 * m + r]:
                     lane_cols[8 * m + r] + 8] for r in range(8)]
        M = np.stack(rows)
        for t in range(32):
            if trans:
                regs[t, m] = M[2 * (t % 4), t // 4], M[2 * (t % 4) + 1, t // 4]
            else:
                regs[t, m] = M[t // 4, 2 * (t % 4)], M[t // 4, 2 * (t % 4) + 1]
    return regs


def _mma_m16n8k16(a, b):
    """mma.sync m16n8k16 row.col from per-lane fragments: a [32, 4, 2],
    b [32, 2, 2]; returns d [32, 4] (c0..c3 of each lane)."""
    A, B = np.zeros((16, 16)), np.zeros((16, 8))
    for t in range(32):
        g, q = t // 4, t % 4
        for i, (r, c) in enumerate(((g, 2 * q), (g + 8, 2 * q),
                                    (g, 2 * q + 8), (g + 8, 2 * q + 8))):
            A[r, c:c + 2] = a[t, i]
        for i, k in enumerate((2 * q, 2 * q + 8)):
            B[k:k + 2, g] = b[t, i]
    D = A @ B
    d = np.zeros((32, 4))
    for t in range(32):
        g, q = t // 4, t % 4
        d[t] = D[g, 2 * q], D[g, 2 * q + 1], D[g + 8, 2 * q], D[g + 8, 2 * q + 1]
    return d


def _row_gather_mirror(table, idx, K, rep, blocks, smem, element_size):
    """``row_gather_kernel``'s materialize path (G2 at ``rep`` 1, G3 at
    ``rep`` 8) in numpy: CTA c, warp w of 8 is global warp c*8 + w; it
    takes rows b..b+31 from b = 32 * (global warp) in steps of 32 * (all
    warps), its lanes load the index of row b + lane from
    ``idx[o + (o // K) * (rep - 1) * K]`` and pass it by shuffle, and lane
    l copies columns 4l..4l+3 of the row, widened to f32. Returns the
    output, filled with NaN where no lane wrote, and the write count of
    every value. ``table`` holds the values as f32; ``element_size`` is
    the bytes of one in the kernel's table (2 for G3's bf16 window)."""
    n = idx.size // rep
    flat = idx.reshape(-1)
    if smem:  # the CTA stages the table whole, in 16-byte pieces
        staged = table.shape[0] * 128 * element_size
        assert staged % 16 == 0 and staged <= gather.SMEM_BYTES
    out = np.full((n, 128), np.nan, np.float32)
    writes = np.zeros((n, 128), np.int64)
    warps = blocks * 8
    for gw in range(warps):
        for b in range(gw * 32, n, warps * 32):
            mine = [int(flat[o + (o // K) * (rep - 1) * K]) if o < n else 0
                    for o in range(b, b + 32)]
            for q in range(min(32, n - b)):
                r = mine[q]                       # __shfl_sync(mine, q)
                for lane in range(32):
                    c = 4 * lane
                    out[b + q, c:c + 4] = table[r, c:c + 4]
                    writes[b + q, c:c + 4] += 1
    return out, writes


@pytest.mark.parametrize("W", [64, 128, 512, 2048])
def test_onehot_row_gather_mirror(W):
    """G3 as ``row_gather_kernel`` runs it: the residency and grid
    ``rows_grid`` gives (shared memory up to W = 512, L2 at 2048), every
    output value written once by its warp and lane from the first of its
    block's 8 idx rows, bit for bit ``bf16(win)[rows]`` and the plain
    version. Kc = 100 leaves a block's rows across warps' steps of 32."""
    Kc, nblocks = 100, 3
    win, idx = gather.onehot_inputs(W, Kc, nblocks * Kc)
    assert idx.shape == (nblocks * gather.G3_REP, Kc)
    where, blocks = gather.rows_grid(W, 2, sms=1)
    assert where == ("smem" if W <= 512 else "l2")
    assert blocks == (min(8, gather.SMEM_BYTES // (W * 256))
                      if where == "smem" else 8)
    wb = torch.from_numpy(win).to(torch.bfloat16).float().numpy()
    out, writes = _row_gather_mirror(wb, idx, Kc, gather.G3_REP, blocks,
                                     where == "smem", 2)
    assert (writes == 1).all()
    rows = idx[::gather.G3_REP].reshape(-1)
    np.testing.assert_array_equal(out, wb[rows])
    np.testing.assert_array_equal(
        out, gather.onehot_expand(_t(win), _t(idx)).numpy())


def test_g2_row_gather_mirror():
    """G2 through the same walk at ``rep`` 1: ``out[r] = slab[idx[r]]``."""
    slab, idx = gather.row_gather_inputs(256, 64, 640)
    where, blocks = gather.rows_grid(256, 4, sms=1)
    assert (where, blocks) == ("smem", 1)
    out, writes = _row_gather_mirror(slab, idx, 64, 1, blocks, True, 4)
    assert (writes == 1).all()
    np.testing.assert_array_equal(
        out, gather.row_gather(_t(slab), _t(idx), 64, True).numpy())


def _row_gather_sum_mirror(table, idx, K, blocks, threads, R):
    """``row_gather_sum_kernel`` (G1) in numpy: CTA c, warp w of
    ``threads / 32`` is global warp c * (threads / 32) + w; it takes
    output rows o = g * 8 + j from its global warp in steps of all warps.
    A row's indices ``idx[g*K + k0*8 + j]`` come 32 at a time, one a lane
    (``mine``). At R = 1 each passes by shuffle and its row (lane l
    columns 4l..4l+3, widened to f32) is added as it lands; at R = 4 the
    warp writes them to its 32 ints of shared memory and reads them back
    4 at a time, and a chunk's rows go R at a time, all R loaded before
    any is added. The adds run in k0 order into an f32 sum started at +0.
    Returns the output (NaN where no warp wrote), the write count of
    every value and the k0 order each row's adds took."""
    per, outs = K // 8, idx.size // K * 8
    out = np.full((outs, 128), np.nan, np.float32)
    writes = np.zeros((outs, 128), np.int64)
    order = {}
    warps = blocks * (threads // 32)
    for gw in range(warps):
        for o in range(gw, outs, warps):
            g, j = o >> 3, o & 7
            acc = np.zeros(128, np.float32)
            seen = order.setdefault(o, [])
            for b in range(0, per, 32):
                mine = [int(idx[g * K + j + (b + lane) * 8])
                        if b + lane < per else 0 for lane in range(32)]
                m = min(32, per - b)
                for q in range(0, m, R):
                    if R == 1:
                        r = [mine[q]]                       # __shfl_sync
                    else:                                   # int4 reads
                        r = [x for u in range(0, R, 4)
                             for x in mine[(q + u) % 32:(q + u) % 32 + 4]]
                    live = [u for u in range(R) if q + u < m]
                    v = [table[r[u]] for u in live]         # R loads
                    for u, row in zip(live, v):             # then R adds
                        acc += row
                        seen.append(b + q + u)
            for lane in range(32):
                out[o, 4 * lane:4 * lane + 4] = acc[4 * lane:4 * lane + 4]
                writes[o, 4 * lane:4 * lane + 4] += 1
    return out, writes, order


@pytest.mark.parametrize("S,dtype", [(gather.SMEM_ROWS, torch.float32),
                                     (gather.SMEM_ROWS, torch.bfloat16),
                                     (4096, torch.float32),
                                     (4096, torch.bfloat16)])
@pytest.mark.parametrize("K,n", [(8, 200 * 8), (32, 3 * 32), (72, 5 * 72),
                                 (128, 3 * 128), (512, 3 * 512)])
def test_row_gather_sum_mirror(S, dtype, K, n):
    """G1 as ``row_gather_sum_kernel`` runs it, on the normal-valued slab:
    the CTA and grid ``rows_grid(..., summed=True)`` gives (1024 threads
    on a staged table, 256 from L2), the rows in flight a warp
    ``SUM_ROWS`` gives (f32 4, bf16 1), bit for bit ``row_gather_plain``,
    every output written once, each row's adds in k0 order. K/8 = 1 and
    9 leave the last batch of 4 rows short; K = 512 takes two chunks of
    32 indices; K = 8 at 1600 rows gives a warp several output rows."""
    slab, idx = gather.row_gather_inputs(S, K, n)
    table = torch.from_numpy(slab).to(dtype)
    es = table.element_size()
    where, blocks = gather.rows_grid(S, es, sms=1, summed=True)
    threads = gather.row_threads(where, summed=True)
    assert (where, threads) == (("smem", 1024) if S == gather.SMEM_ROWS
                                else ("l2", 256))
    assert blocks == ((2 if es == 2 else 1) if where == "smem" else 8)
    R = gather.SUM_ROWS[es]
    assert R == (4 if es == 4 else 1)
    out, writes, order = _row_gather_sum_mirror(
        table.float().numpy(), idx, K, blocks, threads, R)
    assert (writes == 1).all()
    assert all(seen == list(range(K // 8)) for seen in order.values())
    want = gather.row_gather_plain(table, _t(idx), K, False).numpy()
    np.testing.assert_array_equal(out, want)
    # the values are not integers: the order of the f32 adds shows
    assert not np.array_equal(slab, np.rint(slab))


def test_row_gather_sum_order_shows_on_normal_values():
    """On normal values another order of the same f32 adds gives other
    bits, so the mirror's equality above holds the order itself."""
    K = 512
    slab, idx = gather.row_gather_inputs(gather.SMEM_ROWS, K, K)
    rows = slab[idx].reshape(1, K // 8, 8, 128)
    fwd = np.zeros((8, 128), np.float32)
    rev = np.zeros((8, 128), np.float32)
    for k in range(K // 8):
        fwd += rows[0, k]
        rev += rows[0, K // 8 - 1 - k]
    np.testing.assert_array_equal(
        fwd, gather.row_gather_plain(_t(slab), _t(idx), K, False).numpy())
    assert not np.array_equal(fwd, rev)


def _axis0_mirror(src, idx, smem, threads, blocks, U):
    """``gather_axis0_kernel`` (P1) in numpy: thread t of CTA c takes the
    items e = s * step + c * threads * U + u * threads + t (step = all
    CTAs' threads * U; u < U; e < n4), item e being out[e // 32, 4l ..
    4l + 3] with l = e mod 32, the thread's lane. In shared memory row r's
    column j sits at word r * 128 + (j & 3) * 32 + (j >> 2). Returns the
    output (NaN where no thread wrote), the write count of every value,
    and for every warp, step, item and component the banks of the 32
    lanes' shared loads (rows of 32; empty from L2)."""
    n4 = idx.size // 4
    flat_idx = idx.reshape(-1, 4)
    if smem:
        tab = np.empty(src.shape[0] * 128, np.float32)
        j = np.arange(128)
        for r in range(src.shape[0]):
            tab[r * 128 + (j & 3) * 32 + (j >> 2)] = src[r]
    out = np.full(n4 * 4, np.nan, np.float32)
    writes = np.zeros(n4 * 4, np.int64)
    banks = []
    step = blocks * threads * U
    t = np.arange(threads)
    lane = t & 31
    for s0 in range(0, n4, step):
        for c in range(blocks):
            for u in range(U):
                e = s0 + c * threads * U + u * threads + t
                live = e < n4
                assert (e % 32 == lane).all()
                i = flat_idx[e[live]]
                ln = lane[live]
                if smem:
                    words = i * 128 + np.arange(4) * 32 + ln[:, None]
                    v = tab[words]
                    for w0 in range(0, threads, 32):
                        sel = (t[live] >= w0) & (t[live] < w0 + 32)
                        if sel.any():
                            banks.append((words[sel] % 32).T)
                else:
                    v = src[i, 4 * ln[:, None] + np.arange(4)]
                out[(4 * e[live])[:, None] + np.arange(4)] = v
                writes[(4 * e[live])[:, None] + np.arange(4)] += 1
    return out.reshape(idx.shape), writes.reshape(idx.shape), banks


@pytest.mark.parametrize("S", [*gather.P1_S])
@pytest.mark.parametrize("rows", [777, 64])
def test_axis0_permuted_table_mirror(S, rows):
    """P1 as ``gather_axis0_kernel`` runs it, at the CTA, items in flight
    and grid ``axis0_grid`` gives: every output written once, equal to the plain
    version and to ``np.take_along_axis`` (the TPU probe's check); in
    shared memory the permuted columns put a warp's 32 loads of one
    component on 32 banks. 777 rows of idx leave a partial last step."""
    rng = np.random.default_rng(S + rows)
    src = rng.normal(size=(S, 128)).astype(np.float32)
    idx = rng.integers(0, S, size=(rows, 128)).astype(np.int32)
    smem, threads, U, blocks = gather.axis0_grid(S, sms=1)
    assert (smem, threads, U) == ((True, 1024, 4) if S <= 256
                                  else (False, 256, 1))
    assert blocks == ((2 if S <= 64 else 1) if smem else 8)
    out, writes, banks = _axis0_mirror(src, idx, smem, threads, blocks, U)
    assert (writes == 1).all()
    np.testing.assert_array_equal(out, np.take_along_axis(src, idx, axis=0))
    np.testing.assert_array_equal(
        out, gather.gather_axis0_plain(_t(src), _t(idx)).numpy())
    assert bool(banks) == smem
    for b in banks:  # [component, lanes of one warp]
        assert all(len(set(row)) == len(row) for row in b.tolist())
    # the staged layout without the permutation: lanes l and l + 8 meet
    if smem:
        words = idx[0, ::4][:32] * 128 + 4 * np.arange(32)
        assert len(set((words % 32).tolist())) == 8


@pytest.mark.parametrize("W", [128, 2048])
def test_probe_onehot_records_the_functions_bytes(W):
    """G3's bound is what the function moves: the bf16 window once, one
    idx row per block and the f32 rows; no operations."""
    n = 2 * gather.G3_KC
    rec = gather.probe_onehot(W, CPU, lambda s: None, False, n)
    assert rec["flops"] == 0 and rec["max_abs_err"] == 0.0
    assert rec["nbytes"] == 2 * W * 128 + 4 * n + 4 * n * 128
    assert rec["nbytes"] == gather.onehot_bytes(W, 2, gather.G3_KC)
    assert rec["ms"] is None


def test_block_dot_bf16_fragment_mirror():
    """``block_dot_bf16_kernel``'s A fragments (ldmatrix.x4 from rows of
    136 halves) and B fragments (ldmatrix.x2.trans) over one k16 step give
    the product of the staged tiles."""
    rng = np.random.default_rng(3)
    A = rng.integers(-4, 5, size=(16, 128)).astype(np.float32)
    Bt = rng.integers(-4, 5, size=(128, 64)).astype(np.float32)
    As = np.zeros((16, 136), np.float32)
    As[:, :128] = A
    Bs = np.zeros((128, 72), np.float32)
    Bs[:, :64] = Bt
    lanes = np.arange(32)
    acc = np.zeros((8, 32, 4))
    for k0 in range(0, 128, 16):
        a = _ldmatrix(As, lanes & 15, k0 + (lanes >> 4) * 8, 4, trans=False)
        for j in range(8):
            b = _ldmatrix(Bs, k0 + (lanes & 15), np.full(32, j * 8), 2,
                          trans=True)
            acc[j] += _mma_m16n8k16(a, b)
    C = np.zeros((16, 64))
    for j in range(8):
        for t in range(32):
            g, q = t // 4, t % 4
            C[g, j * 8 + 2 * q:j * 8 + 2 * q + 2] = acc[j, t, :2]
            C[g + 8, j * 8 + 2 * q:j * 8 + 2 * q + 2] = acc[j, t, 2:]
    np.testing.assert_array_equal(C, A @ Bt)


def _dot_f32_mirror(A, B, groups, passes=1):
    """``block_dot_f32_kernel`` (M 64, 128) and ``block_dot_f32_rows_kernel``
    (M 8) in numpy: each CTA (column tile x, group g) stages its k-slices
    through the kernel's thread maps into shared-memory arrays started at
    NaN, and each thread's register tile takes its products in (pass,
    chunk, k) order. Asserts every slot of a stage is written once per
    slice and every output of the [M, 512] tile by one thread; returns
    the sum of the partials over g."""
    nch, M, K = A.shape
    N = 512
    stream = B.ndim == 3
    if M == 8:  # one row x 4 columns a thread; the whole chunk a step
        NT, threads, KS = 128, 256, K
        t = np.arange(threads)
        rows = (t // 32)[:, None]
        cols = 4 * (t % 32)[:, None] + np.arange(4)
    else:
        NT, KS = (128 if M == 128 else 256), 32
        RG, CG = M // 8, NT // 8
        threads, WR = RG * CG, RG // 4
        t = np.arange(threads)
        lane, warp = t & 31, t >> 5
        rg = (warp % WR) * 4 + (lane & 3)
        cg = (warp // WR) * 8 + (lane >> 2)
        q4 = np.arange(4)
        rows = np.concatenate([rg[:, None] * 4 + q4,
                               M // 2 + rg[:, None] * 4 + q4], 1)
        cols = np.concatenate([cg[:, None] * 4 + q4,
                               NT // 2 + cg[:, None] * 4 + q4], 1)
        # the A slice's float4s: row m, k-quad kq (a_slot)
        idx = t[:, None] + threads * np.arange(M * KS // 4 // threads)
        ln, w = idx & 31, idx >> 5
        kq, m = (ln & 3) + 4 * (w & 1), (ln >> 2) + 8 * (w >> 1)
        # the B slice's 16-byte copies
        e = t[:, None] + threads * np.arange(KS * NT // 4 // threads)
        bk, bq = e // (NT // 4), e % (NT // 4)
    owned = np.zeros((M, NT), int)
    np.add.at(owned, (rows[:, :, None], cols[:, None, :]), 1)
    assert (owned == 1).all()
    partial = np.zeros((groups, M, N), np.float32)
    for x in range(N // NT):
        n0 = x * NT
        for g in range(groups):
            mine = len(range(g, nch, groups))
            acc = np.zeros((threads, rows.shape[1], cols.shape[1]),
                           np.float32)
            for it in range(passes * mine * (K // KS)):
                c = g + groups * ((it // (K // KS)) % mine)
                k0 = (it % (K // KS)) * KS
                Bc = B[c] if stream else B
                if M == 8:
                    As, Bs = A[c].T, Bc[:, n0:n0 + NT]  # [k][m], [k][n]
                else:
                    As = np.full((KS, M), np.nan, np.float32)
                    Bs = np.full((KS, NT), np.nan, np.float32)
                    seen = np.zeros((KS, M), int)
                    for i in range(m.shape[1]):
                        for d in range(4):
                            kk = 4 * kq[:, i] + d
                            As[kk, m[:, i]] = A[c, m[:, i], k0 + kk]
                            np.add.at(seen, (kk, m[:, i]), 1)
                    assert (seen == 1).all()
                    for i in range(bk.shape[1]):
                        for d in range(4):
                            Bs[bk[:, i], 4 * bq[:, i] + d] = \
                                Bc[k0 + bk[:, i], n0 + 4 * bq[:, i] + d]
                    assert not np.isnan(Bs).any()
                for k in range(KS):
                    acc += As[k][rows][:, :, None] * Bs[k][cols][:, None, :]
            partial[g][rows[:, :, None], n0 + cols[:, None, :]] = acc
    return partial.sum(0)


@pytest.mark.parametrize("M,stream_b", r2.DOT_CASES)
def test_block_dot_f32_tile_mirror(M, stream_b):
    """Every output of each ``DOT_CASES`` shape is one thread's, every
    slot of a stage is written once a slice, and the CTAs' tiles over
    their chunks sum to the plain version exactly (integer inputs)."""
    A, B = r2.dot_inputs(M, stream_b, integer=True, nch_rows=5 * M)
    want = r2.block_dot_plain(_t(A), _t(B), passes=2).numpy()
    for groups in (1, 2):  # a CTA of one chunk and of several
        np.testing.assert_array_equal(_dot_f32_mirror(A, B, groups, 2), want)
    grid_x, _ = r2.dot_grid(M, "f32")
    assert grid_x == 512 // (128 if M in (8, 128) else 256)


def _scatter_l2_mirror(offs, a, acc_rows, passes=1, ft=r2.L2_FT, u=8):
    """``scatter_l2_kernel`` in numpy f32: the plan (``scatter_plan``),
    then CTA (block, feature tile), thread (j, q) summing its float4 over
    the block's run of ``perm`` in groups of ``u`` slabs; every output
    written by one thread, into an accumulator started at NaN."""
    nch, rows, F = a.shape
    rr = r2.RR
    perm, seg = r2.scatter_plan(offs, acc_rows)
    slabs = a.reshape(-1, rr, F)
    acc = np.full((acc_rows, F), np.nan, np.float32)
    owned = np.zeros((acc_rows, F), int)
    t = np.arange(rr * ft // 4)
    j, q = t // (ft // 4), t % (ft // 4)
    for blk in range(acc_rows // rr):
        for y in range(F // ft):
            f = y * ft + 4 * q[:, None] + np.arange(4)   # [threads, 4]
            s = np.zeros((len(t), 4), np.float32)
            for _ in range(passes):
                k = seg[blk]
                while k < seg[blk + 1]:
                    group = perm[k:min(k + u, seg[blk + 1])]
                    v = [slabs[p][j[:, None], f] for p in group]  # loads
                    for x in v:                                  # adds
                        s += x
                    k += len(group)
            acc[blk * rr + j[:, None], f] = s
            np.add.at(owned, (blk * rr + j[:, None], f), 1)
    assert (owned == 1).all()
    return acc


def _scatter_cases():
    # the quick size; offsets that leave most blocks empty; a few blocks
    # that take many slabs each
    yield "quick", r2.scatter_inputs(r2.L2_ROWS, r2.NCH_SCATTER // 32,
                                     normal=True)
    offs, a = r2.scatter_inputs(512, 2, normal=True)
    yield "sparse", (offs, a)
    rng = np.random.default_rng(5)
    offs = rng.choice([0, 3, 62], size=24).astype(np.int32)
    yield "crowded", (offs, rng.normal(size=(3, 64, 128)).astype(np.float32))


@pytest.mark.parametrize("passes", [1, 3])
@pytest.mark.parametrize("case", ["quick", "sparse", "crowded"])
def test_scatter_l2_plan_mirror(case, passes):
    """The segment walk over the stably sorted plan equals the sequential
    (pass, chunk, slab) loop bit for bit on normal-valued slabs."""
    offs, a = dict(_scatter_cases())[case]
    acc_rows = {"quick": r2.L2_ROWS, "sparse": 512, "crowded": 512}[case]
    perm, seg = r2.scatter_plan(offs, acc_rows)
    counts = np.diff(seg)
    if case == "sparse":
        assert (counts == 0).sum() > len(counts) // 2
    if case == "crowded":
        assert counts.max() > 8
    got = _scatter_l2_mirror(offs, a, acc_rows, passes)
    want = r2.scatter_sequential(offs, a, acc_rows, passes)
    np.testing.assert_array_equal(got, want)
    # a block no slab hits is written as zeros
    empty = np.flatnonzero(counts == 0)
    assert (got.reshape(-1, r2.RR, a.shape[-1])[empty] == 0).all()
    # and the plain version (index_add_ on the CPU) takes the same order
    np.testing.assert_array_equal(
        r2.scatter_plain(_t(offs), _t(a), acc_rows, passes).numpy(), want)


def test_scatter_plan_is_a_stable_sort_with_its_runs():
    offs = np.array([2, 0, 2, 1, 0, 2], np.int32)
    perm, seg = r2.scatter_plan(offs, 4 * r2.RR)
    assert perm.tolist() == [1, 4, 3, 0, 2, 5]
    assert seg.tolist() == [0, 2, 3, 6, 6]
    assert perm.dtype == seg.dtype == np.int32
    for bad in (np.array([0, 4], np.int32), np.array([-1], np.int32)):
        with pytest.raises(ValueError, match="offsets"):
            r2.scatter_plan(bad, 4 * r2.RR)
    with pytest.raises(ValueError, match="blocks"):
        r2.scatter_plan(offs, 4 * r2.RR + 1)


def test_l2_scatter_binds_on_the_cpu():
    offs, a = r2.scatter_inputs(512, 4, normal=True)
    bufs, fn = r2.l2_scatter(offs, 512, device=CPU)
    assert sorted(bufs) == ["perm", "seg"]
    assert fn.meta == dict(slabs=32, blocks=64, rr=r2.RR)
    assert fn.staged_on(bufs) == CPU
    got = fn(bufs, _t(a), 2)
    np.testing.assert_array_equal(got.numpy(), r2.scatter_sequential(
        offs, a, 512, 2))
    with pytest.raises(ValueError, match="CUDA tensor"):
        r2.scatter_l2_cuda(bufs, _t(a), fn.meta)


def _scatter_smem_mirror(offs, a, acc_rows, passes=1, groups=r2.SMEM_GROUPS,
                         cluster=r2.SMEM_CLUSTER, stages=r2.SMEM_STAGES):
    """``scatter_smem_kernel`` in numpy f32, every CTA (group g, 64-feature
    tile) walked as the kernel walks it: the producer fills ring slot
    ``it % stages`` with chunk ``g + groups * (it % mine)`` (its 64 rows
    of the tile and its 8 offsets); consumer thread (j, f) loads the 8
    slab rows and the 8 accumulator rows, takes an earlier slab's sum for
    a block the chunk hit before, adds, and stores in slab order, each
    store by the thread that owns the row (row % R == j). Then rank r of
    each cluster sums its share of rows over the ranks in rank order, and
    the last cluster those shares over the clusters in cluster order,
    each output written once into an ``out`` started at NaN."""
    nch, rows, F = a.shape
    rr, kch, ft = r2.RR, r2.KCH, r2.SMEM_FT
    off = np.asarray(offs).reshape(nch, kch)
    out = np.full((acc_rows, F), np.nan, np.float32)
    written = np.zeros((acc_rows, F), int)
    t = np.arange(rr * ft)
    j, f = t // ft, t % ft                                   # thread (j, f)
    share = -(-acc_rows // cluster)
    for tile in range(F // ft):
        cols = tile * ft + f
        accs = []
        for g in range(groups):
            acc = np.zeros((acc_rows, F), np.float32)[:, :ft].copy()
            owner = np.full((acc_rows, ft), -1)
            ring = np.full((stages, kch * rr, ft), np.nan, np.float32)
            soffs = np.zeros((stages, kch), int)
            mine = len(range(g, nch, groups))
            for it in range(passes * mine):
                s, c = it % stages, g + groups * (it % mine)
                ring[s] = a[c][:, tile * ft:(tile + 1) * ft]   # the TMA box
                soffs[s] = off[c]
                o = soffs[s]
                x = [ring[s][i * rr + j, f] for i in range(kch)]  # loads
                v = [acc[o[i] * rr + j, f] for i in range(kch)]
                for i in range(kch):
                    for k in range(i):
                        if o[k] == o[i]:
                            v[i] = v[k]
                    v[i] = v[i] + x[i]
                for i in range(kch):                              # stores
                    r = o[i] * rr + j
                    assert ((owner[r, f] == -1) | (owner[r, f] == t)).all()
                    owner[r, f] = t
                    acc[r, f] = v[i]
                ring[s] = np.nan                                  # freed
            accs.append(acc)
        sums = []
        for k in range(0, groups, cluster):
            part = np.empty((acc_rows, ft), np.float32)
            for rank in range(cluster):
                r0 = min(acc_rows, rank * share)
                r1 = min(acc_rows, r0 + share)
                v = accs[k][r0:r1]
                for q in range(1, cluster):
                    v = v + accs[k + q][r0:r1]
                part[r0:r1] = v
            sums.append(part)
        res = sums[0]
        for p in sums[1:]:
            res = res + p
        out[:, tile * ft:(tile + 1) * ft] = res
        written[:, tile * ft:(tile + 1) * ft] += 1
    assert (written == 1).all()
    return out


def _scatter_smem_cases():
    # the quick and the full size; a block hit by many slabs; fewer chunks
    # than groups (groups with no chunk)
    yield "quick", r2.scatter_inputs(r2.SMEM_ROWS, r2.NCH_SCATTER // 32,
                                     normal=True)
    yield "full", r2.scatter_inputs(r2.SMEM_ROWS, normal=True)
    rng = np.random.default_rng(6)
    offs = rng.choice([0, 5, 31], size=32, p=[0.7, 0.2, 0.1]).astype(np.int32)
    yield "crowded", (offs, rng.normal(size=(4, 64, 128)).astype(np.float32))
    yield "empty_groups", r2.scatter_inputs(r2.SMEM_ROWS, 3, ft=64,
                                            normal=True)


SMEM_LAUNCH = (r2.SMEM_GROUPS, r2.SMEM_CLUSTER, r2.SMEM_STAGES)


@pytest.mark.parametrize("passes", [1, 3])
@pytest.mark.parametrize("case,launch", [
    ("quick", SMEM_LAUNCH), ("full", SMEM_LAUNCH), ("crowded", SMEM_LAUNCH),
    ("empty_groups", SMEM_LAUNCH), ("quick", (4, 4, 4)),
    ("crowded", (4, 4, 4)), ("empty_groups", (32, 4, 4)),
    ("crowded", (32, 4, 4))])
def test_scatter_smem_order_mirror(case, launch, passes):
    """The kernel's walk (ring stages, one owner per accumulator element,
    the loads of a stage together, cluster ranks and clusters) equals the
    order it keeps, ``r2.scatter_smem_order``, bit for bit on normal
    slabs, and the plain version exactly on integer ones; at the
    wrappers' 12 groups a tile and at 4 and 32 (one and 8 clusters)."""
    groups, cluster, stages = launch
    offs, a = dict(_scatter_smem_cases())[case]
    acc_rows = r2.SMEM_ROWS
    if case == "crowded":
        assert np.bincount(offs).max() > 16
    if case == "empty_groups":
        assert a.shape[0] < groups
    want = r2.scatter_smem_order(offs, a, acc_rows, passes, groups, cluster)
    got = _scatter_smem_mirror(offs, a, acc_rows, passes, groups, cluster,
                               stages)
    np.testing.assert_array_equal(got, want)
    # the order shows on normal values: it is not the sequential loop's
    if case in ("quick", "full"):
        assert (want != r2.scatter_sequential(offs, a, acc_rows,
                                              passes)).any()
    ai = np.rint(a * 4).astype(np.float32)
    np.testing.assert_array_equal(
        _scatter_smem_mirror(offs, ai, acc_rows, passes, groups, cluster,
                             stages),
        r2.scatter_plain(_t(offs), _t(ai), acc_rows, passes).numpy())


def test_smem_scatter_binds_on_the_cpu():
    offs, a = r2.scatter_inputs(r2.SMEM_ROWS, 4, normal=True)
    bufs, fn = r2.smem_scatter(offs, r2.SMEM_ROWS, device=CPU)
    assert sorted(bufs) == ["offs"] and bufs["offs"].dtype == torch.int32
    assert fn.meta == dict(slabs=32, acc_rows=r2.SMEM_ROWS, rr=r2.RR,
                           groups=r2.SMEM_GROUPS, cluster=r2.SMEM_CLUSTER)
    assert fn.staged_on(bufs) == CPU
    got = fn(bufs, _t(a), 2)
    np.testing.assert_array_equal(got.numpy(), r2.scatter_sequential(
        offs, a, r2.SMEM_ROWS, 2))
    r2.check_offs(bufs, fn.meta, CPU)
    with pytest.raises(ValueError, match="offs"):
        r2.check_offs({"offs": bufs["offs"][:-1]}, fn.meta, CPU)
    with pytest.raises(ValueError, match="CUDA tensor"):
        r2.scatter_smem_cuda(bufs, _t(a), fn.meta)
    for bad in (np.array([0, 32], np.int32), np.array([-1], np.int32)):
        with pytest.raises(ValueError, match="offsets"):
            r2.smem_scatter(bad, r2.SMEM_ROWS, device=CPU)


@pytest.mark.parametrize("shape,rows,match", [
    ((2, 64, 96), 256, "multiple of 64"), ((2, 32, 128), 256, "slabs of"),
    ((2, 64, 128), 260, "R=8"), ((2, 64, 128), 4096, "227 KB"),
    ((64, 128), 256, "slabs")])
def test_smem_scatter_refuses_what_its_kernel_does_not_take(shape, rows,
                                                            match):
    with pytest.raises(ValueError, match=match):
        r2._smem_shapes(torch.zeros(shape), rows)
    assert r2._smem_shapes(torch.zeros(3, 64, 128), 256) == (3, 128)


@pytest.mark.parametrize("smem", [True, False])
def test_probe_scatter_times_one_cold_pass_and_records_the_order_check(smem):
    lines = []
    rec = r2.probe_scatter(smem, CPU, out=lines.append, nch=16)
    assert rec["name"] == ("smem_scatter" if smem else "l2_scatter")
    assert rec["order_checked"] is True
    assert all(np.isfinite(rec[k]) and rec[k] > 0
               for k in ("ms", "plain_ms", "library_ms"))
    assert "one pass from an empty L2" in lines[0] and "warm" in lines[0]


# ------------------------------------------------- timing and the CLIs
def test_cold_ms_brackets_one_call_per_repeat():
    calls = []
    ms = bench.cold_ms(lambda: calls.append(time.sleep(0.001)), "cpu",
                       repeats=3)
    # one warm call, then one call a repeat, each near 1 ms
    assert len(calls) == 4 and 0.5 < ms < 500


def test_slope_ms_chains_and_takes_the_least_of_each_side():
    calls = []

    def fn(v):
        calls.append(1)
        return v + 1
    ms = bench.slope_ms(fn, torch.zeros(4), lo=2, hi=5, repeats=2)
    # each side warmed once, then timed twice: (2 + 5) * 3 applications
    assert len(calls) == 21 and np.isfinite(ms)
    seen = []
    assert bench.run_slope_ms(lambda n: seen.append(n), 1, 3, 2,
                              cuda=False) is not None
    assert seen == [1, 3, 1, 1, 3, 3]


@pytest.mark.parametrize("probe", ["mosaic", "r2", "gather"])
def test_probes_run_quick_on_the_cpu(probe):
    mod = {"mosaic": mosaic, "r2": r2, "gather": gather}[probe]
    lines = []
    recs = mod.run(CPU, quick=True, out=lines.append, timed=False)
    # the dots are held to float64 within r2.DOT_C units by the run
    # itself; the rest to their plain versions
    assert recs and all(r["max_abs_err"] <= 1e-4 for r in recs
                        if not r["name"].startswith("block_dot"))
    assert all(r["max_abs_err"] <= 1e-3 and "units, within" in r["line"]
               for r in recs if r["name"].startswith("block_dot"))
    assert all(r["name"] in _build.LAUNCHES for r in recs)
    assert len(lines) >= len(recs)
    assert all("exact=True" in ln or "OK" in ln or "within" in ln
               or "ok=True" in ln for ln in lines)


def test_h100_probes_cli_on_the_cpu():
    spec = importlib.util.spec_from_file_location(
        "h100_probes", os.path.join(SCRIPTS, "h100_probes.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    lines = []
    status, recs = mod.main(["--device", "cpu", "--quick", "--probe",
                             "mosaic"], out=lines.append)
    assert status == 0 and len(recs) == 3
    assert [r["name"] for r in recs] == ["seg_scan_probe", "construct_probe",
                                         "launch_floor"]
    assert lines[0].startswith("device: cpu")
    assert any(ln.startswith("seg_scan [32x128] SUB=4") for ln in lines)
