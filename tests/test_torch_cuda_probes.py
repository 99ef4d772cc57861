"""K12 (saxpy) and the probe kernels K13-K15 of ``loops_tpu_torch``
(``csrc/saxpy.cu``, ``csrc/probes.cu``, ``csrc/probes_r2.cu``,
``csrc/probes_gather.cu``) on the card: each against its plain PyTorch
version at small sizes and at the TPU scripts' sizes, two launches bitwise
equal, the launch counters, the wrappers' input checks; the build with the
shared header ``csrc/seg_scan.cuh``, and K2, whose scan moved into it.

Every test here needs an NVIDIA card and skips without one. The file
imports neither JAX nor ``loops_tpu``; run it on the card with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_probes.py

Exact: saxpy, the scan on integer values, the constructs but ``dot0``, the
gathers (G1's sums also on normal values: k0 order from +0, as the plain
version adds them), the scatter, the one-hot expand, the dots on integer
values; the L2 scatter also on normal values, bit for bit against the sequential
(pass, chunk, slab) order computed on the CPU (``r2.scatter_sequential``),
and the smem scatter against its group order (``r2.scatter_smem_order``).
K13's bound forms equal the unbound calls bit for bit; the launch floor
kernel launches and counts. The
scan on normal values at ``atol 1e-4`` and ``dot0`` at ``1e-5`` (the
scripts' own); the dots on normal values within ``r2.DOT_C`` units of
their float64 reference (``r2.hold_dot``), which a TF32 product fails.
"""
import os

import numpy as np
import pytest
import torch

from loops_tpu_torch.layout import CsrLayout
from loops_tpu_torch.ops.kernels import _build, saxpy, spmv_flat_v2
from loops_tpu_torch.probes import gather, mosaic, r2
from loops_tpu_torch.schedule.plans import make_plan
from loops_tpu_torch.utils import generate, reference


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _counted(name, n, fn):
    before = _build.LAUNCHES[name]
    out = fn()
    torch.cuda.synchronize()
    assert _build.LAUNCHES[name] == before + n
    return out


@pytest.mark.cuda
def test_every_entry_point_is_bound_by_the_launch_binding(cuda_device):
    import ctypes
    import types

    _build.load_library()
    assert sorted(_build._FNS) == sorted(_build._SIGNATURES)
    for name, fn in _build._FNS.items():
        assert isinstance(fn, types.BuiltinFunctionType), name
        assert not isinstance(fn, ctypes._CFuncPtr), name
    assert os.path.exists(_build.BUILD_INFO["binding_path"])


@pytest.mark.cuda
def test_build_takes_the_header(cuda_device):
    _build.load_library()
    assert os.path.exists(_build.BUILD_INFO["path"])
    assert os.path.join(_build.SRC_DIR, "seg_scan.cuh") in _build._sources()


@pytest.mark.cuda
@pytest.mark.parametrize("block", [8, 256, 1024])
@pytest.mark.parametrize("name", ["uniform", "skewed", "empty_rows",
                                  "wide_rows"])
def test_k2_after_the_scan_moved(cuda_device, name, block):
    csr = {"uniform": lambda: generate.random_csr(700, 500, 0.02, seed=1),
           "skewed": lambda: generate.skewed_csr(300, 900, heavy_rows=3),
           "empty_rows": lambda: generate.empty_row_csr(400, 300),
           "wide_rows": lambda: generate.random_csr(64, 4000, 0.3, seed=2),
           }[name]()
    x = generate.make_input_vector(csr.shape[1])
    plan = make_plan(CsrLayout.from_csr(csr), "merge_path", block_work=block)
    b, fn = spmv_flat_v2.flat_spmv_v2(csr, plan, device=cuda_device)
    xd = torch.from_numpy(x).to(cuda_device)
    y1 = _counted("flat_spmv_v2", 1, lambda: fn(b, xd))
    assert torch.equal(y1, fn(b, xd))
    y = y1.cpu().numpy()
    plain = spmv_flat_v2.flat_spmv_v2_plain(b, xd, csr.shape).cpu().numpy()
    np.testing.assert_allclose(y, plain, atol=1e-4, rtol=1e-4)
    assert reference.rigorously_validate_spmv(csr, x, y).verdict == \
        "NOT_A_BUG"


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 7, 1000, 1 << 16, (1 << 22) + 3])
def test_saxpy_matches_plain_bitwise(cuda_device, n):
    rng = np.random.default_rng(n)
    x, y = (torch.from_numpy(rng.normal(size=n).astype(np.float32)).to(
        cuda_device) for _ in range(2))
    out = _counted("saxpy", 1, lambda: saxpy.saxpy(2.5, x, y,
                                                   device=cuda_device))
    assert torch.equal(out, saxpy.saxpy_plain(2.5, x, y))
    # a view one float into its buffer: the scalar path
    xb = torch.zeros(n + 1, device=cuda_device)
    xb[1:] = x
    assert torch.equal(saxpy.saxpy_cuda(-0.75, xb[1:], y),
                       saxpy.saxpy_plain(-0.75, x, y))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 3, 4, 5, 1023, 1024, 1025, 65536,
                               (1 << 20) + 7, 1 << 26])
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
def test_saxpy_offsets_bitwise(cuda_device, n, offset):
    # x and y 0-3 floats past 16 bytes, from NaN-filled buffers: the
    # float4 body and its scalar tail at offset 0, the scalar loop else,
    # each a * x + y bit for bit into a new tensor
    g = torch.Generator(device=cuda_device).manual_seed(n + offset)
    x, y = (torch.randn(n, device=cuda_device, generator=g)
            for _ in range(2))
    want = saxpy.saxpy_plain(-0.75, x, y)
    views = []
    for v in (x, y):
        b = torch.full((n + offset,), float("nan"), device=cuda_device)
        b[offset:] = v
        views.append(b[offset:])
    out = _counted("saxpy", 1 if n else 0,
                   lambda: saxpy.saxpy_cuda(-0.75, *views))
    assert out.data_ptr() % 16 == 0 and out.storage_offset() == 0
    assert out.shape == (n,) and torch.equal(out, want)
    # y on 16 bytes: x's offset alone
    assert torch.equal(saxpy.saxpy_cuda(-0.75, views[0], y), want)


@pytest.mark.cuda
def test_saxpy_example_and_shapes(cuda_device):
    x = torch.randn(8, 8192, device=cuda_device)
    y = torch.randn(8, 8192, device=cuda_device)
    assert saxpy.saxpy(2.5, x, y).shape == (8, 8192)
    assert saxpy.saxpy(1.0, x[:0], y[:0]).numel() == 0
    from importlib.util import module_from_spec, spec_from_file_location
    spec = spec_from_file_location("saxpy_torch", os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "examples", "saxpy_torch.py"))
    mod = module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.main(["--device", "cuda"]) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("shape,sub", [((32, 128), 4), ((64, 128), 8),
                                       ((12, 100), 3), ((4096, 128), 4)])
def test_seg_scan_matches_plain(cuda_device, shape, sub):
    rng = np.random.default_rng(sum(shape))
    v = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
        cuda_device)
    keep = torch.from_numpy((rng.random(shape) < 0.9).astype(
        np.float32)).to(cuda_device)
    got = _counted("seg_scan_probe", 2,
                   lambda: mosaic.launch_twice(
                       lambda: mosaic.seg_scan(v, keep, sub)))
    mosaic.hold("scan", got, mosaic.seg_scan_plain(v, keep, sub),
                mosaic.SCAN_ATOL)
    vi = torch.round(v * 8)
    mosaic.hold("scan integer", mosaic.seg_scan(vi, keep, sub),
                mosaic.seg_scan_plain(vi, keep, sub))


@pytest.mark.cuda
def test_k13_probes_at_the_scripts_sizes(cuda_device):
    before = dict(_build.LAUNCHES)
    recs = mosaic.run(cuda_device, timed=False, out=lambda s: None)
    assert [r["name"] for r in recs] == ["seg_scan_probe", "construct_probe",
                                         "launch_floor"]
    # two unbound launches and one bound launch a construct
    assert _build.LAUNCHES["construct_probe"] == \
        before["construct_probe"] + 3 * len(mosaic.CONSTRUCTS)
    assert recs[1]["max_abs_err"] <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["seg_scan", *mosaic.CONSTRUCTS])
def test_k13_bind_forms_equal_the_unbound_calls(cuda_device, kind):
    """Bound once (inputs staged and checked at bind), a call launches into
    a NaN-filled ``out=`` and equals the unbound call bit for bit."""
    if kind == "seg_scan":
        v, keep = (torch.from_numpy(a).to(cuda_device)
                   for a in mosaic.scan_inputs())
        bufs, fn = mosaic.seg_scan_bind(v, keep, device=cuda_device)
        want = mosaic.seg_scan_cuda(v, keep)
        counter = "seg_scan_probe"
    else:
        args = mosaic._on(mosaic.construct_inputs()[kind], cuda_device)
        bufs, fn = mosaic.construct_bind(kind, *args, device=cuda_device)
        want = mosaic.construct_cuda(kind, *args)
        counter = "construct_probe"
    assert fn.staged_on(bufs) == want.device
    out = torch.full_like(want, float("nan"))
    got = _counted(counter, 1, lambda: fn(bufs, out=out))
    assert got is out and torch.equal(out, want)
    with pytest.raises(ValueError, match="out"):
        fn(bufs, out=torch.zeros(3, device=cuda_device))


@pytest.mark.cuda
def test_launch_floor_launches_and_counts(cuda_device):
    buf = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    got = _counted("launch_floor", 1, lambda: mosaic.launch_floor(buf, 9))
    assert got is buf and int(buf.item()) == 9
    with pytest.raises(ValueError, match="elements"):
        mosaic.launch_floor_cuda(torch.zeros(2, dtype=torch.int32,
                                             device=cuda_device))
    us, n = mosaic.profiled_us(lambda: mosaic.launch_floor_cuda(buf),
                               "launch_floor_kernel", launches=50)
    assert n == 0 or 0 < us < 100
    rec = mosaic.probe_floor(cuda_device, out=lambda s: None)
    assert 0 < rec["floor_ms"] < rec["ms"] and rec["events_us"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("mode", r2.MODES)
@pytest.mark.parametrize("case", r2.DOT_CASES)
@pytest.mark.parametrize("rows", [1024, r2.NCH_ROWS])
def test_block_dot(cuda_device, mode, case, rows):
    M, stream_b = case
    before = _build.LAUNCHES[f"block_dot_{mode}"]
    err, units = r2.check_dot(M, stream_b, mode, cuda_device, nch_rows=rows)
    assert _build.LAUNCHES[f"block_dot_{mode}"] == before + 4
    assert np.isfinite(err) and units <= r2.DOT_C
    A, B = r2._dot_tensors(M, stream_b, mode, cuda_device, True, rows)
    assert torch.equal(r2.block_dot(A, B, mode, passes=3),
                       r2.block_dot_plain(A, B, mode, passes=3))


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(128, True), (64, False)])
def test_dot_check_refuses_tf32(cuda_device, case):
    A, B = r2._dot_tensors(*case, "f32", cuda_device)
    assert r2.tf32_units(A, B) > 4 * r2.DOT_C


@pytest.mark.cuda
@pytest.mark.parametrize("smem", [True, False])
@pytest.mark.parametrize("nch", [3, r2.NCH_SCATTER])
def test_scatter(cuda_device, smem, nch):
    rows = r2.SMEM_ROWS if smem else r2.L2_ROWS
    offs, a = (torch.from_numpy(v).to(cuda_device)
               for v in r2.scatter_inputs(rows, nch))
    name = "smem_scatter" if smem else "l2_scatter"
    got = _counted(name, 2, lambda: r2.launch_twice(
        lambda: r2.scatter(offs, a, rows, smem)))
    r2.hold(name, got, r2.scatter_plain(offs, a, rows))
    r2.hold(name, r2.scatter(offs, a, rows, smem, passes=2),
            r2.scatter_plain(offs, a, rows, passes=2))
    if smem:
        return
    # normal values: the sequential order bit for bit, into a NaN-filled
    # out= that the kernel writes in full
    offs_n, a_n = r2.scatter_inputs(rows, nch, normal=True)
    b, fn = r2.l2_scatter(offs_n, rows, device=cuda_device)
    an = torch.from_numpy(a_n).to(cuda_device)
    for passes in (1, 3):
        out = torch.full((rows, r2.FT), float("nan"), device=cuda_device)
        got = _counted(name, 1, lambda: fn(b, an, passes, out=out))
        assert got is out
        assert torch.equal(got.cpu(), torch.from_numpy(
            r2.scatter_sequential(offs_n, a_n, rows, passes)))


@pytest.mark.cuda
@pytest.mark.parametrize("nch", [3, 16, r2.NCH_SCATTER])
@pytest.mark.parametrize("groups", [r2.SMEM_GROUPS, 4, 32])
def test_smem_scatter_order_into_out(cuda_device, monkeypatch, groups, nch):
    """On the script's normal slabs the smem scatter equals its group
    order (``r2.scatter_smem_order``) bit for bit, into a NaN-filled
    ``out=`` it writes in full, over 0, 1 and 3 passes: at the wrappers'
    12 groups a tile, at one cluster a tile and at 8; with fewer chunks
    than groups too."""
    monkeypatch.setattr(r2, "SMEM_GROUPS", groups)
    cluster = r2.SMEM_CLUSTER
    offs, a = r2.scatter_inputs(r2.SMEM_ROWS, nch, normal=True)
    b, fn = r2.smem_scatter(offs, r2.SMEM_ROWS, device=cuda_device)
    assert fn.meta["groups"] == groups
    ad = torch.from_numpy(a).to(cuda_device)
    for passes in (0, 1, 3):
        out = torch.full((r2.SMEM_ROWS, r2.FT), float("nan"),
                         device=cuda_device)
        got = _counted("smem_scatter", 1, lambda: fn(b, ad, passes, out=out))
        assert got is out
        assert torch.equal(got.cpu(), torch.from_numpy(r2.scatter_smem_order(
            offs, a, r2.SMEM_ROWS, passes, groups, cluster)))
    # the tickets are left at zero: a second launch gives the same bits
    assert torch.equal(fn(b, ad, 3), out)


@pytest.mark.cuda
def test_smem_scatter_refusals(cuda_device):
    dev = cuda_device
    offs = torch.zeros(16, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="CUDA tensor"):
        r2.scatter_cuda(offs.cpu(), torch.zeros(2, 64, 512), 256)
    for shape, rows, match in (((2, 64, 96), 256, "multiple of 64"),
                               ((2, 32, 512), 256, "slabs of"),
                               ((2, 64, 512), 260, "R=8"),
                               ((2, 64, 512), 1024, "227 KB")):
        with pytest.raises(ValueError, match=match):
            r2.scatter_cuda(offs, torch.zeros(shape, device=dev), rows)
    b, fn = r2.smem_scatter(offs, 256, device=dev)
    with pytest.raises(ValueError, match="chunks"):
        fn(b, torch.zeros(3, 64, 512, device=dev))
    flat = torch.zeros(2 * 64 * 512 + 1, device=dev)
    with pytest.raises(ValueError, match="aligned"):
        fn(b, flat[1:].view(2, 64, 512))
    with pytest.raises(ValueError, match="offsets"):
        r2.smem_scatter(offs + 32, 256, device=dev)
    with pytest.raises(ValueError, match="dtype"):
        r2.scatter_smem_cuda({"offs": offs.float()}, torch.zeros(
            2, 64, 512, device=dev), fn.meta)


@pytest.mark.cuda
def test_smem_scatter_clusters_fit_one_wave(cuda_device):
    # the wrappers' launch needs F / 64 * groups / cluster clusters at once
    need = r2.FT // r2.SMEM_FT * r2.SMEM_GROUPS // r2.SMEM_CLUSTER
    assert r2.smem_clusters(device=cuda_device) >= need


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["empty_blocks", "crowded", "F=128",
                                  "F=256"])
def test_l2_scatter_edge_plans(cuda_device, case):
    """Blocks no slab hits (written as zeros), blocks of many slabs (past
    the 8 in flight), and feature widths of one and two 128-feature
    tiles."""
    rng = np.random.default_rng(7)
    rows, F = 512, 128
    if case == "empty_blocks":
        offs = rng.integers(0, 5, 16).astype(np.int32)
    elif case == "crowded":
        offs = rng.choice([0, 9, 63], size=40).astype(np.int32)
    else:
        F = int(case[2:])
        offs = rng.integers(0, 64, 24).astype(np.int32)
    a = rng.normal(size=(len(offs) // 8, 8 * r2.RR, F)).astype(np.float32)
    b, fn = r2.l2_scatter(offs, rows, device=cuda_device)
    ad = torch.from_numpy(a).to(cuda_device)
    for passes in (0, 1, 3):
        out = torch.full((rows, F), float("nan"), device=cuda_device)
        fn(b, ad, passes, out=out)
        assert torch.equal(out.cpu(), torch.from_numpy(
            r2.scatter_sequential(offs, a, rows, passes)))
    with pytest.raises(ValueError, match="multiple of"):
        fn(b, torch.zeros(len(offs) // 8, 8 * r2.RR, 192,
                          device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("case", r2.DOT_CASES)
def test_block_dot_into_out(cuda_device, case):
    """``out=`` takes the summed partials: a NaN-filled one is written in
    full and equals a fresh result."""
    A, B = r2._dot_tensors(*case, "f32", cuda_device, nch_rows=1024)
    out = torch.full((case[0], 512), float("nan"), device=cuda_device)
    got = r2.block_dot(A, B, "f32", 2, out=out)
    assert got is out and torch.equal(out, r2.block_dot(A, B, "f32", 2))


@pytest.mark.cuda
def test_r2_dispatch_and_stream_report(cuda_device):
    res = r2.probe_dispatch(cuda_device, out=lambda s: None, launches=20)
    assert res["K12 saxpy_cuda"]["enqueue_us"] > 0
    assert r2.probe_stream(cuda_device, out=lambda s: None, rows=1024) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("S", gather.P1_S)
@pytest.mark.parametrize("n", [4096, gather.N_ELEMS])
def test_gather_axis0(cuda_device, S, n):
    rec = gather.probe_axis0(S, cuda_device, lambda s: None, False, n)
    assert rec["max_abs_err"] == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("S", gather.P1_S)
@pytest.mark.parametrize("rows", [1, 777, 4097])
def test_gather_axis0_partial_step(cuda_device, S, rows):
    """idx rows that leave the last step of 4 items a thread partial (and
    one row, less than one step of one CTA): bit for bit, two launches
    equal, into every element."""
    rng = np.random.default_rng(rows)
    src = torch.from_numpy(rng.normal(size=(S, 128)).astype(
        np.float32)).to(cuda_device)
    idx = torch.from_numpy(rng.integers(0, S, size=(rows, 128)).astype(
        np.int32)).to(cuda_device)
    got = _counted("gather_axis0", 2, lambda: gather.launch_twice(
        lambda: gather.gather_axis0(src, idx)))
    assert torch.equal(got, gather.gather_axis0_plain(src, idx))


@pytest.mark.cuda
@pytest.mark.parametrize("S", [*gather.P2_S, 3])
@pytest.mark.parametrize("n", [4096, gather.N_ELEMS])
def test_gather_axis1(cuda_device, S, n):
    rec = gather.probe_axis1(S, cuda_device, lambda s: None, False, n)
    assert rec["max_abs_err"] == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(gather.DTYPES))
@pytest.mark.parametrize("S", [gather.SMEM_ROWS, 4096, gather.ARXIV_ROWS,
                               gather.HBM_ROWS])
@pytest.mark.parametrize("K,mat", [(8, False), (32, False), (128, False),
                                   (512, False), (64, True), (8, True)])
def test_row_gather(cuda_device, dtype, S, K, mat):
    # G1 bit for bit on the normal slab and on the integer one (probe_rows
    # holds both): its f32 sums run in k0 order from +0
    for n in (K * 3, gather.N_ROWS // 8):
        rec = gather.probe_rows(S, K, dtype, mat, cuda_device,
                                lambda s: None, False, n)
        assert rec["max_abs_err"] == 0.0
        assert rec["name"].endswith(gather.residency(
            S, torch.empty(0, dtype=gather.DTYPES[dtype]).element_size()))


@pytest.mark.cuda
@pytest.mark.parametrize("W", [64, *gather.G3_W])
@pytest.mark.parametrize("n", [2048, 3 * gather.G3_KC, gather.N_ROWS])
def test_onehot_expand(cuda_device, W, n):
    # bit for bit the plain version (two launches equal), 2, 3 (odd) and
    # 2048 blocks of Kc rows
    rec = gather.probe_onehot(W, cuda_device, lambda s: None, False, n)
    assert rec["max_abs_err"] == 0.0 and rec["flops"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("W", [64, 512, 2048, 3000])
@pytest.mark.parametrize("Kc,nblocks", [(100, 5), (33, 1), (1024, 7)])
def test_onehot_expand_odd_shapes(cuda_device, W, Kc, nblocks):
    # blocks of Kc rows that cut a warp's steps of 32 rows, one block,
    # odd block counts; windows in shared memory, from L2 and one of W
    # past a power of two
    win, idx = (torch.from_numpy(a).to(cuda_device)
                for a in gather.onehot_inputs(W, Kc, nblocks * Kc))
    out = gather.onehot_expand(win, idx)
    assert tuple(out.shape) == (nblocks * Kc, 128)
    assert torch.equal(out, gather.onehot_expand_plain(win, idx))


@pytest.mark.cuda
def test_wrappers_check_inputs(cuda_device):
    dev = cuda_device
    x = torch.ones(64, device=dev)
    with pytest.raises(ValueError, match="CUDA tensor"):
        saxpy.saxpy_cuda(1.0, x.cpu(), x.cpu())
    with pytest.raises(ValueError, match="dtype"):
        saxpy.saxpy_cuda(1.0, x.double(), x.double())
    with pytest.raises(ValueError, match="elements"):
        saxpy.saxpy_cuda(1.0, x, x[:3])
    v = torch.ones(32, 128, device=dev)
    with pytest.raises(ValueError, match="rows"):
        mosaic.seg_scan_cuda(v[:30], v[:30], 4)
    with pytest.raises(ValueError, match="contiguous"):
        mosaic.seg_scan_cuda(v.t(), v.t(), 4)
    with pytest.raises(ValueError, match="base"):
        mosaic.construct_cuda("dynbase", torch.ones(4, 128, device=dev), 13)
    with pytest.raises(ValueError, match="expected"):
        mosaic.construct_cuda("shift_sub", torch.ones(16, 128, device=dev))
    A = torch.ones(8, 64, 128, device=dev)
    with pytest.raises(ValueError, match="B must be"):
        r2.block_dot_cuda(A, torch.ones(128, 256, device=dev))
    with pytest.raises(ValueError, match="dtype"):
        r2.block_dot_cuda(A, torch.ones(128, 512, device=dev), "bf16")
    with pytest.raises(ValueError, match="M in"):
        r2.block_dot_cuda(torch.ones(8, 32, 128, device=dev),
                          torch.ones(128, 512, device=dev))
    with pytest.raises(ValueError, match="227 KB"):
        r2.scatter_cuda(torch.zeros(8, dtype=torch.int32, device=dev),
                        torch.ones(1, 64, 512, device=dev), 4096)
    src = torch.ones(8, 128, device=dev)
    with pytest.raises(ValueError, match="dtype"):
        gather.gather_axis0_cuda(src, torch.zeros(8, 128, device=dev))
    with pytest.raises(ValueError, match="n % K"):
        gather.row_gather_cuda(src, torch.zeros(12, dtype=torch.int32,
                                                device=dev), 8, False)
    with pytest.raises(ValueError, match="nblocks"):
        gather.onehot_expand_cuda(torch.ones(100, 128, device=dev),
                                  torch.zeros(12, 128, dtype=torch.int32,
                                              device=dev))
