"""The port's out-of-core tier (``loops_tpu_torch/io/shards.py``) on the
CPU: the tests of ``tests/test_shards.py`` on the port (round trip, edge
balance, partition-then-plan, the streamed SpMM against dense and into a
memmap, empty rows and tiny shards, ``merge_path`` in f32 and bf16, the
skewed case); the shard files against ``loops_tpu``'s array for array;
the streamed output against ``loops_tpu``'s ``StreamedSpMM`` (its Pallas
K4 in interpret mode); K4's ``pad_groups``/``pad_R`` bit for bit;
``powerlaw_csr`` against ``scripts/bench_outofcore.py`` on both of its
paths; and the CLI at a small size.

Tolerances: against the f64 dense product, f32 ``rtol=atol=1e-4`` and
bf16 0.05 (``tests/test_shards.py``'s). Against ``loops_tpu``'s stream,
whose products are rounded the same way and summed in another order:
f32 and bf16 ``rtol=atol=1e-5``. Padded against unpadded K4: bit for bit.
"""
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import loops_tpu.io.shards as jshards
import loops_tpu.utils.generate as jgen
from loops_tpu_torch.io.shards import (
    ShardedCSR,
    StreamedSpMM,
    merge_path_extent,
)
from loops_tpu_torch.layout import CsrLayout
from loops_tpu_torch.ops.kernels import spmm_flat
from loops_tpu_torch.schedule.plans import FlatBlockPlan
from loops_tpu_torch.utils import generate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
TOL = dict(rtol=1e-4, atol=1e-4)
JAX_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def store(tmp_path):
    csr = generate.random_csr(200, 180, 0.05, seed=9)
    sharded = ShardedCSR.build(csr, 4, str(tmp_path / "shards"))
    return csr, sharded


def test_shard_roundtrip(store, tmp_path):
    csr, sharded = store
    re = ShardedCSR.open(str(tmp_path / "shards"))
    assert re.num_shards == 4
    assert tuple(re.shape) == csr.shape
    # every edge present exactly once, with global cols recoverable
    total = 0
    for p in range(4):
        s = re.shard(p)
        nnz = len(s["indices"])
        total += nnz
        gcols = np.asarray(s["gather"])[np.asarray(s["indices"])]
        r0 = s["row0"]
        a0 = csr.offsets[r0]
        assert np.array_equal(gcols, csr.indices[a0:a0 + nnz])
        assert np.array_equal(np.asarray(s["vals"]), csr.vals[a0:a0 + nnz])
    assert total == csr.nnz


def test_edge_balance(store):
    csr, sharded = store
    nnzs = np.asarray(sharded.meta["nnzs"], dtype=np.float64)
    rows = np.diff(sharded.row_starts)
    work = nnzs + rows
    # merge-path cut: every shard within ~2x of the mean work share
    assert work.max() <= 2.0 * work.mean() + 1


def test_partition_then_plan(store):
    csr, sharded = store
    for p in range(4):
        plan = sharded.plan(p, "merge_path", block_work=64)
        s = sharded.shard(p)
        assert plan.num_atoms == len(s["indices"])
        assert plan.num_tiles == s["rows"]


def test_streamed_spmm_matches_dense(store):
    csr, sharded = store
    rng = np.random.default_rng(3)
    X = rng.normal(size=(csr.shape[1], 16)).astype(np.float32)
    got = StreamedSpMM(sharded, device=CPU)(X)
    want = csr.to_dense() @ X
    np.testing.assert_allclose(got, want, **TOL)


def test_streamed_spmm_memmap_out(store, tmp_path):
    csr, sharded = store
    rng = np.random.default_rng(4)
    X = rng.normal(size=(csr.shape[1], 8)).astype(np.float32)
    out = np.lib.format.open_memmap(
        str(tmp_path / "y.npy"), mode="w+",
        dtype=np.float32, shape=(csr.shape[0], 8))
    StreamedSpMM(sharded, device=CPU)(X, out=out)
    out.flush()
    want = csr.to_dense() @ X
    np.testing.assert_allclose(np.load(str(tmp_path / "y.npy")), want, **TOL)


@pytest.mark.parametrize("schedule", ["row_mapped", "merge_path"])
def test_empty_rows_and_tiny_shards(tmp_path, schedule):
    csr = generate.empty_row_csr(17, 5)
    sharded = ShardedCSR.build(csr, 6, str(tmp_path / "s2"))
    X = np.ones((csr.shape[1], 4), np.float32)
    got = StreamedSpMM(sharded, schedule, device=CPU)(X)
    want = csr.to_dense() @ X
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_streamed_spmm_merge_path(tmp_path, dtype):
    """K4 (its plain version here) through the streamed out-of-core path:
    one set of buffers, every shard staged to the common padded shape."""
    csr = generate.random_csr(300, 300, 0.03, seed=6)
    st = ShardedCSR.build(csr, 5, str(tmp_path))
    X = np.random.default_rng(1).normal(size=(300, 48)).astype(np.float32)
    sp = StreamedSpMM(st, schedule="merge_path", dtype=dtype, device=CPU)
    out = sp(X)
    ref = csr.to_dense() @ X
    tol = 0.05 if dtype else 1e-4
    np.testing.assert_allclose(out, ref, atol=tol, rtol=tol)
    # every shard staged into the same buffers, of the store's extent
    assert sp._bufs["vals"].shape == (sp.groups, 512)
    assert all(len(v) == 5 for v in sp.times.values())


def test_streamed_spmm_merge_path_skewed(tmp_path):
    csr = generate.skewed_csr(200, 200, heavy_rows=4)
    st = ShardedCSR.build(csr, 3, str(tmp_path))
    X = np.random.default_rng(2).normal(size=(200, 16)).astype(np.float32)
    out = StreamedSpMM(st, schedule="merge_path", device=CPU)(X)
    np.testing.assert_allclose(out, csr.to_dense() @ X, **TOL)


SHARD_CASES = {
    "random": (lambda g: g.random_csr(300, 280, 0.03, seed=6), 5),
    "skewed": (lambda g: g.skewed_csr(200, 200, heavy_rows=4), 3),
    "empty_rows": (lambda g: g.empty_row_csr(17, 5), 6),
    "tall": (lambda g: g.random_csr(2000, 60, 0.05, seed=2), 7),
}


@pytest.mark.parametrize("name", sorted(SHARD_CASES))
def test_shard_files_equal_jax_package(tmp_path, name):
    make, P = SHARD_CASES[name]
    ShardedCSR.build(make(generate), P, str(tmp_path / "t"))
    jshards.ShardedCSR.build(make(jgen), P, str(tmp_path / "j"))
    files = sorted(os.listdir(tmp_path / "t"))
    assert files == sorted(os.listdir(tmp_path / "j"))
    assert len(files) == 4 * P + 1
    for f in files:
        if f.endswith(".json"):
            with open(tmp_path / "t" / f) as a, open(tmp_path / "j" / f) as b:
                assert json.load(a) == json.load(b)
            continue
        a, b = np.load(tmp_path / "t" / f), np.load(tmp_path / "j" / f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    # each package opens the other's store
    t = ShardedCSR.open(str(tmp_path / "j"))
    assert t.max_rows == jshards.ShardedCSR.open(str(tmp_path / "t")).max_rows


def test_shard_files_without_native_remap(tmp_path, monkeypatch):
    import loops_tpu_torch.native.convert as tconvert
    csr = generate.random_csr(300, 280, 0.03, seed=6)
    ShardedCSR.build(csr, 5, str(tmp_path / "native"))
    monkeypatch.setattr(tconvert, "unique_remap", lambda *a: None)
    ShardedCSR.build(csr, 5, str(tmp_path / "numpy"))
    for f in sorted(os.listdir(tmp_path / "native")):
        if f.endswith(".npy"):
            np.testing.assert_array_equal(np.load(tmp_path / "native" / f),
                                          np.load(tmp_path / "numpy" / f))


@pytest.mark.parametrize("schedule,dtype", [("row_mapped", None),
                                            ("merge_path", None),
                                            ("merge_path", "bfloat16")])
@pytest.mark.parametrize("name", ["random", "skewed", "empty_rows"])
def test_streamed_equals_jax_package(tmp_path, name, schedule, dtype):
    make, P = SHARD_CASES[name]
    csr = make(generate)
    t = ShardedCSR.build(csr, P, str(tmp_path / "t"))
    j = jshards.ShardedCSR.build(make(jgen), P, str(tmp_path / "j"))
    X = np.random.default_rng(3).normal(size=(csr.shape[1], 24)).astype(
        np.float32)
    got = StreamedSpMM(t, schedule, dtype=dtype, device=CPU)(X)
    want = jshards.StreamedSpMM(j, schedule, dtype=dtype)(X)
    np.testing.assert_allclose(got, want, **JAX_TOL)


@pytest.mark.parametrize("block_work", [8, 64, 512])
@pytest.mark.parametrize("name", sorted(generate.SPMM_EDGE_CASES))
def test_merge_path_extent_is_the_plans(name, block_work):
    csr = generate.SPMM_EDGE_CASES[name]()
    plan = FlatBlockPlan.merge_path(CsrLayout.from_csr(csr),
                                    block_work=block_work)
    assert merge_path_extent(csr.offsets, block_work) == (
        plan.num_blocks, plan.max_rel_span)


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
@pytest.mark.parametrize("F", [5, 40, 128])
@pytest.mark.parametrize("name", ["hub", "empty_run", "empty_tail",
                                  "hub_512"])
def test_k4_padded_equals_unpadded_bitwise(name, F, dtype):
    csr = generate.SPMM_EDGE_CASES[name]()
    block = 512 if name.endswith("_512") else 8
    plan = FlatBlockPlan.merge_path(CsrLayout.from_csr(csr),
                                    block_work=block)
    B = torch.from_numpy(np.random.default_rng(F).normal(
        size=(csr.shape[1], F)).astype(np.float32))
    b0, f0 = spmm_flat.flat_spmm(csr, plan, dtype=dtype, device=CPU)
    groups, R = plan.num_blocks + 13, plan.max_rel_span + 40
    b1, f1 = spmm_flat.flat_spmm(csr, plan, dtype=dtype, device=CPU,
                                 pad_groups=groups, pad_R=R)
    assert (f0.meta["groups"], f0.meta["R"]) == (plan.num_blocks,
                                                  plan.max_rel_span)
    assert (f1.meta["groups"], f1.meta["R"]) == (groups, R)
    for k in ("vals", "cols", "rows"):
        assert b1[k].shape == (groups, block)
    for k in ("atom_starts", "row_starts"):
        assert b1[k].shape == (groups + 1,)
    assert (b1["row_first"][plan.num_blocks:] == -1).all()
    assert (b1["row_starts"][plan.num_blocks:] == csr.shape[0]).all()
    assert torch.equal(f0(b0, B), f1(b1, B))
    assert torch.equal(
        spmm_flat.flat_spmm_plain(b1, B, csr.shape, dtype),
        spmm_flat.flat_spmm_plain(b0, B, csr.shape, dtype))
    # pads under the plan's own extent change nothing
    _, f2 = spmm_flat.flat_spmm(csr, plan, device=CPU, pad_groups=1,
                                pad_R=1)
    assert f2.meta["groups"] == plan.num_blocks
    assert f2.meta["R"] == plan.max_rel_span


def test_two_shards_share_one_staged_shape(tmp_path):
    csr = generate.skewed_csr(300, 300, heavy_rows=5)
    st = ShardedCSR.build(csr, 4, str(tmp_path))
    sp = StreamedSpMM(st, "merge_path", block_work=64, device=CPU)
    shapes = {tuple((k, tuple(v.shape)) for k, v in sorted(sp.stage(p).items()))
              for p in range(4)}
    assert len(shapes) == 1


def test_streamed_refusals(store):
    csr, sharded = store
    with pytest.raises(ValueError, match="row_mapped"):
        StreamedSpMM(sharded, "group_mapped", device=CPU)
    with pytest.raises(ValueError, match="merge_path"):
        StreamedSpMM(sharded, "row_mapped", dtype="bfloat16", device=CPU)
    with pytest.raises(ValueError, match="dtype"):
        StreamedSpMM(sharded, "merge_path", dtype="float16", device=CPU)
    with pytest.raises(ValueError, match="rows"):
        StreamedSpMM(sharded, device=CPU)(np.ones((3, 2), np.float32))


def _reference_script():
    spec = importlib.util.spec_from_file_location(
        "bench_outofcore_ref", os.path.join(REPO, "scripts",
                                            "bench_outofcore.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("n,avg_deg", [(5000, 4), (20000, 15),
                                       (1 << 22, 1)])
def test_powerlaw_csr_equals_reference_script(n, avg_deg):
    """The alias path below 2**22 nodes, and the inverse-CDF path with
    the native counting sort from 2**22."""
    want = _reference_script().powerlaw_csr(n, avg_deg)
    got = generate.powerlaw_csr(n, avg_deg)
    assert tuple(got.shape) == tuple(want.shape)
    for name in ("offsets", "indices", "vals"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("args", [
    ["--schedule", "merge_path"],
    ["--schedule", "merge_path", "--dtype", "bfloat16"],
    ["--schedule", "row_mapped"],
])
def test_cli_on_the_cpu(tmp_path, args):
    r = subprocess.run(
        [sys.executable, "scripts/bench_outofcore_torch.py", "--nodes",
         "20000", "--shards", "4", "--feat", "16", "--device", "cpu",
         "--dir", str(tmp_path / "work"), *args],
        capture_output=True, text=True, timeout=300, cwd=REPO)
    assert r.returncode == 0, r.stdout + r.stderr
    lines = r.stdout.splitlines()
    assert [ln.split(":")[0] for ln in lines] == [
        "graph", "stage", "plan", "spmm", "check"]
    assert lines[-1].startswith("check: heaviest row") and \
        lines[-1].endswith("OK")
    for part in ("gather", "upload", "kernel", "download"):
        assert part in lines[3]
    assert not (tmp_path / "work").exists()


def test_cli_keeps_a_directory_it_did_not_make(tmp_path):
    """A ``--dir`` holding other files is refused and left as it was; an
    empty one that existed is kept, with the run's store in it."""
    work = tmp_path / "data"
    work.mkdir()
    (work / "keep.txt").write_text("not the CLI's")
    cmd = [sys.executable, "scripts/bench_outofcore_torch.py", "--nodes",
           "5000", "--shards", "2", "--feat", "8", "--device", "cpu",
           "--dir"]
    r = subprocess.run(cmd + [str(work)], capture_output=True, text=True,
                       timeout=300, cwd=REPO)
    assert r.returncode == 2 and "meta.json" in r.stderr
    assert sorted(os.listdir(work)) == ["keep.txt"]
    empty = tmp_path / "empty"
    empty.mkdir()
    for _ in range(2):  # the second run reuses the first run's store
        r = subprocess.run(cmd + [str(empty)], capture_output=True,
                           text=True, timeout=300, cwd=REPO)
        assert r.returncode == 0, r.stdout + r.stderr
        assert (empty / "meta.json").exists()
