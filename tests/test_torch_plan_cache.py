"""The port's plan cache (``loops_tpu_torch/io/plan_cache.py``): the six
tests of ``tests/test_plan_cache.py`` on the port, C2's fix (processes
that save one key at once leave one readable file and no error), a file
the JAX package wrote being a miss, and ``SpMVOperator(plan_cache=)``
giving a bitwise-equal ``y`` from a built plan and from a cached one."""
import multiprocessing as mp
import os

import numpy as np
import pytest
import torch

import loops_tpu.io.plan_cache as jcache
import loops_tpu.utils.generate as jgen
from loops_tpu_torch.io import plan_cache
from loops_tpu_torch.io.plan_cache import (
    load_plan,
    matrix_content_key,
    plan_cache_get_or_build,
    plan_key,
    save_plan,
)
from loops_tpu_torch.ops.kernels import spmv_sorted
from loops_tpu_torch.ops.spmv import SpMVOperator
from loops_tpu_torch.utils.generate import random_csr

CPU = torch.device("cpu")


def _csr(n=512, sparsity=0.01, seed=1):
    return random_csr(n, n, sparsity, seed=seed)


def test_content_key_sensitivity():
    a = _csr(seed=1)
    b = _csr(seed=2)
    assert matrix_content_key(a) == matrix_content_key(a)
    assert matrix_content_key(a) != matrix_content_key(b)
    # same pattern, different values must not alias
    c = type(a)(a.shape, a.offsets.copy(), a.indices.copy(), a.vals + 1.0)
    assert matrix_content_key(a) != matrix_content_key(c)
    # the JAX package hashes the same bytes the same way
    assert matrix_content_key(a) == jcache.matrix_content_key(
        jgen.random_csr(512, 512, 0.01, seed=1))


def test_plan_key_includes_knobs():
    a = _csr()
    k1 = plan_key(a, "sorted_spmv", {"block_atoms": 64})
    k2 = plan_key(a, "sorted_spmv", {"block_atoms": 128})
    assert k1 != k2
    # and the version: never the JAX package's key for the same plan
    assert k1 != jcache.plan_key(a, "sorted_spmv", {"block_atoms": 64})


def test_save_load_round_trip(tmp_path):
    arrays = dict(x=np.arange(12, dtype=np.int32).reshape(3, 4),
                  y=np.ones(5, np.float32))
    params = dict(rows=7, span=16, plan_ms=1.25)
    save_plan(tmp_path, "k0", arrays, params)
    out = load_plan(tmp_path, "k0")
    assert out is not None
    arr2, par2 = out
    np.testing.assert_array_equal(arr2["x"], arrays["x"])
    np.testing.assert_array_equal(arr2["y"], arrays["y"])
    assert par2["rows"] == 7 and par2["plan_ms"] == 1.25
    assert load_plan(tmp_path, "missing") is None
    # the temporary file is gone: only the published one is left
    assert sorted(os.listdir(tmp_path)) == ["k0.npz"]


def test_get_or_build_hit_and_miss(tmp_path):
    a = _csr()
    calls = []

    def build():
        calls.append(1)
        return dict(z=np.zeros(3, np.int8)), dict(rows=3, plan_ms=9.0)

    arr1, p1 = plan_cache_get_or_build(tmp_path, a, {"s": 1}, build)
    assert p1["plan_source"] == "built" and len(calls) == 1
    arr2, p2 = plan_cache_get_or_build(tmp_path, a, {"s": 1}, build)
    assert p2["plan_source"] == "cache" and len(calls) == 1
    assert p2["built_plan_ms"] == 9.0      # the build's cost kept
    assert p2["plan_ms"] >= 0
    np.testing.assert_array_equal(arr1["z"], arr2["z"])
    # different knobs -> rebuild
    plan_cache_get_or_build(tmp_path, a, {"s": 2}, build)
    assert len(calls) == 2


def test_sorted_spmv_cached_plan_matches(tmp_path):
    """End to end: a cache-hit bind computes the identical result."""
    csr = _csr(n=1024, sparsity=0.02, seed=3)
    x = np.random.default_rng(0).standard_normal(1024).astype(np.float32)
    cold = SpMVOperator(csr, schedule="sorted_flat",
                        plan_cache=str(tmp_path), device=CPU)
    assert cold.meta.get("plan_source") == "built"
    y_cold = cold(x)
    warm = SpMVOperator(csr, schedule="sorted_flat",
                        plan_cache=str(tmp_path), device=CPU)
    assert warm.meta.get("plan_source") == "cache"
    y_warm = warm(x)
    assert torch.equal(y_cold, y_warm)
    # the reported plan cost on a hit is the load time, the build's beside
    assert warm.meta["built_plan_ms"] == pytest.approx(cold.meta["plan_ms"])
    assert warm.meta["plan_ms"] >= 0


def test_corrupt_cache_file_is_a_miss(tmp_path):
    a = _csr()
    key = plan_key(a, "sorted_spmv", {})
    (tmp_path / f"{key}.npz").write_bytes(b"not an npz")
    assert load_plan(tmp_path, key) is None


def test_c2_processes_saving_one_key(tmp_path):
    """C2: ``loops_tpu`` writes every save through ``.{key}.tmp.npz``, so
    two savers of one key write one temporary file under each other. The
    port's savers each write their own and rename it into place."""
    ctx = mp.get_context("spawn")
    jobs = [(str(tmp_path), "k", dict(a=np.full(20000, seed, np.int32)),
             dict(seed=seed, plan_ms=1.0)) for seed in range(4)] * 25
    with ctx.Pool(4) as pool:
        done = pool.starmap_async(save_plan, jobs, chunksize=1).get(
            timeout=120)
    assert len(done) == 100
    assert sorted(os.listdir(tmp_path)) == ["k.npz"]
    arrays, params = load_plan(tmp_path, "k")
    # one saver's whole file: its array agrees with its params
    assert params["seed"] in range(4)
    assert (arrays["a"] == params["seed"]).all()


def test_c2_a_lost_rename_is_tolerated(tmp_path, monkeypatch):
    save_plan(tmp_path, "k", dict(a=np.zeros(3)), dict(plan_ms=1.0))

    def refuse(src, dst):
        raise PermissionError("the target is in use")
    monkeypatch.setattr(plan_cache.os, "replace", refuse)
    # another saver's file stands: this save gives way without an error
    save_plan(tmp_path, "k", dict(a=np.ones(3)), dict(plan_ms=2.0))
    assert sorted(os.listdir(tmp_path)) == ["k.npz"]
    np.testing.assert_array_equal(load_plan(tmp_path, "k")[0]["a"],
                                  np.zeros(3))
    # with no file to give way to, the failure is raised
    with pytest.raises(PermissionError):
        save_plan(tmp_path, "other", dict(a=np.ones(3)), dict(plan_ms=2.0))
    assert sorted(os.listdir(tmp_path)) == ["k.npz"]


def test_jax_written_cache_file_is_a_miss(tmp_path):
    csr = _csr(n=300, sparsity=0.03, seed=5)
    knobs = dict(block_atoms=spmv_sorted.BLOCK_ATOMS)
    key = plan_key(csr, "sorted_spmv", knobs, spmv_sorted.PLAN_KEY_ARRAYS)
    # the JAX package's file, under the key K1's bind looks up
    jarr, jpar = dict(vals=np.ones(4, np.float32)), dict(plan_ms=1.0)
    jcache.save_plan(tmp_path, key, jarr, jpar)
    assert jcache.load_plan(tmp_path, key) is not None
    assert load_plan(tmp_path, key) is None
    op = SpMVOperator(csr, schedule="sorted_flat", plan_cache=str(tmp_path),
                      device=CPU)
    assert op.meta["plan_source"] == "built"
    # and the JAX package misses the port's file
    assert jcache.load_plan(tmp_path, key) is None


@pytest.mark.parametrize("schedule,impl", [("sorted_flat", "xla"),
                                           ("merge_path", "pallas3"),
                                           ("auto", "xla")])
@pytest.mark.parametrize("seed", [1, 2])
def test_operator_plan_cache_bitwise(tmp_path, schedule, impl, seed):
    csr = random_csr(700, 600, 0.02, seed=seed)
    x = np.random.default_rng(seed).uniform(-1, 1, 600).astype(np.float32)
    ops = [SpMVOperator(csr, schedule, impl=impl, plan_cache=str(tmp_path),
                        device=CPU) for _ in range(2)]
    assert ops[0].impl_used == "sorted_spmv"
    assert [op.meta["plan_source"] for op in ops] == ["built", "cache"]
    assert torch.equal(ops[0](x), ops[1](x))
    uncached = SpMVOperator(csr, schedule, impl=impl, device=CPU)
    assert torch.equal(uncached(x), ops[1](x))
    assert uncached.meta["plan_source"] == "built"


def test_block_atoms_is_part_of_the_key(tmp_path):
    csr = random_csr(400, 400, 0.02, seed=7)
    _, f1 = spmv_sorted.sorted_spmv(csr, block_atoms=64, device=CPU,
                                    cache_dir=tmp_path)
    _, f2 = spmv_sorted.sorted_spmv(csr, block_atoms=128, device=CPU,
                                    cache_dir=tmp_path)
    _, f3 = spmv_sorted.sorted_spmv(csr, block_atoms=64, device=CPU,
                                    cache_dir=tmp_path)
    assert [f.meta["plan_source"] for f in (f1, f2, f3)] == [
        "built", "built", "cache"]
    assert f1.meta["num_blocks"] == f3.meta["num_blocks"] != \
        f2.meta["num_blocks"]
    assert len(os.listdir(tmp_path)) == 2


def test_empty_matrix_plan_caches(tmp_path):
    from loops_tpu_torch.formats import CSR
    empty = CSR((5, 7), np.zeros(6, np.int64), np.zeros(0, np.int64),
                np.zeros(0, np.float32))
    for source in ("built", "cache"):
        op = SpMVOperator(empty, "sorted_flat", plan_cache=str(tmp_path),
                          device=CPU)
        assert op.meta["plan_source"] == source
        assert not op(np.ones(7, np.float32)).any()


@pytest.mark.parametrize("schedule,impl", [("row_mapped", "xla"),
                                           ("group_mapped", "xla"),
                                           ("merge_path", "pallas2"),
                                           ("work_oriented", "pallas")])
def test_route_without_a_plan_to_cache_leaves_dir_unused(tmp_path, schedule,
                                                         impl):
    csr = random_csr(200, 200, 0.03, seed=4)
    d = tmp_path / "cache"
    op = SpMVOperator(csr, schedule, impl=impl, plan_cache=str(d),
                      device=CPU)
    x = np.ones(200, np.float32)
    np.testing.assert_allclose(op(x).numpy(), csr.to_dense() @ x,
                               rtol=1e-5, atol=1e-5)
    assert not d.exists()


def test_cache_holds_the_plan_not_the_matrix(tmp_path):
    """K1's cached file holds the arrays the plan derives; a hit takes the
    matrix's own arrays from the caller's CSR (its row structure is
    keyed)."""
    csr = random_csr(500, 400, 0.02, seed=9)
    _, f1 = spmv_sorted.sorted_spmv(csr, device=CPU, cache_dir=tmp_path)
    (name,) = os.listdir(tmp_path)
    with np.load(tmp_path / name) as z:
        stored = sorted(k for k in z.files if not k.startswith("__"))
    assert stored == sorted(spmv_sorted.PLAN_ARRAYS)
    b2, f2 = spmv_sorted.sorted_spmv(csr, device=CPU, cache_dir=tmp_path)
    b0, _ = spmv_sorted.sorted_spmv(csr, device=CPU)
    assert f2.meta["plan_source"] == "cache"
    assert sorted(b2) == sorted(b0)
    for k in b0:
        assert torch.equal(b0[k], b2[k]), k
    assert f1.meta["key_ms"] >= 0 and f2.meta["key_ms"] >= 0


def test_k1_key_is_the_row_structure(tmp_path):
    """K1's plan derives from the shape and the row offsets: a matrix with
    those and other columns and values hits the cache and computes its
    own product, bit for bit the product of its own built plan; other
    offsets or another shape miss."""
    a = random_csr(600, 500, 0.02, seed=11)
    rng = np.random.default_rng(11)
    # other columns (each row's still distinct) and other values
    b = type(a)(a.shape, a.offsets.copy(), (a.indices + 7) % 500,
                rng.standard_normal(a.nnz).astype(np.float32))
    x = rng.uniform(-1, 1, 500).astype(np.float32)
    ops = [SpMVOperator(m, "sorted_flat", plan_cache=str(tmp_path),
                        device=CPU) for m in (a, b)]
    assert [op.meta["plan_source"] for op in ops] == ["built", "cache"]
    assert len(os.listdir(tmp_path)) == 1
    own = SpMVOperator(b, "sorted_flat", device=CPU)
    assert torch.equal(ops[1](x), own(x))
    np.testing.assert_allclose(ops[1](x).numpy(), b.to_dense() @ x,
                               rtol=1e-5, atol=1e-5)
    assert not torch.equal(ops[0](x), ops[1](x))
    # the key hashes the offsets, not the columns or values
    knobs = dict(block_atoms=spmv_sorted.BLOCK_ATOMS)
    keys = spmv_sorted.PLAN_KEY_ARRAYS
    assert plan_key(a, "sorted_spmv", knobs, keys) == plan_key(
        b, "sorted_spmv", knobs, keys)
    assert plan_key(a, "sorted_spmv", knobs) != plan_key(
        b, "sorted_spmv", knobs)
    other = random_csr(600, 500, 0.02, seed=12)
    wider = type(a)((600, 501), a.offsets, a.indices, a.vals)
    for m in (other, wider):
        op = SpMVOperator(m, "sorted_flat", plan_cache=str(tmp_path),
                          device=CPU)
        assert op.meta["plan_source"] == "built"
    assert len(os.listdir(tmp_path)) == 3
