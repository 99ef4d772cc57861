"""Layouts, the merge-path partitioner, the schedule planners,
``choose_schedule`` and K2's extraction staging of the port give the same
arrays as ``loops_tpu`` on the same matrices."""
import numpy as np
import pytest

import loops_tpu.layout as jl
import loops_tpu.schedule.plans as jp
import loops_tpu.utils.generate as jgen
import loops_tpu_torch.formats as tf
import loops_tpu_torch.layout as tl
import loops_tpu_torch.schedule.plans as tp
from loops_tpu.ops.kernels.spmv_flat_v2 import _stage_extraction as j_stage
from loops_tpu_torch.formats.base import INDEX_DTYPE
from loops_tpu_torch.ops.kernels.spmv_flat_v2 import _keep_flags
from test_torch_spmv_kernels import BATTERY as SPMV_BATTERY

# the 9-matrix battery of tests/test_spmv_battery.py, plus two larger ones
BATTERY = {
    **SPMV_BATTERY,
    "random_big": lambda: jgen.random_csr(300, 280, 0.03, seed=3),
    "skewed_big": lambda: jgen.skewed_csr(200, 150, heavy_rows=3, seed=2),
}


def _pair(name):
    j = BATTERY[name]()
    t = tf.csr_from_arrays(j.shape, j.offsets, j.indices, j.vals)
    return t, j


def _layouts(name):
    t, j = _pair(name)
    return tl.CsrLayout.from_csr(t), jl.CsrLayout.from_csr(j)


def assert_same_fields(a, b, fields):
    for f in fields:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)
        else:
            assert x == y, f


@pytest.mark.parametrize("name", sorted(BATTERY))
def test_csr_layout_matches(name):
    t, j = _layouts(name)
    assert (t.num_tiles, t.num_atoms) == (j.num_tiles, j.num_atoms)
    for m in ("tile_offsets", "tile_sizes", "atom_tile_ids"):
        np.testing.assert_array_equal(getattr(t, m)(), getattr(j, m)(),
                                      err_msg=m)
    atoms = np.arange(t.num_atoms)
    np.testing.assert_array_equal(t.tile_of(atoms), j.tile_of(atoms))
    tl.check_layout_invariants(t)
    tl.check_tile_of_round_trip(t)


@pytest.mark.parametrize("parts", [1, 3, 7, 16])
@pytest.mark.parametrize("name", ["random", "skewed", "empty_rows",
                                  "random_big"])
def test_merge_path_partition_matches(name, parts):
    t, j = _layouts(name)
    off = t.tile_offsets()
    for ipp in (None, 8):
        ta = tl.merge_path_partition(off, parts, ipp)
        ja = jl.merge_path_partition(off, parts, ipp)
        for a, b in zip(ta, ja):
            np.testing.assert_array_equal(a, b)
    walk = tl.merge_path_reference(off)
    assert walk == jl.merge_path_reference(off)
    # every partition boundary lies on the sequential walk
    ta, aa = tl.merge_path_partition(off, parts)
    assert set(zip(ta.tolist(), aa.tolist())) <= set(walk)


FLAT_FIELDS = ("schedule", "num_tiles", "num_atoms", "block_atoms",
               "tile_starts", "atom_starts", "atom_gather", "rel_tile",
               "valid", "num_blocks", "max_rel_span")


@pytest.mark.parametrize("block", [8, 64])
@pytest.mark.parametrize("schedule", ["merge_path", "work_oriented"])
@pytest.mark.parametrize("name", sorted(BATTERY))
def test_flat_block_plan_matches(name, schedule, block):
    t, j = _layouts(name)
    kw = ({"block_work": block} if schedule == "merge_path"
          else {"block_atoms": block})
    tp_plan = tp.make_plan(t, schedule, **kw)
    jp_plan = jp.make_plan(j, schedule, **kw)
    assert_same_fields(tp_plan, jp_plan, FLAT_FIELDS)
    # one plan fed to both packages: from_arrays rebuilds it field for field
    again = tp.FlatBlockPlan.from_arrays(
        jp_plan.schedule, jp_plan.num_tiles, jp_plan.num_atoms,
        jp_plan.block_atoms, jp_plan.tile_starts, jp_plan.atom_starts,
        jp_plan.atom_gather, jp_plan.rel_tile, jp_plan.valid)
    assert_same_fields(again, jp_plan, FLAT_FIELDS)


@pytest.mark.parametrize("class_step", [1.0, 0.5])
@pytest.mark.parametrize("name", sorted(BATTERY))
def test_group_mapped_plan_matches(name, class_step):
    t, j = _layouts(name)
    a = tp.make_plan(t, "group_mapped", class_step=class_step)
    b = jp.make_plan(j, "group_mapped", class_step=class_step)
    assert (a.num_tiles, a.num_atoms, a.padded_atoms) == (
        b.num_tiles, b.num_atoms, b.padded_atoms)
    assert len(a.buckets) == len(b.buckets)
    for ba, bb in zip(a.buckets, b.buckets):
        for k in ("tiles", "atom_slots", "valid"):
            assert ba[k].dtype == bb[k].dtype
            np.testing.assert_array_equal(ba[k], bb[k])


@pytest.mark.parametrize("name", sorted(BATTERY))
def test_row_mapped_plan_matches(name):
    t, j = _layouts(name)
    a, b = tp.make_plan(t, "row_mapped"), jp.make_plan(j, "row_mapped")
    np.testing.assert_array_equal(a.atom_tile_ids, b.atom_tile_ids)


@pytest.mark.parametrize("name", sorted(BATTERY) + ["skew_heavy",
                                                    "medium_band"])
def test_choose_schedule_matches_fitted_table(name):
    extra = {
        "skew_heavy": lambda: jgen.skewed_csr(20, 40, heavy_rows=1,
                                              heavy_nnz=30),
        "medium_band": lambda: jgen.banded_csr(40, 40, band=8),
    }
    j = (BATTERY.get(name) or extra[name])()
    t = tf.csr_from_arrays(j.shape, j.offsets, j.indices, j.vals)
    tlay, jlay = tl.CsrLayout.from_csr(t), jl.CsrLayout.from_csr(j)
    assert tp.HEURISTIC_THRESHOLDS == jp.HEURISTIC_THRESHOLDS
    assert tp.choose_schedule(tlay) == jp.choose_schedule(
        jlay, jp.HEURISTIC_THRESHOLDS)
    legacy = dict(ratio=2.0, cv=0.5, small=4.0, flat="work_oriented")
    assert tp.choose_schedule(tlay, legacy) == jp.choose_schedule(jlay,
                                                                  legacy)


def test_choose_schedule_skew_branch():
    # cv > 4 goes to the degree-class planes under the fitted table
    j = jgen.skewed_csr(400, 400, heavy_rows=1, heavy_nnz=400, light_nnz=1)
    t = tf.csr_from_arrays(j.shape, j.offsets, j.indices, j.vals)
    assert tp.choose_schedule(tl.CsrLayout.from_csr(t)) == "group_mapped"
    assert jp.choose_schedule(jl.CsrLayout.from_csr(j),
                              jp.HEURISTIC_THRESHOLDS) == "group_mapped"
    empty = tf.csr_from_arrays((3, 3), np.zeros(4, np.int32), [], [])
    assert tp.choose_schedule(tl.CsrLayout.from_csr(empty)) == "row_mapped"


def t_stage(plan, lanes=128):
    """The TPU kernel's extraction staging (``_stage_extraction``: row-end
    slots, their 128-aligned rows, mask, keep, s0, R, S) rebuilt on the
    port's keep flags, which are all of it that K2 takes."""
    B, K = plan.atom_gather.shape
    r0 = plan.tile_starts[:-1].astype(np.int64)
    s0 = (r0 // lanes).astype(INDEX_DTYPE)
    valid = plan.valid
    rel = plan.rel_tile.astype(np.int64) + (r0 % lanes)[:, None]
    keep = _keep_flags(plan)
    change = np.zeros((B, K), bool)     # atom k starts a new row run
    change[:, 1:] = valid[:, 1:] & (rel[:, 1:] != rel[:, :-1])
    ends = np.zeros((B, K), bool)       # last atom of each row run
    ends[:, :-1] = valid[:, :-1] & (change[:, 1:] | ~valid[:, 1:])
    ends[:, -1] = valid[:, -1]
    counts = ends.sum(axis=1)
    S = -(-max(int(counts.max(initial=0)), 1) // lanes) * lanes
    eb, ek = np.nonzero(ends)
    slot = np.arange(len(eb)) - np.repeat(np.cumsum(counts) - counts, counts)
    end_arr = np.zeros((B, S), INDEX_DTYPE)
    rel_arr = np.zeros((B, S), INDEX_DTYPE)
    mask_arr = np.zeros((B, S), np.float32)
    end_arr[eb, slot] = ek
    rel_arr[eb, slot] = rel[eb, ek]
    mask_arr[eb, slot] = 1.0
    R = -(-(int(rel_arr.max(initial=0)) + 1) // lanes) * lanes
    return (end_arr, rel_arr, mask_arr, keep.astype(np.float32), s0, R, S)


@pytest.mark.parametrize("block", [8, 32, 256])
@pytest.mark.parametrize("name", sorted(BATTERY))
def test_stage_extraction_matches(name, block):
    _, j = _layouts(name)
    plan = jp.make_plan(j, "merge_path", block_work=block)
    got, want = t_stage(plan), j_stage(plan)
    assert len(got) == len(want) == 7
    for a, b in zip(got, want):
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b


def test_block_rows_are_first_and_last_atom_rows():
    _, j = _pair("skewed_big")
    jplan = jp.make_plan(jl.CsrLayout.from_csr(j), "merge_path",
                         block_work=16)
    plan = tp.FlatBlockPlan.from_arrays(
        jplan.schedule, jplan.num_tiles, jplan.num_atoms, jplan.block_atoms,
        jplan.tile_starts, jplan.atom_starts, jplan.atom_gather,
        jplan.rel_tile, jplan.valid)
    first, last = plan.block_rows()
    rid = j.row_ids()
    n = np.diff(plan.atom_starts)
    has = n > 0
    np.testing.assert_array_equal(first[has], rid[plan.atom_starts[:-1][has]])
    np.testing.assert_array_equal(last[has], rid[plan.atom_starts[1:][has] - 1])
    assert (first[~has] == -1).all() and (last[~has] == -1).all()
