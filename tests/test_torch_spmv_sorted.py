"""K1, the sorted-flat kernel module of the port, against ``loops_tpu``'s
``sorted_spmv_pallas`` run as ``tests/test_spmv_sorted.py`` runs it on the
CPU (``vregs_per_block=2``, interpret mode), on the same numpy inputs.

Tolerances, the numpy mirrors of the CUDA kernels and the battery are
those of ``test_torch_spmv_kernels.py``.
"""
import functools

import numpy as np
import pytest
import torch

import loops_tpu.utils.generate as jgen
import loops_tpu_torch.formats as tf
from loops_tpu.ops.kernels.spmv_sorted import sorted_spmv_pallas
from loops_tpu_torch.ops.kernels import spmv_sorted
from loops_tpu_torch.utils import generate
from test_torch_spmv_kernels import (
    ATOL,
    BATTERY,
    RTOL,
    _agree,
    _inputs,
    _seam_pass,
    _store,
    _valid,
)


def _emulate_sorted(a, params, x):
    """Mirror of ``sorted_spmv_kernel``: per block, the f32 products of its
    atom range [cuts[b], cuts[b+1]) first (shared memory), then each row of
    [row_first, row_last] summed by a group of ``lanes_per_row`` lanes:
    lane l sums products lo+l, lo+l+g, ... in order, then the xor-shuffle
    tree; interior rows go to y, the first and last to the seam buffer;
    the empty rows after the block's last row up to the next block's
    first (and, in block 0, those before its first) are zeroed. y starts
    at NaN, so a row the kernel leaves unwritten shows."""
    rows, nb = params["rows"], params["num_blocks"]
    g = params["lanes_per_row"]
    y = np.full(rows, np.nan, np.float32)
    seam = np.full(2 * nb, np.nan, np.float32)
    off, cuts = a["offsets"], a["cuts"]
    for b in range(nb):
        a0, a1 = cuts[b], cuts[b + 1]
        rf, rl = a["row_first"][b], a["row_last"][b]
        nxt = a["row_first"][b + 1] if b + 1 < nb else rows
        y[rl + 1:nxt] = 0
        if b == 0:
            y[:rf] = 0
        prod = a["vals"][a0:a1] * x[a["cols"][a0:a1]]
        assert prod.dtype == np.float32
        for r in range(rf, rl + 1):
            lo, hi = max(off[r], a0) - a0, min(off[r + 1], a1) - a0
            part = np.zeros(g, np.float32)
            for lane in range(g):
                for i in range(lo + lane, hi, g):
                    part[lane] = np.float32(part[lane] + prod[i])
            o = g // 2
            while o:
                part = part + part[np.arange(g) ^ o]
                o //= 2
            _store(y, seam, b, r, rf, rl, part[0])
    return _seam_pass(a["row_first"], a["row_last"], seam, y)


# -------------------------------------------------------------- K1 (sorted)
@pytest.mark.parametrize("name", sorted(BATTERY))
def test_sorted_plain_matches_pallas(name):
    t, j, x = _inputs(name)
    jb, jfn = sorted_spmv_pallas(j, vregs_per_block=2, interpret=True)
    tb, tfn = spmv_sorted.sorted_spmv(t, block_atoms=2 * 1024,
                                      device="cpu")
    y = tfn(tb, torch.from_numpy(x))
    _agree(y.numpy(), jfn(jb, x), j, x, f"K1/{name}")
    assert tfn.meta["plan_ms"] >= 0


@pytest.mark.parametrize("case", ["multiblock", "stripes", "span_split",
                                  "long_row"])
def test_sorted_plan_cuts_and_emulated_kernel(case, monkeypatch):
    j, kw = {
        # > ROW_WINDOW rows and several merge-path blocks per stripe, as in
        # tests/test_spmv_sorted.py
        "multiblock": (jgen.random_csr(2600, 700, 0.01, seed=3),
                       dict(block_atoms=2048)),
        # stripes of 1024 rows cut the 2600 rows in three
        "stripes": (jgen.random_csr(2600, 700, 0.01, seed=3),
                    dict(block_atoms=2048)),
        # few atoms per row: blocks are cut by the 896-row span bound
        "span_split": (jgen.tridiag_csr(3000), dict(block_atoms=8192)),
        # one row longer than a block: split across several blocks
        "long_row": (jgen.skewed_csr(40, 3000, heavy_rows=1,
                                     heavy_nnz=2500, seed=1),
                     dict(block_atoms=1024)),
    }[case]
    if case == "stripes":
        monkeypatch.setattr(spmv_sorted, "STRIPE_ROWS", 1024)
    t = tf.csr_from_arrays(j.shape, j.offsets, j.indices, j.vals)
    x = jgen.make_input_vector(j.shape[1])
    a, params = spmv_sorted.sorted_spmv_plan(t, **kw)
    cuts = a["cuts"].astype(np.int64)
    K = params["block_atoms"]
    assert cuts[0] == 0 and cuts[-1] == t.nnz and (np.diff(cuts) > 0).all()
    assert np.diff(cuts).max() <= K
    assert (a["row_last"] - a["row_first"]).max() <= spmv_sorted.ROW_SPAN
    rid = t.row_ids()
    np.testing.assert_array_equal(a["row_first"], rid[cuts[:-1]])
    np.testing.assert_array_equal(a["row_last"], rid[cuts[1:] - 1])
    stripe = params["ST"]
    assert stripe == 1024 if case == "stripes" else stripe >= t.shape[0]
    assert (a["row_first"] // stripe == a["row_last"] // stripe).all()
    lanes = params["lanes_per_row"]
    assert lanes in (1, 2, 4, 8, 16, 32)
    _valid(_emulate_sorted(a, params, x), t, x, f"emulated/{case}")
    tb, tfn = spmv_sorted.sorted_spmv_bind(a, params, "cpu")
    _valid(tfn(tb, torch.from_numpy(x)).numpy(), t, x, f"plain/{case}")


def test_sorted_empty_matrix():
    t = tf.csr_from_arrays((9, 4), np.zeros(10, np.int32), [], [])
    b, fn = spmv_sorted.sorted_spmv(t, device="cpu")
    y = fn(b, torch.zeros(4))
    assert y.shape == (9,) and not y.any()


@pytest.mark.parametrize("block", [8, 1024])
@pytest.mark.parametrize("name", sorted(BATTERY))
def test_sorted_emulated_kernel_battery(name, block):
    t, _, x = _inputs(name)
    a, params = spmv_sorted.sorted_spmv_plan(t, block_atoms=block)
    y = _emulate_sorted(a, params, x)
    _valid(y, t, x, f"emulated/{name}")
    tb, tfn = spmv_sorted.sorted_spmv_bind(a, params, "cpu")
    np.testing.assert_allclose(y, tfn(tb, torch.from_numpy(x)).numpy(),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("block", [8, 64])
@pytest.mark.parametrize("name", sorted(generate.SPMV_EDGE_CASES))
def test_sorted_emulated_kernel_edge_cases(name, block):
    # empty rows between two blocks, before the first and after the last,
    # and rows over several blocks: every row written once
    t = generate.SPMV_EDGE_CASES[name]()
    x = jgen.make_input_vector(t.shape[1])
    a, params = spmv_sorted.sorted_spmv_plan(t, block_atoms=block)
    covered = np.zeros(t.shape[0], bool)
    for r0, r1 in zip(a["row_first"], a["row_last"]):
        covered[r0:r1 + 1] = True
    # rows outside every block's [row_first, row_last], which the kernel
    # zeroes, in all but the cases whose blocks span their empty rows
    assert covered.all() == (name in ("hub", "hub_512", "empty_run"))
    y = _emulate_sorted(a, params, x)
    assert not np.isnan(y).any()
    _valid(y, t, x, f"emulated/{name}/{block}")
    tb, tfn = spmv_sorted.sorted_spmv_bind(a, params, "cpu")
    np.testing.assert_allclose(y, tfn(tb, torch.from_numpy(x)).numpy(),
                               rtol=RTOL, atol=ATOL)


def test_sorted_span_past_the_offsets_window(monkeypatch):
    # with no stripe to cut it, the span split's 64 passes leave a block
    # wider than the kernel's 1024-row offsets window, which it then reads
    # from device memory; the mirror and the plain version still agree
    monkeypatch.setattr(spmv_sorted, "STRIPE_ROWS", 1 << 30)
    t = generate.ladder_csr()
    x = jgen.make_input_vector(t.shape[1])
    a, params = spmv_sorted.sorted_spmv_plan(t, block_atoms=8192)
    assert (a["row_last"] - a["row_first"]).max() >= 1024
    y = _emulate_sorted(a, params, x)
    _valid(y, t, x, "emulated/ladder")
    # a row holds at most one nonzero: its product, exactly
    exact = np.zeros(t.shape[0], np.float32)
    exact[t.row_ids()] = t.vals * x[t.indices]
    np.testing.assert_array_equal(y, exact)


def test_sorted_plan_refuses_blocks_past_shared_memory():
    t = generate.random_csr(40, 30, 0.2, seed=2)
    for k in (0, spmv_sorted.MAX_BLOCK_ATOMS + 1):
        with pytest.raises(ValueError, match="shared memory"):
            spmv_sorted.sorted_spmv_plan(t, block_atoms=k)
    a, params = spmv_sorted.sorted_spmv_plan(t, block_atoms=8)
    assert params["max_atoms"] == int(np.diff(a["cuts"]).max()) <= 8


# --------------------------------------- K1's persistent walk (one launch)
def _k1_shape(a, params, sms=132):
    return spmv_sorted.launch_shape(
        params, spmv_sorted.max_block_rows(a["row_first"], a["row_last"]),
        sms)


# the grids of the persistent walk, clamped to nb as the kernel's launch
# shape clamps them; pieces of a quad or two besides the kernel's own cut
# most rows across pieces
K1_GRIDS = (1, 2, 7, 264, 10 ** 6)


def _k1_holds(a, params, x, label, pieces=(4, 8)):
    want = _emulate_sorted(a, params, x)
    assert not np.isnan(want).any(), label
    nb = params["num_blocks"]
    own = _k1_shape(a, params)["piece"]
    for grid in K1_GRIDS:
        for piece in (own, *pieces):
            got = spmv_sorted.sorted_spmv_mirror(a, params, x,
                                                 min(grid, nb), piece)
            np.testing.assert_array_equal(
                got.view(np.uint32), want.view(np.uint32),
                err_msg=f"{label} grid {grid} piece {piece}")
    return want


@functools.lru_cache(maxsize=None)
def _pallas_y(name):
    """``sorted_spmv_pallas`` in interpret mode on a battery matrix, once
    per matrix (its compile is what takes the time)."""
    _, j, x = _inputs(name)
    jb, jfn = sorted_spmv_pallas(j, vregs_per_block=2, interpret=True)
    return np.asarray(jfn(jb, x))


@pytest.mark.parametrize("block", [8, 1024])
@pytest.mark.parametrize("name", sorted(BATTERY))
def test_k1_persistent_walk_battery(name, block):
    t, j, x = _inputs(name)
    a, params = spmv_sorted.sorted_spmv_plan(t, block_atoms=block)
    y = _k1_holds(a, params, x, f"{name}/{block}")
    _valid(y, t, x, f"k1 walk/{name}")
    _agree(y, _pallas_y(name), j, x, f"k1 walk vs pallas/{name}")


@pytest.mark.parametrize("block", [8, 64])
@pytest.mark.parametrize("name", sorted(generate.SPMV_EDGE_CASES))
def test_k1_persistent_walk_edge_cases(name, block):
    # empty rows between blocks, at range boundaries, before the first
    # and after the last; hub rows over many blocks and ranges
    t = generate.SPMV_EDGE_CASES[name]()
    x = jgen.make_input_vector(t.shape[1])
    a, params = spmv_sorted.sorted_spmv_plan(t, block_atoms=block)
    _valid(_k1_holds(a, params, x, f"{name}/{block}"), t, x, name)


@pytest.mark.parametrize("block", [8, 1024, 4096])
def test_k1_persistent_walk_row_over_ranges(block):
    # one row of 2500 atoms over many blocks: at grid 7 and block 8 it
    # spans several CTA ranges whole, and past 1024 atoms a block is cut
    # into pieces
    j = jgen.skewed_csr(40, 3000, heavy_rows=1, heavy_nnz=2500, seed=1)
    t = tf.csr_from_arrays(j.shape, j.offsets, j.indices, j.vals)
    x = jgen.make_input_vector(j.shape[1])
    a, params = spmv_sorted.sorted_spmv_plan(t, block_atoms=block)
    shape = _k1_shape(a, params)
    assert shape["piece"] == min(-(-params["max_atoms"] // 4) * 4, 1024)
    if block == 8:
        heavy = np.count_nonzero(a["row_first"] == a["row_last"])
        assert heavy > 3 * params["num_blocks"] // 7
    y = _k1_holds(a, params, x, f"row_over_ranges/{block}", pieces=(12,))
    _valid(y, t, x, "row_over_ranges")


def test_k1_launch_shape():
    # the grid is at most 3 CTAs an SM and one block a CTA at least; the
    # piece the longest block rounded to a quad, at most 1024; the window
    # the most rows of a block and one, rounded to a quad, at most 1024
    t = generate.random_csr(3000, 2500, 0.004, seed=7)
    a, params = spmv_sorted.sorted_spmv_plan(t, block_atoms=64)
    nb = params["num_blocks"]
    rows = int((a["row_last"] - a["row_first"]).max()) + 1
    for sms in (1, 132, 10 ** 4):
        s = _k1_shape(a, params, sms)
        assert s["grid"] == min(nb, 3 * sms)
        assert s["piece"] == 64 and s["window"] == -(-(rows + 1) // 4) * 4
    a, params = spmv_sorted.sorted_spmv_plan(t, block_atoms=8192)
    assert _k1_shape(a, params)["piece"] == 1024
    monkey = dict(params, max_atoms=5)
    assert spmv_sorted.launch_shape(monkey, 2000, 1)["window"] == 1024
    assert spmv_sorted.launch_shape(monkey, 2000, 1)["piece"] == 8


def test_k1_persistent_walk_empty_matrix():
    # nnz = 0: no block, no launch; the bound function gives zeros
    t = tf.csr_from_arrays((9, 4), np.zeros(10, np.int32), [], [])
    a, params = spmv_sorted.sorted_spmv_plan(t)
    assert params["num_blocks"] == 0 and a == {}
    b, fn = spmv_sorted.sorted_spmv_bind(a, params, "cpu")
    assert fn.launch is None
    assert not fn(b, torch.zeros(4)).any()


def _lane_tree(p, g):
    """A row's value as lanes sum it: lane l adds p[l], p[l + g], ... to
    0 in order, then lane 0 of the xor tree."""
    part = np.zeros(g, np.float32)
    for lane in range(g):
        for i in range(lane, len(p), g):
            part[lane] = np.float32(part[lane] + p[i])
    o = g // 2
    while o:
        part = part + part[np.arange(g) ^ o]
        o //= 2
    return part[0]


def _one_thread(p, g):
    """``csrc/spmv.cu`` ``k1_tree``: one thread's sum of a short row (at
    most 2 g products): F(0, 1), F(l, o) = F(l, 2 o) + F(l + o, 2 o),
    F(l, g) lane l's partial, summed from 0 in order."""
    n, f32 = len(p), np.float32
    assert n <= 2 * g

    def tree(o, lane):
        if o == g:
            a = f32(0)
            for c in range(2):
                if lane + c * g < n:
                    a = f32(a + p[lane + c * g])
            return a
        return f32(tree(2 * o, lane) + tree(2 * o, lane + o))
    return tree(1, 0)


@pytest.mark.parametrize("g", [1, 2, 4, 8, 16, 32])
def test_k1_one_thread_row_sum_is_the_lane_tree(g):
    # the kernel sums a piece of short rows one row a thread; its order
    # of f32 additions gives the lane groups' value bit for bit (signed
    # zeros, magnitudes far apart, every length up to the cap)
    rng = np.random.default_rng(g)
    cap = 2 * g
    for n in range(cap + 1):
        for _ in range(6):
            p = (rng.standard_normal(n)
                 * 10.0 ** rng.integers(-4, 5, n)).astype(np.float32)
            if n:
                p[rng.integers(0, n)] = -0.0
            want, got = _lane_tree(p, g), _one_thread(p, g)
            assert want.view(np.uint32) == got.view(np.uint32), (g, n, p)


def _four_lanes(p, g, piece):
    """``csrc/spmv.cu`` ``k1_rows``' general path on one row of products
    ``p`` cut into pieces of ``piece``: T = g / 4 threads (g < 4: one)
    each hold lanes tau, tau + T, tau + 2 T, tau + 3 T; a lane sums its
    products from 0, or from the partial the piece before carried; a
    thread reduces its lanes to (a0 + a2) + (a1 + a3), and the T threads
    finish by xor shuffles."""
    f32, n = np.float32, len(p)
    T, k = (g // 4, 4) if g >= 4 else (1, g)
    carry = np.zeros(32, f32)
    for p0 in range(0, max(n, 1), piece):
        p1 = min(n, p0 + piece)
        q = np.zeros(T, f32)
        for tau in range(T):
            lanes = [tau, tau + T if g >= 4 else 1, tau + 2 * T,
                     tau + 3 * T][:k]
            a = []
            for lane in lanes:
                acc = carry[lane] if p0 else f32(0)
                i = lane + (-(-(p0 - lane) // g) * g if lane < p0 else 0)
                for i in range(i, p1, g):
                    acc = f32(acc + p[i])
                a.append(acc)
            for lane, acc in zip(lanes, a):
                carry[lane] = acc
            q[tau] = (f32(f32(a[0] + a[2]) + f32(a[1] + a[3])) if k == 4
                      else f32(a[0] + a[1]) if k == 2 else a[0])
    o = T // 2
    while o:
        q = q + q[np.arange(T) ^ o]
        o //= 2
    return q[0]


@pytest.mark.parametrize("g", [1, 2, 4, 8, 16, 32])
def test_k1_four_lanes_a_thread_is_the_lane_tree(g):
    # a row summed four lanes a thread, its partials carried from piece to
    # piece, gives the lane groups' value bit for bit
    rng = np.random.default_rng(100 + g)
    for n in (1, 2, 3, g, g + 1, 4 * g, 4 * g + 3, 131, 700):
        for piece in (4, 8, 12, 1024):
            p = (rng.standard_normal(n)
                 * 10.0 ** rng.integers(-4, 5, n)).astype(np.float32)
            p[rng.integers(0, n)] = -0.0
            want, got = _lane_tree(p, g), _four_lanes(p, g, piece)
            assert want.view(np.uint32) == got.view(np.uint32), (g, n, piece)
