"""K1, the sorted-flat kernel module of the port, against ``loops_tpu``'s
``sorted_spmv_pallas`` run as ``tests/test_spmv_sorted.py`` runs it on the
CPU (``vregs_per_block=2``, interpret mode), on the same numpy inputs.

Tolerances, the numpy mirrors of the CUDA kernels and the battery are
those of ``test_torch_spmv_kernels.py``.
"""
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
