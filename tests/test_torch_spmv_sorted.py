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
from test_torch_spmv_kernels import (
    BATTERY,
    _agree,
    _inputs,
    _seam_pass,
    _store,
    _valid,
)


def _emulate_sorted(a, params, x):
    """Mirror of ``sorted_spmv_kernel``: per block, each row of
    [row_first, row_last] summed over the block's atoms."""
    rows, nb = params["rows"], params["num_blocks"]
    y = np.zeros(rows, np.float32)
    seam = np.full(2 * nb, np.nan, np.float32)
    off = a["offsets"]
    for b in range(nb):
        a0, a1 = a["cuts"][b], a["cuts"][b + 1]
        rf, rl = a["row_first"][b], a["row_last"][b]
        for r in range(rf, rl + 1):
            lo, hi = max(off[r], a0), min(off[r + 1], a1)
            s = np.float32(np.sum(a["vals"][lo:hi] * x[a["cols"][lo:hi]],
                                  dtype=np.float32))
            _store(y, seam, b, r, rf, rl, s)
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


@pytest.mark.parametrize("name", sorted(BATTERY))
def test_sorted_emulated_kernel_battery(name):
    t, _, x = _inputs(name)
    a, params = spmv_sorted.sorted_spmv_plan(t, block_atoms=8)
    _valid(_emulate_sorted(a, params, x), t, x, f"emulated/{name}")
