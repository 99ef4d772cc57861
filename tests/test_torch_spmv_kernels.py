"""The SpMV kernel modules of the port against ``loops_tpu``'s Pallas
kernels (K2 and K3 here, K1 in ``test_torch_spmv_sorted.py``), run as
the JAX package's own tests run them on the CPU (interpret mode), on the
same numpy inputs.

On the CPU each wrapper takes its plain PyTorch version, so that is what
is compared here. The tolerance is ``rtol=1e-5, atol=1e-6``: both sides
sum each row in f32, in different orders (the TPU kernels by log-step
scans or exact one-hot matmuls, the plain versions sequentially). Both
must also pass the Wilkinson validator.

The CUDA kernels cannot run here. ``_emulate_*`` mirror, in numpy, what
each kernel of ``csrc/spmv.cu`` does with its staged buffers (block-local
row sums, row ends from the keep flags, the row window, the seam pass),
so a wrong staging array shows on the CPU. ``test_torch_cuda_kernels.py``
holds each kernel against its plain version on the card.
"""
import numpy as np
import pytest
import torch

import loops_tpu.layout as jl
import loops_tpu.schedule.plans as jp
import loops_tpu.utils.generate as jgen
import loops_tpu_torch.formats as tf
import loops_tpu_torch.schedule.plans as tp
from loops_tpu.formats import CSR as JaxCSR
from loops_tpu.ops.kernels.spmv_flat import flat_spmv_pallas
from loops_tpu.ops.kernels.spmv_flat_v2 import flat_spmv_pallas_v2
from loops_tpu_torch.layout import CsrLayout
from loops_tpu_torch.ops.kernels import spmv_flat, spmv_flat_v2
from loops_tpu_torch.utils import generate, reference
from loops_tpu_torch.utils.equal import count_mismatches

RTOL, ATOL = 1e-5, 1e-6

def _jax_csr(t):
    return JaxCSR(t.shape, t.offsets, t.indices, t.vals)


# the 9-matrix battery of tests/test_spmv_battery.py, made by the port's
# generators and handed to loops_tpu as the same arrays
BATTERY = {name: (lambda make=make: _jax_csr(make()))
           for name, make in generate.BATTERY.items()}


def _inputs(name):
    j = BATTERY[name]()
    t = tf.csr_from_arrays(j.shape, j.offsets, j.indices, j.vals)
    x = jgen.make_input_vector(j.shape[1])
    return t, j, x


def _plans(j, block):
    jplan = jp.FlatBlockPlan.merge_path(jl.CsrLayout.from_csr(j),
                                        block_work=block)
    tplan = tp.FlatBlockPlan.from_arrays(
        jplan.schedule, jplan.num_tiles, jplan.num_atoms, jplan.block_atoms,
        jplan.tile_starts, jplan.atom_starts, jplan.atom_gather,
        jplan.rel_tile, jplan.valid)
    return tplan, jplan


def _agree(y_port, y_jax, csr, x, label, rtol=RTOL, atol=ATOL):
    y_port, y_jax = np.asarray(y_port), np.asarray(y_jax)
    assert y_port.shape == y_jax.shape == (csr.shape[0],), label
    np.testing.assert_allclose(y_port, y_jax, rtol=rtol, atol=atol,
                               err_msg=label)
    for side, y in (("port", y_port), ("jax", y_jax)):
        _valid(y, csr, x, f"{label}/{side}")


def _valid(y, csr, x, label):
    """The repo's battery check: default battery tolerance against the
    host f32 reference, and the Wilkinson verdict."""
    n = count_mismatches(y, reference.spmv(csr, x), atol=1e-3, rtol=1e-4)
    assert n == 0, f"{label}: {n} mismatches"
    rep = reference.rigorously_validate_spmv(csr, x, y)
    assert rep.verdict == "NOT_A_BUG", f"{label}: {rep}"


# ----------------------------------------------- numpy mirrors of the kernels
def _seam_pass(row_first, row_last, seam, y):
    """Mirror of ``seam_kernel``: the first block touching a boundary row
    owns it and adds the later blocks' partials in block order."""
    nb = len(row_first)

    def walk(r, c, s):
        while c < nb and row_first[c] == r:
            s += seam[2 * c]
            if row_last[c] != r:
                break
            c += 1
        return s

    for b in range(nb):
        rf, rl = row_first[b], row_last[b]
        if rf < 0:
            continue
        if b == 0 or row_last[b - 1] != rf:
            s = seam[2 * b]
            if rl == rf:
                s = walk(rf, b + 1, s)
            y[rf] = s
        if rl != rf:
            y[rl] = walk(rl, b + 1, seam[2 * b + 1])
    return y


def _store(y, seam, b, row, rf, rl, s):
    if row == rf:
        seam[2 * b] = s
    elif row == rl:
        seam[2 * b + 1] = s
    else:
        y[row] = s


def _emulate_flat_v2(b, rows, x, chunk=256):
    """Mirror of ``flat_spmv_v2_kernel``: a segmented scan over each
    block's products, reset where keep == 0, in chunks with a carry; each
    row end (keep of the next atom == 0, or the last atom) stores."""
    a = {k: v.numpy() for k, v in b.items()}
    nb, K = a["vals"].shape
    y = np.zeros(rows, np.float32)
    seam = np.full(2 * nb, np.nan, np.float32)
    for blk in range(nb):
        n = a["atom_starts"][blk + 1] - a["atom_starts"][blk]
        rf, rl = a["row_first"][blk], a["row_last"][blk]
        run = np.float32(0)
        for k in range(n):
            p = np.float32(a["vals"][blk, k] * x[a["cols"][blk, k]])
            run = p if a["keep"][blk, k] == 0 else np.float32(run + p)
            if k == n - 1 or a["keep"][blk, k + 1] == 0:
                row = a["tile_starts"][blk] + a["rel"][blk, k]
                _store(y, seam, blk, row, rf, rl, run)
    return _seam_pass(a["row_first"], a["row_last"], seam, y)


def _emulate_flat(b, rows, R, x):
    """Mirror of ``flat_spmv_kernel``: a window of R rows from the block's
    128-aligned base; rows of [row_first, row_last] go out."""
    a = {k: v.numpy() for k, v in b.items()}
    nb, K = a["vals"].shape
    y = np.zeros(rows, np.float32)
    seam = np.full(2 * nb, np.nan, np.float32)
    for blk in range(nb):
        n = a["atom_starts"][blk + 1] - a["atom_starts"][blk]
        if n == 0:
            continue
        win = np.zeros(R, np.float32)
        for k in range(n):
            r = a["rel"][blk, k]
            assert 0 <= r < R
            win[r] = np.float32(win[r] + a["vals"][blk, k]
                                * x[a["cols"][blk, k]])
        rf, rl = a["row_first"][blk], a["row_last"][blk]
        for j in range(R):
            row = a["s0"][blk] * 128 + j
            if rf <= row <= rl:
                _store(y, seam, blk, row, rf, rl, win[j])
    return _seam_pass(a["row_first"], a["row_last"], seam, y)


# ------------------------------------------------------------ K2 (flat v2)
@pytest.mark.parametrize("block", [8, 32])
@pytest.mark.parametrize("name", sorted(BATTERY))
def test_flat_v2_plain_matches_pallas(name, block):
    t, j, x = _inputs(name)
    tplan, jplan = _plans(j, block)
    jb, jfn = flat_spmv_pallas_v2(j, jplan, interpret=True)
    tb, tfn = spmv_flat_v2.flat_spmv_v2(t, tplan, device="cpu")
    y = tfn(tb, torch.from_numpy(x)).numpy()
    _agree(y, jfn(jb, x), j, x, f"K2/{name}/{block}")
    np.testing.assert_allclose(_emulate_flat_v2(tb, t.shape[0], x), y,
                               rtol=RTOL, atol=ATOL)


def test_flat_v2_emulated_chunks_and_long_rows():
    # a row longer than the kernel's 256-atom chunk and a block with more
    # than one chunk: the carry between chunks
    j = jgen.skewed_csr(30, 900, heavy_rows=2, heavy_nnz=700, seed=4)
    t = tf.csr_from_arrays(j.shape, j.offsets, j.indices, j.vals)
    x = jgen.make_input_vector(j.shape[1])
    tplan, jplan = _plans(j, 1024)
    tb, tfn = spmv_flat_v2.flat_spmv_v2(t, tplan, device="cpu")
    y = tfn(tb, torch.from_numpy(x)).numpy()
    _valid(_emulate_flat_v2(tb, t.shape[0], x), t, x, "emulated/long_rows")
    jb, jfn = flat_spmv_pallas_v2(j, jplan, interpret=True)
    # 700-atom rows: summation-order noise reaches ~1e-5 absolute, so the
    # battery tolerance of the repo applies here
    _agree(y, jfn(jb, x), j, x, "K2/long_rows", rtol=1e-4, atol=1e-3)


# --------------------------------------------------------------- K3 (flat)
@pytest.mark.parametrize("block", [8, 32])
@pytest.mark.parametrize("name", sorted(BATTERY))
def test_flat_plain_matches_pallas(name, block):
    t, j, x = _inputs(name)
    tplan, jplan = _plans(j, block)
    jb, jfn = flat_spmv_pallas(j, jplan, interpret=True)
    tb, tfn = spmv_flat.flat_spmv(t, tplan, device="cpu")
    y = tfn(tb, torch.from_numpy(x)).numpy()
    _agree(y, jfn(jb, x), j, x, f"K3/{name}/{block}")
    np.testing.assert_allclose(
        _emulate_flat(tb, t.shape[0], tfn.meta["R"], x), y,
        rtol=RTOL, atol=ATOL)


def test_flat_refuses_window_past_shared_memory():
    t = generate.wide_span_csr(spmv_flat.MAX_WINDOW + 1)
    plan = tp.make_plan(CsrLayout.from_csr(t), "work_oriented",
                        block_atoms=8)
    with pytest.raises(ValueError, match="shared-memory"):
        spmv_flat.flat_spmv(t, plan, device="cpu")
