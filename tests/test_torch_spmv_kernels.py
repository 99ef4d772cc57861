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


def _zero_unowned(y, row_first, row_last, blk, rows):
    """Mirror of ``zero_unowned_rows``: block ``blk`` zeroes the rows
    strictly inside its (row_first, row_last) (its runs are stored after
    it), the rows from its last up to the next block with atoms (to the
    end of y when there is none) and, block 0, those before the first
    block with atoms."""
    nb = len(row_first)

    def next_first(c):
        has = np.nonzero(row_first[c:] >= 0)[0]
        return row_first[c + has[0]] if len(has) else rows

    rf, rl = row_first[blk], row_last[blk]
    if rf >= 0:
        y[rf + 1:rl] = 0
        y[rl + 1:next_first(blk + 1)] = 0
    if blk == 0:
        y[:rf if rf >= 0 else next_first(1)] = 0


def _block_seg_scan(v, f, carry):
    """Mirror of ``loops_scan::block_seg_scan`` over one chunk, one
    (value, flag) pair per thread: the warp's shuffle scan in its order of
    steps, the warp aggregates folded in warp order from ``carry``.
    Returns each thread's value before it (the exclusive value) and the
    carry for the next chunk."""
    warps = len(v) // 32
    v = v.reshape(warps, 32).astype(np.float32)
    f = f.reshape(warps, 32).astype(bool)
    lane = np.arange(32)[None, :]
    d = 1
    while d < 32:
        pv = np.zeros_like(v)
        pf = np.zeros_like(f)
        pv[:, d:], pf[:, d:] = v[:, :-d], f[:, :-d]
        up = lane >= d
        v = np.where(up & ~f, pv + v, v).astype(np.float32)
        f = np.where(up, f | pf, f)
        d *= 2
    pre = np.float32(carry)
    warp_pre = np.zeros(warps, np.float32)
    for w in range(warps):
        warp_pre[w] = pre
        pre = v[w, 31] if f[w, 31] else np.float32(pre + v[w, 31])
    incl = np.where(f, v, warp_pre[:, None] + v).astype(np.float32)
    before = np.empty_like(incl)
    before[:, 1:] = incl[:, :-1]
    before[:, 0] = warp_pre
    return before.reshape(-1), pre


def _emulate_flat_v2(b, rows, x):
    """Mirror of ``flat_spmv_v2_kernel``: per chunk of ``CHUNK`` slots,
    each of ``THREADS`` threads folds its ``ITEMS`` consecutive slots' f32
    products (reset where keep == 0, and past the block's atoms); the
    block scan over the folds gives each thread the open run's value
    before its first slot; it folds again from there and stores each run
    end (the slot after it starts a run) to its row or the seam buffer.
    y starts at NaN, so a row the kernel leaves unwritten shows."""
    a = {k: v.numpy() for k, v in b.items()}
    nb, K = a["vals"].shape
    items, chunk = spmv_flat_v2.ITEMS, spmv_flat_v2.CHUNK
    y = np.full(rows, np.nan, np.float32)
    seam = np.full(2 * nb, np.nan, np.float32)
    for blk in range(nb):
        n = a["atom_starts"][blk + 1] - a["atom_starts"][blk]
        rf, rl = a["row_first"][blk], a["row_last"][blk]
        _zero_unowned(y, a["row_first"], a["row_last"], blk, rows)
        carry = np.float32(0)
        for c0 in range(0, n, chunk):
            k = c0 + np.arange(chunk).reshape(-1, items)  # [THREADS, ITEMS]
            inside = k < n
            kk = np.minimum(k, K - 1)
            p = np.where(inside, a["vals"][blk, kk] * x[a["cols"][blk, kk]],
                         np.float32(0)).astype(np.float32)
            reset = ~inside | (a["keep"][blk, kk] == 0)
            nxt = np.minimum(k + 1, K - 1)
            # the slot after a run's last starts a run, or lies past n
            end = inside & ((k + 1 >= n) | (a["keep"][blk, nxt] == 0))
            tail = np.zeros(chunk // items, np.float32)
            for i in range(items):
                tail = np.where(reset[:, i], p[:, i], tail + p[:, i])
            run, carry = _block_seg_scan(tail, reset.any(axis=1), carry)
            for i in range(items):
                run = np.where(reset[:, i], p[:, i], run + p[:, i])
                for t in np.nonzero(end[:, i])[0]:
                    row = a["tile_starts"][blk] + a["rel"][blk, k[t, i]]
                    _store(y, seam, blk, row, rf, rl, run[t])
    return _seam_pass(a["row_first"], a["row_last"], seam, y)


def _lane_sum(prod, g):
    """A lane group's sum: lane l adds prod[l], prod[l + g], ... in order,
    then the xor-shuffle tree."""
    part = np.zeros(g, np.float32)
    for lane in range(g):
        for v in prod[lane::g]:
            part[lane] = np.float32(part[lane] + v)
    o = g // 2
    while o:
        part = part + part[np.arange(g) ^ o]
        o //= 2
    return part[0]


def _emulate_flat(b, rows, params, x):
    """Mirror of ``flat_spmv_kernel``: per piece of ``params["piece"]``
    slots, the f32 products, runs cut where rel changes, each summed by
    a group of ``lanes_per_row`` lanes; the piece's last run is carried
    into the next (carry + its next part) and stored when it ends; rows
    go to ``s0*128 + rel``, the first and last through the seam buffer.
    y starts at NaN, so a row the kernel leaves unwritten shows."""
    a = {k: v.numpy() for k, v in b.items()}
    nb, K = a["vals"].shape
    piece, g = params["piece"], params["lanes_per_row"]
    y = np.full(rows, np.nan, np.float32)
    seam = np.full(2 * nb, np.nan, np.float32)
    for blk in range(nb):
        n = a["atom_starts"][blk + 1] - a["atom_starts"][blk]
        rf, rl = a["row_first"][blk], a["row_last"][blk]
        _zero_unowned(y, a["row_first"], a["row_last"], blk, rows)
        if n == 0:
            continue
        ybase = a["s0"][blk] * 128

        def store(r, v, blk=blk, rf=rf, rl=rl, ybase=ybase):
            _store(y, seam, blk, ybase + r, rf, rl, v)

        cv = cr = None
        for p0 in range(0, n, piece):
            pn = min(piece, n - p0)
            prod = (a["vals"][blk, p0:p0 + pn]
                    * x[a["cols"][blk, p0:p0 + pn]])
            assert prod.dtype == np.float32
            rels = a["rel"][blk, p0:p0 + pn]
            continued = p0 > 0 and rels[0] == cr
            starts = [0] + list(np.nonzero(rels[1:] != rels[:-1])[0] + 1)
            for j, lo in enumerate(starts):
                hi = starts[j + 1] if j + 1 < len(starts) else pn
                acc = _lane_sum(prod[lo:hi], g)
                if j == 0 and continued:
                    acc = np.float32(cv + acc)
                if j == len(starts) - 1:
                    nv, nr = acc, rels[lo]
                else:
                    store(rels[lo], acc)
            if p0 > 0 and not continued:
                store(cr, cv)
            cv, cr = nv, nr
        store(cr, cv)
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
    # rows of 700 atoms, over the slots of many threads: the block scan's
    # carry from thread to thread
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
        _emulate_flat(tb, t.shape[0], tfn.params, x), y,
        rtol=RTOL, atol=ATOL)


def test_flat_refuses_window_past_shared_memory():
    t = generate.wide_span_csr(spmv_flat.MAX_WINDOW + 1)
    plan = tp.make_plan(CsrLayout.from_csr(t), "work_oriented",
                        block_atoms=8)
    with pytest.raises(ValueError, match="shared-memory"):
        spmv_flat.flat_spmv(t, plan, device="cpu")


# ------------------------------------------- K2 and K3: the mirrors' cases
def _flat_case(kernel, t, plan, x):
    """The kernel's mirror and its plain version on one plan."""
    if kernel == "K2":
        tb, tfn = spmv_flat_v2.flat_spmv_v2(t, plan, device="cpu")
        emulated = _emulate_flat_v2(tb, t.shape[0], x)
    else:
        tb, tfn = spmv_flat.flat_spmv(t, plan, device="cpu")
        emulated = _emulate_flat(tb, t.shape[0], tfn.params, x)
    return emulated, tfn(tb, torch.from_numpy(x)).numpy(), tfn


@pytest.mark.parametrize("kernel", ["K2", "K3"])
@pytest.mark.parametrize("block", [8, 64])
@pytest.mark.parametrize("name", sorted(generate.SPMV_EDGE_CASES))
def test_flat_emulated_kernel_edge_cases(kernel, name, block):
    # empty rows between two blocks (blocks without atoms among them),
    # before the first and after the last, and rows over several blocks:
    # every row of the NaN-started y written
    t = generate.SPMV_EDGE_CASES[name]()
    x = jgen.make_input_vector(t.shape[1])
    plan = tp.make_plan(CsrLayout.from_csr(t), "merge_path", block_work=block)
    y, y_plain, _ = _flat_case(kernel, t, plan, x)
    assert not np.isnan(y).any(), f"{kernel}/{name}: a row left unwritten"
    np.testing.assert_allclose(y, y_plain, rtol=RTOL, atol=ATOL)
    _valid(y, t, x, f"emulated {kernel}/{name}/{block}")


LARGE_BLOCK_CASES = {
    # rows of ~18 atoms across thread (8 slots), chunk and piece (2048)
    # boundaries
    "random": lambda: jgen.random_csr(700, 600, 0.03, seed=5),
    # rows longer than a piece or a chunk, one over several
    "long_rows": lambda: jgen.skewed_csr(30, 6000, heavy_rows=2,
                                         heavy_nnz=5000, seed=6),
    # runs of one atom: one run a thread's slot, the widest scan
    "tridiag": lambda: jgen.tridiag_csr(3000),
}


@pytest.mark.parametrize("kernel", ["K2", "K3"])
@pytest.mark.parametrize("block", [4096, 8192])
@pytest.mark.parametrize("name", sorted(LARGE_BLOCK_CASES))
def test_flat_emulated_kernel_large_blocks(kernel, name, block):
    j = LARGE_BLOCK_CASES[name]()
    t = tf.csr_from_arrays(j.shape, j.offsets, j.indices, j.vals)
    x = jgen.make_input_vector(j.shape[1])
    plan = tp.make_plan(CsrLayout.from_csr(t), "merge_path", block_work=block)
    assert plan.block_atoms > spmv_flat.PIECE
    assert np.diff(plan.atom_starts).max() > spmv_flat_v2.CHUNK
    y, y_plain, tfn = _flat_case(kernel, t, plan, x)
    if kernel == "K3":
        assert tfn.params["piece"] == spmv_flat.PIECE
    assert not np.isnan(y).any()
    # rows of thousands of atoms: the battery's tolerance, as for
    # long_rows above
    tol = (dict(rtol=1e-4, atol=1e-3) if name == "long_rows"
           else dict(rtol=RTOL, atol=ATOL))
    np.testing.assert_allclose(y, y_plain, **tol)
    _valid(y, t, x, f"emulated {kernel}/{name}/{block}")


@pytest.mark.parametrize("kernel", ["K2", "K3"])
def test_flat_emulated_kernel_wide_window(kernel):
    # the work_oriented plan whose one block spans 40000 rows (a 157 KB
    # row window for K3): the block zeroes the rows between its two
    t = generate.wide_span_csr(40_000)
    x = jgen.make_input_vector(t.shape[1])
    plan = tp.make_plan(CsrLayout.from_csr(t), "work_oriented", block_atoms=8)
    y, y_plain, tfn = _flat_case(kernel, t, plan, x)
    if kernel == "K3":
        assert 48 * 1024 < 4 * tfn.meta["R"] <= 4 * spmv_flat.MAX_WINDOW
    assert not np.isnan(y).any()
    np.testing.assert_array_equal(y, y_plain)
    _valid(y, t, x, f"emulated {kernel}/wide")


@pytest.mark.parametrize("case,lanes", [
    # mean run length -> the power of two at or above it, at most 32
    ("tridiag", 4), ("random", 32), ("one_per_row", 1)])
def test_flat_lanes_per_run(case, lanes):
    t = {"tridiag": lambda: generate.sized_csr([3] * 200, 300, seed=1),
         "random": lambda: generate.sized_csr([40] * 50, 300, seed=2),
         "one_per_row": lambda: generate.sized_csr([1] * 90, 30, seed=3),
         }[case]()
    plan = tp.make_plan(CsrLayout.from_csr(t), "merge_path", block_work=64)
    assert spmv_flat.lanes_per_run(plan) == lanes


@pytest.mark.parametrize("kernel", ["K2", "K3"])
@pytest.mark.parametrize("key", ["vals", "cols", "rel", "row_last"])
def test_flat_check_staged_refuses(kernel, key):
    # the check a wrapper runs at bind, and at a call with other buffers
    t = BATTERY["random"]()
    t = tf.csr_from_arrays(t.shape, t.offsets, t.indices, t.vals)
    plan = tp.make_plan(CsrLayout.from_csr(t), "merge_path", block_work=32)
    mod = spmv_flat_v2 if kernel == "K2" else spmv_flat
    build = mod.flat_spmv_v2 if kernel == "K2" else mod.flat_spmv
    b, fn = build(t, plan, device="cpu")
    cpu = torch.device("cpu")
    mod.check_staged(b, fn.params, cpu)
    bad = {"vals": b["vals"].double(), "cols": b["cols"][:, :-1],
           "rel": b["rel"].long(), "row_last": b["row_last"].repeat(2)[::2]}
    with pytest.raises(ValueError, match=key):
        mod.check_staged({**b, key: bad[key]}, fn.params, cpu)
    with pytest.raises(ValueError, match="CUDA tensor"):
        (mod.flat_spmv_v2_cuda if kernel == "K2" else mod.flat_spmv_cuda)(
            b, torch.zeros(t.shape[1]), fn.params)
