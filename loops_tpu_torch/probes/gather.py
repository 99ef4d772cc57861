"""K15: the port of ``scripts/tpu_r3_gather_probe.py`` and
``scripts/tpu_r4_gather_probe.py``: what one gathered element or row costs
on the card, from shared memory, from L2 and from device memory. K4 and K5
pay this per nonzero.

- **P1** ``gather_axis0`` (``r3:37``): ``out[i, j] = src[idx[i, j], j]``,
  src [S, 128], S in {8, 64, 256, 1024}, N = 4,194,304 elements. src sits
  in shared memory where it fits (S <= 256: 128 KB); S = 1024 (512 KB)
  does not fit a CTA's 227 KB and is read from L2 (``__ldg``).
- **P2** ``gather_axis1`` (``r3:77``): ``out[i, j] = src[i, idx[i, j]]``, S
  in {8, 256}: a warp holds a row and gathers by shuffles.
- **P4, G0** (``r3:116``, ``r4:41``) were XLA on the TPU: library
  baselines here, timed only: ``torch.take`` at C = 32768, N = 4,194,304,
  and ``B[idx]`` at M = 169,343, F = 128, N = 2,097,152, f32 and bf16.
- **G1, G2** ``row_gather`` (``r4:56`` ``_dynload_run``): rows of a [S,
  128] slab gathered by idx and summed in groups of 8 (G1: ``out[g*8 + j]
  = sum_k0 slab[idx[g*K + k0 + j]]``, (S, K) in {(1024, 32), (4096, 128),
  (4096, 512)}) or materialized (G2, (4096, 64)); N = 2,097,152 rows, f32
  and bf16. The TPU's slabs (512 KB, 2 MB) do not fit shared memory, so
  three residencies run: shared memory (S = 256), L2 (the TPU's S) and
  device memory (the 169,343-row arxiv table, 86.7 MB in f32; 43.3 MB in
  bf16, which the 50 MB L2 may partly hold). G2 is exact; G1 runs on
  integer-valued slabs, where its f32 sums are exact.
- **G3** ``onehot_expand`` (``r4:121``): ``OH[Kc, W] @ win[W, 128]`` with a
  bf16 one-hot on the tensor cores, W in {128, 512, 2048}, Kc = 1024, N =
  2,097,152 rows; exact against the bf16-rounded window rows. Printed with
  the operations model at 989 TFLOP/s (the script used the v5e's rate).

Library calls (timed only): ``torch.take_along_dim`` (P1),
``torch.gather`` (P2), ``torch.nn.functional.embedding_bag(mode="sum")``
over ``idx`` reordered into bags of K/8 outside the timing (G1),
``torch.index_select`` (G2, G3).
"""
from __future__ import annotations

import numpy as np
import torch

from loops_tpu_torch.ops.kernels import _build
from loops_tpu_torch.probes.common import hold, launch_ms, launch_twice, record
from loops_tpu_torch.utils.platform import ensure_platform

LANES = 128
N_ELEMS = 4_194_304           # r3: P1, P2, P4
N_ROWS = 2_097_152            # r4: G0-G3
P1_S, P2_S = (8, 64, 256, 1024), (8, 256)
P4_C = 32768
ARXIV_ROWS = 169_343
HBM_ROWS = 2_097_152          # 1.07 GB f32: the device-memory table
G1_CASES = ((1024, 32), (4096, 128), (4096, 512))
G2_CASE = (4096, 64)
SMEM_ROWS = 256
G3_W, G3_KC = (128, 512, 2048), 1024
SMEM_BYTES = 227 * 1024       # a CTA's shared memory on an H100
L2_BYTES = 50 * 2**20         # the H100's L2
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
BF16_PEAK = 989e12


def _sms(dev) -> int:
    return _build.sm_count(dev)


def residency(rows: int, element_size: int) -> str:
    """Where a [rows, 128] table is read from: ``smem`` when a CTA can
    stage it, ``hbm`` past four times the L2 (at most a quarter of random
    rows can hit there), ``l2`` between."""
    nbytes = rows * LANES * element_size
    if nbytes <= SMEM_BYTES:
        return "smem"
    return "l2" if nbytes <= 4 * L2_BYTES else "hbm"


# ------------------------------------------------------------------- P1
def axis0_inputs(S: int, n: int = N_ELEMS):
    """r3 ``probe_axis0``: ``default_rng(0)``; src [S, 128] normal, idx
    [tiles * S, 128] in [0, S), tiles = max(n // (S * 128), 1)."""
    tiles = max(n // (S * LANES), 1)
    rng = np.random.default_rng(0)
    src = rng.normal(size=(S, LANES)).astype(np.float32)
    idx = rng.integers(0, S, size=(tiles * S, LANES)).astype(np.int32)
    return src, idx


def gather_axis0_cuda(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    dev = src.device
    if dev.type != "cuda":
        raise ValueError(f"gather_axis0_cuda needs a CUDA tensor, got {dev}")
    S = src.shape[0]
    if src.dim() != 2 or src.shape[1] != LANES or idx.dim() != 2 \
            or idx.shape[1] != LANES:
        raise ValueError("gather_axis0: src [S, 128] and idx [n, 128]")
    _build.check(src, "src", torch.float32, dev)
    _build.check(idx, "idx", torch.int32, dev)
    out = torch.empty(idx.shape, dtype=torch.float32, device=dev)
    smem = residency(S, 4) == "smem"
    per_sm = max(1, SMEM_BYTES // (S * LANES * 4)) if smem else 8
    _build.launch("loops_gather_axis0", "gather_axis0", dev, src, idx, out, S,
                  idx.numel() // 4, int(smem), min(8, per_sm) * _sms(dev))
    return out


def gather_axis0_plain(src, idx):
    return src[idx.long(), torch.arange(LANES, device=src.device)]


def gather_axis0(src, idx):
    if src.device.type == "cpu":
        return gather_axis0_plain(src, idx)
    return gather_axis0_cuda(src, idx)


# ------------------------------------------------------------------- P2
def axis1_inputs(S: int, n: int = N_ELEMS):
    """r3 ``probe_axis1``: src [tiles * S, 128] normal, idx in [0, 128)."""
    tiles = max(n // (S * LANES), 1)
    rng = np.random.default_rng(0)
    src = rng.normal(size=(tiles * S, LANES)).astype(np.float32)
    idx = rng.integers(0, LANES, size=(tiles * S, LANES)).astype(np.int32)
    return src, idx


def gather_axis1_cuda(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    dev = src.device
    if dev.type != "cuda":
        raise ValueError(f"gather_axis1_cuda needs a CUDA tensor, got {dev}")
    if src.dim() != 2 or src.shape[1] != LANES:
        raise ValueError("gather_axis1: src [rows, 128]")
    _build.check(src, "src", torch.float32, dev)
    _build.check(idx, "idx", torch.int32, dev, src.numel())
    out = torch.empty_like(src)
    rows = src.shape[0]
    blocks = max(1, min(-(-rows // 8), 8 * _sms(dev)))
    _build.launch("loops_gather_axis1", "gather_axis1", dev, src, idx, out,
                  rows, blocks)
    return out


def gather_axis1_plain(src, idx):
    return src[torch.arange(src.shape[0], device=src.device)[:, None],
               idx.long()]


def gather_axis1(src, idx):
    if src.device.type == "cpu":
        return gather_axis1_plain(src, idx)
    return gather_axis1_cuda(src, idx)


# --------------------------------------------------------------- G1, G2
def row_gather_inputs(S: int, K: int, n: int = N_ROWS, integer: bool = False):
    """r4 ``_dynload_run``: ``default_rng(0)``; slab [S, 128] normal (or
    integers in [-8, 8]), idx [n // K * K] in [0, S)."""
    rng = np.random.default_rng(0)
    slab = rng.normal(size=(S, LANES)).astype(np.float32)
    idx = rng.integers(0, S, size=(n // K * K,)).astype(np.int32)
    if integer:
        slab = np.rint(slab * 3).astype(np.float32)
    return slab, idx


def row_gather_tensors(S: int, K: int, n: int, integer: bool, device):
    """``row_gather_inputs`` on ``device``. A table past the arxiv one is
    drawn there instead (``torch.Generator`` seeded 0): numpy would take
    seconds over its 268M values."""
    if S <= ARXIV_ROWS:
        return tuple(torch.from_numpy(a).to(device)
                     for a in row_gather_inputs(S, K, n, integer))
    g = torch.Generator(device).manual_seed(0)
    slab = torch.randn(S, LANES, generator=g, device=device)
    if integer:
        slab = torch.round(slab * 3)
    idx = torch.randint(0, S, (n // K * K,), generator=g, device=device,
                        dtype=torch.int32)
    return slab, idx


def row_gather_cuda(slab: torch.Tensor, idx: torch.Tensor, K: int,
                    materialize: bool) -> torch.Tensor:
    """G1 (sums, [n/K*8, 128] f32) or G2 (rows, [n, 128] in the slab's
    type); slab f32 or bf16 [S, 128], idx int32 [n], n % K == 0."""
    dev = slab.device
    if dev.type != "cuda":
        raise ValueError(f"row_gather_cuda needs a CUDA tensor, got {dev}")
    if slab.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"slab has dtype {slab.dtype}, expected float32 or "
                         "bfloat16")
    S, n = slab.shape[0], idx.numel()
    if slab.dim() != 2 or slab.shape[1] != LANES or K % 8 or n % K:
        raise ValueError(f"row_gather: slab [S, 128], K % 8 == 0 and n % K "
                         f"== 0, got {tuple(slab.shape)}, K={K}, n={n}")
    _build.check(slab, "slab", slab.dtype, dev)
    _build.check(idx, "idx", torch.int32, dev)
    es = slab.element_size()
    where = residency(S, es)
    bytes_ = S * LANES * es
    per_sm = max(1, min(8, SMEM_BYTES // bytes_)) if where == "smem" else 8
    if materialize:
        out = torch.empty(n, LANES, dtype=slab.dtype, device=dev)
    else:
        out = torch.empty(n // K * 8, LANES, dtype=torch.float32, device=dev)
    _build.launch("loops_row_gather",
                  f"row_gather_{'mat' if materialize else 'sum'}_{where}", dev,
                  slab, idx, out, S, K, n, int(slab.dtype == torch.bfloat16),
                  int(where == "smem"), int(not materialize),
                  per_sm * _sms(dev))
    return out


def row_gather_bags(idx: torch.Tensor, K: int) -> torch.Tensor:
    """G1's groups as bags: row ``g*8 + j`` of the result lists
    ``idx[g*K + k0*8 + j]`` for k0 in order, [n / K * 8, K / 8] int64 (the
    index ``embedding_bag`` takes for G1's sums)."""
    n = idx.numel()
    return idx.long().reshape(n // K, K // 8, 8).transpose(1, 2).reshape(
        -1, K // 8)


def row_gather_plain(slab, idx, K, materialize):
    rows = slab[idx.long()]
    if materialize:
        return rows
    n = idx.numel()
    # [g, k0 / 8, j, 128] summed over k0 in order
    parts = rows.float().reshape(n // K, K // 8, 8, LANES)
    acc = torch.zeros_like(parts[:, 0])
    for k in range(K // 8):
        acc += parts[:, k]
    return acc.reshape(-1, LANES)


def row_gather(slab, idx, K, materialize):
    if slab.device.type == "cpu":
        return row_gather_plain(slab, idx, K, materialize)
    return row_gather_cuda(slab, idx, K, materialize)


# ------------------------------------------------------------------- G3
def onehot_inputs(W: int, Kc: int = G3_KC, n: int = N_ROWS):
    """r4 ``g3_onehot_expand``: ``default_rng(0)``; win [W, 128] normal;
    idx [nblocks * 8, Kc], each block's row repeated 8 times."""
    nblocks = n // Kc
    rng = np.random.default_rng(0)
    win = rng.normal(size=(W, LANES)).astype(np.float32)
    idx = np.repeat(rng.integers(0, W, size=(nblocks, 1, Kc)).astype(np.int32),
                    8, axis=1).reshape(nblocks * 8, Kc)
    return win, idx


def onehot_expand_cuda(win: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``OH @ bf16(win)`` per block of Kc rows: [nblocks * Kc, 128] f32."""
    dev = win.device
    if dev.type != "cuda":
        raise ValueError(f"onehot_expand_cuda needs a CUDA tensor, got {dev}")
    W = win.shape[0]
    if win.dim() != 2 or win.shape[1] != LANES or W % 64 or idx.dim() != 2 \
            or idx.shape[0] % 8 or idx.shape[1] % 128:
        raise ValueError(f"onehot_expand: win [W, 128] with W % 64 == 0 and "
                         f"idx [nblocks * 8, Kc] with Kc % 128 == 0, got "
                         f"{tuple(win.shape)}, {tuple(idx.shape)}")
    _build.check(win, "win", torch.float32, dev)
    _build.check(idx, "idx", torch.int32, dev)
    Kc = idx.shape[1]
    rows = idx.shape[0] // 8 * Kc
    wb = win.to(torch.bfloat16)
    out = torch.empty(rows, LANES, dtype=torch.float32, device=dev)
    _build.launch("loops_onehot_expand", "onehot_expand", dev, wb, idx, out,
                  W, Kc, rows)
    return out


def onehot_rows(idx: torch.Tensor) -> torch.Tensor:
    """The window row of every output row: each block's first idx row."""
    return idx[::8].reshape(-1)


def onehot_expand_plain(win, idx):
    return win.to(torch.bfloat16).float()[onehot_rows(idx).long()]


def onehot_expand(win, idx):
    if win.device.type == "cpu":
        return onehot_expand_plain(win, idx)
    return onehot_expand_cuda(win, idx)


# ----------------------------------------------------------------- probes
# Each probe holds its kernel to the plain version (two launches bitwise
# equal) and, when ``timed``, times the kernel, the plain version and the
# library call by slope.
def _times(kernel, plain, library, device, timed):
    if not timed:
        return None, None, None
    return tuple(None if fn is None else launch_ms(fn, device)
                 for fn in (kernel, plain, library))


def probe_axis0(S, device, out=print, timed=True, n=N_ELEMS) -> dict:
    src, idx = (torch.from_numpy(a).to(device) for a in axis0_inputs(S, n))
    got = launch_twice(lambda: gather_axis0(src, idx))
    err = hold(f"P1 S={S}", got, gather_axis0_plain(src, idx))
    N = idx.numel()
    il = idx.long()
    ms, plain_ms, lib_ms = _times(
        lambda: gather_axis0(src, idx), lambda: gather_axis0_plain(src, idx),
        lambda: torch.take_along_dim(src, il, dim=0), device, timed)
    where = residency(S, 4)
    line = (f"P1 axis0 S={S:5d} ({where}) N={N / 1e6:.2f}M: "
            + (f"{ms:7.3f} ms = {ms * 1e6 / N:6.3f} ns/elem  " if timed
               else "") + "exact=True")
    out(line)
    return record("gather_axis0", f"S={S}", ms, plain_ms, lib_ms,
                  4 * src.numel() + 8 * N, 0, "f32", err, line)


def probe_axis1(S, device, out=print, timed=True, n=N_ELEMS) -> dict:
    src, idx = (torch.from_numpy(a).to(device) for a in axis1_inputs(S, n))
    got = launch_twice(lambda: gather_axis1(src, idx))
    err = hold(f"P2 S={S}", got, gather_axis1_plain(src, idx))
    N = idx.numel()
    il = idx.long()
    ms, plain_ms, lib_ms = _times(
        lambda: gather_axis1(src, idx), lambda: gather_axis1_plain(src, idx),
        lambda: torch.gather(src, 1, il), device, timed)
    line = (f"P2 axis1 S={S:5d} N={N / 1e6:.2f}M: "
            + (f"{ms:7.3f} ms = {ms * 1e6 / N:6.3f} ns/elem  " if timed
               else "") + "exact=True")
    out(line)
    return record("gather_axis1", f"S={S}", ms, plain_ms, lib_ms, 12 * N, 0,
                  "f32", err, line)


def probe_rows(S, K, dtype, materialize, device, out=print, timed=True,
               n=N_ROWS) -> dict:
    slab, idx = row_gather_tensors(S, K, n, not materialize, device)
    slab = slab.to(DTYPES[dtype])
    tag = "G2 dyn-mat" if materialize else "G1 dyn-sum"
    got = launch_twice(lambda: row_gather(slab, idx, K, materialize))
    err = hold(f"{tag} S={S} K={K} {dtype}", got,
               row_gather_plain(slab, idx, K, materialize))
    N = idx.numel()
    il = idx.long()
    bags = None if materialize else row_gather_bags(idx, K)
    ms, plain_ms, lib_ms = _times(
        lambda: row_gather(slab, idx, K, materialize),
        lambda: row_gather_plain(slab, idx, K, materialize),
        (lambda: torch.index_select(slab, 0, il)) if materialize
        else (lambda: torch.nn.functional.embedding_bag(bags, slab,
                                                        mode="sum")),
        device, timed)
    es = slab.element_size()
    where = residency(S, es)
    mb = S * LANES * es / 1e6
    line = (f"{tag} slab[{S}x128] {dtype} ({where}, {mb:.1f} MB) K={K} "
            f"N={N / 1e6:.2f}M: "
            + (f"{ms:8.3f} ms = {ms * 1e6 / N:6.3f} ns/row = "
               f"{N * LANES * es / ms / 1e6:7.1f} GB/s of rows  " if timed
               else "") + "exact=True")
    out(line)
    nbytes = S * LANES * es + 4 * N + (N * LANES * es if materialize
                                       else 4 * got.numel())
    flops = 0 if materialize else N * LANES
    name = f"row_gather_{'mat' if materialize else 'sum'}_{where}"
    return record(name, f"S={S} K={K} {dtype}", ms, plain_ms, lib_ms, nbytes,
                  flops, "f32", err, line)


def probe_onehot(W, device, out=print, timed=True, n=N_ROWS) -> dict:
    win, idx = (torch.from_numpy(a).to(device) for a in onehot_inputs(W, n=n))
    got = launch_twice(lambda: onehot_expand(win, idx))
    err = hold(f"G3 W={W}", got, onehot_expand_plain(win, idx))
    N = got.shape[0]
    wr, rl = win.to(torch.bfloat16).float(), onehot_rows(idx).long()
    ms, plain_ms, lib_ms = _times(
        lambda: onehot_expand(win, idx), lambda: onehot_expand_plain(win, idx),
        lambda: torch.index_select(wr, 0, rl), device, timed)
    flops = 2 * N * W * LANES
    model = 2 * W * LANES / BF16_PEAK * 1e9
    line = (f"G3 oh   W={W:5d} Kc={G3_KC} N={N / 1e6:.2f}M: "
            + (f"{ms:8.3f} ms = {ms * 1e6 / N:6.3f} ns/row " if timed
               else "")
            + f"(ops-model {model:.3f} ns/row at 989 TFLOP/s)  ok=True")
    out(line)
    nbytes = 2 * W * LANES + 4 * (N // G3_KC) * 8 * G3_KC + 4 * N * LANES
    return record("onehot_expand", f"W={W}", ms, plain_ms, lib_ms, nbytes,
                  flops, "bf16", err, line)


def library_baselines(device, out=print, n_elems=N_ELEMS, n_rows=N_ROWS,
                      table_rows=ARXIV_ROWS) -> dict:
    """P4 and G0, timed only: ``torch.take`` and ``B[idx]``."""
    res = {}
    rng = np.random.default_rng(0)
    src = torch.from_numpy(rng.normal(size=P4_C).astype(np.float32)).to(
        device)
    idx = torch.from_numpy(rng.integers(0, P4_C, size=n_elems)).to(device)
    ms = launch_ms(lambda: torch.take(src, idx), device)
    out(f"P4 torch.take C={P4_C} N={n_elems / 1e6:.2f}M: {ms:7.3f} ms = "
        f"{ms * 1e6 / n_elems:6.3f} ns/elem")
    res["P4 take"] = ms
    for dt in DTYPES:
        rng = np.random.default_rng(0)
        B = torch.from_numpy(rng.normal(size=(table_rows, LANES)).astype(
            np.float32)).to(device).to(DTYPES[dt])
        ri = torch.from_numpy(rng.integers(0, table_rows, size=n_rows)).to(
            device)
        ms = launch_ms(lambda: B[ri], device)
        out(f"G0 torch B[{table_rows}x{LANES}] {dt:4s} N={n_rows / 1e6:.2f}M: "
            f"{ms:8.3f} ms = {ms * 1e6 / n_rows:6.3f} ns/row")
        res[f"G0 {dt}"] = ms
        del B, ri
    return res


def run(device="cuda", quick: bool = False, out=print, timed=True
        ) -> list:
    """Every K15 probe at the scripts' sizes (``quick``: 1/256 of the
    elements and rows, tables of 16384 and 65536 rows in place of the
    arxiv and the device-memory ones); returns the kernels' records."""
    device = ensure_platform(device)
    d = 256 if quick else 1
    ne, nr = N_ELEMS // d, N_ROWS // d
    tables = (16384, 65536) if quick else (ARXIV_ROWS, HBM_ROWS)
    recs = [probe_axis0(S, device, out, timed, ne) for S in P1_S]
    recs += [probe_axis1(S, device, out, timed, ne) for S in P2_S]
    for dt in DTYPES:
        for S_tpu, K in (*G1_CASES, G2_CASE):
            for S in (SMEM_ROWS, S_tpu, *tables):
                recs.append(probe_rows(S, K, dt, (S_tpu, K) == G2_CASE,
                                       device, out, timed, nr))
    recs += [probe_onehot(W, device, out, timed, nr) for W in G3_W]
    if timed:
        library_baselines(device, out, ne, nr, tables[0])
    return recs
