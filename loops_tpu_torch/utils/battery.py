"""Synthetic sweep battery: the schedule heuristic study's corpus.

The port of ``loops_tpu/utils/battery.py``: the same recipes, name for
name, built with numpy on the port's ``COO``/``CSR``, so one name gives
the same CSR, array for array, in both packages. The battery spans the
regimes the schedules differ on:

  * structure: uniform random, power-law (zipf tails of varying alpha),
    banded, block-diagonal, diagonal, empty-row runs, few-heavy-rows
    skew, tall/wide rectangular, R-MAT and log-normal degree graphs;
  * scale: 2k-64k rows;
  * density: average degree 2-128.

Every matrix is a deterministic recipe (name -> build function), so sweep logs
can be re-joined with structural features without storing the matrices
(``tuning/fit.py`` refits ``choose_schedule``'s thresholds from the
logs). All recipes are vectorized, so the whole battery builds in
seconds.
"""
from __future__ import annotations

import numpy as np

from loops_tpu_torch.formats import COO, CSR

__all__ = ["battery", "build", "names"]


def _dedupe_coo(rows, cols, r, c, seed):
    rng = np.random.default_rng(seed)
    key = np.unique(r.astype(np.int64) * cols + c)
    r = (key // cols).astype(np.int64)
    c = (key % cols).astype(np.int64)
    v = rng.uniform(-1.0, 1.0, size=len(key)).astype(np.float32)
    return COO((rows, cols), r, c, v).to_csr()


def uniform(rows, cols, avg_deg, seed=0):
    rng = np.random.default_rng(seed)
    m = rows * avg_deg
    return _dedupe_coo(rows, cols, rng.integers(0, rows, m),
                       rng.integers(0, cols, m), seed + 1)


def powerlaw(rows, cols, avg_deg, alpha=1.0, seed=0):
    """Zipf-tail destination rows: row r draws ~ 1/(r+1)^alpha of the
    edge mass — the GNN-adjacency regime (hubs + long tail)."""
    rng = np.random.default_rng(seed)
    m = rows * avg_deg
    p = 1.0 / np.arange(1, rows + 1, dtype=np.float64) ** alpha
    p /= p.sum()
    r = rng.choice(rows, size=m, p=p)
    c = rng.integers(0, cols, m)
    return _dedupe_coo(rows, cols, r, c, seed + 1)


def banded(rows, cols, band, seed=0):
    r = np.repeat(np.arange(rows), 2 * band + 1)
    off = np.tile(np.arange(-band, band + 1), rows)
    c = r + off
    m = (c >= 0) & (c < cols)
    return _dedupe_coo(rows, cols, r[m], c[m], seed + 1)


def block_diag(nblocks, block, seed=0):
    n = nblocks * block
    b = np.repeat(np.arange(nblocks), block * block)
    r = b * block + np.tile(np.repeat(np.arange(block), block), nblocks)
    c = b * block + np.tile(np.tile(np.arange(block), block), nblocks)
    return _dedupe_coo(n, n, r, c, seed + 1)


def empty_runs(rows, cols, live_every, avg_deg, seed=0):
    """Only every ``live_every``-th row has nonzeros — long empty-row
    runs (the planner/binary-search edge case at scale)."""
    rng = np.random.default_rng(seed)
    live = np.arange(0, rows, live_every)
    m = len(live) * avg_deg
    r = rng.choice(live, size=m)
    c = rng.integers(0, cols, m)
    return _dedupe_coo(rows, cols, r, c, seed + 1)


def few_heavy(rows, cols, heavy_rows, heavy_deg, light_deg=2, seed=0):
    """A few rows carry most nonzeros (vectorized skewed_csr)."""
    rng = np.random.default_rng(seed)
    mh = heavy_rows * heavy_deg
    ml = (rows - heavy_rows) * light_deg
    r = np.concatenate([rng.integers(0, heavy_rows, mh),
                        rng.integers(heavy_rows, rows, ml)])
    c = rng.integers(0, cols, mh + ml)
    return _dedupe_coo(rows, cols, r, c, seed + 1)


def rmat(n, avg_deg, a=0.57, b=0.19, c=0.19, seed=0):
    """Stochastic-Kronecker (R-MAT) sampler — the Graph500 heavy-tail
    generator. Each edge picks one quadrant per bit level with
    probabilities [a, b, c, 1-a-b-c]; the classic (0.57, 0.19, 0.19)
    parameters give the hub-plus-fractal-tail structure real web/social
    SuiteSparse graphs show, which the zipf ``powerlaw`` family (smooth
    tail, uniform columns) does not. Fully vectorized: log2(n) rounds
    over all m edges."""
    rng = np.random.default_rng(seed)
    levels = int(np.log2(n))
    if 1 << levels != n:
        raise ValueError(f"rmat needs power-of-two n, got {n}")
    m = n * avg_deg
    r = np.zeros(m, np.int64)
    col = np.zeros(m, np.int64)
    pr = a + b          # P(top half for rows)
    pc_top = a / (a + b)      # P(left | top)
    pc_bot = c / max(1.0 - a - b, 1e-12)  # P(left | bottom)
    for _ in range(levels):
        u = rng.random(m)
        v = rng.random(m)
        top = u < pr
        left = v < np.where(top, pc_top, pc_bot)
        r = (r << 1) | (~top).astype(np.int64)
        col = (col << 1) | (~left).astype(np.int64)
    return _dedupe_coo(n, n, r, col, seed + 1)


def lognormal_config(n, avg_deg, sigma=1.5, seed=0):
    """Configuration-model graph with log-normal out-degrees — the
    degree-moment profile of many real SuiteSparse matrices (heavy but
    not zipf-straight tails; matches the mid-body mass the rmat family
    under-produces)."""
    rng = np.random.default_rng(seed)
    deg = rng.lognormal(mean=0.0, sigma=sigma, size=n)
    deg = np.maximum((deg / deg.mean() * avg_deg).astype(np.int64), 0)
    r = np.repeat(np.arange(n, dtype=np.int64), deg)
    c = rng.integers(0, n, len(r))
    return _dedupe_coo(n, n, r, c, seed + 1)


def diagonal(n, ndiags, seed=0):
    offs = np.unique(np.concatenate(
        [[0], np.random.default_rng(seed).integers(-n // 2, n // 2,
                                                   ndiags - 1)]))
    r = np.repeat(np.arange(n), len(offs))
    c = r + np.tile(offs, n)
    m = (c >= 0) & (c < n)
    return _dedupe_coo(n, n, r[m], c[m], seed + 1)


def battery(max_rows: int = 65536) -> dict:
    """name -> zero-argument build function of every battery matrix."""
    mats = {}

    def add(name, fn):
        mats[name] = fn

    sizes = [s for s in (2048, 8192, 32768) if s <= max_rows]
    for n in sizes:
        for d in (2, 8, 32, 128):
            for seed in (0, 1):
                add(f"uni_n{n}_d{d}_s{seed}",
                    lambda n=n, d=d, seed=seed: uniform(n, n, d,
                                                        seed=n + d + seed))
    for n in [s for s in (4096, 8192, 16384, 65536) if s <= max_rows]:
        for d in (4, 16, 64):
            for a in (0.8, 1.2, 1.6):
                add(f"pl_n{n}_d{d}_a{a}",
                    lambda n=n, d=d, a=a: powerlaw(n, n, d, a,
                                                   seed=n + d))
    for n in sizes:
        for b in (1, 4, 16, 64, 256):
            add(f"band_n{n}_b{b}",
                lambda n=n, b=b: banded(n, n, b, seed=b))
    for blk in (16, 64, 256):
        for nb in (32, 128):
            if nb * blk <= max_rows:
                add(f"bdiag_{nb}x{blk}",
                    lambda nb=nb, blk=blk: block_diag(nb, blk, seed=blk))
    for n in sizes:
        for ev in (2, 4, 16):
            add(f"empty_n{n}_e{ev}",
                lambda n=n, ev=ev: empty_runs(n, n, ev, 8, seed=ev))
    for n in [s for s in (4096, 16384) if s <= max_rows]:
        for hr in (1, 16, 256):
            for hd in (n // 8, n // 2):
                add(f"heavy_n{n}_r{hr}_k{hd}",
                    lambda n=n, hr=hr, hd=hd: few_heavy(n, n, hr, hd,
                                                        seed=hr))
    for n in sizes:
        for nd in (3, 17, 65):
            add(f"dia_n{n}_k{nd}",
                lambda n=n, nd=nd: diagonal(n, nd, seed=nd))
    # rectangular
    for (r, c) in ((32768, 2048), (2048, 32768), (16384, 4096)):
        if max(r, c) <= max_rows:
            add(f"rect_{r}x{c}",
                lambda r=r, c=c: uniform(r, c, 16, seed=r))
    # heavy-tail families approaching real SuiteSparse structure (the
    # reference's 4,831-matrix sweep is dominated by web/social/circuit
    # graphs with fractal hub tails; rmat is the standard surrogate,
    # lognormal covers the mid-body moments)
    for n in [s for s in (8192, 32768, 65536) if s <= max_rows]:
        for d in (8, 32):
            for tag, a in (("g500", 0.57), ("mild", 0.45)):
                for seed in (0, 1):
                    add(f"rmat_n{n}_d{d}_{tag}_s{seed}",
                        lambda n=n, d=d, a=a, seed=seed: rmat(
                            n, d, a=a, b=0.19, c=0.19,
                            seed=n + d + seed))
    for n in [s for s in (8192, 32768) if s <= max_rows]:
        for seed in (0, 1):
            add(f"rmat_n{n}_d128_g500_s{seed}",
                lambda n=n, seed=seed: rmat(n, 128, seed=n + seed))
    for n in [s for s in (8192, 32768) if s <= max_rows]:
        for d in (8, 32):
            for sg in (1.0, 2.0):
                add(f"lgn_n{n}_d{d}_s{sg}",
                    lambda n=n, d=d, sg=sg: lognormal_config(
                        n, d, sigma=sg, seed=n + d))
        add(f"lgn_n{n}_d16_s3.0",
            lambda n=n: lognormal_config(n, 16, sigma=3.0, seed=n))
    return mats


def names(max_rows: int = 65536):
    return sorted(battery(max_rows))


def build(name: str, max_rows: int = 65536) -> CSR:
    return battery(max_rows)[name]()
