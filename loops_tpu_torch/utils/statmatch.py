"""Size- and structure-matched replicas of the SuiteSparse sweep
population: the port of ``loops_tpu/utils/statmatch.py``.

The reference's performance evidence is 4,831 real SuiteSparse matrices
(reference: plots/data/heuristics.csv; scripts/run.sh:15-30). Neither
they nor that CSV are in this repository. What the repository does hold
are the logs of ``loops_tpu``'s stat-matched sweeps,
``plots/data/statmatched/*.csv`` (250 matrices, sample seed 0) and
``plots/data/statmatched_rep/*.csv`` (80 matrices, seed 1): each row
``kernel,dataset,rows,cols,nnzs,elapsed`` names one sampled matrix
``sm_<name>`` with its exact (rows, cols, nnz), and each directory's
``statmatch_info.json`` records the sample (eligible fraction, family of
each replica). ``load_population`` reads the matrices from those rows, so
the port rebuilds the same samples without the 4,831-row CSV, and
``statmatched_battery`` copies ``info`` from the JSON file (its eligible
counts need the full population, which the port cannot recompute).

Each replica has the matrix's exact dimensions and nnz and a *structure
prior* keyed on SuiteSparse naming conventions (bus/shell/elt/... are
FEM meshes -> banded; soc-/web-/cit-/as-/com- are scale-free networks ->
power-law; rajat/dcop/fpga/circuit are circuit matrices -> heavy-tailed
lognormal; lp_ are rectangular LP bases -> uniform rectangular);
matrices no keyword matches fall back to a density/aspect rule. This is
a size+prior match, NOT real data. ``_KEYWORDS``, ``family_of``,
``_name_seed``, ``_exact_unique_coo`` and ``replica`` are ``loops_tpu``'s
unchanged, so one name and seed give the same CSR in both packages.

The over-cap tier: ``loops_tpu`` sampled only matrices under 4M nnz and
1M rows (93.11% of the population, ``eligible_frac``); 80 GB of device
memory holds the rest. ``xl_battery`` adds synthetic square replicas of
each family at 16M and 64M nnz, average degree 16, named
``xl_<family>_<nnz>``: labelled synthetic, never by a SuiteSparse name.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np

from loops_tpu_torch.formats import CSR

__all__ = ["FAMILIES", "RefMatrix", "SyntheticMatrix", "family_of",
           "load_population", "replica", "statmatched_battery",
           "build_replica_by_name", "xl_battery", "xl_replica", "LOG_DIR",
           "REP_LOG_DIR"]

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# the logs of loops_tpu's two stat-matched sweeps, and the sample seed
# each was drawn and built with
LOG_DIR = os.path.join(_REPO, "plots", "data", "statmatched")
REP_LOG_DIR = os.path.join(_REPO, "plots", "data", "statmatched_rep")
SAMPLE_SEEDS = {LOG_DIR: 0, REP_LOG_DIR: 1}

# the over-cap tier: nnz of each synthetic replica, and its degree
XL_NNZ = (1 << 24, 1 << 26)
XL_DEGREE = 16

# keyword -> structure family, first match wins (lowercased substring)
_KEYWORDS = (
    # scale-free networks: social / web / citation / autonomous systems
    ("powerlaw", ("soc", "web-", "wiki", "com-", "cit-", "ca-", "as-",
                  "email", "p2p", "amazon", "youtube", "flickr",
                  "hollywood", "ljournal", "twitter", "graph500", "kron",
                  "uk-200", "arabic", "indochina", "dblp", "patents",
                  "roadnet", "astro", "cond-mat", "hep", "pgp", "gnutella",
                  "slashdot", "epinions", "orkut", "friendster")),
    # circuits & device simulation: hub rows, heavy tails
    ("lognormal", ("rajat", "dcop", "adder", "fpga", "bips", "case39",
                   "zeros", "hcircuit", "scircuit", "memplus", "coupled",
                   "onetone", "twotone", "ckt", "asic", "freescale",
                   "circuit", "trans4", "trans5", "dc1", "dc2", "dc3",
                   "ibm_matrix", "barrier", "igbt", "bjtcai", "highk",
                   "mosfet", "power", "init_adder")),
    # finite-element / structural / PDE meshes: banded after ordering
    ("banded", ("bus", "shell", "cavity", "cube", "sphere", "tube", "elt",
                "mesh", "bcsstk", "bcsstm", "crystk", "ct20", "pwtk",
                "ship", "hood", "benelechi", "af_", "audik", "bone",
                "emilia", "fault", "flan", "geo_", "hook", "ml_",
                "msdoor", "nasa", "olafu", "raefsky", "s3dkq", "dubcova",
                "ecology", "thermal", "apache", "parabolic", "g3_circuit",
                "offshore", "tmt_", "t2d", "t3d", "venkat", "wang", "2d_",
                "3d_", "dtube", "plat", "gridgena", "wathen", "nos",
                "delaunay", "rgg_", "hugetrace", "road", "nd3k", "nd6k",
                "nd12k", "nd24k", "pkustk", "oilpan", "vanbody", "x104",
                "cant", "consph", "cop20k", "mac_econ", "mc2depi",
                "pdb1hys", "rma10", "abacus", "spectralwave")),
    # linear programming: rectangular, near-uniform columns
    ("uniform", ("lp_", "lpi_", "ken-", "pds-", "cre-", "osa-", "nug",
                 "dfl", "qap", "rail", "stat96", "watson", "karted",
                 "degme", "tp-6", "stormg2", "cont11", "neos", "sgpf")),
)

FAMILIES = ("banded", "powerlaw", "lognormal", "uniform")


@dataclass(frozen=True)
class RefMatrix:
    name: str
    rows: int
    cols: int
    nnz: int

    @property
    def family(self) -> str:
        return family_of(self.name, self.rows, self.cols, self.nnz)


def family_of(name: str, rows: int, cols: int, nnz: int) -> str:
    low = name.lower()
    for fam, keys in _KEYWORDS:
        if any(k in low for k in keys):
            return fam
    # fallback: density/aspect rule
    if rows != cols:
        return "uniform"
    avg = nnz / max(rows, 1)
    if avg <= 3.0:
        return "banded"
    if nnz / (float(rows) * cols) > 0.02:
        return "uniform"
    # deterministic mix for the rest (hash of the name): meshes dominate
    # the unlabeled SuiteSparse middle, heavy tails are next
    h = sum(name.encode()) % 10
    return ("banded" if h < 4 else
            "lognormal" if h < 7 else
            "powerlaw" if h < 9 else "uniform")


@dataclass(frozen=True)
class SyntheticMatrix:
    """A replica target whose family is given, not read from its name."""
    name: str
    rows: int
    cols: int
    nnz: int
    family: str


def load_population(log_dir: str = LOG_DIR) -> list[RefMatrix]:
    """The sampled matrices named by the ``sm_<name>`` rows of the sweep
    logs (``*.csv``) in ``log_dir``, sorted by name; ``TIMEOUT,<name>``
    markers and rows of other populations are skipped."""
    found = {}
    for fname in sorted(os.listdir(log_dir)):
        if not fname.endswith(".csv"):
            continue
        with open(os.path.join(log_dir, fname)) as f:
            for line in f:
                parts = line.strip().split(",")
                if len(parts) < 5 or not parts[1].startswith("sm_"):
                    continue
                try:
                    dims = tuple(int(p) for p in parts[2:5])
                except ValueError:
                    continue  # a header or another artifact's row
                found.setdefault(parts[1][3:], dims)
    return [RefMatrix(n, *found[n]) for n in sorted(found)]


def _name_seed(name: str, seed: int = 0) -> int:
    import zlib
    return (zlib.crc32(name.encode()) ^ seed) & 0x7FFFFFFF


def build_replica_by_name(nm: str, seed: int = 0, log_dir: str = LOG_DIR):
    """Rebuild the replica for an ``sm_<dataset>`` sweep name (from the
    population of ``log_dir``) or an ``xl_<family>_<nnz>`` one: the
    deterministic-recipe contract the synthetic battery has
    (``utils/battery.build``)."""
    if nm.startswith("xl_"):
        mats, _ = xl_battery(seed)
        if nm in mats:
            return mats[nm]()
        raise KeyError(nm)
    if not nm.startswith("sm_"):
        raise KeyError(nm)
    target = nm[3:]
    for m in load_population(log_dir):
        if m.name == target:
            return replica(m, _name_seed(target, seed))
    raise KeyError(nm)


# ---------------------------------------------------------------- coo
def _exact_unique_coo(draw, n_target: int, seed: int, max_iter: int = 64):
    """Draw batches of (r, c) until n_target unique pairs exist, then
    keep exactly n_target (uniform thinning preserves the marginal)."""
    rng = np.random.default_rng(seed)
    rs = np.empty(0, np.int64)
    cs = np.empty(0, np.int64)
    need = n_target
    for _ in range(max_iter):
        r, c = draw(rng, int(need * 1.3) + 16)
        rs = np.concatenate([rs, r])
        cs = np.concatenate([cs, c])
        key = rs * (cs.max() + 1 if len(cs) else 1) + cs
        _, idx = np.unique(key, return_index=True)
        if len(idx) >= n_target:
            idx = np.sort(rng.permutation(idx)[:n_target])
            return rs[idx], cs[idx]
        need = n_target - len(idx)
    # pathological (target close to the full support): return what we have
    key = rs * (cs.max() + 1 if len(cs) else 1) + cs
    _, idx = np.unique(key, return_index=True)
    return rs[idx], cs[idx]


def _coo_to_csr(rows_i, cols_i, shape, seed) -> CSR:
    order = np.lexsort((cols_i, rows_i))
    rows_i, cols_i = rows_i[order], cols_i[order]
    offs = np.searchsorted(rows_i, np.arange(shape[0] + 1)).astype(np.int64)
    vals = np.random.default_rng(seed + 7).uniform(
        -1, 1, len(rows_i)).astype(np.float32)
    return CSR(shape, offs, cols_i.astype(np.int64), vals)


def replica(m: RefMatrix, seed: int = 0) -> CSR:
    """Generate the (rows, cols, nnz)-matched replica under m's family
    prior. nnz is matched exactly unless the target exceeds ~the
    family's support (then best-effort, recorded by the caller)."""
    fam = m.family
    R, C, N = m.rows, m.cols, m.nnz
    N = min(N, R * C)

    # dense-support shortcut: at fill > 30% (RHS-vector "_b" matrices,
    # tiny dense blocks) rejection sampling degenerates into coupon
    # collecting; sample cells without replacement instead (structure
    # is immaterial at that density)
    if R * C <= 1 << 24 and N > 0.3 * R * C:
        rngd = np.random.default_rng(seed)
        flat = rngd.permutation(R * C)[:N]
        return _coo_to_csr(flat // C, flat % C, (R, C), seed)

    if fam == "banded":
        halfw = max(int(np.ceil(N / max(R, 1) / 2)), 1)

        def draw(rng, k):
            r = rng.integers(0, R, k)
            c = r * C // R + rng.integers(-halfw, halfw + 1, k)
            return r, np.clip(c, 0, C - 1)
    elif fam == "powerlaw":
        ranks = np.arange(1, C + 1, dtype=np.float64)
        p = 1.0 / ranks
        p /= p.sum()
        cdf = np.cumsum(p)

        def draw(rng, k):
            r = rng.integers(0, R, k)
            c = np.searchsorted(cdf, rng.random(k))
            return r, np.minimum(c, C - 1)
    elif fam == "lognormal":
        # heavy-tailed row degrees (circuit hubs): rows weighted by a
        # lognormal, columns near-uniform
        rngw = np.random.default_rng(seed + 3)
        w = rngw.lognormal(0.0, 1.5, R)
        w /= w.sum()
        cdf = np.cumsum(w)

        def draw(rng, k):
            r = np.searchsorted(cdf, rng.random(k))
            return np.minimum(r, R - 1), rng.integers(0, C, k)
    else:  # uniform
        def draw(rng, k):
            return rng.integers(0, R, k), rng.integers(0, C, k)

    rr, cc = _exact_unique_coo(draw, N, seed)
    return _coo_to_csr(rr, cc, (R, C), seed)


def statmatched_battery(log_dir: str = LOG_DIR, seed: int | None = None):
    """name -> build function (sweep-compatible), and the sample's info.

    Returns ``(mats, info)``: an ``sm_<name>`` build function for every
    matrix the logs of ``log_dir`` name, each seeded by its name and
    ``seed`` (by default the seed that directory's sample was built
    with), and ``info`` as its ``statmatch_info.json`` records it.
    """
    if seed is None:
        seed = SAMPLE_SEEDS.get(os.path.abspath(log_dir), 0)
    mats = {}
    for m in load_population(log_dir):
        # seed keyed on the NAME (not the sample position) so a single
        # replica can be rebuilt later (the fitter's features) without
        # re-deriving the whole sample
        mats[f"sm_{m.name}"] = (lambda mm=m, s=_name_seed(m.name, seed):
                                replica(mm, s))
    with open(os.path.join(log_dir, "statmatch_info.json")) as f:
        info = json.load(f)
    return mats, info


def xl_replica(m, seed: int = 0) -> CSR:
    """``replica`` for the over-cap tier, but for the banded family: at
    16 nonzeros a row ``replica`` draws columns from a band of 17 by
    rejection and re-sorts every draw so far each round (coupon
    collecting: ~36 s a million nonzeros on one host core, still short of
    the target after 64 rounds). The banded replica here samples exactly
    ``nnz`` cells of that same band without replacement instead."""
    if m.family != "banded":
        return replica(m, seed)
    R, C, N = m.rows, m.cols, m.nnz
    halfw = max(int(np.ceil(N / max(R, 1) / 2)), 1)
    r = np.repeat(np.arange(R, dtype=np.int64), 2 * halfw + 1)
    c = np.clip(r * C // R + np.tile(np.arange(-halfw, halfw + 1), R),
                0, C - 1)
    key = np.unique(r * C + c)
    del r, c
    rng = np.random.default_rng(seed)
    key = key[np.sort(rng.choice(len(key), min(N, len(key)),
                                 replace=False))]
    return _coo_to_csr(key // C, key % C, (R, C), seed)


def xl_battery(seed: int = 0):
    """The over-cap tier: ``xl_<family>_<nnz>`` -> build function, for
    each family at each of ``XL_NNZ``, square with ``XL_DEGREE``
    nonzeros a row on average; ``info`` names each one's family and marks
    it synthetic."""
    mats, fams = {}, {}
    for nnz in XL_NNZ:
        for fam in FAMILIES:
            nm = f"xl_{fam}_{nnz}"
            n = nnz // XL_DEGREE
            m = SyntheticMatrix(nm, n, n, nnz, fam)
            mats[nm] = (lambda mm=m, s=_name_seed(nm, seed):
                        xl_replica(mm, s))
            fams[nm] = fam
    info = dict(synthetic=True, sampled=len(mats), families=fams,
                family_counts={f: sum(1 for v in fams.values() if v == f)
                               for f in FAMILIES},
                note="synthetic replicas past loops_tpu's sampling caps "
                     "(4M nnz, 1M rows); no SuiteSparse matrix")
    return mats, info
