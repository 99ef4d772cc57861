"""The stat-matched population against ``loops_tpu``'s: the matrices read
from the in-repo sweep logs, every logged name's family equal to
``loops_tpu``'s ``family_of`` and to its ``statmatch_info.json``, and
every logged replica under 200k nonzeros equal, array for array, to
``loops_tpu.utils.statmatch.replica`` at seed 0 (seed 1 in
``test_torch_statmatch_seed1.py``); the over-cap ``xl_`` tier's
recipes."""
import json
import os

import numpy as np
import pytest

import loops_tpu.utils.statmatch as js
from loops_tpu_torch.utils import statmatch as ts

POPULATIONS = {"statmatched": ts.LOG_DIR, "statmatched_rep": ts.REP_LOG_DIR}
LOGGED = {m.name: m for d in POPULATIONS.values()
          for m in ts.load_population(d)}
SMALL = sorted(n for n, m in LOGGED.items() if m.nnz < 200_000)


def _info(d):
    with open(os.path.join(d, "statmatch_info.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("pop", sorted(POPULATIONS))
def test_population_from_logs(pop):
    d = POPULATIONS[pop]
    pop_list = ts.load_population(d)
    info = _info(d)
    assert len(pop_list) == info["sampled"]
    assert {f"sm_{m.name}" for m in pop_list} == set(info["families"])
    # every matrix's dimensions as the logs hold them, TIMEOUT rows aside
    with open(os.path.join(d, "row_mapped.csv")) as f:
        rows = [ln.strip().split(",") for ln in f if ln.startswith("row_")]
    dims = {p[1][3:]: tuple(int(v) for v in p[2:5]) for p in rows}
    assert {m.name: (m.rows, m.cols, m.nnz) for m in pop_list} == dims


@pytest.mark.parametrize("pop", sorted(POPULATIONS))
def test_family_of_every_logged_name(pop):
    d = POPULATIONS[pop]
    fams = _info(d)["families"]
    for m in ts.load_population(d):
        jm = js.RefMatrix(m.name, m.rows, m.cols, m.nnz)
        assert m.family == jm.family == fams[f"sm_{m.name}"], m
        assert ts.family_of(m.name, m.rows, m.cols, m.nnz) == js.family_of(
            m.name, m.rows, m.cols, m.nnz)


def replica_equal(name, seed):
    m = LOGGED[name]
    t = ts.replica(m, ts._name_seed(name, seed))
    j = js.replica(js.RefMatrix(m.name, m.rows, m.cols, m.nnz),
                   js._name_seed(name, seed))
    assert t.shape == j.shape == (m.rows, m.cols)
    for field in ("offsets", "indices", "vals"):
        a, b = getattr(t, field), getattr(j, field)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b, err_msg=f"{name}.{field}")


# seed 1 (the rep population's) in tests/test_torch_statmatch_seed1.py
@pytest.mark.parametrize("name", SMALL)
def test_replica_equal(name):
    replica_equal(name, 0)


def test_statmatched_battery_contract():
    for d, seed in ((ts.LOG_DIR, 0), (ts.REP_LOG_DIR, 1)):
        mats, info = ts.statmatched_battery(d)
        assert info == _info(d) and set(mats) == set(info["families"])
        small = min((n for n in mats if n[3:] in SMALL),
                    key=lambda n: LOGGED[n[3:]].nnz)
        a = mats[small]()
        b = ts.build_replica_by_name(small, seed, d)
        c = ts.replica(LOGGED[small[3:]], ts._name_seed(small[3:], seed))
        np.testing.assert_array_equal(a.indices, b.indices)
        np.testing.assert_array_equal(a.vals, c.vals)
    with pytest.raises(KeyError):
        ts.build_replica_by_name("sm_not_logged")
    with pytest.raises(KeyError):
        ts.build_replica_by_name("uni_n2048_d2_s0")


def test_xl_tier_names_and_families():
    mats, info = ts.xl_battery()
    assert info["synthetic"] and len(mats) == 8
    for nnz in ts.XL_NNZ:
        for fam in ts.FAMILIES:
            assert info["families"][f"xl_{fam}_{nnz}"] == fam
    assert ts.XL_NNZ == (16 * 2 ** 20, 64 * 2 ** 20)


@pytest.mark.parametrize("family", ts.FAMILIES)
def test_xl_replica_small(family):
    m = ts.SyntheticMatrix(f"xl_{family}_65536", 4096, 4096, 65536, family)
    a = ts.xl_replica(m, 3)
    assert a.shape == (4096, 4096) and a.nnz == 65536
    assert a.offsets[0] == 0 and a.offsets[-1] == a.nnz
    rows = np.repeat(np.arange(4096), np.diff(a.offsets))
    key = rows.astype(np.int64) * 4096 + a.indices
    assert np.all(np.diff(key) > 0)  # sorted, no duplicate cell
    np.testing.assert_array_equal(ts.xl_replica(m, 3).indices, a.indices)
    if family == "banded":
        # exactly nnz cells of the band of half-width 8 about the diagonal
        assert np.abs(a.indices - rows).max() <= 8
    else:
        b = ts.replica(m, 3)
        np.testing.assert_array_equal(a.indices, b.indices)
        np.testing.assert_array_equal(a.vals, b.vals)


def test_build_replica_by_name_xl(monkeypatch):
    monkeypatch.setattr(ts, "XL_NNZ", (1 << 14,))
    mats, _ = ts.xl_battery()
    assert set(mats) == {f"xl_{f}_16384" for f in ts.FAMILIES}
    a = ts.build_replica_by_name("xl_powerlaw_16384")
    np.testing.assert_array_equal(a.indices,
                                  mats["xl_powerlaw_16384"]().indices)
    assert a.nnz == 16384 and a.shape == (1024, 1024)
