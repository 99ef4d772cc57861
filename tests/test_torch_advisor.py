"""The format advisor against ``loops_tpu``'s: with ``loops_tpu``'s
constants passed in as ``costs=`` (read from ``loops_tpu.formats.advisor``
here, never restated in the port), ``advise`` gives its ``FormatAdvice``
field for field on ``tests/test_format_advisor.py``'s matrices; the one
difference, the dropped sorted-kernel envelope, is pinned; the probes
are exact; the default cost row is the card's, with its provenance."""
import dataclasses

import numpy as np
import pytest
import torch

import loops_tpu.formats as jf
import loops_tpu.formats.advisor as jadv
import loops_tpu_torch.formats as tf
from loops_tpu_torch.formats import advisor as tadv
from loops_tpu_torch.utils import generate

CPU = torch.device("cpu")
HBM = 819.0  # the bandwidth tests/test_format_advisor.py fixes


def _uniform_rows(n=4096, k=8, seed=1):
    rng = np.random.default_rng(seed)
    cols = np.concatenate([np.sort(rng.choice(n, k, replace=False))
                           for _ in range(n)])
    return tf.CSR((n, n), np.arange(n + 1, dtype=np.int64) * k, cols,
                  rng.normal(size=n * k).astype(np.float32))


# the matrices of tests/test_format_advisor.py, and a few more
MATRICES = {
    "tridiag_512": lambda: generate.tridiag_csr(512),
    "identity_256": lambda: generate.identity_csr(256),
    "uniform_rows": _uniform_rows,
    "block_diag_8x128": lambda: generate.block_diag_csr(num_blocks=8,
                                                        block=128, seed=2),
    "powerlaw": lambda: generate.skewed_csr(2048, 2048, heavy_rows=4, seed=4),
    "empty": lambda: tf.CSR((4, 4), np.zeros(5, np.int64),
                            np.zeros(0, np.int64), np.zeros(0, np.float32)),
    "banded_64": lambda: generate.banded_csr(64, 64, band=2),
    "block_diag_4x16": lambda: generate.block_diag_csr(4, 16),
    "random": lambda: generate.random_csr(300, 200, 0.03, seed=1),
}


def _jax_costs(hbm=HBM):
    """``loops_tpu``'s cost model as a cost row: its sorted-gather CSR
    rate, its gather rate for ELL cells and BCSR blocks, and its stream
    rate for DIA cells and block values."""
    return tf.FormatCosts(
        csr_ns_per_nnz=jadv.CSR_SORTED_NS,
        ell_ns_per_cell=jadv.GATHER_NS,
        dia_ns_per_cell=jadv._stream_ns_per_cell(hbm),
        bcsr_ns_per_block=jadv.GATHER_NS,
        stream_gbps=hbm, provenance="loops_tpu's constants")


def _jax_csr(t):
    return jf.CSR(t.shape, t.offsets, t.indices, t.vals)


def _same_advice(a, b):
    for f in dataclasses.fields(b):
        mine, theirs = getattr(a, f.name), getattr(b, f.name)
        if f.name == "est_ms":
            assert mine.keys() == theirs.keys()
            for k in theirs:
                assert mine[k] == pytest.approx(theirs[k], rel=1e-12), k
        elif f.name == "why":
            # the same text, less the TPU's unit name
            assert mine == theirs.replace("MXU block stream", "block stream")
        elif isinstance(theirs, float):
            assert mine == pytest.approx(theirs, rel=1e-12), f.name
        else:
            assert mine == theirs, f.name


@pytest.mark.parametrize("block", [(8, 128), (8, 8)])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_advice_matches_loops_tpu_field_for_field(name, block):
    t = MATRICES[name]()
    mine = tadv.advise(t, costs=_jax_costs(), bcsr_block=block, device=CPU)
    theirs = jadv.advise(_jax_csr(t), hbm_gbps=HBM, bcsr_block=block)
    _same_advice(mine, theirs)
    assert tadv.choose_format(t, costs=_jax_costs(), bcsr_block=block,
                              device=CPU) == theirs.recommended


def test_recommendations_land_where_loops_tpus_do():
    # the regimes tests/test_format_advisor.py pins, under its constants
    picks = {name: tadv.choose_format(MATRICES[name](), costs=_jax_costs(),
                                      device=CPU)
             for name in ("tridiag_512", "identity_256", "uniform_rows",
                          "block_diag_8x128", "powerlaw", "empty")}
    assert picks == {"tridiag_512": "dia", "identity_256": "dia",
                     "uniform_rows": "csr", "block_diag_8x128": "bcsr",
                     "powerlaw": "csr", "empty": "csr"}


def test_dropped_sorted_kernel_envelope():
    # a CSR wider than the TPU kernel's resident-x cap: loops_tpu costs
    # its nonzeros at the gather floor (its kernel refuses and the XLA
    # path runs); K1 takes any float32 CSR, so here every nonzero costs
    # csr_ns_per_nnz
    n = jadv._SORTED_X_CAP_COLS + 1
    t = tf.CSR((4, n), np.array([0, 2, 3, 3, 5]), np.array([0, n - 1, 7, 2,
                                                             n // 2]),
               np.ones(5, np.float32))
    mine = tadv.advise(t, costs=_jax_costs(), device=CPU)
    theirs = jadv.advise(_jax_csr(t), hbm_gbps=HBM)
    assert theirs.est_ms["csr"] == pytest.approx(5 * jadv.GATHER_NS * 1e-6)
    assert mine.est_ms["csr"] == pytest.approx(5 * jadv.CSR_SORTED_NS * 1e-6)
    # float64 values: loops_tpu's sorted kernel stages f32 and refuses
    t64 = MATRICES["uniform_rows"]()
    t64 = tf.CSR(t64.shape, t64.offsets, t64.indices,
                 t64.vals.astype(np.float64))
    assert jadv.advise(_jax_csr(t64), hbm_gbps=HBM).est_ms["csr"] == \
        pytest.approx(t64.nnz * jadv.GATHER_NS * 1e-6)
    assert tadv.advise(t64, costs=_jax_costs(), device=CPU).est_ms["csr"] \
        == pytest.approx(t64.nnz * jadv.CSR_SORTED_NS * 1e-6)
    # and the port carries none of the envelope
    for name in ("_SORTED_X_CAP_COLS", "_SORTED_SPAN_COLS",
                 "_SORTED_PAD_CAP", "_SORTED_BLOCK_ATOMS", "_csr_ns_per_nnz",
                 "GATHER_NS", "CSR_SORTED_NS"):
        assert not hasattr(tadv, name), name


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_probes_are_loops_tpus(name):
    t = MATRICES[name]()
    j = _jax_csr(t)
    for block in ((8, 128), (2, 2), (16, 128)):
        assert tadv.probe_bcsr_fill(t, *block) == pytest.approx(
            jadv.probe_bcsr_fill(j, *block), rel=1e-12)
    ndiag, fill = tadv.probe_dia_fill(t)
    assert ndiag == jf.DIA.count_diagonals(j)
    pitch, waste = tadv.probe_ell_waste(t)
    assert pitch == jf.ELL.max_nnz_per_row(j)
    adv = jadv.advise(j, hbm_gbps=HBM)
    assert fill == pytest.approx(adv.dia_fill, rel=1e-12)
    assert waste == pytest.approx(adv.ell_waste, rel=1e-12)


def test_block_fill_probe_matches_the_bcsr_container():
    t = generate.random_csr(256, 256, sparsity=0.05, seed=3)
    b = t.to_bcsr(8, 128)
    assert tadv.probe_bcsr_fill(t, 8, 128) == pytest.approx(
        t.nnz / (b.num_blocks * 8 * 128))


def test_default_row_is_the_cards(monkeypatch):
    h100 = tadv._TABLE[0][1]
    assert "H100" in h100.provenance and "W" in h100.provenance
    assert h100.csr_ns_per_nnz > 0 and h100.dia_ns_per_cell > 0
    assert h100.ell_ns_per_cell > 0 and h100.bcsr_ns_per_block >= 0
    # the CPU stands in the H100 row and says so
    cpu = tadv.format_costs(CPU)
    assert cpu.csr_ns_per_nnz == h100.csr_ns_per_nnz
    assert "standing in" in cpu.provenance
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA H100 80GB HBM3")
    assert tadv.format_costs("cuda") is h100
    # advise's default is that row
    t = MATRICES["tridiag_512"]()
    assert tadv.advise(t, device=CPU).est_ms == tadv.advise(
        t, costs=h100, device=CPU).est_ms


def test_advice_converts_and_keeps_the_spmv():
    from loops_tpu_torch.ops.spmv import SpMVOperator

    for name in ("tridiag_512", "banded_64", "block_diag_4x16", "random"):
        t = MATRICES[name]()
        x = generate.make_input_vector(t.shape[1])
        pick = tadv.choose_format(t, costs=_jax_costs(), bcsr_block=(8, 8),
                                  device=CPU)
        mat = {"csr": lambda c: c, "ell": lambda c: c.to_ell(),
               "dia": lambda c: c.to_dia(),
               "bcsr": lambda c: c.to_bcsr(8, 8)}[pick](t)
        y = SpMVOperator(mat, "auto" if pick != "csr" else "row_mapped",
                         device=CPU)(x)
        np.testing.assert_allclose(y.numpy(), t.to_dense() @ x, rtol=1e-5,
                                   atol=1e-6)
