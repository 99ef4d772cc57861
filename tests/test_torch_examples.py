"""The port's examples on the CPU, against the JAX examples they port:
``examples/range_torch.py``, ``examples/custom_layout_torch.py`` and
``examples/saxpy_torch.py`` print the same lines as ``examples/range.py``,
``examples/custom_layout.py`` and ``examples/saxpy.py`` (saxpy: its own
``torch vs kernel`` line) and ``Errors: 0``; ``FlatRebinLayout`` and
``UniformLayout`` (with ``EllLayout`` and ``DiaLayout``) give
``loops_tpu``'s arrays, and ``utils/sample.py`` and ``utils/math.py`` are
``loops_tpu``'s."""
import contextlib
import importlib.util
import io
import os

import numpy as np
import pytest
import torch

from loops_tpu import layout as jl
from loops_tpu.utils import math as jmath
from loops_tpu.utils import sample as jsample
from loops_tpu_torch import layout as tl
from loops_tpu_torch.utils import generate, sample
from loops_tpu_torch.utils import math as tmath

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(name, argv=None):
    spec = importlib.util.spec_from_file_location(
        f"{name}_example", os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        spec.loader.exec_module(mod)
        status = mod.main(*([argv] if argv is not None else []))
    return status, out.getvalue().splitlines()


@pytest.mark.parametrize("name,argv", [("range", None),
                                       ("custom_layout", ["--device", "cpu"])])
def test_example_prints_the_jax_examples_lines(name, argv):
    status, lines = _run(f"{name}_torch", argv)
    jstatus, jlines = _run(name)
    assert status == jstatus == 0
    assert lines == jlines
    if name == "custom_layout":
        assert lines[-1] == "Errors: 0"


def test_saxpy_example_on_the_cpu():
    status, lines = _run("saxpy_torch", ["--device", "cpu"])
    jstatus, jlines = _run("saxpy")
    assert status == jstatus == 0
    assert lines == ["saxpy n=65536: torch vs kernel max err 0.00e+00",
                     "Errors: 0"]
    assert jlines[-1] == lines[-1]
    assert jlines[0].startswith("saxpy n=65536: ")
    status, lines = _run("saxpy_torch", ["--device", "cpu", "--n", "1024"])
    assert status == 0 and lines[0].startswith("saxpy n=1024:")


@pytest.mark.parametrize("argv", [["--n", "12"], ["--n", "0"]])
def test_saxpy_example_refuses_bad_sizes(argv):
    with pytest.raises(SystemExit):
        _run("saxpy_torch", ["--device", "cpu", *argv])


def test_sample_and_math_are_the_jax_packages():
    a, b = sample.csr(), jsample.csr()
    assert a.shape == b.shape
    for f in ("offsets", "indices", "vals"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert getattr(a, f).dtype == getattr(b, f).dtype
    for x in range(0, 40):
        for m in (1, 3, 8, 32):
            assert tmath.ceil_div(x, m) == jmath.ceil_div(x, m)
            assert tmath.round_up(x, m) == jmath.round_up(x, m)
            assert tmath.round_down(x, m) == jmath.round_down(x, m)


CSRS = {"sample": lambda: (sample.csr(), jsample.csr()),
        "random": lambda: (generate.random_csr(40, 30, 0.2, seed=3),) * 2,
        "empty_rows": lambda: (generate.empty_row_csr(12, 9),) * 2}


@pytest.mark.parametrize("K", [1, 3, 8, 1000])
@pytest.mark.parametrize("name", sorted(CSRS))
def test_flat_rebin_matches_loops_tpu(name, K):
    mine, theirs = CSRS[name]()
    a = tl.FlatRebinLayout(tl.CsrLayout.from_csr(mine), K)
    b = jl.FlatRebinLayout(jl.CsrLayout.from_csr(theirs), K)
    assert (a.num_tiles, a.num_atoms) == (b.num_tiles, b.num_atoms)
    np.testing.assert_array_equal(a.tile_offsets(), b.tile_offsets())
    np.testing.assert_array_equal(a.base_tile_ids(), b.base_tile_ids())
    atoms = np.arange(a.num_atoms)
    np.testing.assert_array_equal(a.tile_of(atoms), b.tile_of(atoms))
    np.testing.assert_array_equal(a.atom_tile_ids(), b.atom_tile_ids())
    for t in range(a.num_tiles):
        assert (a.tile_begin(t), a.tile_end(t)) == (b.tile_begin(t),
                                                    b.tile_end(t))
    tl.check_layout_invariants(a)
    tl.check_tile_of_round_trip(a)
    with pytest.raises(ValueError):
        tl.FlatRebinLayout(tl.CsrLayout.from_csr(mine), 0)


@pytest.mark.parametrize("cls", ["UniformLayout", "EllLayout", "DiaLayout"])
@pytest.mark.parametrize("tiles,pitch", [(5, 3), (1, 1), (7, 0), (0, 4)])
def test_uniform_views_match_loops_tpu(cls, tiles, pitch):
    a, b = getattr(tl, cls)(tiles, pitch), getattr(jl, cls)(tiles, pitch)
    assert (a.num_tiles, a.num_atoms, a.pitch) == (b.num_tiles, b.num_atoms,
                                                   b.pitch)
    np.testing.assert_array_equal(a.tile_offsets(), b.tile_offsets())
    assert a.tile_offsets().dtype == b.tile_offsets().dtype
    atoms = np.arange(a.num_atoms)
    np.testing.assert_array_equal(a.tile_of(atoms), b.tile_of(atoms))
    np.testing.assert_array_equal(a.atom_tile_ids(), b.atom_tile_ids())
    tl.check_layout_invariants(a)
    tl.check_tile_of_round_trip(a)


def test_ell_and_dia_views_wait_for_their_formats():
    with pytest.raises(NotImplementedError, match="A6"):
        tl.EllLayout.from_ell(None)
    with pytest.raises(NotImplementedError, match="A6"):
        tl.DiaLayout.from_dia(None)


def test_custom_layout_reduction_is_deterministic():
    spec = importlib.util.spec_from_file_location(
        "custom_layout_torch_mod",
        os.path.join(REPO, "examples", "custom_layout_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    rng = np.random.default_rng(0)
    seg = rng.integers(0, 7, size=200)
    data = torch.from_numpy(rng.normal(size=200).astype(np.float32))
    got = mod.sorted_segment_sum(data, seg, 9)
    assert got.shape == (9,) and float(got[7]) == float(got[8]) == 0.0
    want = np.zeros(9)
    np.add.at(want, seg, data.numpy().astype(np.float64))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    assert torch.equal(got, mod.sorted_segment_sum(data, seg, 9))
