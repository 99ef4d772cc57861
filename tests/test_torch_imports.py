"""The PyTorch port stands alone: it imports without JAX or ``loops_tpu``,
no module of it imports either, and asking for a CUDA device without a
card raises instead of dropping to the CPU."""
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "loops_tpu_torch")
CPU = torch.device("cpu")

SLICE_MODULES = [
    "loops_tpu_torch",
    "loops_tpu_torch.utils.platform",
    "loops_tpu_torch.utils.device",
    "loops_tpu_torch.utils.timer",
    "loops_tpu_torch.utils.bench",
    "loops_tpu_torch.utils.reference",
    "loops_tpu_torch.utils.equal",
    "loops_tpu_torch.utils.generate",
    "loops_tpu_torch.utils.profile_spmv",
    "loops_tpu_torch.formats.base",
    "loops_tpu_torch.formats.convert",
    "loops_tpu_torch.formats.coo",
    "loops_tpu_torch.formats.csr",
    "loops_tpu_torch.formats.csc",
    "loops_tpu_torch.formats.bcsr",
    "loops_tpu_torch.io.filepath",
    "loops_tpu_torch.io.market",
    "loops_tpu_torch.io.ogb",
    "loops_tpu_torch.layout.contract",
    "loops_tpu_torch.layout.views",
    "loops_tpu_torch.layout.merge_path",
    "loops_tpu_torch.schedule.plans",
    "loops_tpu_torch.tuning.launch_box",
    "loops_tpu_torch.ops.gather",
    "loops_tpu_torch.ops.spmv",
    "loops_tpu_torch.ops.kernels._build",
    "loops_tpu_torch.ops.kernels.spmv_sorted",
    "loops_tpu_torch.ops.kernels.spmv_flat_v2",
    "loops_tpu_torch.ops.kernels.spmv_flat",
    "loops_tpu_torch.ops.spmm",
    "loops_tpu_torch.ops.kernels.spmm_flat",
    "loops_tpu_torch.ops.kernels.spmv_bcsr",
    "loops_tpu_torch.ops.kernels.spmm_bcsr",
    "loops_tpu_torch.ops.kernels.spmm_bcsr_v2",
    "loops_tpu_torch.ops.kernels.spmm_bcsr_v3",
    "loops_tpu_torch.ops.sddmm",
    "loops_tpu_torch.ops.kernels.sddmm_flat",
    "loops_tpu_torch.ops.kernels.sddmm_bcsr",
    "loops_tpu_torch.utils.stream",
    "loops_tpu_torch.models",
    "loops_tpu_torch.models.graph",
    "loops_tpu_torch.models.message_passing",
    "loops_tpu_torch.models.gcn",
    "loops_tpu_torch.models.train",
    "loops_tpu_torch.models.checkpoint",
    "loops_tpu_torch.utils.math",
    "loops_tpu_torch.utils.sample",
    "loops_tpu_torch.layout.partition",
    "loops_tpu_torch.ops.kernels.saxpy",
    "loops_tpu_torch.probes",
    "loops_tpu_torch.probes.common",
    "loops_tpu_torch.probes.mosaic",
    "loops_tpu_torch.probes.r2",
    "loops_tpu_torch.probes.gather",
]


def _package_sources():
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def test_slice_imports_with_jax_blocked():
    # a None entry in sys.modules makes any later import of that name fail
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['loops_tpu'] = None\n"
        "sys.modules['optax'] = None\n"
        "sys.modules['orbax'] = None\n"
        f"for m in {SLICE_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "import loops_tpu_torch\n"
        "for sub in loops_tpu_torch._SUBMODULES:\n"
        "    getattr(loops_tpu_torch, sub)\n"
        "assert not [m for m in sys.modules if m.startswith('jax.')]\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=REPO)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.strip().endswith("ok")


def test_no_jax_import_in_package():
    pat = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|import\s+loops_tpu\b"
                     r"|from\s+loops_tpu\b|from\s+loops_tpu\.|"
                     r"import\s+loops_tpu\.)", re.M)
    offenders = []
    for path in _package_sources():
        with open(path) as f:
            src = f.read()
        offenders += [f"{os.path.relpath(path, REPO)}: {m.group(0).strip()}"
                      for m in pat.finditer(src)]
    assert not offenders, offenders
    # the scan does see the package (guards against a wrong path)
    assert sum(1 for _ in _package_sources()) >= len(SLICE_MODULES) - 1


def test_lazy_submodules():
    import loops_tpu_torch

    assert set(loops_tpu_torch._SUBMODULES) <= set(dir(loops_tpu_torch))
    assert (loops_tpu_torch.ops.SpMVOperator.__module__
            == "loops_tpu_torch.ops.spmv")
    with pytest.raises(AttributeError):
        loops_tpu_torch.not_a_submodule


def _tiny_csr():
    from loops_tpu_torch.utils import generate
    return generate.identity_csr(4)


def _tiny_plan():
    from loops_tpu_torch.layout import CsrLayout
    from loops_tpu_torch.schedule.plans import make_plan
    csr = _tiny_csr()
    return csr, make_plan(CsrLayout.from_csr(csr), "merge_path", block_work=8)


def _tiny_graph():
    from loops_tpu_torch.models.graph import Graph
    return Graph.from_edges(np.array([0, 1, 2]), np.array([1, 2, 3]), 4,
                            make_undirected=True)


def _tiny_bcsr():
    from loops_tpu_torch.formats import BCSR
    return BCSR.from_csr(_tiny_csr(), 8, 128)


def _entry(module, name):
    import importlib
    return getattr(importlib.import_module(f"loops_tpu_torch.{module}"), name)


def _script_main(path):
    """``main`` of a script of the repo (``examples/``, ``scripts/``),
    loaded by path."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        os.path.basename(path)[:-3] + "_entry", os.path.join(REPO, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


# every public entry point of the port that takes ``device=``, called
# without one: each defaults to the card
NO_DEVICE_CALLS = {
    "ensure_platform": lambda: _entry("utils.platform", "ensure_platform")(),
    "SpMVOperator": lambda: _entry("ops.spmv", "SpMVOperator")(_tiny_csr()),
    "spmv": lambda: _entry("ops.spmv", "spmv")(_tiny_csr(), np.ones(4)),
    "SpMVOperator_bcsr": lambda: _entry("ops.spmv", "SpMVOperator")(
        _tiny_bcsr(), impl="pallas"),
    "SpMMOperator": lambda: _entry("ops.spmm", "SpMMOperator")(_tiny_csr()),
    "spmm": lambda: _entry("ops.spmm", "spmm")(
        _tiny_csr(), np.ones((4, 2), np.float32)),
    "SpMMOperator_bcsr": lambda: _entry("ops.spmm", "SpMMOperator")(
        _tiny_bcsr(), impl="pallas3"),
    "GCN": lambda: _entry("models.gcn", "GCN")(_tiny_graph(), [3, 2]),
    "aggregate_operator": lambda: _entry(
        "models.message_passing", "aggregate_operator")(_tiny_graph()),
    "masked_aggregate_operator": lambda: _entry(
        "models.message_passing", "masked_aggregate_operator")(
            _tiny_graph(), np.ones(4, bool)),
    "_route_aggregation": lambda: _entry(
        "models.message_passing", "_route_aggregation")(_tiny_csr(), None),
    "sorted_spmv": lambda: _entry("ops.kernels.spmv_sorted",
                                  "sorted_spmv")(_tiny_csr()),
    "flat_spmv": lambda: _entry("ops.kernels.spmv_flat", "flat_spmv")(
        *_tiny_plan()),
    "flat_spmv_v2": lambda: _entry("ops.kernels.spmv_flat_v2",
                                   "flat_spmv_v2")(*_tiny_plan()),
    "flat_spmm": lambda: _entry("ops.kernels.spmm_flat", "flat_spmm")(
        *_tiny_plan()),
    "bcsr_spmv": lambda: _entry("ops.kernels.spmv_bcsr", "bcsr_spmv")(
        _tiny_bcsr()),
    "bcsr_spmm": lambda: _entry("ops.kernels.spmm_bcsr", "bcsr_spmm")(
        _tiny_bcsr()),
    "bcsr_spmm_v2": lambda: _entry("ops.kernels.spmm_bcsr_v2",
                                   "bcsr_spmm_v2")(_tiny_bcsr()),
    "bcsr_spmm_v3": lambda: _entry("ops.kernels.spmm_bcsr_v3",
                                   "bcsr_spmm_v3")(_tiny_bcsr()),
    "SDDMMOperator": lambda: _entry("ops.sddmm", "SDDMMOperator")(
        _tiny_csr(), impl="pallas", dtype="bfloat16"),
    "sddmm": lambda: _entry("ops.sddmm", "sddmm")(
        _tiny_csr(), np.ones((4, 2), np.float32), np.ones((4, 2), np.float32)),
    "SDDMMOperator_bcsr": lambda: _entry("ops.sddmm", "SDDMMOperator")(
        _tiny_bcsr(), impl="pallas"),
    "sddmm_flat": lambda: _entry("ops.kernels.sddmm_flat", "sddmm_flat")(
        _tiny_csr()),
    "sddmm_bcsr": lambda: _entry("ops.kernels.sddmm_bcsr", "sddmm_bcsr")(
        _tiny_bcsr()),
    "measure_stream_gbps": lambda: _entry("utils.stream",
                                          "measure_stream_gbps")(),
    "saxpy": lambda: _entry("ops.kernels.saxpy", "saxpy")(
        2.5, np.ones(8, np.float32), np.ones(8, np.float32)),
    "probes.mosaic.run": lambda: _entry("probes.mosaic", "run")(),
    "probes.mosaic.seg_scan_bind": lambda: _entry(
        "probes.mosaic", "seg_scan_bind")(np.zeros((4, 8), np.float32),
                                          np.ones((4, 8), np.float32)),
    "probes.mosaic.construct_bind": lambda: _entry(
        "probes.mosaic", "construct_bind")("shift_sub",
                                           np.zeros((32, 128), np.float32)),
    "probes.r2.smem_scatter": lambda: _entry("probes.r2", "smem_scatter")(
        np.zeros(8, np.int32), 256),
    "probes.r2.smem_clusters": lambda: _entry("probes.r2", "smem_clusters")(),
    "probes.r2.run": lambda: _entry("probes.r2", "run")(quick=True),
    "probes.gather.run": lambda: _entry("probes.gather", "run")(quick=True),
    "examples/saxpy_torch.py": lambda: _script_main(
        "examples/saxpy_torch.py")([]),
    "examples/custom_layout_torch.py": lambda: _script_main(
        "examples/custom_layout_torch.py")([]),
    "scripts/h100_probes.py": lambda: _script_main(
        "scripts/h100_probes.py")(["--quick"]),
    "launch_params": lambda: _entry("tuning.launch_box", "launch_params")(),
    "Timer": lambda: _entry("utils.timer", "Timer")(),
    "time_fn": lambda: _entry("utils.timer", "time_fn")(lambda: None),
}


@pytest.mark.parametrize("entry", sorted(NO_DEVICE_CALLS))
def test_cuda_request_without_card_raises(monkeypatch, entry):
    from loops_tpu_torch.utils.platform import ensure_platform

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        NO_DEVICE_CALLS[entry]()
    assert ensure_platform("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        ensure_platform("meta")


def test_example_refuses_cuda_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the refusal cannot be observed")
    r = subprocess.run(
        [sys.executable, "examples/spmv_torch.py", "--rows", "8",
         "--cols", "8"], capture_output=True, text=True, timeout=120,
        cwd=REPO)
    assert r.returncode != 0
    assert "CUDA is not available" in r.stderr
    assert ",random," not in r.stdout


def test_kernel_wrappers_refuse_cpu_tensors():
    from loops_tpu_torch.ops.kernels import spmv_flat, spmv_flat_v2, spmv_sorted

    x = torch.zeros(4)
    with pytest.raises(ValueError, match="CUDA tensor"):
        spmv_sorted.sorted_spmv_cuda({}, x, dict(num_blocks=1, cols_n=4,
                                                  rows=4))
    with pytest.raises(ValueError, match="CUDA tensor"):
        spmv_flat_v2.flat_spmv_v2_cuda({}, x, (4, 4))
    with pytest.raises(ValueError, match="CUDA tensor"):
        spmv_flat.flat_spmv_cuda({}, x, (4, 4), 128)


def test_device_properties_without_card(monkeypatch):
    from loops_tpu_torch.utils import device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    device.clear_cache()
    try:
        p = device.properties()
        assert p["platform"] == "cpu" and device.num_devices() == 0
        assert device.device_kind() == "cpu"
    finally:
        device.clear_cache()


def test_launch_box_rows(monkeypatch):
    from loops_tpu_torch.tuning import launch_box

    assert launch_box.launch_params(CPU).spmv_block == 64
    # a card that is visible, as far as the resolver can tell
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA H100 80GB HBM3")
    h100 = launch_box.launch_params(torch.device("cuda", 0))
    assert h100.spmv_block == 1024 and h100.spmm_block_f == 256
    assert h100.bcsr_block == (8, 128)
    assert "unmeasured on H100" in h100.provenance
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "Other")
    assert launch_box.launch_params("cuda").provenance == "fallback"


def test_timing_on_cpu_uses_host_clock():
    from loops_tpu_torch.utils.bench import apply_ms
    from loops_tpu_torch.utils.timer import Timer, time_fn

    calls = []

    def fn(v):
        calls.append(1)
        return v * 2

    x = torch.ones(8)
    ms = apply_ms(fn, x, iters=4, repeats=3, warmup=2)
    assert ms >= 0 and len(calls) == 2 + 4 * 3
    assert time_fn(fn, x, iters=3, device=CPU) >= 0
    t = Timer(CPU).start()
    assert t.stop() >= 0 and t.seconds == t.milliseconds / 1e3


def test_profile_applies_on_cpu():
    from loops_tpu_torch.ops.spmv import SpMVOperator
    from loops_tpu_torch.utils import generate
    from loops_tpu_torch.utils.profile_spmv import profile_applies

    op = SpMVOperator(generate.random_csr(40, 30, 0.1, seed=2), "merge_path",
                      block=16, impl="pallas2", device=CPU)
    x = torch.from_numpy(generate.make_input_vector(30))
    r = profile_applies(op, x, applies=3, warmup=1)
    # no card: nothing ran on a device, so the whole apply is idle
    assert r["wall_ms"] > 0 and r["device_ms"] == 0 and r["kernels"] == []
    assert r["idle_share"] == 1.0


def test_profile_refuses_without_card(monkeypatch):
    from loops_tpu_torch.utils import profile_spmv

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        profile_spmv.main([])
