"""No module the benchmark runs imports JAX or the JAX package, by whole
top-level name (``loops_tpu_torch`` begins with ``loops_tpu``), and the
plain references import nothing of the program."""
import ast
import os

import pytest

from loopsbench import harness

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANNED = set(harness.BANNED_MODULES)


def modules():
    for d, _, files in os.walk(PKG):
        if os.path.basename(d) in ("tests", "__pycache__"):
            continue
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.relpath(os.path.join(d, f), PKG)


def top_names(path):
    with open(os.path.join(PKG, path)) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value.split(".")[0]


@pytest.mark.parametrize("path", list(modules()))
def test_no_jax(path):
    assert not BANNED.intersection(top_names(path)), path


@pytest.mark.parametrize("path", [p for p in modules()
                                  if p.startswith("reference")])
def test_reference_imports_nothing_of_the_program(path):
    names = set(top_names(path))
    assert names <= {"__future__", "torch"}, names


def test_banned_modules_compares_whole_names():
    names = ["loops_tpu_torch", "loops_tpu_torch.ops.spmv", "jaxlib.xla",
             "numpy", "flaxen"]
    assert harness.banned_modules(names) == ["jaxlib"]
    assert harness.banned_modules(names + ["loops_tpu.ops"]) == [
        "jaxlib", "loops_tpu"]
