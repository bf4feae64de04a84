"""Nothing the benchmark runs loads JAX or the JAX package, judged by
whole top-level names; the reference loads nothing of the program."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench.run import forbidden_modules

from .conftest import ROOT

HERE = ROOT / "perfbench"


def test_whole_top_level_names():
    assert forbidden_modules(["eryn_tpu_torch", "eryn_tpu_torch.ops",
                              "jaxtyping", "numpy"]) == []
    assert forbidden_modules(["eryn_tpu.moves", "jax.numpy",
                              "jaxlib", "flax.linen"]) == [
        "eryn_tpu", "flax", "jax", "jaxlib"]


def _imports(path):
    tree = ast.parse(Path(path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in HERE.rglob("*.py")
    if "tests" not in p.parts))
def test_no_source_imports_jax(path):
    tops = {name.split(".")[0] for name in _imports(ROOT / path)}
    assert not tops & {"jax", "jaxlib", "flax", "eryn_tpu"}, tops


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in (HERE / "reference").glob("*.py")))
def test_reference_imports_nothing_of_the_program(path):
    tops = {name.split(".")[0] for name in _imports(ROOT / path)}
    assert tops <= {"__future__", "math", "torch", "numpy"}, tops


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r);"
            "import perfbench.reference.checks, perfbench.reference.gaussian,"
            " perfbench.reference.pulses;"
            "print(sorted({m.split('.')[0] for m in sys.modules}"
            " & {'eryn_tpu_torch', 'eryn_tpu', 'jax', 'jaxlib', 'flax'}))"
            % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]"
