"""What the benchmark imports: no JAX, no JAX package anywhere in it, and
nothing of the program in its reference. Top-level names are compared
whole: the program's name begins with the JAX package's."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import harness

BENCH = Path(__file__).resolve().parents[1]
PROGRAM = "vqnerf_release_torch"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _top(name):
    return name.split(".")[0]


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_in_the_benchmark(path):
    found = {m for m in _imports(path) if _top(m) in harness.FORBIDDEN}
    assert not found


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    found = {m for m in _imports(path) if _top(m) == PROGRAM}
    assert not found


def test_reference_loads_no_program_module():
    code = ("import sys; import benchmark.reference.decomp; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=BENCH.parent).stdout
    tops = set(ast.literal_eval(out.strip()))
    assert PROGRAM not in tops
    assert not tops & set(harness.FORBIDDEN)


def test_forbidden_names_are_compared_whole():
    mods = {"jax": 1, "jaxlib.xla": 1, "vqnerf_release_tpu.ops": 1,
            PROGRAM: 1, PROGRAM + ".kernels": 1, "jaxtyping": 1,
            "flaxen": 1}
    assert harness.forbidden_modules(mods) == [
        "jax", "jaxlib.xla", "vqnerf_release_tpu.ops"]
