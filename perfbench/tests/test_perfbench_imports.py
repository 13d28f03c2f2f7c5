"""No module of the benchmark imports JAX, the JAX package or its old
``benchmarks`` folder, and the reference and trace generator import
nothing of the program either.
Top-level module names are compared whole (``repro_torch`` is not
``repro``)."""
import ast
from pathlib import Path

import pytest

from perfbench import harness

SOURCES = sorted(p for p in harness.BENCH.rglob("*.py")
                 if "__pycache__" not in p.parts)
# JAX, the JAX package, and the JAX package's old benchmark folder
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}
STANDALONE = ("reference", "tracegen.py", "check.py", "roofline.py",
              "controls.py")


def top_level_imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(harness.BENCH))
                              for p in SOURCES])
def test_no_jax_and_no_jax_package_or_its_benchmarks(path):
    assert not FORBIDDEN & set(top_level_imports(path))


@pytest.mark.parametrize("path", [p for p in SOURCES if p.relative_to(
    harness.BENCH).parts[0] in STANDALONE],
    ids=lambda p: str(p.relative_to(harness.BENCH)))
def test_reference_side_imports_nothing_of_the_program(path):
    assert "repro_torch" not in set(top_level_imports(path))
