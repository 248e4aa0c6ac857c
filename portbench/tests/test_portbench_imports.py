"""What the benchmark runs imports neither JAX nor the JAX package
(top-level names compared whole: ``pilosa_tpu_torch`` is not
``pilosa_tpu``), and the references import nothing of the program."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
BANNED = {"jax", "jaxlib", "flax", "pilosa_tpu"}


def _top_names(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(BENCH)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not set(_top_names(path)) & BANNED


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_references_import_nothing_of_the_program(path):
    names = set(_top_names(path))
    assert "pilosa_tpu_torch" not in names
    assert names <= {"__future__", "typing", "numpy", "torch", "portbench"}
