"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program: top-level module names are
compared whole (``compression_tpu_torch`` begins with
``compression_tpu`` and is not it)."""

import ast
import pathlib

import pytest

BENCH = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "compression_tpu"}
SOURCES = sorted(BENCH.rglob("*.py"))


def imported_top_levels(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                names.add(str(node.args[0].value).split(".")[0])
    return names


def test_the_sources_are_found():
    assert len(SOURCES) > 20
    assert BENCH / "run.py" in SOURCES


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not imported_top_levels(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    names = imported_top_levels(path)
    assert "compression_tpu_torch" not in names
    assert names <= {"__future__", "bisect", "contextlib", "dataclasses", "importlib", "math",
                     "pathlib", "struct", "typing", "numpy", "torch", "benchmark"}
    text = path.read_text()
    for other in ("benchmark.program", "benchmark.drivers", "benchmark.weights",
                  "benchmark.families"):
        assert other not in text


def test_the_names_are_compared_whole():
    assert "compression_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "compression_tpu.models".split(".")[0] in FORBIDDEN
