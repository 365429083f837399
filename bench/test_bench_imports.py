"""No module of the benchmark imports the JAX side (compared by whole
top-level names: ``repro_torch`` is not ``repro``), and the reference
imports nothing of the program."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def imported(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            tops.add(str(node.args[0].value).split(".")[0])
    return tops


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_side(path):
    assert not imported(path) & FORBIDDEN
    assert "benchmarks" + "/" not in path.read_text()


def test_jax_side_by_whole_names():
    from bench import harness
    assert harness.jax_side(["jax.numpy", "repro_torch.serving", "os", "repro",
                             "benchmarks.run", "flaxen"]) == ["benchmarks", "jax", "repro"]
    assert harness.jax_side(["repro_torch", "torch", "bench.harness"]) == []


def test_reference_imports_nothing_of_the_program():
    assert not imported(BENCH / "yardstick.py") - {
        "__future__", "contextlib", "math", "typing", "numpy", "torch"}
    # the benchmark's own package for its loader of ref/ files
    assert not imported(BENCH / "reference.py") - {
        "__future__", "contextlib", "pathlib", "typing", "torch", "bench"}
    assert imported_from(BENCH / "reference.py", "bench") == {"bench"}


def imported_from(path: Path, top: str) -> set:
    """The modules of package ``top`` that ``path`` imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names if a.name.split(".")[0] == top}
        elif (isinstance(node, ast.ImportFrom) and node.level == 0
              and node.module.split(".")[0] == top):
            names.add(node.module)
    return names


@pytest.mark.parametrize("path", sorted((BENCH / "ref").glob("*.py")),
                         ids=lambda p: p.name)
def test_each_reference_imports_nothing_of_the_program(path):
    """A plain reference imports torch, the standard library's math and
    typing, and ``bench.reference``'s helpers: nothing of the program,
    of the harness or of the architecture modules."""
    assert not imported(path) - {"__future__", "math", "typing", "torch",
                                 "bench"}
    assert imported_from(path, "bench") <= {"bench.reference"}
    assert "repro_torch" not in path.read_text()
