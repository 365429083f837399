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
    for name in ("reference.py", "yardstick.py"):
        assert not imported(BENCH / name) - {"__future__", "contextlib",
                                             "math", "typing", "numpy", "torch"}
