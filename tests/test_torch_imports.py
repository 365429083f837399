"""The port stands alone: no JAX and nothing of ``repro`` is imported by
``src/repro_torch`` or ``chip_smoke.py``, and the framework-free modules
it carries are exact copies of the reference's."""
import ast
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = {"jax", "jaxlib", "repro"}

COPIES = ([f"configs/{m}.py" for m in (
    "__init__", "olmo_1b", "deepseek_coder_33b", "qwen3_8b", "qwen1_5_4b",
    "xlstm_350m", "llama32_vision_11b", "hubert_xlarge",
    "jamba15_large_398b", "phi35_moe_42b", "qwen3_moe_30b_a3b",
    "paper_workloads")]
    + [f"core/{m}.py" for m in (
        "task", "ops", "registry", "events", "preemption", "ready_queue",
        "scheduler", "arbiter", "predictor", "metrics", "faults", "simulator",
        "cluster", "arch_ops", "__init__", "trace", "autoscaler")]
    + ["serving/request.py", "serving/kv_cache.py", "serving/__init__.py",
       "training/data.py"]
    + [f"workloads/{m}.py" for m in (
        "__init__", "admission", "arrivals", "generator", "retry",
        "serving_adapter", "spec", "tenants", "trace_io")]
    + [f"obs/{m}.py" for m in (
        "__init__", "tracing", "telemetry", "slo", "replay_diff")]
    # the examples that compute with no framework: their source is
    # examples/<name>.py at the root, their copy under the port's examples/
    + [f"examples/{m}.py" for m in (
        "chaos_recovery", "closed_loop_admission", "elastic_autoscale",
        "observability_tour", "traffic_load_sweep")])
# the engine copy's two edits: the port's H100 is the default hardware
ENGINE_EDITS = [
    ("from repro_torch.hw import TPU_V5E, HardwareModel",
     "from repro_torch.hw import H100, HardwareModel"),
    ("    hw: HardwareModel = TPU_V5E", "    hw: HardwareModel = H100"),
]


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and node.args
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")):
            arg = node.args[0]
            if isinstance(arg, ast.JoinedStr) and arg.values:
                arg = arg.values[0]
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                yield arg.value


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text())
    bad = [m for m in _imported_modules(tree)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path}: imports {bad}"


def _source(rel: str) -> str:
    """The reference file a copy at ``rel`` (under the port) is made from."""
    return rel if rel.startswith("examples/") else f"src/repro/{rel}"


def _copy_of(rel: str) -> str:
    src = _source(rel)
    header = f"# Copied from {src}; `repro.` rewritten to `repro_torch.`.\n"
    return header + re.sub(r"\brepro\.", "repro_torch.", (ROOT / src).read_text())


@pytest.mark.parametrize("rel", COPIES)
def test_copies_match_reference(rel):
    assert (PORT / rel).read_text() == _copy_of(rel)


def test_engine_copy_differs_by_its_two_edits():
    expect = _copy_of("serving/engine.py")
    for old, new in ENGINE_EDITS:
        assert expect.count(old) == 1
        expect = expect.replace(old, new)
    assert (PORT / "serving/engine.py").read_text() == expect


def test_hw_copy_adds_only_h100():
    text = (PORT / "hw.py").read_text()
    expect = _copy_of("hw.py")
    assert text.startswith(expect)
    added = ast.parse(text[len(expect):])
    assert [n.targets[0].id for n in added.body] == ["H100"]


def test_h100_model():
    from repro_torch.hw import H100
    assert H100.peak_flops == 989e12
    assert (H100.hbm_bw, H100.hbm_bytes, H100.ici_bw) == (3.35e12, 80e9, 0.0)
