"""BENCHMARK.json against its contract, and every cell resolving to its
files: configuration, traffic mix, cell file and one reader per metric."""
import json
import re
from pathlib import Path

import pytest

from bench import harness

REPO = Path(__file__).resolve().parents[1]
BM = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BM) == {"command", "paths", "run_seconds", "configs",
                       "workloads", "end_to_end", "per_layer"}
    assert BM["paths"] == ["bench"] and BM["command"][1] == "bench/run.py"
    assert 1 <= BM["run_seconds"] <= 51
    assert len(json.dumps(BM)) < 64 * 1024


def test_configs():
    for c in BM["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("bench/")
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        for key in c["reduced"]:
            assert key in cfg and not key.endswith(("_dim", "_rank", "_size"))
        assert any(w["config"] == c["name"] for w in BM["workloads"])


@pytest.mark.parametrize("cell", [w["name"] for w in BM["workloads"]])
def test_cell_resolves(cell):
    w = next(x for x in BM["workloads"] if x["name"] == cell)
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["chips"] == 1 and len(w["why"]) <= 200
    spec = harness.resolve(BM, cell)
    assert spec["cell"]["gap_limit"] > 0 and spec["cell"]["check_tokens"] > 0
    assert spec["mix"]["round_requests"] >= 1 and spec["cell"]["cycle_rounds"] >= 1
    if spec["mix"]["arrivals"] == "poisson":
        assert spec["cell"]["mean_gap_s"] > 0
    e2e = [m["name"] for m in harness.cell_metrics(BM, cell, False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert harness.cell_metrics(BM, cell, True)


def test_metrics():
    e2e = {m["name"]: m for m in BM["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    names = [m["name"] for m in BM["end_to_end"] + BM["per_layer"]]
    assert len(names) == len(set(names))
    cells = {w["name"] for w in BM["workloads"]}
    for m in BM["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BM["end_to_end"] + BM["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        assert callable(harness.reader(m["name"]))
    for m in BM["per_layer"]:
        moved = e2e[m["moves"]]
        # each listed cell reports the metric it moves
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_every_file_is_named_from_name_characters():
    for path in (REPO / "bench").rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        assert re.match(r"^[A-Za-z0-9_.\-/]+$",
                        str(path.relative_to(REPO))), path
