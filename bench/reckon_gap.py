#!/usr/bin/env python3
"""Reckons a Poisson cell's mean arrival gap once, when the cell is
defined, and prints it for the cell's file (``cells/<cell>.json``,
``mean_gap_s``): the mean of the predicted isolated times
(``Task.isolated_time``, Algorithm 1 on the frozen H100 model) over one
block of the mix's sizes, divided by the mix's offered load.  Runs on the
CPU: the engine schedules without executing.

    PYTHONPATH=src python3 bench/reckon_gap.py olmo-1b preempt
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def reckon(config: str, mix_name: str) -> dict:
    from bench import traffic
    cfg = json.loads((REPO / "bench" / "configs" / f"{config}.json").read_text())
    mix = traffic.load_mix(mix_name)
    iso = mean_isolated_s(cfg, mix)
    return dict(mean_isolated_s=iso, mean_gap_s=iso / mix["load"])


def mean_isolated_s(cfg: dict, mix: dict) -> float:
    """The mean predicted isolated time over one block of the mix."""
    import numpy as np
    from repro_torch.hw import HardwareModel
    from repro_torch.serving import EngineConfig, ServingEngine

    from bench import harness, traffic, yardstick
    model = harness.build_model(cfg)
    drawn = [dict(rid=i, priority=s["priority"], arrival=0.0,
                  max_new_tokens=s["output_len"],
                  prompt=np.zeros((s["batch"], s["prompt_len"]), np.int32))
             for i, s in enumerate(traffic.block_sizes(mix))]
    engine = ServingEngine({cfg["name"]: (model, None)}, cfg=EngineConfig(
        hw=HardwareModel(**yardstick.FROZEN_H100), policy="prema",
        mechanism="dynamic", execute=False))
    engine.run(harness.requests(cfg, drawn))
    return float(np.mean([t.isolated_time for t in engine.tasks]))


if __name__ == "__main__":
    sys.path[:0] = [str(REPO / "src"), str(REPO)]
    print(json.dumps(reckon(*sys.argv[1:3])))
