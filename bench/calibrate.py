#!/usr/bin/env python3
"""The readings a cell's ``gap_limit`` is set from, many seeds in one
process (the benchmark's own runs never run this):

    python3 bench/calibrate.py --workload olmo-1b.preempt --seconds 12 \
        --seeds 101 102 103

For each seed: the weights drawn from it, the warm round, a short window
of the cell's rounds at its own load, then on the same sample a run
compares (at least ``check_tokens`` served tokens, the longest request
among them) the widest gap of what the program served, and of the token
the fp8 control (``reference.logits_at(..., fp8=True)``) puts first.  The
lower reading is the program's largest over the seeds, the upper one the
control's smallest.  One JSON line per seed, then the two readings.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def calibrate(workload: str, seeds, seconds: float, device="cuda",
              spec=None, out=sys.stdout) -> dict:
    import torch

    from bench import harness
    spec = spec if spec is not None else harness.resolve(
        harness.load_benchmark(), workload)
    cfg, mix = spec["cfg"], spec["mix"]
    model = harness.build_model(cfg)
    rows = []
    for seed in seeds:
        t0 = time.perf_counter()
        w = harness.draw_weights(cfg, seed, device)
        params = harness.port_params(cfg, w)
        harness.new_engine(model, params).run(harness.warm_requests(
            cfg, mix, seed, cfg["vocab_size"]))
        rec = harness.Recorder()
        results, by_rid, _ = harness.serve(model, params, spec, seed, seconds,
                                           rec)
        got = harness.check(w, cfg, results, by_rid, seed,
                            spec["cell"]["check_tokens"], device, fp8=True)
        row = dict(seed=seed, program_gap=got["widest_gap"],
                   control_gap=got["control_gap"], tokens=got["tokens"],
                   requests=got["requests"], served=len(results),
                   preemptions=sum(r.preemptions for r in rec.reqs.values()),
                   seconds=time.perf_counter() - t0)
        print(json.dumps(row), file=out, flush=True)
        rows.append(row)
        del w, params, results, rec
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    lower = max(r["program_gap"] for r in rows)
    upper = min(r["control_gap"] for r in rows)
    summary = dict(workload=workload, lower=lower, upper=upper,
                   ratio=upper / lower if lower else float("inf"))
    print(json.dumps(summary), file=out, flush=True)
    return summary


if __name__ == "__main__":
    sys.path[:0] = [str(REPO / "src"), str(REPO)]
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=12.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    calibrate(args.workload, args.seeds, args.seconds)
