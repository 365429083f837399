"""Quickstart: serve two models on one engine under PREMA scheduling (port
of ``examples/quickstart.py``).

Runs on ``cuda`` unless ``--device cpu`` is given, in f32 (the
reference's dtype) unless ``--dtype`` says otherwise, on the tiny configs
unless ``--full`` asks for the full-size ones.  The weights come from one
seeded generator; the requests are the reference's ``default_rng(0)``
draws, so the request list is the reference's.

    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu
    PYTHONPATH=src python -m repro_torch.examples.quickstart --full \
        --dtype bfloat16

``main`` runs the parts in order: ``build_models``, ``make_requests`` and
``run``, which callers may drive one at a time (with other weights, a
hardware model, or observers attached to the engine before it runs).
"""
import argparse
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.hw import H100, HardwareModel
from repro_torch.models import get_model
from repro_torch.obs import (SLOMonitor, SLORule, SpanTracer, Telemetry,
                             TelemetryConfig)
from repro_torch.params import resolve_device
from repro_torch.serving import EngineConfig, InferenceRequest, ServingEngine

ARCHS = ("olmo-1b", "qwen3-8b")
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def build_models(device="cuda", dtype: torch.dtype = torch.float32,
                 full: bool = False, archs=ARCHS) -> dict:
    """``{name: (model, params)}`` of ``archs``, their weights drawn in turn
    from one generator seeded with 0 on ``device``."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(0)
    models = {}
    for name in archs:
        m = get_model(name, tiny=not full)
        models[name] = (m, m.init_params(generator=gen, dtype=dtype,
                                         device=device))
    return models


def make_requests(seed: int = 0) -> list:
    """The reference's 8 requests, alternating over ``ARCHS``."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(8):
        arch = ARCHS[i % 2]
        plen = int(rng.integers(6, 16))
        reqs.append(InferenceRequest(
            rid=i, arch=arch,
            prompt=rng.integers(1, 250, (1, plen)).astype(np.int32),
            max_new_tokens=8,
            priority=int(rng.choice([1, 3, 9])),
            arrival=float(rng.uniform(0, 1e-4)),
            true_decode_len=int(rng.integers(3, 9))))
    return reqs


def observe(engine: ServingEngine, reqs: list) -> tuple:
    """``obs/``'s SpanTracer, Telemetry and SLOMonitor attached to
    ``engine`` for ``reqs`` (call before ``engine.run(reqs)``), each fed
    the tasks the engine will make of them.  Times are the engine's
    virtual clock: telemetry windows of the longest isolated request, and
    two rules over 100 such windows, every request's SLA and a TTFT
    target of the shortest isolated request.  Returns the three."""
    tasks = [engine._make_job(r).task for r in reqs]
    iso = [t.isolated_time for t in tasks]
    kw = dict(target=0.9, window=100 * max(iso), min_samples=2,
              alert_burn=1.5, clear_burn=0.75)
    rules = [SLORule(name="sla", **kw),
             SLORule(name="ttft", metric="ttft", ttft_target=min(iso), **kw)]
    return (SpanTracer().attach(engine),
            Telemetry(TelemetryConfig(window=max(iso))).attach(
                engine, tasks=tasks),
            SLOMonitor(rules).attach(engine, tasks=tasks))


def run(models: dict, reqs: list, hw: HardwareModel = H100,
        attach: Optional[Callable] = None):
    """Serve ``reqs`` under PREMA with the reference's length profiles and
    print its table; ``hw`` is the engine's hardware model,
    ``attach(engine, reqs)`` (``observe``, say) runs before the requests
    do.  Returns the engine and its results."""
    engine = ServingEngine(models, cfg=EngineConfig(
        hw=hw, policy="prema", mechanism="dynamic"))
    # teach the decode-length LUT (the paper's Fig-9 regression) a profile
    engine.fit_length_regressor("olmo-1b", [(8, 4), (8, 6), (16, 8)])
    engine.fit_length_regressor("qwen3-8b", [(8, 5), (16, 10)])
    if attach is not None:
        attach(engine, reqs)

    results = engine.run(reqs)
    print(f"{'rid':>3} {'arch':12} {'prio':>4} {'ntt':>6} {'ttft_us':>8} "
          f"{'preempts':>8} tokens")
    for r in sorted(results, key=lambda r: r.rid):
        print(f"{r.rid:>3} {r.arch:12} {r.priority:>4} {r.ntt:>6.2f} "
              f"{r.ttft*1e6:>8.1f} {r.n_preemptions:>8} "
              f"{r.tokens[0][:6].tolist()}")
    s = engine.summary()
    print(f"\nANTT={s['antt']:.2f}  STP={s['stp']:.2f}  "
          f"fairness={s['fairness']:.3f}  SLA met={s['sla_met_rate']:.0%}")
    return engine, results


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="float32", choices=sorted(DTYPES))
    ap.add_argument("--full", action="store_true",
                    help="full-size configs in place of the tiny ones")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    models = build_models(args.device, DTYPES[args.dtype], args.full)
    return run(models, make_requests())


if __name__ == "__main__":
    main()
