"""Serving launcher: bring up a PREMA engine over registered models and
replay a request trace (synthetic or from a JSON file).

    PYTHONPATH=src python -m repro_torch.launch.serve --archs olmo-1b qwen3-8b \
        --n-requests 12 --policy prema --mechanism dynamic

Runs on ``cuda`` unless ``--device cpu`` is given; ``--full`` serves the
full-size configs in place of the tiny ones.  The synthetic and JSON
requests are token prompts, as the reference launcher's are, so the archs
they serve are the token decoders: the dense and MoE ones, xlstm-350m and
the hybrid jamba-1.5-large (``--archs xlstm-350m jamba-1.5-large-398b``;
jamba tiny only, its full size does not fit one card).  The VLM
llama-3.2-vision-11b and the encoder-only hubert-xlarge need image
embeddings or frames with each request: ``ServingEngine.run`` takes them
from a serving trace (``repro_torch.workloads.serving_adapter`` draws
them from each record's seed) or from requests that carry them.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch.models import get_model
from repro_torch.params import resolve_device
from repro_torch.serving import EngineConfig, InferenceRequest, ServingEngine

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--archs", nargs="+", default=["olmo-1b", "qwen3-8b"])
    ap.add_argument("--policy", default="prema",
                    choices=["fcfs", "rrb", "hpf", "sjf", "token", "prema"])
    ap.add_argument("--mechanism", default="dynamic",
                    choices=["checkpoint", "kill", "drain", "dynamic"])
    ap.add_argument("--non-preemptive", action="store_true")
    ap.add_argument("--n-requests", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", default=None, help="JSON request trace")
    ap.add_argument("--out", default=None, help="write results JSON here")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="bfloat16", choices=sorted(DTYPES))
    ap.add_argument("--full", action="store_true",
                    help="full-size configs in place of the tiny ones")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(0)
    models = {}
    for name in args.archs:
        m = get_model(name, tiny=not args.full)
        models[name] = (m, m.init_params(generator=gen,
                                         dtype=DTYPES[args.dtype],
                                         device=device))
    engine = ServingEngine(models, cfg=EngineConfig(
        policy=args.policy, preemptive=not args.non_preemptive,
        mechanism=args.mechanism))
    for name in args.archs:
        engine.fit_length_regressor(name, [(6, 3), (8, 4), (12, 6), (16, 8)])

    rng = np.random.default_rng(args.seed)
    if args.trace:
        with open(args.trace) as f:
            spec = json.load(f)
        reqs = [InferenceRequest(
            rid=i, arch=r["arch"],
            prompt=np.asarray(r["prompt"], np.int32)[None],
            max_new_tokens=r.get("max_new_tokens", 8),
            priority=r.get("priority", 3),
            arrival=r.get("arrival", 0.0)) for i, r in enumerate(spec)]
    else:
        reqs = []
        for i in range(args.n_requests):
            arch = args.archs[int(rng.integers(len(args.archs)))]
            plen = int(rng.integers(6, 16))
            reqs.append(InferenceRequest(
                rid=i, arch=arch,
                prompt=rng.integers(1, 250, (1, plen)).astype(np.int32),
                max_new_tokens=8, priority=int(rng.choice([1, 3, 9])),
                arrival=float(rng.uniform(0, 2e-4)),
                true_decode_len=int(rng.integers(3, 9))))

    results = engine.run(reqs)
    s = engine.summary()
    print(f"{len(results)} requests | ANTT {s['antt']:.2f} | "
          f"STP {s['stp']:.2f} | fairness {s['fairness']:.3f} | "
          f"tail95(high) {s['tail95_high']:.2f} | "
          f"SLA met {s['sla_met_rate']:.0%} | "
          f"preemptions {int(s['preemptions'])}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump([{
                "rid": r.rid, "arch": r.arch, "ntt": r.ntt,
                "ttft": r.ttft, "tokens": r.tokens.tolist(),
                "preemptions": r.n_preemptions} for r in results], f,
                indent=1)


if __name__ == "__main__":
    main()
