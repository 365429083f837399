"""End-to-end driver: multi-tenant serving of 4 architectures with mixed
priorities and SLAs, comparing NP-FCFS (the TensorRT-IS baseline of the
paper's Fig 1) against preemptive PREMA on the same request trace (port
of ``examples/multi_tenant_serving.py``).

Covers: dense LM, MoE, SSM (xLSTM) and a VLM — real execution with
genuine layer-boundary preemption (checkpoint/restore of KV + hidden
state), priority-aware token scheduling, Algorithm-3 dynamic mechanism
selection, decode-length prediction via the profile LUT, and host-offload
accounting under KV-pool pressure.

Runs on ``cuda`` unless ``--device cpu`` is given, in f32 (the
reference's dtype) unless ``--dtype`` says otherwise, always on the tiny
configs: the four archs at full size hold about 84 GB in bf16, more than
one card.

    PYTHONPATH=src python -m repro_torch.examples.multi_tenant_serving \
        --device cpu
"""
import argparse
import copy

import numpy as np
import torch

from repro_torch.examples import quickstart
from repro_torch.hw import H100, HardwareModel
from repro_torch.serving import EngineConfig, InferenceRequest, ServingEngine

ARCHS = ("olmo-1b", "qwen3-moe-30b-a3b", "xlstm-350m",
         "llama-3.2-vision-11b")


def build_models(device="cuda", dtype: torch.dtype = torch.float32) -> dict:
    return quickstart.build_models(device, dtype, archs=ARCHS)


def make_trace(models, rng, n=16):
    reqs = []
    for i in range(n):
        arch = ARCHS[int(rng.integers(len(ARCHS)))]
        cfg = models[arch][0].cfg
        plen = int(rng.integers(5, 14))
        kw = dict(
            rid=i, arch=arch,
            prompt=rng.integers(1, 250, (1, plen)).astype(np.int32),
            max_new_tokens=6, priority=int(rng.choice([1, 3, 9])),
            arrival=float(rng.uniform(0, 2e-4)),
            sla_scale=6.0,
            true_decode_len=int(rng.integers(2, 7)))
        if cfg.img_tokens:
            kw["img_embeds"] = rng.standard_normal(
                (1, cfg.img_tokens, cfg.d_vision)).astype(np.float32)
        reqs.append(InferenceRequest(**kw))
    return reqs


def run(models, reqs, policy, preemptive, mech, hw: HardwareModel = H100):
    eng = ServingEngine(models, cfg=EngineConfig(
        hw=hw, policy=policy, preemptive=preemptive, mechanism=mech))
    for arch in ARCHS:
        eng.fit_length_regressor(arch, [(6, 3), (8, 4), (10, 5), (13, 6)])
    eng.run([copy.deepcopy(r) for r in reqs])
    return eng


def compare(models, reqs, hw: HardwareModel = H100):
    """NP-FCFS and preemptive PREMA on ``reqs``: prints the improvement
    table and checks that the token outputs are identical across the two
    schedulers.  Returns both engines."""
    fcfs = run(models, reqs, "fcfs", False, "drain", hw)
    prema = run(models, reqs, "prema", True, "dynamic", hw)

    print(f"{'metric':24} {'NP-FCFS':>10} {'P-PREMA':>10} {'improvement':>12}")
    f, p = fcfs.summary(), prema.summary()
    for met, better_low in [("antt", True), ("fairness", False),
                            ("stp", False), ("tail95_high", True),
                            ("sla_met_rate", False), ("mean_ttft", True)]:
        imp = (f[met] / p[met]) if better_low else (p[met] / max(f[met], 1e-12))
        print(f"{met:24} {f[met]:>10.3f} {p[met]:>10.3f} {imp:>11.2f}x")
    print(f"\npreemptions under PREMA: {int(p['preemptions'])}, "
          f"checkpoint overhead {p['ckpt_overhead']*1e6:.1f} us total")
    # outputs are bit-identical across schedulers: preemption never changes
    # model results
    fr = {r.rid: r.tokens for r in fcfs.completed}
    pr = {r.rid: r.tokens for r in prema.completed}
    if set(fr) != set(pr) or not all(np.array_equal(fr[k], pr[k])
                                     for k in fr):
        raise AssertionError("token outputs differ across schedulers")
    print("token outputs identical across schedulers: OK")
    return fcfs, prema


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="float32",
                    choices=sorted(quickstart.DTYPES))
    args = ap.parse_args(argv)
    rng = np.random.default_rng(7)
    models = build_models(args.device, quickstart.DTYPES[args.dtype])
    reqs = make_trace(models, rng)
    return compare(models, reqs)


if __name__ == "__main__":
    main()
