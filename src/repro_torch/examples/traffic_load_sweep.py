# Copied from examples/traffic_load_sweep.py; `repro.` rewritten to `repro_torch.`.
"""End-to-end driver for the traffic subsystem (repro/workloads/).

Builds a two-tenant SLA mix — a latency-sensitive interactive tenant and a
throughput-oriented batch tenant — drives a 4-NPU PREMA cluster with
bursty (MMPP) open-loop traffic at increasing offered load, prints the
per-tenant latency/SLA breakdown at each point, and demonstrates trace
record/replay: the exported JSONL reproduces the run bit-for-bit.

    PYTHONPATH=src python examples/traffic_load_sweep.py
"""
import io

import numpy as np

from repro_torch.core import metrics, trace
from repro_torch.core.cluster import ClusterConfig, ClusterSimulator
from repro_torch.core.predictor import Predictor
from repro_torch.core.scheduler import make_policy
from repro_torch.hw import PAPER_NPU
from repro_torch.workloads import (MMPP, TenantSpec, Trace, TrafficMix, generate)


def build_mix(rate: float) -> TrafficMix:
    return TrafficMix(tenants=(
        TenantSpec(name="interactive", models=("CNN-AN", "RNN-SA"),
                   share=0.3, priority=9, sla_scale=4.0, batch=1),
        TenantSpec(name="batch", models=("CNN-VN", "CNN-GN", "RNN-MT1"),
                   share=0.7, priority=1, sla_scale=16.0),
    ), arrivals=MMPP.bursty(rate, duty=0.3))


def main() -> None:
    pred = Predictor(PAPER_NPU)
    trace.build_regressors(pred, np.random.default_rng(1234))
    n_devices, n_tasks = 4, 64

    # calibrate offered load against the mix's mean isolated time
    probe = generate(build_mix(rate=1.0), np.random.default_rng(0),
                     64, pred=pred)
    mean_iso = float(np.mean([t.isolated_time for t in probe.tasks()]))

    print(f"{'load':>5} {'tenant':>12} {'n':>4} {'antt':>7} "
          f"{'p99_ntt':>8} {'sla':>6}")
    for load in (0.4, 0.8, 1.2):
        rate = load * n_devices / mean_iso
        tr = generate(build_mix(rate), np.random.default_rng(42),
                      n_tasks, pred=pred)
        sim = ClusterSimulator(
            PAPER_NPU, make_policy("prema", preemptive=True),
            ClusterConfig(mechanism="dynamic", n_devices=n_devices,
                          placement="affinity"))
        done = sim.run(tr)
        for tenant, row in metrics.per_tenant_summary(done).items():
            print(f"{load:>5.1f} {tenant:>12} {row['n_tasks']:>4.0f} "
                  f"{row['antt']:>7.2f} {row['p99_ntt']:>8.2f} "
                  f"{row['sla_satisfaction']:>6.2f}")

    # record/replay: the exported trace reproduces the run bit-for-bit
    buf = io.StringIO()
    tr.save(buf)
    buf.seek(0)
    replayed = ClusterSimulator(
        PAPER_NPU, make_policy("prema", preemptive=True),
        ClusterConfig(mechanism="dynamic", n_devices=n_devices,
                      placement="affinity")).run(Trace.load(buf, pred=pred))
    ref = sorted((t.tid, t.completion) for t in done)
    got = sorted((t.tid, t.completion) for t in replayed)
    print(f"\nreplay identical: {got == ref} "
          f"({len(tr)} records round-tripped through JSONL)")


if __name__ == "__main__":
    main()
