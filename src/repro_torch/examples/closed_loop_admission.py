# Copied from examples/closed_loop_admission.py; `repro.` rewritten to `repro_torch.`.
"""Closed-loop serving control plane in ~60 lines.

Runs the same three-tenant workload through the cluster simulator three
ways and prints what the event stream sees:

1. open-loop Poisson at 1.6x cluster capacity (queues grow, tails blow up);
2. the same offered population behind *reactive* closed-loop clients
   (offered throughput self-limits to what the cluster completes);
3. open-loop again but behind priority-aware admission control (low
   priority is shed early; the interactive tenant keeps its SLA).

Usage::

    PYTHONPATH=src python examples/closed_loop_admission.py
"""
import numpy as np

from repro_torch.core import metrics, trace as core_trace
from repro_torch.core.cluster import ClusterConfig, ClusterSimulator
from repro_torch.core.predictor import Predictor
from repro_torch.core.scheduler import make_policy
from repro_torch.hw import PAPER_NPU
from repro_torch.workloads import (ClosedLoop, ExecutedTrace, Poisson, TenantSpec,
                             TrafficMix, generate, make_admission)
from repro_torch.configs import paper_workloads as pw

N_TASKS = 48
LOAD = 3.0          # offered load as a fraction of cluster capacity


def make_sim(admission=None):
    return ClusterSimulator(
        PAPER_NPU, make_policy("prema", preemptive=True),
        ClusterConfig(mechanism="dynamic", n_devices=2,
                      admission=admission))


def report(label, sim, tasks):
    log = sim.events.log
    span = max(ev.t for ev in log)
    n_sub = sum(1 for ev in log if ev.kind == "submit")
    n_drop = sum(1 for ev in log if ev.kind == "drop")
    m = metrics.summarize(tasks)
    hi = metrics.per_tenant_summary(tasks).get("interactive", {})
    print(f"{label:<22} offered={n_sub / span:6.1f}/s "
          f"shed={n_drop / max(n_sub, 1):5.1%} "
          f"p99_ntt={m['p99_ntt']:7.2f} "
          f"sla={m['sla_satisfaction']:5.1%} "
          f"sla_interactive={hi.get('sla_satisfaction', float('nan')):5.1%}")


def main():
    pred = Predictor(PAPER_NPU)
    core_trace.build_regressors(pred, np.random.default_rng(123))
    models = tuple(pw.WORKLOAD_NAMES)
    mean_iso = 0.05
    rate = LOAD * 2 / mean_iso
    mix = TrafficMix(tenants=(
        TenantSpec(name="interactive", models=models, share=0.25,
                   priority=9, sla_scale=4.0),
        TenantSpec(name="standard", models=models, share=0.375,
                   priority=3, sla_scale=8.0),
        TenantSpec(name="batch", models=models, share=0.375,
                   priority=1, sla_scale=20.0),
    ), arrivals=Poisson(rate=rate), kind="paper")
    tr = generate(mix, np.random.default_rng(7), N_TASKS, pred=pred)

    sim = make_sim()
    report("open loop", sim, sim.run(tr))

    sim = make_sim()
    proc = ClosedLoop(n_clients=6, think_time=mean_iso)
    report("closed loop", sim, proc.drive(sim, tr.tasks(), seed=7))

    sim = make_sim(make_admission("priority_shed", soft_depth=4,
                                  hard_depth=16))
    tasks = sim.run(tr)
    report("open + admission", sim, tasks)

    executed = ExecutedTrace.capture(sim, meta={"scenario": "admission"})
    diff = executed.diff(tr)
    print(f"\nexecuted-vs-offered: {diff['n_dropped']} dropped, "
          f"{diff['n_preemptions']} preemptions, "
          f"mean queue delay {diff['mean_queue_delay'] * 1e3:.2f} ms")


if __name__ == "__main__":
    main()
