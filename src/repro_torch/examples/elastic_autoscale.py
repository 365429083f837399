# Copied from examples/elastic_autoscale.py; `repro.` rewritten to `repro_torch.`.
"""Elastic cluster riding a diurnal load curve via the event-driven
autoscaler.

Three fleets serve the same three-tenant diurnal trace (interactive /
standard / batch over the paper's 8-DNN suite):

* static-1   — one always-on device (under-provisioned at peak);
* static-4   — four always-on devices (peak-provisioned, idle at night);
* autoscaled — starts at one device; ``core/autoscaler.py`` watches the
  shared event bus and scales between 1 and 4 off the queue-depth
  signal, paying a provision delay on the way up and checkpoint-
  migrating residents away on the way down.

The punchline mirrors ``benchmarks/autoscale_sweep.py``: the autoscaled
fleet holds the interactive SLA next to static-4 while consuming a
fraction of its device-seconds.

    PYTHONPATH=src python examples/elastic_autoscale.py
"""
import numpy as np

from repro_torch.core import metrics
from repro_torch.core.autoscaler import Autoscaler, AutoscalerConfig
from repro_torch.core.cluster import ClusterConfig, ClusterSimulator
from repro_torch.core.predictor import Predictor
from repro_torch.core.scheduler import make_policy
from repro_torch.core.trace import build_regressors
from repro_torch.hw import PAPER_NPU
from repro_torch.workloads import Diurnal, TenantSpec, TrafficMix, generate
from repro_torch.configs import paper_workloads as pw

MAX_DEVICES = 4
N_TASKS = 256


def make_trace(pred):
    iso_probe = generate(
        TrafficMix(tenants=(TenantSpec(name="probe",
                                       models=tuple(pw.WORKLOAD_NAMES),
                                       share=1.0),),
                   arrivals=Diurnal(base_rate=1.0), kind="paper"),
        np.random.default_rng(7), 64, pred=pred)
    iso = float(np.mean([t.isolated_time for t in iso_probe.tasks()]))
    models = tuple(pw.WORKLOAD_NAMES)
    mix = TrafficMix(tenants=(
        TenantSpec(name="interactive", models=models, share=0.25,
                   priority=9, sla_scale=4.0),
        TenantSpec(name="standard", models=models, share=0.375,
                   priority=3, sla_scale=8.0),
        TenantSpec(name="batch", models=models, share=0.375,
                   priority=1, sla_scale=20.0),
    ), arrivals=Diurnal(base_rate=1.8 / iso, amplitude=0.85,
                        period=64.0 * iso, phase=0.75), kind="paper")
    return generate(mix, np.random.default_rng(0), N_TASKS, pred=pred), iso


def run_fleet(tr, iso, config):
    if config == "autoscaled":
        cfg = ClusterConfig(mechanism="dynamic", n_devices=1,
                            provision_latency=0.5 * iso)
    else:
        cfg = ClusterConfig(mechanism="dynamic",
                            n_devices=1 if config == "static-1" else MAX_DEVICES)
    sim = ClusterSimulator(PAPER_NPU, make_policy("prema", preemptive=True),
                           cfg)
    scaler = None
    if config == "autoscaled":
        scaler = Autoscaler(AutoscalerConfig(
            min_devices=1, max_devices=MAX_DEVICES,
            target_queue_per_device=2.0, low_watermark=0.35,
            window=3.0 * iso, cooldown=1.5 * iso)).attach(sim)
    tasks = sim.run(tr)
    s = sim.summary()
    hi = metrics.per_tenant_summary(tasks)["interactive"]
    row = dict(sla_hi=hi["sla_satisfaction"], p99_ntt=s["p99_ntt"],
               devsec=s["capacity_seconds"],
               ups=int(s["n_scale_ups"]), downs=int(s["n_scale_downs"]))
    if scaler is not None:
        scaler.detach()
    return row


def main():
    pred = Predictor(PAPER_NPU)
    build_regressors(pred, np.random.default_rng(1))
    tr, iso = make_trace(pred)
    print(f"diurnal trace: {N_TASKS} tasks, mean isolated {iso*1e3:.1f} ms\n")
    print(f"{'fleet':>12} {'sla(hi)':>8} {'p99_ntt':>8} "
          f"{'device-sec':>11} {'ups':>4} {'downs':>6}")
    rows = {}
    for config in ("static-1", f"static-{MAX_DEVICES}", "autoscaled"):
        r = rows[config] = run_fleet(tr, iso, config)
        print(f"{config:>12} {r['sla_hi']:>8.1%} {r['p99_ntt']:>8.2f} "
              f"{r['devsec']:>11.3f} {r['ups']:>4} {r['downs']:>6}")
    ratio = rows["autoscaled"]["devsec"] / rows[f"static-{MAX_DEVICES}"]["devsec"]
    print(f"\nautoscaled fleet used {ratio:.0%} of static-{MAX_DEVICES}'s "
          f"device-seconds at sla(hi)={rows['autoscaled']['sla_hi']:.1%}")


if __name__ == "__main__":
    main()
