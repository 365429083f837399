# Copied from examples/observability_tour.py; `repro.` rewritten to `repro_torch.`.
"""The observability layer in ~100 lines: spans, telemetry, live SLOs.

One chaotic serving run — four devices, three SLA tenants, seeded
crashes — observed three ways at once through the shared event bus:

1. **SpanTracer** reconstructs every task's queued/run spans and writes
   a Perfetto/Chrome trace (``obs_tour_trace.json`` — drop it on
   ``ui.perfetto.dev``): per-device run slices, DOWN windows, flow
   arrows across preemptions and crash re-queues, queue-depth and
   PREMA-token counter tracks.
2. **Telemetry** folds the same events into sim-time windows (counts,
   utilization, NTT/turnaround histograms) without ever holding per-task
   state — the JSONL export renders with
   ``python -m benchmarks.report --telemetry obs_tour_telemetry.jsonl``.
3. **SLOMonitor** evaluates error-budget burn *during* the run and emits
   ``slo_alert``/``slo_clear`` back onto the bus, where any subscriber
   (here: a plain list) can react.

Then the replay half: the run's event log round-trips through
``ExecutedTrace`` and ``repro_torch.obs.replay_diff`` proves a re-run is
bit-identical — and pinpoints the first divergence when it isn't.

    PYTHONPATH=src python examples/observability_tour.py
"""
import numpy as np

from repro_torch.core import trace as core_trace
from repro_torch.core.cluster import ClusterConfig, ClusterSimulator
from repro_torch.core.faults import FaultInjector
from repro_torch.core.predictor import Predictor
from repro_torch.core.scheduler import make_policy
from repro_torch.hw import PAPER_NPU
from repro_torch.obs import (SLOMonitor, SLORule, SpanTracer, Telemetry,
                       TelemetryConfig)
from repro_torch.obs.replay_diff import first_divergence
from repro_torch.workloads import Poisson, TenantSpec, TrafficMix, generate
from repro_torch.configs import paper_workloads as pw

N_DEVICES = 4
N_TASKS = 96
LOAD = 1.5                      # well past the knee: queues + preemptions
MTBF_ISO, MTTR_ISO = 8.0, 2.0   # in mean isolated task times


def make_trace(pred, rng):
    models = tuple(pw.WORKLOAD_NAMES)
    probe = generate(TrafficMix(tenants=(TenantSpec(
        name="probe", models=models, share=1.0),),
        arrivals=Poisson(rate=1.0), kind="paper"),
        np.random.default_rng(7), 64, pred=pred)
    iso = float(np.mean([t.isolated_time for t in probe.tasks()]))
    mix = TrafficMix(tenants=(
        # deliberately tight SLAs (c.f. the sweeps' 4x/8x/20x): past the
        # knee with crashes, budgets *will* burn -- that's the demo
        TenantSpec(name="interactive", models=models, share=0.25,
                   priority=9, sla_scale=1.5),
        TenantSpec(name="standard", models=models, share=0.375,
                   priority=3, sla_scale=2.5),
        TenantSpec(name="batch", models=models, share=0.375,
                   priority=1, sla_scale=6.0),
    ), arrivals=Poisson(rate=LOAD * N_DEVICES / iso), kind="paper")
    return generate(mix, rng, N_TASKS, pred=pred), iso


def make_sim(iso):
    faults = FaultInjector(mtbf=MTBF_ISO * iso, mttr=MTTR_ISO * iso, seed=77)
    return ClusterSimulator(
        PAPER_NPU, make_policy("prema", preemptive=True),
        ClusterConfig(n_devices=N_DEVICES, mechanism="checkpoint",
                      faults=faults))


def make_slo(iso):
    return SLOMonitor([
        SLORule(name="interactive-sla", tenant="interactive", target=0.9,
                window=16.0 * iso, min_samples=5,
                alert_burn=1.5, clear_burn=0.75),
        SLORule(name="fleet-sla", target=0.8, window=16.0 * iso,
                alert_burn=1.5, clear_burn=0.75),
    ])


def main():
    pred = Predictor(PAPER_NPU)
    core_trace.build_regressors(pred, np.random.default_rng(123))
    tr, iso = make_trace(pred, np.random.default_rng(0))

    # -- one run, three observers ---------------------------------------
    sim = make_sim(iso)
    tasks = tr.tasks()
    tracer = SpanTracer().attach(sim)
    telemetry = Telemetry(TelemetryConfig(window=4.0 * iso)).attach(
        sim, tasks=tasks)
    slo = make_slo(iso).attach(sim, tasks=tasks)
    heard = []                   # anything can subscribe to SLO events
    sim.events.subscribe("slo_alert", heard.append)
    sim.run(tasks)

    print(f"1. spans: {len(tracer.spans)} reconstructed from "
          f"{tracer.n_events} events")
    busy = tracer.device_busy_seconds()
    for d in sorted(busy):
        bar = "#" * int(40 * busy[d] / max(busy.values()))
        print(f"   npu{d} {busy[d]*1e3:7.1f} ms busy {bar}")
    print(f"   -> {tracer.export('obs_tour_trace.json')} "
          "(open in ui.perfetto.dev)\n")

    snap = telemetry.snapshot()
    tot = snap["totals"]
    print(f"2. telemetry: {len(snap['windows'])} windows of "
          f"{snap['window']:g} s")
    print(f"   submit={tot['submit']} complete={tot['complete']} "
          f"preempt={tot['preempt']} fails={tot['device_fail']} "
          f"sla={tot['sla_attainment']:.1%} "
          f"ntt_mean={tot['ntt_mean']:.2f}")
    print(f"   -> {telemetry.export_jsonl('obs_tour_telemetry.jsonl')} "
          "(render: python -m benchmarks.report --telemetry ...)\n")

    print(f"3. SLOs: {len(slo.alerts)} transitions, "
          f"{len(heard)} heard live on the bus")
    for t, kind, rule, tenant, burn in slo.alerts:
        print(f"   t={t*1e3:7.1f} ms {kind:<9} {rule:<16} "
              f"tenant={tenant or '*':<12} burn={burn:.1f}x")
    for name, st in slo.snapshot().items():
        print(f"   final {name:<16} attainment={st['attainment']:.1%} "
              f"burn={st['burn_rate']:.2f} active={st['active']}")
    print()

    # -- replay: determinism you can diff -------------------------------
    # the monitor's alerts are events too, so a faithful re-run needs the
    # same rules attached -- and then even the alert instants replay
    sim2 = make_sim(iso)
    t2 = core_trace.clone_tasks(tasks)
    make_slo(iso).attach(sim2, tasks=t2)
    sim2.run(t2)
    div = first_divergence(sim.events.log, sim2.events.log)
    print(f"4. replay: re-run vs original -> "
          f"{'bit-identical (alerts included)' if div is None else 'DIVERGED'}")
    sim3 = make_sim(iso)
    t3 = [t for t in core_trace.clone_tasks(tasks)
          if t.tid != 5]                              # drop one task
    make_slo(iso).attach(sim3, tasks=t3)
    sim3.run(t3)
    div = first_divergence(sim.events.log, sim3.events.log)
    print("   drop task 5 and diff again ->")
    for line in div.render().splitlines():
        print(f"   {line}")

    tracer.detach(), telemetry.detach(), slo.detach()


if __name__ == "__main__":
    main()
