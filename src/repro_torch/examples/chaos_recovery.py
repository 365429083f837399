# Copied from examples/chaos_recovery.py; `repro.` rewritten to `repro_torch.`.
"""Device crashes, checkpoint recovery, and client retries in ~100 lines.

Two demos on the cluster simulator's fault plumbing:

1. **One scripted crash, two recovery modes.**  A single device runs one
   long task; a scripted ``FaultInjector`` kills the device mid-flight
   and repairs it shortly after.  Under ``checkpoint`` the task resumes
   from its last durable snapshot; under ``kill`` it restarts from zero.
   The printed timeline shows exactly how much work each mode lost.

2. **A fleet under stochastic chaos.**  Four devices serve a
   three-tenant Poisson mix while seeded MTBF/MTTR failures flap
   capacity.  Three configurations ride the *same* failure schedule:
   ride-it-out (static), ``AutoscalerConfig(replace_failed=True)``
   (a stand-in device is provisioned on every crash), and static plus
   ``RetryDriver`` clients re-offering work the admission controller
   sheds while the fleet is degraded.  The fleet runs plain FCFS so
   the failures actually bite the interactive tenant — under PREMA the
   token scheduler holds its SLA even without replacement (that cell
   is in ``benchmarks/chaos_sweep.py``).

The punchline mirrors the chaos sweep: checkpoints bound per-crash
loss, replacement restores the interactive SLA, and retries keep
offered == completed + dropped exact under failures.

    PYTHONPATH=src python examples/chaos_recovery.py
"""
import numpy as np

from repro_torch.core import metrics, trace as core_trace
from repro_torch.core.cluster import ClusterConfig, ClusterSimulator
from repro_torch.core.autoscaler import Autoscaler, AutoscalerConfig
from repro_torch.core.faults import FaultInjector
from repro_torch.core.predictor import Predictor
from repro_torch.core.scheduler import make_policy
from repro_torch.core.task import Task, TaskState
from repro_torch.hw import PAPER_NPU
from repro_torch.workloads import (Poisson, QueueShed, RetryDriver, RetryPolicy,
                             TenantSpec, TrafficMix, generate)
from repro_torch.configs import paper_workloads as pw

N_DEVICES = 4
N_TASKS = 96
LOAD = 0.65
MTBF_ISO, MTTR_ISO = 6.0, 3.0       # in mean isolated task times
FAULT_SEED = 77


def mk_task(tid, priority, arrival, total):
    n = 20
    return Task(tid=tid, model=f"m{tid}", priority=priority, arrival=arrival,
                batch=1, node_times=np.full(n, total / n),
                node_out_bytes=np.full(n, 1 << 17, dtype=np.int64),
                predicted_total=total)


def scripted_crash_demo():
    """A 10 ms task is checkpoint-preempted at 3 ms (that snapshot is
    the only durable state), resumes, then the device crashes at 6.5 ms
    and repairs at 8 ms.  Checkpoint recovery rolls back to the 3 ms
    snapshot; KILL recovery restarts from zero — twice (snapshots are
    only taken by the checkpoint mechanism, so the preemption itself
    already discarded progress)."""
    print("1. one scripted crash: checkpoint resume vs kill restart\n")
    for mech in ("checkpoint", "kill"):
        long = mk_task(0, priority=3, arrival=0.0, total=10e-3)
        spike = mk_task(1, priority=9, arrival=3e-3, total=2e-3)
        inj = FaultInjector(script=[(6.5e-3, "fail", 0),
                                    (8e-3, "recover", 0)])
        sim = ClusterSimulator(
            PAPER_NPU, make_policy("prema", preemptive=True),
            ClusterConfig(n_devices=1, mechanism=mech, faults=inj))
        sim.run([long, spike])
        print(f"  {mech:<11} preempt@3ms crash@6.5ms repair@8ms -> "
              f"lost {long.lost_work * 1e3:4.1f} ms, "
              f"finished at {long.completion * 1e3:5.1f} ms")
    print()


def make_trace(pred, rng):
    models = tuple(pw.WORKLOAD_NAMES)
    probe = generate(TrafficMix(tenants=(TenantSpec(
        name="probe", models=models, share=1.0),),
        arrivals=Poisson(rate=1.0), kind="paper"),
        np.random.default_rng(7), 64, pred=pred)
    iso = float(np.mean([t.isolated_time for t in probe.tasks()]))
    mix = TrafficMix(tenants=(
        TenantSpec(name="interactive", models=models, share=0.25,
                   priority=9, sla_scale=4.0),
        TenantSpec(name="standard", models=models, share=0.375,
                   priority=3, sla_scale=8.0),
        TenantSpec(name="batch", models=models, share=0.375,
                   priority=1, sla_scale=20.0),
    ), arrivals=Poisson(rate=LOAD * N_DEVICES / iso), kind="paper")
    return generate(mix, rng, N_TASKS, pred=pred), iso


def run_fleet(tr, iso, config):
    faults = FaultInjector(mtbf=MTBF_ISO * iso, mttr=MTTR_ISO * iso,
                           seed=FAULT_SEED)
    admission = QueueShed(max_depth=2) if config == "retry" else None
    sim = ClusterSimulator(
        PAPER_NPU, make_policy("fcfs", preemptive=True),
        ClusterConfig(n_devices=N_DEVICES, mechanism="checkpoint",
                      faults=faults, admission=admission))
    scaler = None
    if config == "replace":
        scaler = Autoscaler(AutoscalerConfig(
            min_devices=N_DEVICES, max_devices=N_DEVICES + 2,
            replace_failed=True, target_queue_per_device=1e9,
            low_watermark=0.5, cooldown=2.0 * iso)).attach(sim)
    if config == "retry":
        driver = RetryDriver(RetryPolicy(max_retries=4, backoff=0.5 * iso,
                                         deadline_scale=24.0))
        tasks = driver.drive(sim, tr.tasks())
    else:
        driver, tasks = None, sim.run(tr)
    s = sim.summary()
    hi = metrics.per_tenant_summary(tasks).get("interactive", {})
    n_done = sum(1 for t in tasks if t.state is TaskState.DONE)
    n_drop = sum(1 for t in tasks if t.state is TaskState.DROPPED)
    row = dict(sla_hi=hi.get("sla_satisfaction", float("nan")),
               lost=s["lost_work"], fails=int(s["n_failures"]),
               avail=s["availability"], n_done=n_done, n_drop=n_drop,
               retries=driver.n_retried if driver else 0)
    if scaler is not None:
        scaler.detach()
    assert n_done + n_drop == N_TASKS     # retries never double-settle
    return row


def main():
    pred = Predictor(PAPER_NPU)
    core_trace.build_regressors(pred, np.random.default_rng(123))
    scripted_crash_demo()
    rng = np.random.default_rng(0)
    tr, iso = make_trace(pred, rng)
    print(f"2. {N_DEVICES}-device fleet, MTBF={MTBF_ISO:.0f}x / "
          f"MTTR={MTTR_ISO:.0f}x mean task time, same failure schedule\n")
    print(f"{'config':>10} {'sla(hi)':>8} {'lost(s)':>8} {'fails':>6} "
          f"{'avail':>6} {'done':>5} {'drop':>5} {'retries':>8}")
    for config in ("static", "replace", "retry"):
        r = run_fleet(tr, iso, config)
        print(f"{config:>10} {r['sla_hi']:>8.1%} {r['lost']:>8.3f} "
              f"{r['fails']:>6} {r['avail']:>6.1%} {r['n_done']:>5} "
              f"{r['n_drop']:>5} {r['retries']:>8}")


if __name__ == "__main__":
    main()
