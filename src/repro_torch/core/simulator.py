# Copied from src/repro/core/simulator.py; `repro.` rewritten to `repro_torch.`.
"""Event-driven single-NPU simulator (the paper's evaluation vehicle).

The simulator advances a virtual clock over three event kinds — task
arrival, task completion, and the scheduling-period quantum (Table II,
0.25 ms).  At every wake-up the *decision* (policy wake-up, candidate
selection, ``Policy.may_preempt``, Algorithm-3 mechanism choice, KILL
progress guarantee) is delegated to the shared scheduling core in
``core/arbiter.py`` — the same :class:`~repro_torch.core.arbiter.Arbiter` that
drives the multi-device :class:`~repro_torch.core.cluster.ClusterSimulator` and
the real-execution :class:`~repro_torch.serving.engine.ServingEngine`.  This
module only *executes* the returned decision on the virtual clock:

* switches pay the CHECKPOINT spill latency (context bytes / memory BW) and
  a restore latency when the preempted task resumes;
* KILL switches are instantaneous but reset the victim's progress;
* DRAIN lets the running task finish first;
* preemption points are tile boundaries: the requested preemption time is
  rounded up to the end of the current GEMM_OP tile (µs-scale, modeled via
  per-node tile times when available).

For N-device simulation see ``core/cluster.py``; ``ClusterSimulator`` with
``n_devices=1`` reproduces this loop bit-identically.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core import events as event_hooks
from repro_torch.core import preemption
from repro_torch.core.arbiter import (Action, Arbiter, ArbiterConfig,
                                should_preempt)  # noqa: F401  (compat)
from repro_torch.core.preemption import Mechanism
from repro_torch.core.ready_queue import make_ready
from repro_torch.core.scheduler import SCHED_QUANTUM, Policy
from repro_torch.core.task import Task, TaskState
from repro_torch.hw import HardwareModel


@dataclasses.dataclass
class SimConfig:
    """Single-device simulator knobs (mechanism, quantum, admission)."""

    mechanism: str = "dynamic"   # checkpoint | kill | drain | dynamic
    quantum: float = SCHED_QUANTUM
    log_events: bool = False
    # Progress guarantee for KILL (anti-livelock; see ArbiterConfig).
    kill_early_frac: float = 0.5
    max_kills: int = 4
    # Admission control (repro_torch.workloads.admission.AdmissionPolicy or
    # None): consulted once per submission via core.events.offer; rejected
    # tasks are DROPPED, emit a ``drop`` event, and never execute.
    admission: Optional[object] = None

    def arbiter_config(self) -> ArbiterConfig:
        """The arbiter-facing subset of this config."""
        return ArbiterConfig(mechanism=self.mechanism,
                             kill_early_frac=self.kill_early_frac,
                             max_kills=self.max_kills)


def tile_roundup(task: Task, elapsed: float) -> float:
    """Extra time to reach the next tile boundary (≥ elapsed)."""
    tt = getattr(task, "node_tile_times", None)
    if tt is None:
        return 0.0
    node = task.current_node()
    if node >= task.total_nodes:
        return 0.0
    q = float(tt[node])
    if q <= 0:
        return 0.0
    offset = (task.executed + elapsed) - float(task._cum[node])
    rem = offset % q
    return 0.0 if rem < 1e-12 else (q - rem)


class NPUSimulator:
    """Single-NPU virtual-clock simulator — the paper's setting (§V).

    A thin wrapper over the shared :class:`~repro_torch.core.arbiter.Arbiter`:
    one device, one running task, preemption by checkpoint/kill/drain,
    events on ``self.events``.  ``ClusterSimulator(n_devices=1)`` is
    bit-identical (tests/test_cluster.py).
    """

    def __init__(self, hw: HardwareModel, policy: Policy,
                 cfg: Optional[SimConfig] = None):
        self.hw = hw
        self.policy = policy
        self.cfg = cfg or SimConfig()
        self.arbiter = Arbiter(policy, self.cfg.arbiter_config())
        self.log: List[Tuple[float, str, int]] = []
        self._inject = None          # live only inside run()

    @property
    def events(self):
        """The shared event bus (core/events.py); subscribe before run()."""
        return self.arbiter.events

    def submit(self, task: Task, at: float) -> None:
        """Inject a task mid-run (closed-loop clients); only valid from an
        event hook while ``run()`` is executing."""
        if self._inject is None:
            raise RuntimeError("submit() is only valid during run() — "
                               "call it from an event-bus hook")
        self._inject(task, at)

    # ------------------------------------------------------------------
    def run(self, tasks: Sequence[Task]) -> List[Task]:
        """``tasks`` may be a prebuilt Task list or a
        :class:`repro_torch.workloads.Trace` (materialized fresh per call)."""
        from repro_torch.workloads.trace_io import as_task_list  # no import cycle
        tasks = as_task_list(tasks)
        hw, cfg, arbiter = self.hw, self.cfg, self.arbiter
        bus, admission = arbiter.events, cfg.admission
        arbiter.reset()
        bus.clear()
        if admission is not None:
            admission.reset()
        self.log = []          # per-run, like every other piece of state
        counter = itertools.count()
        events: List[Tuple[float, int, str, int, int]] = []

        def push(t, kind, tid=-1, gen=0):
            heapq.heappush(events, (t, next(counter), kind, tid, gen))

        by_id: Dict[int, Task] = {t.tid: t for t in tasks}
        for t in tasks:
            t.state = TaskState.WAITING
            push(t.arrival, "arrival", t.tid)

        pending_arrivals: set = set()   # injected tids not yet offered

        def inject(task: Task, at: float):
            nonlocal n_settled
            at = float(at)
            if (task.tid in by_id and task.tid not in pending_arrivals
                    and task.state in (TaskState.DONE, TaskState.DROPPED)):
                # re-offer of a settled logical task (client retry): it is
                # outstanding again — one task, many attempts, n_settled
                # stays exact
                n_settled -= 1
            task.state = TaskState.WAITING
            task.arrival = at
            task.last_wake = at
            by_id[task.tid] = task
            pending_arrivals.add(task.tid)
            push(at, "arrival", task.tid)
        self._inject = inject

        # Indexed ready set (core/ready_queue.py): heap-backed selection
        # for built-in policies, list-compatible iteration for the rest.
        ready = make_ready(self.policy.name)
        running: Optional[Task] = None
        run_start = 0.0          # when current execution segment began
        run_gen = 0              # invalidates stale completion events
        busy_until = 0.0         # switch-overhead window (non-preemptible)
        next_quantum = None
        n_settled = 0            # DONE + DROPPED

        def log(t, kind, tid):
            if cfg.log_events:
                self.log.append((t, kind, tid))

        def ensure_quantum(now):
            nonlocal next_quantum
            if next_quantum is None or next_quantum <= now:
                next_quantum = now + cfg.quantum
                push(next_quantum, "quantum")

        def start(task: Task, now: float) -> float:
            """Begin/resume execution; returns the execution start time
            after any restore overhead."""
            nonlocal running, run_start, run_gen, busy_until
            t0 = now
            if task.restore_pending:
                lat = preemption.restore_latency(task, hw)
                task.checkpoint_overhead += lat
                task.restore_pending = False
                t0 += lat
            running = task
            task.state = TaskState.RUNNING
            task.device = 0
            if task.first_service is None:
                task.first_service = t0
            run_start = t0
            run_gen += 1
            busy_until = t0
            push(t0 + task.remaining, "complete", task.tid, run_gen)
            log(now, "start", task.tid)
            bus.dispatch(now, task, 0)
            return t0

        def preempt(now: float, mech: Mechanism) -> float:
            """Stop the running task; returns when the NPU is free."""
            nonlocal running, run_gen, busy_until
            task = running
            assert task is not None
            elapsed = max(0.0, now - run_start)
            free_at = now
            if mech is Mechanism.KILL:
                # everything since the last restart-from-zero is redone work
                task.lost_work += task.executed + elapsed
                task.executed = 0.0
                task.reset_progress()
                task.n_kills += 1
                task.state = TaskState.WAITING
            else:  # CHECKPOINT
                extra = tile_roundup(task, elapsed)
                task.executed += elapsed + extra
                task.ckpt_executed = task.executed   # durable snapshot
                lat = preemption.checkpoint_latency(task, hw)
                task.checkpoint_overhead += lat
                task.restore_pending = True
                task.n_preemptions += 1
                task.state = TaskState.PREEMPTED
                free_at = now + extra + lat
            task.last_wake = now     # before insert: the queue snapshots it
            ready.append(task)
            running = None
            run_gen += 1
            busy_until = free_at
            log(now, f"preempt-{mech.value}", task.tid)
            bus.preempt(now, task, 0, mech.value)
            return free_at

        def sync_running(now: float):
            """Fold elapsed run time into Time_executed so policy decisions
            see fresh remaining-time estimates (completion time invariant)."""
            nonlocal run_start
            if running is not None and now > run_start:
                running.executed += now - run_start
                run_start = now

        def schedule(now: float):
            """The two-step procedure (§V-C): ask the shared arbiter for a
            decision, then execute it on the virtual clock."""
            if not ready:
                return
            sync_running(now)
            d = arbiter.decide(ready, now, running, busy_until)
            if d.action is Action.START:
                ready.remove(d.cand)
                start(d.cand, max(now, busy_until))
            elif d.action is Action.BUSY:
                push(busy_until, "quantum")  # retry when NPU frees up
            elif d.action is Action.DRAIN:
                # let the running task finish; re-evaluated at every wake
                log(now, "drain", running.tid)
            elif d.action is Action.PREEMPT:
                free_at = preempt(now, d.mechanism)
                ready.remove(d.cand)
                start(d.cand, free_at)
            # IDLE / KEEP / DEFER: nothing to execute this wake-up

        # ---------------- main loop ----------------
        try:
            while events:
                now, _, kind, tid, gen = heapq.heappop(events)
                if kind == "arrival":
                    task = by_id[tid]
                    pending_arrivals.discard(tid)
                    if not event_hooks.offer(bus, admission, task, now,
                                             len(ready)):
                        if tid in pending_arrivals:
                            pass   # a drop hook already re-offered it
                        else:
                            task.state = TaskState.DROPPED
                            n_settled += 1
                    else:
                        task.last_wake = now
                        ready.append(task)
                        log(now, "arrival", tid)
                        schedule(now)
                        ensure_quantum(now)
                elif kind == "complete":
                    if (running is None or running.tid != tid
                            or gen != run_gen):
                        continue  # stale
                    task = running
                    task.executed = task.isolated_time
                    task.completion = now
                    task.state = TaskState.DONE
                    n_settled += 1
                    running = None
                    log(now, "complete", tid)
                    bus.complete(now, task, 0)
                    schedule(now)
                    if ready:
                        ensure_quantum(now)
                elif kind == "quantum":
                    next_quantum = None
                    if ready or running is not None:
                        schedule(now)
                        if ready:
                            ensure_quantum(now)
                if n_settled == len(by_id) and not events:
                    break
        finally:
            self._inject = None   # dead runs must not accept submissions
        settled = (TaskState.DONE, TaskState.DROPPED)
        assert all(t.state in settled for t in by_id.values()), (
            f"unfinished tasks: "
            f"{[t.tid for t in by_id.values() if t.state not in settled]}")
        return list(by_id.values())
