# Copied from src/repro/core/cluster.py; `repro.` rewritten to `repro_torch.`.
"""Multi-NPU cluster scheduling: N preemptible devices, one global queue.

The paper evaluates PREMA on a single NPU; production serving schedules
across fleets of accelerators (multi-tenant multi-accelerator systems,
arXiv:2404.08950).  This module scales the same scheduling core
(``core/arbiter.py``) to an N-device cluster:

* :class:`DeviceState` — per-device running slot, switch-overhead busy
  window, accumulated service time (utilization accounting), its own
  :class:`~repro_torch.hw.HardwareModel`, and an alive window
  (``alive_since``/``alive_until``) for elastic capacity;
* :class:`Cluster` — the device set plus a pluggable *placement* policy
  that maps a selected task onto a concrete device;
* :class:`ClusterSimulator` — the event-driven N-device generalization of
  :class:`~repro_torch.core.simulator.NPUSimulator`; with ``n_devices=1`` it is
  bit-identical to the single-NPU loop (tests/test_cluster.py).

Heterogeneity
-------------
``ClusterConfig(device_hw=[...])`` gives each device its own hardware
model.  Task service times stay expressed on the cluster's *reference*
hardware; each device carries a ``speed`` factor derived through the same
Algorithm-1 latency model the predictor trusts
(:func:`repro_torch.core.predictor.relative_speed`), and the simulator dilates
execution, preemption-cost, and victim-ranking estimates by it.  A
homogeneous cluster has ``speed == 1.0`` everywhere and reproduces the
historical math bit-exactly.

Elasticity
----------
Devices can join and leave mid-run: ``add_device`` (schedulable after
``provision_latency``), ``drain_device`` (stop placing; residents either
finish or are checkpoint-migrated away over the existing
``migration_latency`` path), and ``remove_device`` (drain, then leave for
good once idle).  Each transition emits a ``device_up`` /
``device_drain`` / ``device_down`` event on the shared bus, which is what
``core/autoscaler.py`` subscribes to.  Per-device alive windows feed the
``capacity_seconds`` normalization in ``metrics.cluster_summary``.

Failures
--------
``ClusterConfig(faults=FaultInjector(...))`` injects device crashes
(``core/faults.py``): deterministic per-device MTBF/MTTR processes and
scripted fail-at instants drive ``device_fail`` / ``device_recover``
events on the shared bus.  A failed device contributes zero capacity
(not placeable, never a preemption victim) until repaired; its in-flight
task loses all progress since its last durable checkpoint and is
re-queued — resuming over the normal restore/migration path when a
checkpoint exists, restarting from scratch (KILL-style,
``Task.n_crashes``) when none does.  Lost progress accumulates in
``Task.lost_work``; per-device downtime feeds the ``availability``
metric.  ``remove_device(dev, drain=False)`` is the *unplanned* removal
(an operator yanking a device): the resident takes the same explicit
loss/re-queue path instead of being silently dropped.  Mid-run
``fail_device`` / ``recover_device`` hooks let tests and reactive
subsystems crash a device from any event-bus callback.  A run with no
injector (or an inert one) is bit-identical to the pre-fault code path
(tests/test_fastpath_parity.py).

Placement policies
------------------
``least_loaded``  pick the free device with the least accumulated busy
                  time per alive second (classic load balancing,
                  re-normalized over unequal device lifetimes).
``affinity``      prefer (1) the device holding the task's checkpoint —
                  resuming elsewhere pays the cross-device
                  :func:`~repro_torch.core.preemption.migration_latency` — then
                  (2) a device that last ran the same model (weights
                  warm), falling back to least-loaded.
``speed_aware``   interactive-priority tasks go to the fastest free
                  device; everything else balances load (heterogeneous
                  clusters).
``random``        uniform-random free device (baseline).

Scheduling works on a *global* ready queue: at every wake-up the policy
selects a candidate exactly as on one NPU, then placement chooses the
device; if no device is free, the arbiter considers preempting the
running task with the longest device-relative remaining work (per-device
``may_preempt`` + Algorithm-3 mechanism choice + KILL progress guarantee,
all shared with the single-device path).
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

import operator

from repro_torch.core import events as event_hooks
from repro_torch.core import metrics, preemption
from repro_torch.core import scheduler as _sched
from repro_torch.core.arbiter import Action, Arbiter, remaining_cost
from repro_torch.core.faults import FaultInjector
from repro_torch.core.predictor import relative_speed
from repro_torch.core.preemption import Mechanism
from repro_torch.core.ready_queue import make_ready
from repro_torch.core.registry import Registry
from repro_torch.core.scheduler import Policy
from repro_torch.core.simulator import SimConfig, tile_roundup
from repro_torch.core.task import Task, TaskState
from repro_torch.hw import HardwareModel

# Policies whose arbitration logic the hot loop may inline.  Exact types
# only: a subclass overriding may_preempt must flow through the generic
# Arbiter.arbitrate path.
_EXACT_POLICIES = (_sched.FCFS, _sched.RoundRobin, _sched.HPF, _sched.SJF,
                   _sched.TokenFCFS, _sched.PREMA)
_dev_order = operator.attrgetter("dev")

PLACEMENT_NAMES = ("least_loaded", "affinity", "speed_aware", "random")

# Priority level treated as "interactive" by speed-aware placement (the
# paper's high-priority token weight).
INTERACTIVE_PRIORITY = 9

# Disaggregated-pool roles: a "prefill" device only hosts jobs in their
# prefill phase, a "decode" device only decoding jobs, "any" hosts both.
POOL_ROLES = ("any", "prefill", "decode")


def role_accepts(role: str, phase: Optional[str]) -> bool:
    """Whether a device pool role may host a job in ``phase``.

    ``phase`` is ``"prefill"``/``"decode"`` on the batched serving path
    and ``None`` on the whole-task path (which every role accepts — the
    task carries no phase, so pools are meaningless there).
    """
    return role == "any" or phase is None or role == phase


@dataclasses.dataclass
class DeviceState:
    """One NPU's slot in the cluster.

    ``batch_slots``/``residents``/``role`` generalize the single
    ``running`` task to a vector of co-resident batch slots (continuous
    batching, ``serving/engine.py``); the whole-device simulators keep
    using ``running`` alone, and a default-constructed device
    (``batch_slots == 1``, ``role == "any"``) behaves bit-identically to
    the pre-batching cluster core.
    """
    dev: int
    hw: Optional[HardwareModel] = None  # None -> the cluster's reference hw
    speed: float = 1.0            # wall time = reference time / speed
    running: Optional[Task] = None
    run_start: float = 0.0        # start of the current execution segment
    run_gen: int = 0              # invalidates stale completion events
    busy_until: float = 0.0       # switch-overhead window (non-preemptible)
    busy_time: float = 0.0        # accumulated service seconds
    last_model: Optional[str] = None
    # ---- continuous batching (serving/engine.py batched path) ----
    role: str = "any"             # pool membership (POOL_ROLES)
    batch_slots: int = 1          # concurrent residents the device admits
    residents: List[Optional[Task]] = dataclasses.field(
        default_factory=list)     # slot -> resident (batched path only)
    # ---- elastic lifecycle ----
    added_at: float = 0.0         # ordered at (provisioning is paid for)
    alive_since: float = 0.0      # schedulable from here (post-provision)
    alive_until: Optional[float] = None   # set on removal (device_down)
    draining: bool = False        # no new placements
    remove_pending: bool = False  # leave the cluster once idle
    # ---- failure state (core/faults.py) ----
    failed: bool = False          # crashed: zero capacity until repaired
    failed_at: Optional[float] = None     # start of the open failure window
    downtime: float = 0.0         # closed failure windows, seconds

    @property
    def alive(self) -> bool:
        """Whether the device is still a cluster member."""
        return self.alive_until is None

    def schedulable(self, now: float) -> bool:
        """Whether new placements may land here at ``now``."""
        return (self.alive and not self.draining and not self.failed
                and now + 1e-15 >= self.alive_since)

    def capacity_seconds(self, until: float) -> float:
        """Paid-for seconds inside ``[0, until]`` — the device's share of
        the cluster's capacity normalization.  Charged from ``added_at``:
        a provisioning device is capacity the operator is already paying
        for, even though it cannot run work yet."""
        end = until if self.alive_until is None else min(self.alive_until,
                                                         until)
        return max(0.0, end - min(self.added_at, until))

    def downtime_seconds(self, until: float) -> float:
        """Failed seconds inside ``[0, until]`` (an open failure window is
        charged up to ``until`` or removal, whichever is first) — feeds
        the ``availability`` metric in ``metrics.cluster_health``."""
        down = self.downtime
        if self.failed and self.failed_at is not None:
            end = until if self.alive_until is None else min(self.alive_until,
                                                             until)
            down += max(0.0, min(end, until) - self.failed_at)
        return down

    # ---- batch-slot helpers (batched serving path) ----
    @property
    def n_resident(self) -> int:
        """Occupied batch slots (always 0 on the whole-device path, which
        tracks its single resident in ``running`` instead)."""
        return sum(1 for r in self.residents if r is not None)

    def free_slot(self) -> Optional[int]:
        """Lowest free slot index, or None when all ``batch_slots`` are
        occupied.  The residents vector grows lazily up to
        ``batch_slots`` so single-resident devices stay allocation-free.
        """
        for i, r in enumerate(self.residents):
            if r is None:
                return i
        if len(self.residents) < self.batch_slots:
            self.residents.append(None)
            return len(self.residents) - 1
        return None


def _alive_seconds(d: DeviceState, now: float) -> float:
    return max(now - d.alive_since, 1e-12)


def _least_loaded(free: List[DeviceState], now: float) -> DeviceState:
    # busy time per alive second: devices that joined late are compared at
    # equal footing with founders (equal lifetimes reduce to raw busy time)
    return min(free, key=lambda d: (d.busy_time / _alive_seconds(d, now),
                                    d.dev))


def place_least_loaded(task: Task, free: List[DeviceState],
                       rng: np.random.Generator, now: float) -> DeviceState:
    """Lowest busy-time-per-alive-second device wins."""
    return _least_loaded(free, now)


def place_affinity(task: Task, free: List[DeviceState],
                   rng: np.random.Generator, now: float) -> DeviceState:
    """Prefer the checkpoint's home device, then model-warm devices —
    avoids paying cross-device migration and cold-model switch costs."""
    if task.restore_pending and task.device is not None:
        home = [d for d in free if d.dev == task.device]
        if home:
            return home[0]
    warm = [d for d in free if d.last_model == task.model]
    if warm:
        return _least_loaded(warm, now)
    return _least_loaded(free, now)


def place_speed_aware(task: Task, free: List[DeviceState],
                      rng: np.random.Generator, now: float) -> DeviceState:
    """Interactive-priority work goes to the fastest free device (ties
    broken least-loaded); the rest balances load over the live set.

    Pool-role aware: when the task carries a ``phase`` (batched serving
    path) and a role-specialized device matching it is free, the
    specialized pool wins over ``"any"`` devices — generalists are kept
    free for the phase the specialized pools cannot host.
    """
    phase = getattr(task, "phase", None)
    if phase is not None:
        exact = [d for d in free if d.role == phase]
        if exact:
            free = exact
    if task.priority >= INTERACTIVE_PRIORITY:
        top = max(d.speed for d in free)
        return _least_loaded([d for d in free if d.speed == top], now)
    return _least_loaded(free, now)


def place_random(task: Task, free: List[DeviceState],
                 rng: np.random.Generator, now: float) -> DeviceState:
    """Uniform choice over free devices (the seeded baseline)."""
    return free[int(rng.integers(len(free)))]


_REGISTRY = Registry("placement")
_REGISTRY.register("least_loaded", place_least_loaded)
_REGISTRY.register("affinity", place_affinity)
_REGISTRY.register("speed_aware", place_speed_aware)
_REGISTRY.register("random", place_random)


def make_placement(name: str):
    """Look up a placement function by name (``PLACEMENT_NAMES``)."""
    return _REGISTRY.get(name)


class Cluster:
    """Device set + placement; shared by the cluster simulator and the
    serving engine (which keeps its own job slots but reuses the placement,
    lifecycle, and utilization bookkeeping)."""

    def __init__(self, n_devices: int, placement: str = "least_loaded",
                 seed: int = 0, base_hw: Optional[HardwareModel] = None,
                 device_hw: Optional[Sequence[HardwareModel]] = None,
                 device_roles: Optional[Sequence[str]] = None,
                 batch_slots: int = 1):
        """``device_roles`` assigns each device a pool role from
        ``POOL_ROLES`` (prefill/decode disaggregation; defaults to
        ``"any"`` everywhere), ``batch_slots`` the number of concurrent
        residents every device admits on the batched serving path.  Both
        default to the whole-device configuration the simulators use."""
        if device_hw is not None and len(device_hw) > 0:
            n_devices = len(device_hw)
        if device_roles is not None and len(device_roles) > 0:
            bad = [r for r in device_roles if r not in POOL_ROLES]
            if bad:
                raise ValueError(f"unknown pool roles {bad!r}; "
                                 f"choose from {POOL_ROLES}")
            if device_hw is None:
                n_devices = len(device_roles)
            elif len(device_roles) != n_devices:
                raise ValueError("device_roles and device_hw lengths differ")
        if n_devices < 1:
            raise ValueError("n_devices must be >= 1")
        if batch_slots < 1:
            raise ValueError("batch_slots must be >= 1")
        self.base_hw = base_hw
        self.batch_slots = int(batch_slots)
        self.devices: List[DeviceState] = []
        for d in range(n_devices):
            hw = device_hw[d] if device_hw else None
            role = device_roles[d] if device_roles else "any"
            self.devices.append(self._make_device(d, hw, role=role))
        self.placement_name = placement
        self._place = make_placement(placement)
        self.rng = np.random.default_rng(seed)
        self.n_migrations = 0
        self.n_scale_ups = 0
        self.n_scale_downs = 0
        self.n_failures = 0

    def _make_device(self, dev: int, hw: Optional[HardwareModel],
                     added_at: float = 0.0, alive_since: float = 0.0,
                     role: str = "any") -> DeviceState:
        speed = 1.0
        if hw is not None and self.base_hw is not None:
            speed = relative_speed(hw, self.base_hw)
        return DeviceState(dev, hw=hw, speed=speed, added_at=added_at,
                           alive_since=alive_since, busy_until=alive_since,
                           role=role, batch_slots=self.batch_slots)

    @property
    def n_devices(self) -> int:
        """Total devices ever added, including removed/failed ones."""
        return len(self.devices)

    @property
    def n_alive(self) -> int:
        """Devices that can take new placements now or soon: alive, not
        draining, not failed (a still-provisioning device counts, so an
        autoscaler does not double-order capacity it already paid for)."""
        return sum(1 for d in self.devices
                   if d.alive and not d.draining and not d.failed)

    def free(self, now: float) -> List[DeviceState]:
        """Devices that can start a task at ``now`` (whole-device path)."""
        return [d for d in self.devices
                if d.schedulable(now) and d.running is None
                and now >= d.busy_until]

    def free_for(self, now: float, phase: Optional[str]) -> List[DeviceState]:
        """Devices with a spare batch slot at ``now`` whose pool role
        accepts a job in ``phase`` (batched path analogue of ``free``)."""
        return [d for d in self.devices
                if d.schedulable(now) and role_accepts(d.role, phase)
                and d.n_resident < d.batch_slots and now >= d.busy_until]

    def choose(self, task: Task, free: List[DeviceState],
               now: float = 0.0) -> DeviceState:
        """Pick a device for ``task`` via the configured placement."""
        return self._place(task, free, self.rng, now)

    def busy_times(self) -> List[float]:
        """Accumulated service seconds per device."""
        return [d.busy_time for d in self.devices]

    def capacity_seconds(self, until: float) -> List[float]:
        """Paid-for seconds per device inside ``[0, until]``."""
        return [d.capacity_seconds(until) for d in self.devices]

    def downtime_seconds(self, until: float) -> List[float]:
        """Failed seconds per device inside ``[0, until]``."""
        return [d.downtime_seconds(until) for d in self.devices]

    # ---- elastic transitions (event emission is the caller's job) ----
    def add_device(self, now: float, hw: Optional[HardwareModel] = None,
                   provision_latency: float = 0.0,
                   role: str = "any") -> DeviceState:
        """Join a device (schedulable after ``provision_latency``);
        ``role`` assigns it to a pool on the batched serving path."""
        if role not in POOL_ROLES:
            raise ValueError(f"unknown pool role {role!r}; "
                             f"choose from {POOL_ROLES}")
        d = self._make_device(len(self.devices), hw, added_at=now,
                              alive_since=now + provision_latency,
                              role=role)
        self.devices.append(d)
        self.n_scale_ups += 1
        return d

    def drain_device(self, dev: int) -> DeviceState:
        """Stop placements on ``dev`` (residents are the caller's job)."""
        d = self.devices[dev]
        d.draining = True
        return d

    def remove_device(self, dev: int, now: float) -> DeviceState:
        """Take an idle, drained ``dev`` out of the cluster at ``now``."""
        d = self.devices[dev]
        if d.running is not None:
            raise RuntimeError(f"device {dev} still has a resident task; "
                               "drain it first")
        d.draining = True
        d.remove_pending = False
        d.alive_until = now
        self.n_scale_downs += 1
        return d


@dataclasses.dataclass
class ClusterConfig(SimConfig):
    """Cluster knobs on top of SimConfig: size, placement, elasticity."""

    n_devices: int = 1
    placement: str = "least_loaded"
    placement_seed: int = 0
    # Heterogeneity: one HardwareModel per device (overrides n_devices).
    device_hw: Optional[Sequence[HardwareModel]] = None
    # Elasticity: delay before an added device becomes schedulable, and
    # what to do with residents of a draining device ("migrate" preempts
    # them over the checkpoint/migration path, "finish" lets them run out).
    provision_latency: float = 0.0
    drain: str = "migrate"
    # Failure injection: a FaultInjector drives device_fail/device_recover
    # (None or an inert injector keeps the run bit-identical to the
    # pre-fault code path).
    faults: Optional[FaultInjector] = None


class ClusterSimulator:
    """Event-driven N-device generalization of ``NPUSimulator``.

    Same event kinds (arrival / completion / scheduling quantum), same
    arbiter; completions carry the device index.  After ``run`` the
    ``cluster`` attribute exposes per-device busy time and alive windows
    for utilization metrics, and :meth:`summary` reports cluster-level
    metrics (``metrics.cluster_summary``).

    Elastic capacity: :meth:`add_device`, :meth:`drain_device`, and
    :meth:`remove_device` are valid *during* ``run()`` (call them from an
    event-bus hook, e.g. ``core/autoscaler.py``); they emit
    ``device_up``/``device_drain``/``device_down`` events.
    """

    def __init__(self, hw: HardwareModel, policy: Policy,
                 cfg: Optional[ClusterConfig] = None):
        self.hw = hw
        self.policy = policy
        self.cfg = cfg or ClusterConfig()
        self.arbiter = Arbiter(policy, self.cfg.arbiter_config())
        self.cluster = self._make_cluster()
        self.log: List[Tuple[float, str, int, int]] = []
        self._tasks: List[Task] = []
        self._inject = None          # live only inside run()
        self._elastic = None         # (add, drain, remove) hooks inside run()

    def _make_cluster(self) -> Cluster:
        return Cluster(self.cfg.n_devices, self.cfg.placement,
                       self.cfg.placement_seed, base_hw=self.hw,
                       device_hw=self.cfg.device_hw)

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

    # ---- elastic capacity (valid during run(), from event hooks) -----
    def _elastic_hooks(self):
        if self._elastic is None:
            raise RuntimeError("elastic capacity changes are only valid "
                               "during run() — call from an event-bus hook")
        return self._elastic

    def add_device(self, hw: Optional[HardwareModel] = None) -> int:
        """Scale up: join a device (schedulable after the configured
        ``provision_latency``); returns its index."""
        return self._elastic_hooks()[0](hw)

    def drain_device(self, dev: int) -> None:
        """Stop placing on ``dev``; residents migrate or finish per
        ``cfg.drain``.  The device stays alive (it still counts toward
        capacity) until removed."""
        self._elastic_hooks()[1](dev, False)

    def remove_device(self, dev: int, drain: bool = True) -> None:
        """Scale down.  ``drain=True`` (planned removal): stop placements
        and leave once idle; residents migrate or finish per ``cfg.drain``.
        ``drain=False`` (unplanned): yank the device *now* — the resident
        loses its un-checkpointed progress and is explicitly re-queued
        over the crash path (``Task.lost_work``/``n_crashes``), never
        silently dropped."""
        if drain:
            self._elastic_hooks()[1](dev, True)
        else:
            self._elastic_hooks()[2](dev)

    # ---- failures (valid during run(), from event hooks) -------------
    def fail_device(self, dev: int) -> None:
        """Crash ``dev`` now: the resident loses un-checkpointed progress
        and is re-queued; the device contributes zero capacity until
        :meth:`recover_device` (or an injector-scheduled repair)."""
        self._elastic_hooks()[3](dev)

    def recover_device(self, dev: int) -> None:
        """Repair a failed device; it becomes placeable again."""
        self._elastic_hooks()[4](dev)

    @property
    def n_alive_devices(self) -> int:
        """Placeable devices right now (see ``Cluster.n_alive``)."""
        return self.cluster.n_alive

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
        self.log = []
        self.cluster = self._make_cluster()
        devices = self.cluster.devices   # mutated in place by add_device
        counter = itertools.count()
        events: List[Tuple[float, int, str, int, int, int]] = []

        def push(t, kind, tid=-1, gen=0, dev=-1):
            heapq.heappush(events, (t, next(counter), kind, tid, gen, dev))

        by_id: Dict[int, Task] = {t.tid: t for t in tasks}
        for t in tasks:
            t.state = TaskState.WAITING
            t.device = None
            push(t.arrival, "arrival", t.tid)

        pending_arrivals: set = set()   # injected tids not yet offered

        def inject(task: Task, at: float):
            nonlocal n_settled
            at = float(at)
            if (task.tid in by_id and task.tid not in pending_arrivals
                    and task.state in (TaskState.DONE, TaskState.DROPPED)):
                # re-offer of a settled logical task (client retry): it is
                # outstanding again, so un-count it — one task, many
                # attempts, n_settled stays exact
                n_settled -= 1
            task.state = TaskState.WAITING
            task.device = None
            task.arrival = at
            task.last_wake = at
            by_id[task.tid] = task
            pending_arrivals.add(task.tid)
            push(at, "arrival", task.tid)
        self._inject = inject

        # Indexed ready set (core/ready_queue.py): heap-backed selection
        # for built-in policies, list-compatible iteration otherwise.
        ready = make_ready(self.policy.name)
        next_quantum = None
        n_settled = 0            # DONE + DROPPED
        retry_pending: set = set()

        # ---- incremental device indexes (hot-path state) -------------
        # idle: placement-eligible membership (alive, not draining,
        # nothing resident) keyed by device index — the time conditions
        # (busy_until switch windows, alive_since provisioning) are
        # checked at use.  busy: devices with a resident task.  drainish:
        # draining-but-alive devices, kept in device order so drain
        # servicing walks them exactly like the historical full scan.
        idle: Dict[int, DeviceState] = {d.dev: d for d in devices}
        busy: Dict[int, DeviceState] = {}
        drainish: List[DeviceState] = []

        def push_retry(t):
            # deduped wake-up at a known future instant (end of a switch
            # overhead / provisioning window).  Without the dedup every
            # schedule() call during the window stacks another event at
            # the same time, and each of those calls schedule() again —
            # a quadratic event storm on elastic runs.
            if t not in retry_pending:
                retry_pending.add(t)
                push(t, "retry")

        def log(t, kind, tid, dev=-1):
            if cfg.log_events:
                self.log.append((t, kind, tid, dev))

        def ensure_quantum(now):
            nonlocal next_quantum
            if next_quantum is None or next_quantum <= now:
                next_quantum = now + cfg.quantum
                push(next_quantum, "quantum")

        def dev_hw(d: DeviceState) -> HardwareModel:
            return d.hw if d.hw is not None else hw

        def start(d: DeviceState, task: Task, now: float) -> float:
            t0 = now
            if task.restore_pending:
                lat = preemption.restore_latency(task, dev_hw(d))
                if task.device is not None and task.device != d.dev:
                    # checkpoint lives on another chip: pay the transfer
                    lat += preemption.migration_latency(task, dev_hw(d))
                    self.cluster.n_migrations += 1
                task.checkpoint_overhead += lat
                task.restore_pending = False
                t0 += lat
            d.running = task
            idle.pop(d.dev, None)
            busy[d.dev] = d
            task.state = TaskState.RUNNING
            task.device = d.dev
            d.last_model = task.model
            if task.first_service is None:
                task.first_service = t0
            d.run_start = t0
            d.run_gen += 1
            d.busy_until = t0
            push(t0 + task.remaining / d.speed, "complete", task.tid,
                 d.run_gen, d.dev)
            log(now, "start", task.tid, d.dev)
            bus.dispatch(now, task, d.dev)
            return t0

        def preempt(d: DeviceState, now: float, mech: Mechanism) -> float:
            task = d.running
            assert task is not None
            # progress and tile geometry live in reference-hardware seconds;
            # the wall clock advances at 1/speed of them on this device
            elapsed = max(0.0, now - d.run_start) * d.speed
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
                d.busy_time += (elapsed + extra) / d.speed
                lat = preemption.checkpoint_latency(task, dev_hw(d))
                task.checkpoint_overhead += lat
                task.restore_pending = True
                task.n_preemptions += 1
                task.state = TaskState.PREEMPTED
                free_at = now + extra / d.speed + lat
            task.last_wake = now     # before insert: the queue snapshots it
            ready.append(task)
            d.running = None
            busy.pop(d.dev, None)
            if d.alive and not d.draining:
                idle[d.dev] = d
            d.run_gen += 1
            d.busy_until = free_at
            log(now, f"preempt-{mech.value}", task.tid, d.dev)
            bus.preempt(now, task, d.dev, mech.value)
            return free_at

        def sync_running(now: float):
            # per-device accounting is independent, so walking the busy
            # index (insertion order) matches the historical device-order
            # scan bit-for-bit
            for d in busy.values():
                if now > d.run_start:
                    dt = now - d.run_start
                    d.running.executed += dt * d.speed
                    d.busy_time += dt
                    d.run_start = now

        def settle_drain(d: DeviceState, now: float):
            if not (d.remove_pending and d.alive and d.running is None):
                return
            if now < d.busy_until:
                # its eviction checkpoint is still spilling: the device
                # is occupied (and paid for) until the write lands
                push_retry(d.busy_until)
                return
            self.cluster.remove_device(d.dev, now)
            drainish.remove(d)
            log(now, "device_down", -1, d.dev)
            bus.device_down(now, d.dev)

        def service_drains(now: float):
            # a drain that landed while its resident was inside a
            # restore/switch window deferred the eviction; carry it out
            # as soon as the window ends, and settle removals whose
            # eviction spill has finished (both paths schedule retries)
            if not drainish:
                return
            for d in tuple(drainish):
                if not d.alive:
                    continue
                if (d.running is not None and cfg.drain == "migrate"
                        and now >= d.busy_until):
                    sync_running(now)
                    preempt(d, now, Mechanism.CHECKPOINT)
                settle_drain(d, now)

        # Arbitration constants hoisted out of the hot loop; the inlined
        # branch below reproduces Arbiter.arbitrate (may_preempt gate →
        # Algorithm-3 / static mechanism → KILL progress guarantee) with
        # identical float expressions, and is taken only for the exact
        # built-in policy classes — subclasses keep the generic path.
        pol = arbiter.policy
        pname = pol.name
        inline_arb = type(pol) in _EXACT_POLICIES
        dynamic = cfg.mechanism == "dynamic"
        static_mech = None if dynamic else Mechanism(cfg.mechanism)
        kef, mk = cfg.kill_early_frac, cfg.max_kills
        # only random placement observes the free list's order (and the
        # historical order is by device index); the others reduce with
        # order-independent total-order keys
        order_free = self.cluster.placement_name == "random"

        def schedule(now: float):
            service_drains(now)
            if not ready:
                return
            sync_running(now)
            arbiter.wake(ready, now)
            while ready:
                cand = arbiter.pick(ready, now, None)
                if cand is None:
                    return
                free = [d for d in idle.values()
                        if now >= d.busy_until
                        and now + 1e-15 >= d.alive_since]
                if free:
                    if order_free and len(free) > 1:
                        free.sort(key=_dev_order)
                    d = self.cluster.choose(cand, free, now)
                    ready.remove(cand)
                    start(d, cand, now)
                    if len(free) > 1 and ready:
                        continue  # fill remaining free devices this wake
                    return
                if idle:
                    # idle-but-not-free: inside switch-overhead windows
                    # (wait for the chip rather than displacing another —
                    # historical behavior) or still provisioning (wake at
                    # alive_since, but a not-yet-alive device must not
                    # suppress preemption: the scale-up fired *because*
                    # of overload)
                    switching = provisioning = None
                    for d in idle.values():
                        if now >= d.alive_since:
                            if switching is None or d.busy_until < switching:
                                switching = d.busy_until
                        elif (provisioning is None
                                or d.alive_since < provisioning):
                            provisioning = d.alive_since
                    if provisioning is not None:
                        push_retry(provisioning)
                    if switching is not None:
                        push_retry(switching)
                        return
                if not pol.preemptive:
                    return
                # every placeable device is running: consider displacing the
                # victim with the longest device-relative remaining work
                victims = []
                for d in busy.values():
                    if (d.draining or d.alive_until is not None
                            or now + 1e-15 < d.alive_since
                            or now < d.busy_until):
                        continue
                    t = d.running
                    rem = t.predicted_total - t.executed
                    if rem < 0.0:
                        rem = 0.0
                    spd = d.speed
                    victims.append(
                        (-(rem / (spd if spd > 1e-12 else 1e-12)), d.dev, d))
                victims.sort()
                if not inline_arb:
                    for _, _, d in victims:
                        dec = arbiter.arbitrate(d.running, cand)
                        if dec.action is Action.PREEMPT:
                            free_at = preempt(d, now, dec.mechanism)
                            ready.remove(cand)
                            start(d, cand, free_at)
                            return
                        if dec.action is Action.DRAIN:
                            log(now, "drain", d.running.tid, d.dev)
                    return
                c_rem = cand.predicted_total - cand.executed
                if c_rem < 0.0:
                    c_rem = 0.0
                c_dn = (cand.predicted_total
                        if cand.predicted_total > 1e-12 else 1e-12)
                for _, _, d in victims:
                    r = d.running
                    # ---- Policy.may_preempt, inlined per builtin ----
                    if pname == "prema":
                        if dynamic:
                            may = True
                        else:
                            r_rem = r.predicted_total - r.executed
                            may = c_rem < (r_rem if r_rem > 0.0 else 0.0)
                    elif pname == "fcfs":
                        may = cand.arrival < r.arrival
                    elif pname == "hpf":
                        may = cand.priority > r.priority
                    elif pname == "sjf":
                        r_rem = r.predicted_total - r.executed
                        may = c_rem < (r_rem if r_rem > 0.0 else 0.0)
                    elif pname == "token":
                        may = cand.tokens > r.tokens
                    else:            # rrb
                        may = True
                    if not may:
                        continue     # KEEP: try the next victim
                    if dynamic:
                        # Algorithm 3 (preemption.select_mechanism)
                        r_dn = (r.predicted_total
                                if r.predicted_total > 1e-12 else 1e-12)
                        r_rem = r.predicted_total - r.executed
                        if r_rem < 0.0:
                            r_rem = 0.0
                        if c_rem / r_dn > r_rem / c_dn:
                            log(now, "drain", r.tid, d.dev)
                            continue
                        mech = Mechanism.CHECKPOINT
                    else:
                        mech = static_mech
                        if mech is Mechanism.DRAIN:
                            log(now, "drain", r.tid, d.dev)
                            continue
                        if mech is Mechanism.KILL:
                            lim = (r.predicted_total
                                   if r.predicted_total > 1e-12 else 1e-12)
                            if not (r.executed <= kef * lim
                                    and r.n_kills < mk):
                                continue   # DEFER: progress guarantee
                    free_at = preempt(d, now, mech)
                    ready.remove(cand)
                    start(d, cand, free_at)
                    return
                return

        # ---- elastic hooks (live only inside run) --------------------
        clock = 0.0              # last event time: "now" for hook calls

        def add_dev(new_hw: Optional[HardwareModel]) -> int:
            d = self.cluster.add_device(clock, hw=new_hw,
                                        provision_latency=cfg.provision_latency)
            log(clock, "device_up", -1, d.dev)
            bus.device_up(clock, d.dev)
            idle[d.dev] = d
            push_retry(d.alive_since)        # wake when it comes online
            arm_failure(d.dev, clock)        # replacements can fail too
            return d.dev

        def drain_dev(dev: int, remove: bool) -> None:
            d = devices[dev]
            if not d.alive or (d.draining and not remove):
                return
            if not d.draining:
                d.draining = True
                idle.pop(d.dev, None)
                drainish.append(d)
                drainish.sort(key=_dev_order)
                log(clock, "device_drain", -1, d.dev)
                bus.device_drain(clock, d.dev)
                if d.running is not None and cfg.drain == "migrate":
                    if clock >= d.busy_until:
                        sync_running(clock)
                        preempt(d, clock, Mechanism.CHECKPOINT)
                        push_retry(d.busy_until)    # re-place the evictee
                    else:
                        # resident is inside a restore/switch window: the
                        # retry drives migrate_drains once it ends
                        push_retry(d.busy_until)
            d.remove_pending = d.remove_pending or remove
            settle_drain(d, clock)

        # ---- failure injection (core/faults.py) ----------------------
        injector = cfg.faults if (cfg.faults is not None
                                  and cfg.faults.active) else None
        # per-device arming generation: a pending stochastic "fail" heap
        # event is valid only while its generation is current, so a
        # scripted/manual crash-and-repair cycle cannot leave a stale
        # second failure in flight for the same stream
        fail_arm: Dict[int, int] = {}

        def arm_failure(dev: int, at: float):
            if injector is None:
                return
            t = injector.next_failure(dev, at)
            if t is not None:
                g = fail_arm.get(dev, 0) + 1
                fail_arm[dev] = g
                push(t, "fail", gen=g, dev=dev)

        def work_outstanding() -> bool:
            # inject() keeps n_settled exact across client retries, so
            # this is "some logical task is not DONE/DROPPED right now"
            return n_settled < len(by_id)

        def crash_resident(d: DeviceState, now: float):
            # the in-flight task loses everything since its last durable
            # checkpoint (snapshots are spilled off-device, so they
            # survive the crash) and is re-queued; the device keeps its
            # busy_time — it did spin, the work is just lost
            task = d.running
            if task is None:
                return
            sync_running(now)
            task.lost_work += max(0.0, task.executed - task.ckpt_executed)
            task.n_crashes += 1
            if task.ckpt_executed > 0.0:
                task.executed = task.ckpt_executed
                task.restore_pending = True
                task.state = TaskState.PREEMPTED
            else:
                task.reset_progress()        # KILL-style restart
                task.state = TaskState.WAITING
            task.last_wake = now
            ready.append(task)
            d.running = None
            busy.pop(d.dev, None)
            d.run_gen += 1                   # invalidate its completion
            d.busy_until = now
            log(now, "task_lost", task.tid, d.dev)

        def do_fail(dev: int, now: float, scripted: bool) -> bool:
            d = devices[dev] if 0 <= dev < len(devices) else None
            if d is None or not d.alive or d.failed:
                return False
            crash_resident(d, now)
            d.failed = True
            d.failed_at = now
            idle.pop(dev, None)
            self.cluster.n_failures += 1
            log(now, "device_fail", -1, dev)
            bus.device_fail(now, dev)
            # stochastic failures always heal through the MTTR process
            # (instantly when mttr == 0: a transient blip); a scripted or
            # manual crash heals only through mttr > 0, a scripted
            # recover, or recover_device — otherwise it is permanent
            if injector is not None and (not scripted or injector.mttr > 0):
                push(injector.repair_at(dev, now), "recover", dev=dev)
            return True

        def do_recover(dev: int, now: float) -> bool:
            d = devices[dev] if 0 <= dev < len(devices) else None
            if d is None or not d.alive or not d.failed:
                return False
            if d.failed_at is not None:
                d.downtime += max(0.0, now - d.failed_at)
            d.failed = False
            d.failed_at = None
            if not d.draining and d.running is None:
                idle[dev] = d
            d.busy_until = max(d.busy_until, now)
            log(now, "device_recover", -1, dev)
            bus.device_recover(now, dev)
            if work_outstanding():
                arm_failure(dev, now)        # the stream continues
            return True

        def unplug_dev(dev: int) -> None:
            # unplanned removal: same explicit loss/re-queue path as a
            # crash, then the device leaves the cluster for good
            d = devices[dev]
            if not d.alive:
                return
            if d.failed:
                # close the open failure window before the ledger freezes
                if d.failed_at is not None:
                    d.downtime += max(0.0, clock - d.failed_at)
                d.failed = False
                d.failed_at = None
            crash_resident(d, clock)
            idle.pop(dev, None)
            if d in drainish:
                drainish.remove(d)
            self.cluster.remove_device(dev, clock)
            log(clock, "device_down", -1, dev)
            bus.device_down(clock, dev)
            push_retry(clock)                # re-place the evictee

        def fail_dev_hook(dev: int) -> None:
            if do_fail(dev, clock, scripted=True):
                push_retry(clock)            # re-place the evictee

        def recover_dev_hook(dev: int) -> None:
            if do_recover(dev, clock):
                push_retry(clock)            # the queue may drain into it

        self._elastic = (add_dev, drain_dev, unplug_dev,
                         fail_dev_hook, recover_dev_hook)

        if injector is not None:
            injector.reset()
            for st, sk, sdev in injector.scripted():
                push(float(st), "fail" if sk == "fail" else "recover",
                     gen=-1, dev=int(sdev))
            for d in devices:                # device order: deterministic
                arm_failure(d.dev, 0.0)

        # ---------------- main loop ----------------
        try:
            while events:
                now, _, kind, tid, gen, dev = heapq.heappop(events)
                clock = now
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
                    d = devices[dev]
                    if (d.running is None or d.running.tid != tid
                            or gen != d.run_gen):
                        continue  # stale
                    task = d.running
                    d.busy_time += max(0.0, now - d.run_start)
                    task.executed = task.isolated_time
                    task.completion = now
                    task.state = TaskState.DONE
                    n_settled += 1
                    d.running = None
                    busy.pop(dev, None)
                    if d.alive and not d.draining:
                        idle[dev] = d
                    log(now, "complete", tid, dev)
                    bus.complete(now, task, dev)
                    settle_drain(d, now)
                    schedule(now)
                    if ready:
                        ensure_quantum(now)
                elif kind in ("quantum", "retry"):
                    if kind == "quantum":
                        next_quantum = None
                    else:
                        retry_pending.discard(now)
                    if ready or busy:
                        schedule(now)
                        if ready:
                            ensure_quantum(now)
                    else:
                        # no work left, but a pending removal may still be
                        # waiting out its eviction spill
                        service_drains(now)
                elif kind == "fail":
                    # gen >= 0: stochastic stream (valid only while its
                    # arming generation is current); gen == -1: scripted.
                    # Once all work settled, stop the churn so the heap
                    # drains and the run terminates.
                    if gen >= 0 and gen != fail_arm.get(dev):
                        continue
                    if not work_outstanding():
                        continue
                    if do_fail(dev, now, scripted=gen < 0):
                        schedule(now)
                        if ready:
                            ensure_quantum(now)
                elif kind == "recover":
                    if do_recover(dev, now):
                        schedule(now)
                        if ready:
                            ensure_quantum(now)
                if n_settled == len(by_id) and not events:
                    break
        finally:
            self._inject = None   # dead runs must not accept submissions
            self._elastic = None
        settled = (TaskState.DONE, TaskState.DROPPED)
        assert all(t.state in settled for t in by_id.values()), (
            f"unfinished tasks: "
            f"{[t.tid for t in by_id.values() if t.state not in settled]}")
        self._tasks = list(by_id.values())
        return self._tasks

    # ------------------------------------------------------------------
    def summary(self) -> Dict[str, float]:
        """Cluster-level metrics of the last run (STP/ANTT/SLA/util...)."""
        if not self._tasks:
            raise RuntimeError("summary() requires a completed run()")
        done = [t.completion for t in self._tasks if t.completion is not None]
        makespan = max(done) if done else 0.0
        out = metrics.cluster_summary(
            self._tasks, self.cluster.busy_times(), makespan,
            capacity_seconds=self.cluster.capacity_seconds(makespan),
            downtime_seconds=self.cluster.downtime_seconds(makespan))
        out["migrations"] = float(self.cluster.n_migrations)
        out["n_scale_ups"] = float(self.cluster.n_scale_ups)
        out["n_scale_downs"] = float(self.cluster.n_scale_downs)
        out["n_failures"] = float(self.cluster.n_failures)
        return out
