# Copied from src/repro/core/arbiter.py; `repro.` rewritten to `repro_torch.`.
"""Shared scheduling core: the pick → may_preempt → mechanism sequence.

Both execution layers — the event-driven :class:`~repro_torch.core.simulator.
NPUSimulator` / :class:`~repro_torch.core.cluster.ClusterSimulator` (virtual
clock) and the :class:`~repro_torch.serving.engine.ServingEngine` (real JAX
execution) — used to duplicate the same arbitration logic at every
scheduler wake-up.  This module extracts it once:

1. **wake-up** — ``policy.on_wake`` (token accrual for token policies,
   Algorithm 2 line 7) followed by ``policy.select`` over the ready queue;
2. **may_preempt** — whether the candidate is allowed to displace the
   running task, a :meth:`repro_torch.core.scheduler.Policy.may_preempt` method
   (previously a name-string dispatch table);
3. **mechanism choice** — Algorithm 3 (:func:`repro_torch.core.preemption.
   select_mechanism`) when ``mechanism='dynamic'``, else the configured
   static mechanism;
4. **KILL progress guarantee** — a task may be KILLed only in its early
   phase (§IV-C: KILL is only a good trade-off "during the early phases of
   an inference execution") and at most ``max_kills`` times; afterwards
   preemption requests against it are deferred.

The arbiter only *decides*; carrying the decision out (virtual-clock
bookkeeping, tile-boundary round-up, checkpoint spills, KV-cache moves,
real tensor state) stays with the execution layer, which interprets the
returned :class:`Decision`.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional

from repro_torch.core import preemption
from repro_torch.core.events import EventBus
from repro_torch.core.preemption import Mechanism
from repro_torch.core.scheduler import Policy
from repro_torch.core.task import Task


class Action(enum.Enum):
    """What the layer should do with a device at this wake-up."""

    IDLE = "idle"          # no candidate (empty queue or policy abstained)
    START = "start"        # device free: begin/resume the candidate
    BUSY = "busy"          # device inside a switch-overhead window; retry
    KEEP = "keep"          # running task continues (no preemption allowed)
    DRAIN = "drain"        # Algorithm 3 chose DRAIN: let running finish
    DEFER = "defer"        # KILL progress guarantee blocked the switch
    PREEMPT = "preempt"    # displace running via ``decision.mechanism``


@dataclasses.dataclass(frozen=True)
class Decision:
    """One arbiter verdict: the action, its candidate, its mechanism."""

    action: Action
    cand: Optional[Task] = None
    mechanism: Optional[Mechanism] = None


@dataclasses.dataclass
class ArbiterConfig:
    """Mechanism selection + KILL progress-guarantee knobs (shared by the
    simulator's ``SimConfig`` and the serving engine)."""
    mechanism: str = "dynamic"   # checkpoint | kill | drain | dynamic
    kill_early_frac: float = 0.5
    max_kills: int = 4


class Arbiter:
    """One scheduling decision per wake-up, shared by every execution
    layer.  Stateless apart from the policy it wraps; ``reset()`` clears
    policy state (e.g. round-robin position) at the start of a run."""

    def __init__(self, policy: Policy, cfg: Optional[ArbiterConfig] = None,
                 bus: Optional[EventBus] = None):
        self.policy = policy
        self.cfg = cfg or ArbiterConfig()
        # The shared event stream (core/events.py): every execution layer
        # built on this arbiter emits submit/dispatch/preempt/complete/drop
        # through one bus, so observers see one consistent timeline.
        self.events = bus if bus is not None else EventBus()

    # ------------------------------------------------------------------
    def reset(self) -> None:
        """Start-of-run hook: clear per-run policy state so a reused
        policy object cannot leak decisions across runs."""
        self.policy.reset()

    def wake(self, ready: List[Task], now: float) -> None:
        """Per-wake bookkeeping (token accrual).  Call once per wake-up,
        before any ``pick``/``decide`` at that instant."""
        self.policy.on_wake(ready, now)

    def pick(self, ready: List[Task], now: float,
             running: Optional[Task]) -> Optional[Task]:
        """The policy's current candidate (no tokens accrued; see wake)."""
        return self.policy.select(ready, now, running)

    # ------------------------------------------------------------------
    def kill_allowed(self, running: Task) -> bool:
        """KILL progress guarantee (anti-livelock): early phase only, and
        a bounded number of times per task."""
        early = running.executed <= self.cfg.kill_early_frac * max(
            running.predicted_total, 1e-12)
        return early and running.n_kills < self.cfg.max_kills

    def arbitrate(self, running: Task, cand: Task) -> Decision:
        """Steps 2-4 for an already-selected candidate against a running
        task: may_preempt gate, mechanism choice, KILL guarantee."""
        dynamic = self.cfg.mechanism == "dynamic"
        if not self.policy.may_preempt(running, cand, dynamic):
            return Decision(Action.KEEP, cand)
        if dynamic:
            mech = preemption.select_mechanism(running, cand)
        else:
            mech = Mechanism(self.cfg.mechanism)
        if mech is Mechanism.DRAIN:
            return Decision(Action.DRAIN, cand)
        if mech is Mechanism.KILL and not self.kill_allowed(running):
            return Decision(Action.DEFER, cand)
        return Decision(Action.PREEMPT, cand, mech)

    def decide(self, ready: List[Task], now: float, running: Optional[Task],
               busy_until: float = 0.0, *, wake: bool = True) -> Decision:
        """The full per-wake-up sequence for one device (§V-C two-step
        procedure).  ``busy_until`` is the end of the device's current
        switch-overhead window (non-preemptible)."""
        if not ready:
            return Decision(Action.IDLE)
        if wake:
            self.wake(ready, now)
        cand = self.pick(ready, now, running)
        if cand is None:
            return Decision(Action.IDLE)
        if running is None:
            if now >= busy_until:
                return Decision(Action.START, cand)
            return Decision(Action.BUSY, cand)
        if not self.policy.preemptive or now < busy_until:
            return Decision(Action.KEEP, cand)
        if cand is running:
            return Decision(Action.KEEP, cand)
        return self.arbitrate(running, cand)

    # ---- slot-level arbitration (continuous batching) ----------------
    def slot_victim(self, residents: List[Task]) -> Optional[Task]:
        """The co-resident the policy is most willing to displace.

        With one resident per device the preemption victim is forced;
        with a vector of batch slots the arbiter must *rank* residents.
        The ranking mirrors each policy family's selection rule run
        backwards: priority-aware policies (hpf) evict the lowest
        priority, predictor-backed policies (sjf/token/prema) the longest
        predicted remaining work (the costliest slot, Algorithm 3's
        framing), arrival-ordered policies (fcfs/rrb) the youngest
        arrival.  Ties break on tid for determinism.

        Args:
            residents: tasks currently occupying the device's slots.

        Returns:
            The victim candidate, or None when ``residents`` is empty.
        """
        if not residents:
            return None
        if self.policy.name == "hpf":
            return min(residents, key=lambda r: (r.priority, -r.arrival,
                                                 -r.tid))
        if self.policy.uses_predictor:
            return max(residents, key=lambda r: (r.predicted_remaining,
                                                 r.tid))
        return max(residents, key=lambda r: (r.arrival, r.tid))

    def decide_batch(self, ready: List[Task], now: float,
                     residents: List[Task], free_slots: int,
                     busy_until: float = 0.0, *,
                     wake: bool = True) -> Decision:
        """Per-wake-up sequence for one *batch slot* of a device.

        The batched analogue of :meth:`decide`: with a free slot the
        candidate simply STARTs (no one is displaced — continuous
        batching admits it into the running iteration); with all slots
        occupied the policy's least-preferred resident
        (:meth:`slot_victim`) stands in for the single running task and
        the usual may_preempt → mechanism → KILL-guarantee sequence
        applies to that slot alone.

        Args:
            ready: the global ready queue (policy-visible task list).
            now: current sim time on the device's clock.
            residents: tasks occupying the device's slots.
            free_slots: number of unoccupied slots on the device.
            busy_until: end of the device's switch-overhead window.
            wake: run ``policy.on_wake`` first (token accrual); pass
                False when the caller already woke the policy at ``now``.

        Returns:
            A :class:`Decision`; ``PREEMPT``/``DRAIN``/``DEFER`` target
            the ``slot_victim`` resident, which the caller looks up again
            to learn the slot index.
        """
        if not ready:
            return Decision(Action.IDLE)
        if wake:
            self.wake(ready, now)
        cand = self.pick(ready, now, None)
        if cand is None:
            return Decision(Action.IDLE)
        if free_slots > 0:
            if now >= busy_until:
                return Decision(Action.START, cand)
            return Decision(Action.BUSY, cand)
        if not self.policy.preemptive or now < busy_until:
            return Decision(Action.KEEP, cand)
        victim = self.slot_victim(residents)
        if victim is None or victim is cand:
            return Decision(Action.KEEP, cand)
        return self.arbitrate(victim, cand)


def remaining_cost(task: Task, speed: float = 1.0) -> float:
    """Device-relative predicted remaining *wall* time: the shared
    ``Time_estimated - Time_executed`` estimate (reference-hardware
    seconds) dilated by the device's relative speed.  Heterogeneous
    clusters rank preemption victims and drain candidates by this, so a
    slow device holding a long task is correctly seen as the costliest
    slot; with ``speed == 1`` it is exactly ``predicted_remaining``."""
    return task.predicted_remaining / max(speed, 1e-12)


def should_preempt(policy: Policy, running: Task, cand: Task,
                   dynamic_mech: bool) -> bool:
    """Back-compat wrapper for the old free function (pre-arbiter API);
    prefer :meth:`Policy.may_preempt`."""
    return policy.may_preempt(running, cand, dynamic_mech)
