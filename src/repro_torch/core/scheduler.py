# Copied from src/repro/core/scheduler.py; `repro.` rewritten to `repro_torch.`.
"""Scheduling policies (paper §V-C plus all evaluated baselines).

Policies answer two questions at each scheduler wake-up: *which task
should occupy the NPU now?* (``select``) and *may that candidate displace
the running task?* (``may_preempt``).  Preemption mechanics (how a switch
happens) live in ``preemption.py``; the shared arbiter (``arbiter.py``)
sequences select → may_preempt → mechanism choice for every execution
layer (simulator, cluster, serving engine).

Implemented policies (paper Figures 11/12):

=========  ==========  ===========  ==============================
name       predictor?  preemptive?  selection rule
=========  ==========  ===========  ==============================
fcfs       no          optional     earliest arrival
rrb        no          optional     round-robin on quantum
hpf        no          optional     highest priority, FCFS tiebreak
sjf        yes         optional     shortest predicted remaining
token      yes         optional     token candidates, FCFS among them
prema      yes         optional     token candidates, shortest job
=========  ==========  ===========  ==============================

PREMA token mechanics (Algorithm 2): tokens are seeded with the
user-defined priority (1/3/9), accrue each scheduling period by
``priority × slowdown_normalized`` (idle time since the last wake,
normalized by the task's predicted isolated time), and the candidate
threshold is the *max token count in the queue rounded down* to the nearest
priority level.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

from repro_torch.core.ready_queue import ReadyQueue
from repro_torch.core.registry import Registry
from repro_torch.core.task import PRIORITY_LEVELS, Task

SCHED_QUANTUM = 0.25e-3      # scheduling period time-quota (Table II)
TOKEN_LEVELS = PRIORITY_LEVELS


def _fast(ready, name: str) -> bool:
    """True when ``ready`` is a ReadyQueue indexed for this policy; the
    selectors then run on its heaps instead of rescanning the set."""
    return isinstance(ready, ReadyQueue) and ready.policy == name


def accrue_tokens(ready: Sequence[Task], now: float) -> None:
    """Algorithm 2 line 7, applied at every scheduler wake-up.

    A :class:`~repro_torch.core.ready_queue.ReadyQueue` accrues vectorized
    (bit-identical float64 math); plain sequences take the scalar loop.
    """
    if isinstance(ready, ReadyQueue):
        ready.accrue(now)
        return
    for t in ready:
        idle = max(0.0, now - t.last_wake)
        slowdown_norm = idle / max(t.predicted_total, 1e-9)
        t.tokens += t.priority * slowdown_norm
        t.last_wake = now


def token_threshold(ready: Sequence[Task]) -> float:
    """Max token count rounded *down* to the closest priority level
    (paper example: max=8 → threshold 3)."""
    if isinstance(ready, ReadyQueue):
        return ready.threshold()
    mx = max(t.tokens for t in ready)
    thr = TOKEN_LEVELS[0]
    for lvl in TOKEN_LEVELS:
        if mx >= lvl:
            thr = lvl
    return float(thr)


@dataclasses.dataclass
class Policy:
    """Base policy.  ``preemptive`` controls whether the simulator may
    switch away from a running task at wake-ups."""
    name: str = "base"
    preemptive: bool = False
    uses_predictor: bool = False

    def select(self, ready: List[Task], now: float,
               running: Optional[Task]) -> Optional[Task]:
        """The policy's preferred candidate from ``ready`` (None = idle)."""
        raise NotImplementedError

    def on_wake(self, ready: List[Task], now: float) -> None:
        """Per-wake bookkeeping (token accrual for token policies)."""

    def may_preempt(self, running: Task, cand: Task,
                    dynamic_mech: bool) -> bool:
        """Whether ``cand`` may displace ``running`` under this policy
        (the arbiter's step-2 gate; see ``core/arbiter.py``)."""
        return False

    def reset(self) -> None:
        """Clear per-run state.  Called by the arbiter at the start of
        every simulator/engine run so a reused policy object cannot leak
        decisions (e.g. round-robin position) across runs."""


class FCFS(Policy):
    """First come, first served (arrival order; ties on tid)."""

    def __init__(self, preemptive: bool = False):
        super().__init__(name="fcfs", preemptive=preemptive)

    def select(self, ready, now, running):
        """Earliest arrival wins."""
        if _fast(ready, "fcfs"):
            return ready.select()
        return min(ready, key=lambda t: (t.arrival, t.tid)) if ready else None

    def may_preempt(self, running, cand, dynamic_mech):
        """Only an earlier arrival may displace (rare: requeue paths)."""
        return cand.arrival < running.arrival


class RoundRobin(Policy):
    """Cycle through ready tasks on each quantum."""

    def __init__(self, preemptive: bool = False):
        super().__init__(name="rrb", preemptive=preemptive)
        self._last_tid: int = -1

    def select(self, ready, now, running):
        """Next tid after the previously-selected one, cycling."""
        if not ready:
            return None
        order = sorted(ready, key=lambda t: t.tid)
        for t in order:
            if t.tid > self._last_tid:
                self._last_tid = t.tid
                return t
        self._last_tid = order[0].tid
        return order[0]

    def may_preempt(self, running, cand, dynamic_mech):
        """Always: the quantum boundary is the preemption point."""
        return True

    def reset(self):
        """Restart the cycle position."""
        self._last_tid = -1


class HPF(Policy):
    """Highest (user-defined) priority first."""

    def __init__(self, preemptive: bool = False):
        super().__init__(name="hpf", preemptive=preemptive)

    def select(self, ready, now, running):
        """Highest priority; FCFS within a priority level."""
        if _fast(ready, "hpf"):
            return ready.select()
        if not ready:
            return None
        return min(ready, key=lambda t: (-t.priority, t.arrival, t.tid))

    def may_preempt(self, running, cand, dynamic_mech):
        """Strictly higher priority displaces."""
        return cand.priority > running.priority


class SJF(Policy):
    """Shortest (predicted) remaining job first — latency-optimal,
    priority-unaware."""

    def __init__(self, preemptive: bool = False):
        super().__init__(name="sjf", preemptive=preemptive,
                         uses_predictor=True)

    def select(self, ready, now, running):
        """Shortest predicted remaining work wins."""
        if _fast(ready, "sjf"):
            return ready.select()
        if not ready:
            return None
        return min(ready, key=lambda t: (t.predicted_remaining, t.tid))

    def may_preempt(self, running, cand, dynamic_mech):
        """A predicted-shorter candidate displaces."""
        return cand.predicted_remaining < running.predicted_remaining


class TokenFCFS(Policy):
    """Token-based candidate filtering, naive FCFS among candidates
    (paper's TOKEN baseline)."""

    def __init__(self, preemptive: bool = False):
        super().__init__(name="token", preemptive=preemptive,
                         uses_predictor=True)

    def on_wake(self, ready, now):
        """Accrue priority-weighted wait tokens (Eq. 2)."""
        accrue_tokens(ready, now)

    def select(self, ready, now, running):
        """FCFS among tasks above the token threshold."""
        if _fast(ready, "token"):
            return ready.select()
        if not ready:
            return None
        thr = token_threshold(ready)
        cands = [t for t in ready if t.tokens >= thr]
        return min(cands, key=lambda t: (t.arrival, t.tid))

    def may_preempt(self, running, cand, dynamic_mech):
        """More accrued tokens displaces."""
        return cand.tokens > running.tokens


class PREMA(Policy):
    """Algorithm 2: token candidates + shortest-estimated-job selection."""

    def __init__(self, preemptive: bool = True):
        super().__init__(name="prema", preemptive=preemptive,
                         uses_predictor=True)

    def on_wake(self, ready, now):
        """Accrue priority-weighted wait tokens (Eq. 2)."""
        accrue_tokens(ready, now)

    def select(self, ready, now, running):
        """Shortest estimated job among the token candidates."""
        if _fast(ready, "prema"):
            return ready.select()
        if not ready:
            return None
        thr = token_threshold(ready)
        cands = [t for t in ready if t.tokens >= thr]
        return min(cands, key=lambda t: (t.predicted_remaining, t.tid))

    def may_preempt(self, running, cand, dynamic_mech):
        """Under Algorithm 3 always arbitrate; else predicted-shorter."""
        if dynamic_mech:
            return True  # Algorithm 3 arbitrates CHECKPOINT vs DRAIN
        return cand.predicted_remaining < running.predicted_remaining


class Backfill(Policy):
    """EASY-style backfill over predicted idle gaps (priority-aware).

    Orders the queue like :class:`HPF`; interactive candidates
    (``priority >= hi_priority``) always pass straight through.  When the
    head of the queue is *batch* work, the policy consults ``gap_fn`` —
    the caller-installed forecast of how long the device stays free of
    predicted high-priority arrivals — and only starts a batch task whose
    :func:`~repro_torch.core.arbiter.remaining_cost` (scaled by ``safety``)
    fits inside that gap, so backfilled work never delays the reservation
    it runs ahead of.  In EASY mode (default) *any* fitting task may jump
    the queue; ``conservative=True`` lets only the queue head start, and
    holds the device otherwise.

    With no ``gap_fn`` installed the policy degrades to exactly HPF.
    Abstaining (returning no candidate with a non-empty queue) is safe in
    every execution layer: the simulators re-decide each scheduling
    quantum while work is waiting, so a held device wakes up again at the
    next quantum or arrival.
    """

    def __init__(self, preemptive: bool = False, hi_priority: int = 9,
                 safety: float = 1.0, conservative: bool = False):
        super().__init__(name="backfill", preemptive=preemptive,
                         uses_predictor=True)
        self.hi_priority = int(hi_priority)
        self.safety = float(safety)
        self.conservative = bool(conservative)
        # now -> predicted seconds before the next high-priority arrival
        # needs this device (math.inf = no reservation ahead).  Installed
        # by the driver (see benchmarks/predictor_sweep.py).
        self.gap_fn = None

    @staticmethod
    def _hpf_order(t: Task):
        return (-t.priority, t.arrival, t.tid)

    def select(self, ready, now, running):
        """HPF head, gap-checked when the head is batch work."""
        if not ready:
            return None
        cand = min(ready, key=self._hpf_order)
        if cand.priority >= self.hi_priority or self.gap_fn is None:
            return cand
        from repro_torch.core.arbiter import remaining_cost
        gap = float(self.gap_fn(now))
        if self.conservative:
            ok = remaining_cost(cand) * self.safety <= gap
            return cand if ok else None
        fits = [t for t in ready
                if remaining_cost(t) * self.safety <= gap]
        if not fits:
            return None
        return min(fits, key=self._hpf_order)

    def may_preempt(self, running, cand, dynamic_mech):
        """Strictly higher priority displaces (as HPF)."""
        return cand.priority > running.priority


_REGISTRY = Registry("policy")
_REGISTRY.register("fcfs", FCFS)
_REGISTRY.register("rrb", RoundRobin)
_REGISTRY.register("hpf", HPF)
_REGISTRY.register("sjf", SJF)
_REGISTRY.register("token", TokenFCFS)
_REGISTRY.register("prema", PREMA)
_REGISTRY.register("backfill", Backfill)


def make_policy(name: str, preemptive: bool = False) -> Policy:
    """Instantiate a policy by name (one of ``POLICY_NAMES`` or
    ``"backfill"``); unknown names raise the registry's ``KeyError``
    listing the valid choices."""
    return _REGISTRY.make(name, preemptive)


# The paper's evaluated-baseline grid (Figures 11/12) — tests and
# benchmark sweeps iterate this tuple, so the predictive ``backfill``
# policy is registered but deliberately not part of it.
POLICY_NAMES = ("fcfs", "rrb", "hpf", "sjf", "token", "prema")
