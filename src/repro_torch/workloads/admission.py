# Copied from src/repro/workloads/admission.py; `repro.` rewritten to `repro_torch.`.
"""Per-tenant admission control: who gets into the ready queue at all.

Under overload the scheduler can only reorder work that was admitted;
shedding decisions belong at the front door.  An
:class:`AdmissionPolicy` is consulted once per submission (the shared
:func:`repro_torch.core.events.offer` path used by the simulator, the cluster
simulator, and the serving engine): admit → the task joins the ready
queue; reject → the task is marked ``DROPPED``, a ``drop`` event fires,
and it never executes.  Accounting invariant (tests/test_admission.py):
per tenant, ``admitted + rejected == offered``.

Policies
--------
``admit_all``      no-op baseline (the default when no policy is set).
``token_bucket``   per-tenant rate limiting: each tenant's bucket holds up
                   to ``burst`` tokens and refills at ``rate`` tokens/s;
                   a submission spends one token or is shed.
``queue_shed``     global load shedding: reject every submission that
                   arrives while the ready queue holds >= ``max_depth``
                   waiting tasks.
``priority_shed``  priority-aware early drop: below ``soft_depth`` admit
                   everyone; between ``soft_depth`` and ``hard_depth``
                   admit only priority >= ``min_priority`` (protects the
                   interactive class while the queue is congested); at
                   ``hard_depth`` shed everything.
``predicted_cost`` token bucket denominated in *predicted seconds of
                   work* instead of request count: each admission spends
                   the task's ``predicted_total``, so one long batch job
                   costs what it is predicted to cost and cheap
                   interactive requests are not rationed like expensive
                   ones.  This is the predictor-driven admission
                   controller (see ``core/predictor.py``).

All policies are deterministic functions of (task, now, queue_depth) and
their own state, so admission decisions replay bit-identically with the
rest of the stack.  ``reset()`` is called at the start of every run.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from repro_torch.core.registry import Registry
from repro_torch.core.task import Task

ADMISSION_NAMES = ("admit_all", "token_bucket", "queue_shed",
                   "priority_shed", "predicted_cost")


class AdmissionPolicy:
    """Base: ``admit`` decides one submission; ``reset`` clears state."""
    name = "base"

    def reset(self) -> None:
        """Clear per-run state (token levels); called at run start."""

    def admit(self, task: Task, now: float, queue_depth: int) -> bool:
        raise NotImplementedError

    def describe(self) -> Dict:
        d = {k: v for k, v in dataclasses.asdict(self).items()}
        d["policy"] = self.name
        return d


@dataclasses.dataclass
class AdmitAll(AdmissionPolicy):
    """Accept everything (baseline; equivalent to no admission control)."""
    name = "admit_all"

    def admit(self, task, now, queue_depth):
        return True


@dataclasses.dataclass
class TokenBucket(AdmissionPolicy):
    """Per-tenant token bucket: ``rate`` admissions/s, ``burst`` capacity.

    Buckets start full.  Tasks without a tenant share the ``"-"`` bucket.
    ``per_tenant=False`` collapses every tenant into one global bucket.
    """
    rate: float
    burst: float = 1.0
    per_tenant: bool = True
    name = "token_bucket"

    def __post_init__(self):
        if self.rate <= 0:
            raise ValueError("token_bucket rate must be > 0")
        if self.burst < 1:
            raise ValueError("token_bucket burst must be >= 1")
        self._levels: Dict[str, Tuple[float, float]] = {}

    def reset(self):
        self._levels = {}

    def _key(self, task: Task) -> str:
        if not self.per_tenant:
            return "-"
        return task.tenant if task.tenant is not None else "-"

    def admit(self, task, now, queue_depth):
        key = self._key(task)
        level, last = self._levels.get(key, (float(self.burst), now))
        level = min(float(self.burst), level + self.rate * max(0.0, now - last))
        ok = level >= 1.0
        if ok:
            level -= 1.0
        self._levels[key] = (level, now)
        return ok


@dataclasses.dataclass
class QueueShed(AdmissionPolicy):
    """Global queue-depth load shedding: reject arrivals while the ready
    queue already holds >= ``max_depth`` waiting tasks."""
    max_depth: int
    name = "queue_shed"

    def __post_init__(self):
        if self.max_depth < 1:
            raise ValueError("queue_shed max_depth must be >= 1")

    def admit(self, task, now, queue_depth):
        return queue_depth < self.max_depth


@dataclasses.dataclass
class PriorityShed(AdmissionPolicy):
    """Priority-aware early drop: under congestion, shed low-priority work
    *before* the queue saturates so high-priority admissions still meet
    their SLAs.  ``hard_depth`` defaults to ``4 x soft_depth``."""
    soft_depth: int
    hard_depth: Optional[int] = None
    min_priority: int = 9
    name = "priority_shed"

    def __post_init__(self):
        if self.soft_depth < 1:
            raise ValueError("priority_shed soft_depth must be >= 1")
        if self.hard_depth is None:
            self.hard_depth = 4 * self.soft_depth
        if self.hard_depth < self.soft_depth:
            raise ValueError("hard_depth must be >= soft_depth")

    def admit(self, task, now, queue_depth):
        if queue_depth < self.soft_depth:
            return True
        if queue_depth >= self.hard_depth:
            return False
        return task.priority >= self.min_priority


@dataclasses.dataclass
class PredictedCostBucket(AdmissionPolicy):
    """Predicted-work token bucket: ``rate`` predicted-seconds of work
    admitted per second, ``burst`` predicted-seconds of capacity.

    Where :class:`TokenBucket` spends one token per request regardless of
    size, this bucket spends the task's *predicted runtime*
    (``Task.predicted_total``): sizing ``rate`` at the fleet's service
    capacity admits exactly the work the devices can absorb, whatever mix
    of long and short requests arrives.  Admission quality therefore
    tracks predictor quality — the sensitivity
    ``benchmarks/predictor_sweep.py`` sweeps.  Buckets start full; tasks
    without a tenant share the ``"-"`` bucket.
    """
    rate: float
    burst: float = 1.0
    per_tenant: bool = True
    name = "predicted_cost"

    def __post_init__(self):
        if self.rate <= 0:
            raise ValueError("predicted_cost rate must be > 0")
        if self.burst <= 0:
            raise ValueError("predicted_cost burst must be > 0")
        self._levels: Dict[str, Tuple[float, float]] = {}

    def reset(self):
        self._levels = {}

    def _key(self, task: Task) -> str:
        if not self.per_tenant:
            return "-"
        return task.tenant if task.tenant is not None else "-"

    def admit(self, task, now, queue_depth):
        key = self._key(task)
        level, last = self._levels.get(key, (float(self.burst), now))
        level = min(float(self.burst),
                    level + self.rate * max(0.0, now - last))
        cost = max(0.0, float(task.predicted_total))
        ok = level >= cost
        if ok:
            level -= cost
        self._levels[key] = (level, now)
        return ok


_REGISTRY = Registry("admission policy")
_REGISTRY.register("admit_all", AdmitAll)
_REGISTRY.register("token_bucket", TokenBucket)
_REGISTRY.register("queue_shed", QueueShed)
_REGISTRY.register("priority_shed", PriorityShed)
_REGISTRY.register("predicted_cost", PredictedCostBucket)


def make_admission(name: str, **kwargs) -> AdmissionPolicy:
    """Instantiate an admission policy by name (``ADMISSION_NAMES``)."""
    return _REGISTRY.make(name, **kwargs)
