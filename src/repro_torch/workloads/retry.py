# Copied from src/repro/workloads/retry.py; `repro.` rewritten to `repro_torch.`.
"""Client-side recovery: retry budgets, exponential backoff, abandonment.

Admission control sheds work with a ``drop`` event
(``repro_torch.workloads.admission``); real clients do not simply vanish — they
back off and try again, up to a budget, until a deadline passes (the
edge-offloading literature models exactly this churn, arXiv:2504.16792).
:class:`RetryDriver` layers that behavior on *any* execution layer
exposing the common surface (``events`` bus + ``submit(item, at)``): the
single-NPU simulator, the cluster simulator, and the serving engine.

Semantics
---------
* One **logical task, many attempts**: a retry re-offers the *same*
  ``Task`` / ``InferenceRequest`` object, so ``n_offered == n_admitted +
  n_rejected`` stays exact in ``metrics.per_tenant_summary`` and
  ``ExecutedTrace.diff`` — attempts are visible as ``retry`` events and
  the per-item ``n_retries`` counter, not as phantom extra tasks.
* **Exponential backoff**: attempt *k* (0-based) is re-offered
  ``backoff * backoff_mult**k`` seconds after its drop.  Deterministic —
  no RNG — so same seed + same workload keeps the event log
  bit-identical across runs.
* **Abandonment**: when the retry budget is exhausted, or the re-offer
  would land past the client's deadline (absolute ``deadline`` seconds
  and/or ``deadline_scale`` x isolated time, both measured from the
  *first* offer), the client gives up for good: ``item.abandoned`` is
  set and an ``abandon`` event fires (``device == -1``).  The item stays
  DROPPED — its final outcome.

Events fire in drop order at the drop instant (``retry`` announces the
future re-offer; the re-offer itself is the next ``submit`` for that
tid), keeping the bus log time-ordered for ``ExecutedTrace`` capture.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.core.events import Event, EventBus

__all__ = ["RetryPolicy", "RetryDriver"]


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """How a client behaves after an admission drop.

    ``max_retries`` re-offers per logical task; attempt *k* backs off
    ``backoff * backoff_mult**k`` seconds.  ``deadline`` (absolute
    seconds) and ``deadline_scale`` (x isolated time, when the item
    exposes one) bound the client's patience from its first offer: a
    retry that would land past the earliest bound becomes an abandon.
    """

    max_retries: int = 3
    backoff: float = 1e-3
    backoff_mult: float = 2.0
    deadline: Optional[float] = None
    deadline_scale: Optional[float] = None

    def __post_init__(self):
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if self.backoff < 0 or self.backoff_mult <= 0:
            raise ValueError("backoff must be >= 0 and backoff_mult > 0")

    def backoff_for(self, attempt: int) -> float:
        return self.backoff * self.backoff_mult ** attempt

    def deadline_for(self, item) -> Optional[float]:
        """Patience in seconds from the first offer (None: unbounded)."""
        bounds: List[float] = []
        if self.deadline is not None:
            bounds.append(self.deadline)
        iso = getattr(item, "isolated_time", None)
        if self.deadline_scale is not None and iso is not None:
            bounds.append(self.deadline_scale * float(iso))
        return min(bounds) if bounds else None


def _tid(item) -> int:
    return item.tid if hasattr(item, "tid") else item.rid


class RetryDriver:
    """Re-offers dropped items with backoff; abandons past the budget.

    Usage — either drive a run directly::

        driver = RetryDriver(RetryPolicy(max_retries=2))
        done = driver.drive(sim, tasks)

    or attach around another driver (e.g. closed-loop clients)::

        driver.attach(sim, tasks)
        try:
            ClosedLoopDriver(proc, tasks).run(sim)
        finally:
            driver.detach()

    Only registered items are retried (mid-run injections by other
    drivers pass through untouched).  The driver mutates each item's
    ``n_retries`` / ``abandoned`` / ``first_offer`` fields and keeps its
    own ``n_retried`` / ``n_abandoned`` totals.
    """

    def __init__(self, policy: Optional[RetryPolicy] = None):
        self.policy = policy if policy is not None else RetryPolicy()
        self.n_retried = 0
        self.n_abandoned = 0
        self._items: Dict[int, object] = {}
        self._layer = None
        self._bus: Optional[EventBus] = None

    # -- lifecycle -----------------------------------------------------
    def attach(self, layer, items) -> "RetryDriver":
        if self._layer is not None:
            raise RuntimeError("driver already attached; detach() first")
        self._items = {_tid(item): item for item in items}
        self._layer = layer
        self._bus = layer.events
        self._bus.subscribe("submit", self._on_submit)
        self._bus.subscribe("drop", self._on_drop)
        return self

    def detach(self) -> None:
        if self._bus is not None:
            self._bus.unsubscribe("submit", self._on_submit)
            self._bus.unsubscribe("drop", self._on_drop)
        self._layer = None
        self._bus = None

    def drive(self, layer, items):
        """Run ``layer`` over ``items`` with this client behavior;
        returns ``layer.run``'s result."""
        items = list(items)
        self.attach(layer, items)
        try:
            return layer.run(items)
        finally:
            self.detach()

    # -- event hooks ---------------------------------------------------
    def _on_submit(self, ev: Event) -> None:
        item = self._items.get(ev.tid)
        if item is not None and item.first_offer is None:
            item.first_offer = ev.t

    def _client_event(self, kind: str, t: float, item) -> None:
        self._bus.emit(Event(float(t), kind, _tid(item), -1, None,
                             getattr(item, "tenant", None),
                             int(getattr(item, "priority", 0))))

    def _on_drop(self, ev: Event) -> None:
        item = self._items.get(ev.tid)
        if item is None or item.abandoned:
            return
        attempt = item.n_retries
        first = item.first_offer if item.first_offer is not None else ev.t
        retry_at = ev.t + self.policy.backoff_for(attempt)
        patience = self.policy.deadline_for(item)
        if (attempt >= self.policy.max_retries
                or (patience is not None and retry_at > first + patience)):
            item.abandoned = True
            self.n_abandoned += 1
            self._client_event("abandon", ev.t, item)
            return
        item.n_retries = attempt + 1
        self.n_retried += 1
        self._client_event("retry", ev.t, item)
        self._layer.submit(item, retry_at)
