# Copied from src/repro/core/events.py; `repro.` rewritten to `repro_torch.`.
"""Unified execution event hooks: one stream for every execution layer.

Every execution layer — :class:`~repro_torch.core.simulator.NPUSimulator`,
:class:`~repro_torch.core.cluster.ClusterSimulator`, and
:class:`~repro_torch.serving.engine.ServingEngine` — emits the same five event
kinds, with sim-time timestamps, through the :class:`EventBus` carried by
the shared :class:`~repro_torch.core.arbiter.Arbiter`:

==========  ===============================================================
``submit``    a task was offered to the system (its arrival instant);
              fires before any admission decision, ``device == -1``.
``dispatch``  a task began (or resumed) execution on a device; under
              continuous batching ``slot`` names its batch slot.
``preempt``   a running task was displaced; carries the mechanism
              (``checkpoint`` / ``kill``) that was used.
``complete``  a task finished on a device.
``drop``      admission control rejected the task at submission
              (``device == -1``); dropped tasks never dispatch.
==========  ===============================================================

Elastic clusters add three *device lifecycle* events (``tid == -1``):

================  =========================================================
``device_up``     a device joined the cluster (it becomes schedulable at
                  its ``alive_since`` instant, after any provision delay).
``device_drain``  a device stopped accepting placements; residents either
                  finish or are checkpoint-migrated away.
``device_down``   a drained device left the cluster for good.
================  =========================================================

Fault injection (``core/faults.py``) adds two more device events
(``tid == -1``) and two client-recovery events:

==================  =======================================================
``device_fail``     a device crashed: zero capacity until repaired; its
                    in-flight task lost all un-checkpointed progress and
                    was re-queued (KILL-style restart when it had no
                    durable checkpoint).
``device_recover``  a failed device was repaired and is schedulable again.
``retry``           a client re-offered a dropped task after a backoff
                    (``repro_torch.workloads.retry.RetryDriver``); same ``tid``,
                    new attempt.
``abandon``         a client gave up on a task for good — retry budget
                    exhausted or its deadline passed (``device == -1``).
==================  =======================================================

The observability layer (``repro/obs/slo.py``) adds two *control* events
(``tid == -1``, ``device == -1``) that reactive subsystems — autoscaler,
admission — can subscribe to like any other kind:

=============  ============================================================
``slo_alert``  a tenant class is burning its error budget too fast
               (``tenant`` names the class, ``mechanism`` the rule id).
``slo_clear``  the same rule dropped back under its threshold.
=============  ============================================================

The bus is the one observation point for reactive subsystems: closed-loop
clients resample their think time on ``complete``/``drop``
(:class:`repro_torch.workloads.arrivals.ClosedLoopDriver`), executed-trace
capture snapshots ``bus.log``
(:class:`repro_torch.workloads.trace_io.ExecutedTrace`), and admission
accounting counts ``submit``/``drop`` pairs.  Subscribers persist across
runs; the log is cleared at the start of every ``run()``.

Determinism contract: with the same seed and workload, the event log is
bit-identical across ``NPUSimulator`` and ``ClusterSimulator(n_devices=1)``
(and across repeated runs of either) — pinned by tests/test_events.py.
Subscribers must not mutate scheduling state; they may inject *new* work
via the layer's ``submit()``.
"""
from __future__ import annotations

import json
from typing import Callable, Dict, IO, List, NamedTuple, Optional, Union

EVENT_KINDS = (
    "submit",
    "dispatch",
    "preempt",
    "complete",
    "drop",
    "device_up",
    "device_drain",
    "device_down",
    "device_fail",
    "device_recover",
    "retry",
    "abandon",
    "slo_alert",
    "slo_clear",
)
DEVICE_EVENT_KINDS = ("device_up", "device_drain", "device_down")
FAULT_EVENT_KINDS = ("device_fail", "device_recover")
SLO_EVENT_KINDS = ("slo_alert", "slo_clear")


class Event(NamedTuple):
    """One scheduling-visible state change, stamped with sim time.

    A NamedTuple rather than a dataclass: execution layers emit millions
    of these on large traces, and tuple construction is the cheapest
    immutable record Python has.  Field access, value equality, and
    ``_replace`` match the former frozen-dataclass surface.
    """
    t: float
    kind: str                       # one of EVENT_KINDS
    tid: int
    device: int = -1                # -1: not bound to a device (submit/drop)
    mechanism: Optional[str] = None  # preempt only: checkpoint | kill
    tenant: Optional[str] = None
    priority: int = 0
    slot: int = -1                  # batch slot on the device (continuous
    #                                 batching); -1 = whole-device event

    def to_json(self) -> dict:
        """The JSONL wire form (``ExecutedTrace``/``JsonlSpool`` framing)."""
        return {"t": self.t, "kind": self.kind, "tid": self.tid,
                "device": self.device, "mechanism": self.mechanism,
                "tenant": self.tenant, "priority": self.priority,
                "slot": self.slot}

    @classmethod
    def from_json(cls, d: dict) -> "Event":
        """Rebuild from :meth:`to_json` output; missing fields default."""
        return cls(**{name: d[name] for name in cls._fields if name in d})


Subscriber = Callable[[Event], None]


class EventBus:
    """Publish/subscribe hub plus an always-on in-order event log.

    ``subscribe(kind, fn)`` registers a hook for one event kind (or
    ``"*"`` for all); the matching ``on_submit``/``on_dispatch``/
    ``on_preempt``/``on_complete``/``on_drop`` helpers are sugar for the
    five kinds.  ``emit`` appends to ``log`` *before* notifying
    subscribers, so a hook that injects new work observes a log that
    already contains the triggering event.

    ``keep_log=False`` turns the in-memory log off for streaming runs
    where events go to a sink (e.g. :class:`JsonlSpool`) instead — peak
    RSS then stays flat in trace length.  Capture/replay and the
    determinism tests rely on the log, so it defaults to on.
    """

    def __init__(self, keep_log: bool = True) -> None:
        self._subs: Dict[str, List[Subscriber]] = {k: [] for k in EVENT_KINDS}
        self._subs["*"] = []
        self.keep_log = keep_log
        self.log: List[Event] = []
        self._emitting = False
        self._pending: List[Event] = []

    # -- subscription --------------------------------------------------
    def subscribe(self, kind: str, fn: Subscriber) -> Subscriber:
        """Register ``fn`` for one event ``kind`` (``"*"`` = all kinds)."""
        if kind not in self._subs:
            raise KeyError(f"unknown event kind {kind!r}; "
                           f"choose from {EVENT_KINDS + ('*',)}")
        self._subs[kind].append(fn)
        return fn

    def unsubscribe(self, kind: str, fn: Subscriber) -> None:
        """Remove a subscription added with :meth:`subscribe`."""
        self._subs[kind].remove(fn)

    def subscribe_map(self, handlers: Dict[str, Subscriber]) -> Callable[[], None]:
        """Subscribe a ``kind → handler`` mapping in one call and return a
        ``detach()`` closure that removes exactly those subscriptions —
        the idiom observability sinks (``repro/obs/``) use to attach and
        restore the no-subscriber fast path on detach.  ``detach`` is
        idempotent."""
        entries = [(kind, fn) for kind, fn in handlers.items()]
        for kind, fn in entries:
            self.subscribe(kind, fn)
        detached = []

        def detach() -> None:
            if detached:
                return
            detached.append(True)
            for kind, fn in entries:
                self.unsubscribe(kind, fn)

        return detach

    def on_submit(self, fn: Subscriber) -> Subscriber:
        """Sugar for ``subscribe("submit", fn)``."""
        return self.subscribe("submit", fn)

    def on_dispatch(self, fn: Subscriber) -> Subscriber:
        """Sugar for ``subscribe("dispatch", fn)``."""
        return self.subscribe("dispatch", fn)

    def on_preempt(self, fn: Subscriber) -> Subscriber:
        """Sugar for ``subscribe("preempt", fn)``."""
        return self.subscribe("preempt", fn)

    def on_complete(self, fn: Subscriber) -> Subscriber:
        """Sugar for ``subscribe("complete", fn)``."""
        return self.subscribe("complete", fn)

    def on_drop(self, fn: Subscriber) -> Subscriber:
        """Sugar for ``subscribe("drop", fn)``."""
        return self.subscribe("drop", fn)

    # -- emission ------------------------------------------------------
    def clear(self) -> None:
        """Drop the log (start of a run); subscriptions are kept."""
        self.log = []

    def emit(self, ev: Event) -> None:
        """Log ``ev`` (when ``keep_log``) and notify its subscribers."""
        if self.keep_log:
            self.log.append(ev)
        # breadth-first delivery: an event emitted from inside a hook
        # (e.g. RetryDriver announcing a ``retry`` while handling a
        # ``drop``) is logged immediately but notified only after the
        # triggering event's subscribers have all run, so every
        # subscriber — streaming sinks included — observes events in
        # exactly the log order
        if self._emitting:
            self._pending.append(ev)
            return
        self._emitting = True
        try:
            self._notify(ev)
            while self._pending:
                self._notify(self._pending.pop(0))
        finally:
            self._emitting = False
            del self._pending[:]

    def _notify(self, ev: Event) -> None:
        # snapshot subscriber lists only when non-empty: a hook may
        # (un)subscribe from inside a callback, but the common case is
        # no subscribers at all and must stay allocation-free
        subs = self._subs[ev.kind]
        if subs:
            for fn in tuple(subs):
                fn(ev)
        subs = self._subs["*"]
        if subs:
            for fn in tuple(subs):
                fn(ev)

    def _task_event(self, t: float, kind: str, task, device: int,
                    mechanism: Optional[str] = None, slot: int = -1) -> None:
        self.emit(Event(float(t), kind, task.tid, device, mechanism,
                        getattr(task, "tenant", None),
                        int(getattr(task, "priority", 0)), slot))

    def submit(self, t: float, task) -> None:
        """A task was offered at its arrival instant (before admission)."""
        self._task_event(t, "submit", task, -1)

    def dispatch(self, t: float, task, device: int, slot: int = -1) -> None:
        """A task began (or resumed) on ``device``; ``slot`` is its batch
        slot under continuous batching (-1 when the device runs a single
        resident — the historical whole-device path)."""
        self._task_event(t, "dispatch", task, device, slot=slot)

    def preempt(self, t: float, task, device: int, mechanism: str,
                slot: int = -1) -> None:
        """A running task was displaced by ``mechanism`` on ``device``."""
        self._task_event(t, "preempt", task, device, mechanism, slot=slot)

    def complete(self, t: float, task, device: int, slot: int = -1) -> None:
        """A task finished on ``device`` (``slot`` as in :meth:`dispatch`)."""
        self._task_event(t, "complete", task, device, slot=slot)

    def drop(self, t: float, task) -> None:
        """Admission control shed the task; it never executes."""
        self._task_event(t, "drop", task, -1)

    # -- device lifecycle (elastic clusters; tid == -1) ----------------
    def device_up(self, t: float, device: int) -> None:
        """A device joined the cluster (schedulable after provisioning)."""
        self.emit(Event(t=float(t), kind="device_up", tid=-1, device=device))

    def device_drain(self, t: float, device: int) -> None:
        """A device stopped accepting new placements."""
        self.emit(Event(t=float(t), kind="device_drain", tid=-1, device=device))

    def device_down(self, t: float, device: int) -> None:
        """A drained device left the cluster for good."""
        self.emit(Event(t=float(t), kind="device_down", tid=-1, device=device))

    # -- faults (core/faults.py; tid == -1) ----------------------------
    def device_fail(self, t: float, device: int) -> None:
        """A device crashed: zero capacity until ``device_recover``."""
        self.emit(Event(t=float(t), kind="device_fail", tid=-1, device=device))

    def device_recover(self, t: float, device: int) -> None:
        """A failed device was repaired and is schedulable again."""
        self.emit(Event(t=float(t), kind="device_recover", tid=-1,
                        device=device))

    # -- client recovery (repro_torch.workloads.retry) -----------------------
    def retry(self, t: float, task) -> None:
        """A client re-offered a dropped task after backoff."""
        self._task_event(t, "retry", task, -1)

    def abandon(self, t: float, task) -> None:
        """A client gave up on a task (budget/deadline exhausted)."""
        self._task_event(t, "abandon", task, -1)

    # -- SLO monitoring (repro_torch.obs.slo; tid == -1) ---------------------
    def slo_alert(self, t: float, tenant: Optional[str], rule: str) -> None:
        """A tenant class is burning its error budget too fast; ``rule``
        (carried in the ``mechanism`` field) names the rule that fired."""
        self.emit(Event(t=float(t), kind="slo_alert", tid=-1, device=-1,
                        mechanism=rule, tenant=tenant))

    def slo_clear(self, t: float, tenant: Optional[str], rule: str) -> None:
        """The named rule's burn rate dropped back under its clear bar."""
        self.emit(Event(t=float(t), kind="slo_clear", tid=-1, device=-1,
                        mechanism=rule, tenant=tenant))


class JsonlSpool:
    """Streaming event sink: one JSON line per event, written as emitted.

    Subscribe it to a bus (``spool = JsonlSpool(path); spool.attach(bus)``)
    and run with ``bus.keep_log = False`` to keep peak RSS flat on
    million-event traces; the spool file round-trips through
    :meth:`repro_torch.workloads.trace_io.ExecutedTrace.load` when written with
    ``header=True`` (the default).
    """

    def __init__(self, path_or_fp: Union[str, IO[str]],
                 header: bool = True, meta: Optional[Dict] = None,
                 flush_every: int = 0):
        if hasattr(path_or_fp, "write"):
            self._fp, self._owns = path_or_fp, False
        else:
            self._fp, self._owns = open(path_or_fp, "w"), True
        self.n_events = 0
        self.flush_every = int(flush_every)
        self._bus: Optional[EventBus] = None
        if header:
            # n_records omitted: unknowable while streaming (loaders
            # tolerate its absence)
            self._fp.write(json.dumps(
                {"version": 1, "kind": "executed", "meta": dict(meta or {})},
                sort_keys=True) + "\n")

    def __call__(self, ev: Event) -> None:
        self._fp.write(json.dumps(ev.to_json(), sort_keys=True) + "\n")
        self.n_events += 1
        if self.flush_every and self.n_events % self.flush_every == 0:
            self._fp.flush()

    def attach(self, bus: EventBus) -> "JsonlSpool":
        """Subscribe to every event on ``bus``; returns self for chaining."""
        bus.subscribe("*", self)
        self._bus = bus
        return self

    def flush(self) -> None:
        """Push buffered lines to the OS so a concurrently-read (or
        later-killed) spool is readable up to the last flushed event."""
        self._fp.flush()

    def close(self) -> None:
        """Detach from the bus, flush, and close an owned file handle."""
        if self._bus is not None:
            self._bus.unsubscribe("*", self)
            self._bus = None
        self._fp.flush()
        if self._owns:
            self._fp.close()

    def __enter__(self) -> "JsonlSpool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def offer(bus: EventBus, admission, task, now: float,
          queue_depth: int) -> bool:
    """Shared submission path: emit ``submit``, consult admission control,
    and emit ``drop`` on rejection.  Returns True when the task was
    admitted (the caller enqueues it), False when it was shed (the caller
    marks it DROPPED and forgets it).  ``queue_depth`` is the number of
    tasks waiting in the ready queue, excluding running tasks."""
    bus.submit(now, task)
    if admission is not None and not admission.admit(task, now, queue_depth):
        bus.drop(now, task)
        return False
    return True
