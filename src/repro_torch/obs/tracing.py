# Copied from src/repro/obs/tracing.py; `repro.` rewritten to `repro_torch.`.
"""Span tracing: reconstruct per-task execution spans from the event
stream and export Chrome trace-event / Perfetto JSON.

The :class:`SpanTracer` is a pure EventBus subscriber — attach it to any
execution layer (``tracer = SpanTracer().attach(sim)``), run, and
``tracer.export("trace.json")`` writes a file that opens directly in
``ui.perfetto.dev`` (or ``chrome://tracing``) with

- one track per device (pid 1) carrying run slices named ``t<tid> p<prio>``
  plus DOWN/DRAIN slices for fault and drain windows,
- one async track per task, grouped per tenant (pid 2), showing the
  queued → running → … lifecycle,
- flow arrows across checkpoint/kill migrations, crash re-queues, and
  admission-drop → retry re-offers,
- counter tracks (pid 3) for ready-queue depth and PREMA token accrual
  (waiting priority-seconds — the currency Algorithm 2 schedules by).

Span reconstruction notes: the core emits ``dispatch`` at the decision
instant and ``preempt`` at the displacement instant, so checkpoint spill
and restore latencies are folded into the surrounding run/queued spans
(events are the scheduling-visible truth; see tests/test_obs_property.py
for when span time equals ``DeviceState.busy_time`` exactly).  A
``device_fail`` carries no task event for the crashed resident — the
tracer infers it from its device → running-task map, ending the run span
with reason ``crash``.
"""
from __future__ import annotations

import json
from typing import Dict, List, NamedTuple, Optional

# admission-path instants (submit/drop/retry/abandon, device == -1) get
# their own track on the devices process so retry flows have a slice to
# anchor to
ADMISSION_TRACK = 9999


def _slot_track(device: int, slot: int) -> int:
    """Chrome thread id for a (device, batch-slot) sub-track; kept above
    ADMISSION_TRACK so it can never collide with a device index."""
    return (device + 1) * 10000 + slot


class Span(NamedTuple):
    """One reconstructed interval of a task's life.

    ``phase`` is ``"run"`` (on ``device``) or ``"queued"`` (waiting,
    ``device`` is where it last ran, -1 before first dispatch);
    ``reason`` says how the span ended: ``complete``, ``preempt:kill``,
    ``preempt:checkpoint``, ``crash``, ``dispatch`` (a queued span ending
    in service), ``drop``, ``open`` (still in flight at export time).
    ``slot`` is the batch slot the run occupied under continuous
    batching (-1 on the whole-device path).
    """
    tid: int
    device: int
    t0: float
    t1: float
    phase: str
    priority: int
    tenant: Optional[str]
    reason: str
    slot: int = -1


class SpanTracer:
    """Streaming span reconstruction over the 14 event kinds.

    Pay-for-what-you-use: construct + :meth:`attach` to observe a run,
    :meth:`detach` to restore the bus's no-subscriber fast path.  All
    state is plain lists/dicts appended per event; export does the
    (relatively) expensive JSON shaping once at the end.
    """

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self._spans: List[tuple] = []        # finished Span tuples
        # run-slot key: the device index (whole-device path, slot == -1)
        # or a (device, slot) pair (continuous batching)
        self._running: Dict = {}             # key -> (tid, t0, prio, ten)
        self._waiting: Dict[int, float] = {}  # tid -> wait-start t
        self._task: Dict[int, tuple] = {}     # tid -> (tenant, prio, t_submit)
        self._last_device: Dict[int, int] = {}  # tid -> last dispatch device
        self._ended: Dict[int, float] = {}    # tid -> lifecycle end t
        self._flows: List[tuple] = []  # (id, cat, src_t, src_track, dst_t, dst_track)
        self._pending_flow: Dict[int, tuple] = {}  # tid -> (id, cat, t, track)
        self._admission: List[tuple] = []      # (t, kind, tid)
        self._down: Dict[int, tuple] = {}      # device -> (t0, label)
        self._down_spans: List[tuple] = []     # (device, t0, t1, label)
        self.counter_samples: List[tuple] = []  # (t, depth, tokens)
        self._depth = 0
        self._prio_sum = 0.0
        self._acc = 0.0
        self._acc_t = 0.0
        self._flow_seq = 0
        self.last_t = 0.0
        self.n_events = 0
        self._detach = None

    # -- bus plumbing ---------------------------------------------------
    def attach(self, layer_or_bus) -> "SpanTracer":
        bus = getattr(layer_or_bus, "events", layer_or_bus)
        bus.subscribe("*", self)
        self._detach = lambda: bus.unsubscribe("*", self)
        return self

    def detach(self) -> None:
        if self._detach is not None:
            self._detach()
            self._detach = None

    # -- per-event state machine ---------------------------------------
    def __call__(self, ev) -> None:
        # the dispatch/submit/complete arms are the simulator's hot path
        # (gated by benchmarks/obs_overhead.py): tuple-unpack once,
        # inline the waiting-set/token bookkeeping, and append plain
        # tuples -- no per-event object construction
        t, kind, tid, device, mechanism, tenant, priority, slot = ev
        self.n_events += 1
        if t > self.last_t:
            self.last_t = t
        if kind == "dispatch":
            t0 = self._waiting.pop(tid, None)
            if t0 is not None:
                acc = self._acc = (self._acc
                                   + self._prio_sum * (t - self._acc_t))
                self._acc_t = t
                self._depth -= 1
                self._prio_sum -= priority
                self.counter_samples.append((t, self._depth, acc))
                self._spans.append((tid, self._last_device.get(tid, -1),
                                    t0, t, "queued", priority, tenant,
                                    "dispatch", -1))
            key = device if slot < 0 else (device, slot)
            self._running[key] = (tid, t, priority, tenant)
            self._last_device[tid] = device
            if tid in self._pending_flow:
                pf = self._pending_flow.pop(tid)
                self._flows.append((pf[0], pf[1], pf[2], pf[3], t, device))
        elif kind == "complete":
            self._end_run(device, t, "complete", slot)
            self._ended[tid] = t
        elif kind == "submit":
            if tid not in self._task:
                self._task[tid] = (tenant, priority, t)
            else:
                self._ended.pop(tid, None)  # a re-offer revives the task
            self._waiting[tid] = t
            acc = self._acc = (self._acc
                               + self._prio_sum * (t - self._acc_t))
            self._acc_t = t
            self._depth += 1
            self._prio_sum += priority
            self.counter_samples.append((t, self._depth, acc))
        elif kind == "preempt":
            self._end_run(device, t, "preempt:" + str(mechanism), slot)
            self._waiting[tid] = t
            self._wait_enter(t, priority)
            self._flow_from(tid, "migration", t, device)
        elif kind == "drop":
            t0 = self._waiting.pop(tid, None)
            if t0 is not None:
                self._wait_leave(t, priority)
                self._spans.append((tid, -1, t0, t, "queued",
                                    priority, tenant, "drop", -1))
            self._ended[tid] = t
            self._admission.append((t, "drop", tid))
            self._flow_from(tid, "retry", t, ADMISSION_TRACK)
        elif kind == "retry":
            self._admission.append((t, "retry", tid))
        elif kind == "abandon":
            self._ended[tid] = t
            self._pending_flow.pop(tid, None)
            self._admission.append((t, "abandon", tid))
        elif kind == "device_fail":
            # a crash evicts every resident: the single whole-device key
            # plus all of the device's batch slots
            keys = [k for k in self._running
                    if k == device or (isinstance(k, tuple)
                                       and k[0] == device)]
            for key in keys:
                rtid, rt0, rprio, rten = self._running.pop(key)
                rslot = key[1] if isinstance(key, tuple) else -1
                self._spans.append((rtid, device, rt0, t, "run",
                                    rprio, rten, "crash", rslot))
                self._waiting[rtid] = t
                self._wait_enter(t, rprio)
                self._flow_from(rtid, "crash", t, device)
            self._down[device] = (t, "DOWN")
        elif kind == "device_recover":
            d = self._down.pop(device, None)
            if d is not None:
                self._down_spans.append((device, d[0], t, d[1]))
        elif kind == "device_drain":
            self._down.setdefault(device, (t, "DRAIN"))
        elif kind == "device_down":
            d = self._down.pop(device, None)
            if d is not None:
                self._down_spans.append((device, d[0], t, d[1]))
            self._down[device] = (t, "OFF")
        # device_up / slo_alert / slo_clear: no span state to keep --
        # they surface as instants on export
        elif kind == "device_up":
            d = self._down.pop(device, None)
            if d is not None:
                self._down_spans.append((device, d[0], t, d[1]))

    # -- small helpers --------------------------------------------------
    def _end_run(self, device: int, t: float, reason: str,
                 slot: int = -1) -> None:
        run = self._running.pop(device if slot < 0 else (device, slot),
                                None)
        if run is not None:
            tid, t0, prio, tenant = run
            self._spans.append((tid, device, t0, t, "run", prio, tenant,
                                reason, slot))

    def _flow_from(self, tid: int, cat: str, t: float, track: int) -> None:
        self._flow_seq += 1
        self._pending_flow[tid] = (self._flow_seq, cat, t, track)

    def _wait_enter(self, t: float, prio: int) -> None:
        # PREMA token accrual: waiting tasks earn tokens at their
        # priority rate; the running total is the counter track
        self._acc += self._prio_sum * (t - self._acc_t)
        self._acc_t = t
        self._depth += 1
        self._prio_sum += prio
        self.counter_samples.append((t, self._depth, self._acc))

    def _wait_leave(self, t: float, prio: int) -> None:
        self._acc += self._prio_sum * (t - self._acc_t)
        self._acc_t = t
        self._depth -= 1
        self._prio_sum -= prio
        self.counter_samples.append((t, self._depth, self._acc))

    @property
    def queue_samples(self) -> List[tuple]:
        """(t, ready-queue depth) at every depth change."""
        return [(t, d) for t, d, _ in self.counter_samples]

    @property
    def token_samples(self) -> List[tuple]:
        """(t, total accrued priority-seconds) at every change."""
        return [(t, a) for t, _, a in self.counter_samples]

    # -- views ----------------------------------------------------------
    @property
    def spans(self) -> List[Span]:
        """Finished spans plus still-open run/queued spans closed at
        ``last_t`` (reason ``open``), sorted by start time."""
        out = [Span(*s) for s in self._spans]
        for key, (tid, t0, prio, ten) in self._running.items():
            dev, slot = key if isinstance(key, tuple) else (key, -1)
            out.append(Span(tid, dev, t0, self.last_t, "run", prio, ten,
                            "open", slot))
        for tid, t0 in self._waiting.items():
            info = self._task.get(tid, (None, 0, t0))
            out.append(Span(tid, -1, t0, self.last_t, "queued",
                            info[1], info[0], "open"))
        out.sort(key=lambda s: (s.t0, s.t1, s.tid))
        return out

    def device_busy_seconds(self) -> Dict[int, float]:
        """Per-device total run-span seconds (open spans counted up to
        ``last_t``) — the event-derived analogue of
        ``DeviceState.busy_time`` (equal when checkpoint bytes and tile
        roundup are zero; see tests/test_obs_property.py)."""
        out: Dict[int, float] = {}
        for s in self.spans:
            if s.phase == "run":
                out[s.device] = out.get(s.device, 0.0) + (s.t1 - s.t0)
        return out

    # -- Chrome trace-event export --------------------------------------
    def to_chrome(self) -> dict:
        """The trace as a Chrome trace-event object (``traceEvents`` +
        ``displayTimeUnit``); ``export`` writes it to disk.  Timestamps
        are sim-seconds scaled to microseconds."""
        us = 1e6
        ev: List[dict] = []
        spans = self.spans

        def meta(pid, tid, key, name, idx=None):
            e = {"ph": "M", "pid": pid, "tid": tid, "name": key,
                 "args": {"name": name}}
            ev.append(e)
            if idx is not None:
                ev.append({"ph": "M", "pid": pid, "tid": tid,
                           "name": "thread_sort_index",
                           "args": {"sort_index": idx}})

        meta(1, 0, "process_name", "devices")
        meta(2, 0, "process_name", "tenants")
        meta(3, 0, "process_name", "telemetry")
        devices = sorted({s.device for s in spans if s.device >= 0}
                         | {d for d, *_ in self._down_spans})
        # slot runs render on per-(device, slot) sub-tracks grouped under
        # their device by sort_index (device at d*100, slots right after;
        # the track-id scheme assumes < 100 slots per device)
        slot_tracks = sorted({(s.device, s.slot) for s in spans
                              if s.phase == "run" and s.slot >= 0})
        for d in devices:
            meta(1, d, "thread_name", f"npu{d}", idx=d * 100)
        for d, sl in slot_tracks:
            meta(1, _slot_track(d, sl), "thread_name",
                 f"npu{d} slot{sl}", idx=d * 100 + sl + 1)
        meta(1, ADMISSION_TRACK, "thread_name", "admission",
             idx=ADMISSION_TRACK)

        tenants = sorted({s.tenant or "-" for s in spans})
        tenant_tid = {ten: i for i, ten in enumerate(tenants)}
        for ten, i in tenant_tid.items():
            meta(2, i, "thread_name", f"tenant {ten}", idx=i)

        for s in spans:
            if s.phase == "run":
                track = (s.device if s.slot < 0
                         else _slot_track(s.device, s.slot))
                ev.append({"ph": "X", "pid": 1, "tid": track,
                           "ts": s.t0 * us, "dur": (s.t1 - s.t0) * us,
                           "name": f"t{s.tid} p{s.priority}", "cat": "run",
                           "args": {"tid": s.tid, "tenant": s.tenant,
                                    "slot": s.slot, "end": s.reason}})
            # task lifecycle on the tenant process: nested async spans
            ttid = tenant_tid[s.tenant or "-"]
            ev.append({"ph": "b", "pid": 2, "tid": ttid, "ts": s.t0 * us,
                       "id": s.tid, "cat": "task",
                       "name": (f"t{s.tid} {s.phase}"
                                if s.phase == "queued"
                                else f"t{s.tid} run@{s.device}"),
                       "args": {"end": s.reason}})
            ev.append({"ph": "e", "pid": 2, "tid": ttid, "ts": s.t1 * us,
                       "id": s.tid, "cat": "task",
                       "name": f"t{s.tid} {s.phase}"})
        for d, t0, t1, label in self._down_spans:
            ev.append({"ph": "X", "pid": 1, "tid": d, "ts": t0 * us,
                       "dur": (t1 - t0) * us, "name": label, "cat": "fault",
                       "args": {}})
        for d, (t0, label) in self._down.items():   # still down at export
            ev.append({"ph": "X", "pid": 1, "tid": d, "ts": t0 * us,
                       "dur": (self.last_t - t0) * us, "name": label,
                       "cat": "fault", "args": {}})
        for t, kind, tid in self._admission:
            ev.append({"ph": "X", "pid": 1, "tid": ADMISSION_TRACK,
                       "ts": t * us, "dur": 0, "name": f"{kind} t{tid}",
                       "cat": "admission", "args": {"tid": tid}})
        for fid, cat, st, strack, dt, dtrack in self._flows:
            ev.append({"ph": "s", "pid": 1, "tid": strack, "ts": st * us,
                       "id": fid, "cat": "flow", "name": cat})
            ev.append({"ph": "f", "bp": "e", "pid": 1, "tid": dtrack,
                       "ts": dt * us, "id": fid, "cat": "flow", "name": cat})
        for t, depth in self.queue_samples:
            ev.append({"ph": "C", "pid": 3, "tid": 0, "ts": t * us,
                       "name": "queue_depth", "args": {"depth": depth}})
        for t, acc in self.token_samples:
            ev.append({"ph": "C", "pid": 3, "tid": 0, "ts": t * us,
                       "name": "tokens_accrued", "args": {"tokens": acc}})
        return {"traceEvents": ev, "displayTimeUnit": "ms"}

    def export(self, path: str) -> str:
        """Write Chrome/Perfetto JSON to ``path`` and return it."""
        with open(path, "w") as fp:
            json.dump(self.to_chrome(), fp)
        return path
