# Copied from src/repro/workloads/trace_io.py; `repro.` rewritten to `repro_torch.`.
"""Trace record/replay: JSONL export and deterministic reload.

A :class:`Trace` is the replayable unit of this subsystem: an ordered list
of :class:`~repro_torch.workloads.spec.TaskSpec` records plus mix metadata.
``save``/``load`` round-trip it through JSONL (one header line, then one
record per line), and :meth:`Trace.tasks` materializes *fresh* Task objects
on every call — so the same trace can drive any number of policy runs, each
starting from pristine dynamic state, across the single-NPU simulator, the
cluster simulator, and the serving engine, with bit-identical inputs.

An :class:`ExecutedTrace` is the other direction: a capture of what
actually *ran* — the dispatch/preempt/complete/drop timeline from the
shared event bus (``core/events.py``), with device and mechanism — in the
same JSONL framing.  It round-trips losslessly (save → load → identical
events), replays through any :class:`~repro_torch.core.events.EventBus`, and
:meth:`ExecutedTrace.diff` compares it against the *offered* trace
(queueing delays, sheds, tasks offered but never run).
"""
from __future__ import annotations

import dataclasses
import json
from typing import IO, Dict, List, Optional, Sequence, Union

from repro_torch.core.events import Event, EventBus
from repro_torch.core.predictor import Predictor
from repro_torch.core.task import Task
from repro_torch.workloads.spec import TaskSpec, materialize_task

TRACE_FORMAT_VERSION = 1


@dataclasses.dataclass
class Trace:
    """An ordered, replayable set of sampled task records."""
    records: List[TaskSpec]
    kind: str = "paper"                 # "paper" | "serving"
    meta: Dict = dataclasses.field(default_factory=dict)
    # bound at generation/load time; not serialized
    pred: Optional[Predictor] = None
    _fresh: Optional[List[Task]] = dataclasses.field(
        default=None, repr=False, compare=False)

    def __len__(self) -> int:
        return len(self.records)

    # ------------------------------------------------------------------
    def tasks(self, pred: Optional[Predictor] = None) -> List[Task]:
        """Materialize fresh :class:`Task` objects (paper-kind traces).

        Every call returns brand-new tasks with pristine dynamic state;
        materialization is RNG-free, so repeated calls are bit-identical.
        """
        if self.kind != "paper":
            raise ValueError(
                f"{self.kind!r} traces materialize into serving requests; "
                "use repro_torch.workloads.to_requests(trace, models)")
        pred = pred or self.pred
        if pred is None:
            raise ValueError("trace is not bound to a Predictor; "
                             "pass one to tasks(pred)")
        if self._fresh is not None and pred is self.pred:
            out, self._fresh = self._fresh, None   # one-shot generation cache
            return out
        return [materialize_task(s, pred) for s in self.records]

    # ------------------------------------------------------------------
    def save(self, path_or_fp: Union[str, IO[str]]) -> None:
        """Write JSONL: a header line, then one record per line."""
        header = {"version": TRACE_FORMAT_VERSION, "kind": self.kind,
                  "n_records": len(self.records), "meta": self.meta}
        if hasattr(path_or_fp, "write"):
            self._write(path_or_fp, header)
        else:
            with open(path_or_fp, "w") as fp:
                self._write(fp, header)

    def _write(self, fp: IO[str], header: Dict) -> None:
        fp.write(json.dumps(header, sort_keys=True) + "\n")
        for rec in self.records:
            fp.write(json.dumps(rec.to_json(), sort_keys=True) + "\n")

    @classmethod
    def load(cls, path_or_fp: Union[str, IO[str]],
             pred: Optional[Predictor] = None) -> "Trace":
        if hasattr(path_or_fp, "read"):
            lines = [ln for ln in path_or_fp.read().splitlines() if ln]
        else:
            with open(path_or_fp) as fp:
                lines = [ln for ln in fp.read().splitlines() if ln]
        if not lines:
            raise ValueError("empty trace file")
        header = json.loads(lines[0])
        version = header.get("version")
        if version != TRACE_FORMAT_VERSION:
            raise ValueError(f"unsupported trace version {version!r}")
        records = [TaskSpec.from_json(json.loads(ln)) for ln in lines[1:]]
        if header.get("n_records") not in (None, len(records)):
            raise ValueError(
                f"truncated trace: header says {header['n_records']} "
                f"records, file has {len(records)}")
        return cls(records=records, kind=header.get("kind", "paper"),
                   meta=header.get("meta", {}), pred=pred)


@dataclasses.dataclass
class ExecutedTrace:
    """What actually ran: an ordered capture of the execution event stream.

    ``capture`` snapshots a layer's event bus after (or during) a run;
    ``save``/``load`` round-trip the JSONL form; ``replay`` re-emits the
    events through a bus, driving any subscriber exactly as the original
    run did — same-seed capture → save → load → replay reproduces the
    original event log bit-identically (tests/test_events.py).
    """
    events: List[Event]
    meta: Dict = dataclasses.field(default_factory=dict)

    def __len__(self) -> int:
        return len(self.events)

    @classmethod
    def capture(cls, layer_or_bus, meta: Optional[Dict] = None
                ) -> "ExecutedTrace":
        """Snapshot the event log of an execution layer (anything with an
        ``events`` bus: NPUSimulator, ClusterSimulator, ServingEngine) or
        of a bare :class:`EventBus`.

        The capture *aliases* ``bus.log`` rather than copying it — on a
        million-event run a copy would briefly double peak RSS for no
        benefit.  The alias is safe: ``bus.clear()`` (start of the next
        run) rebinds ``bus.log`` to a fresh list, so the captured timeline
        is never mutated behind the trace's back.  For runs too large to
        hold in memory at all, stream instead
        (:class:`repro_torch.core.events.JsonlSpool` with ``keep_log=False``).
        """
        bus = getattr(layer_or_bus, "events", layer_or_bus)
        return cls(events=bus.log, meta=dict(meta or {}))

    # ------------------------------------------------------------------
    def save(self, path_or_fp: Union[str, IO[str]]) -> None:
        header = {"version": TRACE_FORMAT_VERSION, "kind": "executed",
                  "n_records": len(self.events), "meta": self.meta}
        if hasattr(path_or_fp, "write"):
            self._write(path_or_fp, header)
        else:
            with open(path_or_fp, "w") as fp:
                self._write(fp, header)

    def _write(self, fp: IO[str], header: Dict) -> None:
        fp.write(json.dumps(header, sort_keys=True) + "\n")
        for ev in self.events:
            fp.write(json.dumps(ev.to_json(), sort_keys=True) + "\n")

    @classmethod
    def load(cls, path_or_fp: Union[str, IO[str]]) -> "ExecutedTrace":
        if hasattr(path_or_fp, "read"):
            lines = [ln for ln in path_or_fp.read().splitlines() if ln]
        else:
            with open(path_or_fp) as fp:
                lines = [ln for ln in fp.read().splitlines() if ln]
        if not lines:
            raise ValueError("empty executed-trace file")
        header = json.loads(lines[0])
        if header.get("version") != TRACE_FORMAT_VERSION:
            raise ValueError(
                f"unsupported trace version {header.get('version')!r}")
        if header.get("kind") != "executed":
            raise ValueError(
                f"not an executed trace (kind={header.get('kind')!r}); "
                "use Trace.load for offered traces")
        body = lines[1:]
        try:
            events = [Event.from_json(json.loads(ln)) for ln in body]
        except (json.JSONDecodeError, KeyError, TypeError, ValueError):
            if header.get("n_records") is not None:
                raise
            # Streaming spools (JsonlSpool) omit n_records because the
            # count is unknowable while the run is live; a killed run
            # leaves a half-written final line.  Salvage everything up
            # to it — mid-file corruption still raises below.
            events = []
            for i, ln in enumerate(body):
                try:
                    events.append(Event.from_json(json.loads(ln)))
                except (json.JSONDecodeError, KeyError, TypeError,
                        ValueError):
                    if i != len(body) - 1:
                        raise ValueError(
                            f"corrupt executed trace: unparseable event "
                            f"at line {i + 2} (not the final line)")
                    break
        if header.get("n_records") not in (None, len(events)):
            raise ValueError(
                f"truncated trace: header says {header['n_records']} "
                f"events, file has {len(events)}")
        return cls(events=events, meta=header.get("meta", {}))

    # ------------------------------------------------------------------
    def replay(self, bus: Optional[EventBus] = None) -> EventBus:
        """Re-emit every captured event through ``bus`` (a fresh one when
        omitted), driving its subscribers in original order; returns the
        bus, whose log then equals ``self.events``."""
        bus = bus if bus is not None else EventBus()
        for ev in self.events:
            bus.emit(ev)
        return bus

    # ------------------------------------------------------------------
    def per_task(self) -> Dict[int, Dict]:
        """Fold the timeline into per-task facts: submit/first-dispatch/
        completion times, preemption/retry counts, drop/abandon flags,
        device set.  One row per *logical* task: a retried tid keeps a
        single row whose ``n_submits`` counts the attempts, and
        ``dropped`` reflects the final outcome (an admission drop
        followed by a successful re-offer is not a dropped task)."""
        out: Dict[int, Dict] = {}
        for ev in self.events:
            if ev.tid < 0:
                continue    # device lifecycle events are not task-scoped
            row = out.setdefault(ev.tid, {
                "submit": None, "dispatch": None, "complete": None,
                "dropped": False, "abandoned": False, "n_submits": 0,
                "n_retries": 0, "n_preemptions": 0, "devices": []})
            if ev.kind == "submit":
                if row["submit"] is None:
                    row["submit"] = ev.t
                row["n_submits"] += 1
            elif ev.kind == "dispatch":
                if row["dispatch"] is None:
                    row["dispatch"] = ev.t
                if ev.device not in row["devices"]:
                    row["devices"].append(ev.device)
                row["dropped"] = False   # a later attempt was admitted
            elif ev.kind == "preempt":
                row["n_preemptions"] += 1
            elif ev.kind == "complete":
                row["complete"] = ev.t
                row["dropped"] = False
            elif ev.kind == "drop":
                row["dropped"] = True
            elif ev.kind == "retry":
                row["n_retries"] += 1
            elif ev.kind == "abandon":
                row["abandoned"] = True
        return out

    def diff(self, offered: "Trace") -> Dict:
        """Offered-vs-executed comparison: which offered tasks were shed
        or never ran, which executed tasks were not in the offered trace
        (e.g. closed-loop injections), and how far execution drifted from
        the offer (queueing delay, arrival skew).

        Counts are per *logical* task (``per_task`` folds retried
        attempts into one row), so ``n_submitted == n_completed +
        n_dropped + n_in_flight`` stays exact under client retries:
        ``n_dropped`` is final-outcome drops, attempts show up in
        ``n_attempts``/``n_retries`` instead."""
        per = self.per_task()
        offered_at = {rec.tid: rec.arrival for rec in offered.records}
        ran = {tid: row for tid, row in per.items()
               if row["dispatch"] is not None}
        delays = [row["dispatch"] - row["submit"] for row in per.values()
                  if row["dispatch"] is not None and row["submit"] is not None]
        skews = [abs(per[tid]["submit"] - offered_at[tid])
                 for tid in offered_at
                 if tid in per and per[tid]["submit"] is not None]
        return {
            "n_offered": len(offered_at),
            "n_submitted": len(per),
            "n_attempts": sum(r["n_submits"] for r in per.values()),
            "n_executed": len(ran),
            "n_completed": sum(1 for r in per.values()
                               if r["complete"] is not None),
            "n_dropped": sum(1 for r in per.values() if r["dropped"]),
            "n_retries": sum(r["n_retries"] for r in per.values()),
            "n_abandoned": sum(1 for r in per.values() if r["abandoned"]),
            "n_preemptions": sum(r["n_preemptions"] for r in per.values()),
            "dropped": sorted(t for t, r in per.items() if r["dropped"]),
            "never_ran": sorted(t for t in offered_at
                                if t not in ran),
            "not_offered": sorted(t for t in per if t not in offered_at),
            "mean_queue_delay": (sum(delays) / len(delays)) if delays else 0.0,
            "max_arrival_skew": max(skews, default=0.0),
        }


def as_task_list(obj: Union[Trace, Sequence[Task]],
                 pred: Optional[Predictor] = None) -> List[Task]:
    """Normalize a run() input: a Trace materializes fresh tasks, a plain
    sequence passes through unchanged."""
    if isinstance(obj, Trace) or (hasattr(obj, "records")
                                  and callable(getattr(obj, "tasks", None))):
        return obj.tasks(pred)
    return list(obj)
