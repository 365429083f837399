# Copied from src/repro/obs/telemetry.py; `repro.` rewritten to `repro_torch.`.
"""Streaming telemetry: windowed counters + fixed-bucket histograms.

A :class:`Telemetry` subscriber folds the event stream into sim-time
windows *incrementally* — memory is O(windows × tenants), never
O(tasks): event counts and per-tenant SLA tallies are plain integer
bumps, latency distributions go into :class:`repro_torch.core.metrics.Histogram`
buckets, and continuous signals (queue depth, running devices, failed
devices) are time-weighted integrals advanced per event and split across
window boundaries.

NTT and SLA attainment need each task's isolated time and SLA scale,
which events don't carry — pass the offered task list to
:meth:`Telemetry.attach` (``Telemetry(cfg).attach(sim, tasks=trace.tasks())``)
to enable them; without it those keys are simply absent.

``snapshot()`` returns the whole timeseries as a dict;
``export_jsonl(path)`` writes one JSON line per window, which
``benchmarks/report.py --telemetry`` renders as a table.  Totals
reconcile exactly with :func:`repro_torch.core.metrics.summarize` on the same
run (counts equal, means to float tolerance) — pinned by
tests/test_obs.py.
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core import metrics

DEFAULT_NTT_EDGES = tuple(metrics.log_bucket_edges(0.5, 512.0, 21))
DEFAULT_TAT_EDGES = tuple(metrics.log_bucket_edges(1e-3, 1e4, 29))


@dataclasses.dataclass(frozen=True)
class TelemetryConfig:
    """``window`` is the sim-time bucket length (seconds); ``n_devices``
    seeds the alive-fleet baseline for utilization/availability (when
    None, the max device index seen + 1 is used at snapshot time —
    correct for fixed fleets, an approximation once elasticity kicks
    in)."""
    window: float = 60.0
    t0: float = 0.0
    n_devices: Optional[int] = None
    ntt_edges: Tuple[float, ...] = DEFAULT_NTT_EDGES
    turnaround_edges: Tuple[float, ...] = DEFAULT_TAT_EDGES
    # TTFT here is the scheduler-visible time-to-first-service (submit →
    # first dispatch of the attempt), the event-stream analogue of the
    # token-level TTFT in ``metrics.serving_summary``.
    ttft_edges: Tuple[float, ...] = DEFAULT_TAT_EDGES

    def __post_init__(self):
        if self.window <= 0.0:
            raise ValueError(
                f"window length must be > 0, got {self.window}")


_COUNT_KINDS = ("submit", "dispatch", "preempt", "complete", "drop",
                "retry", "abandon", "device_fail", "slo_alert")


class _Window:
    __slots__ = ("counts", "kills", "queue_int", "busy_int", "delta_int",
                 "failed_int", "ntt_hist", "tat_hist", "ttft_hist",
                 "per_tenant", "per_prio", "pred_n", "pred_abs",
                 "pred_signed")

    def __init__(self) -> None:
        self.counts = dict.fromkeys(_COUNT_KINDS, 0)
        self.kills = 0
        self.pred_n = 0          # completions with a usable prediction
        self.pred_abs = 0.0      # Σ |relative prediction error|
        self.pred_signed = 0.0   # Σ signed relative prediction error
        self.queue_int = 0.0    # ∫ queue depth dt
        self.busy_int = 0.0     # ∫ running-device count dt
        self.delta_int = 0.0    # ∫ (alive fleet − baseline) dt
        self.failed_int = 0.0   # ∫ failed-device count dt
        self.ntt_hist: Optional[metrics.Histogram] = None
        self.tat_hist: Optional[metrics.Histogram] = None
        self.ttft_hist: Optional[metrics.Histogram] = None
        # tenant/prio -> [n_complete, n_sla_met, ntt_sum]
        self.per_tenant: Dict[str, List[float]] = {}
        self.per_prio: Dict[int, List[float]] = {}


class Telemetry:
    """Windowed counters/histograms/integrals over the event stream."""

    def __init__(self, config: Optional[TelemetryConfig] = None) -> None:
        self.config = config or TelemetryConfig()
        self.reset()

    def reset(self) -> None:
        self._win: Dict[int, _Window] = {}
        self._inflight: Dict[int, float] = {}    # tid -> submit t
        self._await_first: Dict[int, float] = {}  # tid -> submit t until
        #                                           first dispatch (TTFT)
        self._resident: Dict[int, int] = {}      # device -> running tid
        self._iso: Dict[int, Tuple[float, float]] = {}  # tid -> (iso, scale)
        self._pred: Dict[int, float] = {}        # tid -> predicted runtime
        self._depth = 0
        self._busy = 0
        self._delta = 0          # alive-fleet change vs baseline
        self._failed = 0
        self._last_t = self.config.t0
        self._max_dev = -1
        self.last_t = self.config.t0
        self.n_events = 0
        self._detach = None

    # -- bus plumbing ---------------------------------------------------
    def attach(self, layer_or_bus, tasks: Optional[Sequence] = None
               ) -> "Telemetry":
        """Subscribe to the layer's bus.  ``tasks`` (any iterable of
        objects with ``tid``/``isolated_time``/``sla_scale``) enables
        NTT and SLA-attainment series."""
        bus = getattr(layer_or_bus, "events", layer_or_bus)
        bus.subscribe("*", self)
        self._detach = lambda: bus.unsubscribe("*", self)
        if tasks is not None:
            for t in tasks:
                scale = getattr(t, "sla_scale", None)
                self._iso[t.tid] = (
                    t.isolated_time,
                    scale if scale is not None else metrics.DEFAULT_SLA_SCALE)
                pred = getattr(t, "predicted_total", None)
                if pred is not None:
                    self._pred[t.tid] = float(pred)
        return self

    def detach(self) -> None:
        if self._detach is not None:
            self._detach()
            self._detach = None

    # -- incremental folding --------------------------------------------
    def _window(self, idx: int) -> _Window:
        w = self._win.get(idx)
        if w is None:
            w = self._win[idx] = _Window()
        return w

    def _advance(self, t: float) -> None:
        """Distribute the constant-valued integrands over [last_t, t),
        splitting at window boundaries — O(windows crossed)."""
        cfg, lo = self.config, self._last_t
        if t <= lo:
            return
        k = metrics.window_index(lo, cfg.window, cfg.t0)
        while lo < t:
            hi = min(t, cfg.t0 + (k + 1) * cfg.window)
            dt = hi - lo
            if self._depth or self._busy or self._delta or self._failed:
                w = self._window(k)
                w.queue_int += self._depth * dt
                w.busy_int += self._busy * dt
                w.delta_int += self._delta * dt
                w.failed_int += self._failed * dt
            lo = hi
            k += 1
        self._last_t = t

    def __call__(self, ev) -> None:
        t, kind, tid = ev.t, ev.kind, ev.tid
        self.n_events += 1
        self._advance(t)
        if t > self.last_t:
            self.last_t = t
        if ev.device > self._max_dev:
            self._max_dev = ev.device
        w = self._window(metrics.window_index(t, self.config.window,
                                              self.config.t0))
        c = w.counts
        if kind in c:
            c[kind] += 1
        if kind == "submit":
            self._depth += 1
            self._inflight[tid] = t
            self._await_first[tid] = t
        elif kind == "dispatch":
            self._depth -= 1
            self._busy += 1
            slot_key = ev.device if ev.slot < 0 else (ev.device, ev.slot)
            self._resident[slot_key] = tid
            t_sub = self._await_first.pop(tid, None)
            if t_sub is not None:
                if w.ttft_hist is None:
                    w.ttft_hist = metrics.Histogram(self.config.ttft_edges)
                w.ttft_hist.add(t - t_sub)
        elif kind == "preempt":
            self._depth += 1
            self._busy -= 1
            self._resident.pop(
                ev.device if ev.slot < 0 else (ev.device, ev.slot), None)
            if ev.mechanism == "kill":
                w.kills += 1
        elif kind == "complete":
            self._busy -= 1
            self._resident.pop(
                ev.device if ev.slot < 0 else (ev.device, ev.slot), None)
            self._complete(w, ev, t)
        elif kind == "drop":
            self._depth -= 1
            self._inflight.pop(tid, None)
            self._await_first.pop(tid, None)
        elif kind == "device_fail":
            # failed capacity lives in failed_int alone (delta_int tracks
            # elastic up/down), or `alive` would double-subtract the crash
            self._failed += 1
            # crashed residents re-queue without a task event: they stop
            # accruing busy time now and re-enter the queue (a batched
            # device may hold several, one per slot key)
            keys = [k for k in self._resident
                    if k == ev.device or (isinstance(k, tuple)
                                          and k[0] == ev.device)]
            for k in keys:
                self._resident.pop(k)
                self._busy -= 1
                self._depth += 1
        elif kind == "device_recover":
            self._failed -= 1
        elif kind == "device_up":
            self._delta += 1
        elif kind == "device_down":
            self._delta -= 1

    def _complete(self, w: _Window, ev, t: float) -> None:
        t_sub = self._inflight.pop(ev.tid, None)
        if t_sub is None:
            return
        tat = t - t_sub
        if w.tat_hist is None:
            w.tat_hist = metrics.Histogram(self.config.turnaround_edges)
        w.tat_hist.add(tat)
        iso = self._iso.get(ev.tid)
        ten = ev.tenant if ev.tenant is not None else "-"
        row = w.per_tenant.setdefault(ten, [0, 0, 0.0])
        prow = w.per_prio.setdefault(int(ev.priority), [0, 0, 0.0])
        row[0] += 1
        prow[0] += 1
        if iso is not None:
            ntt = tat / iso[0]
            met = tat <= iso[1] * iso[0]
            if w.ntt_hist is None:
                w.ntt_hist = metrics.Histogram(self.config.ntt_edges)
            w.ntt_hist.add(ntt)
            row[1] += met
            row[2] += ntt
            prow[1] += met
            prow[2] += ntt
            pred = self._pred.get(ev.tid)
            # degenerate pairs (NaN prediction, zero actual) are skipped,
            # matching metrics.prediction_errors
            if pred is not None and iso[0] > 0.0 and math.isfinite(pred):
                err = (pred - iso[0]) / iso[0]
                w.pred_n += 1
                w.pred_abs += abs(err)
                w.pred_signed += err

    # -- views ----------------------------------------------------------
    def _n_devices(self) -> int:
        if self.config.n_devices is not None:
            return self.config.n_devices
        return max(self._max_dev + 1, 1)

    def _row(self, k: int, w: _Window, n_dev: int) -> Dict:
        cfg = self.config
        t0 = cfg.t0 + k * cfg.window
        t1 = t0 + cfg.window
        # the last window of a run is partial: normalize rates by the
        # observed fraction so a half-full window isn't half-idle
        span = min(t1, max(self.last_t, t0)) - t0 or cfg.window
        alive = n_dev * span + w.delta_int - w.failed_int
        row = {"t0": t0, "t1": t1, **w.counts, "kills": w.kills,
               "queue_depth_mean": w.queue_int / span,
               "busy_device_seconds": w.busy_int,
               "utilization": w.busy_int / max(alive, 1e-12),
               "availability": 1.0 - w.failed_int / max(n_dev * span, 1e-12),
               "preemption_rate": w.counts["preempt"] / span}
        for name, h in (("ntt", w.ntt_hist), ("turnaround", w.tat_hist),
                        ("ttft", w.ttft_hist)):
            if h is not None:
                row[f"{name}_mean"] = h.mean()
                for p in metrics.PERCENTILES:
                    row[f"{name}_p{p}"] = h.percentile(p)
        if w.pred_n:
            row["pred_mape"] = w.pred_abs / w.pred_n
            row["pred_bias"] = w.pred_signed / w.pred_n
        def classed(rows):
            return {str(key): {
                "n": r[0],
                "sla_attainment": (r[1] / r[0] if r[0] and self._iso
                                   else float("nan")),
                "ntt_mean": (r[2] / r[0] if r[0] and self._iso
                             else float("nan"))}
                for key, r in sorted(rows.items())}
        if w.per_tenant:
            row["per_tenant"] = classed(w.per_tenant)
        if w.per_prio:
            row["per_priority"] = classed(w.per_prio)
        return row

    def snapshot(self) -> Dict:
        """The full timeseries plus run totals, as plain dicts.  Totals
        reconcile with ``metrics.summarize`` on the same run: counts
        exactly, means to float tolerance (incremental sums vs numpy's
        pairwise summation)."""
        self._advance(self.last_t)
        n_dev = self._n_devices()
        windows = [dict(index=k, **self._row(k, w, n_dev))
                   for k, w in sorted(self._win.items())]
        totals: Dict[str, float] = dict.fromkeys(_COUNT_KINDS, 0)
        totals["kills"] = 0
        ntt_n = ntt_sum = met_sum = 0.0
        for w in self._win.values():
            for kk, v in w.counts.items():
                totals[kk] += v
            totals["kills"] += w.kills
            for r in w.per_tenant.values():
                ntt_n += r[0]
                met_sum += r[1]
                ntt_sum += r[2]
        if self._iso and ntt_n:
            totals["ntt_mean"] = ntt_sum / ntt_n
            totals["sla_attainment"] = met_sum / ntt_n
        return {"window": self.config.window, "t0": self.config.t0,
                "n_devices": n_dev, "n_events": self.n_events,
                "last_t": self.last_t, "windows": windows,
                "totals": totals}

    def export_jsonl(self, path: str) -> str:
        """One header line + one JSON line per window (sorted by index);
        rendered by ``benchmarks/report.py --telemetry``."""
        snap = self.snapshot()
        with open(path, "w") as fp:
            fp.write(json.dumps(
                {"version": 1, "kind": "telemetry",
                 "window": snap["window"], "t0": snap["t0"],
                 "n_devices": snap["n_devices"],
                 "n_windows": len(snap["windows"]),
                 "totals": snap["totals"]}, sort_keys=True) + "\n")
            for row in snap["windows"]:
                fp.write(json.dumps(row, sort_keys=True) + "\n")
        return path
