# Copied from src/repro/core/autoscaler.py; `repro.` rewritten to `repro_torch.`.
"""Event-driven autoscaling: elastic capacity as an EventBus subscriber.

The autoscaler closes the loop the ROADMAP asked for: it watches the
shared execution event stream (``core/events.py``) — the same
``submit``/``dispatch``/``preempt``/``complete``/``drop`` timeline every
execution layer emits — reconstructs the ready-queue depth and a sliding
SLA-attainment window from it, and drives ``add_device`` /
``remove_device`` on the attached layer (``ClusterSimulator`` or
``ServingEngine``) within configured bounds.

Signals
-------
* **Queue depth** — submits and preemption re-queues push, dispatches and
  drops pop; the time-weighted mean over ``window`` seconds, normalized
  by the live device count, is compared against
  ``target_queue_per_device`` (scale up) and ``low_watermark`` of it
  (scale down).
* **SLA attainment** (optional) — when ``sla_latency`` is set, the
  fraction of window completions whose turnaround beat that budget; a
  window below ``sla_target`` forces a scale-up even if the queue looks
  shallow (latency pain without backlog: slow devices, long residents).
* **Failures** (optional) — with ``replace_failed`` on, every
  ``device_fail`` event (``core/faults.py``) provisions one replacement
  device within ``max_devices``; fault events are otherwise excluded
  from the load signal, and scale-down retires the surplus after the
  crashed device recovers.

Decisions respect ``cooldown`` sim-seconds between actions and the
``[min_devices, max_devices]`` bounds; scale-down prefers an idle device
(slowest first, then the youngest), so draining rarely has to migrate.
Every action lands on the bus as ``device_up``/``device_drain``/
``device_down``, making autoscaler runs replayable and bit-deterministic
for a fixed seed (tests/test_autoscaler.py).
"""
from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

from repro_torch.core.events import DEVICE_EVENT_KINDS, FAULT_EVENT_KINDS, Event
from repro_torch.hw import HardwareModel


@dataclasses.dataclass
class AutoscalerConfig:
    """Scaling policy knobs (times are sim-seconds)."""

    min_devices: int = 1
    max_devices: int = 8
    # Scale up when the window-averaged queue depth per live device
    # exceeds this; scale down when it falls below low_watermark * target.
    target_queue_per_device: float = 2.0
    low_watermark: float = 0.25
    window: float = 0.1
    cooldown: float = 0.05
    scale_step: int = 1
    # Optional SLA-attainment trigger: turnaround budget (absolute
    # seconds) and the minimum on-time fraction of window completions.
    sla_latency: Optional[float] = None
    sla_target: float = 0.9
    # HardwareModel for scale-up devices (None -> the layer's reference).
    device_hw: Optional[HardwareModel] = None
    # Provision a replacement on every ``device_fail`` (within
    # max_devices), restoring capacity while the crashed device repairs;
    # scale-down retires the surplus once the failure heals.
    replace_failed: bool = False
    # Disaggregated pools (batched serving): when not "any", this
    # autoscaler manages only the devices of that pool role — scale-ups
    # join with the role, scale-downs and the [min, max] bounds consider
    # only that pool, so a prefill and a decode autoscaler can run
    # side-by-side on one engine without fighting over capacity.
    pool_role: str = "any"
    # Predictive lookahead (sim-seconds).  0 = reactive only (the
    # historical behavior, bit-identical).  > 0 sizes the fleet from
    # *predicted arriving work*: each submit contributes its task's
    # predicted runtime (``attach(layer, tasks=...)`` supplies the
    # predictions), a double-exponential smoother over the work-arrival
    # stream extrapolates the rate ``lookahead`` seconds ahead, and the
    # fleet is driven toward ``ceil(forecast / target_util)`` devices —
    # provisioning ahead of a diurnal ramp instead of after the backlog
    # builds.
    lookahead: float = 0.0
    target_util: float = 0.75

    def __post_init__(self):
        if self.min_devices < 1:
            raise ValueError("min_devices must be >= 1")
        if self.max_devices < self.min_devices:
            raise ValueError("max_devices must be >= min_devices")
        if not 0.0 <= self.low_watermark < 1.0:
            raise ValueError("low_watermark must be in [0, 1)")
        if self.pool_role not in ("any", "prefill", "decode"):
            raise ValueError(f"unknown pool_role {self.pool_role!r}")
        if self.lookahead < 0.0:
            raise ValueError("lookahead must be >= 0")
        if not 0.0 < self.target_util <= 1.0:
            raise ValueError("target_util must be in (0, 1]")


class Autoscaler:
    """Subscribe to a layer's event bus and drive its elastic capacity.

    Usage::

        scaler = Autoscaler(AutoscalerConfig(max_devices=4)).attach(sim)
        sim.run(trace)
        scaler.decisions          # [(t, "up"/"down", device), ...]

    The subscriber persists across runs; call :meth:`reset` (or rely on
    the automatic rewind detection — sim time restarting near zero) when
    reusing one instance for several runs.
    """

    def __init__(self, cfg: Optional[AutoscalerConfig] = None):
        self.cfg = cfg or AutoscalerConfig()
        self.layer = None
        self.decisions: List[Tuple[float, str, int]] = []
        self._samples: Deque[Tuple[float, float]] = deque()
        self._area = 0.0           # integral of depth dt over the samples
        self._completions: Deque[Tuple[float, bool]] = deque()
        self._submit_t: Dict[int, float] = {}
        self._backlog = 0
        self._last_t = 0.0
        self._last_action = None   # None until the first action
        self._in_decision = False
        self._pred: Dict[int, float] = {}       # tid -> predicted runtime
        self._pred_mean = 0.0
        self._arrivals: Deque[Tuple[float, float]] = deque()

    # -- wiring --------------------------------------------------------
    def attach(self, layer, tasks=None) -> "Autoscaler":
        """Subscribe to ``layer.events``; the layer must expose
        ``add_device``/``remove_device`` and ``cluster`` (the shared
        ``core.cluster.Cluster`` bookkeeping).  ``tasks`` supplies the
        offered task list so lookahead mode knows each submission's
        predicted runtime (events carry only tids); unknown tids fall
        back to the mean of the known predictions."""
        self.layer = layer
        if tasks is not None:
            self._pred = {t.tid: float(t.predicted_total) for t in tasks}
        self._pred_mean = (sum(self._pred.values()) / len(self._pred)
                           if self._pred else 0.0)
        layer.events.subscribe("*", self._on_event)
        return self

    def detach(self) -> None:
        """Unsubscribe from the attached layer's bus (no-op if detached)."""
        if self.layer is not None:
            self.layer.events.unsubscribe("*", self._on_event)
            self.layer = None

    def reset(self) -> None:
        """Clear accumulated signal and decision history between runs."""
        self.decisions = []
        self._samples.clear()
        self._area = 0.0
        self._completions.clear()
        self._submit_t.clear()
        self._backlog = 0
        self._last_t = 0.0
        self._last_action = None
        self._arrivals.clear()

    @property
    def n_scale_events(self) -> int:
        """Total scale-up + scale-down actions taken this run."""
        return len(self.decisions)

    # -- signal maintenance --------------------------------------------
    def _on_event(self, ev: Event) -> None:
        if ev.kind in FAULT_EVENT_KINDS:
            # capacity churn, not offered load: keep failures out of the
            # backlog signal, but optionally provision a replacement
            if ev.kind == "device_fail" and self.cfg.replace_failed:
                self._replace(ev.t, ev.device)
            return
        if ev.kind in DEVICE_EVENT_KINDS:
            return  # our own actions are not a load signal
        if self._samples and ev.t < self._last_t:
            # A fresh run restarts the sim clock near zero: detect it as a
            # rewind past our whole observation window AND past the oldest
            # sample we hold.  Anything smaller is per-device clock skew
            # (the ServingEngine stamps events on per-device virtual
            # clocks, which are not globally monotone): monotonize it so
            # the windowed integral never sees negative time slices.
            if (ev.t + self.cfg.window < self._last_t
                    and ev.t < self._samples[0][0]):
                self.reset()
            else:
                ev = ev._replace(t=self._last_t)
        self._last_t = ev.t
        if ev.kind == "submit":
            self._backlog += 1
            self._submit_t[ev.tid] = ev.t
            if self.cfg.lookahead > 0.0:
                self._arrivals.append(
                    (ev.t, self._pred.get(ev.tid, self._pred_mean)))
        elif ev.kind == "dispatch":
            self._backlog -= 1
        elif ev.kind == "preempt":
            self._backlog += 1
        elif ev.kind == "drop":
            self._backlog -= 1
            self._submit_t.pop(ev.tid, None)
        elif ev.kind == "complete":
            t0 = self._submit_t.pop(ev.tid, None)
            if self.cfg.sla_latency is not None and t0 is not None:
                ok = (ev.t - t0) <= self.cfg.sla_latency
                self._completions.append((ev.t, ok))
        if self._samples:
            t_prev, d_prev = self._samples[-1]
            self._area += d_prev * (ev.t - t_prev)
        self._samples.append((ev.t, float(self._backlog)))
        self._prune(ev.t)
        if not self._in_decision:
            self._in_decision = True
            try:
                self._decide(ev.t)
            finally:
                self._in_decision = False

    def _prune(self, now: float) -> None:
        horizon = now - self.cfg.window
        while len(self._samples) > 1 and self._samples[1][0] <= horizon:
            t0, d0 = self._samples.popleft()
            self._area -= d0 * (self._samples[0][0] - t0)
        while self._completions and self._completions[0][0] <= horizon:
            self._completions.popleft()
        # the forecast kernel decays exponentially with time constant
        # ``window``: arrivals older than 4 windows contribute < 2 % and
        # can be dropped without visibly moving the estimate
        arr_horizon = now - 4.0 * self.cfg.window
        while self._arrivals and self._arrivals[0][0] <= arr_horizon:
            self._arrivals.popleft()

    def _avg_depth(self, now: float) -> float:
        """Time-weighted mean queue depth over the sliding window, from
        the incrementally-maintained integral (O(1) per event; _prune
        keeps at most one sample older than the window as the carrier of
        the depth at the window's left edge)."""
        if not self._samples:
            return 0.0
        t_first, d_first = self._samples[0]
        t_last, d_last = self._samples[-1]
        start = max(t_first, now - self.cfg.window)
        span = now - start
        if span <= 0.0:
            return d_last
        area = self._area + d_last * (now - t_last)
        if t_first < start:
            # clip the first segment's pre-window part (it runs at
            # d_first until the next sample, or until now if alone)
            t_next = self._samples[1][0] if len(self._samples) > 1 else now
            area -= d_first * (min(t_next, start) - t_first)
        return area / span

    def _sla_bad(self) -> bool:
        if self.cfg.sla_latency is None or not self._completions:
            return False
        ok = sum(1 for _, met in self._completions if met)
        return ok / len(self._completions) < self.cfg.sla_target

    def _forecast_work(self, now: float) -> float:
        """Predicted work-arrival rate (device-equivalents of predicted
        seconds per second) ``lookahead`` seconds ahead.  Two exponential
        kernels over the predicted-cost arrival stream — a fast one
        (``window / 2``) and a slow one (``window``) — give smoothed rate
        estimates at two effective ages; their difference over the age
        gap is the trend, extrapolated ``lookahead`` seconds past the
        fast kernel's lag.  On a diurnal ramp the fast estimate leads the
        slow one and the forecast leads both; per-task cost variance,
        which a boxcar split-half slope amplifies into capacity churn, is
        damped by the exponential weighting."""
        tau_f = self.cfg.window / 2.0
        tau_s = self.cfg.window
        if tau_f <= 0.0:
            return 0.0
        r_f = r_s = 0.0
        for t, c in self._arrivals:
            if t > now:
                continue
            r_f += (c / tau_f) * math.exp(-(now - t) / tau_f)
            r_s += (c / tau_s) * math.exp(-(now - t) / tau_s)
        trend = (r_f - r_s) / (tau_s - tau_f)
        return max(0.0, r_f + trend * (self.cfg.lookahead + tau_f))

    # -- decisions ------------------------------------------------------
    def _pool_alive(self) -> int:
        """Live device count within the managed pool (all devices when
        ``pool_role == "any"``; role-matching ones otherwise)."""
        if self.cfg.pool_role == "any":
            return self.layer.cluster.n_alive
        return sum(1 for d in self.layer.cluster.devices
                   if d.alive and not d.draining and not d.failed
                   and d.role == self.cfg.pool_role)

    def _add_device(self):
        """Provision one device, joining it to the managed pool."""
        if self.cfg.pool_role != "any":
            return self.layer.add_device(self.cfg.device_hw,
                                         role=self.cfg.pool_role)
        return self.layer.add_device(self.cfg.device_hw)

    def _replace(self, now: float, failed_dev: int) -> None:
        """React to a crash: add one device so serving capacity is back
        before the failed unit repairs.  Repair, not reactive scaling —
        it bypasses the cooldown, but still counts as the last action so
        the fresh device is not drained before it finishes provisioning
        (``n_alive`` already excludes the failed device, so the bound
        check naturally leaves room for the replacement)."""
        if self._pool_alive() >= self.cfg.max_devices:
            return
        dev = self._add_device()
        self.decisions.append((now, "replace", dev))
        self._last_action = now

    def _decide(self, now: float) -> None:
        cfg = self.cfg
        if self._last_action is not None and now - self._last_action < cfg.cooldown:
            return
        if cfg.lookahead > 0.0:
            self._decide_lookahead(now)
            return
        n_alive = self._pool_alive()
        depth = self._avg_depth(now)
        up_thr = cfg.target_queue_per_device * n_alive
        if (depth > up_thr or self._sla_bad()) and n_alive < cfg.max_devices:
            for _ in range(min(cfg.scale_step, cfg.max_devices - n_alive)):
                dev = self._add_device()
                self.decisions.append((now, "up", dev))
            self._last_action = now
        elif (
            depth < cfg.low_watermark * up_thr
            and not self._sla_bad()
            and n_alive > cfg.min_devices
        ):
            dev = self._drain_candidate()
            if dev is not None:
                self.layer.remove_device(dev)
                self.decisions.append((now, "down", dev))
                self._last_action = now

    def _decide_lookahead(self, now: float) -> None:
        """Forecast-driven sizing: scale toward ``ceil(forecast /
        target_util)`` devices (with a 0.1-device deadband so a forecast
        hovering at a capacity boundary does not thrash), keeping only an
        emergency depth trigger — backlog past twice the up-threshold —
        as the backstop for forecast misses.  Scale-down releases
        capacity as soon as the forecast says it is surplus (the queue
        must merely be under the up-threshold, not drained) —
        anticipating the diurnal down-ramp is where the device-second
        savings come from.  Every avoided up/down cycle also avoids
        paying ``provision_latency`` in dead capacity-seconds, so the
        decision rule is deliberately less trigger-happy than the
        reactive path."""
        cfg = self.cfg
        n_alive = self._pool_alive()
        depth = self._avg_depth(now)
        up_thr = cfg.target_queue_per_device * n_alive
        raw = self._forecast_work(now) / cfg.target_util
        n_target = min(cfg.max_devices, max(cfg.min_devices, math.ceil(raw - 0.1)))
        emergency = depth > 2.0 * up_thr
        if (n_target > n_alive or emergency) and n_alive < cfg.max_devices:
            want = max(n_target - n_alive, cfg.scale_step if emergency else 1)
            for _ in range(min(want, cfg.max_devices - n_alive)):
                dev = self._add_device()
                self.decisions.append((now, "up", dev))
            self._last_action = now
        elif n_target < n_alive and depth <= up_thr and n_alive > cfg.min_devices:
            dev = self._drain_candidate()
            if dev is not None:
                self.layer.remove_device(dev)
                self.decisions.append((now, "down", dev))
                self._last_action = now

    def _drain_candidate(self) -> Optional[int]:
        """Pick the device to retire: idle before busy, slow before fast,
        youngest (highest index) on ties — deterministic by construction.
        A pool-scoped autoscaler only ever retires its own pool."""
        live = [d for d in self.layer.cluster.devices if d.alive and not d.draining]
        if self.cfg.pool_role != "any":
            live = [d for d in live if d.role == self.cfg.pool_role]
        if len(live) <= self.cfg.min_devices:
            return None
        best = min(
            live,
            key=lambda d: (d.running is not None or d.n_resident > 0,
                           d.speed, -d.dev),
        )
        return best.dev
