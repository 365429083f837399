# Copied from src/repro/obs/slo.py; `repro.` rewritten to `repro_torch.`.
"""Live SLO monitoring: rolling SLA attainment + error-budget burn rate.

An :class:`SLOMonitor` watches ``complete``/``drop``/``abandon`` events
and, per :class:`SLORule`, maintains a rolling window of task outcomes
(SLA met / missed; drops and abandons count as misses when
``count_drops``).  The *burn rate* is the classic error-budget ratio

    burn = (1 - attainment) / (1 - target)

— burn 1.0 spends the budget exactly at the sustainable rate, burn 2.0
twice as fast.  When burn exceeds ``rule.alert_burn`` (with at least
``min_samples`` outcomes in the window) the monitor emits an
``slo_alert`` event back onto the same bus — so an autoscaler or
admission controller can subscribe to it like any other kind, and it
round-trips through ``ExecutedTrace`` — and an ``slo_clear`` once burn
falls back to ≤ ``clear_burn`` (hysteresis: alert and clear thresholds
differ so a rule oscillating around the alert line doesn't flap).

SLA evaluation needs isolated times, which events don't carry: pass the
offered tasks to :meth:`SLOMonitor.attach` just like
:class:`~repro_torch.obs.telemetry.Telemetry`.  Everything is deterministic —
same trace, same alerts, bit-for-bit (tests/test_obs.py).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

from repro_torch.core import metrics


@dataclasses.dataclass(frozen=True)
class SLORule:
    """One alerting rule over one tenant class (``tenant=None`` matches
    every task).  ``target`` is the SLA-attainment objective (e.g. 0.9 ⇒
    a 10% error budget); the window is sim-time seconds.

    ``metric`` selects what the rule watches: ``"sla"`` (the default)
    evaluates end-to-end turnaround against each task's SLA budget on
    ``complete``; ``"ttft"`` evaluates time-to-first-service (submit →
    first dispatch of the attempt, the serving TTFT SLO) against the
    absolute ``ttft_target`` seconds — the signal chunked prefill and
    prefill/decode disaggregation exist to protect.
    """
    name: str
    tenant: Optional[str] = None
    target: float = 0.9
    window: float = 600.0
    alert_burn: float = 2.0
    clear_burn: float = 1.0
    min_samples: int = 10
    count_drops: bool = True
    metric: str = "sla"               # "sla" | "ttft"
    ttft_target: Optional[float] = None   # seconds (metric == "ttft")

    def __post_init__(self):
        if not 0.0 < self.target < 1.0:
            raise ValueError(f"target must be in (0, 1), got {self.target}")
        if self.clear_burn > self.alert_burn:
            raise ValueError("clear_burn must be <= alert_burn "
                             "(hysteresis, not oscillation)")
        if self.metric not in ("sla", "ttft"):
            raise ValueError(f"unknown metric {self.metric!r}; "
                             "choose 'sla' or 'ttft'")
        if self.metric == "ttft" and self.ttft_target is None:
            raise ValueError("metric='ttft' needs an absolute ttft_target "
                             "(seconds)")


class _RuleState:
    __slots__ = ("outcomes", "n_met", "active")

    def __init__(self) -> None:
        self.outcomes: Deque[Tuple[float, bool]] = deque()
        self.n_met = 0
        self.active = False


class SLOMonitor:
    """EventBus subscriber evaluating :class:`SLORule` s as the run
    unfolds; ``alerts`` records every emitted transition as
    ``(t, kind, rule_name, tenant, burn)``."""

    def __init__(self, rules: Sequence[SLORule]) -> None:
        names = [r.name for r in rules]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate rule names: {names}")
        self.rules = list(rules)
        self.reset()

    def reset(self) -> None:
        self._state: Dict[str, _RuleState] = {r.name: _RuleState()
                                              for r in self.rules}
        self._iso: Dict[int, Tuple[float, float]] = {}
        self._submits: Dict[int, float] = {}
        self._await_first: Dict[int, float] = {}   # tid -> submit t (ttft)
        self._bus = None
        self._detach = None
        self.alerts: List[Tuple[float, str, str, Optional[str], float]] = []

    # -- bus plumbing ---------------------------------------------------
    def attach(self, layer_or_bus, tasks: Optional[Sequence] = None
               ) -> "SLOMonitor":
        bus = getattr(layer_or_bus, "events", layer_or_bus)
        self._bus = bus
        handlers = {"complete": self._on_outcome,
                    "drop": self._on_outcome,
                    "abandon": self._on_outcome,
                    "submit": self._on_submit}
        if any(r.metric == "ttft" for r in self.rules):
            handlers["dispatch"] = self._on_dispatch
        self._detach = bus.subscribe_map(handlers)
        if tasks is not None:
            for t in tasks:
                scale = getattr(t, "sla_scale", None)
                self._iso[t.tid] = (
                    t.isolated_time,
                    scale if scale is not None else metrics.DEFAULT_SLA_SCALE)
        return self

    def detach(self) -> None:
        if self._detach is not None:
            self._detach()
            self._detach = None
            self._bus = None

    # -- evaluation -----------------------------------------------------
    def _on_submit(self, ev) -> None:
        # remember the (re-)offer instant: turnaround spans the last
        # attempt, matching Task.turnaround under crash re-queue
        self._submits[ev.tid] = ev.t
        self._await_first[ev.tid] = ev.t

    def _on_dispatch(self, ev) -> None:
        # first dispatch after a submit: the attempt's TTFT sample
        t_sub = self._await_first.pop(ev.tid, None)
        if t_sub is None:
            return
        for rule in self.rules:
            if rule.metric != "ttft":
                continue
            if rule.tenant is not None and rule.tenant != ev.tenant:
                continue
            self._observe(rule, ev.t, (ev.t - t_sub) <= rule.ttft_target)

    def _on_outcome(self, ev) -> None:
        if ev.kind == "complete":
            t_sub = self._submits.pop(ev.tid, None)
            iso = self._iso.get(ev.tid)
            if t_sub is None or iso is None:
                return
            met = (ev.t - t_sub) <= iso[1] * iso[0]
        else:
            self._submits.pop(ev.tid, None)
            self._await_first.pop(ev.tid, None)
            met = False
        for rule in self.rules:
            if rule.tenant is not None and rule.tenant != ev.tenant:
                continue
            if not met and ev.kind != "complete" and not rule.count_drops:
                continue
            if rule.metric == "ttft":
                # dispatch drives ttft rules; a drop/abandon that never
                # dispatched is a miss when the rule counts drops
                if ev.kind != "complete" and rule.count_drops:
                    self._observe(rule, ev.t, False)
                continue
            self._observe(rule, ev.t, met)

    def _observe(self, rule: SLORule, t: float, met: bool) -> None:
        st = self._state[rule.name]
        st.outcomes.append((t, met))
        st.n_met += met
        lo = t - rule.window
        while st.outcomes and st.outcomes[0][0] < lo:
            _, m = st.outcomes.popleft()
            st.n_met -= m
        n = len(st.outcomes)
        if n < rule.min_samples:
            return
        burn = self.burn_rate(rule.name)
        if not st.active and burn > rule.alert_burn:
            st.active = True
            self.alerts.append((t, "slo_alert", rule.name, rule.tenant, burn))
            if self._bus is not None:
                self._bus.slo_alert(t, rule.tenant, rule.name)
        elif st.active and burn <= rule.clear_burn:
            st.active = False
            self.alerts.append((t, "slo_clear", rule.name, rule.tenant, burn))
            if self._bus is not None:
                self._bus.slo_clear(t, rule.tenant, rule.name)

    # -- views ----------------------------------------------------------
    def attainment(self, rule_name: str) -> float:
        st = self._state[rule_name]
        n = len(st.outcomes)
        return st.n_met / n if n else float("nan")

    def burn_rate(self, rule_name: str) -> float:
        rule = next(r for r in self.rules if r.name == rule_name)
        att = self.attainment(rule_name)
        return (1.0 - att) / (1.0 - rule.target)

    def active(self, rule_name: str) -> bool:
        return self._state[rule_name].active

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for r in self.rules:
            st = self._state[r.name]
            out[r.name] = {"tenant": r.tenant, "active": st.active,
                           "n_window": len(st.outcomes),
                           "attainment": self.attainment(r.name),
                           "burn_rate": (self.burn_rate(r.name)
                                         if st.outcomes else float("nan"))}
        return out
