# Copied from src/repro/obs/__init__.py; `repro.` rewritten to `repro_torch.`.
"""Streaming observability over the shared EventBus.

Everything here is a *subscriber*: attach to any execution layer
(``NPUSimulator``, ``ClusterSimulator``, ``ServingEngine``) or a bare
:class:`~repro_torch.core.events.EventBus` and the scheduling loop stays
untouched — nothing attached means the no-subscriber fast path and
bit-identical behavior; detaching restores it (gated by
``benchmarks/obs_overhead.py``).

- :class:`~repro_torch.obs.tracing.SpanTracer` — per-task span reconstruction
  and Chrome trace-event / Perfetto JSON export (``ui.perfetto.dev``).
- :class:`~repro_torch.obs.telemetry.Telemetry` — windowed counters and
  fixed-bucket histograms in O(windows) memory, JSONL timeseries export.
- :class:`~repro_torch.obs.slo.SLOMonitor` — rolling SLA attainment and
  error-budget burn-rate rules emitting ``slo_alert``/``slo_clear``
  back onto the bus.
- :func:`~repro_torch.obs.replay_diff.first_divergence` — earliest differing
  event between two executed logs, with surrounding context.
"""
from repro_torch.obs.replay_diff import first_divergence
from repro_torch.obs.slo import SLOMonitor, SLORule
from repro_torch.obs.telemetry import Telemetry, TelemetryConfig
from repro_torch.obs.tracing import Span, SpanTracer

__all__ = [
    "Span",
    "SpanTracer",
    "Telemetry",
    "TelemetryConfig",
    "SLOMonitor",
    "SLORule",
    "first_divergence",
]
