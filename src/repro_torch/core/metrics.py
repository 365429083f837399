# Copied from src/repro/core/metrics.py; `repro.` rewritten to `repro_torch.`.
"""Multi-program performance metrics (Eyerman & Eeckhout; paper Eq 1-2),
tail-latency percentiles, and per-tenant SLA/goodput summaries."""
from __future__ import annotations

import bisect
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

from repro_torch.core.task import Task, TaskState

DEFAULT_SLA_SCALE = 8.0      # fallback for tasks with no tenant SLA class
PERCENTILES = (50, 95, 99)


def completed(tasks: Sequence[Task]) -> List[Task]:
    """The subset that actually finished.  Latency/SLA aggregates are
    defined over this subset; tasks shed by admission control (DROPPED)
    count toward offered/rejected totals only."""
    return [t for t in tasks if t.completion is not None]


def rejected(tasks: Sequence[Task]) -> List[Task]:
    """The subset shed by admission control (never executed)."""
    return [t for t in tasks if t.state is TaskState.DROPPED]


def antt(tasks: Sequence[Task]) -> float:
    """Average normalized turnaround time (lower is better)."""
    tasks = completed(tasks)
    if not tasks:
        return float("nan")
    return float(np.mean([t.ntt for t in tasks]))


def stp(tasks: Sequence[Task]) -> float:
    """System throughput = sum of per-task progress rates (higher better)."""
    tasks = completed(tasks)
    return float(np.sum([1.0 / t.ntt for t in tasks]))


def fairness(tasks: Sequence[Task]) -> float:
    """Priority-weighted equal-progress metric (Eq 2): min_{i,j} PP_i/PP_j."""
    tasks = completed(tasks)
    if not tasks:
        return float("nan")
    prio_sum = float(np.sum([t.priority for t in tasks]))
    pp = np.asarray([(1.0 / t.ntt) / (t.priority / prio_sum) for t in tasks])
    return float(pp.min() / pp.max())


def sla_violation_rate(tasks: Sequence[Task], n: float) -> float:
    """Fraction of tasks with turnaround > n x isolated time (§VI-C)."""
    v = [t.turnaround > n * t.isolated_time for t in completed(tasks)]
    if not v:
        return float("nan")
    return float(np.mean(v))


def sla_satisfaction(tasks: Sequence[Task],
                     default_scale: float = DEFAULT_SLA_SCALE) -> float:
    """Fraction of *completed* (admitted) tasks meeting their own SLA
    target (per-task ``sla_scale`` where assigned, ``default_scale``
    otherwise)."""
    tasks = completed(tasks)
    if not tasks:
        return float("nan")
    return float(np.mean([t.sla_met(default_scale) for t in tasks]))


def goodput(tasks: Sequence[Task], makespan: Optional[float] = None,
            default_scale: float = DEFAULT_SLA_SCALE) -> float:
    """SLA-meeting completions per second of offered-load wall time."""
    tasks = completed(tasks)
    if not tasks:
        return 0.0
    if makespan is None:
        makespan = max(t.completion for t in tasks)
    met = float(np.sum([t.sla_met(default_scale) for t in tasks]))
    return met / max(makespan, 1e-12)


def tail_latency_ratio(tasks: Sequence[Task], priority: int = 9,
                       pct: float = 95.0) -> float:
    """``pct``-ile of NTT among tasks of the given priority (Fig 14)."""
    sel = [t.ntt for t in completed(tasks) if t.priority == priority]
    if not sel:
        return float("nan")
    return float(np.percentile(sel, pct))


def _percentile_rows(series: Dict[str, Sequence[float]],
                     pcts: Sequence[int]) -> Dict[str, float]:
    """One ``np.percentile`` call (one sort) per series for the whole
    percentile list; keys emitted in the historical p-major order."""
    qs = list(pcts)
    res = {name: (np.percentile(vals, qs) if len(vals) else None)
           for name, vals in series.items()}
    out: Dict[str, float] = {}
    for i, p in enumerate(qs):
        for name in series:
            r = res[name]
            out[f"p{p}_{name}"] = (float(r[i]) if r is not None
                                   else float("nan"))
    return out


def percentile_summary(tasks: Sequence[Task],
                       pcts: Sequence[int] = PERCENTILES) -> Dict[str, float]:
    """p50/p95/p99 of turnaround, NTT, and TTFT (time to first service —
    the queueing delay the mean hides)."""
    tasks = completed(tasks)
    return _percentile_rows(
        {"turnaround": [t.turnaround for t in tasks],
         "ntt": [t.ntt for t in tasks],
         "ttft": [t.first_service - t.arrival for t in tasks
                  if t.first_service is not None]}, pcts)


def serving_summary(results: Sequence,
                    interactive_priority: int = 9) -> Dict[str, float]:
    """Token-level serving aggregates over a run's ``RequestResult`` set.

    The paper's NTT/SLA framing extends to the two serving SLOs:
    **TTFT** (time to first token — prefill queueing + compute) and
    **TPOT** (time per output token over decode).  Returns their means
    and p50/p95/p99, plus ``tokens_per_s`` (generated tokens over the
    run's makespan — the continuous-batching headline number) and the
    interactive-priority TTFT percentiles separately, since chunked
    prefill exists to protect exactly that class.

    Args:
        results: completed :class:`repro_torch.serving.request.RequestResult` s.
        interactive_priority: priority level reported separately.

    Returns:
        Flat ``str -> float`` dict; NaN where a series is empty.
    """
    results = list(results)
    out: Dict[str, float] = {}
    if not results:
        return {"tokens_per_s": 0.0, "mean_ttft": float("nan"),
                "mean_tpot": float("nan")}
    ttfts = [r.ttft for r in results]
    tpots = [r.tpot for r in results if not np.isnan(r.tpot)]
    makespan = max(r.completion for r in results)
    n_tok = sum(r.n_tokens for r in results)
    out["tokens_per_s"] = n_tok / max(makespan, 1e-12)
    out["n_tokens"] = float(n_tok)
    out["mean_ttft"] = float(np.mean(ttfts))
    out["mean_tpot"] = float(np.mean(tpots)) if tpots else float("nan")
    inter = [r.ttft for r in results if r.priority >= interactive_priority]
    out.update(_percentile_rows(
        {"ttft": ttfts, "tpot": tpots, "interactive_ttft": inter},
        PERCENTILES))
    return out


def summarize(tasks: Sequence[Task]) -> Dict[str, float]:
    """Aggregate over one run's task set.  Latency/SLA keys cover the
    completed subset; ``n_offered``/``n_rejected``/``shed_rate`` account
    for admission-control drops (all zero-drop workloads are unchanged:
    ``n_tasks == n_offered``).

    Each latency series is materialized exactly once and shared across
    every aggregate (the helper functions stay as the one-off public
    API); elementwise float64 array math reproduces the per-task scalar
    expressions bit-exactly.
    """
    done = completed(tasks)
    n_rej = len(rejected(tasks))
    ntts = np.asarray([t.ntt for t in done])
    tat = np.asarray([t.turnaround for t in done])
    iso = np.asarray([t.isolated_time for t in done])
    prio = np.asarray([float(t.priority) for t in done])
    met = np.asarray([t.sla_met(DEFAULT_SLA_SCALE) for t in done])
    if done:
        pp = (1.0 / ntts) / (prio / prio.sum())
        fair = float(pp.min() / pp.max())
        makespan = max(t.completion for t in done)
        good = float(np.sum(met)) / max(makespan, 1e-12)
        sat = float(np.mean(met))
    else:
        fair, good, sat = float("nan"), 0.0, float("nan")
    hi = ntts[prio == 9.0]
    out = {
        "antt": float(np.mean(ntts)) if done else float("nan"),
        "stp": float(np.sum(1.0 / ntts)) if done else 0.0,
        "fairness": fair,
        "tail95_high": (float(np.percentile(hi, 95.0)) if hi.size
                        else float("nan")),
        "n_tasks": float(len(done)),
        "n_offered": float(len(tasks)),
        "n_rejected": float(n_rej),
        "shed_rate": float(n_rej) / max(len(tasks), 1),
        "preemptions": float(np.sum([t.n_preemptions for t in done])),
        "kills": float(np.sum([t.n_kills for t in done])),
        "ckpt_overhead": float(np.sum([t.checkpoint_overhead for t in done])),
        "sla_satisfaction": sat,
        "goodput": good,
        # fault tolerance (all zero on failure-free runs)
        "lost_work": float(np.sum([t.lost_work for t in tasks])),
        "n_crashes": float(np.sum([t.n_crashes for t in tasks])),
        "retries": float(np.sum([t.n_retries for t in tasks])),
        "n_abandoned": float(np.sum([t.abandoned for t in tasks])),
    }
    out.update(_percentile_rows(
        {"turnaround": tat, "ntt": ntts,
         "ttft": [t.first_service - t.arrival for t in done
                  if t.first_service is not None]}, PERCENTILES))
    for n in (2, 4, 8, 12, 16, 20):
        out[f"sla_viol@{n}"] = float(np.mean(tat > n * iso)) if done \
            else float("nan")
    return out


def prediction_errors(tasks: Sequence[Task]) -> np.ndarray:
    """Per-task signed relative runtime-prediction error over the
    completed subset: ``(predicted_total - isolated_time) /
    isolated_time``.  Positive = over-prediction.  Tasks with
    non-finite predictions or non-positive actual runtimes are dropped
    (degenerate inputs yield a shorter array, never a crash)."""
    done = completed(tasks)
    pred = np.asarray([t.predicted_total for t in done], dtype=float)
    iso = np.asarray([t.isolated_time for t in done], dtype=float)
    if not done:
        return np.empty(0)
    ok = np.isfinite(pred) & np.isfinite(iso) & (iso > 0.0)
    return (pred[ok] - iso[ok]) / iso[ok]


def _pred_stats(tasks: Sequence[Task]) -> Dict[str, float]:
    err = prediction_errors(tasks)
    n = err.size
    ape = np.abs(err)
    return {"pred_n": float(n),
            "pred_mape": float(np.mean(ape)) if n else float("nan"),
            "pred_bias": float(np.mean(err)) if n else float("nan"),
            "pred_p95_ape": (float(np.percentile(ape, 95.0)) if n
                             else float("nan"))}


def prediction_error_summary(tasks: Sequence[Task]
                             ) -> Dict[str, object]:
    """Predicted-vs-actual runtime calibration over a run's task set.

    Flat keys: ``pred_n`` (tasks with a usable prediction/actual pair),
    ``pred_mape`` (mean absolute relative error), ``pred_bias`` (mean
    signed relative error — positive means the predictor over-estimates),
    ``pred_p95_ape`` (tail miss).  ``per_model`` nests the same stats per
    model name — the calibration view that shows *which* network the
    predictor misjudges.  Empty or all-degenerate inputs (no completions,
    NaN predictions, zero actual runtimes) return NaN stats, never raise
    — the same hardening convention as :func:`summarize`.
    """
    out: Dict[str, object] = dict(_pred_stats(tasks))
    groups: Dict[str, List[Task]] = {}
    for t in completed(tasks):
        groups.setdefault(t.model, []).append(t)
    out["per_model"] = {m: _pred_stats(ts)
                        for m, ts in sorted(groups.items())}
    return out


def aggregate(runs: Iterable[Dict[str, float]]) -> Dict[str, float]:
    """Average metric dicts across simulation runs."""
    runs = list(runs)
    keys = runs[0].keys()
    return {k: float(np.mean([r[k] for r in runs])) for k in keys}


# ---------------------------------------------------------------------------
# Streaming plumbing — fixed-bucket histograms and sim-time windows,
# shared by repro/obs/telemetry.py (O(buckets) memory per series however
# many samples flow through; exact aggregates stay with ``summarize``
# over retained task lists)
# ---------------------------------------------------------------------------

def log_bucket_edges(lo: float, hi: float, n: int = 24) -> List[float]:
    """``n`` logarithmically-spaced bucket edges covering ``[lo, hi]`` —
    the standard latency-histogram layout (constant per-bucket relative
    error)."""
    if not (0.0 < lo < hi):
        raise ValueError(f"need 0 < lo < hi, got [{lo}, {hi}]")
    return [float(x) for x in np.geomspace(lo, hi, n)]


def window_index(t: float, window: float, t0: float = 0.0) -> int:
    """Index of the sim-time window ``[t0 + k*w, t0 + (k+1)*w)``
    containing ``t``.  Raises on non-positive window lengths rather than
    silently folding everything into one bucket."""
    if window <= 0.0:
        raise ValueError(f"window length must be > 0, got {window}")
    return int((t - t0) // window)


class Histogram:
    """Fixed-bucket streaming histogram.

    ``edges`` (sorted, len m) define m+1 buckets: bucket 0 is the
    underflow ``< edges[0]``, bucket i counts ``[edges[i-1], edges[i])``,
    the last bucket is the overflow ``>= edges[-1]``.  ``add`` is O(log m);
    memory is O(m) regardless of sample count.  ``percentile`` is
    bucket-resolution (linear interpolation inside the winning bucket);
    ``mean`` is exact (tracked sum/count)."""

    __slots__ = ("edges", "counts", "_sum")

    def __init__(self, edges: Sequence[float]):
        self.edges = [float(e) for e in edges]
        if self.edges != sorted(self.edges) or len(self.edges) < 1:
            raise ValueError("edges must be a sorted non-empty sequence")
        self.counts = [0] * (len(self.edges) + 1)
        self._sum = 0.0

    @property
    def n(self) -> int:
        """Total weight added so far."""
        return sum(self.counts)

    def add(self, value: float, weight: int = 1) -> None:
        """Bucket ``value`` (O(log buckets), constant memory)."""
        self.counts[bisect.bisect_right(self.edges, value)] += weight
        self._sum += value * weight

    def mean(self) -> float:
        """Exact mean of added values (the sum is tracked, not bucketed)."""
        n = self.n
        return self._sum / n if n else float("nan")

    def percentile(self, pct: float) -> float:
        """Bucket-resolution estimate of the ``pct``-ile (0..100).
        Underflow resolves to ``edges[0]``, overflow to ``edges[-1]`` —
        the histogram cannot see beyond its edge span."""
        n = self.n
        if n == 0:
            return float("nan")
        target = pct / 100.0 * n
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if cum >= target and c:
                lo = self.edges[i - 1] if i >= 1 else self.edges[0]
                hi = self.edges[i] if i < len(self.edges) else self.edges[-1]
                frac = (target - (cum - c)) / c
                return float(lo + (hi - lo) * min(max(frac, 0.0), 1.0))
        return float(self.edges[-1])

    def merge(self, other: "Histogram") -> "Histogram":
        """Accumulate ``other`` in place; edge layouts must match."""
        if self.edges != other.edges:
            raise ValueError("cannot merge histograms with different edges")
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self._sum += other._sum
        return self

    def to_dict(self) -> Dict[str, object]:
        """JSON-serializable form (telemetry export)."""
        return {"edges": list(self.edges), "counts": list(self.counts),
                "sum": self._sum}


# ---------------------------------------------------------------------------
# Tenant (SLA-class) metrics — see repro/workloads/
# ---------------------------------------------------------------------------

def per_tenant_summary(tasks: Sequence[Task],
                       default_scale: float = DEFAULT_SLA_SCALE
                       ) -> Dict[str, Dict[str, float]]:
    """ANTT/STP, tail percentiles, SLA satisfaction, and admission
    accounting per tenant class (tasks with no tenant group under
    ``"-"``).  Latency/SLA keys cover each tenant's completed subset;
    ``n_offered = n_admitted + n_rejected`` always holds per tenant."""
    groups: Dict[str, List[Task]] = {}
    for t in tasks:
        groups.setdefault(t.tenant if t.tenant is not None else "-",
                          []).append(t)
    all_done = completed(tasks)
    makespan = max((t.completion for t in all_done), default=0.0)
    out: Dict[str, Dict[str, float]] = {}
    for tenant, ts in sorted(groups.items()):
        done, shed = completed(ts), rejected(ts)
        met = np.asarray([t.sla_met(default_scale) for t in done])
        row = {"n_tasks": float(len(done)),
               "n_offered": float(len(ts)),
               "n_admitted": float(len(ts) - len(shed)),
               "n_rejected": float(len(shed)),
               "shed_rate": float(len(shed)) / max(len(ts), 1),
               "sla_satisfaction": (float(np.mean(met)) if done
                                    else float("nan")),
               "goodput": (float(np.sum(met)) / max(makespan, 1e-12)
                           if done else 0.0),
               # one logical task, many attempts: retries/crashes accrue
               # on the same Task, so the offered/admitted split above
               # stays exact under client retry and crash re-queue
               "retries": float(np.sum([t.n_retries for t in ts])),
               "n_abandoned": float(np.sum([t.abandoned for t in ts])),
               "n_crashes": float(np.sum([t.n_crashes for t in ts])),
               "lost_work": float(np.sum([t.lost_work for t in ts]))}
        if done:
            ntts = np.asarray([t.ntt for t in done])
            row["antt"] = float(np.mean(ntts))
            row["stp"] = float(np.sum(1.0 / ntts))
            row.update(_percentile_rows(
                {"turnaround": [t.turnaround for t in done],
                 "ntt": ntts,
                 "ttft": [t.first_service - t.arrival for t in done
                          if t.first_service is not None]}, PERCENTILES))
        out[tenant] = row
    return out


# ---------------------------------------------------------------------------
# Cluster (multi-NPU) metrics — see core/cluster.py
# ---------------------------------------------------------------------------

def per_device_summary(tasks: Sequence[Task]) -> Dict[int, Dict[str, float]]:
    """ANTT/STP and tail percentiles per device, grouped by the device each
    task completed on."""
    groups: Dict[int, List[Task]] = {}
    for t in completed(tasks):
        groups.setdefault(t.device if t.device is not None else -1,
                          []).append(t)
    out: Dict[int, Dict[str, float]] = {}
    for dev, ts in sorted(groups.items()):
        row = {"antt": antt(ts), "stp": stp(ts), "n_tasks": float(len(ts))}
        row.update(percentile_summary(ts))
        out[dev] = row
    return out


def device_utilization(busy_times: Sequence[float], makespan: float,
                       capacity_seconds: Optional[Sequence[float]] = None
                       ) -> List[float]:
    """Per-device fraction of its *alive* time spent executing tasks.

    ``capacity_seconds[i]`` is device *i*'s alive window inside the run
    (elastic clusters: devices join and leave mid-run, so dividing every
    device's busy time by the global makespan understates late joiners
    and early leavers).  Omitted, every device is assumed alive for the
    whole makespan — the historical fixed-fleet behavior."""
    if capacity_seconds is None:
        capacity_seconds = [makespan] * len(busy_times)
    return [min(1.0, b / max(cap, 1e-12))
            for b, cap in zip(busy_times, capacity_seconds)]


def cluster_health(tasks: Sequence[Task], busy_times: Sequence[float],
                   makespan: float,
                   capacity_seconds: Optional[Sequence[float]] = None,
                   downtime_seconds: Optional[Sequence[float]] = None
                   ) -> Dict[str, float]:
    """Cluster-level utilization, throughput, and cross-device balance
    only — no per-task latency aggregates (compose with ``summarize``
    via :func:`cluster_summary` when both cover the same task set).
    ``capacity_seconds`` carries per-device alive windows for elastic
    clusters; ``capacity_seconds`` in the output is the total
    device-seconds the configuration consumed (the denominator of any
    cost-normalized comparison across fleet sizes).  ``downtime_seconds``
    carries per-device failed time (core/faults.py) and adds an
    ``availability`` key: the fraction of paid-for device-seconds the
    fleet was actually serviceable."""
    out: Dict[str, float] = {}
    utils = device_utilization(busy_times, makespan, capacity_seconds)
    per_dev = per_device_summary(tasks)
    caps = (list(capacity_seconds) if capacity_seconds is not None
            else [makespan] * len(busy_times))
    out["n_devices"] = float(len(busy_times))
    out["makespan"] = float(makespan)
    out["capacity_seconds"] = float(np.sum(caps))
    out["throughput"] = float(len(completed(tasks))) / max(makespan, 1e-12)
    out["util_mean"] = float(np.mean(utils))
    out["util_min"] = float(np.min(utils))
    out["util_max"] = float(np.max(utils))
    busy = np.asarray(busy_times, dtype=float)
    out["load_imbalance"] = float(busy.max() / max(busy.mean(), 1e-12))
    # every device counts: one that completed nothing contributes stp=0,
    # so an all-tasks-on-one-device schedule scores 0, not 1
    stps = [per_dev.get(dev, {"stp": 0.0})["stp"]
            for dev in range(len(busy_times))]
    out["device_fairness"] = (float(min(stps) / max(max(stps), 1e-12))
                              if len(stps) > 1 else 1.0)
    if downtime_seconds is not None:
        down = float(np.sum(downtime_seconds))
        out["downtime_seconds"] = down
        out["availability"] = 1.0 - down / max(out["capacity_seconds"], 1e-12)
    return out


def cluster_summary(tasks: Sequence[Task], busy_times: Sequence[float],
                    makespan: float,
                    capacity_seconds: Optional[Sequence[float]] = None,
                    downtime_seconds: Optional[Sequence[float]] = None
                    ) -> Dict[str, float]:
    """Global ``summarize`` (incl. tail percentiles) plus cluster-level
    utilization, throughput and cross-device balance (STP/ANTT across
    devices).  Pass ``capacity_seconds`` (per-device alive windows) for
    elastic clusters so utilization divides by alive time, not the
    global makespan, and ``downtime_seconds`` (per-device failed time)
    for an ``availability`` figure."""
    out = summarize(tasks)
    out.update(cluster_health(tasks, busy_times, makespan, capacity_seconds,
                              downtime_seconds))
    return out
