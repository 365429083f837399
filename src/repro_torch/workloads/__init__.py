# Copied from src/repro/workloads/__init__.py; `repro.` rewritten to `repro_torch.`.
"""Traffic-generation subsystem: arrival processes, tenant SLA classes,
and trace record/replay.

This package replaces ad-hoc task lists with a composable workload layer —
the evaluation vehicle for every load-dependent question the ROADMAP asks
(sustained heavy traffic, bursts, per-tenant SLAs, latency–throughput
knees).

Arrival processes (``repro_torch.workloads.arrivals``)
------------------------------------------------
``sample(rng, service_times) -> arrival times``, one per task:

* ``UniformWindow(contention, window)`` — the paper's §III dispatch;
  bit-compatible with the pre-refactor ``core.trace.make_workload``.
* ``Poisson(rate)`` — open-loop memoryless arrivals (requests/second).
* ``MMPP(rate_on, rate_off, mean_on, mean_off)`` — bursty on/off traffic;
  ``MMPP.bursty(rate, duty)`` builds a burst source with a target mean rate.
* ``Diurnal(base_rate, amplitude, period)`` — sinusoidal rate curve
  (non-homogeneous Poisson via thinning).
* ``ClosedLoop(n_clients, think_time)`` — N synchronous clients; next
  request follows the previous one's (isolated-time-approximated)
  completion plus an exponential think time.

``make_arrival(name, **kwargs)`` is the string-keyed factory.

Tenant specs (``repro_torch.workloads.tenants``)
------------------------------------------
``TenantSpec(name, models, share, priority, sla_scale, batch_choices,
prompt_len_range, decode_len_range, ...)`` describes one tenant's model
mix, traffic share, scheduler priority and SLA multiplier (target
turnaround = ``sla_scale`` x isolated time).  ``TrafficMix(tenants,
arrivals, kind)`` composes tenants with an arrival process; ``kind`` is
``"paper"`` (§III 8-DNN suite → simulator ``Task``s) or ``"serving"``
(registered architectures → engine ``InferenceRequest``s).
``paper_mix()`` is the §III methodology as a one-tenant mix.

Generation and replay
---------------------
``generate(mix, rng, n_tasks, pred) -> Trace`` samples a replayable trace:
same (mix, seed) ⇒ identical records, always.  ``Trace.save(path)`` /
``Trace.load(path, pred)`` round-trip JSONL; ``Trace.tasks()`` materializes
fresh simulator tasks (RNG-free, bit-identical per call) and
``to_requests(trace, models)`` expands serving-kind traces into engine
requests with payloads synthesized from each record's own seed.  The
simulators and the serving engine accept a ``Trace`` directly in ``run``.

Closed-loop clients, admission control, executed traces
-------------------------------------------------------
``ClosedLoop.drive(layer, items, seed)`` (or :class:`ClosedLoopDriver`)
runs any execution layer under *reactive* closed-loop arrivals: clients
resample think time off actual ``complete``/``drop`` events from the
layer's event bus (``core/events.py``) instead of a pre-sampled trace;
``open_frac``/``open_rate`` mix in an open-loop Poisson side stream.
``repro_torch.workloads.admission`` provides per-tenant admission control
(``token_bucket`` rate limiting, ``queue_shed`` load shedding,
``priority_shed`` priority-aware early drop); rejected work is DROPPED,
emits a ``drop`` event, and shows up as ``n_rejected`` in
``metrics.per_tenant_summary``.  :class:`ExecutedTrace` captures the
dispatch/preempt/complete/drop timeline of what actually ran,
round-trips through JSONL, replays through any EventBus, and diffs
against the offered :class:`Trace`.

Determinism guarantees
----------------------
1. ``generate`` is a pure function of (mix, seed, n_tasks).
2. Materialization never consumes RNG: export → reload → run is
   bit-identical to running the original trace, on the single-NPU
   simulator, the cluster simulator, and the serving engine alike.
3. ``paper_mix()`` + ``UniformWindow`` reproduces the pre-refactor §III
   generator exactly at equal seeds (pinned by tests/test_workloads.py).
4. Same seed + same workload ⇒ the execution event log is bit-identical
   across ``NPUSimulator`` and ``ClusterSimulator(n_devices=1)``, and an
   ``ExecutedTrace`` save → load → replay reproduces it exactly
   (tests/test_events.py).
"""
from repro_torch.workloads.admission import (ADMISSION_NAMES,  # noqa: F401
                                       AdmissionPolicy, AdmitAll,
                                       PredictedCostBucket, PriorityShed,
                                       QueueShed, TokenBucket,
                                       make_admission)
from repro_torch.workloads.arrivals import (ARRIVAL_NAMES, ArrivalProcess,  # noqa: F401
                                      ClosedLoop, ClosedLoopDriver, Diurnal,
                                      MMPP, Poisson, UniformWindow,
                                      make_arrival)
from repro_torch.workloads.generator import generate  # noqa: F401
from repro_torch.workloads.retry import RetryDriver, RetryPolicy  # noqa: F401
from repro_torch.workloads.spec import (BATCH_CHOICES, TaskSpec,  # noqa: F401
                                  materialize_task, sample_task_spec)
from repro_torch.workloads.tenants import (TenantSpec, TrafficMix,  # noqa: F401
                                     paper_mix)
from repro_torch.workloads.trace_io import (ExecutedTrace, Trace,  # noqa: F401
                                      as_task_list)


def to_requests(trace, models):
    """Expand a serving-kind trace into engine requests (lazy import: the
    serving stack pulls in JAX model code the simulators don't need)."""
    from repro_torch.workloads.serving_adapter import to_requests as _impl
    return _impl(trace, models)
