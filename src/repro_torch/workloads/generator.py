# Copied from src/repro/workloads/generator.py; `repro.` rewritten to `repro_torch.`.
"""Trace generation: sample a :class:`TrafficMix` into a replayable Trace.

Sampling happens in three strictly ordered phases — (1) tenant+model
choice per task, (2) per-task spec draws (batch, priority, lengths),
(3) arrival times from the mix's arrival process — because that is the
draw order of the original §III generator; keeping it makes the
``uniform_window``/:func:`~repro_torch.workloads.tenants.paper_mix` path
bit-compatible with the pre-refactor ``core.trace.make_workload`` at equal
seeds, while every other arrival process slots into the same pipeline.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core.predictor import Predictor
from repro_torch.workloads.spec import TaskSpec, materialize_task, sample_task_spec
from repro_torch.workloads.tenants import TenantSpec, TrafficMix
from repro_torch.workloads.trace_io import Trace


def _sample_serving_spec(tid: int, model: str, ten: TenantSpec,
                         rng: np.random.Generator, seed: int) -> TaskSpec:
    """Spec draws for a serving-kind tenant: prompt/decode lengths come
    from the tenant's ranges instead of the paper profiling LUTs."""
    batch = ten.batch if ten.batch is not None else int(
        rng.choice(ten.batch_choices))
    priority = ten.priority if ten.priority is not None else int(
        rng.choice(ten.priority_choices))
    lo, hi = ten.prompt_len_range
    prompt_len = int(rng.integers(lo, hi + 1))
    dlo, dhi = ten.decode_len_range
    decode_len = int(rng.integers(dlo, dhi + 1))
    return TaskSpec(tid=tid, model=model, priority=priority, batch=batch,
                    in_len=prompt_len, actual_unroll=decode_len,
                    tenant=ten.name, sla_scale=ten.sla_scale,
                    max_new_tokens=ten.max_new_tokens, seed=seed)


def generate(mix: TrafficMix, rng: np.random.Generator, n_tasks: int,
             pred: Optional[Predictor] = None, start_tid: int = 0,
             payload_seed: int = 0) -> Trace:
    """Sample ``n_tasks`` tasks from ``mix`` into a replayable Trace.

    ``pred`` is required for paper-kind mixes (materialization and the
    profiled RNN length LUTs).  ``payload_seed`` offsets the per-record
    payload streams (prompt-token synthesis on serving replay) without
    consuming draws from ``rng``.
    """
    if n_tasks < 1:
        raise ValueError("n_tasks must be >= 1")
    if mix.kind == "paper" and pred is None:
        raise ValueError("paper-kind mixes require a Predictor")
    tenants = mix.tenants
    shares = mix.shares()

    # phase 1: tenant + model choice per task (single tenant draws nothing
    # for the tenant itself — keeps the §III stream unchanged)
    chosen = []
    for _ in range(n_tasks):
        ten = (tenants[0] if len(tenants) == 1
               else tenants[int(rng.choice(len(tenants), p=shares))])
        model = str(rng.choice(ten.models))
        chosen.append((ten, model))

    # phase 2: per-task spec draws at arrival 0
    specs = []
    for i, (ten, model) in enumerate(chosen):
        tid = start_tid + i
        seed = payload_seed + tid
        if mix.kind == "paper":
            specs.append(sample_task_spec(
                tid, model, pred, rng, arrival=0.0, priority=ten.priority,
                batch=ten.batch, batch_choices=ten.batch_choices,
                priority_choices=ten.priority_choices, tenant=ten.name,
                sla_scale=ten.sla_scale, seed=seed))
        else:
            specs.append(_sample_serving_spec(tid, model, ten, rng, seed))

    # phase 3: arrivals (service-aware processes see isolated estimates)
    tasks = None
    if mix.kind == "paper":
        # materialized here both for the isolated-service estimates and as
        # the one-shot tasks() cache (materialization is deterministic)
        tasks = [materialize_task(s, pred) for s in specs]
        service = np.asarray([t.isolated_time for t in tasks])
    else:
        # relative work proxy: token count; only service-aware processes
        # (uniform_window auto-window, closed_loop think pacing) consume it
        service = np.asarray([float(s.in_len + s.actual_unroll)
                              for s in specs])
    arrivals = mix.arrivals.sample(rng, service)

    for spec, arr in zip(specs, arrivals):
        spec.arrival = float(arr)
    if tasks is not None:
        for task, arr in zip(tasks, arrivals):
            task.arrival = float(arr)
            task.last_wake = task.arrival

    meta = {"arrivals": mix.arrivals.describe(), "kind": mix.kind,
            "n_tasks": n_tasks,
            "tenants": [{"name": t.name, "share": float(sh),
                         "sla_scale": t.sla_scale,
                         "models": list(t.models)}
                        for t, sh in zip(tenants, shares)]}
    trace = Trace(records=specs, kind=mix.kind, meta=meta, pred=pred)
    trace._fresh = tasks
    return trace
