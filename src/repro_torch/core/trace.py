# Copied from src/repro/core/trace.py; `repro.` rewritten to `repro_torch.`.
"""Multi-tasked DNN workload generation (paper §III methodology).

A workload of N tasks is built by sampling, per task: one of the eight
benchmark DNNs, a batch size (1/4/16), a uniform-random dispatch time over
a contention window, and a priority level among {low, medium, high}.
RNN tasks additionally sample an input sentence length from the profiled
set; the *actual* time-unrolled length is drawn from the profiled output
lengths for that input length, while the scheduler only sees the LUT
prediction (paper §VI).

The sampling itself now lives in the traffic subsystem
(``repro_torch.workloads``): specs are drawn by ``sample_task_spec`` and expanded
RNG-free by ``materialize_task``, and :func:`make_workload` is a thin
wrapper over ``generate(paper_mix(...))`` with the ``uniform_window``
compatibility process — bit-identical to the original generator at equal
seeds (pinned by tests/test_workloads.py).  Use ``repro_torch.workloads``
directly for open-loop arrival processes, tenant SLA classes, and trace
record/replay.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from repro_torch.configs import paper_workloads as pw
from repro_torch.core.predictor import LengthRegressor, Predictor
from repro_torch.core.task import Task
from repro_torch.workloads.spec import (BATCH_CHOICES,  # noqa: F401  (re-export)
                                  materialize_task, sample_task_spec)


def build_regressors(pred: Predictor, rng: np.random.Generator) -> None:
    """Fit the Fig-9 characterization LUTs once (amortized profiling)."""
    for name in ("RNN-MT1", "RNN-MT2", "RNN-ASR"):
        pairs = pw.profile_length_pairs(name, rng)
        pred.register_regressor(name, LengthRegressor().fit(pairs))


def make_task(tid: int, model: str, pred: Predictor,
              rng: np.random.Generator, arrival: float,
              priority: Optional[int] = None,
              batch: Optional[int] = None,
              in_len: Optional[int] = None) -> Task:
    """Sample one §III task (thin wrapper: spec draw + materialization)."""
    spec = sample_task_spec(tid, model, pred, rng, arrival=arrival,
                            priority=priority, batch=batch, in_len=in_len)
    return materialize_task(spec, pred)


def make_workload(pred: Predictor, rng: np.random.Generator,
                  n_tasks: int = 8,
                  models: Sequence[str] = pw.WORKLOAD_NAMES,
                  window: Optional[float] = None,
                  contention: float = 0.5) -> List[Task]:
    """Sample an N-task multi-tasked workload.

    ``contention`` sets the arrival window as a fraction of the summed
    isolated time: 0 → all arrive at t=0 (max contention); 1 → arrivals
    spread over the whole serial makespan (light contention).
    """
    from repro_torch.workloads import UniformWindow, generate, paper_mix
    mix = paper_mix(arrivals=UniformWindow(contention=contention,
                                           window=window),
                    models=tuple(models))
    return generate(mix, rng, n_tasks, pred=pred).tasks()


def clone_tasks(tasks: Sequence[Task]) -> List[Task]:
    """Fresh Task objects with identical static fields (so each policy run
    starts from pristine dynamic state)."""
    out = []
    for t in tasks:
        nt = Task(tid=t.tid, model=t.model, priority=t.priority,
                  arrival=t.arrival, batch=t.batch,
                  node_times=t.node_times.copy(),
                  node_out_bytes=t.node_out_bytes.copy(),
                  predicted_total=t.predicted_total, in_len=t.in_len,
                  tenant=t.tenant, sla_scale=t.sla_scale)
        nt.node_tile_times = getattr(t, "node_tile_times", None)
        out.append(nt)
    return out
