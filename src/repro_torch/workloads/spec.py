# Copied from src/repro/workloads/spec.py; `repro.` rewritten to `repro_torch.`.
"""Task specs: the *sampled* identity of a task, split from its
materialization.

A :class:`TaskSpec` captures every random draw that defines a task — model,
batch, priority, input length, the ground-truth unroll/decode length the
scheduler never sees, plus tenant/SLA attribution — as plain scalars, so a
trace of specs can be serialized to JSONL and replayed bit-for-bit.
:func:`materialize_task` deterministically expands a spec into a scheduler
:class:`~repro_torch.core.task.Task` (node arrays, predictor estimate, tile
quanta) with *no* RNG involved; :func:`sample_task_spec` performs the draws
in exactly the order of the original §III generator (``core/trace.py``
pre-refactor), so the ``uniform_window`` compatibility path reproduces the
paper workloads bit-identically for a given seed.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs import paper_workloads as pw
from repro_torch.core.ops import GemmOp, NetworkDesc
from repro_torch.core.predictor import Predictor, node_time
from repro_torch.core.task import PRIORITY_LEVELS, Task

BATCH_CHOICES = (1, 4, 16)


@dataclasses.dataclass
class TaskSpec:
    """Everything sampled about one task; sufficient for exact replay."""
    tid: int
    model: str
    priority: int
    batch: int
    arrival: float = 0.0
    in_len: int = 0           # input/prompt length (0 for CNNs)
    actual_unroll: int = 0    # ground-truth decoder unroll / decode length
    tenant: Optional[str] = None
    sla_scale: Optional[float] = None
    max_new_tokens: int = 0   # serving-trace decode cap (0 = n/a)
    seed: int = 0             # payload stream (prompt tokens on replay)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "TaskSpec":
        return cls(**{f.name: d[f.name] for f in dataclasses.fields(cls)
                      if f.name in d})


def sample_task_spec(tid: int, model: str, pred: Predictor,
                     rng: np.random.Generator, arrival: float = 0.0,
                     priority: Optional[int] = None,
                     batch: Optional[int] = None,
                     in_len: Optional[int] = None,
                     batch_choices: Sequence[int] = BATCH_CHOICES,
                     priority_choices: Sequence[int] = PRIORITY_LEVELS,
                     tenant: Optional[str] = None,
                     sla_scale: Optional[float] = None,
                     seed: int = 0) -> TaskSpec:
    """Sample a paper-suite task spec.

    Draw order (batch, priority, lengths) is the contract: it matches the
    pre-refactor ``core.trace.make_task`` exactly, which is what makes the
    ``uniform_window`` compatibility process seed-identical to §III.
    """
    net = pw.get_network(model)
    if batch is None:
        batch = int(rng.choice(batch_choices))
    if priority is None:
        priority = int(rng.choice(priority_choices))

    actual_unroll = 0
    if net.kind == "rnn_seq2seq":
        reg = pred.regressor(model)
        if in_len is None:
            in_len = int(rng.choice(reg.input_lengths))
        actual_unroll = reg.sample_actual(in_len, rng)
    elif net.kind == "rnn_linear":
        if in_len is None:
            in_len = int(rng.integers(4, 61))
    else:
        in_len = 0
    return TaskSpec(tid=tid, model=model, priority=priority, batch=batch,
                    arrival=arrival, in_len=in_len or 0,
                    actual_unroll=actual_unroll, tenant=tenant,
                    sla_scale=sla_scale, seed=seed)


def _node_arrays(net: NetworkDesc, in_len: int, unroll: int,
                 pred: Predictor) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    ops = net.ops(in_len, unroll)
    times = np.asarray([float(node_time(o, pred.hw, pred.acc)) for o in ops])
    out_bytes = np.asarray([
        o.output_bytes(pred.hw.bytes_per_elem) if isinstance(o, GemmOp)
        else o.elems * pred.hw.bytes_per_elem
        for o in ops], dtype=np.int64)
    # per-node tile quantum (preemption-point granularity): inner-tile time
    sw, sh = pred.hw.sa_rows, pred.hw.sa_cols
    c1 = (pred.acc + sh + 2 * sw) / pred.hw.freq_hz
    m1 = (sh * sw + sh * pred.acc) * pred.hw.bytes_per_elem / pred.hw.hbm_bw
    tile_t = max(c1, m1) / pred.hw.n_mxu
    tile_times = np.full(len(ops), tile_t)
    return times, out_bytes, tile_times


def materialize_task(spec: TaskSpec, pred: Predictor) -> Task:
    """Deterministically expand a spec into a fresh :class:`Task` — same
    spec + predictor ⇒ bit-identical task, every call."""
    net = pw.get_network(spec.model).with_batch(spec.batch)
    if net.kind in ("rnn_seq2seq", "rnn_linear"):
        predicted = pred.predict(net, in_len=spec.in_len).total_time
    else:
        predicted = pred.predict(net).total_time
    times, out_bytes, tile_times = _node_arrays(net, spec.in_len,
                                                spec.actual_unroll, pred)
    task = Task(tid=spec.tid, model=spec.model, priority=spec.priority,
                arrival=spec.arrival, batch=spec.batch, node_times=times,
                node_out_bytes=out_bytes, predicted_total=predicted,
                in_len=spec.in_len, tenant=spec.tenant,
                sla_scale=spec.sla_scale)
    task.node_tile_times = tile_times
    return task
