# Copied from src/repro/core/task.py; `repro.` rewritten to `repro_torch.`.
"""Inference-task context (the paper's Fig-4 task context table)."""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np

PRIORITY_TOKENS = {"low": 1, "medium": 3, "high": 9}
PRIORITY_LEVELS = (1, 3, 9)


class TaskState(enum.Enum):
    """Lifecycle of a task across every execution layer."""

    WAITING = "waiting"        # in ReadyQueue, never run or KILLed back
    RUNNING = "running"
    PREEMPTED = "preempted"    # checkpointed, in ReadyQueue
    DONE = "done"
    DROPPED = "dropped"        # shed by admission control; never executed


@dataclasses.dataclass
class Task:
    """One inference request dispatched to the NPU scheduler.

    Static fields mirror the paper's context table: TaskID, priority,
    Time_estimated (predictor), Time_isolated; dynamic fields track tokens,
    executed time and preemption state.
    """
    tid: int
    model: str
    priority: int                      # 1 / 3 / 9
    arrival: float                     # seconds
    batch: int
    # per-node *actual* durations (actual unroll), seconds
    node_times: np.ndarray
    # per-node output-activation bytes (checkpoint state at each boundary)
    node_out_bytes: np.ndarray
    predicted_total: float             # Time_estimated (predictor, LUT unroll)
    in_len: int = 0
    tenant: Optional[str] = None       # SLA class this task belongs to
    sla_scale: Optional[float] = None  # SLA target = sla_scale x isolated time

    # ---- dynamic scheduling state ----
    state: TaskState = TaskState.WAITING
    device: Optional[int] = None       # device the task last ran on (cluster)
    phase: Optional[str] = None        # batched serving: "prefill"/"decode"
    #                                    (None on the whole-task path)
    tokens: float = 0.0
    executed: float = 0.0              # Time_executed (actual progress)
    last_wake: float = 0.0             # last token-accrual timestamp
    first_service: Optional[float] = None
    completion: Optional[float] = None
    n_preemptions: int = 0
    n_kills: int = 0
    checkpoint_overhead: float = 0.0   # total ckpt+restore seconds paid
    restore_pending: bool = False      # must pay restore latency on resume
    # ---- fault-tolerance state (core/faults.py, workloads/retry.py) ----
    ckpt_executed: float = 0.0         # progress at the last durable ckpt
    lost_work: float = 0.0             # executed seconds wiped by crashes
    #                                    and KILL restarts (redone work)
    n_crashes: int = 0                 # devices that died under this task
    n_retries: int = 0                 # client re-offers after a drop
    abandoned: bool = False            # client gave up (budget/deadline)
    first_offer: Optional[float] = None  # first submission (retries move
    #                                      ``arrival`` to the last attempt)

    def __post_init__(self):
        self.tokens = float(self.priority)
        self.last_wake = self.arrival
        self._cum = np.concatenate([[0.0], np.cumsum(self.node_times)])

    # ---- static properties ----
    @property
    def isolated_time(self) -> float:
        """C_single: uninterrupted execution time (actual)."""
        return float(self._cum[-1])

    @property
    def total_nodes(self) -> int:
        """Number of schedulable periods (checkpointable boundaries)."""
        return len(self.node_times)

    # ---- progress ----
    @property
    def remaining(self) -> float:
        """Actual (oracle) seconds of work left."""
        return max(0.0, self.isolated_time - self.executed)

    @property
    def predicted_remaining(self) -> float:
        """Time_estimated - Time_executed (Algorithm 3 lines 1-2)."""
        return max(0.0, self.predicted_total - self.executed)

    def current_node(self) -> int:
        """Index of the node containing the current progress point."""
        return int(np.searchsorted(self._cum, self.executed, side="right") - 1)

    def checkpoint_bytes(self, vmem_bytes: int) -> int:
        """Live context state at the current boundary: the output
        activations derived so far, bounded by on-chip UBUF/ACCQ capacity
        (paper §IV-B)."""
        node = min(self.current_node(), self.total_nodes - 1)
        return int(min(self.node_out_bytes[node], vmem_bytes))

    def reset_progress(self):
        """KILL: all progress is lost (paper §IV-C), including any durable
        checkpoint — a killed task restarts from scratch."""
        self.executed = 0.0
        self.restore_pending = False
        self.ckpt_executed = 0.0

    # ---- metrics ----
    @property
    def turnaround(self) -> float:
        """Completion minus arrival (requires the task to be DONE)."""
        assert self.completion is not None
        return self.completion - self.arrival

    @property
    def ntt(self) -> float:
        """Normalized turnaround time C_multi / C_single (Eq 1)."""
        return self.turnaround / self.isolated_time

    @property
    def sla_target(self) -> Optional[float]:
        """Absolute turnaround budget (seconds), or None when the task has
        no tenant-assigned SLA class."""
        if self.sla_scale is None:
            return None
        return self.sla_scale * self.isolated_time

    def sla_met(self, default_scale: float = 8.0) -> bool:
        """Whether turnaround met the tenant SLA (or ``default_scale``)."""
        scale = self.sla_scale if self.sla_scale is not None else default_scale
        return self.turnaround <= scale * self.isolated_time
