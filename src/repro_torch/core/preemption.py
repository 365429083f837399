# Copied from src/repro/core/preemption.py; `repro.` rewritten to `repro_torch.`.
"""NPU preemption mechanisms (paper §IV) and the dynamic selection policy
(Algorithm 3).

Mechanisms
----------
* ``CHECKPOINT`` — store the live context (output activations in UBUF/ACCQ,
  bounded by on-chip capacity) to memory at the next tile boundary; pay
  ``bytes / BW`` now and again on restore.
* ``KILL``       — terminate immediately; zero preemption latency, all
  progress lost.
* ``DRAIN``      — do not preempt; the candidate waits for completion.

The serving engine (TPU path) re-uses the same mechanism enum; there the
checkpointed state is the activation working set only, since KV/SSM caches
are already HBM-resident (DESIGN.md §2).
"""
from __future__ import annotations

import enum

from repro_torch.core.task import Task
from repro_torch.hw import HardwareModel


class Mechanism(enum.Enum):
    """The paper's three preemption mechanisms (§IV-C)."""

    CHECKPOINT = "checkpoint"
    KILL = "kill"
    DRAIN = "drain"


def checkpoint_latency(task: Task, hw: HardwareModel) -> float:
    """Time to spill the preempted task's context state to memory."""
    return task.checkpoint_bytes(hw.vmem_bytes) / hw.hbm_bw


def restore_latency(task: Task, hw: HardwareModel) -> float:
    """Time to reload a checkpointed context before resuming."""
    return task.checkpoint_bytes(hw.vmem_bytes) / hw.hbm_bw


def migration_latency(task: Task, hw: HardwareModel) -> float:
    """Extra cost to resume a checkpointed task on a *different* device:
    the spilled context crosses the inter-chip interconnect (ICI when the
    part has one, otherwise the memory system).  Model-affinity placement
    (core/cluster.py) exists to avoid paying this."""
    bw = hw.ici_bw * max(hw.ici_links, 1) if hw.ici_bw > 0 else hw.hbm_bw
    return task.checkpoint_bytes(hw.vmem_bytes) / bw


def preemption_cost(task: Task, hw: HardwareModel, mech: Mechanism) -> float:
    """Immediate cost charged when ``mech`` displaces ``task``."""
    if mech is Mechanism.CHECKPOINT:
        return checkpoint_latency(task, hw)
    return 0.0


def select_mechanism(running: Task, candidate: Task) -> Mechanism:
    """Algorithm 3: dynamic preemption mechanism selection.

    If the running task is nearing completion while the candidate still has
    relatively long remaining work, draining the current task first hurts
    the candidate relatively little and helps ANTT; otherwise checkpoint.
    """
    deg_current = candidate.predicted_remaining / max(running.predicted_total, 1e-12)
    deg_candidate = running.predicted_remaining / max(candidate.predicted_total, 1e-12)
    if deg_current > deg_candidate:
        return Mechanism.DRAIN
    return Mechanism.CHECKPOINT
