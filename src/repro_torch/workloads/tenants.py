# Copied from src/repro/workloads/tenants.py; `repro.` rewritten to `repro_torch.`.
"""Tenant SLA classes and traffic mixes.

A :class:`TenantSpec` describes one tenant's traffic: which models it
invokes, its share of the offered load, its scheduler priority (fixed, or
sampled from the paper's {1,3,9} levels), its SLA multiplier (target
turnaround = ``sla_scale`` x isolated time), and its batch/length
distributions.  A :class:`TrafficMix` composes tenants with an arrival
process into a complete, generatable workload description.

``kind="paper"`` mixes reference the §III 8-DNN suite and materialize into
simulator :class:`~repro_torch.core.task.Task` objects; ``kind="serving"`` mixes
reference registered serving architectures (``repro_torch.models.registry``) and
materialize into :class:`~repro_torch.serving.request.InferenceRequest` payloads
via :func:`repro_torch.workloads.serving_adapter.to_requests`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs import paper_workloads as pw
from repro_torch.core.task import PRIORITY_LEVELS
from repro_torch.workloads.arrivals import ArrivalProcess, UniformWindow
from repro_torch.workloads.spec import BATCH_CHOICES


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant's model mix, SLA class, and sampling distributions."""
    name: str
    models: Tuple[str, ...]
    share: float = 1.0                  # relative traffic fraction
    priority: Optional[int] = None      # fixed level; None → sample
    priority_choices: Tuple[int, ...] = PRIORITY_LEVELS
    batch: Optional[int] = None         # fixed batch; None → sample
    batch_choices: Tuple[int, ...] = BATCH_CHOICES
    sla_scale: float = 8.0              # target = sla_scale x isolated time
    # serving-kind payload distributions (token prompts / decode budget)
    prompt_len_range: Tuple[int, int] = (5, 14)
    decode_len_range: Tuple[int, int] = (2, 7)
    max_new_tokens: int = 16

    def __post_init__(self):
        if not self.models:
            raise ValueError(f"tenant {self.name!r} needs >= 1 model")
        if self.share <= 0:
            raise ValueError(f"tenant {self.name!r} share must be > 0")


@dataclasses.dataclass(frozen=True)
class TrafficMix:
    """Tenants + arrival process = a generatable workload."""
    tenants: Tuple[TenantSpec, ...]
    arrivals: ArrivalProcess
    kind: str = "paper"                 # "paper" | "serving"

    def __post_init__(self):
        if not self.tenants:
            raise ValueError("mix needs >= 1 tenant")
        names = [t.name for t in self.tenants]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tenant names: {names}")
        if self.kind not in ("paper", "serving"):
            raise ValueError(f"unknown mix kind {self.kind!r}")

    def shares(self) -> np.ndarray:
        s = np.asarray([t.share for t in self.tenants], dtype=float)
        return s / s.sum()


def paper_mix(arrivals: Optional[ArrivalProcess] = None,
              models: Sequence[str] = pw.WORKLOAD_NAMES,
              sla_scale: float = 8.0) -> TrafficMix:
    """The §III methodology as a mix: one tenant over the 8-DNN suite,
    priorities {1,3,9}, batch {1,4,16}, uniform-window dispatch.  With the
    default :class:`UniformWindow` process this reproduces the original
    ``core.trace.make_workload`` bit-for-bit at equal seeds."""
    tenant = TenantSpec(name="paper", models=tuple(models),
                        sla_scale=sla_scale)
    return TrafficMix(tenants=(tenant,),
                      arrivals=arrivals or UniformWindow(), kind="paper")
