# Copied from src/repro/serving/request.py; `repro.` rewritten to `repro_torch.`.
"""Serving request types."""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class InferenceRequest:
    rid: int
    arch: str                       # registered model name
    prompt: np.ndarray              # (batch, prompt_len) int32 token ids
    max_new_tokens: int = 16
    priority: int = 3               # 1 / 3 / 9
    arrival: float = 0.0            # engine virtual seconds
    sla_scale: float = 8.0          # SLA target = sla_scale x isolated time
    tenant: Optional[str] = None    # SLA class (see repro_torch.workloads)
    eos_id: Optional[int] = None    # stop token (None → run to max_new)
    # ground-truth decode length for simulation-mode runs (sampled from the
    # profiled distribution, unknown to the scheduler)
    true_decode_len: Optional[int] = None
    img_embeds: Optional[np.ndarray] = None
    frames: Optional[np.ndarray] = None
    # ---- client-recovery state (repro_torch.workloads.retry) ----
    n_retries: int = 0              # re-offers after admission drops
    abandoned: bool = False         # client gave up (budget/deadline)
    first_offer: Optional[float] = None   # first submission (retries move
    #                                       ``arrival`` to the last attempt)

    @property
    def batch(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[1])


@dataclasses.dataclass
class RequestResult:
    rid: int
    arch: str
    tokens: np.ndarray              # (batch, n_generated)
    arrival: float
    first_token_time: float
    completion: float
    isolated_time: float
    n_preemptions: int
    n_kills: int
    ckpt_overhead: float
    priority: int
    sla_target: float
    tenant: Optional[str] = None
    # decoded-token count for virtual-mode runs where ``tokens`` is empty
    # (the batched engine fills it; TPOT falls back to ``tokens`` width)
    n_decoded: Optional[int] = None

    @property
    def turnaround(self) -> float:
        return self.completion - self.arrival

    @property
    def ntt(self) -> float:
        return self.turnaround / max(self.isolated_time, 1e-12)

    @property
    def ttft(self) -> float:
        """Time to first token: first decoded token's instant − arrival
        (prefill queueing + prefill compute)."""
        return self.first_token_time - self.arrival

    @property
    def n_tokens(self) -> int:
        """Generated token count (per sequence): ``n_decoded`` when the
        engine recorded it (virtual mode), else the width of ``tokens``."""
        if self.n_decoded is not None:
            return int(self.n_decoded)
        return int(self.tokens.shape[1])

    @property
    def tpot(self) -> float:
        """Time per output token over the decode phase — the serving
        SLO companion to :attr:`ttft` (prefill).  NaN when the request
        decoded fewer than two tokens."""
        n = self.n_tokens
        if n < 2:
            return float("nan")
        return (self.completion - self.first_token_time) / (n - 1)

    @property
    def sla_met(self) -> bool:
        return self.turnaround <= self.sla_target
