"""Preemptible executor (port of ``repro/serving/executor.py``): runs the
model with preemption points at super-block (period) boundaries during
prefill and token boundaries during decode.

The execution context held at a boundary — hidden activations, the KV
cache, generated tokens — is an explicit :class:`ExecState`.  Suspend and
resume are exact: a preempted-then-resumed run produces bit-identical
outputs to an uninterrupted one.  Each step runs under
``torch.inference_mode()``; the decode cache is updated in place.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import ArchConfig
from repro_torch.models import transformer
from repro_torch.models.layers import apply_norm, unembed
from repro_torch.models.registry import Model

Params = Dict[str, Any]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclasses.dataclass
class ExecState:
    """Checkpointable execution context (the CHECKPOINT payload)."""
    phase: str                            # prefill | decode | done
    period_idx: int = 0
    h: Optional[torch.Tensor] = None      # hidden activations at the boundary
    img_h: Optional[torch.Tensor] = None
    cache_slices: Optional[List] = None   # per completed period (prefill)
    cache: Optional[Any] = None           # stacked cache (decode)
    pos: int = 0                          # tokens in cache
    tokens_out: Optional[List[np.ndarray]] = None
    last_logits: Optional[torch.Tensor] = None

    def context_bytes(self) -> int:
        """Size of the state a CHECKPOINT must preserve: the live
        activation boundary state; the KV cache stays in device memory."""
        return int(sum(_nbytes(t) for t in (self.h, self.last_logits)
                       if t is not None))

    def cache_bytes(self) -> int:
        leaves = (transformer.tree_leaves(self.cache_slices)
                  + transformer.tree_leaves(self.cache))
        return int(sum(_nbytes(t) for t in leaves))


def _greedy(logits: torch.Tensor) -> np.ndarray:
    """First index of the maximum, as ``jnp.argmax``."""
    return torch.argmax(logits[:, -1], dim=-1).to(torch.int32).cpu().numpy()


class PreemptibleExecutor:
    """Period/token-granular executor for one model instance."""

    def __init__(self, model: Model, params: Params):
        self.model = model
        self.cfg: ArchConfig = model.cfg
        self.params = params

    @property
    def n_periods(self) -> int:
        return self.cfg.n_periods

    def _device(self) -> torch.device:
        return self.params["embed"]["table"].device

    @torch.inference_mode()
    def start(self, batch: Dict[str, Any]) -> ExecState:
        tokens = torch.as_tensor(np.asarray(batch["tokens"]),
                                 device=self._device())
        h = transformer._embed_inputs(self.params, self.cfg,
                                      {"tokens": tokens})
        return ExecState(phase="prefill", period_idx=0, h=h, cache_slices=[],
                         tokens_out=[], pos=int(h.shape[1]))

    @torch.inference_mode()
    def step_prefill(self, st: ExecState) -> ExecState:
        """Execute one super-block period; boundary afterwards."""
        assert st.phase == "prefill"
        cfg = self.cfg
        slots = transformer.period_params(self.params["slots"], st.period_idx)
        h, new_cache = st.h, {}
        for i in range(cfg.period):
            h, nc = transformer._apply_block(i, h, slots[f"slot{i}"], cfg,
                                             "prefill", None, None)
            new_cache[f"slot{i}"] = nc
        st.h = h
        st.cache_slices.append(new_cache)
        st.period_idx += 1
        if st.period_idx == self.n_periods:
            hn = apply_norm(st.h, self.params["final_norm"], cfg)
            st.last_logits = unembed(hn[:, -1:], self.params, cfg)
            # stack the per-period slices into the decode cache and
            # greedy-sample the first token
            st.cache = transformer.stack_periods(st.cache_slices)
            st.cache_slices = None
            st.tokens_out.append(_greedy(st.last_logits))
            st.phase = "decode"
        return st

    def _grow_cache(self, st: ExecState, extra: int) -> None:
        """Extend the attention KV buffers to hold ``extra`` more tokens."""
        def pad(a: torch.Tensor) -> torch.Tensor:
            shape = list(a.shape)
            shape[2] = extra             # (periods, B, T, H, Dh)
            return torch.cat([a, a.new_zeros(shape)], dim=2)
        st.cache = {name: {k: pad(v) for k, v in slot.items()}
                    for name, slot in st.cache.items()}

    @torch.inference_mode()
    def step_decode(self, st: ExecState) -> ExecState:
        """Generate one token; boundary afterwards."""
        assert st.phase == "decode"
        t_cap = st.cache["slot0"]["k"].shape[2]
        if st.pos >= t_cap:
            self._grow_cache(st, max(16, t_cap // 4))
        tok = torch.as_tensor(st.tokens_out[-1][:, None],
                              device=self._device())
        logits, st.cache = transformer.decode_step(
            self.params, st.cache, tok, st.pos, self.cfg)
        st.pos += 1
        st.last_logits = logits
        st.tokens_out.append(_greedy(logits))
        return st

    def step(self, st: ExecState) -> ExecState:
        if st.phase == "prefill":
            return self.step_prefill(st)
        if st.phase == "decode":
            return self.step_decode(st)
        return st

    # ------------------------------------------------------------------
    def run_uninterrupted(self, batch: Dict[str, Any], max_new_tokens: int,
                          eos_id: Optional[int] = None) -> ExecState:
        st = self.start(batch)
        while st.phase == "prefill":
            st = self.step_prefill(st)
        while st.phase == "decode" and len(st.tokens_out) < max_new_tokens:
            st = self.step_decode(st)
            if eos_id is not None and bool(np.all(st.tokens_out[-1] == eos_id)):
                break
        st.phase = "done"
        return st

    @staticmethod
    def checkpoint(st: ExecState) -> ExecState:
        """Make the context a complete, consistent snapshot: wait for the
        work queued on the state's CUDA stream."""
        if st.h is not None and st.h.is_cuda:
            torch.cuda.current_stream(st.h.device).synchronize()
        return st

    @staticmethod
    def restore(st: ExecState) -> ExecState:
        return st
