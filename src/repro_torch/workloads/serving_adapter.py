# Copied from src/repro/workloads/serving_adapter.py; `repro.` rewritten to `repro_torch.`.
"""Bridge serving-kind traces to :class:`InferenceRequest` payloads.

A serving-kind :class:`~repro_torch.workloads.trace_io.Trace` names registered
architectures (``repro_torch.models.registry``) instead of the paper's 8 DNNs.
``to_requests`` expands each record into a concrete request: prompt tokens
(and vision/audio payloads where the architecture needs them) are
synthesized from the record's own ``seed``, so replaying an exported trace
rebuilds byte-identical requests with no shared RNG state.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from repro_torch.models.registry import Model
from repro_torch.serving.request import InferenceRequest
from repro_torch.workloads.trace_io import Trace

_VOCAB_CAP = 250      # tiny-model-safe token id ceiling


def to_requests(trace: Trace,
                models: Dict[str, Tuple[Model, dict]]) -> List[InferenceRequest]:
    """Materialize a serving-kind trace into engine requests."""
    if trace.kind != "serving":
        raise ValueError(f"expected a serving-kind trace, got {trace.kind!r}")
    reqs: List[InferenceRequest] = []
    for rec in trace.records:
        if rec.model not in models:
            raise KeyError(f"trace references unregistered model "
                           f"{rec.model!r}; engine serves {sorted(models)}")
        model, _ = models[rec.model]
        cfg = model.cfg
        prng = np.random.default_rng(rec.seed)
        plen = max(1, rec.in_len)
        vocab_hi = max(2, min(_VOCAB_CAP, cfg.vocab_size))
        kw = dict(
            rid=rec.tid, arch=rec.model,
            prompt=prng.integers(1, vocab_hi,
                                 (rec.batch, plen)).astype(np.int32),
            max_new_tokens=rec.max_new_tokens or 16,
            priority=rec.priority, arrival=rec.arrival,
            sla_scale=rec.sla_scale if rec.sla_scale is not None else 8.0,
            true_decode_len=rec.actual_unroll,
            tenant=rec.tenant)
        if getattr(cfg, "img_tokens", 0):
            kw["img_embeds"] = prng.standard_normal(
                (rec.batch, cfg.img_tokens, cfg.d_vision)).astype(np.float32)
        if getattr(cfg, "embedding_inputs", False):
            kw["frames"] = prng.standard_normal(
                (rec.batch, plen, cfg.d_model)).astype(np.float32)
        reqs.append(InferenceRequest(**kw))
    return reqs
