"""Plain PyTorch version of the flash-attention kernel (follows
``repro/kernels/flash_attention/ref.py``): f32 scores, -1e30 masking,
softmax, f32 PV, cast to ``q.dtype``."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True) -> torch.Tensor:
    """q: (B,Hq,S,D); k,v: (B,Hkv,T,D) → (B,Hq,S,D).  Causal: key j is
    visible to query i iff j <= i."""
    b, hq, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    qg = q.reshape(b, hkv, hq // hkv, s, d).float()
    scores = torch.einsum("bhgsd,bhtd->bhgst", qg, k.float()) * (d ** -0.5)
    if causal:
        rows = torch.arange(s, device=q.device)[:, None]
        cols = torch.arange(t, device=q.device)[None, :]
        scores = torch.where(cols <= rows, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgst,bhtd->bhgsd", p, v.float())
    return out.reshape(b, hq, s, d).to(q.dtype)
