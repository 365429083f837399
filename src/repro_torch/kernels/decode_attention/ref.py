"""Plain PyTorch version of the decode-attention kernel (follows
``repro/kernels/decode_attention/ref.py``): f32 scores, -1e30 masking of
keys past ``pos``, softmax, f32 PV, cast to ``q.dtype``."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           pos: int) -> torch.Tensor:
    """q: (B,Hq,D); k,v: (B,Hkv,T,D); attend over cache[0..pos] →
    (B,Hq,D)."""
    b, hq, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    qg = q.reshape(b, hkv, hq // hkv, d).float()
    s = torch.einsum("bhgd,bhtd->bhgt", qg, k.float()) * (d ** -0.5)
    valid = torch.arange(t, device=q.device) <= pos
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgt,bhtd->bhgd", p, v.float())
    return out.reshape(b, hq, d).to(q.dtype)
