"""The plain reference of a dense decoder (``arch/dense.py``), float32 with
TF32 off, written from the published architectures: OLMo's LayerNorm
without parameters and tied embeddings, Qwen1.5's RMSNorm, QKV biases and
untied head, and for both SwiGLU, RoPE on split halves (the HF
convention) and multi-head causal attention.  It reads the weights the
benchmark drew, in the serving dtype, and upcasts them one layer at a
time, so it fits beside them."""
from __future__ import annotations

import math
from typing import Dict, Sequence

import torch

from bench.reference import _linear, exact_f32


def _norm(x: torch.Tensor, scale, cfg: Dict) -> torch.Tensor:
    eps = cfg["norm_eps"]
    if cfg["norm"] == "rmsnorm":
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale
    if cfg["norm"] == "layernorm_np":
        mu = x.mean(-1, keepdim=True)
        var = (x - mu).pow(2).mean(-1, keepdim=True)
        return (x - mu) * torch.rsqrt(var + eps)
    raise ValueError(f"unknown norm {cfg['norm']!r}")


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, H, Dh) at positions 0..S-1, rotating split halves; the angles
    are taken in float64."""
    s, _, dh = x.shape
    inv = theta ** (-torch.arange(0, dh, 2, dtype=torch.float64,
                                  device=x.device) / dh)
    ang = torch.arange(s, dtype=torch.float64, device=x.device)[:, None] * inv
    cos = torch.cos(ang).float()[:, None, :]
    sin = torch.sin(ang).float()[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attention(q, k, v) -> torch.Tensor:
    """Causal softmax attention, every head its own K and V (MHA);
    q, k, v (S, H, Dh) -> (S, H * Dh)."""
    s, h, dh = q.shape
    scores = torch.einsum("shd,thd->hst", q, k) / math.sqrt(dh)
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device).triu(1)
    p = torch.softmax(scores.masked_fill(mask, float("-inf")), dim=-1)
    return torch.einsum("hst,thd->shd", p, v).reshape(s, h * dh)


def _layer(h: torch.Tensor, w: Dict, i: int, cfg: Dict,
           fp8: bool) -> torch.Tensor:
    lw = {k: t[i].float() for k, t in w.items()
          if k in ("wq", "wk", "wv", "wo", "bq", "bk", "bv", "norm1",
                   "norm2", "w_in", "w_gate", "w_out")}
    d = cfg["hidden_size"]
    x = _norm(h, lw.get("norm1"), cfg)
    q = _linear(x, lw["wq"].reshape(d, -1), fp8).unflatten(-1, lw["wq"].shape[1:])
    k = _linear(x, lw["wk"].reshape(d, -1), fp8).unflatten(-1, lw["wk"].shape[1:])
    v = _linear(x, lw["wv"].reshape(d, -1), fp8).unflatten(-1, lw["wv"].shape[1:])
    if "bq" in lw:
        q, k, v = q + lw["bq"], k + lw["bk"], v + lw["bv"]
    theta = cfg["rope_theta"]
    o = _attention(_rope(q, theta), _rope(k, theta), v)
    h = h + _linear(o, lw["wo"].reshape(-1, d), fp8)
    x = _norm(h, lw.get("norm2"), cfg)
    g = torch.nn.functional.silu(_linear(x, lw["w_gate"], fp8))
    return h + _linear(g * _linear(x, lw["w_in"], fp8), lw["w_out"], fp8)


@torch.no_grad()
def logits_at(cfg: Dict, w: Dict, tokens: torch.Tensor, rows: Sequence[int],
              fp8: bool = False) -> torch.Tensor:
    """Float32 logits (len(rows), vocab) of the sequence ``tokens`` (1-D)
    at positions ``rows``: row p predicts the token at p + 1."""
    with exact_f32():
        h = w["embed"][tokens.long()].float()
        for i in range(cfg["num_hidden_layers"]):
            h = _layer(h, w, i, cfg, fp8)
        final = w.get("final_norm")
        h = _norm(h[list(rows)], None if final is None else final.float(), cfg)
        head = (w["lm_head"] if "lm_head" in w else w["embed"].T).float()
        return _linear(h, head, fp8)
