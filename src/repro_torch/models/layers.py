"""Shared building blocks (port of ``repro/models/layers.py``): plain
functions on tensors over dicts of tensors.

Initialisers take an explicit ``torch.Generator`` and a leading period
count ``n`` (``None`` for unstacked leaves); stacked leaves are filled one
period at a time so a full-size model never holds an f32 copy of all its
weights.  The random bits differ from ``jax.random``; the tests share
weights through ``repro_torch.params.params_from_numpy`` instead.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.configs import ArchConfig

Params = dict


def stacked(n: Optional[int], shape: Sequence[int]) -> tuple:
    """``shape`` with a leading period axis of ``n`` (none if ``n`` is
    None)."""
    return tuple(shape) if n is None else (n, *shape)


def normal_leaf(gen: torch.Generator, n: Optional[int], shape: Sequence[int],
                std: float, dtype: torch.dtype, device) -> torch.Tensor:
    """N(0, std²) leaf of ``shape``, stacked over ``n`` periods when ``n``
    is not None; drawn in f32 and cast one period at a time."""
    def draw():
        x = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                        device=device)
        return (x * std).to(dtype)
    if n is None:
        return draw()
    out = torch.empty(stacked(n, shape), dtype=dtype, device=device)
    for i in range(n):
        out[i] = draw()
    return out


# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------
def init_norm(cfg: ArchConfig, n: Optional[int], dtype, device) -> Params:
    if cfg.norm == "layernorm_np":
        return {}
    shape = stacked(n, (cfg.d_model,))
    p = {"scale": torch.ones(shape, dtype=dtype, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros(shape, dtype=dtype, device=device)
    return p


def apply_norm(x: torch.Tensor, p: Params, cfg: ArchConfig,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    if cfg.norm == "rmsnorm":
        y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
        return (y * p["scale"].float()).to(x.dtype)
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mean), dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    if cfg.norm == "layernorm":
        y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


def rms_norm_head(x: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """Per-head RMSNorm over the trailing (d_head) dim — qwen3 qk-norm."""
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (y * scale.float()).to(x.dtype)


# --------------------------------------------------------------------------
# Rotary position embedding
# --------------------------------------------------------------------------
def rope_freqs(d_head: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, d_head, 2, dtype=torch.float32,
                        device=device) / d_head
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, Dh); positions: (..., S) integer.  Rotates split
    halves, not interleaved pairs."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)            # (Dh/2,)
    angles = positions[..., None].float() * freqs               # (..., S, Dh/2)
    cos = torch.cos(angles)[..., None, :]                       # (..., S, 1, Dh/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# Dense MLP
# --------------------------------------------------------------------------
def init_mlp(cfg: ArchConfig, gen: torch.Generator, n: Optional[int], dtype,
             device) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    std_in, std_out = d ** -0.5, f ** -0.5
    p = {"w_in": normal_leaf(gen, n, (d, f), std_in, dtype, device),
         "w_out": normal_leaf(gen, n, (f, d), std_out, dtype, device)}
    if cfg.mlp_act == "silu":  # SwiGLU: extra gate matrix
        p["w_gate"] = normal_leaf(gen, n, (d, f), std_in, dtype, device)
    return p


def apply_mlp(x: torch.Tensor, p: Params, cfg: ArchConfig) -> torch.Tensor:
    h = x @ p["w_in"]
    if cfg.mlp_act == "silu":
        h = F.silu(x @ p["w_gate"]) * h
    else:
        h = F.gelu(h, approximate="tanh")   # jax.nn.gelu's default
    return h @ p["w_out"]


# --------------------------------------------------------------------------
# Embedding / unembedding
# --------------------------------------------------------------------------
def init_embed(cfg: ArchConfig, gen: torch.Generator, dtype, device) -> Params:
    return {"table": normal_leaf(gen, None, (cfg.vocab_size, cfg.d_model),
                                 cfg.d_model ** -0.5, dtype, device)}


def embed_tokens(tokens: torch.Tensor, p: Params) -> torch.Tensor:
    return F.embedding(tokens, p["table"])


def unembed(h: torch.Tensor, params: Params, cfg: ArchConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return h @ params["embed"]["table"].T            # (V, D)
    return h @ params["lm_head"]["w"]
