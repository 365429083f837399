"""GQA self-attention and cross-attention (port of
``repro/models/attention.py``, prefill and decode).

Attention itself runs through the port's kernels: prefill (self and
cross) through ``flash_attention`` and decode through ``decode_attention``,
whose plain versions take their place on the CPU.  They replace the
reference's ``_dense_attend``/``_chunked_attend``/``_gqa_attend``.  One
deliberate difference in bf16: the reference model casts the
probabilities to ``q.dtype`` before PV; the decode kernel and the
CUDA-core flash kernel (the TPU ones too) keep them in f32, and the port
follows the kernels, in cross-attention as in self-attention.  In f32 the
two are the same.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs import ArchConfig
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.layers import (apply_rope, normal_leaf, rms_norm_head,
                                       stacked)

Params = dict


def init_attn(cfg: ArchConfig, gen: torch.Generator, n: Optional[int], dtype,
              device) -> Params:
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    std = d ** -0.5
    p = {
        "wq": normal_leaf(gen, n, (d, hq, dh), std, dtype, device),
        "wk": normal_leaf(gen, n, (d, hkv, dh), std, dtype, device),
        "wv": normal_leaf(gen, n, (d, hkv, dh), std, dtype, device),
        "wo": normal_leaf(gen, n, (hq, dh, d), (hq * dh) ** -0.5, dtype,
                          device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(stacked(n, (hq, dh)), dtype=dtype, device=device)
        p["bk"] = torch.zeros(stacked(n, (hkv, dh)), dtype=dtype, device=device)
        p["bv"] = torch.zeros(stacked(n, (hkv, dh)), dtype=dtype, device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(stacked(n, (dh,)), dtype=dtype, device=device)
        p["k_norm"] = torch.ones(stacked(n, (dh,)), dtype=dtype, device=device)
    return p


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B,S,D) x (D,H,Dh) → (B,S,H,Dh)."""
    return (x @ w.reshape(w.shape[0], -1)).unflatten(-1, w.shape[1:])


def _out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """(B,S,H,Dh) x (H,Dh,D) → (B,S,D)."""
    return out.flatten(-2) @ wo.reshape(-1, wo.shape[-1])


def _project_q(x, p, cfg: ArchConfig):
    """Queries of x (B,S,D), with bias and qk-norm, before RoPE."""
    q = _proj(x, p["wq"])
    if cfg.qkv_bias:
        q = q + p["bq"]
    if cfg.qk_norm:
        q = rms_norm_head(q, p["q_norm"])
    return q


def _project_kv(src, p, cfg: ArchConfig):
    """Keys and values of src (B,T,D), with bias and qk-norm, before
    RoPE."""
    k, v = _proj(src, p["wk"]), _proj(src, p["wv"])
    if cfg.qkv_bias:
        k, v = k + p["bk"], v + p["bv"]
    if cfg.qk_norm:
        k = rms_norm_head(k, p["k_norm"])
    return k, v


def _project_qkv(x, p, cfg: ArchConfig, positions):
    """x: (B,S,D); positions: (B or 1, S), shared by queries and keys."""
    q = apply_rope(_project_q(x, p, cfg), positions, cfg.rope_theta)
    k, v = _project_kv(x, p, cfg)
    return q, apply_rope(k, positions, cfg.rope_theta), v


def attn_prefill(x: torch.Tensor, p: Params, cfg: ArchConfig
                 ) -> Tuple[torch.Tensor, Params]:
    """Full-sequence self-attention; also returns the KV cache
    (B,T,Hkv,Dh)."""
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = _project_qkv(x, p, cfg, positions)
    # the kernel reads the (B,S,H,Dh) tensors through strides
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal=cfg.causal)
    return _out_proj(out.transpose(1, 2), p["wo"]), {"k": k, "v": v}


def attn_decode(x: torch.Tensor, p: Params, cfg: ArchConfig, cache: Params,
                pos: int) -> Tuple[torch.Tensor, Params]:
    """One-token decode.  x: (B,1,D); cache k/v: (B,T,Hkv,Dh) views of the
    period's slice of the stacked cache; ``pos`` = tokens already in the
    cache.  The new token is written at ``pos`` and attends over
    [0..pos]."""
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(x, p, cfg, positions)
    # in place, where the reference returns a new cache from
    # dynamic_update_slice: the write lands in the stacked cache itself
    cache["k"][:, pos] = k_new[:, 0]
    cache["v"][:, pos] = v_new[:, 0]
    out = decode_attention(q[:, 0], cache["k"].transpose(1, 2),
                           cache["v"].transpose(1, 2), pos)
    return _out_proj(out[:, None], p["wo"]), cache


# --------------------------------------------------------------------------
# Cross-attention (VLM image layers): queries from the text, keys and values
# from the projected image states; no RoPE, no mask
# --------------------------------------------------------------------------
def cross_attn_prefill(x: torch.Tensor, p: Params, cfg: ArchConfig,
                       img_h: torch.Tensor) -> Tuple[torch.Tensor, Params]:
    """x: (B,S,D) text; img_h: (B,Timg,D).  Returns the output and the
    static image KV cache (B,Timg,Hkv,Dh) (the reference's
    ``cross_attn_forward`` and ``cross_attn_kv``)."""
    q = _project_q(x, p, cfg)
    k, v = _project_kv(img_h, p, cfg)
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal=False)
    return _out_proj(out.transpose(1, 2), p["wo"]), {"k": k, "v": v}


def cross_attn_decode(x: torch.Tensor, p: Params, cfg: ArchConfig,
                      cache: Params) -> Tuple[torch.Tensor, Params]:
    """One-token decode over every image position of the static cache,
    which it returns unchanged."""
    q = _project_q(x, p, cfg)
    out = decode_attention(q[:, 0], cache["k"].transpose(1, 2),
                           cache["v"].transpose(1, 2), cache["k"].shape[1] - 1)
    return _out_proj(out[:, None], p["wo"]), cache
