"""The composable model (port of ``repro/models/transformer.py``): a
periodic stack of (attn, mlp or moe) blocks.

Per-slot parameters are stacked on a leading ``n_periods`` axis as in the
reference; its ``lax.scan`` over periods becomes a Python loop.  Mixers
other than self-attention raise ``NotImplementedError`` naming the
ROADMAP item that ports them.

The cache is a dict ``{"slot{i}": {"k", "v"}}`` of (n_periods, B, T, Hkv,
Dh) tensors.  ``decode_step`` updates it in place and returns it.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import (apply_mlp, apply_norm, embed_tokens,
                                       init_embed, init_mlp, init_norm,
                                       normal_leaf, unembed)
from repro_torch.params import resolve_device

Params = Dict[str, Any]
Cache = Dict[str, Any]

_ROADMAP = {
    "mamba": "item 8 (SSM and hybrid models)",
    "mlstm": "item 8 (SSM and hybrid models)",
    "slstm": "item 8 (SSM and hybrid models)",
    "cross_attn": "item 9 (vision and audio models)",
    "inputs": "item 9 (vision and audio models)",
}


def _not_ported(what: str, key: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: ROADMAP.md, modules to port, "
        f"{_ROADMAP[key]}")


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` unless every block of ``cfg`` is
    self-attention with an MLP or MoE feed-forward (or none) and its inputs
    are tokens."""
    for mixer, _ in cfg.block_pattern:
        if mixer != "attn":
            raise _not_ported(f"{cfg.name}: mixer {mixer!r}", mixer)
    if cfg.img_tokens or cfg.embedding_inputs:
        raise _not_ported(f"{cfg.name}: image/embedding inputs", "inputs")


# ==========================================================================
# Init
# ==========================================================================
def init_params(cfg: ArchConfig, *, generator: torch.Generator,
                dtype: torch.dtype = torch.bfloat16, device="cuda") -> Params:
    """Random weights with the reference's shapes and standard deviations,
    drawn from ``generator`` (which must live on ``device``)."""
    check_supported(cfg)
    dev = resolve_device(device)
    n = cfg.n_periods
    params: Params = {"embed": init_embed(cfg, generator, dtype, dev),
                      "slots": {}}
    for i, (_, ffn) in enumerate(cfg.block_pattern):
        slot = {"norm1": init_norm(cfg, n, dtype, dev),
                "mixer": attn.init_attn(cfg, generator, n, dtype, dev)}
        if ffn != "none":
            init_ffn = moe_mod.init_moe if ffn == "moe" else init_mlp
            slot["norm2"] = init_norm(cfg, n, dtype, dev)
            slot["ffn"] = init_ffn(cfg, generator, n, dtype, dev)
        params["slots"][f"slot{i}"] = slot
    params["final_norm"] = init_norm(cfg, None, dtype, dev)
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": normal_leaf(
            generator, None, (cfg.d_model, cfg.vocab_size),
            cfg.d_model ** -0.5, dtype, dev)}
    return params


def tree_map(fn: Callable, tree):
    """Apply ``fn`` to every tensor leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree) -> list:
    """Leaves of nested dicts and lists, in order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in tree_leaves(v)]
    return [] if tree is None else [tree]


def period_params(slots: Params, i: int) -> Params:
    """The parameters of period ``i`` (views into the stacked leaves)."""
    return tree_map(lambda x: x[i], slots)


# ==========================================================================
# Block application
# ==========================================================================
def _apply_block(slot_idx: int, h: torch.Tensor, slot_p: Params,
                 cfg: ArchConfig, mode: str, cache: Optional[Cache],
                 pos: Optional[int]
                 ) -> Tuple[torch.Tensor, Optional[Cache], torch.Tensor]:
    """Pre-norm residual block (self-attention, then the MLP or MoE if
    any).  Returns (h, new_cache, aux), aux the MoE's load-balance loss
    (f32 zero for other blocks)."""
    ffn = cfg.block_pattern[slot_idx][1]
    y = apply_norm(h, slot_p["norm1"], cfg)
    if mode == "decode":
        y, new_cache = attn.attn_decode(y, slot_p["mixer"], cfg, cache, pos)
    else:
        y, new_cache = attn.attn_prefill(y, slot_p["mixer"], cfg)
    h = h + y
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if ffn != "none":
        y = apply_norm(h, slot_p["norm2"], cfg)
        if ffn == "moe":
            y, aux = moe_mod.apply_moe(y, slot_p["ffn"], cfg)
        else:
            y = apply_mlp(y, slot_p["ffn"], cfg)
        h = h + y
    return h, new_cache, aux


def _embed_inputs(params: Params, cfg: ArchConfig,
                  batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    return embed_tokens(batch["tokens"], params["embed"])


# ==========================================================================
# Public entry points
# ==========================================================================
def prefill(params: Params, batch: Dict[str, torch.Tensor], cfg: ArchConfig
            ) -> Tuple[torch.Tensor, Cache]:
    """Full-sequence forward producing last-position logits + cache."""
    h = _embed_inputs(params, cfg, batch)
    per_period = []
    for p_idx in range(cfg.n_periods):
        slots = period_params(params["slots"], p_idx)
        new_cache = {}
        for i in range(cfg.period):
            h, nc, _ = _apply_block(i, h, slots[f"slot{i}"], cfg,
                                    "prefill", None, None)
            new_cache[f"slot{i}"] = nc
        per_period.append(new_cache)
    cache = stack_periods(per_period)
    h = apply_norm(h, params["final_norm"], cfg)
    return unembed(h[:, -1:], params, cfg), cache


def stack_periods(per_period: list) -> Cache:
    """Per-period cache dicts → one cache stacked on a leading period axis."""
    first = per_period[0]
    return {slot: {name: torch.stack([c[slot][name] for c in per_period])
                   for name in first[slot]} for slot in first}


def decode_step(params: Params, cache: Cache, tokens: torch.Tensor, pos: int,
                cfg: ArchConfig) -> Tuple[torch.Tensor, Cache]:
    """One-token decode.  tokens: (B,1) integer; pos: number of tokens
    already in the KV cache (host int).  Updates ``cache`` in place."""
    h = embed_tokens(tokens, params["embed"])
    for p_idx in range(cfg.n_periods):
        slots = period_params(params["slots"], p_idx)
        for i in range(cfg.period):
            name = f"slot{i}"
            period_cache = {k: c[p_idx] for k, c in cache[name].items()}
            h, _, _ = _apply_block(i, h, slots[name], cfg, "decode",
                                   period_cache, pos)
    h = apply_norm(h, params["final_norm"], cfg)
    return unembed(h, params, cfg), cache


# ==========================================================================
# Cache construction
# ==========================================================================
class LeafSpec(NamedTuple):
    """Shape and dtype of one cache leaf (``jax.ShapeDtypeStruct``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def cache_spec(cfg: ArchConfig, batch: int, max_seq: int,
               dtype: torch.dtype = torch.bfloat16) -> Cache:
    """Cache shapes, stacked over periods."""
    check_supported(cfg)
    out: Cache = {}
    for i in range(cfg.period):
        kv = LeafSpec((cfg.n_periods, batch, max_seq, cfg.n_kv_heads,
                       cfg.d_head), dtype)
        out[f"slot{i}"] = {"k": kv, "v": kv}
    return out


def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               dtype: torch.dtype = torch.bfloat16, device="cuda") -> Cache:
    """Zero cache on ``device``."""
    dev = resolve_device(device)
    return tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype, device=dev),
                    cache_spec(cfg, batch, max_seq, dtype))


def cache_bytes(cfg: ArchConfig, batch: int, max_seq: int,
                dtype: torch.dtype = torch.bfloat16) -> int:
    spec = cache_spec(cfg, batch, max_seq, dtype)
    return sum(s.dtype.itemsize * functools.reduce(lambda a, b: a * b,
                                                   s.shape, 1)
               for s in tree_leaves(spec))
