"""The composable model (port of ``repro/models/transformer.py``): a
periodic stack of (mixer, ffn) blocks, the mixer self-attention, Mamba,
mLSTM or sLSTM, the ffn an MLP, an MoE or none.

Per-slot parameters are stacked on a leading ``n_periods`` axis as in the
reference; its ``lax.scan`` over periods becomes a Python loop.
Cross-attention and non-token inputs raise ``NotImplementedError`` naming
the ROADMAP item that ports them.

The cache is a dict ``{"slot{i}": {...}}`` stacked on a leading period
axis: attention's ``k``/``v`` (n_periods, B, T, Hkv, Dh), Mamba's ``ssm``
and ``conv``, mLSTM's ``C``, ``n``, ``m`` and sLSTM's ``c``, ``n``, ``h``,
``m``.  ``decode_step`` updates it in place and returns it: attention
writes its new K/V into the stacked cache, and each recurrent slot's new
state is copied back over its period's slice.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm
from repro_torch.models.layers import (apply_mlp, apply_norm, embed_tokens,
                                       init_embed, init_mlp, init_norm,
                                       normal_leaf, unembed)
from repro_torch.params import resolve_device

Params = Dict[str, Any]
Cache = Dict[str, Any]

_ROADMAP = {
    "cross_attn": "item 9 (vision and audio models)",
    "inputs": "item 9 (vision and audio models)",
}


def _not_ported(what: str, key: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: ROADMAP.md, modules to port, "
        f"{_ROADMAP[key]}")


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` unless every block's mixer is
    self-attention, Mamba, mLSTM or sLSTM and the inputs are tokens."""
    for mixer, _ in cfg.block_pattern:
        if mixer not in _MIXERS:
            raise _not_ported(f"{cfg.name}: mixer {mixer!r}", mixer)
    if cfg.img_tokens or cfg.embedding_inputs:
        raise _not_ported(f"{cfg.name}: image/embedding inputs", "inputs")


# mixer -> (init, prefill, decode); every init takes (cfg, gen, n, dtype,
# device), every prefill (x, p, cfg) and every decode (x, p, cfg, cache),
# attention's also ``pos``; prefill and decode return (out, new_cache)
_MIXERS = {
    "attn": (attn.init_attn, attn.attn_prefill, attn.attn_decode),
    "mamba": (ssm.init_mamba, ssm.mamba_prefill, ssm.mamba_decode),
    "mlstm": (ssm.init_mlstm, ssm.mlstm_prefill, ssm.mlstm_decode),
    "slstm": (ssm.init_slstm, ssm.slstm_prefill, ssm.slstm_decode),
}


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
    for i, (mixer, ffn) in enumerate(cfg.block_pattern):
        slot = {"norm1": init_norm(cfg, n, dtype, dev),
                "mixer": _MIXERS[mixer][0](cfg, generator, n, dtype, dev)}
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
    """Pre-norm residual block (the mixer, then the MLP or MoE if any).
    Returns (h, new_cache, aux), aux the MoE's load-balance loss (f32 zero
    for other blocks)."""
    mixer, ffn = cfg.block_pattern[slot_idx]
    y = apply_norm(h, slot_p["norm1"], cfg)
    _, prefill_fn, decode_fn = _MIXERS[mixer]
    if mode != "decode":
        y, new_cache = prefill_fn(y, slot_p["mixer"], cfg)
    elif mixer == "attn":
        y, new_cache = decode_fn(y, slot_p["mixer"], cfg, cache, pos)
    else:
        y, new_cache = decode_fn(y, slot_p["mixer"], cfg, cache)
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
    already in the KV cache (host int).  Updates ``cache`` in place:
    attention writes into it, and a recurrent slot's new state (a new
    tensor) is copied over its period's slice."""
    h = embed_tokens(tokens, params["embed"])
    for p_idx in range(cfg.n_periods):
        slots = period_params(params["slots"], p_idx)
        for i, (mixer, _) in enumerate(cfg.block_pattern):
            name = f"slot{i}"
            period_cache = {k: c[p_idx] for k, c in cache[name].items()}
            h, new_state, _ = _apply_block(i, h, slots[name], cfg, "decode",
                                           period_cache, pos)
            if mixer != "attn":
                for k, v in new_state.items():
                    period_cache[k].copy_(v)
    h = apply_norm(h, params["final_norm"], cfg)
    return unembed(h, params, cfg), cache


# ==========================================================================
# Cache construction
# ==========================================================================
class LeafSpec(NamedTuple):
    """Shape and dtype of one cache leaf (``jax.ShapeDtypeStruct``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def _slot_cache_shape(mixer: str, cfg: ArchConfig, batch: int, max_seq: int,
                      dtype: torch.dtype) -> Dict[str, LeafSpec]:
    """One period's cache leaves; recurrent states are f32 in every dtype
    except Mamba's conv tail, which holds inputs in the model dtype."""
    f32 = torch.float32
    if mixer == "attn":
        kv = LeafSpec((batch, max_seq, cfg.n_kv_heads, cfg.d_head), dtype)
        return {"k": kv, "v": kv}
    if mixer == "mamba":
        di, ds, dc = cfg.mamba_d_inner, cfg.mamba_d_state, cfg.mamba_d_conv
        return {"ssm": LeafSpec((batch, di, ds), f32),
                "conv": LeafSpec((batch, dc - 1, di), dtype)}
    h = cfg.n_heads
    if mixer == "mlstm":
        dh = int(cfg.lstm_proj_factor * cfg.d_model) // h
        return {"C": LeafSpec((batch, h, dh, dh), f32),
                "n": LeafSpec((batch, h, dh), f32),
                "m": LeafSpec((batch, h), f32)}
    leaf = LeafSpec((batch, h, cfg.d_model // h), f32)       # slstm
    return {"c": leaf, "n": leaf, "h": leaf, "m": leaf}


def cache_spec(cfg: ArchConfig, batch: int, max_seq: int,
               dtype: torch.dtype = torch.bfloat16) -> Cache:
    """Cache shapes, stacked over periods."""
    check_supported(cfg)
    return {f"slot{i}": {name: LeafSpec((cfg.n_periods, *s.shape), s.dtype)
                         for name, s in _slot_cache_shape(
                             mixer, cfg, batch, max_seq, dtype).items()}
            for i, (mixer, _) in enumerate(cfg.block_pattern)}


def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               dtype: torch.dtype = torch.bfloat16, device="cuda") -> Cache:
    """Cache on ``device``: zeros, except the xLSTM stabilisers ``m``,
    which start at -1e30 as the prefill scans do."""
    dev = resolve_device(device)
    cache = tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype, device=dev),
                     cache_spec(cfg, batch, max_seq, dtype))
    for i, (mixer, _) in enumerate(cfg.block_pattern):
        if mixer in ("mlstm", "slstm"):
            cache[f"slot{i}"]["m"].fill_(ssm.M_INIT)
    return cache


def cache_bytes(cfg: ArchConfig, batch: int, max_seq: int,
                dtype: torch.dtype = torch.bfloat16) -> int:
    spec = cache_spec(cfg, batch, max_seq, dtype)
    return sum(s.dtype.itemsize * functools.reduce(lambda a, b: a * b,
                                                   s.shape, 1)
               for s in tree_leaves(spec))
