"""The composable model (port of ``repro/models/transformer.py``): a
periodic stack of (mixer, ffn) blocks, the mixer self-attention,
cross-attention, Mamba, mLSTM or sLSTM, the ffn an MLP, an MoE or none.
Inputs are tokens, tokens with image embeddings (the VLM, whose
``img_proj`` maps them into the model width for cross-attention), or frame
embeddings (the encoder-only audio model, whose prefill returns logits at
every position and no cache).

Per-slot parameters are stacked on a leading ``n_periods`` axis as in the
reference; its ``lax.scan`` over periods becomes a Python loop.
``train_loss`` runs the stack in mode ``"train"``: attention through
``attn_forward``/``cross_attn_forward`` (plain torch under autograd, never
the kernels), each period under the ``remat`` policy.

The cache is a dict ``{"slot{i}": {...}}`` stacked on a leading period
axis: attention's ``k``/``v`` (n_periods, B, T, Hkv, Dh), cross-attention's
static image ``k``/``v`` (n_periods, B, img_tokens, Hkv, Dh), Mamba's
``ssm`` and ``conv``, mLSTM's ``C``, ``n``, ``m`` and sLSTM's ``c``, ``n``,
``h``, ``m``.  ``decode_step`` updates it in place and returns it:
attention writes its new K/V into the stacked cache, cross-attention
leaves its own as it is, and each recurrent slot's new state is copied
back over its period's slice.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                   create_selective_checkpoint_contexts)

from repro_torch.configs import ArchConfig
from repro_torch.distributed import collectives as col
from repro_torch.distributed.context import Split, current, tp_split, use_ctx
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm
from repro_torch.models.layers import (CE_CHUNK_THRESHOLD, apply_mlp,
                                       apply_norm,
                                       chunked_unembed_cross_entropy,
                                       cross_entropy, embed_tokens,
                                       init_embed, init_mlp, init_norm,
                                       normal_leaf, placing, unembed)
from repro_torch.params import resolve_device

Params = Dict[str, Any]
Cache = Dict[str, Any]

# mixer -> (init, prefill, decode, forward); every init takes (cfg, gen,
# n, dtype, device), every prefill and forward (x, p, cfg),
# cross-attention's also ``img_h``, and every decode (x, p, cfg, cache),
# attention's also ``pos``; prefill and decode return (out, new_cache),
# forward (training) the output alone
_MIXERS = {
    "attn": (attn.init_attn, attn.attn_prefill, attn.attn_decode,
             attn.attn_forward),
    "cross_attn": (attn.init_attn, attn.cross_attn_prefill,
                   attn.cross_attn_decode, attn.cross_attn_forward),
    "mamba": (ssm.init_mamba, ssm.mamba_prefill, ssm.mamba_decode,
              ssm.mamba_forward),
    "mlstm": (ssm.init_mlstm, ssm.mlstm_prefill, ssm.mlstm_decode,
              ssm.mlstm_forward),
    "slstm": (ssm.init_slstm, ssm.slstm_prefill, ssm.slstm_decode,
              ssm.slstm_forward),
}
REMATS = ("none", "dots", "full")


# ==========================================================================
# Init
# ==========================================================================
def init_params(cfg: ArchConfig, *, generator: torch.Generator,
                dtype: torch.dtype = torch.bfloat16, device="cuda",
                place: Optional[Callable] = None) -> Params:
    """Random weights with the reference's shapes and standard deviations,
    drawn from ``generator`` (which must live on ``device``).  Frame
    inputs have no embedding table and always an ``lm_head``; image inputs
    add ``img_proj`` (d_vision, d_model).  ``place``, where given, takes
    each leaf as soon as it is made, in drawing order, and the tree keeps
    what it returns (``layers.placing``)."""
    with placing(place):
        return _init_params(cfg, generator, dtype, resolve_device(device))


def _init_params(cfg: ArchConfig, generator: torch.Generator,
                 dtype: torch.dtype, dev: torch.device) -> Params:
    n = cfg.n_periods
    params: Params = {"slots": {}}
    if not cfg.embedding_inputs:
        params["embed"] = init_embed(cfg, generator, dtype, dev)
    for i, (mixer, ffn) in enumerate(cfg.block_pattern):
        slot = {"norm1": init_norm(cfg, n, dtype, dev),
                "mixer": _MIXERS[mixer][0](cfg, generator, n, dtype, dev)}
        if ffn != "none":
            init_ffn = moe_mod.init_moe if ffn == "moe" else init_mlp
            slot["norm2"] = init_norm(cfg, n, dtype, dev)
            slot["ffn"] = init_ffn(cfg, generator, n, dtype, dev)
        params["slots"][f"slot{i}"] = slot
    params["final_norm"] = init_norm(cfg, None, dtype, dev)
    if not cfg.tie_embeddings or cfg.embedding_inputs:
        params["lm_head"] = {"w": normal_leaf(
            generator, None, (cfg.d_model, cfg.vocab_size),
            cfg.d_model ** -0.5, dtype, dev)}
    if cfg.img_tokens:
        params["img_proj"] = {"w": normal_leaf(
            generator, None, (cfg.d_vision, cfg.d_model),
            cfg.d_vision ** -0.5, dtype, dev)}
    return params


def tree_map(fn: Callable, tree):
    """Apply ``fn`` to every tensor leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree) -> list:
    """Leaves of nested dicts and lists in ``jax.tree.leaves``' order:
    dict keys sorted, lists in order.  The optimizer's global norm and the
    checkpoint's leaf list depend on it."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in tree_leaves(v)]
    return [] if tree is None else [tree]


def tree_unflatten(tree: dict, leaves: list) -> dict:
    """``tree``'s nesting of dicts, its leaves replaced by ``leaves`` taken
    in :func:`tree_leaves` order."""
    it = iter(leaves)

    def build(node):
        if not isinstance(node, dict):
            return next(it)
        built = {k: build(node[k]) for k in sorted(node)}
        return {k: built[k] for k in node}
    out = build(tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def period_params(slots: Params, i: int) -> Params:
    """The parameters of period ``i`` (views into the stacked leaves)."""
    return tree_map(lambda x: x[i], slots)


# ==========================================================================
# Block application
# ==========================================================================
def _apply_block(slot_idx: int, h: torch.Tensor, slot_p: Params,
                 cfg: ArchConfig, mode: str, cache: Optional[Cache],
                 pos: Optional[int], img_h: Optional[torch.Tensor]
                 ) -> Tuple[torch.Tensor, Optional[Cache], torch.Tensor]:
    """Pre-norm residual block (the mixer, then the MLP or MoE if any), in
    mode ``"train"``, ``"prefill"`` or ``"decode"``.  ``img_h`` (B,
    img_tokens, D) feeds cross-attention.  Returns
    (h, new_cache, aux), aux the MoE's load-balance loss (f32 zero for
    other blocks)."""
    mixer, ffn = cfg.block_pattern[slot_idx]
    y = apply_norm(h, slot_p["norm1"], cfg)
    _, prefill_fn, decode_fn, forward_fn = _MIXERS[mixer]
    if mode == "decode":
        extra = (pos,) if mixer == "attn" else ()
        y, new_cache = decode_fn(y, slot_p["mixer"], cfg, cache, *extra)
    else:
        extra = (img_h,) if mixer == "cross_attn" else ()
        if mode == "train":
            y, new_cache = forward_fn(y, slot_p["mixer"], cfg, *extra), None
        else:
            y, new_cache = prefill_fn(y, slot_p["mixer"], cfg, *extra)
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
                  batch: Dict[str, torch.Tensor]
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(h, img_h): token embeddings, or ``frames`` cast to the weights'
    dtype; and for image inputs ``img_embeds @ img_proj`` computed in f32
    and rounded once, as JAX promotes f32 inputs against bf16 weights.
    In the sharded train step the table may hold this process's block of
    the vocabulary (``embed_tokens``)."""
    if cfg.embedding_inputs:
        h = batch["frames"].to(params["lm_head"]["w"].dtype)
    else:
        h = embed_tokens(batch["tokens"], params["embed"],
                         tp_split("vocab", cfg.vocab_size))
    img_h = None
    if cfg.img_tokens:
        img_h = (batch["img_embeds"].float()
                 @ params["img_proj"]["w"].float()).to(h.dtype)
    return h, img_h


def _save_unbatched_products(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of remat ``"dots"``: keep the outputs of
    2-D products (``aten.mm``, what the projections and MLPs lower to) and
    recompute the rest, batched products included: the counterpart of
    ``jax.checkpoint_policies.checkpoint_dots_with_no_batch_dims``."""
    return (CheckpointPolicy.MUST_SAVE if op is torch.ops.aten.mm.default
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _train_period(h: torch.Tensor, slots: Params, cfg: ArchConfig,
                  img_h: Optional[torch.Tensor]):
    """One period of blocks in mode ``"train"``: (h, aux), aux the last
    block's, as the reference's scan carries it."""
    for i in range(cfg.period):
        h, _, aux = _apply_block(i, h, slots[f"slot{i}"], cfg, "train",
                                 None, None, img_h)
    return h, aux


def _train_stack(params: Params, h: torch.Tensor, cfg: ArchConfig,
                 img_h: Optional[torch.Tensor], remat: str,
                 gather: Optional[Callable] = None):
    """The periods in turn, each under ``remat``: ``"none"`` keeps every
    activation, ``"full"`` only the period's inputs (non-reentrant
    ``checkpoint``), ``"dots"`` also its 2-D products.  Returns (h, aux),
    aux summed over periods in f32.  The reference's scan adds only each
    period's last block's aux (``transformer.py:190-199``): for jamba,
    one MoE block in four; the port adds the same.  ``gather`` (see
    ``train_loss``) runs inside each period's remat region."""
    if remat not in REMATS:
        raise ValueError(f"remat must be one of {REMATS}, got {remat!r}")
    ckpt = dict(use_reentrant=False, preserve_rng_state=False)
    if remat == "dots":
        ckpt["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_unbatched_products)
    ctx = current()

    def period(h, slots, img_h):
        # a period's recompute may run on another thread (the device's
        # backward thread): it enters the sharding context its forward saw
        with use_ctx(ctx):
            if gather is not None:
                slots = gather(slots, "slots")
            return _train_period(h, slots, cfg, img_h)

    aux_acc = torch.zeros((), dtype=torch.float32, device=h.device)
    # one unbind of each stacked leaf: its backward stacks the periods'
    # gradients once, where a view per period (``period_params``) would add
    # a zero-filled gradient of the whole stacked leaf for every period
    periods = tree_map(lambda x: x.unbind(0), params["slots"])
    for p_idx in range(cfg.n_periods):
        slots = tree_map(lambda u: u[p_idx], periods)
        if remat == "none":
            h, aux = period(h, slots, img_h)
        else:
            h, aux = checkpoint(period, h, slots, img_h, **ckpt)
        aux_acc = aux_acc + aux
    return h, aux_acc


# ==========================================================================
# Public entry points
# ==========================================================================
def train_loss(params: Params, batch: Dict[str, torch.Tensor],
               cfg: ArchConfig, remat: str = "none",
               aux_weight: float = 0.01, gather: Optional[Callable] = None
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean next-token cross-entropy plus ``aux_weight`` times the MoE
    load-balance loss: (loss, {"ce", "moe_aux"}).  ``batch`` holds
    ``labels`` (B,S) and ``tokens`` (B,S), or ``frames`` (B,S,D) for the
    encoder-only model (scored through ``lm_head``), and ``img_embeds``
    for the VLM.  Above ``CE_CHUNK_THRESHOLD`` logits (counted over the
    whole vocabulary, split or not) the unembed and CE run in
    checkpointed sequence chunks.  Where the sharded step splits the
    vocabulary over 'model' the table or ``lm_head`` holds this process's
    block of it, the logits are that block and the CE combines the
    blocks (``layers._token_nll``).

    ``gather(tree, path)`` (the sharded train step's) makes a subtree of
    local parameter shards whole (but for the 'model' shards of the layers
    the step splits) just before its use: the top-level leaves
    once (path ``""``), each period's slot leaves inside the period's remat
    region (path ``"slots"``), so one period at a time is whole."""
    params = _top_level(params, gather)
    h, img_h = _embed_inputs(params, cfg, batch)
    h, aux = _train_stack(params, h, cfg, img_h, remat, gather)
    h = apply_norm(h, params["final_norm"], cfg)
    if cfg.embedding_inputs:
        unembed_fn = lambda hh: hh @ params["lm_head"]["w"]
    else:
        unembed_fn = lambda hh: unembed(hh, params, cfg)
    b, s, _ = h.shape
    vocab = tp_split("vocab", cfg.vocab_size)
    if b * s * cfg.vocab_size > CE_CHUNK_THRESHOLD:
        ce = chunked_unembed_cross_entropy(h, batch["labels"], unembed_fn,
                                           vocab)
    else:
        ce = cross_entropy(unembed_fn(h), batch["labels"], vocab)
    return ce + aux_weight * aux, {"ce": ce, "moe_aux": aux}


def _whole_vocab(logits: torch.Tensor, sp: Optional[Split]) -> torch.Tensor:
    """Logits of every vocabulary entry: this process's block (a split
    vocabulary) gathered over 'model', else ``logits`` itself."""
    if sp is None:
        return logits
    return col.all_gather(logits, logits.dim() - 1, sp.mesh, sp.axes)


def _top_level(params: Params, gather: Optional[Callable]) -> Params:
    """``params`` with its top-level leaves gathered (see ``train_loss``)."""
    if gather is None:
        return params
    return {**gather({k: v for k, v in params.items() if k != "slots"}, ""),
            "slots": params["slots"]}


def prefill(params: Params, batch: Dict[str, torch.Tensor], cfg: ArchConfig,
            gather: Optional[Callable] = None) -> Tuple[torch.Tensor, Cache]:
    """Full-sequence forward producing last-position logits + cache; for
    frame inputs (encoder-only) logits at every position and no cache.
    ``gather`` (the sharded serving step's) makes local shards whole but
    for what the step splits, as in ``train_loss``: the top-level leaves
    once, each period's just before it runs; the logits of a vocabulary
    split over 'model' are gathered whole."""
    params = _top_level(params, gather)
    h, img_h = _embed_inputs(params, cfg, batch)
    per_period = []
    for p_idx in range(cfg.n_periods):
        slots = period_params(params["slots"], p_idx)
        if gather is not None:
            slots = gather(slots, "slots")
        new_cache = {}
        for i in range(cfg.period):
            h, nc, _ = _apply_block(i, h, slots[f"slot{i}"], cfg,
                                    "prefill", None, None, img_h)
            new_cache[f"slot{i}"] = nc
        per_period.append(new_cache)
    h = apply_norm(h, params["final_norm"], cfg)
    vocab = tp_split("vocab", cfg.vocab_size)
    if cfg.embedding_inputs:      # encoder-only: every position, no cache
        return _whole_vocab(h @ params["lm_head"]["w"], vocab), {}
    return (_whole_vocab(unembed(h[:, -1:], params, cfg), vocab),
            stack_periods(per_period))


def stack_periods(per_period: list) -> Cache:
    """Per-period cache dicts → one cache stacked on a leading period axis."""
    first = per_period[0]
    return {slot: {name: torch.stack([c[slot][name] for c in per_period])
                   for name in first[slot]} for slot in first}


def decode_step(params: Params, cache: Cache, tokens: torch.Tensor, pos: int,
                cfg: ArchConfig, gather: Optional[Callable] = None
                ) -> Tuple[torch.Tensor, Cache]:
    """One-token decode.  tokens: (B,1) integer; pos: number of tokens
    already in the KV cache (host int).  Updates ``cache`` in place:
    attention writes into it, cross-attention's image K/V stay as they
    are, and a recurrent slot's new state (a new tensor) is copied over
    its period's slice.  ``gather``: as in ``prefill``; the cache is then
    this process's blocks of it."""
    params = _top_level(params, gather)
    vocab = tp_split("vocab", cfg.vocab_size)
    h = embed_tokens(tokens, params["embed"], vocab)
    for p_idx in range(cfg.n_periods):
        slots = period_params(params["slots"], p_idx)
        if gather is not None:
            slots = gather(slots, "slots")
        for i, (mixer, _) in enumerate(cfg.block_pattern):
            name = f"slot{i}"
            period_cache = {k: c[p_idx] for k, c in cache[name].items()}
            h, new_state, _ = _apply_block(i, h, slots[name], cfg, "decode",
                                           period_cache, pos, None)
            if mixer not in ("attn", "cross_attn"):
                for k, v in new_state.items():
                    period_cache[k].copy_(v)
    h = apply_norm(h, params["final_norm"], cfg)
    return _whole_vocab(unembed(h, params, cfg), vocab), cache


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
    if mixer == "cross_attn":
        kv = LeafSpec((batch, cfg.img_tokens, cfg.n_kv_heads, cfg.d_head),
                      dtype)
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
