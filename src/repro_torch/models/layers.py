"""Shared building blocks (port of ``repro/models/layers.py``): plain
functions on tensors over dicts of tensors.

Initialisers take an explicit ``torch.Generator`` and a leading period
count ``n`` (``None`` for unstacked leaves); stacked leaves are filled one
period at a time so a full-size model never holds an f32 copy of all its
weights.  The random bits differ from ``jax.random``; the tests share
weights through ``repro_torch.params.params_from_numpy`` instead.

In the sharded train step's context the MLP, the embedding and the
cross-entropy split over 'model' as the reference's rules split d_ff and
the vocabulary (``distributed.context.tp_split``): the MLP's in-projections
hold local columns and its out-projection local rows, reduced over
'model'; the embedding table and the unembedding hold local vocabulary
rows, and the cross-entropy combines the local log-sums.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs import ArchConfig
from repro_torch.distributed import collectives as col
from repro_torch.distributed.context import Split, tp_split

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
    """SwiGLU or GELU MLP.  With d_ff split over 'model' (the reference's
    ``ff`` rule; ``w_in``/``w_gate`` placed (fsdp, model), ``w_out``
    (model, fsdp)) the weights are this process's columns and rows: the
    activation stays local and the out-projection's partial sums are
    reduced over 'model'."""
    h = x @ p["w_in"]
    if cfg.mlp_act == "silu":
        h = F.silu(x @ p["w_gate"]) * h
    else:
        h = F.gelu(h, approximate="tanh")   # jax.nn.gelu's default
    return reduce_over(h @ p["w_out"], tp_split("ff", cfg.d_ff))


def reduce_over(y: torch.Tensor, sp: Optional[Split]) -> torch.Tensor:
    """A row-parallel product's partial sums ``y`` added over ``sp``'s
    processes (``y`` itself when nothing is split)."""
    return y if sp is None else col.all_reduce(y, sp.mesh, sp.axes)


# --------------------------------------------------------------------------
# Embedding / unembedding
# --------------------------------------------------------------------------
def init_embed(cfg: ArchConfig, gen: torch.Generator, dtype, device) -> Params:
    return {"table": normal_leaf(gen, None, (cfg.vocab_size, cfg.d_model),
                                 cfg.d_model ** -0.5, dtype, device)}


def embed_tokens(tokens: torch.Tensor, p: Params,
                 sp: Optional[Split] = None) -> torch.Tensor:
    """Rows of ``p["table"]``.  With the vocabulary split (``sp``) the
    table holds this process's rows: a token outside them looks up zeros,
    and the sum over 'model' is every token's row."""
    if sp is None:
        return F.embedding(tokens, p["table"])
    local, mine = _local_ids(tokens, p["table"].shape[0], sp)
    rows = F.embedding(local, p["table"])
    return col.all_reduce(torch.where(mine[..., None], rows, 0.0), sp.mesh,
                          sp.axes)


def _local_ids(ids: torch.Tensor, v_local: int, sp: Split):
    """(ids as rows of this process's block of ``v_local`` vocabulary
    entries, 0 outside it; whether each id lies in the block)."""
    local = ids.long() - sp.index * v_local
    mine = (local >= 0) & (local < v_local)
    return torch.where(mine, local, 0), mine


def unembed(h: torch.Tensor, params: Params, cfg: ArchConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return h @ params["embed"]["table"].T            # (V, D)
    return h @ params["lm_head"]["w"]


def _token_nll(logits: torch.Tensor, labels: torch.Tensor,
               sp: Optional[Split] = None) -> torch.Tensor:
    """Each position's negative log-likelihood of its label, in f32.  With
    the vocabulary split (``sp``) ``logits`` are this process's block: the
    log-sums of the blocks combine by one more ``logsumexp`` (at one block
    its value, bit for bit), and the label's logit is read where it lies
    and summed over 'model'."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    if sp is None:
        gold = logits.gather(-1, labels[..., None].long())[..., 0]
        return logz - gold
    logz = torch.logsumexp(col.all_gather(logz[None], 0, sp.mesh, sp.axes),
                           dim=0)
    local, mine = _local_ids(labels, logits.shape[-1], sp)
    gold = logits.gather(-1, local[..., None])[..., 0]
    gold = col.all_reduce(torch.where(mine, gold, 0.0), sp.mesh, sp.axes)
    return logz - gold


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  sp: Optional[Split] = None) -> torch.Tensor:
    """Mean token cross-entropy, computed in f32 (``sp``: see
    ``_token_nll``)."""
    return torch.mean(_token_nll(logits, labels, sp))


# At training scale the full logits tensor (B*S, V) can reach hundreds of
# GB; above this element count the unembed+CE is streamed over sequence
# chunks so only (B, chunk, V) logits are ever live.
CE_CHUNK_THRESHOLD = 2 ** 28
CE_SEQ_CHUNK = 256


def _chunk_ce_sum(h: torch.Tensor, labels: torch.Tensor,
                  unembed_fn: Callable, sp: Optional[Split]) -> torch.Tensor:
    return torch.sum(_token_nll(unembed_fn(h), labels, sp))


def chunked_unembed_cross_entropy(h: torch.Tensor, labels: torch.Tensor,
                                  unembed_fn: Callable,
                                  sp: Optional[Split] = None,
                                  seq_chunk: int = CE_SEQ_CHUNK
                                  ) -> torch.Tensor:
    """Mean CE of ``unembed_fn(h_chunk)`` without materialising the full
    logits.  h: (B,S,D); labels: (B,S).  Each chunk runs under a
    non-reentrant ``checkpoint`` (the reference's ``jax.checkpoint`` per
    scan step), so its logits are recomputed in the backward pass and
    never saved; the per-chunk sums add up in f32 in chunk order.  ``sp``
    splits the vocabulary (see ``_token_nll``); it is passed, not read
    from the context, since the recompute may run on another thread."""
    b, s, _ = h.shape
    if s % seq_chunk != 0:
        seq_chunk = s  # fall back (small inputs)
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, s, seq_chunk):
        tot = tot + checkpoint(_chunk_ce_sum, h[:, i:i + seq_chunk],
                               labels[:, i:i + seq_chunk], unembed_fn, sp,
                               use_reentrant=False, preserve_rng_state=False)
    return tot / (b * s)
