"""GQA self-attention and cross-attention (port of
``repro/models/attention.py``: train, prefill and decode).

Serving runs attention through the port's kernels: prefill (self and
cross) through ``flash_attention`` and decode through
``decode_attention``, whose plain versions take their place on the CPU.
One deliberate difference in bf16: the reference model casts the
probabilities to ``q.dtype`` before PV; the decode kernel and the
CUDA-core flash kernel (the TPU ones too) keep them in f32, and serving
follows the kernels, in cross-attention as in self-attention.  In f32 the
two are the same.

Training runs ``attn_forward`` and ``cross_attn_forward``: the reference's
``_dense_attend``, ``_chunked_attend`` and ``_gqa_attend`` as plain
differentiable torch, the probabilities cast to ``q.dtype`` before PV as
the reference casts them.  The kernels have no backward and refuse inputs
that require grad, so training never reaches them.

In the sharded train step's context both split over 'model' as the
reference's rules say (``distributed.context.tp_split``):

* ``heads: model`` (the query heads divide): q, ``bq`` and ``wo`` hold
  this process's heads, k and v its KV heads when the KV heads divide
  too; else ``wk``/``wv`` are replicated, and each process projects the
  KV heads its query heads read (query head h reads KV head h // g);
  ``wo`` is row-parallel, its partial sums reduced over 'model';
* ``qseq: model`` (they do not): the queries of this process's block of
  rows against the keys and values of every row, computed whole from
  the whole input (no collective), the causal mask over global row
  indices; the output rows are gathered back over 'model'.

In the sharded serving step's context (``distributed/serve_step.py``)
prefill splits the same way, through the flash kernel on the local heads
or, for a block of query rows, at their offset (``q_offset``); then it
lays the K/V it returns out as decode keeps them, every KV head at this
process's block of positions over 'model' (the reference pins prefill's
cache to its decode sharding): one all_to_all from heads to positions, or
where the query heads do not divide, this block of the whole K/V.  Decode
projects q on the heads of the leaves' 'model' shards (as ``param_specs``
places ``wq``) and k and v on its KV heads (where the KV heads do not
divide 'model', ``wk`` and ``wv`` are replicated, and it projects those
its query heads read), gathers the three (B, H, Dh) tensors over 'model',
writes the new K/V on the process that holds
position ``pos``, runs the decode kernel over this process's block of the
cache (``kv_seq``: over 'model', or every axis for ``long_500k``) with
its log-sum-exp, merges the blocks (``collectives.merge_partials``) and
puts this process's heads of the result through the row-parallel
``wo``.  The reference's decode rules leave the heads whole (``heads:
None``), but its compiled decode keeps ``wq`` placed (fsdp, model); the
port's projections follow the placement, a deliberate difference that
spares every process the whole projections.  Cross-attention decodes
over this process's block of the image keys (split over 'model' where
``img_tokens`` divides) and merges the same way.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from repro_torch.configs import ArchConfig
from repro_torch.distributed import collectives as col
from repro_torch.distributed.context import (TP, Split, current,
                                            model_split, tp_split)
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.layers import (apply_rope, leaf, normal_leaf,
                                       reduce_over, rms_norm_head, stacked)
from repro_torch.obs import host

Params = dict
NEG_INF = -1e30
# KV-chunk threshold: above this many keys (and a multiple of KV_CHUNK),
# training attention streams KV blocks with an online softmax so the
# (S x T) score tensor is never materialised whole
CHUNK_THRESHOLD = 2048
KV_CHUNK = 1024


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
        for name, h in (("bq", hq), ("bk", hkv), ("bv", hkv)):
            p[name] = leaf(torch.zeros(stacked(n, (h, dh)), dtype=dtype,
                                       device=device))
    if cfg.qk_norm:
        for name in ("q_norm", "k_norm"):
            p[name] = leaf(torch.ones(stacked(n, (dh,)), dtype=dtype,
                                      device=device))
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


def _prefill_attend(x: torch.Tensor, kv_src: Optional[torch.Tensor],
                    p: Params, cfg: ArchConfig
                    ) -> Tuple[torch.Tensor, Params]:
    """Prefill attention of x (B,S,D) over ``kv_src`` (cross-attention: no
    RoPE, not causal) or over x itself, through the flash kernel, split
    over 'model' as the rules say (see the module's docstring); returns
    the output and the K/V (B,T,Hkv,Dh) in the decode layout."""
    s = x.shape[1]
    src = x if kv_src is None else kv_src
    heads = tp_split("heads", cfg.n_heads)
    rows = None if heads else tp_split("qseq", s)
    row0, s_q = rows.block(s) if rows else (0, s)
    q = _project_q(x if rows is None else x.narrow(1, row0, s_q), p, cfg)
    p_kv, kv_idx = _kv_heads(p, cfg, heads)
    k, v = _project_kv(src, p_kv, cfg)
    if kv_src is None:
        positions = torch.arange(s, device=x.device)[None, :]
        q = apply_rope(q, positions[:, row0:row0 + s_q], cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    k_a, v_a = ((k, v) if kv_idx is None else
                (k.index_select(2, kv_idx), v.index_select(2, kv_idx)))
    # the kernel reads the (B,S,H,Dh) tensors through strides
    t0 = host.ON and host.now()
    out = flash_attention(q.transpose(1, 2), k_a.transpose(1, 2),
                          v_a.transpose(1, 2),
                          causal=kv_src is None and cfg.causal,
                          q_offset=row0)
    if t0:
        host.add("attn.kernel", t0, host.now())
    y = reduce_over(_out_proj(out.transpose(1, 2), p["wo"]), heads)
    if rows is not None:
        y = col.all_gather(y, 1, rows.mesh, rows.axes)
    seq = model_split(src.shape[1])
    return y, {"k": _every_kv_head(k, cfg, heads, seq),
               "v": _every_kv_head(v, cfg, heads, seq)}


def _kv_cut(cfg: ArchConfig, n: int, index: int) -> Tuple[int, int]:
    """[lo, hi): the KV heads that the query heads of process ``index`` of
    ``n`` read (query head h reads KV head h // g)."""
    hq, g = cfg.n_heads // n, cfg.n_heads // cfg.n_kv_heads
    q0 = index * hq
    return q0 // g, (q0 + hq - 1) // g + 1


def _every_kv_head(k: torch.Tensor, cfg: ArchConfig, heads: Optional[Split],
                   seq: Optional[Split]) -> torch.Tensor:
    """This process's K (or V), (B,T,H,Dh) with H its KV heads
    (``heads``: the KV heads of its query heads; else every KV head), as
    every KV head at this process's block of the T positions where
    ``seq`` splits them over 'model' (prefill's cache in the decode
    layout; a decode token's K/V with ``seq`` None).
    Each process's heads are padded to the same count ``w`` and exchanged
    by one all_to_all (positions to their owners), or gathered where the
    positions are not split; then each KV head is read where it lies.
    Outside the serving context K itself."""
    if heads is None:
        return k if seq is None else k.narrow(1, *seq.block(k.shape[1]))
    n, hkv = heads.n, cfg.n_kv_heads
    divides = hkv % n == 0
    w = hkv // n if divides else max(
        hi - lo for lo, hi in (_kv_cut(cfg, n, r) for r in range(n)))
    b, t, h, dh = k.shape
    if h < w:
        k = torch.cat([k, k.new_zeros((b, t, w - h, dh))], dim=2)
    if seq is not None:
        recv = col.all_to_all(k.reshape(b, n, t // n, w, dh).transpose(0, 1),
                              heads.mesh, TP)
    else:
        recv = col.all_gather(k[None], 0, heads.mesh, heads.axes)
    recv = recv.permute(1, 2, 0, 3, 4).reshape(b, recv.shape[2], n * w, dh)
    if divides:         # process r holds KV heads [r w, (r + 1) w)
        return recv
    # KV head h from the first process that holds it, r = h g // hq of the
    # query heads' split (computed on the device: no host copy, no sync)
    g, hq = cfg.n_heads // hkv, cfg.n_heads // n
    kv = torch.arange(hkv, device=k.device)
    r = kv * g // hq
    return recv.index_select(2, r * w + kv - r * hq // g)


def attn_prefill(x: torch.Tensor, p: Params, cfg: ArchConfig
                 ) -> Tuple[torch.Tensor, Params]:
    """Full-sequence self-attention; also returns the KV cache
    (B,T,Hkv,Dh)."""
    return _prefill_attend(x, None, p, cfg)


def _gather_heads(t: torch.Tensor, sp: Optional[Split]) -> torch.Tensor:
    """(B,1,H_local,Dh) of this process's heads → every head."""
    return t if sp is None else col.all_gather(t, 2, sp.mesh, sp.axes)


def _decode_over_block(q: torch.Tensor, cache: Params,
                       pos: Union[int, torch.Tensor],
                       kv: Optional[Split]) -> torch.Tensor:
    """The decode kernel over the cache block this process holds, whose
    first position is ``kv``'s block start (0 without a split), at
    global ``pos``; with a split the blocks' outputs are merged.  The call
    is the span ``attn.kernel`` while ``obs.host`` records."""
    t0 = host.ON and host.now()
    k, v = cache["k"].transpose(1, 2), cache["v"].transpose(1, 2)
    if kv is None:
        out = decode_attention(q, k, v, pos)
    else:
        t = k.shape[2]
        local = min(max(pos - kv.index * t, -1), t - 1)
        out, lse = decode_attention(q, k, v, local, return_lse=True)
        out = col.merge_partials(out, lse, kv.mesh, kv.axes)
    if t0:
        host.add("attn.kernel", t0, host.now())
    return out


def _heads_out(out: torch.Tensor, p: Params, heads: Optional[Split]
               ) -> torch.Tensor:
    """(B,Hq,Dh) of every head → (B,1,D): this process's heads through
    its rows of ``wo``, summed over 'model'."""
    if heads is not None:
        hq = out.shape[1] // heads.n
        out = out.narrow(1, heads.index * hq, hq)
    return reduce_over(_out_proj(out[:, None], p["wo"]), heads)


def attn_decode(x: torch.Tensor, p: Params, cfg: ArchConfig, cache: Params,
                pos: Union[int, torch.Tensor]) -> Tuple[torch.Tensor, Params]:
    """One-token decode.  x: (B,1,D); cache k/v: (B,T,Hkv,Dh) views of the
    period's slice of the stacked cache (in the serving context this
    process's block of it); ``pos`` = tokens already in the cache, a host
    int or a 0-dim int32 tensor on x's device (read by RoPE, the cache
    write and the kernel on the device, so that the step can be captured
    in a CUDA graph; the same values as the int's, bit for bit).  The new
    token is written at ``pos`` and attends over [0..pos].  A tensor
    ``pos`` with the cache split over positions (``kv_seq``) raises
    ``ValueError``."""
    b = x.shape[0]
    on_device = isinstance(pos, torch.Tensor)
    ctx = current()
    kv = None if ctx is None else ctx.shard_split("kv_seq")
    if on_device and kv is not None:
        raise ValueError("a device pos needs the whole cache on this "
                         "process; kv_seq splits it")
    positions = (pos.expand(b, 1) if on_device else
                 torch.full((b, 1), pos, dtype=torch.int32, device=x.device))
    heads = model_split(cfg.n_heads)
    q = _gather_heads(apply_rope(_project_q(x, p, cfg), positions,
                                 cfg.rope_theta), heads)
    # this process's KV heads (those its query heads read where the KV
    # heads do not divide 'model'), then every KV head
    p_kv, _ = _kv_heads(p, cfg, heads)
    k_new, v_new = _project_kv(x, p_kv, cfg)
    k_new = _every_kv_head(apply_rope(k_new, positions, cfg.rope_theta), cfg,
                           heads, None)
    v_new = _every_kv_head(v_new, cfg, heads, None)
    start = kv.index * cache["k"].shape[1] if kv else 0
    # in place, where the reference returns a new cache from
    # dynamic_update_slice: the write lands in the stacked cache itself
    if on_device:
        at = pos.view(1).long()
        cache["k"].index_copy_(1, at, k_new)
        cache["v"].index_copy_(1, at, v_new)
    elif 0 <= pos - start < cache["k"].shape[1]:
        cache["k"][:, pos - start] = k_new[:, 0]
        cache["v"][:, pos - start] = v_new[:, 0]
    out = _decode_over_block(q[:, 0], cache, pos, kv)
    return _heads_out(out, p, heads), cache


# --------------------------------------------------------------------------
# Cross-attention (VLM image layers): queries from the text, keys and values
# from the projected image states; no RoPE, no mask
# --------------------------------------------------------------------------
def cross_attn_prefill(x: torch.Tensor, p: Params, cfg: ArchConfig,
                       img_h: torch.Tensor) -> Tuple[torch.Tensor, Params]:
    """x: (B,S,D) text; img_h: (B,Timg,D).  Returns the output and the
    static image KV cache (B,Timg,Hkv,Dh) (the reference's
    ``cross_attn_forward`` and ``cross_attn_kv``)."""
    return _prefill_attend(x, img_h, p, cfg)


def cross_attn_decode(x: torch.Tensor, p: Params, cfg: ArchConfig,
                      cache: Params) -> Tuple[torch.Tensor, Params]:
    """One-token decode over every image position of the static cache
    (in the serving context this process's block of them), which it
    returns unchanged."""
    heads = model_split(cfg.n_heads)
    q = _gather_heads(_project_q(x, p, cfg), heads)
    img = model_split(cfg.img_tokens)
    pos = (1 if img is None else img.n) * cache["k"].shape[1] - 1
    out = _decode_over_block(q[:, 0], cache, pos, img)
    return _heads_out(out, p, heads), cache


# --------------------------------------------------------------------------
# Training: the reference's attention math as differentiable torch
# --------------------------------------------------------------------------
def _dense_attend(q, k, v, dh: int, mask: Optional[torch.Tensor]):
    """q: (B,S,H,Dh); k,v: (B,T,H,Dh); mask broadcastable to (B,H,S,T)."""
    scores = torch.einsum("bshk,bthk->bhst", q, k).float() * dh ** -0.5
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhst,bthk->bshk", probs, v)


def _chunked_attend(q, k, v, dh: int, causal: bool, kv_chunk: int,
                    row0: int = 0):
    """Online-softmax streaming over KV chunks of ``kv_chunk`` keys, in
    f32, every chunk computed in full (causal masking, no skipping), as
    the reference's ``lax.scan`` does.  Query row i is global row
    ``row0 + i``."""
    b, s, h, _ = q.shape
    t = k.shape[1]
    qf = q.float() * dh ** -0.5
    rows = torch.arange(row0, row0 + s, device=q.device)[:, None]
    f32 = dict(dtype=torch.float32, device=q.device)
    m = torch.full((b, h, s), NEG_INF, **f32)
    l = torch.zeros((b, h, s), **f32)
    acc = torch.zeros((b, h, s, dh), **f32)
    for ci in range(t // kv_chunk):
        k_i = k[:, ci * kv_chunk:(ci + 1) * kv_chunk].float()
        v_i = v[:, ci * kv_chunk:(ci + 1) * kv_chunk].float()
        s_ij = torch.einsum("bshk,bthk->bhst", qf, k_i)
        if causal:
            cols = ci * kv_chunk + torch.arange(kv_chunk,
                                                device=q.device)[None, :]
            s_ij = torch.where((cols <= rows)[None, None], s_ij, NEG_INF)
        # amax, like jnp.max, splits the gradient evenly between ties
        m_new = torch.maximum(m, torch.amax(s_ij, dim=-1))
        p = torch.exp(s_ij - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = alpha * l + torch.sum(p, dim=-1)
        acc = alpha[..., None] * acc + torch.einsum("bhst,bthk->bhsk", p, v_i)
        m = m_new
    out = (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
    return out.transpose(1, 2)                                 # (B,S,H,Dh)


def _gqa_attend(q, k, v, mask: Optional[torch.Tensor],
                causal_for_chunks: Optional[bool] = None, row0: int = 0):
    """q: (B,S,Hq,Dh); k,v: (B,T,Hkv,Dh).  KV heads are broadcast up to the
    query heads (head h reads KV head h // g, ``jnp.repeat``).  With
    ``causal_for_chunks`` not None, T > ``CHUNK_THRESHOLD`` and T a
    multiple of ``KV_CHUNK``, the chunked online softmax runs, query row
    i being global row ``row0 + i``."""
    b, s, hq, dh = q.shape
    hkv, t = k.shape[2], k.shape[1]
    g = hq // hkv
    if g > 1:
        k = k[:, :, :, None].expand(b, t, hkv, g, dh).reshape(b, t, hq, dh)
        v = v[:, :, :, None].expand(b, t, hkv, g, dh).reshape(b, t, hq, dh)
    if (causal_for_chunks is not None and t > CHUNK_THRESHOLD
            and t % KV_CHUNK == 0):
        return _chunked_attend(q, k, v, dh, causal_for_chunks, KV_CHUNK,
                               row0)
    return _dense_attend(q, k, v, dh, mask)


def _causal_mask(s: int, t: int, device, offset: int = 0) -> torch.Tensor:
    """(1,1,S,T) mask; query i may see key j iff j <= i + offset."""
    qi = torch.arange(s, device=device)[:, None]
    kj = torch.arange(t, device=device)[None, :]
    return (kj <= qi + offset)[None, None]


def _kv_heads(p: Params, cfg: ArchConfig, heads: Optional[Split]):
    """(p, idx): where the query heads split over 'model' but the KV heads
    do not divide it (``wk``/``wv`` replicated), ``p`` with ``wk``, ``wv``
    and their biases cut to the KV heads this process's query heads read
    (contiguous, since its query heads are), and ``idx``, the KV head of
    each local query head among them: query head h reads KV head h // g.
    Else ``p`` itself and None."""
    if heads is None or cfg.n_kv_heads % heads.n == 0:
        return p, None
    hq, g = cfg.n_heads // heads.n, cfg.n_heads // cfg.n_kv_heads
    q0 = heads.index * hq
    lo, hi = _kv_cut(cfg, heads.n, heads.index)
    cut = {k: (p[k][:, lo:hi] if k in ("wk", "wv") else p[k][lo:hi])
           for k in ("wk", "wv", "bk", "bv") if k in p}
    idx = (q0 + torch.arange(hq, device=p["wk"].device)) // g - lo
    return {**p, **cut}, idx


def _train_attend(x: torch.Tensor, kv_src: Optional[torch.Tensor], p: Params,
                  cfg: ArchConfig) -> torch.Tensor:
    """Training attention of x (B,S,D) over ``kv_src`` (cross-attention: no
    RoPE, no mask) or over x itself (``kv_src`` None: RoPE, causal when
    the config is), head-parallel or sequence-parallel over 'model' where
    the rules split it (see the module's docstring)."""
    s = x.shape[1]
    causal = kv_src is None and cfg.causal
    # reference attention.py:144-152: hint(q, "batch", "qseq", "heads",
    # None); k and v "kv_seq" (None in training), "heads"
    heads = tp_split("heads", cfg.n_heads)
    rows = None if heads else tp_split("qseq", s)
    row0, s_q = rows.block(s) if rows else (0, s)
    xq = x if rows is None else x.narrow(1, row0, s_q)
    q = _project_q(xq, p, cfg)
    p_kv, kv_idx = _kv_heads(p, cfg, heads)
    k, v = _project_kv(x if kv_src is None else kv_src, p_kv, cfg)
    if kv_src is None:
        positions = torch.arange(s, device=x.device)[None, :]
        q = apply_rope(q, positions[:, row0:row0 + s_q], cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    if kv_idx is not None:
        k, v = k.index_select(2, kv_idx), v.index_select(2, kv_idx)
    mask = _causal_mask(s_q, s, x.device, row0) if causal else None
    out = _gqa_attend(q, k, v, mask, causal_for_chunks=causal, row0=row0)
    # reference attention.py:172, :224: hint(out @ wo, "batch", "qseq",
    # None), so the rows come back whole and the heads' sums are added
    y = reduce_over(_out_proj(out, p["wo"]), heads)
    return y if rows is None else col.all_gather(y, 1, rows.mesh, rows.axes)


def attn_forward(x: torch.Tensor, p: Params, cfg: ArchConfig) -> torch.Tensor:
    """Full-sequence self-attention for training (and encoders): dense, or
    the chunked online softmax beyond ``CHUNK_THRESHOLD`` keys."""
    return _train_attend(x, None, p, cfg)


def cross_attn_forward(x: torch.Tensor, p: Params, cfg: ArchConfig,
                       img_h: torch.Tensor) -> torch.Tensor:
    """x: (B,S,D) text; img_h: (B,Timg,D) projected image states.  No RoPE,
    no mask; dense for every config's image tokens (at most 2048), and
    chunked beyond, as the reference."""
    return _train_attend(x, img_h, p, cfg)
