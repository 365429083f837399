"""Mixture-of-Experts FFN (port of ``repro/models/moe.py``, its local
path).

Capacity-bounded scatter dispatch, then a batched per-expert product, then
a gather combine, with every shape static in the number of tokens: no
boolean selection and no host sync, so a step stays capturable.  Routing
is a top-k softmax, renormalised, in f32 whatever the model dtype; the
auxiliary load-balancing loss is Switch's.

Under a sharding context whose expert weights are DTensors, ``apply_moe``
dispatches to the expert-parallel paths of ``moe_sharded.py`` as the
reference does; plain tensors are whole values and take the local path.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from torch.distributed.tensor import DTensor

from repro_torch.configs import ArchConfig
from repro_torch.distributed import collectives as col
from repro_torch.distributed.context import current
from repro_torch.distributed.sharding import axis_size
from repro_torch.models.layers import normal_leaf

Params = dict


def init_moe(cfg: ArchConfig, gen: torch.Generator, n: Optional[int], dtype,
             device) -> Params:
    """Router (always f32), then per-expert ``w_in``/``w_out`` (and
    ``w_gate`` for SwiGLU) in ``dtype``, stacked over ``n`` periods."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    std_in, std_out = d ** -0.5, f ** -0.5
    p = {"router": normal_leaf(gen, n, (d, e), std_in, torch.float32, device),
         "w_in": normal_leaf(gen, n, (e, d, f), std_in, dtype, device),
         "w_out": normal_leaf(gen, n, (e, f, d), std_out, dtype, device)}
    if cfg.mlp_act == "silu":
        p["w_gate"] = normal_leaf(gen, n, (e, d, f), std_in, dtype, device)
    return p


def capacity(n_tokens: int, cfg: ArchConfig) -> int:
    """Static per-expert capacity (python int)."""
    c = math.ceil(n_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(8, -(-c // 8) * 8)  # round up to a multiple of 8


def route(x2d: torch.Tensor, p: Params, cfg: ArchConfig
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x2d: (T, D) → (gate_weights (T,k) f32, expert_idx (T,k), aux_loss)."""
    probs = torch.softmax(x2d.float() @ p["router"], dim=-1)
    # a stable descending sort puts tied experts in index order, as
    # jax.lax.top_k does (torch.topk may not); the capacity cumsum in
    # moe_ffn depends on that order
    gw, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gw, idx = gw[:, :cfg.top_k], idx[:, :cfg.top_k]
    gw = gw / gw.sum(dim=-1, keepdim=True)
    # Switch-style load-balance loss: E * sum_e f_e * p_e
    e = cfg.n_experts
    me = probs.mean(dim=0)                                       # (E,)
    ce = F.one_hot(idx[:, 0], e).float().mean(dim=0)
    aux = e * torch.sum(me * ce)
    return gw, idx, aux


def moe_ffn(x2d: torch.Tensor, p: Params, cfg: ArchConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x2d: (T, D) → (out (T, D), aux_loss scalar)."""
    t, d = x2d.shape
    k, e = cfg.top_k, cfg.n_experts
    cap = capacity(t, cfg)

    gw, idx, aux = route(x2d, p, cfg)

    flat_e = idx.reshape(t * k)                                  # (T*k,)
    # Position of each routed copy within its expert queue, in token-major
    # order: cumulative count over the one-hot, laid out (E, T*k) so that
    # the scan runs along contiguous memory (along T*k rows, a CUDA scan
    # is serial in T*k).
    onehot = flat_e[None, :] == torch.arange(e, device=x2d.device)[:, None]
    pos_all = torch.cumsum(onehot, dim=1) - 1                    # (E, T*k)
    pos = pos_all.gather(0, flat_e[None, :])[0]
    keep = pos < cap                                             # drop overflow
    pos_c = torch.where(keep, pos, cap - 1)

    # Dispatch: scatter token copies into (E, C, D) expert queues.  A
    # dropped copy adds zero at slot cap - 1, which a kept copy may hold:
    # the scatter must accumulate (deterministically on CUDA), not assign.
    x_rep = x2d[:, None].expand(t, k, d).reshape(t * k, d)       # (T*k, D)
    upd = torch.where(keep[:, None], x_rep, 0)
    buf = x2d.new_zeros((e, cap, d)).index_put_((flat_e, pos_c), upd,
                                                 accumulate=True)

    # Expert FFN, batched over the expert axis.
    h = torch.bmm(buf, p["w_in"])
    if cfg.mlp_act == "silu":
        h = F.silu(torch.bmm(buf, p["w_gate"])) * h
    else:
        h = F.gelu(h, approximate="tanh")   # jax.nn.gelu's default
    out_e = torch.bmm(h, p["w_out"])                             # (E, C, D)

    # Combine: gather each copy back, weight by (renormalised) gate prob,
    # rounded to the activations' dtype; the sum over k stays in it.
    out_rep = out_e[flat_e, pos_c]                               # (T*k, D)
    w = (gw.reshape(t * k, 1) * keep[:, None]).to(out_rep.dtype)
    out_rep = out_rep * w
    return out_rep.reshape(t, k, d).sum(dim=1), aux


def apply_moe(x: torch.Tensor, p: Params, cfg: ArchConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) → (out, aux).  Uses an expert-parallel path when a
    distributed context is active, the weights are DTensors and the path
    applies to the batch's global token count (see moe_sharded.py); the
    local scatter path otherwise, on every token and the weights made
    whole."""
    from repro_torch.models import moe_sharded
    b, s, d = x.shape
    x2 = x.reshape(b * s, d)
    ctx = current()
    if ctx is None or not isinstance(p["w_in"], DTensor):
        out, aux = moe_ffn(x2, p, cfg)
        return out.reshape(b, s, d), aux
    n_tokens = b * s * axis_size(ctx.mesh, ctx.row_axes)
    if moe_sharded.sharded_applicable(cfg, ctx, n_tokens):
        out, aux = moe_sharded.moe_ffn_sharded(x2, p, cfg, ctx)
    elif moe_sharded.psum_applicable(cfg, ctx, n_tokens):
        out, aux = moe_sharded.moe_ffn_psum(x2, p, cfg, ctx)
    else:   # every token, whole weights: the reference's global arrays
        dm = ctx.mesh.device_mesh
        whole = {k: col.make_whole(w.to_local(), w.placements, dm)
                 for k, w in p.items()}
        out, aux = moe_ffn(col.all_gather(x2, 0, dm, ctx.row_axes), whole,
                           cfg)
        out = col.shard_of(out, 0, dm, ctx.row_axes)
    return out.reshape(b, s, d), aux
