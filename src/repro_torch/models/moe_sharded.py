"""Expert-parallel MoE on local tensors with explicit collectives (port of
``repro/models/moe_sharded.py``, whose ``shard_map`` bodies these are).

Two paths, chosen by ``moe.apply_moe`` under a sharding context:

* ``moe_ffn_sharded`` (GShard/DeepSpeed-MoE dispatch): tokens sharded over
  *every* mesh axis; routing and capacity-bounded dispatch into
  per-(source-shard, expert) queues are local; one ``all_to_all`` over
  'model' moves the queues to their expert owners; the expert FFNs run as
  local batched products on weights all-gathered over the fsdp axes just
  in time; the reverse ``all_to_all`` and a local gather combine.
* ``moe_ffn_psum`` (decode-size token counts): every token on every
  process, each process's d_model slice over fsdp; the first expert
  product contracts the local slice and sums the hidden activations over
  fsdp, the per-expert partial outputs combine with one token-sized sum
  over 'model'.

The expert weights and the router are DTensors with ``param_specs``'
placements (experts over 'model', d_model over fsdp).  ``x2d`` holds this
process's rows: split over ``ctx.row_axes`` and the same on the processes
of the other axes (the whole batch when ``row_axes`` is empty, as the
reference's global array).  The output has ``x2d``'s rows.  Every
collective is differentiable (``distributed/collectives.py``), so the
same paths train: each process's gradients are those of the sum of all
the processes' losses.

Kept from the reference: the per-shard capacity (``max(4, ...)`` rounded
to 4, not ``moe.capacity``), the aux per shard then averaged over every
process; kept from the port's local path: the stable descending sort for
top-k (ties order as ``jax.lax.top_k``) and the accumulating ``index_put_``
(a dropped copy adds zero at ``cap - 1``).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.configs import ArchConfig
from repro_torch.distributed import collectives as col
from repro_torch.distributed.context import P, ShardCtx, placements
from repro_torch.distributed.sharding import axis_size

TP = "model"


def _fsdp_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def sharded_applicable(cfg: ArchConfig, ctx: ShardCtx, n_tokens: int) -> bool:
    if ctx is None:
        return False
    mesh = ctx.mesh
    if TP not in mesh.axis_names:
        return False
    n_dev = mesh.devices.size
    n_tp = dict(zip(mesh.axis_names, mesh.devices.shape))[TP]
    return (cfg.n_experts % n_tp == 0 and n_tokens % n_dev == 0
            and n_tokens // n_dev >= cfg.n_experts // n_tp)


def psum_applicable(cfg: ArchConfig, ctx: ShardCtx, n_tokens: int) -> bool:
    """Small-token EP path (decode steps): experts shard over 'model',
    tokens replicate."""
    if ctx is None:
        return False
    mesh = ctx.mesh
    if TP not in mesh.axis_names:
        return False
    n_tp = dict(zip(mesh.axis_names, mesh.devices.shape))[TP]
    return cfg.n_experts % n_tp == 0


def _local(w: DTensor, spec: P, ctx: ShardCtx) -> torch.Tensor:
    """``w``'s local shard, which must be laid out as ``spec`` says (the
    reference's ``shard_map`` in_spec for it)."""
    want = placements(spec, ctx.mesh)
    if not isinstance(w, DTensor) or list(w.placements) != want:
        raise ValueError(f"expected a DTensor placed {want}, got "
                         f"{getattr(w, 'placements', type(w).__name__)}")
    return w.to_local()


def _route(logits, cfg):
    """Top-k routing of f32 ``logits`` as ``moe.route``: (gw, idx, probs)."""
    probs = torch.softmax(logits, dim=-1)
    gw, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gw, idx = gw[:, :cfg.top_k], idx[:, :cfg.top_k]
    return gw / gw.sum(dim=-1, keepdim=True), idx, probs


def _aux(probs, idx, e):
    """Switch's load-balance loss of these tokens."""
    me = probs.mean(dim=0)
    ce = F.one_hot(idx[:, 0], e).float().mean(dim=0)
    return e * torch.sum(me * ce)


def _ffn(toks, w_in, w_gate, w_out, cfg, psum=None):
    """The experts' batched FFN; ``psum`` sums the hidden activations of
    partial contractions."""
    h = torch.bmm(toks, w_in)
    if cfg.mlp_act == "silu":
        g = torch.bmm(toks, w_gate)
        if psum is not None:
            h, g = psum(h), psum(g)
        h = F.silu(g) * h
    else:
        if psum is not None:
            h = psum(h)
        h = F.gelu(h, approximate="tanh")   # jax.nn.gelu's default
    return torch.bmm(h, w_out)


def moe_ffn_psum(x2d: torch.Tensor, p: dict, cfg: ArchConfig,
                 ctx: ShardCtx) -> Tuple[torch.Tensor, torch.Tensor]:
    """EP-without-a2a for small token counts (one decode step).

    Tokens replicate over fsdp but their *d_model slices* stay
    fsdp-sharded, so expert weights are never gathered: the first expert
    product contracts the local d-slice and sums the (tiny) hidden
    activations over fsdp; the second produces local d-slices directly;
    the per-expert partial outputs combine with one token-sized sum over
    the EP axis."""
    mesh, dm = ctx.mesh, ctx.mesh.device_mesh
    n_tp = axis_size(mesh, TP)
    fsdp = _fsdp_axes(mesh)
    d = x2d.shape[1]
    e, k = cfg.n_experts, cfg.top_k
    e_l = e // n_tp
    if d % max(axis_size(mesh, fsdp), 1) != 0:
        fsdp = ()
    fs = fsdp if fsdp else None

    # every token, this process's d slice
    x_all = col.all_gather(x2d, 0, dm, ctx.row_axes)
    x_l = col.shard_of(x_all, 1, dm, fsdp)
    t_l = x_l.shape[0]
    router_l = _local(p["router"], P(fs, None), ctx)
    w_in_l = _local(p["w_in"], P(TP, fs, None), ctx)
    w_gate_l = (_local(p["w_gate"], P(TP, fs, None), ctx)
                if "w_gate" in p else None)
    w_out_l = _local(p["w_out"], P(TP, None, fs), ctx)

    logits = x_l.float() @ router_l
    if fsdp:
        logits = col.all_reduce(logits, dm, fsdp)            # (T, E) tiny
    gw, idx, probs = _route(logits, cfg)
    aux = col.all_reduce(_aux(probs, idx, e), dm, mesh.axis_names) \
        / mesh.devices.size

    rank = col.axis_index(dm, (TP,))
    local_idx = idx - rank * e_l                              # (T, k)
    valid = ((local_idx >= 0) & (local_idx < e_l)).reshape(t_l * k)
    flat_e = torch.where(valid, local_idx.reshape(t_l * k), 0)
    pos = torch.arange(t_l * k, device=x2d.device)
    x_rep = x_l[:, None].expand(t_l, k, x_l.shape[1]).reshape(t_l * k, -1)
    upd = torch.where(valid[:, None], x_rep, 0)
    buf = x_l.new_zeros((e_l, t_l * k, x_l.shape[1])).index_put_(
        (flat_e, pos), upd, accumulate=True)

    psum = (lambda t: col.all_reduce(t, dm, fsdp)) if fsdp else None
    out_e = _ffn(buf, w_in_l, w_gate_l, w_out_l, cfg, psum)   # (e_l, s, d_l)
    w = (gw.reshape(t_l * k, 1) * valid[:, None]).to(out_e.dtype)
    y = (out_e[flat_e, pos] * w).reshape(t_l, k, -1).sum(dim=1)
    y = col.all_reduce(y, dm, (TP,))                          # (T, d_l)
    y = col.all_gather(y, 1, dm, fsdp)
    return col.shard_of(y, 0, dm, ctx.row_axes), aux


def moe_ffn_sharded(x2d: torch.Tensor, p: dict, cfg: ArchConfig,
                    ctx: ShardCtx) -> Tuple[torch.Tensor, torch.Tensor]:
    """x2d: this process's rows (T_rows, D) → (out (T_rows, D), aux)."""
    mesh, dm = ctx.mesh, ctx.mesh.device_mesh
    n_tp = axis_size(mesh, TP)
    fsdp = _fsdp_axes(mesh)
    all_axes = tuple(mesh.axis_names)
    rep = tuple(a for a in all_axes if a not in ctx.row_axes)
    d = x2d.shape[1]
    e, k = cfg.n_experts, cfg.top_k
    e_l = e // n_tp
    # this process's tokens: its rows, split over the axes they replicate on
    x_l = col.shard_of(x2d, 0, dm, rep)
    t_l = x_l.shape[0]
    # per-(source shard, expert) queue capacity
    cap = max(4, -(-math.ceil(t_l * k * cfg.capacity_factor / e) // 4) * 4)
    fs = fsdp if fsdp else None
    router = col.all_gather(_local(p["router"], P(fs, None), ctx), 0, dm,
                            fsdp)
    w_in_l = _local(p["w_in"], P(TP, fs, None), ctx)
    w_gate_l = (_local(p["w_gate"], P(TP, fs, None), ctx)
                if "w_gate" in p else None)
    w_out_l = _local(p["w_out"], P(TP, None, fs), ctx)

    # ---- routing (local) ----
    gw, idx, probs = _route(x_l.float() @ router, cfg)
    aux = _aux(probs, idx, e)

    # ---- local capacity-bounded dispatch ----
    flat_e = idx.reshape(t_l * k)
    onehot = flat_e[None, :] == torch.arange(e, device=x2d.device)[:, None]
    pos = (torch.cumsum(onehot, dim=1) - 1).gather(0, flat_e[None, :])[0]
    keep = pos < cap
    pos_c = torch.where(keep, pos, cap - 1)
    x_rep = x_l[:, None].expand(t_l, k, d).reshape(t_l * k, d)
    upd = torch.where(keep[:, None], x_rep, 0)
    buf = x_l.new_zeros((e, cap, d)).index_put_((flat_e, pos_c), upd,
                                                accumulate=True)

    # ---- a2a to expert owners over the EP axis ----
    recv = col.all_to_all(buf, dm, TP)         # (n_src * e_l, cap, d)
    toks = recv.reshape(n_tp, e_l, cap, d).transpose(0, 1).reshape(
        e_l, n_tp * cap, d)

    # ---- expert FFN (gather FSDP-sharded weights just in time) ----
    out = _ffn(toks, col.all_gather(w_in_l, 1, dm, fsdp),
               None if w_gate_l is None
               else col.all_gather(w_gate_l, 1, dm, fsdp),
               col.all_gather(w_out_l, 2, dm, fsdp), cfg)

    # ---- reverse a2a + local combine ----
    out = out.reshape(e_l, n_tp, cap, d).transpose(0, 1).reshape(e, cap, d)
    back = col.all_to_all(out, dm, TP)         # (e, cap, d)
    w = (gw.reshape(t_l * k, 1) * keep[:, None]).to(back.dtype)
    y = (back[flat_e, pos_c] * w).reshape(t_l, k, d).sum(dim=1)
    aux = col.all_reduce(aux, dm, all_axes) / mesh.devices.size
    return col.all_gather(y, 0, dm, rep), aux
