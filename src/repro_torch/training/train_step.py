"""Train step: loss + grad + AdamW update, with gradient accumulation,
remat policy, and optional int8 gradient compression (error feedback);
port of ``repro/training/train_step.py``.

``make_train_step`` returns ``(params, opt_state, batch) -> (params,
opt_state, metrics)``, the reference's signature; the inputs are left as
they are.  A step is two parts, each a function of its own so a caller can
time them apart: ``make_grad_fn``'s (loss and gradients, accumulated over
microbatches) and ``update`` (compression, then AdamW).

Gradients come from ``torch.autograd.grad`` over the parameter leaves,
taken through detached aliases that require grad, so the caller's tensors
never do.  A leaf that gets no gradient raises: it means the graph was cut
(an op without a backward, a tensor made under ``inference_mode``), where
JAX would have returned zeros only for a leaf the loss truly ignores.

Gradient accumulation splits the global batch into ``grad_accum``
contiguous groups of rows, as the reference's reshape does, adds each
microbatch's gradients into an ``accum_dtype`` buffer in order and divides
by ``grad_accum``.  Each microbatch's backward is remat'd per period, so
live activation memory is one microbatch deep regardless of global batch.

Under a mesh the parameters and moments are DTensors (the launcher places
them per ``distributed.sharding``) and the step computes on their local
shards (``_sharded_grad``): the same loss and gradients, the mean over
the whole batch.  A microbatch's rows split over the fsdp axes, as the
reference's ``batch`` rule says; the 'model' processes hold the same rows
and split the dense layers as the reference's rules do (heads, d_ff, the
vocabulary, Mamba's inner channels), MoE layers over experts.  On one
process every collective still runs, and the numbers are the meshless
step's bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs import ArchConfig
from repro_torch.distributed import collectives as col
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.context import Mesh, ShardCtx, current, use_ctx
from repro_torch.distributed.gather import gatherer
from repro_torch.models import transformer
from repro_torch.models.transformer import tree_leaves, tree_map, tree_unflatten
from repro_torch.params import resolve_device
from repro_torch.training import compression
from repro_torch.training.optimizer import (OptConfig, apply_updates,
                                            init_opt_state)

ACCUM_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: OptConfig = dataclasses.field(default_factory=OptConfig)
    remat: str = "full"           # none | dots | full
    grad_accum: int = 1           # microbatches per step
    accum_dtype: str = "float32"  # grad accumulator (bfloat16 at 398B scale)
    compress_grads: bool = False  # int8 + error feedback
    aux_weight: float = 0.01


def batch_to_device(batch: Dict[str, np.ndarray], device
                    ) -> Dict[str, torch.Tensor]:
    """A ``TokenDataset`` batch (numpy, or tensors) → tensors on
    ``device``; token ids and labels become ``long`` for indexing."""
    out = {}
    for k, v in batch.items():
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(v))
        t = t.to(device)
        out[k] = t.long() if k in ("tokens", "labels") else t
    return out


def make_grad_fn(cfg: ArchConfig, tcfg: TrainConfig) -> Callable:
    """``(params, batch) -> (loss, parts, grads)``: the mean loss over the
    batch, ``train_loss``'s parts (``{}`` when it accumulates), and the
    gradient tree, accumulated over ``grad_accum`` microbatches.  DTensor
    parameters take the sharded path (``_sharded_grad``), and their
    gradients are DTensors with the parameters' placements."""
    def value_and_grad(params, batch, gather=None):
        aliases = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss, parts = transformer.train_loss(
            aliases, batch, cfg, remat=tcfg.remat, aux_weight=tcfg.aux_weight,
            gather=gather)
        grads = torch.autograd.grad(loss, tree_leaves(aliases),
                                    allow_unused=True)
        if any(g is None for g in grads):
            raise RuntimeError(f"{cfg.name}: {sum(g is None for g in grads)} "
                               "parameter leaves got no gradient")
        return (loss.detach(), {k: v.detach() for k, v in parts.items()},
                tree_unflatten(params, list(grads)))

    def accumulate(params, batch, gather=None):
        ga = tcfg.grad_accum
        if ga == 1:
            return value_and_grad(params, batch, gather)
        adt = ACCUM_DTYPES[tcfg.accum_dtype]
        for x in batch.values():
            if x.shape[0] % ga:
                raise ValueError(f"global batch {x.shape[0]} is not a "
                                 f"multiple of grad_accum {ga}")
        mb = next(iter(batch.values())).shape[0] // ga
        acc = [torch.zeros(p.shape, dtype=adt, device=p.device)
               for p in tree_leaves(params)]
        loss = torch.zeros((), dtype=torch.float32,
                           device=tree_leaves(params)[0].device)
        for i in range(ga):
            micro = {k: x[i * mb:(i + 1) * mb] for k, x in batch.items()}
            l, _, g = value_and_grad(params, micro, gather)
            for a, gi in zip(acc, tree_leaves(g)):
                a.add_(gi.to(adt))
            del g
            loss = loss + l
        for a in acc:
            a.div_(ga)
        return loss / ga, {}, tree_unflatten(params, acc)

    def grad_fn(params, batch):
        leaves = tree_leaves(params)
        if isinstance(leaves[0], DTensor):
            return _sharded_grad(params, batch, cfg, tcfg, accumulate)
        return accumulate(params, batch_to_device(batch, leaves[0].device))

    return grad_fn


def _row_axes(mesh, rows: int) -> Tuple[str, ...]:
    """The mesh axes a microbatch's ``rows`` are split over: the fsdp axes
    where they divide the rows (``batch_specs``' rule), else none; the
    processes of the other axes ('model') hold the same rows."""
    fsdp = shd.axes_in(mesh, shd.FSDP_AXES)
    return fsdp if fsdp and rows % shd.axis_size(mesh, fsdp) == 0 else ()


def _sharded_grad(params, batch, cfg: ArchConfig, tcfg: TrainConfig,
                  accumulate: Callable):
    """The step's gradient on DTensor parameters, computed on local shards
    (ZeRO-3 over the fsdp axes, tensor parallel over 'model'): each
    period's leaves gathered over the fsdp axes just in time by a
    differentiable all-gather (inside the period's remat region, so one
    period at a time, again under recompute), the leaves the rules split
    over 'model' left as their 'model' shards for the model's
    column- and row-parallel products (``context.tp_split``), the others
    made whole; each microbatch's rows split over the fsdp axes
    (``_row_axes``) and the same on the 'model' processes; MoE layers
    through ``moe_sharded``.

    Gradients: each process differentiates its own loss (the 'model'
    processes of a row block hold equal losses), and every collective's
    backward is its adjoint, so each local leaf gets the gradient of the
    sum of all the processes' losses: the gathers' reduce-scatters (and
    the MoE's all_to_all) sum over the processes that shard it, an
    all-reduce over the mesh dims that replicate it adds the copies'
    pieces (a replicated leaf's gradient is partial on each 'model'
    process), then a division by the process count makes it the mean over
    the whole batch, as the single-process step's.  No identity-forward,
    all-reduce-backward operator is needed before a column-parallel
    product: the partial gradients of a replicated activation stay on
    their processes and meet where its leaves' copies are added.  Runs
    under the current sharding context, or one on the parameters' mesh."""
    ctx = current()
    dm = tree_leaves(params)[0].device_mesh
    mesh = ctx.mesh if ctx is not None else Mesh(dm)
    rules = ctx.rules if ctx is not None else {}
    place = tree_map(lambda p: tuple(p.placements), params)
    local = tree_map(lambda p: p.to_local(), params)
    batch = batch_to_device(batch, tree_leaves(local)[0].device)

    ga = tcfg.grad_accum
    rows = next(iter(batch.values())).shape[0] // ga
    row_axes = _row_axes(mesh, rows)
    per = rows // shd.axis_size(mesh, row_axes)
    r = col.axis_index(dm, row_axes)
    # this process's rows of each microbatch; microbatches stay contiguous
    mine = {k: x.reshape(ga, rows, *x.shape[1:])[:, r * per:(r + 1) * per]
            .reshape(ga * per, *x.shape[1:]) for k, x in batch.items()}
    step_ctx = ShardCtx(mesh, rules, row_axes, tp=True)
    with use_ctx(step_ctx):
        loss, parts, grads = accumulate(local, mine,
                                        gatherer(cfg, place, step_ctx))

    n = mesh.devices.size
    out = []
    for g, pl in zip(tree_leaves(grads), tree_leaves(place)):
        g = col.sum_replicated(g.contiguous(), pl, dm).div_(n)
        out.append(DTensor.from_local(g, dm, pl, run_check=False))
    mean = lambda t: col.all_reduce(t, dm, range(dm.ndim)) / n
    return (mean(loss), {k: mean(v) for k, v in parts.items()},
            tree_unflatten(params, out))


def update(params, grads, opt_state, tcfg: TrainConfig):
    """Compression (when on), then the AdamW update: (new params, new opt
    state, {"grad_norm", "lr"})."""
    if tcfg.compress_grads:
        grads, new_err = compression.compress_with_feedback(
            grads, opt_state["err"])
    new_params, new_opt, opt_metrics = apply_updates(
        params, grads, opt_state, tcfg.opt)
    if tcfg.compress_grads:
        new_opt["err"] = new_err
    return new_params, new_opt, opt_metrics


def make_train_step(cfg: ArchConfig, tcfg: TrainConfig) -> Callable:
    grad_fn = make_grad_fn(cfg, tcfg)

    def train_step(params, opt_state, batch):
        loss, parts, grads = grad_fn(params, batch)
        new_params, new_opt, opt_metrics = update(params, grads, opt_state,
                                                  tcfg)
        metrics = {"loss": loss, **opt_metrics}
        for k, v in parts.items():
            metrics[k] = v
        return new_params, new_opt, metrics

    return train_step


def init_train_state(cfg: ArchConfig, tcfg: TrainConfig, *,
                     generator: torch.Generator,
                     dtype: torch.dtype = torch.float32, device="cuda",
                     place=None):
    """Random parameters from ``generator`` (on ``device``), each leaf
    through ``place`` as it is drawn where given (``init_params``), zero
    moments and, when compression is on, error-feedback buffers, each
    made like its parameter (a DTensor's zeros are its shard's)."""
    dev = resolve_device(device)
    params = transformer.init_params(cfg, generator=generator, dtype=dtype,
                                     device=dev, place=place)
    opt_state = init_opt_state(params, tcfg.opt)
    if tcfg.compress_grads:
        opt_state["err"] = compression.init_error_feedback(params)
    return params, opt_state
