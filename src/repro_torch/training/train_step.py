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
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import numpy as np
import torch

from repro_torch.configs import ArchConfig
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
    """A ``TokenDataset`` batch (numpy) → tensors on ``device``; token ids
    and labels become ``long`` for indexing."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v)).to(device)
        out[k] = t.long() if k in ("tokens", "labels") else t
    return out


def make_grad_fn(cfg: ArchConfig, tcfg: TrainConfig) -> Callable:
    """``(params, batch) -> (loss, parts, grads)``: the mean loss over the
    batch, ``train_loss``'s parts (``{}`` when it accumulates), and the
    gradient tree, accumulated over ``grad_accum`` microbatches."""
    def value_and_grad(params, batch):
        aliases = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss, parts = transformer.train_loss(
            aliases, batch, cfg, remat=tcfg.remat, aux_weight=tcfg.aux_weight)
        grads = torch.autograd.grad(loss, tree_leaves(aliases),
                                    allow_unused=True)
        if any(g is None for g in grads):
            raise RuntimeError(f"{cfg.name}: {sum(g is None for g in grads)} "
                               "parameter leaves got no gradient")
        return (loss.detach(), {k: v.detach() for k, v in parts.items()},
                tree_unflatten(params, list(grads)))

    def grad_fn(params, batch):
        device = tree_leaves(params)[0].device
        batch = batch_to_device(batch, device)
        ga = tcfg.grad_accum
        if ga == 1:
            return value_and_grad(params, batch)
        adt = ACCUM_DTYPES[tcfg.accum_dtype]
        for x in batch.values():
            if x.shape[0] % ga:
                raise ValueError(f"global batch {x.shape[0]} is not a "
                                 f"multiple of grad_accum {ga}")
        mb = next(iter(batch.values())).shape[0] // ga
        acc = [torch.zeros(p.shape, dtype=adt, device=p.device)
               for p in tree_leaves(params)]
        loss = torch.zeros((), dtype=torch.float32, device=device)
        for i in range(ga):
            micro = {k: x[i * mb:(i + 1) * mb] for k, x in batch.items()}
            l, _, g = value_and_grad(params, micro)
            for a, gi in zip(acc, tree_leaves(g)):
                a.add_(gi.to(adt))
            del g
            loss = loss + l
        for a in acc:
            a.div_(ga)
        return loss / ga, {}, tree_unflatten(params, acc)

    return grad_fn


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
                     dtype: torch.dtype = torch.float32, device="cuda"):
    """Random parameters from ``generator`` (on ``device``), zero moments,
    and the error-feedback buffers when compression is on."""
    dev = resolve_device(device)
    params = transformer.init_params(cfg, generator=generator, dtype=dtype,
                                     device=dev)
    opt_state = init_opt_state(params, tcfg.opt)
    if tcfg.compress_grads:
        opt_state["err"] = compression.init_error_feedback(params)
    return params, opt_state
