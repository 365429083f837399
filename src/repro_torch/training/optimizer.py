"""Hand-rolled AdamW with cosine schedule, global-norm clipping, and
configurable moment dtype (port of ``repro/training/optimizer.py``).

The reference's formula, one leaf at a time: the gradient clipped by the
global norm, the moments updated and bias-corrected in f32, then
``p - lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)``.  Not
``torch.optim.AdamW``, which decays the weights before the step and
places eps and the bias correction differently, so its numbers are not
the reference's.  The step counter, the schedule and the bias corrections
are f32 tensors on the parameters' device, as the reference computes
them, so a step needs nothing from the host.

DTensor leaves (the sharded step's) update on their local shards, each
leaf placed as its parameter; the global norm adds each distinct shard
once, then sums over the processes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.distributed import collectives as col
from repro_torch.models.transformer import tree_leaves, tree_map, tree_unflatten

MOMENT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class OptConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"   # float32 | bfloat16


def lr_at(step: torch.Tensor, cfg: OptConfig) -> torch.Tensor:
    """Linear warmup to ``peak_lr``, then a cosine down to
    ``min_lr_frac * peak_lr`` at ``total_steps``; f32."""
    step = step.float()
    warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cfg.peak_lr * cos)


def init_opt_state(params, cfg: OptConfig) -> Dict[str, Any]:
    """Zero moments in ``moment_dtype``, each made like its parameter (a
    DTensor's zeros are local to its shard), and a 0-dim int32 step, on
    the parameters' device."""
    mdt = MOMENT_DTYPES[cfg.moment_dtype]
    zeros = lambda p: torch.zeros_like(p, dtype=mdt)
    step_device = tree_leaves(params)[0].device
    return {
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=step_device),
    }


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's sum of squares (in f32), added in
    ``jax.tree.leaves``' order.  DTensor leaves: each process adds the
    shards it is the first holder of (coordinate 0 on every mesh dim that
    replicates the leaf), then the sums add over the processes."""
    leaves = tree_leaves(tree)
    if not isinstance(leaves[0], DTensor):
        return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                              for x in leaves))
    dm = leaves[0].device_mesh
    coord = dm.get_coordinate()
    total = sum((torch.sum(torch.square(x.to_local().float()))
                 for x in leaves
                 if all(c == 0 for c, p in zip(coord, x.placements)
                        if p.is_replicate())),
                torch.zeros((), device=leaves[0].to_local().device))
    return torch.sqrt(col.all_reduce(total, dm, range(dm.ndim)))


def _local(x: torch.Tensor) -> torch.Tensor:
    return x.to_local() if isinstance(x, DTensor) else x


def _placed_as(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A new local shard ``x`` placed as the DTensor ``like`` (``x`` itself
    when ``like`` is a plain tensor)."""
    if not isinstance(like, DTensor):
        return x
    return DTensor.from_local(x, like.device_mesh, like.placements,
                              run_check=False)


@torch.no_grad()
def apply_updates(params, grads, state, cfg: OptConfig
                  ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step: (new params, new state, {"grad_norm", "lr"}).  New
    tensors throughout; the inputs are left as they are."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-12), max=1.0)
    lr = lr_at(step, cfg)
    b1c = 1 - cfg.b1 ** step.float()
    b2c = 1 - cfg.b2 ** step.float()
    mdt = MOMENT_DTYPES[cfg.moment_dtype]

    def upd(p, g, m, v):
        g = g.float() * scale
        m32 = cfg.b1 * m.float() + (1 - cfg.b1) * g
        v32 = cfg.b2 * v.float() + (1 - cfg.b2) * g * g
        mh = m32 / b1c
        vh = v32 / b2c
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p.float()
        newp = p.float() - lr * delta
        return newp.to(p.dtype), m32.to(mdt), v32.to(mdt)

    leaves = tree_leaves(params)
    out = [upd(*map(_local, (p, g, m, v))) for p, g, m, v in zip(
        leaves, tree_leaves(grads), tree_leaves(state["m"]),
        tree_leaves(state["v"]))]
    new_p, new_m, new_v = (
        tree_unflatten(params, [_placed_as(o[i], p)
                                for o, p in zip(out, leaves)])
        for i in range(3))
    new_state = {"m": new_m, "v": new_v, "step": step}
    return new_p, new_state, {"grad_norm": gnorm, "lr": lr}
