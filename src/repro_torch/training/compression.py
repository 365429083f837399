"""Gradient compression with error feedback (port of
``repro/training/compression.py``).

int8 block-quantized gradients cut data-parallel all-reduce bytes 4x vs
f32; the quantization residual is carried in an error-feedback buffer so
the *accumulated* gradient signal is unbiased.  On one card there is no
all-reduce: ``compress_with_feedback`` runs on the gradient before the
update, as the reference's runs before its implicit mean-reduce.
Quantization is bit for bit the reference's: blocks of 256, the scale
``max |x| / 127 + 1e-12``, and ``torch.round``, which rounds half to even
as ``jnp.round`` does.  DTensor leaves (the sharded step's) quantize
their whole value, whose blocks of 256 are the reference's global array's,
and go back to their placements.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.models.transformer import tree_leaves, tree_map, tree_unflatten

BLOCK = 256


def _pad_len(n: int) -> int:
    return (-n) % BLOCK


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-block symmetric int8 quantization.  Returns (q, scales)."""
    flat = x.float().reshape(-1)
    pad = _pad_len(flat.numel())
    if pad:
        flat = F.pad(flat, (0, pad))
    blocks = flat.reshape(-1, BLOCK)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    flat = (q.float() * scale).reshape(-1)
    n = 1
    for s in shape:
        n *= s
    return flat[:n].reshape(shape)


def init_error_feedback(params) -> Any:
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)


@torch.no_grad()
def compress_with_feedback(grads, errors):
    """Quantize (grad + carried error); new error = input - dequantized."""
    def one(g, e):
        if isinstance(g, DTensor):
            dg, de = one(g.full_tensor(), e.full_tensor())
            return (distribute_tensor(dg, g.device_mesh, g.placements),
                    distribute_tensor(de, e.device_mesh, e.placements))
        x = g.float() + e
        q, s = quantize_int8(x)
        deq = dequantize_int8(q, s, g.shape)
        return deq.to(g.dtype), x - deq

    out = [one(g, e) for g, e in zip(tree_leaves(grads),
                                     tree_leaves(errors))]
    return (tree_unflatten(grads, [o[0] for o in out]),
            tree_unflatten(grads, [o[1] for o in out]))
