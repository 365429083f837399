"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version.  A wrapper runs the plain version for CPU tensors only; for CUDA
tensors it launches its kernel or raises."""
from __future__ import annotations

from typing import Sequence

import torch

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def tma_compatible(strides: Sequence[int], element_size: int,
                   data_ptr: int) -> bool:
    """Whether the tensor memory accelerator (TMA) can read a tensor with
    these element strides and this base address: unit innermost stride,
    every other stride positive and a multiple of 16 bytes, base aligned to
    16 bytes."""
    return (strides[-1] == 1 and data_ptr % 16 == 0
            and all(s > 0 and s * element_size % 16 == 0
                    for s in strides[:-1]))


def tma_operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself where TMA can read it (:func:`tma_compatible`), else a
    copy of it that TMA can read: a fresh tensor whose rows are padded to a
    multiple of 16 bytes, viewed back to ``t``'s shape."""
    if tma_compatible(t.stride(), t.element_size(), t.data_ptr()):
        return t
    last = t.shape[-1]
    pad = -last % (16 // t.element_size())
    buf = torch.empty((*t.shape[:-1], last + pad), dtype=t.dtype,
                      device=t.device)
    return buf[..., :last].copy_(t)


def check_attention_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           q_ndim: int, head_dims: Sequence[int]) -> None:
    """Raise on inputs the kernels do not take: mixed devices or dtypes, a
    dtype other than f32/bf16, a head dim outside ``head_dims`` (the widths
    the wrapper's kernels are built for), or query heads that are not a
    multiple of the KV heads."""
    if q.dim() != q_ndim or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"bad shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must lie on one device")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in DTYPE_CODES:
        raise ValueError(f"dtypes must be one of f32/bf16 and equal, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    d = q.shape[-1]
    if d not in head_dims or k.shape[-1] != d:
        raise ValueError(f"head dim must be one of {tuple(head_dims)}, got "
                         f"q {d}, k {k.shape[-1]}")
    if q.shape[0] != k.shape[0]:
        raise ValueError("q and k must have the same batch size")
    if q.shape[1] % k.shape[1]:
        raise ValueError(f"query heads {q.shape[1]} are not a multiple of "
                         f"KV heads {k.shape[1]}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")


def refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """Raise ``RuntimeError`` when grad mode is on and one of ``tensors``
    requires grad: the kernels have no backward, and an output written
    through raw pointers would carry no ``grad_fn``, so the gradients of
    everything upstream would be dropped without an error.  Training
    reaches attention through ``models.attention.attn_forward``."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} has no backward; it takes no input that "
                           "requires grad while grad mode is on")
