"""Wrapper of the flash-attention kernels (``csrc/flash_attention.cu``).

Two kernels, chosen by :func:`kernel_variant` from the dtype and the head
width alone: ``"wgmma"`` (tensor cores fed by TMA) for bf16 at D = 128,
``"cuda_core"`` for f32 and for bf16 at other head widths."""
from __future__ import annotations

import torch

from repro_torch.kernels import (DTYPE_CODES, check_attention_inputs,
                                 cuda_lib, tma_operand)
from repro_torch.kernels.flash_attention.ref import flash_attention_plain

WGMMA_HEAD_DIM = 128
launches = 0   # kernel launches by this wrapper in this process
variant_launches = {"wgmma": 0, "cuda_core": 0}   # the same, by kernel


def kernel_variant(dtype: torch.dtype, d: int) -> str:
    """The kernel that a CUDA launch at this dtype and head width runs."""
    return ("wgmma" if dtype == torch.bfloat16 and d == WGMMA_HEAD_DIM
            else "cuda_core")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q: (B,Hq,S,D); k,v: (B,Hkv,T,D), any strides → (B,Hq,S,D).  Ragged S
    and T are masked inside the kernel.  The wgmma kernel reads its inputs
    by TMA: an input whose strides TMA cannot take (innermost stride not 1,
    other strides not multiples of 8 elements, base not 16-byte aligned) is
    copied first (:func:`repro_torch.kernels.tma_operand`)."""
    global launches
    check_attention_inputs(q, k, v, q_ndim=4)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal)
    b, hq, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    lib, stream = cuda_lib.library(), torch.cuda.current_stream(
        q.device).cuda_stream
    variant = kernel_variant(q.dtype, d)
    if variant == "wgmma":
        q, k, v = tma_operand(q), tma_operand(k), tma_operand(v)
    out = torch.empty_like(q)          # keeps q's strides
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    strides = cuda_lib.strides_arg(q, k, v, out)
    if variant == "wgmma":
        err = lib.prema_flash_attention_wgmma(
            *ptrs, b, hq, hkv, s, t, strides, d ** -0.5, int(causal), stream)
    else:
        err = lib.prema_flash_attention(
            DTYPE_CODES[q.dtype], *ptrs, b, hq, hkv, s, t, d, strides,
            d ** -0.5, int(causal), stream)
    cuda_lib.check(err, f"flash_attention ({variant})")
    launches += 1
    variant_launches[variant] += 1
    return out
