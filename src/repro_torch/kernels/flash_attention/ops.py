"""Wrapper of the flash-attention kernel (``csrc/flash_attention.cu``)."""
from __future__ import annotations

import torch

from repro_torch.kernels import DTYPE_CODES, check_attention_inputs, cuda_lib
from repro_torch.kernels.flash_attention.ref import flash_attention_plain

launches = 0   # kernel launches by this wrapper in this process


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q: (B,Hq,S,D); k,v: (B,Hkv,T,D), any strides → (B,Hq,S,D) laid out
    like ``q``.  Ragged S and T are masked inside the kernel."""
    global launches
    check_attention_inputs(q, k, v, q_ndim=4)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal)
    b, hq, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    out = torch.empty_like(q)          # keeps q's strides
    err = cuda_lib.library().prema_flash_attention(
        DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), b, hq, hkv, s, t, d,
        cuda_lib.strides_arg(q, k, v, out), d ** -0.5, int(causal),
        torch.cuda.current_stream(q.device).cuda_stream)
    cuda_lib.check(err, "flash_attention")
    launches += 1
    return out
