"""Wrapper of the decode-attention kernel (``csrc/decode_attention.cu``)."""
from __future__ import annotations

import torch

from repro_torch.kernels import DTYPE_CODES, check_attention_inputs, cuda_lib
from repro_torch.kernels.decode_attention.ref import decode_attention_plain

launches = 0   # kernel launches by this wrapper in this process


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos: int) -> torch.Tensor:
    """q: (B,Hq,D) one token per sequence; k,v: (B,Hkv,T,D), any strides;
    attend over cache[0..pos] (``pos`` a host int) → (B,Hq,D)."""
    global launches
    check_attention_inputs(q, k, v, q_ndim=3)
    pos = int(pos)
    b, hq, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    if not 0 <= pos < t:
        raise ValueError(f"pos {pos} outside the cache of {t} entries")
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, pos)
    lib = cuda_lib.library()
    if hq // hkv > lib.prema_decode_max_group():
        raise ValueError(f"query group {hq // hkv} exceeds the kernel's "
                         f"{lib.prema_decode_max_group()}")
    n_splits = pos // lib.prema_decode_chunk() + 1
    out = torch.empty((b, hq, d), dtype=q.dtype, device=q.device)
    o_part = torch.empty((b, hq, n_splits, d), dtype=torch.float32,
                         device=q.device)
    m_part = torch.empty((b, hq, n_splits), dtype=torch.float32,
                         device=q.device)
    l_part = torch.empty_like(m_part)
    err = lib.prema_decode_attention(
        DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), o_part.data_ptr(), m_part.data_ptr(),
        l_part.data_ptr(), b, hq, hkv, d, pos,
        cuda_lib.strides_arg(q, k, v, out), d ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    cuda_lib.check(err, "decode_attention")
    launches += 1
    return out
