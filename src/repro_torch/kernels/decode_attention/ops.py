"""Wrapper of the decode-attention kernel (``csrc/decode_attention.cu``).

``pos`` is a host int or a 0-dim int32 tensor on the card, which the kernel
reads itself: the grid is sized from the capacity T, so one launch serves
every ``pos`` and can be captured in a CUDA graph and replayed."""
from __future__ import annotations

import functools
from typing import Tuple, Union

import torch

from repro_torch.kernels import (DTYPE_CODES, check_attention_inputs,
                                 cuda_lib, refuse_grad, tma_operand)
from repro_torch.kernels.decode_attention.ref import decode_attention_plain

HEAD_DIMS = (8, 16, 32, 64, 128)   # the head widths the kernel is built for
launches = 0        # kernel launches by this wrapper in this process
layout_copies = 0   # K or V copied because 16-byte loads could not read it
# per device, the kernel's (B * Hkv) int32 merge tickets: zeros, and left
# zero by every launch.  Allocated by the first call, so warm up before
# capturing a CUDA graph, which must not own them.
_tickets = {}


@functools.lru_cache(maxsize=None)
def _constants() -> Tuple[int, int]:
    """The kernel's keys per chunk and largest query group."""
    lib = cuda_lib.library()
    return lib.prema_decode_chunk(), lib.prema_decode_max_group()


def _check_pos(pos, q: torch.Tensor, t: int):
    if isinstance(pos, torch.Tensor):
        if pos.dtype != torch.int32 or pos.dim() != 0:
            raise ValueError(f"a pos tensor must be 0-dim int32, got "
                             f"{pos.dtype} of shape {tuple(pos.shape)}")
        if pos.device != q.device:
            raise ValueError(f"pos lies on {pos.device}, q on {q.device}")
        return pos
    pos = int(pos)
    if not 0 <= pos < t:
        raise ValueError(f"pos {pos} outside the cache of {t} entries")
    return pos


def _readable(x: torch.Tensor) -> torch.Tensor:
    """``x`` where 16-byte loads can read its rows (unit inner stride,
    16-byte aligned base and strides, as TMA needs too), else a copy."""
    global layout_copies
    y = tma_operand(x)
    layout_copies += y is not x
    return y


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos: Union[int, torch.Tensor]) -> torch.Tensor:
    """q: (B,Hq,D) one token per sequence; k,v: (B,Hkv,T,D), any strides;
    attend over cache[0..pos] → (B,Hq,D).  ``pos``: a host int in [0, T),
    or a 0-dim int32 tensor on q's device, read without a host sync and
    clamped to [0, T).  An input that requires grad while grad mode is on
    raises ``RuntimeError`` (:func:`repro_torch.kernels.refuse_grad`)."""
    global launches
    check_attention_inputs(q, k, v, q_ndim=3, head_dims=HEAD_DIMS)
    refuse_grad("decode_attention", q, k, v)
    b, hq, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    pos = _check_pos(pos, q, t)
    dev_pos = isinstance(pos, torch.Tensor)
    if q.device.type == "cpu":
        return decode_attention_plain(
            q, k, v, pos.clamp(0, t - 1) if dev_pos else pos)
    chunk, max_group = _constants()
    if hq // hkv > max_group:
        raise ValueError(f"query group {hq // hkv} exceeds the kernel's "
                         f"{max_group}")
    k, v = _readable(k), _readable(v)
    tickets = _tickets.get(q.device)
    if tickets is None or tickets.numel() < b * hkv:
        tickets = _tickets[q.device] = torch.zeros(
            max(b * hkv, 64), dtype=torch.int32, device=q.device)
    out = torch.empty((b, hq, d), dtype=q.dtype, device=q.device)
    # per (batch, KV head, chunk of the capacity): the group's partial
    # outputs, maxima and normalisers
    part = torch.empty(b * hkv * -(-t // chunk) * (hq // hkv) * (d + 2),
                       dtype=torch.float32, device=q.device)
    err = cuda_lib.library().prema_decode_attention(
        DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), part.data_ptr(), tickets.data_ptr(),
        pos.data_ptr() if dev_pos else None, 0 if dev_pos else pos,
        b, hq, hkv, t, d, cuda_lib.strides_arg(q, k, v, out), d ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    cuda_lib.check(err, "decode_attention")
    launches += 1
    return out
