"""Wrapper of the decode-attention kernel (``csrc/decode_attention.cu``).

``pos`` is a host int or a 0-dim int32 tensor on the card, which the kernel
reads itself: the grid is sized from the capacity T, so one launch serves
every ``pos`` and can be captured in a CUDA graph and replayed.

A launch is the custom op ``prema::decode_attention``, so that fake
tensors (``FakeTensorMode``: the dry-run) trace through it: its fake
implementation gives the outputs' shapes, dtypes and device, and its FLOP
formula counts what the plain version computes, every key of the
capacity, so a trace on the card's path counts what one on the CPU's
counts.  The merge tickets stay outside the op (an input it leaves
zero), allocated by a real call, never by a fake one or inside a capture.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple, Union

import torch
from torch._subclasses.fake_tensor import is_fake
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import (DTYPE_CODES, check_attention_inputs,
                                 cuda_lib, refuse_grad, tma_operand)
from repro_torch.kernels.decode_attention.ref import decode_attention_plain

HEAD_DIMS = (8, 16, 32, 64, 128)   # the head widths the kernel is built for
launches = 0        # kernel launches by this wrapper in this process
mode_launches = {"lse": 0}   # the same, of those that wrote the lse
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
    if not -1 <= pos < t:
        raise ValueError(f"pos {pos} outside [-1, {t}) for a cache of {t} "
                         "entries")
    return pos


def _readable(x: torch.Tensor) -> torch.Tensor:
    """``x`` where 16-byte loads can read its rows (unit inner stride,
    16-byte aligned base and strides, as TMA needs too), else a copy."""
    global layout_copies
    y = tma_operand(x)
    layout_copies += y is not x
    return y


def _tickets_for(q: torch.Tensor, n: int) -> torch.Tensor:
    """The device's merge tickets, at least ``n``: kept across calls, but
    a fake call gets fake ones of its own."""
    if is_fake(q):
        return torch.zeros(max(n, 64), dtype=torch.int32, device=q.device)
    tickets = _tickets.get(q.device)
    if tickets is None or tickets.numel() < n:
        tickets = _tickets[q.device] = torch.zeros(
            max(n, 64), dtype=torch.int32, device=q.device)
    return tickets


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos: Union[int, torch.Tensor], return_lse: bool = False):
    """q: (B,Hq,D) one token per sequence; k,v: (B,Hkv,T,D), any strides;
    attend over cache[0..pos] → (B,Hq,D), and with ``return_lse`` also
    (out, lse), lse the f32 (B,Hq) log-sum-exp of each query head's scaled
    scores.  ``pos``: a host int in [-1, T), or a 0-dim int32 tensor on
    q's device, read without a host sync and clamped to [-1, T); -1 means
    no key (out 0, lse -1e30).  An input that requires grad while grad
    mode is on raises ``RuntimeError``
    (:func:`repro_torch.kernels.refuse_grad`)."""
    check_attention_inputs(q, k, v, q_ndim=3, head_dims=HEAD_DIMS)
    refuse_grad("decode_attention", q, k, v)
    b, hq, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    pos = _check_pos(pos, q, t)
    dev_pos = isinstance(pos, torch.Tensor)
    if q.device.type == "cpu":
        return decode_attention_plain(
            q, k, v, pos.clamp(-1, t - 1) if dev_pos else pos, return_lse)
    out, lse = torch.ops.prema.decode_attention(
        q, k, v, _tickets_for(q, b * hkv), pos if dev_pos else None,
        0 if dev_pos else pos, return_lse)
    return (out, lse) if return_lse else out


@torch.library.custom_op("prema::decode_attention", mutates_args=(),
                         device_types="cuda")
def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            tickets: torch.Tensor, pos_t: Optional[torch.Tensor], pos: int,
            return_lse: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch; ``pos_t`` (a device int32) or else ``pos``.  The
    tickets are zero before and after, so the op declares no mutation.
    The lse is empty unless asked for."""
    global launches
    b, hq, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    chunk, max_group = _constants()
    if hq // hkv > max_group:
        raise ValueError(f"query group {hq // hkv} exceeds the kernel's "
                         f"{max_group}")
    k, v = _readable(k), _readable(v)
    out, lse = _outputs(q, return_lse)
    # per (batch, KV head, chunk of the capacity): the group's partial
    # outputs, maxima and normalisers
    part = torch.empty(b * hkv * -(-t // chunk) * (hq // hkv) * (d + 2),
                       dtype=torch.float32, device=q.device)
    err = cuda_lib.library().prema_decode_attention(
        DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), part.data_ptr(), tickets.data_ptr(),
        lse.data_ptr() if return_lse else None,
        None if pos_t is None else pos_t.data_ptr(), pos,
        b, hq, hkv, t, d, cuda_lib.strides_arg(q, k, v, out), d ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    cuda_lib.check(err, "decode_attention")
    launches += 1
    mode_launches["lse"] += return_lse
    return out, lse


def _outputs(q: torch.Tensor, return_lse: bool):
    b, hq, d = q.shape
    return (torch.empty((b, hq, d), dtype=q.dtype, device=q.device),
            torch.empty((b, hq) if return_lse else (0,), dtype=torch.float32,
                        device=q.device))


@_launch.register_fake
def _(q, k, v, tickets, pos_t, pos, return_lse):
    return _outputs(q, return_lse)


@register_flop_formula(torch.ops.prema.decode_attention)
def _flops(q_shape, k_shape, *args, **kwargs):
    """The plain version's: q K^T and P V over every key of the capacity."""
    b, hq, d = q_shape
    return 4 * b * hq * k_shape[2] * d
