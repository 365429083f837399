"""Wrapper of the flash-attention kernels (``csrc/flash_attention.cu``).

Two kernels, chosen by :func:`kernel_variant` from the dtype and the head
width alone: ``"wgmma"`` (tensor cores fed by TMA) for bf16 at the widths
of ``WGMMA_HEAD_DIMS`` (64, 80, 128),
``"cuda_core"`` for f32 at every width and for bf16 at 8, 16 and 32 (the
tiny configs').  A launch that fails raises; no width falls back to the
other kernel or to the plain version.

A launch is the custom op ``prema::flash_attention``, so that fake
tensors (``FakeTensorMode``: the dry-run) trace through it: its fake
implementation gives the output's shape, dtype, device and strides, and
its FLOP formula (``torch.utils.flop_counter``) counts what the plain
version computes, every (query, key) pair of both products, so a trace
on the card's path counts what one on the CPU's counts."""
from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import (DTYPE_CODES, check_attention_inputs,
                                 cuda_lib, refuse_grad, tma_operand)
from repro_torch.kernels.flash_attention.ref import flash_attention_plain

# the head widths the kernels are built for: every d_head of the configs
# whose layers reach flash attention (hubert-xlarge's 1280 / 16 = 80)
HEAD_DIMS = (8, 16, 32, 64, 80, 128)
# the widths of the wgmma kernel's instances (flash_fwd_wgmma_kernel<D>)
WGMMA_HEAD_DIMS = (64, 80, 128)
launches = 0   # kernel launches by this wrapper in this process
variant_launches = {"wgmma": 0, "cuda_core": 0}   # the same, by kernel
# the same, of the launches with a query offset (a block of query rows)
mode_launches = {"q_offset": 0}


def kernel_variant(dtype: torch.dtype, d: int) -> str:
    """The kernel that a CUDA launch at this dtype and head width runs."""
    return ("wgmma" if dtype == torch.bfloat16 and d in WGMMA_HEAD_DIMS
            else "cuda_core")


# the same, by kernel and head width ("wgmma/80"): every instance a launch
# can reach
width_launches = {f"{kernel_variant(dt, d)}/{d}": 0 for d in HEAD_DIMS
                  for dt in (torch.bfloat16, torch.float32)}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """q: (B,Hq,S,D); k,v: (B,Hkv,T,D), any strides → (B,Hq,S,D), D one of
    ``HEAD_DIMS`` (else ``ValueError``).  With ``causal``, key j is visible
    to query row i iff j <= i + ``q_offset``: the queries are rows
    ``q_offset``.. of the sequence whose keys k holds.  Ragged S and T are
    masked inside the kernel.  Both kernels read rows of 16 bytes (TMA, or
    16-byte ``cp.async`` copies): an input whose strides do not allow that
    (innermost stride not 1, other strides not multiples of 16 bytes, base
    not 16-byte aligned) is copied first
    (:func:`repro_torch.kernels.tma_operand`).  An input that requires
    grad while grad mode is on raises ``RuntimeError``
    (:func:`repro_torch.kernels.refuse_grad`): the kernels have no
    backward."""
    check_attention_inputs(q, k, v, q_ndim=4, head_dims=HEAD_DIMS)
    refuse_grad("flash_attention", q, k, v)
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, q_offset)
    return torch.ops.prema.flash_attention(q, k, v, causal, q_offset)


def _out_like(q: torch.Tensor) -> torch.Tensor:
    """The output: q's strides (``empty_like``) where the kernels can write
    them in 16-byte rows, else contiguous.  A function of q's shape and
    strides alone, so the fake implementation gives the same."""
    out = torch.empty_like(q)
    st = out.stride()
    if st[-1] == 1 and all(s * q.element_size() % 16 == 0 for s in st[:-1]):
        return out
    return torch.empty(q.shape, dtype=q.dtype, device=q.device)


@torch.library.custom_op("prema::flash_attention", mutates_args=(),
                         device_types="cuda")
def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            q_offset: int) -> torch.Tensor:
    """One launch of the dtype's and head width's kernel."""
    global launches
    b, hq, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    lib, stream = cuda_lib.library(), torch.cuda.current_stream(
        q.device).cuda_stream
    variant = kernel_variant(q.dtype, d)
    out = _out_like(q)
    q, k, v = tma_operand(q), tma_operand(k), tma_operand(v)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    strides = cuda_lib.strides_arg(q, k, v, out)
    if variant == "wgmma":
        err = lib.prema_flash_attention_wgmma(
            *ptrs, b, hq, hkv, s, t, d, strides, d ** -0.5, int(causal),
            q_offset, stream)
    else:
        err = lib.prema_flash_attention(
            DTYPE_CODES[q.dtype], *ptrs, b, hq, hkv, s, t, d, strides,
            d ** -0.5, int(causal), q_offset, stream)
    cuda_lib.check(err, f"flash_attention ({variant})")
    launches += 1
    variant_launches[variant] += 1
    width_launches[f"{variant}/{d}"] += 1
    mode_launches["q_offset"] += q_offset > 0
    return out


@_launch.register_fake
def _(q, k, v, causal, q_offset):
    return _out_like(q)


@register_flop_formula(torch.ops.prema.flash_attention)
def _flops(q_shape, k_shape, v_shape, causal, q_offset, *args, **kwargs):
    """The plain version's: Q K^T and P V over every (query, key) pair."""
    b, hq, s, d = q_shape
    return 4 * b * hq * s * k_shape[2] * d
