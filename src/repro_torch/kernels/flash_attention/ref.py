"""Plain PyTorch version of the flash-attention kernel (follows
``repro/kernels/flash_attention/ref.py``): f32 scores, -1e30 masking,
softmax, f32 PV, cast to ``q.dtype``; and the tolerance that holds the
bf16 tensor-core kernel against it."""
from __future__ import annotations

import torch

NEG_INF = -1e30
# terms of :func:`bf16_tolerance`
BF16_ATOL = 1e-5
BF16_RTOL = 2.0 ** -8
BF16_P_TERM = 2.0 ** -8


def _probabilities(q: torch.Tensor, k: torch.Tensor, causal: bool,
                   q_offset: int = 0) -> torch.Tensor:
    """The normalised softmax in f32, (B, Hkv, Hq/Hkv, S, T)."""
    b, hq, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    qg = q.reshape(b, hkv, hq // hkv, s, d).float()
    scores = torch.einsum("bhgsd,bhtd->bhgst", qg, k.float()) * (d ** -0.5)
    if causal:
        rows = torch.arange(s, device=q.device)[:, None]
        cols = torch.arange(t, device=q.device)[None, :]
        scores = torch.where(cols <= rows + q_offset, scores, NEG_INF)
    return torch.softmax(scores, dim=-1)


def _apply(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    b, hkv, g, s, _ = p.shape
    out = torch.einsum("bhgst,bhtd->bhgsd", p, v)
    return out.reshape(b, hkv * g, s, v.shape[-1])


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, q_offset: int = 0
                          ) -> torch.Tensor:
    """q: (B,Hq,S,D); k,v: (B,Hkv,T,D) → (B,Hq,S,D).  Causal: key j is
    visible to query i iff j <= i + q_offset (the queries are rows
    q_offset.. of a longer sequence)."""
    return _apply(_probabilities(q, k, causal, q_offset),
                  v.float()).to(q.dtype)


def bf16_tolerance(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """Elementwise tolerance, (B,Hq,S,D) f32, of the bf16 tensor-core
    kernel's output against :func:`flash_attention_plain` run in f32 on the
    same (bf16) values:

        1e-5 + 2**-8 |ref| + 2**-8 (P @ |V|)

    with P the plain version's normalised f32 softmax.  The kernel keeps
    scores, m, l and the accumulator in f32 (the 1e-5: f32 sums in another
    order), rounds P to bf16 before P @ V, as the JAX model rounds it to
    q's type, and rounds its output to bf16 once.  Rounding to nearest,
    bf16 errs by at most 2**-9 relative: on the output that is 2**-9 |out|,
    and on each P_j it is 2**-9 P_j, so on P @ V at most 2**-9 (P @ |V|)
    (l sums the unrounded P, so the normaliser adds nothing).  Each term is
    taken twice over.  A dropped key tile, a causal mask one key short or
    long, and a wrong KV head each exceed it by more than 2x
    (``tests/test_torch_tensorcore_numerics.py`` simulates each)."""
    p = _probabilities(q, k, causal, q_offset)
    vf = v.float()
    return (BF16_ATOL + BF16_RTOL * _apply(p, vf).abs()
            + BF16_P_TERM * _apply(p, vf.abs()))
