"""Plain PyTorch version of the decode-attention kernel (follows
``repro/kernels/decode_attention/ref.py``): f32 scores, -1e30 masking of
keys past ``pos``, softmax, f32 PV, cast to ``q.dtype``; on request also
each query head's log-sum-exp of its scores, which weighs the output
against those of other blocks of a split cache.  ``pos = -1`` means the
block holds no key for this token: the output is zeros and the
log-sum-exp -1e30, so the block weighs nothing in a merge."""
from __future__ import annotations

import torch

NEG_INF = -1e30
# terms of :func:`merged_bf16_tolerance`
BF16_ATOL = 1e-5
BF16_RTOL = 2.0 ** -8


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           pos: int, return_lse: bool = False):
    """q: (B,Hq,D); k,v: (B,Hkv,T,D); attend over cache[0..pos] →
    (B,Hq,D), and with ``return_lse`` also the f32 log-sum-exp (B,Hq) of
    the scaled scores of keys 0..pos."""
    b, hq, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    if pos < 0:
        out = q.new_zeros((b, hq, d))
        lse = torch.full((b, hq), NEG_INF, dtype=torch.float32,
                         device=q.device)
        return (out, lse) if return_lse else out
    qg = q.reshape(b, hkv, hq // hkv, d).float()
    s = torch.einsum("bhgd,bhtd->bhgt", qg, k.float()) * (d ** -0.5)
    valid = torch.arange(t, device=q.device) <= pos
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgt,bhtd->bhgd", p, v.float())
    out = out.reshape(b, hq, d).to(q.dtype)
    if not return_lse:
        return out
    return out, torch.logsumexp(s, dim=-1).reshape(b, hq)


def merged_bf16_tolerance(ref: torch.Tensor, outs: torch.Tensor,
                          lses: torch.Tensor) -> torch.Tensor:
    """Elementwise tolerance, (B,Hq,D) f32, of the merge of bf16 partial
    outputs ``outs`` (n,B,Hq,D), each a block of the cache with its
    log-sum-exp in ``lses`` (n,B,Hq), against ``ref``, the plain version
    run in f32 over the whole cache:

        1e-5 + 2**-8 |ref| + 2**-8 sum_r w_r |out_r| / sum_r w_r

    with w_r = exp(lse_r - max lse).  The first two terms are the decode
    kernel's own (``chip_smoke.py``'s ``TOL``): its f32 result rounded
    once to bf16.  Each partial is itself rounded once, by at most 2**-9
    |out_r|, and the merge is their weighted mean, so those errors add at
    most 2**-9 of the weighted mean of |out_r|; taken twice over, as the
    other terms.  Where the partials have one sign the last term is at most
    2**-8 |ref|."""
    w = torch.exp(lses - lses.amax(dim=0))[..., None]
    mean_abs = (w * outs.float().abs()).sum(dim=0) / w.sum(dim=0)
    return BF16_ATOL + BF16_RTOL * ref.float().abs() + BF16_RTOL * mean_abs
