"""The benchmark's frozen arithmetic: the card's published peaks, the
hardware model the engine schedules by, and the operation and byte counts
of the kernels and of the model.  Nothing here reads the program: a change
to the program's own formulas or to its ``hw.py`` moves none of these.

The model counts below are a dense decoder's (every layer attention and
a SwiGLU MLP); ``arch/dense.py`` divides them into executor steps, and
another architecture's module counts its own steps beside them.

Counts are of the work the inputs need (each input byte read once, each
output byte written once; a causal product only over the pairs the mask
keeps), so a kernel's share of its bound can reach 100 % and no more.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

# NVIDIA H100 SXM data sheet, dense rates, at the full 700 W power limit.
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
BF16_BYTES = 2

# The engine's Algorithm-1 hardware model, as ``repro_torch.hw.H100`` read
# when the cells were defined: the arrival gaps of the cells were reckoned
# from it, so the engine schedules by it whatever the program's hw.py says.
FROZEN_H100 = dict(
    name="h100-sxm",
    sa_rows=128,
    sa_cols=128,
    n_mxu=132,
    freq_hz=989e12 / (2 * 132 * 128 * 128),
    hbm_bw=3.35e12,
    hbm_bytes=80 * 10**9,
    vmem_bytes=132 * 228 * 1024,
    wmem_bytes=0,
    mem_latency_cycles=0,
    ici_bw=0.0,
    ici_links=0,
    bytes_per_elem=2,
)


def bound_s(ops: float, nbytes: float) -> float:
    """Least time the card could take: the larger of the compute and the
    memory bound."""
    return max(ops / PEAK_BF16_FLOPS, nbytes / HBM_BYTES_PER_S)


def causal_pairs(s: int) -> int:
    """Query-key pairs a causal mask keeps when S queries attend to the
    same S keys."""
    return s * (s + 1) // 2


def flash_ops(s: int, hq: int, dh: int, batch: int = 1) -> int:
    """Causal self-attention over S positions: QK^T and PV, 2 x 2 Dh
    operations per kept pair and query head."""
    return 4 * batch * hq * dh * causal_pairs(s)


def flash_bytes(s: int, hq: int, hkv: int, dh: int, batch: int = 1) -> int:
    """Q and O of every query head, K and V of every KV head, in bf16."""
    return BF16_BYTES * batch * s * dh * (2 * hq + 2 * hkv)


def decode_attn_ops(t: int, hq: int, dh: int, batch: int = 1) -> int:
    """One new query per head against T cached positions."""
    return 4 * batch * hq * dh * t


def decode_attn_bytes(t: int, hq: int, hkv: int, dh: int,
                      batch: int = 1) -> int:
    """K and V of T positions per KV head, the query and the output."""
    return BF16_BYTES * batch * dh * (2 * t * hkv + 2 * hq)


def layer_matmul_params(cfg: Dict) -> int:
    """Weights one token multiplies in one layer: Q, K, V, O and the three
    SwiGLU matrices."""
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    hq, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    dh = d // hq
    return d * dh * (2 * hq + 2 * hkv) + 3 * d * f


def prefill_model_flops(cfg: Dict, s: int) -> int:
    """A prompt of S tokens: every layer's products at every position,
    causal attention, and the head at the last position only (the one the
    next token needs)."""
    d, hq = cfg["hidden_size"], cfg["num_attention_heads"]
    layers = cfg["num_hidden_layers"]
    dh = d // hq
    return (2 * s * layers * layer_matmul_params(cfg)
            + layers * flash_ops(s, hq, dh)
            + 2 * d * cfg["vocab_size"])


def decode_model_flops(cfg: Dict, t: int) -> int:
    """One new token against T positions (its own included)."""
    d, hq = cfg["hidden_size"], cfg["num_attention_heads"]
    layers = cfg["num_hidden_layers"]
    dh = d // hq
    return (2 * layers * layer_matmul_params(cfg)
            + layers * decode_attn_ops(t, hq, dh)
            + 2 * d * cfg["vocab_size"])


def percentile(values: Sequence[float], pct: float) -> float:
    """``np.percentile`` with linear interpolation, as the program's
    ``core/metrics`` takes its tails."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), pct))


def antt(turnarounds: Sequence[float], services: Sequence[float]) -> float:
    """Average normalized turnaround (the paper's Eq. 1): the mean over
    requests of turnaround over the request's own service time."""
    return float(np.mean([t / s for t, s in zip(turnarounds, services)]))
