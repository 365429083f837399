# Copied from src/repro/core/arch_ops.py; `repro.` rewritten to `repro_torch.`.
"""Lower an :class:`ArchConfig` into predictor op lists (NetworkDesc).

This is the bridge between the 2024-26 model zoo and PREMA's Algorithm-1
predictor: a prefill at prompt length P is the static prefix, and each
decode step is one ``recurrent_ops`` instance — so the paper's seq2seq
output-length LUT applies verbatim to autoregressive LLM decode length.

The lowering mirrors what the JAX model actually executes (same einsums),
so Algorithm-1 estimates and XLA ``cost_analysis`` flops can be
cross-checked (tests/test_predictor.py).
"""
from __future__ import annotations

from typing import List

from repro_torch.configs import ArchConfig
from repro_torch.core.ops import GemmOp, NetworkDesc, VectorOp


def _attn_ops(cfg: ArchConfig, n_q: int, n_kv: int, batch: int, tag: str,
              kv_project: Optional[int] = None) -> List:
    """Self/cross attention at n_q query tokens over n_kv key tokens.
    ``kv_project``: tokens whose K/V are *computed* (decode projects only
    the new token; the rest comes from the cache)."""
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    t = batch * n_q
    n_kvp = batch * (kv_project if kv_project is not None else n_kv)
    ops = [
        GemmOp(m=hq * dh, k=d, n=t, name=f"{tag}.q"),
        GemmOp(m=hkv * dh, k=d, n=n_kvp, name=f"{tag}.k"),
        GemmOp(m=hkv * dh, k=d, n=n_kvp, name=f"{tag}.v"),
        # scores + weighted sum: per-head GEMMs (batch*heads repeats)
        GemmOp(m=n_q, k=dh, n=n_kv, repeat=batch * hq, name=f"{tag}.qk",
               weight_resident=False),
        GemmOp(m=n_q, k=n_kv, n=dh, repeat=batch * hq, name=f"{tag}.av",
               weight_resident=False),
        GemmOp(m=d, k=hq * dh, n=t, name=f"{tag}.o"),
        VectorOp(elems=batch * hq * n_q * n_kv, name=f"{tag}.softmax"),
    ]
    return ops


def _mamba_ops(cfg: ArchConfig, n_tok: int, batch: int, tag: str) -> List:
    d, di, ds = cfg.d_model, cfg.mamba_d_inner, cfg.mamba_d_state
    dtr = max(1, d // 64)
    t = batch * n_tok
    return [
        GemmOp(m=2 * di, k=d, n=t, name=f"{tag}.in"),
        GemmOp(m=dtr + 2 * ds, k=di, n=t, name=f"{tag}.xproj"),
        GemmOp(m=di, k=dtr, n=t, name=f"{tag}.dt"),
        VectorOp(elems=t * di * (2 * ds + cfg.mamba_d_conv + 4),
                 name=f"{tag}.scan"),
        GemmOp(m=d, k=di, n=t, name=f"{tag}.out"),
    ]


def _mlstm_ops(cfg: ArchConfig, n_tok: int, batch: int, tag: str) -> List:
    d = cfg.d_model
    dp = int(cfg.lstm_proj_factor * d)
    h = cfg.n_heads
    dh = dp // h
    t = batch * n_tok
    return [
        GemmOp(m=2 * dp, k=d, n=t, name=f"{tag}.up"),
        GemmOp(m=dp, k=dp, n=t, repeat=3, name=f"{tag}.qkv"),
        # matrix-memory update + readout per token: O(H*dh^2)
        VectorOp(elems=t * h * dh * dh * 3, name=f"{tag}.cell"),
        GemmOp(m=d, k=dp, n=t, name=f"{tag}.down"),
    ]


def _slstm_ops(cfg: ArchConfig, n_tok: int, batch: int, tag: str) -> List:
    d = cfg.d_model
    h = cfg.n_heads
    dh = d // h
    t = batch * n_tok
    return [
        GemmOp(m=4 * d, k=d, n=t, name=f"{tag}.zifo"),
        GemmOp(m=4 * dh, k=dh, n=t, repeat=h, name=f"{tag}.rec",
               weight_resident=False),
        VectorOp(elems=t * d * 8, name=f"{tag}.cell"),
        GemmOp(m=d, k=d, n=t, name=f"{tag}.out"),
    ]


def _ffn_ops(cfg: ArchConfig, ffn: str, n_tok: int, batch: int, tag: str
             ) -> List:
    d, f = cfg.d_model, cfg.d_ff
    t = batch * n_tok
    n_mats = 3 if cfg.mlp_act == "silu" else 2
    if ffn == "mlp":
        return [GemmOp(m=f, k=d, n=t, repeat=n_mats - 1, name=f"{tag}.in"),
                GemmOp(m=d, k=f, n=t, name=f"{tag}.out"),
                VectorOp(elems=t * f, name=f"{tag}.act")]
    if ffn == "moe":
        # active compute only: top_k experts per token
        return [GemmOp(m=cfg.n_experts, k=d, n=t, name=f"{tag}.router"),
                GemmOp(m=f, k=d, n=t * cfg.top_k, repeat=n_mats - 1,
                       name=f"{tag}.exp_in", weight_resident=False),
                GemmOp(m=d, k=f, n=t * cfg.top_k, name=f"{tag}.exp_out",
                       weight_resident=False),
                VectorOp(elems=t * cfg.top_k * f, name=f"{tag}.act")]
    return []


def _layer_ops(cfg: ArchConfig, slot: int, n_q: int, n_kv: int, batch: int,
               decode: bool = False) -> List:
    mixer, ffn = cfg.block_pattern[slot]
    tag = f"s{slot}.{mixer}"
    if mixer == "attn":
        ops = _attn_ops(cfg, n_q, n_kv, batch, tag,
                        kv_project=(1 if decode else None))
    elif mixer == "cross_attn":
        ops = _attn_ops(cfg, n_q, cfg.img_tokens, batch, tag,
                        kv_project=(0 if decode else None))
    elif mixer == "mamba":
        ops = _mamba_ops(cfg, n_q, batch, tag)
    elif mixer == "mlstm":
        ops = _mlstm_ops(cfg, n_q, batch, tag)
    elif mixer == "slstm":
        ops = _slstm_ops(cfg, n_q, batch, tag)
    else:
        raise ValueError(mixer)
    ops += _ffn_ops(cfg, ffn, n_q, batch, tag)
    ops.append(VectorOp(elems=batch * n_q * cfg.d_model * 4, name=f"{tag}.norms"))
    return ops


def prefill_ops(cfg: ArchConfig, prompt_len: int, batch: int) -> List:
    """Full-network prefill (or encoder forward) op list."""
    ops: List = []
    if cfg.img_tokens:
        ops.append(GemmOp(m=cfg.d_model, k=cfg.d_vision,
                          n=batch * cfg.img_tokens, name="img_proj"))
    for period in range(cfg.n_periods):
        for slot in range(cfg.period):
            ops.extend(_layer_ops(cfg, slot, prompt_len, prompt_len, batch))
    ops.append(GemmOp(m=cfg.vocab_size, k=cfg.d_model,
                      n=batch * (prompt_len if cfg.encoder_only else 1),
                      name="unembed"))
    return ops


def decode_step_ops(cfg: ArchConfig, context_len: int, batch: int) -> List:
    """One-token decode against a context of ``context_len``."""
    ops: List = []
    for period in range(cfg.n_periods):
        for slot in range(cfg.period):
            ops.extend(_layer_ops(cfg, slot, 1, context_len, batch,
                                  decode=True))
    ops.append(GemmOp(m=cfg.vocab_size, k=cfg.d_model, n=batch,
                      name="unembed"))
    return ops


def make_llm_network(cfg: ArchConfig, prompt_len: int, batch: int,
                     decode_context: int = 0) -> NetworkDesc:
    """NetworkDesc for a serving request: prefill prefix + per-token decode
    cell.  ``kind='rnn_seq2seq'`` so the LUT length-regressor path applies
    (decode length is the dynamically-predicted unroll)."""
    ctx = decode_context or prompt_len
    return NetworkDesc(
        name=cfg.name,
        static_ops=tuple(prefill_ops(cfg, prompt_len, batch)),
        recurrent_ops=tuple(decode_step_ops(cfg, ctx, batch)),
        kind="cnn" if cfg.encoder_only else "rnn_seq2seq",
        batch=batch)


def flops(cfg: ArchConfig, prompt_len: int, batch: int,
          mode: str = "prefill") -> int:
    """Total FLOPs of one prefill pass or one decode step."""
    if mode == "prefill":
        return sum(op.flops for op in prefill_ops(cfg, prompt_len, batch))
    return sum(op.flops for op in decode_step_ops(cfg, prompt_len, batch))
