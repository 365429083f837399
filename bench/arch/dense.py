"""Dense decoders (OLMo, Qwen1.5): every layer attention, then a SwiGLU MLP,
so a period of the program's stack is one layer.  The harness side of a
configuration whose file names no ``"arch"``: the program's
``ArchConfig``, the weights drawn from the seed under the benchmark's own
names, their layout in the program, and the counts the readers divide by.
The plain reference of the same architecture is ``ref/dense.py``."""
from __future__ import annotations

from typing import Dict

import torch

from bench import yardstick

# a CPU-sized copy for the tests: every key the forward reads keeps its
# meaning, the widths and depth shrink, and the weights are float32
TINY = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=4, vocab_size=256,
            serve_dtype="float32")


def arch_config(cfg: Dict):
    """The program's ``ArchConfig`` for the configuration as its file
    states it."""
    from repro_torch.configs import ArchConfig
    if cfg["hidden_act"] != "silu":
        raise ValueError(f"{cfg['name']}: only SwiGLU MLPs are served")
    return ArchConfig(
        name=cfg["name"], family="dense", n_layers=cfg["num_hidden_layers"],
        d_model=cfg["hidden_size"], n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"], d_ff=cfg["intermediate_size"],
        vocab_size=cfg["vocab_size"], block_pattern=(("attn", "mlp"),),
        norm=cfg["norm"], qkv_bias=cfg["attention_bias"], mlp_act="silu",
        rope_theta=cfg["rope_theta"], tie_embeddings=cfg["tie_word_embeddings"],
        dtype=cfg["serve_dtype"])


def draw_weights(cfg: Dict, gen: torch.Generator,
                 device) -> Dict[str, torch.Tensor]:
    """Every weight, drawn on ``device`` from ``gen`` in the serving dtype,
    one call per stacked leaf: N(0, 1/fan_in) for the products and the
    embedding, N(0, 0.1^2) for QKV biases, 1 + N(0, 0.1^2) for RMSNorm
    scales.  Layer leaves are stacked on a leading layer axis."""
    dtype = getattr(torch, cfg["serve_dtype"])
    n, d, f = cfg["num_hidden_layers"], cfg["hidden_size"], cfg["intermediate_size"]
    hq, hkv, v = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                  cfg["vocab_size"])
    dh = d // hq

    def normal(shape, std, mean=0.0):
        t = torch.randn(shape, generator=gen, device=device, dtype=dtype)
        t.mul_(std)
        return t.add_(mean) if mean else t

    w = {"embed": normal((v, d), d ** -0.5),
         "wq": normal((n, d, hq, dh), d ** -0.5),
         "wk": normal((n, d, hkv, dh), d ** -0.5),
         "wv": normal((n, d, hkv, dh), d ** -0.5),
         "wo": normal((n, hq, dh, d), (hq * dh) ** -0.5),
         "w_in": normal((n, d, f), d ** -0.5),
         "w_gate": normal((n, d, f), d ** -0.5),
         "w_out": normal((n, f, d), f ** -0.5)}
    if cfg["attention_bias"]:
        for name, h in (("bq", hq), ("bk", hkv), ("bv", hkv)):
            w[name] = normal((n, h, dh), 0.1)
    if cfg["norm"] == "rmsnorm":
        w["norm1"] = normal((n, d), 0.1, 1.0)
        w["norm2"] = normal((n, d), 0.1, 1.0)
        w["final_norm"] = normal((d,), 0.1, 1.0)
    if not cfg["tie_word_embeddings"]:
        w["lm_head"] = normal((d, v), d ** -0.5)
    return w


def port_params(w: Dict[str, torch.Tensor]) -> Dict:
    """The same tensors in the program's parameter layout: one slot of
    (attention, MLP), its leaves stacked over the layers."""
    def norm(name):
        return {"scale": w[name]} if name in w else {}
    slot = {"norm1": norm("norm1"),
            "mixer": {k: w[k] for k in ("wq", "wk", "wv", "wo", "bq", "bk",
                                        "bv") if k in w},
            "norm2": norm("norm2"),
            "ffn": {k: w[k] for k in ("w_in", "w_gate", "w_out")}}
    params = {"embed": {"table": w["embed"]}, "slots": {"slot0": slot},
              "final_norm": norm("final_norm")}
    if "lm_head" in w:
        params["lm_head"] = {"w": w["lm_head"]}
    return params


def periods(cfg: Dict) -> int:
    """Prefill steps in a whole prompt: one a layer."""
    return cfg["num_hidden_layers"]


def step_flops(cfg: Dict, kind: str, size: int) -> float:
    """Model FLOPs of one executor step: a ``prefill`` step (one period,
    here one layer, over ``size`` prompt tokens, with its share of the
    head) or a ``decode`` step (one token at context ``size``)."""
    if kind == "prefill":
        return yardstick.prefill_model_flops(cfg, size) / cfg["num_hidden_layers"]
    if kind == "decode":
        return yardstick.decode_model_flops(cfg, size)
    raise ValueError(f"unknown step {kind!r}")


def attention_layers(cfg: Dict) -> int:
    """Decode-kernel launches a decode step: every layer attends."""
    return cfg["num_hidden_layers"]


def attention_per_period(cfg: Dict) -> int:
    """Flash-kernel launches a prefill step."""
    return 1


def head_dim(cfg: Dict) -> int:
    return cfg["hidden_size"] // cfg["num_attention_heads"]


def tiny(cfg: Dict) -> Dict:
    """The overrides that make ``cfg`` a CPU-sized float32 copy."""
    return dict(TINY)
