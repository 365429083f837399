# Copied from src/repro/configs/__init__.py; `repro.` rewritten to `repro_torch.`.
"""Architecture configs and input-shape cells.

Every assigned architecture is expressed as an :class:`ArchConfig` consumed by
``repro_torch.models.transformer``.  Heterogeneous stacks (jamba / xlstm / vlm) are
described as a *periodic super-block*: ``block_pattern`` lists the
(mixer, ffn) type of each layer inside one period and the model scans
``n_layers // period`` periods.  This keeps the lowered HLO compact (a single
scan body per period) regardless of depth.

Shape cells (``SHAPES``) follow the assignment:

* ``train_4k``     — seq 4096,    global batch 256  → lowers ``train_step``
* ``prefill_32k``  — seq 32768,   global batch 32   → lowers ``prefill``
* ``decode_32k``   — seq 32768,   global batch 128  → lowers ``serve_step``
* ``long_500k``    — seq 524288,  global batch 1    → lowers ``serve_step``

``applicable(cfg, shape)`` encodes the mandated skips (encoder-only archs have
no decode; ``long_500k`` only for sub-quadratic archs).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional, Tuple

# --------------------------------------------------------------------------
# Block vocabulary
# --------------------------------------------------------------------------
MIXERS = ("attn", "cross_attn", "mamba", "mlstm", "slstm")
FFNS = ("mlp", "moe", "none")


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int                       # dense-FFN hidden (per expert for MoE)
    vocab_size: int
    # One period of the layer stack: ((mixer, ffn), ...)
    block_pattern: Tuple[Tuple[str, str], ...] = (("attn", "mlp"),)
    d_head: Optional[int] = None    # default d_model // n_heads
    # Norm / attention details
    norm: str = "rmsnorm"           # rmsnorm | layernorm | layernorm_np
    qk_norm: bool = False
    qkv_bias: bool = False
    mlp_act: str = "silu"           # silu (SwiGLU) | gelu (plain)
    rope_theta: float = 10000.0
    causal: bool = True
    encoder_only: bool = False
    tie_embeddings: bool = True
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # SSM (mamba)
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    # xLSTM
    lstm_proj_factor: float = 2.0
    # VLM
    img_tokens: int = 0
    d_vision: int = 0
    # Modality frontend stub: inputs are embeddings, not token ids
    embedding_inputs: bool = False
    # Numerics
    dtype: str = "bfloat16"

    def __post_init__(self):
        if self.d_head is None:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)
        assert self.n_layers % len(self.block_pattern) == 0, (
            f"{self.name}: n_layers={self.n_layers} not divisible by "
            f"period={len(self.block_pattern)}")
        for mixer, ffn in self.block_pattern:
            assert mixer in MIXERS and ffn in FFNS

    # ---- derived ---------------------------------------------------------
    @property
    def period(self) -> int:
        return len(self.block_pattern)

    @property
    def n_periods(self) -> int:
        return self.n_layers // self.period

    @property
    def is_moe(self) -> bool:
        return any(f == "moe" for _, f in self.block_pattern)

    @property
    def attn_free(self) -> bool:
        return not any(m in ("attn", "cross_attn") for m, _ in self.block_pattern)

    @property
    def subquadratic(self) -> bool:
        """True when per-token decode cost does not grow with context
        (SSM / hybrid archs) — the ``long_500k`` eligibility rule."""
        return self.family in ("ssm", "hybrid")

    @property
    def mamba_d_inner(self) -> int:
        return self.mamba_expand * self.d_model

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks), for roofline
        MODEL_FLOPS = 6*N*D."""
        n = self.vocab_size * self.d_model  # embed (tied head)
        if not self.tie_embeddings:
            n += self.vocab_size * self.d_model
        for mixer, ffn in self.block_pattern * self.n_periods:
            n += self._mixer_params(mixer) + self._ffn_params(ffn)
            n += 2 * self._norm_params()
        n += self._norm_params()
        if self.img_tokens:
            n += self.d_vision * self.d_model
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k experts only)."""
        n = self.vocab_size * self.d_model
        if not self.tie_embeddings:
            n += self.vocab_size * self.d_model
        for mixer, ffn in self.block_pattern * self.n_periods:
            n += self._mixer_params(mixer)
            if ffn == "moe":
                per_exp = self._ffn_params("mlp")
                n += self.top_k * per_exp + self.d_model * self.n_experts
            else:
                n += self._ffn_params(ffn)
            n += 2 * self._norm_params()
        n += self._norm_params()
        return n

    def _norm_params(self) -> int:
        return 0 if self.norm == "layernorm_np" else self.d_model

    def _mixer_params(self, mixer: str) -> int:
        d, dh = self.d_model, self.d_head
        if mixer in ("attn", "cross_attn"):
            q = d * self.n_heads * dh
            kv = 2 * d * self.n_kv_heads * dh
            o = self.n_heads * dh * d
            b = (self.n_heads + 2 * self.n_kv_heads) * dh if self.qkv_bias else 0
            return q + kv + o + b
        if mixer == "mamba":
            di, ds, dc = self.mamba_d_inner, self.mamba_d_state, self.mamba_d_conv
            return (d * 2 * di          # in_proj
                    + di * dc           # conv1d
                    + di * (ds * 2 + 1) # x_proj -> B, C, dt (rank-1 dt)
                    + di                # dt bias
                    + di * ds           # A_log
                    + di                # D
                    + di * d)           # out_proj
        if mixer == "mlstm":
            dp = int(self.lstm_proj_factor * d)
            return (d * 2 * dp + 3 * dp * dp // max(self.n_heads, 1) * 0
                    + 3 * d * dp        # q,k,v from pre-up x (see ssm.py)
                    + 3 * dp            # i,f,o gate biases (per-dim gates use dp)
                    + 3 * d * self.n_heads
                    + dp * d)
        if mixer == "slstm":
            dp = d
            return 4 * d * dp + 4 * dp + dp * d
        raise ValueError(mixer)

    def _ffn_params(self, ffn: str) -> int:
        if ffn == "none":
            return 0
        d, f = self.d_model, self.d_ff
        per = d * f * (3 if self.mlp_act == "silu" else 2)
        if ffn == "mlp":
            return per
        if ffn == "moe":
            return self.n_experts * per + d * self.n_experts  # + router
        raise ValueError(ffn)


# --------------------------------------------------------------------------
# Shape cells
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, Shape] = {
    "train_4k": Shape("train_4k", "train", 4096, 256),
    "prefill_32k": Shape("prefill_32k", "prefill", 32768, 32),
    "decode_32k": Shape("decode_32k", "decode", 32768, 128),
    "long_500k": Shape("long_500k", "decode", 524288, 1),
}


def applicable(cfg: ArchConfig, shape: Shape) -> Tuple[bool, str]:
    """(runnable, reason-if-skipped) for an (arch x shape) cell."""
    if cfg.encoder_only and shape.kind == "decode":
        return False, "encoder-only arch has no decode step"
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "long_500k requires sub-quadratic attention (SSM/hybrid only)"
    return True, ""


# --------------------------------------------------------------------------
# Registry
# --------------------------------------------------------------------------
_ARCH_MODULES = {
    "olmo-1b": "olmo_1b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "qwen3-8b": "qwen3_8b",
    "qwen1.5-4b": "qwen1_5_4b",
    "xlstm-350m": "xlstm_350m",
    "llama-3.2-vision-11b": "llama32_vision_11b",
    "hubert-xlarge": "hubert_xlarge",
    "jamba-1.5-large-398b": "jamba15_large_398b",
    "phi3.5-moe-42b-a6.6b": "phi35_moe_42b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
}

ARCH_NAMES = tuple(_ARCH_MODULES)


def get_config(name: str) -> ArchConfig:
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_NAMES}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[name]}")
    return mod.make_config()


def get_tiny_config(name: str) -> ArchConfig:
    """Reduced same-family config for CPU smoke tests."""
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[name]}")
    return mod.make_tiny_config()


def all_cells():
    """Yield every (arch, shape, runnable, reason) cell — 40 total."""
    for name in ARCH_NAMES:
        cfg = get_config(name)
        for shape in SHAPES.values():
            ok, why = applicable(cfg, shape)
            yield name, shape.name, ok, why
