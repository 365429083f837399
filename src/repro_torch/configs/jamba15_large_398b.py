# Copied from src/repro/configs/jamba15_large_398b.py; `repro.` rewritten to `repro_torch.`.
"""jamba-1.5-large-398b [hybrid]: 72L d_model=8192 64H (GQA kv=8) d_ff=24576
vocab=65536, MoE 16e top-2 — Mamba+attention 1:7 interleave, MoE every 2nd
layer (arXiv:2403.19887).

Period-8 super-block: attention at slot 4, mamba elsewhere; MoE FFN at odd
slots, dense MLP at even slots.  Analytic param count of this config is
~398B (expert weights dominate: 36 MoE layers x 16 experts).
"""
from repro_torch.configs import ArchConfig

_PATTERN = tuple(
    (("attn" if i == 4 else "mamba"), ("moe" if i % 2 == 1 else "mlp"))
    for i in range(8)
)


def make_config() -> ArchConfig:
    return ArchConfig(
        name="jamba-1.5-large-398b",
        family="hybrid",
        n_layers=72,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=24576,
        vocab_size=65536,
        block_pattern=_PATTERN,
        norm="rmsnorm",
        mlp_act="silu",
        n_experts=16,
        top_k=2,
        mamba_d_state=16,
        mamba_d_conv=4,
        mamba_expand=2,
        tie_embeddings=False,
    )


def make_tiny_config() -> ArchConfig:
    return ArchConfig(
        name="jamba-1.5-large-398b-tiny",
        family="hybrid",
        n_layers=8,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=256,
        block_pattern=_PATTERN,
        norm="rmsnorm",
        mlp_act="silu",
        n_experts=4,
        top_k=2,
        mamba_d_state=8,
        mamba_d_conv=4,
        mamba_expand=2,
        tie_embeddings=False,
    )
