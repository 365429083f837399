# Copied from src/repro/configs/phi35_moe_42b.py; `repro.` rewritten to `repro_torch.`.
"""phi3.5-moe-42b-a6.6b [moe]: 32L d_model=4096 32H (GQA kv=8) d_ff=6400
vocab=32064, MoE 16 experts top-2 on every layer
(hf:microsoft/Phi-3.5-MoE-instruct)."""
from repro_torch.configs import ArchConfig


def make_config() -> ArchConfig:
    return ArchConfig(
        name="phi3.5-moe-42b-a6.6b",
        family="moe",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=6400,
        vocab_size=32064,
        block_pattern=(("attn", "moe"),),
        norm="layernorm",
        mlp_act="silu",
        n_experts=16,
        top_k=2,
        tie_embeddings=False,
    )


def make_tiny_config() -> ArchConfig:
    return ArchConfig(
        name="phi3.5-moe-42b-a6.6b-tiny",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=96,
        vocab_size=256,
        block_pattern=(("attn", "moe"),),
        norm="layernorm",
        mlp_act="silu",
        n_experts=4,
        top_k=2,
        tie_embeddings=False,
    )
