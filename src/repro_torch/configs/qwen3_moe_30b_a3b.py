# Copied from src/repro/configs/qwen3_moe_30b_a3b.py; `repro.` rewritten to `repro_torch.`.
"""qwen3-moe-30b-a3b [moe]: 48L d_model=2048 32H (GQA kv=4, head_dim=128)
d_ff=768 per expert, vocab=151936, MoE 128 experts top-8
(hf:Qwen/Qwen3-30B-A3B)."""
from repro_torch.configs import ArchConfig


def make_config() -> ArchConfig:
    return ArchConfig(
        name="qwen3-moe-30b-a3b",
        family="moe",
        n_layers=48,
        d_model=2048,
        n_heads=32,
        n_kv_heads=4,
        d_head=128,
        d_ff=768,
        vocab_size=151936,
        block_pattern=(("attn", "moe"),),
        norm="rmsnorm",
        qk_norm=True,
        mlp_act="silu",
        rope_theta=1000000.0,
        n_experts=128,
        top_k=8,
        tie_embeddings=False,
    )


def make_tiny_config() -> ArchConfig:
    return ArchConfig(
        name="qwen3-moe-30b-a3b-tiny",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_head=16,
        d_ff=32,
        vocab_size=256,
        block_pattern=(("attn", "moe"),),
        norm="rmsnorm",
        qk_norm=True,
        mlp_act="silu",
        rope_theta=1000000.0,
        n_experts=8,
        top_k=2,
        tie_embeddings=False,
    )
