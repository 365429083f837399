# Copied from src/repro/configs/qwen3_8b.py; `repro.` rewritten to `repro_torch.`.
"""qwen3-8b [dense]: 36L d_model=4096 32H (GQA kv=8) d_ff=12288 vocab=151936
— qk_norm, GQA (hf:Qwen/Qwen3-8B)."""
from repro_torch.configs import ArchConfig


def make_config() -> ArchConfig:
    return ArchConfig(
        name="qwen3-8b",
        family="dense",
        n_layers=36,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_head=128,
        d_ff=12288,
        vocab_size=151936,
        block_pattern=(("attn", "mlp"),),
        norm="rmsnorm",
        qk_norm=True,
        mlp_act="silu",
        rope_theta=1000000.0,
        tie_embeddings=False,
    )


def make_tiny_config() -> ArchConfig:
    return ArchConfig(
        name="qwen3-8b-tiny",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_head=16,
        d_ff=128,
        vocab_size=256,
        block_pattern=(("attn", "mlp"),),
        norm="rmsnorm",
        qk_norm=True,
        mlp_act="silu",
        rope_theta=1000000.0,
        tie_embeddings=False,
    )
