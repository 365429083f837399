# Copied from src/repro/configs/qwen1_5_4b.py; `repro.` rewritten to `repro_torch.`.
"""qwen1.5-4b [dense]: 40L d_model=2560 20H (MHA kv=20) d_ff=6912
vocab=151936 — QKV bias (hf:Qwen/Qwen1.5 family)."""
from repro_torch.configs import ArchConfig


def make_config() -> ArchConfig:
    return ArchConfig(
        name="qwen1.5-4b",
        family="dense",
        n_layers=40,
        d_model=2560,
        n_heads=20,
        n_kv_heads=20,
        d_ff=6912,
        vocab_size=151936,
        block_pattern=(("attn", "mlp"),),
        norm="rmsnorm",
        qkv_bias=True,
        mlp_act="silu",
        tie_embeddings=False,
    )


def make_tiny_config() -> ArchConfig:
    return ArchConfig(
        name="qwen1.5-4b-tiny",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab_size=256,
        block_pattern=(("attn", "mlp"),),
        norm="rmsnorm",
        qkv_bias=True,
        mlp_act="silu",
        tie_embeddings=False,
    )
