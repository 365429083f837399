# Copied from src/repro/configs/olmo_1b.py; `repro.` rewritten to `repro_torch.`.
"""olmo-1b [dense]: 16L d_model=2048 16H (MHA kv=16) d_ff=8192 vocab=50304.

Non-parametric LayerNorm (arXiv:2402.00838), SwiGLU MLP, RoPE, tied embeddings.
"""
from repro_torch.configs import ArchConfig


def make_config() -> ArchConfig:
    return ArchConfig(
        name="olmo-1b",
        family="dense",
        n_layers=16,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=8192,
        vocab_size=50304,
        block_pattern=(("attn", "mlp"),),
        norm="layernorm_np",
        mlp_act="silu",
        tie_embeddings=True,
    )


def make_tiny_config() -> ArchConfig:
    return ArchConfig(
        name="olmo-1b-tiny",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab_size=256,
        block_pattern=(("attn", "mlp"),),
        norm="layernorm_np",
        mlp_act="silu",
        tie_embeddings=True,
    )
