# Copied from src/repro/configs/deepseek_coder_33b.py; `repro.` rewritten to `repro_torch.`.
"""deepseek-coder-33b [dense]: 62L d_model=7168 56H (GQA kv=8) d_ff=19200
vocab=32256 — llama architecture (arXiv:2401.14196)."""
from repro_torch.configs import ArchConfig


def make_config() -> ArchConfig:
    return ArchConfig(
        name="deepseek-coder-33b",
        family="dense",
        n_layers=62,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        d_ff=19200,
        vocab_size=32256,
        block_pattern=(("attn", "mlp"),),
        norm="rmsnorm",
        mlp_act="silu",
        rope_theta=100000.0,
        tie_embeddings=False,
    )


def make_tiny_config() -> ArchConfig:
    return ArchConfig(
        name="deepseek-coder-33b-tiny",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=8,
        n_kv_heads=2,
        d_ff=160,
        vocab_size=256,
        block_pattern=(("attn", "mlp"),),
        norm="rmsnorm",
        mlp_act="silu",
        rope_theta=100000.0,
        tie_embeddings=False,
    )
