# Copied from src/repro/configs/llama32_vision_11b.py; `repro.` rewritten to `repro_torch.`.
"""llama-3.2-vision-11b [vlm]: 40L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256 — cross-attn image layers every 5th layer (8 of 40).

The vision frontend is a STUB: ``input_specs`` supplies precomputed patch
embeddings (batch, img_tokens=1600, d_vision=1280); the model owns only the
projection into d_model and the cross-attention layers.
"""
from repro_torch.configs import ArchConfig

_PATTERN = tuple(
    (("cross_attn" if i == 4 else "attn"), "mlp") for i in range(5)
)


def make_config() -> ArchConfig:
    return ArchConfig(
        name="llama-3.2-vision-11b",
        family="vlm",
        n_layers=40,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab_size=128256,
        block_pattern=_PATTERN,
        norm="rmsnorm",
        mlp_act="silu",
        rope_theta=500000.0,
        img_tokens=1600,
        d_vision=1280,
        tie_embeddings=False,
    )


def make_tiny_config() -> ArchConfig:
    return ArchConfig(
        name="llama-3.2-vision-11b-tiny",
        family="vlm",
        n_layers=5,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=256,
        block_pattern=_PATTERN,
        norm="rmsnorm",
        mlp_act="silu",
        rope_theta=500000.0,
        img_tokens=8,
        d_vision=16,
        tie_embeddings=False,
    )
