# Copied from src/repro/configs/hubert_xlarge.py; `repro.` rewritten to `repro_torch.`.
"""hubert-xlarge [audio]: 48L d_model=1280 16H (MHA kv=16) d_ff=5120
vocab=504 — encoder-only transformer (arXiv:2106.07447; wav2vec2 arch).

The CNN waveform frontend is a STUB: ``input_specs`` supplies precomputed
frame embeddings (batch, frames, d_model).  Training objective is the
HuBERT masked-frame prediction over a 504-entry codebook; no decode step
exists (decode shape cells are skipped for this arch).
"""
from repro_torch.configs import ArchConfig


def make_config() -> ArchConfig:
    return ArchConfig(
        name="hubert-xlarge",
        family="audio",
        n_layers=48,
        d_model=1280,
        n_heads=16,
        n_kv_heads=16,
        d_ff=5120,
        vocab_size=504,
        block_pattern=(("attn", "mlp"),),
        norm="layernorm",
        mlp_act="gelu",
        causal=False,
        encoder_only=True,
        embedding_inputs=True,
        tie_embeddings=False,
    )


def make_tiny_config() -> ArchConfig:
    return ArchConfig(
        name="hubert-xlarge-tiny",
        family="audio",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab_size=64,
        block_pattern=(("attn", "mlp"),),
        norm="layernorm",
        mlp_act="gelu",
        causal=False,
        encoder_only=True,
        embedding_inputs=True,
        tie_embeddings=False,
    )
