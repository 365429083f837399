# Copied from src/repro/configs/xlstm_350m.py; `repro.` rewritten to `repro_torch.`.
"""xlstm-350m [ssm]: 24L d_model=1024 4H d_ff=0 vocab=50304
— sLSTM + mLSTM blocks (arXiv:2405.04517), 7:1 mLSTM:sLSTM ratio.

The xLSTM block contains its own up/down projections (proj_factor=2), so the
stack has no separate FFN (d_ff=0).
"""
from repro_torch.configs import ArchConfig

# one sLSTM per 8 blocks (xLSTM[7:1])
_PATTERN = tuple(
    (("slstm" if i == 0 else "mlstm"), "none") for i in range(8)
)


def make_config() -> ArchConfig:
    return ArchConfig(
        name="xlstm-350m",
        family="ssm",
        n_layers=24,
        d_model=1024,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,
        vocab_size=50304,
        block_pattern=_PATTERN,
        norm="layernorm",
        lstm_proj_factor=2.0,
        tie_embeddings=True,
    )


def make_tiny_config() -> ArchConfig:
    return ArchConfig(
        name="xlstm-350m-tiny",
        family="ssm",
        n_layers=8,        # one full period so both block kinds are exercised
        d_model=32,
        n_heads=2,
        n_kv_heads=2,
        d_ff=0,
        vocab_size=256,
        block_pattern=_PATTERN,
        norm="layernorm",
        lstm_proj_factor=2.0,
        tie_embeddings=True,
    )
