"""Model registry: arch name → bound model functions."""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable

from repro_torch import configs
from repro_torch.configs import ArchConfig
from repro_torch.models import transformer


@dataclasses.dataclass(frozen=True)
class Model:
    """Config-bound model entry points."""
    cfg: ArchConfig
    init_params: Callable
    train_loss: Callable
    prefill: Callable
    decode_step: Callable
    init_cache: Callable
    cache_spec: Callable


def build(cfg: ArchConfig) -> Model:
    return Model(
        cfg=cfg,
        init_params=functools.partial(transformer.init_params, cfg),
        train_loss=functools.partial(transformer.train_loss, cfg=cfg),
        prefill=functools.partial(transformer.prefill, cfg=cfg),
        decode_step=functools.partial(transformer.decode_step, cfg=cfg),
        init_cache=functools.partial(transformer.init_cache, cfg),
        cache_spec=functools.partial(transformer.cache_spec, cfg),
    )


def get_model(name: str, tiny: bool = False) -> Model:
    cfg = configs.get_tiny_config(name) if tiny else configs.get_config(name)
    return build(cfg)
