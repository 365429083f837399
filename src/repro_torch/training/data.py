# Copied from src/repro/training/data.py; `repro.` rewritten to `repro_torch.`.
"""Deterministic data pipeline.

Batches are a pure function of (seed, step): restart-exact without any
stored cursor beyond the step counter, which is precisely what fault-
tolerant resume needs (checkpoint stores only ``step``).  A file-backed
token corpus (memmap) is supported; otherwise a seeded synthetic stream of
Zipf-ish tokens is generated (CPU tests / dry runs).

For multi-host pods each data shard slices its rows from the global batch
(``shard_for``), so the global batch content is host-count independent —
elastic rescaling keeps the data order.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

import numpy as np

from repro_torch.configs import ArchConfig


@dataclasses.dataclass
class DataConfig:
    seq_len: int
    global_batch: int
    seed: int = 0
    corpus_path: Optional[str] = None   # memmap int32 token file


class TokenDataset:
    def __init__(self, cfg: DataConfig, arch: ArchConfig):
        self.cfg = cfg
        self.arch = arch
        self._corpus = None
        if cfg.corpus_path and os.path.exists(cfg.corpus_path):
            self._corpus = np.memmap(cfg.corpus_path, dtype=np.int32,
                                     mode="r")

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Pure function of step → bit-identical across restarts."""
        cfg, arch = self.cfg, self.arch
        b, s = cfg.global_batch, cfg.seq_len
        if self._corpus is not None:
            n_tok = (len(self._corpus) - 1) // s * s
            rng = np.random.default_rng((cfg.seed, step))
            starts = rng.integers(0, n_tok - s - 1, size=b)
            tokens = np.stack([self._corpus[i:i + s] for i in starts])
            labels = np.stack([self._corpus[i + 1:i + s + 1] for i in starts])
        else:
            rng = np.random.default_rng((cfg.seed, step))
            # Zipf-ish synthetic stream bounded to the vocab
            raw = rng.zipf(1.3, size=(b, s + 1)).astype(np.int64)
            toks = (raw % (arch.vocab_size - 2)) + 1
            tokens, labels = toks[:, :-1], toks[:, 1:]
        batch: Dict[str, np.ndarray] = {
            "tokens": tokens.astype(np.int32),
            "labels": labels.astype(np.int32),
        }
        if arch.embedding_inputs:
            rng2 = np.random.default_rng((cfg.seed, step, 7))
            batch["frames"] = rng2.standard_normal(
                (b, s, arch.d_model), dtype=np.float32)
            del batch["tokens"]
        if arch.img_tokens:
            rng3 = np.random.default_rng((cfg.seed, step, 11))
            batch["img_embeds"] = rng3.standard_normal(
                (b, arch.img_tokens, arch.d_vision), dtype=np.float32)
        return batch

    def shard_for(self, batch: Dict[str, np.ndarray], host_idx: int,
                  n_hosts: int) -> Dict[str, np.ndarray]:
        b = self.cfg.global_batch
        assert b % n_hosts == 0
        lo = (b // n_hosts) * host_idx
        hi = lo + b // n_hosts
        return {k: v[lo:hi] for k, v in batch.items()}
