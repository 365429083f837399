"""The plain reference and the comparison that decides ``correct``.

Each architecture's forward is a file of its own, ``ref/<arch>.py``
(``arch`` as the configuration's file names it, ``dense`` where it names
none), with ``logits_at(cfg, w, tokens, rows, fp8)``: plain PyTorch in
float32 with TF32 off, built from this module's helpers, importing
nothing of the program.  It reads the weights the benchmark drew; the
served tokens it reads only to judge them.

``fp8=True`` is the control: the same forward with every linear layer's
inputs rounded to float8 e4m3 (activations per token, weights per output
column, each scaled to its largest magnitude), the step below bf16 that a
later change could be tempted by.
"""
from __future__ import annotations

import contextlib
from pathlib import Path
from typing import Dict, Sequence

import torch

import bench

REF = Path(__file__).resolve().parent / "ref"
FP8_MAX = 448.0          # largest finite float8 e4m3fn


@contextlib.contextmanager
def exact_f32():
    """Float32 products in float32: TF32 off for cuBLAS and cuDNN."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def _fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3, scaled along ``dim`` to its largest
    magnitude, back in float32."""
    scale = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _linear(x: torch.Tensor, w: torch.Tensor, fp8: bool) -> torch.Tensor:
    """x (S, in) @ w (in, out)."""
    if fp8:
        x, w = _fp8(x, -1), _fp8(w, 0)
    return x @ w


def logits_at(cfg: Dict, w: Dict, tokens: torch.Tensor, rows: Sequence[int],
              fp8: bool = False) -> torch.Tensor:
    """Float32 logits (len(rows), vocab) of the sequence ``tokens`` (1-D)
    at positions ``rows`` (row p predicts the token at p + 1), by the
    reference of the configuration's architecture."""
    ref = bench.load(REF / f"{cfg.get('arch', 'dense')}.py")
    return ref.logits_at(cfg, w, tokens, rows, fp8)


def gaps(ref_logits: torch.Tensor, chosen: torch.Tensor) -> torch.Tensor:
    """How far each chosen token's reference logit lies below the
    reference's best at its position (0 where it is the best)."""
    best = ref_logits.max(dim=-1).values
    return best - ref_logits.gather(-1, chosen.long()[:, None])[:, 0]
