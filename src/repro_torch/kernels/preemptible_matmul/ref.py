"""Plain PyTorch versions of the preemptible-matmul kernel (follow
``repro/kernels/preemptible_matmul/ref.py``), and the tolerance that holds
the kernel's f32 sums against them."""
from __future__ import annotations

import math

import torch

# elementwise tolerance factor of :func:`f32_sum_tolerance`
SUM_TOL_FACTOR = 8.0
# reduction rows that one tensor-core (wgmma) step adds before it rounds
TC_STEP = 16


def matmul_plain(x: torch.Tensor, y: torch.Tensor,
                 out_dtype=None) -> torch.Tensor:
    """x @ y in f32, cast to ``out_dtype`` (default ``x.dtype``)."""
    return (x.float() @ y.float()).to(out_dtype or x.dtype)


def matmul_partial_plain(x: torch.Tensor, y: torch.Tensor, acc: torch.Tensor,
                         k_start: int, k_end: int,
                         bk: int = 128) -> torch.Tensor:
    """A new accumulator: ``acc`` plus K tiles [k_start, k_end) of x @ y,
    one tile at a time in order, in ``acc``'s dtype (f32, or f64 for a
    reference).  ``acc`` may be larger than (M, N); its extra rows and
    columns are left as they are.

    Tile by tile, as the reference's interpret-mode grid sums, so that any
    split of the tiles into calls gives the same bits."""
    m, n, k = x.shape[0], y.shape[1], x.shape[1]
    out = acc.clone()
    for t in range(k_start, k_end):
        lo, hi = t * bk, min((t + 1) * bk, k)
        out[:m, :n] += x[:, lo:hi].to(acc.dtype) @ y[lo:hi].to(acc.dtype)
    return out


def f32_sum_tolerance(x: torch.Tensor, y: torch.Tensor, acc: torch.Tensor,
                      k_start: int, k_end: int, bk: int = 128) -> torch.Tensor:
    """Elementwise tolerance of an f32 accumulator after K tiles
    [k_start, k_end), against the plain version run in float64.

    Adding n products t_k into an f32 accumulator rounds each partial sum
    s_k to 2**-24 relative.  With rounding errors of either sign the total
    grows like 2**-24 * sqrt(sum s_k**2) <= 2**-24 * sqrt(n) * max |s_k|, in
    whatever order the products are added, and |s_k| stays within |acc| +
    |sum t| + sqrt(sum t**2) for data of either sign or of one sign.  The
    tolerance is ``SUM_TOL_FACTOR`` times that bound over the n = hi - lo
    reduction rows.

    bf16 inputs are summed on the tensor cores: each wgmma step adds
    ``TC_STEP`` = 16 exact products of bf16 values and the accumulator and
    rounds once, in a mode NVIDIA does not document.  Rounded toward zero,
    each of the ceil(n / 16) roundings errs by less than one f32 ulp of its
    result, 2**-23 relative, and all with the sign of the sum, so they add
    up linearly to at most ceil(n / 16) * 2**-23 * max |s_k|.  For bf16 the
    tolerance adds that term, 2 * ceil(n / 16) * 2**-24 * (the same
    magnitude).

    Dropping one K tile or the last ragged column, ignoring ``acc``, or
    rounding f32 inputs to TF32 each exceed the tolerance by more than 2x
    (``tests/test_torch_matmul.py`` simulates the f32 FMA chain and
    ``tests/test_torch_tensorcore_numerics.py`` the k16 steps)."""
    m, n, k = x.shape[0], y.shape[1], x.shape[1]
    lo, hi = k_start * bk, min(k_end * bk, k)
    rows = max(hi - lo, 0)
    mag = acc.abs().double()
    if hi > lo:
        xs, ys = x[:, lo:hi].double(), y[lo:hi].double()
        mag[:m, :n] += (xs @ ys).abs() + ((xs * xs) @ (ys * ys)).sqrt()
    factor = SUM_TOL_FACTOR * math.sqrt(rows + 1)
    if x.dtype == torch.bfloat16:
        factor += 2 * -(-rows // TC_STEP)
    return factor * 2.0 ** -24 * mag
