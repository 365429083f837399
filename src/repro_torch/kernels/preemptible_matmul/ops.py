"""Wrapper of the preemptible-matmul kernel (``csrc/preemptible_matmul.cu``)
and the checkpoint built on it (follows
``repro/kernels/preemptible_matmul/ops.py``).

* ``matmul(x, y)``            — ordinary full GEMM, one launch.
* ``matmul_resumable(...)``   — run a K-tile range into an accumulator;
                                checkpoint = (accumulator, k_tile).
* ``MatmulCheckpoint``        — the ACCQ-analogue context object.

Two kernels, chosen by :func:`kernel_variant` from the dtype alone:
``"wgmma"`` (tensor cores fed by TMA) for bf16, ``"cuda_core"`` (one
``fmaf`` per product, no TF32) for f32.  Unlike the reference, x and y are
never padded to tiles: the kernels take the ragged edges (TMA's zero fill,
or masks) and read x and y through their strides.  The checkpoint's
accumulator keeps the reference's padded (Mp, Np) shape, so its
``context_bytes`` are the same; the padding stays 0.

A launch is the custom op ``prema::matmul_resumable``, which writes the
accumulator it is given, as the attention kernels' launches are ops: fake
tensors trace through it (its fake implementation writes nothing), and
its FLOP formula counts the plain version's products over the K range.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import DTYPE_CODES, cuda_lib, tma_operand
from repro_torch.kernels.preemptible_matmul.ref import matmul_partial_plain

WGMMA_BK = 64   # reduction rows of one stage of the wgmma kernel
launches = 0   # kernel launches by this wrapper in this process
variant_launches = {"wgmma": 0, "cuda_core": 0}   # the same, by kernel


def _n_ktiles(k: int, bk: int) -> int:
    return -(-k // bk)


def kernel_variant(dtype: torch.dtype, bk: int) -> str:
    """The kernel that a CUDA launch of this dtype runs.  A bf16 launch must
    start on one of the wgmma kernel's 64-row stages, so that every output
    element sees the same tensor-core steps however the K range is split:
    a bf16 ``bk`` that is not a multiple of 64 raises ``ValueError``."""
    if dtype != torch.bfloat16:
        return "cuda_core"
    if bk % WGMMA_BK:
        raise ValueError(f"bf16 on the card needs bk a multiple of "
                         f"{WGMMA_BK}, got {bk}")
    return "wgmma"


def matmul_resumable(x: torch.Tensor, y: torch.Tensor, acc_in: torch.Tensor,
                     k_start: int, k_end: int, bk: int = 128,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (M,K), y (K,N), f32 or bf16 alike, any strides; acc_in (Ma,Na) f32
    with Ma >= M, Na >= N.  Adds K tiles [k_start, k_end) (units of ``bk``
    rows of y) of x @ y to ``acc_in`` and returns the result, written into
    ``out`` (a contiguous f32 tensor shaped like ``acc_in``, which may be
    ``acc_in`` itself) or else a new tensor.  ``acc_in`` is left as it was
    unless it is ``out``.  On the card a bf16 ``bk`` must be a multiple of
    64 (:func:`kernel_variant`), and the wgmma kernel reads x and y by TMA:
    an input whose strides TMA cannot take (column stride not 1, row stride
    not a multiple of 8 elements, base not 16-byte aligned) is copied first
    into rows padded to 16 bytes (:func:`repro_torch.kernels.tma_operand`).
    """
    if x.dim() != 2 or y.dim() != 2 or acc_in.dim() != 2:
        raise ValueError(f"x, y and acc must be matrices, got x{tuple(x.shape)}"
                         f" y{tuple(y.shape)} acc{tuple(acc_in.shape)}")
    m, k = x.shape
    n = y.shape[1]
    if y.shape[0] != k:
        raise ValueError(f"x{tuple(x.shape)} @ y{tuple(y.shape)}: inner "
                         "dimensions differ")
    if x.dtype != y.dtype or x.dtype not in DTYPE_CODES:
        raise ValueError(f"x and y must both be f32 or both bf16, got "
                         f"{x.dtype} and {y.dtype}")
    if acc_in.dtype != torch.float32:
        raise ValueError(f"the accumulator must be f32, got {acc_in.dtype}")
    if acc_in.shape[0] < m or acc_in.shape[1] < n:
        raise ValueError(f"accumulator {tuple(acc_in.shape)} smaller than the "
                         f"output ({m}, {n})")
    if not (x.device == y.device == acc_in.device) or x.device.type not in (
            "cpu", "cuda"):
        raise ValueError("x, y and acc must lie on one CPU or CUDA device")
    if out is not None and (
            out.shape != acc_in.shape or out.dtype != torch.float32
            or out.device != acc_in.device or not out.is_contiguous()):
        raise ValueError("out must be a contiguous f32 tensor shaped like acc "
                         "on its device")
    if bk < 1:
        raise ValueError(f"bk must be positive, got {bk}")
    if not 0 <= k_start <= k_end <= _n_ktiles(k, bk):
        raise ValueError(f"K tiles [{k_start}, {k_end}) outside the "
                         f"{_n_ktiles(k, bk)} tiles of {bk} in K={k}")
    if out is None:
        out = torch.empty_like(acc_in, memory_format=torch.contiguous_format)
    if k_start == k_end:
        return out.copy_(acc_in)
    if x.device.type == "cpu":
        return out.copy_(matmul_partial_plain(x, y, acc_in, k_start, k_end, bk))
    kernel_variant(x.dtype, bk)    # raises for a bf16 bk off the stages
    torch.ops.prema.matmul_resumable(x, y, acc_in, out, k_start * bk,
                                     min(k_end * bk, k))
    return out


@torch.library.custom_op("prema::matmul_resumable", mutates_args=("out",),
                         device_types="cuda")
def _launch(x: torch.Tensor, y: torch.Tensor, acc_in: torch.Tensor,
            out: torch.Tensor, lo: int, hi: int) -> None:
    """One launch: ``out = acc_in + x[:, lo:hi] @ y[lo:hi]`` (``out`` may
    be ``acc_in``)."""
    global launches
    m, k = x.shape
    n = y.shape[1]
    variant = kernel_variant(x.dtype, WGMMA_BK)
    lib, stream = cuda_lib.library(), torch.cuda.current_stream(
        x.device).cuda_stream
    if variant == "wgmma":
        x, y = tma_operand(x), tma_operand(y)
    ptrs = (x.data_ptr(), y.data_ptr(), acc_in.data_ptr(), out.data_ptr())
    strides = cuda_lib.strides_arg(x, y, acc_in, out)
    acc_m, acc_n = acc_in.shape
    if variant == "wgmma":
        err = lib.prema_matmul_resumable_wgmma(
            *ptrs, m, n, k, acc_m, acc_n, lo, hi, strides, stream)
    else:
        err = lib.prema_matmul_resumable(
            DTYPE_CODES[x.dtype], *ptrs, m, n, acc_m, acc_n, lo, hi, strides,
            stream)
    cuda_lib.check(err, f"matmul_resumable ({variant})")
    launches += 1
    variant_launches[variant] += 1


@_launch.register_fake
def _(x, y, acc_in, out, lo, hi):
    return None


@register_flop_formula(torch.ops.prema.matmul_resumable)
def _flops(x_shape, y_shape, acc_shape, dst_shape, lo, hi, *args, **kwargs):
    """The plain version's: an (M, N) product over ``hi - lo`` rows."""
    return 2 * x_shape[0] * y_shape[1] * (hi - lo)


@dataclasses.dataclass
class MatmulCheckpoint:
    """Checkpointed GEMM context: partial accumulator + progress index."""
    acc: torch.Tensor       # (Mp, Np) f32, padded
    k_tile: int             # next K tile to execute
    n_ktiles: int
    shape: Tuple[int, int]  # un-padded (M, N)

    @property
    def done(self) -> bool:
        return self.k_tile >= self.n_ktiles

    def context_bytes(self) -> int:
        return int(self.acc.numel() * self.acc.element_size())


def start(x: torch.Tensor, y: torch.Tensor, bm: int = 128, bn: int = 128,
          bk: int = 128) -> MatmulCheckpoint:
    """A checkpoint before the first K tile: a zero accumulator padded to
    multiples of (bm, bn)."""
    m, n = x.shape[0], y.shape[1]
    acc = torch.zeros((m + (-m) % bm, n + (-n) % bn), dtype=torch.float32,
                      device=x.device)
    return MatmulCheckpoint(acc=acc, k_tile=0,
                            n_ktiles=_n_ktiles(x.shape[1], bk), shape=(m, n))


def advance(ck: MatmulCheckpoint, x: torch.Tensor, y: torch.Tensor,
            n_tiles: int, bk: int = 128) -> MatmulCheckpoint:
    """Execute up to ``n_tiles`` more K tiles (one scheduling quantum) into
    a new checkpoint; ``ck`` is left as it was."""
    if (x.shape[0], y.shape[1]) != ck.shape or \
            _n_ktiles(x.shape[1], bk) != ck.n_ktiles:
        raise ValueError(f"x{tuple(x.shape)} @ y{tuple(y.shape)} with bk {bk} "
                         f"is not the GEMM of this checkpoint ({ck.shape}, "
                         f"{ck.n_ktiles} K tiles)")
    k_end = min(ck.n_ktiles, ck.k_tile + n_tiles)
    acc = matmul_resumable(x, y, ck.acc, ck.k_tile, k_end, bk=bk)
    return MatmulCheckpoint(acc=acc, k_tile=k_end, n_ktiles=ck.n_ktiles,
                            shape=ck.shape)


def finish(ck: MatmulCheckpoint, out_dtype=torch.float32) -> torch.Tensor:
    """The finished (M, N) product, cast to ``out_dtype``."""
    if not ck.done:
        raise ValueError(f"checkpoint at K tile {ck.k_tile} of {ck.n_ktiles} "
                         "is not finished")
    m, n = ck.shape
    return ck.acc[:m, :n].to(out_dtype, copy=True)


def matmul(x: torch.Tensor, y: torch.Tensor, bk: int = 128,
           out_dtype=None) -> torch.Tensor:
    """Full GEMM through the preemptible kernel (single launch), cast to
    ``out_dtype`` (default ``x.dtype``)."""
    acc = torch.zeros((x.shape[0], y.shape[1]), dtype=torch.float32,
                      device=x.device)
    acc = matmul_resumable(x, y, acc, 0, _n_ktiles(x.shape[1], bk), bk=bk,
                           out=acc)
    return acc.to(out_dtype or x.dtype)
