"""The paper's preemption point at kernel level: a GEMM that stops and
resumes at K-tile boundaries, with the partial accumulator as the
checkpointed ACCQ state (port of ``examples/preemptible_kernel_demo.py``).

    PYTHONPATH=src python -m repro_torch.examples.preemptible_kernel_demo --device cpu
    PYTHONPATH=src python -m repro_torch.examples.preemptible_kernel_demo --full

Without ``--full`` it runs the reference's 512x1024x384 f32 GEMM in quanta
of ``--quantum`` K tiles and prints the reference's lines.  ``--full`` runs
qwen3-8b's down projection for one 2048-token prefill period, x (2048,
d_ff) @ y (d_ff, d_model) in bf16: once uninterrupted, once in quanta.  The
two accumulators must be bitwise equal, both must lie within
``f32_sum_tolerance`` of the plain version run in float64, and on the card
each launch is timed by CUDA events.  Runs on ``cuda`` unless ``--device
cpu`` is given.
"""
from __future__ import annotations

import argparse
from typing import Callable, Optional

import torch

from repro_torch.configs import get_config
from repro_torch.kernels.preemptible_matmul import (advance, f32_sum_tolerance,
                                                    finish,
                                                    matmul_partial_plain,
                                                    matmul_plain, start)
from repro_torch.params import resolve_device

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
FULL_ARCH = "qwen3-8b"
FULL_TOKENS = 2048     # the longest prompt the smoke serves: one prefill


def full_shape(arch: str = FULL_ARCH, tokens: int = FULL_TOKENS):
    """(M, K, N) of the down projection of one ``tokens``-long prefill."""
    cfg = get_config(arch)
    return tokens, cfg.d_ff, cfg.d_model


def timed(fn: Callable, device: torch.device):
    """``fn()`` and its ms by CUDA events on the card (None on the CPU)."""
    if device.type != "cuda":
        return fn(), None
    begin = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    begin.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, begin.elapsed_time(end)


def reference_demo(x: torch.Tensor, y: torch.Tensor, quantum: int) -> float:
    """The reference demo: quanta of ``quantum`` K tiles, then the error of
    the finished product against the plain version."""
    ck = start(x, y)
    m, k = x.shape
    print(f"GEMM {m}x{k}x{y.shape[1]}: {ck.n_ktiles} K-tiles; "
          f"checkpoint = {ck.context_bytes()/1024:.0f} KiB accumulator")
    step = 0
    while not ck.done:
        ck = advance(ck, x, y, n_tiles=quantum)
        step += 1
        print(f"  quantum {step}: k_tile={ck.k_tile}/{ck.n_ktiles} "
              f"(preempt here — context is ACCQ + tile index)")
    out = finish(ck)
    err = float((out - matmul_plain(x, y, torch.float32)).abs().max())
    print(f"resumed result matches uninterrupted GEMM: max|err|={err:.2e}")
    if not err < 1e-3:
        raise AssertionError(f"max|err| {err:.3e} against the plain version")
    return err


def preempted_vs_uninterrupted(x: torch.Tensor, y: torch.Tensor,
                               quantum: int) -> dict:
    """Run the GEMM in one launch, then in quanta of ``quantum`` K tiles;
    raise unless the two accumulators are bitwise equal and both lie within
    ``f32_sum_tolerance`` of the float64 plain version."""
    dev = x.device
    ck0 = start(x, y)
    one, one_ms = timed(lambda: advance(ck0, x, y, n_tiles=ck0.n_ktiles), dev)
    print(f"uninterrupted: 1 launch, {ck0.n_ktiles} K tiles, "
          f"{_ms(one_ms)}")
    ck, quanta_ms = ck0, []
    while not ck.done:
        ck, ms = timed(lambda c=ck: advance(c, x, y, n_tiles=quantum), dev)
        quanta_ms.append(ms)
        print(f"  quantum {len(quanta_ms)}: k_tile={ck.k_tile}/{ck.n_ktiles} "
              f"{_ms(ms)}, checkpoint {ck.context_bytes()} B")
    if not torch.equal(one.acc, ck.acc):
        raise AssertionError("the preempted accumulator differs from the "
                             "uninterrupted one")
    exact = matmul_partial_plain(x, y, ck0.acc.double(), 0, ck0.n_ktiles)
    tol = f32_sum_tolerance(x, y, ck0.acc, 0, ck0.n_ktiles)
    ratio = float(((one.acc.double() - exact).abs() / tol.clamp_min(1e-300))
                  .max())
    err = float((one.acc.double() - exact).abs().max())
    if ratio > 1.0:
        raise AssertionError(f"max|err| {err:.3e} is {ratio:.2f}x the f32 "
                             "summation tolerance")
    total = None if one_ms is None else sum(quanta_ms)
    print(f"preempted: {len(quanta_ms)} launches, {_ms(total)} in all; "
          f"bitwise equal to uninterrupted; max|err| vs float64 plain "
          f"{err:.3e} ({ratio:.3f} of the tolerance)")
    return dict(shape=[x.shape[0], x.shape[1], y.shape[1]],
                dtype=str(x.dtype).split(".")[1], n_ktiles=ck0.n_ktiles,
                quantum=quantum, n_quanta=len(quanta_ms),
                checkpoint_bytes=ck.context_bytes(), bitwise_equal=True,
                max_abs_err=err, err_over_tol=ratio, uninterrupted_ms=one_ms,
                quanta_ms=quanta_ms, quanta_sum_ms=total)


def _ms(ms: Optional[float]) -> str:
    return "time not measured (CPU)" if ms is None else f"{ms:.4f} ms"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default=None, choices=sorted(DTYPES),
                    help="default float32, or bfloat16 with --full")
    ap.add_argument("--quantum", type=int, default=2,
                    help="K tiles per scheduling quantum")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--full", action="store_true",
                    help=f"{FULL_ARCH}'s down projection of one "
                         f"{FULL_TOKENS}-token prefill")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    dtype = DTYPES[args.dtype or ("bfloat16" if args.full else "float32")]
    m, k, n = full_shape() if args.full else (512, 1024, 384)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    x = torch.randn((m, k), generator=gen, device=device, dtype=dtype)
    y = torch.randn((k, n), generator=gen, device=device, dtype=dtype)
    if not args.full:
        return dict(max_abs_err=reference_demo(x, y, args.quantum))
    print(f"{FULL_ARCH} down projection, {FULL_TOKENS}-token prefill: "
          f"x {m}x{k} @ y {k}x{n}, {str(dtype).split('.')[1]}")
    return preempted_vs_uninterrupted(x, y, args.quantum)


if __name__ == "__main__":
    main()
