#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --phases kernels,gemm   # a subset, no summary

Phases, each printing one JSON line; any failure exits non-zero:

1. device: the card's name and power limit, torch, the kernel build
   (``nvcc`` from the sources in this checkout), and per tensor-core
   kernel and for decode its registers, stack, local memory and its
   HGMMA, UTMALDG and LDGSTS (cp.async) instructions (``cuobjdump``);
2. each attention kernel against its plain PyTorch version on the card
   at the serving path's shapes (B 1, Hq 32, Hkv 8, D 128; bf16 and f32;
   flash runs its wgmma kernel in bf16 and its CUDA-core kernel in f32;
   decode also at deepseek-coder-33b's Hq 56), with kernel, plain and
   library (SDPA, a yardstick the port never calls) times by CUDA events
   and the card's bound; for decode also device times from CUDA-graph
   replays, a bitwise run-to-run check, and one call with a device
   ``pos`` captured in a CUDA graph and replayed at four positions;
3. the preemptible GEMM against its plain version run in float64, at the
   reference test's shapes and qwen3-8b's full-width down projection, over
   the whole K range and a middle range seeded from a non-zero
   accumulator, f32 (CUDA-core kernel) and bf16 (wgmma kernel); timed at
   full width beside cuBLAS;
4. tiny qwen3-8b, olmo-1b and deepseek-coder-33b in f32 on the card
   against the same weights on the CPU;
5. the serving path: the PREMA ``ServingEngine`` serving 8 requests on
   full-width qwen3-8b in bf16, checked against isolated runs, with the
   kernels' launch counts, per kernel variant, checked against the
   executor's step counts;
6. the GEMM path: the preemptible-kernel demo at full width
   (``repro_torch.examples.preemptible_kernel_demo --full``), one
   uninterrupted launch and 48 preempted quanta that must agree bit for
   bit, with its launch count (all on the wgmma kernel) checked.

Then a ``{"kernels": [...]}`` line and, last, the device line.  Without a
CUDA device, or without the repository beside it, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import os

# cuBLAS determinism needs this before CUDA starts
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import argparse
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12                     # H100 SXM data sheet
PEAK_OPS = {torch.bfloat16: 989e12,           # tensor cores, dense
            torch.float32: 67e12}             # f32 outside the tensor cores
# kernel vs plain on the card, as (atol, rtol).  The reference is the plain
# version run in f32 on the same values (bf16 inputs upcast exactly).  Both
# sum in f32, in different orders.  A bf16 kernel that keeps P in f32 (the
# decode kernel) rounds its f32 result once, so it must lie within half a
# bf16 ulp (at most 2**-8 relative) of the f32 reference, plus f32
# summation error: tighter than one ulp of the plain version's bf16 output,
# and missed by truncation or a dropped key tile.  The bf16 flash kernel
# also rounds P to bf16 before P @ V, as the JAX model does: it is held to
# ``bf16_tolerance`` (kernels/flash_attention/ref.py), 1e-5 + 2**-8 |ref| +
# 2**-8 (P @ |V|), which a dropped key tile, a causal mask one key off or a
# wrong KV head each exceed (tests/test_torch_tensorcore_numerics.py).
TOL = {torch.float32: (3e-4, 3e-4), torch.bfloat16: (1e-5, 2.0 ** -8)}
# The preemptible GEMM is held elementwise to ``f32_sum_tolerance``
# (kernels/preemptible_matmul/ref.py) against its plain version run in
# float64: 8 * sqrt(n + 1) * 2**-24 * (|acc| + |x @ y| + sqrt(x**2 @ y**2))
# over the n reduction rows of the range, the growth of f32 rounding error
# over n additions.  Dropping a K tile or the last ragged K column, ignoring
# acc_in, or TF32 products each exceed it (tests/test_torch_matmul.py
# simulates each on the CPU, and the tensor cores' k16 steps in
# tests/test_torch_tensorcore_numerics.py).
GEMM_SHAPES = [(128, 128, 128), (256, 384, 512), (100, 200, 300),
               (64, 1000, 72), (1, 129, 1), (257, 64, 130)]
TINY_TOL = 1e-4
B, HQ, HKV, D = 1, 32, 8, 128
L2_BYTES = 50 * 2**20


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------
# timing
# --------------------------------------------------------------------------
def time_ms(fn, sets, reps: int = 20) -> float:
    """Mean ms of ``fn(*inputs)`` by CUDA events, rotating over ``sets``
    so each call finds its inputs outside the L2 cache.  The calls are
    issued back to back from Python, so for a kernel shorter than its
    wrapper's host work this is the host's issue rate: host plus device."""
    for s in sets[:2]:
        fn(*s)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fn(*sets[i % len(sets)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, sets, reps: int = 20, replays: int = 5) -> float:
    """Device ms per call of ``fn(*inputs)``: ``reps`` calls, rotating over
    ``sets``, captured once in a CUDA graph and replayed ``replays`` times
    between two CUDA events.  One replay is one host call, so the host's
    issue of each call drops out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):       # warm-up off the capture
        for s in sets[:2]:
            fn(*s)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fn(*sets[i % len(sets)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def n_copies(set_bytes: int) -> int:
    return int(min(16, max(2, -(-3 * L2_BYTES // set_bytes))))


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def tolerance(ref: torch.Tensor, tol: tuple) -> torch.Tensor:
    atol, rtol = tol
    return atol + rtol * ref.float().abs()


def over_tol(a: torch.Tensor, b: torch.Tensor, tol: torch.Tensor) -> float:
    """max |a - b| / tol: at most 1 where ``a`` is within tolerance."""
    return float(((a.float() - b.float()).abs() / tol).max())


def as_f32(*ts):
    return tuple(t.float() for t in ts)


# --------------------------------------------------------------------------
# phase 2: the attention kernels against their plain versions
# --------------------------------------------------------------------------
def _model_layout(gen, b, t, h, d, dtype):
    """A (B,H,T,D) view of a (B,T,H,D) tensor, as the model hands it over."""
    x = torch.randn((b, t, h, d), generator=gen, device="cuda", dtype=dtype)
    return x.transpose(1, 2)


def flash_case(gen, dtype, s, causal):
    from repro_torch.kernels.flash_attention import (bf16_tolerance,
                                                     flash_attention,
                                                     flash_attention_plain)
    from repro_torch.kernels.flash_attention.ops import kernel_variant
    F = torch.nn.functional
    q = _model_layout(gen, B, s, HQ, D, dtype)
    k = _model_layout(gen, B, s, HKV, D, dtype)
    v = _model_layout(gen, B, s, HKV, D, dtype)
    out = flash_attention(q, k, v, causal)
    ref = flash_attention_plain(*as_f32(q, k, v), causal)
    variant = kernel_variant(dtype, D)
    if variant == "wgmma":
        bound, tol_name = bf16_tolerance(q, k, v, causal), "bf16_tolerance"
    else:
        bound, tol_name = tolerance(ref, TOL[dtype]), f"{TOL[dtype]}"
    ratio = over_tol(out, ref, bound)
    torch.cuda.synchronize()
    err = max_err(out, ref)
    sets = [(q, k, v)] + [tuple(_model_layout(gen, B, s, h, D, dtype)
                                for h in (HQ, HKV, HKV))
                          for _ in range(n_copies(nbytes(q, k, v)) - 1)]
    pairs = s * (s + 1) // 2 if causal else s * s
    ops = 4 * B * HQ * D * pairs
    moved = nbytes(q, k, v, out)
    t_ops, t_bytes = ops / PEAK_OPS[dtype], moved / HBM_BYTES_PER_S
    row = dict(
        kernel="flash_attention", variant=variant,
        dtype=str(dtype).split(".")[1], S=s, T=s, causal=causal,
        max_abs_err=err, tolerance=tol_name, err_over_tol=ratio,
        ok=ratio <= 1.0,
        ms=time_ms(lambda a, b_, c: flash_attention(a, b_, c, causal), sets),
        plain_ms=time_ms(lambda a, b_, c: flash_attention_plain(a, b_, c,
                                                                causal), sets),
        library_ms=time_ms(lambda a, b_, c: F.scaled_dot_product_attention(
            a, b_, c, is_causal=causal, enable_gqa=True), sets),
        bound_ms=max(t_ops, t_bytes) * 1e3,
        bound_by="operations" if t_ops >= t_bytes else "bytes")
    return row


def decode_case(gen, dtype, t, pos, hq=HQ):
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_plain)
    F = torch.nn.functional

    def inputs():
        q = torch.randn((B, hq, D), generator=gen, device="cuda", dtype=dtype)
        return (q, _model_layout(gen, B, t, HKV, D, dtype),
                _model_layout(gen, B, t, HKV, D, dtype))
    q, k, v = inputs()
    out = decode_attention(q, k, v, pos)
    again = decode_attention(q, k, v, pos)
    ref = decode_attention_plain(*as_f32(q, k, v), pos)
    torch.cuda.synchronize()
    err, tol = max_err(out, ref), TOL[dtype]
    ratio = over_tol(out, ref, tolerance(ref, tol))
    bitwise = bool(torch.equal(out, again))
    live = 2 * B * HKV * (pos + 1) * D * k.element_size()
    sets = [(q, k, v)] + [inputs() for _ in range(n_copies(live) - 1)]
    ops = 4 * B * hq * D * (pos + 1)
    moved = nbytes(q, out) + live
    t_ops, t_bytes = ops / PEAK_OPS[dtype], moved / HBM_BYTES_PER_S

    def library(q_, k_, v_):
        return F.scaled_dot_product_attention(
            q_[:, :, None], k_[:, :, :pos + 1], v_[:, :, :pos + 1],
            enable_gqa=True)
    return dict(
        kernel="decode_attention", dtype=str(dtype).split(".")[1], Hq=hq,
        T=t, pos=pos, max_abs_err=err, tolerance=f"{tol}", err_over_tol=ratio,
        bitwise_run_to_run=bitwise, ok=ratio <= 1.0 and bitwise,
        ms=time_ms(lambda a, b_, c: decode_attention(a, b_, c, pos), sets),
        plain_ms=time_ms(lambda a, b_, c: decode_attention_plain(a, b_, c,
                                                                 pos), sets),
        library_ms=time_ms(library, sets),
        device_ms=graph_ms(lambda a, b_, c: decode_attention(a, b_, c, pos),
                           sets),
        library_device_ms=graph_ms(library, sets),
        bound_ms=max(t_ops, t_bytes) * 1e3,
        bound_by="operations" if t_ops >= t_bytes else "bytes")


def decode_graph_case(gen, dtype, t=2560, positions=(0, 255, 2047, 2559)):
    """One decode call with a device ``pos`` captured in a CUDA graph, then
    replayed after writing each of ``positions`` into that tensor: the
    grid must not depend on pos.  Each replay is held to the plain version
    at its pos and must equal a call with the host int bit for bit."""
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_plain)
    q = torch.randn((B, HQ, D), generator=gen, device="cuda", dtype=dtype)
    k = _model_layout(gen, B, t, HKV, D, dtype)
    v = _model_layout(gen, B, t, HKV, D, dtype)
    pos = torch.zeros((), dtype=torch.int32, device="cuda")
    decode_attention(q, k, v, pos)      # warm-up outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = decode_attention(q, k, v, pos)
    rows = []
    for p in positions:
        pos.fill_(p)
        graph.replay()
        ref = decode_attention_plain(*as_f32(q, k, v), p)
        ratio = over_tol(out, ref, tolerance(ref, TOL[dtype]))
        same = bool(torch.equal(out, decode_attention(q, k, v, p)))
        rows.append(dict(pos=p, max_abs_err=max_err(out, ref),
                         err_over_tol=ratio, equals_host_pos=same,
                         ok=ratio <= 1.0 and same))
    return dict(kernel="decode_attention", dtype=str(dtype).split(".")[1],
                T=t, tolerance=f"{TOL[dtype]}", replays=rows,
                ok=all(r["ok"] for r in rows))


def phase_kernels():
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for s in (37, 1024, 2048):
            for causal in (True, False):
                rows.append(flash_case(gen, dtype, s, causal))
                emit("kernel_check", **rows[-1])
        for t in (256, 2560):
            for pos in sorted({0, 255, t * 4 // 5, t - 1}):
                rows.append(decode_case(gen, dtype, t, pos))
                emit("kernel_check", **rows[-1])
        # deepseek-coder-33b's group of 7 query heads per KV head
        rows.append(decode_case(gen, dtype, 2560, 2048, hq=56))
        emit("kernel_check", **rows[-1])
    graphs = [decode_graph_case(gen, dtype)
              for dtype in (torch.bfloat16, torch.float32)]
    for g in graphs:
        emit("decode_graph", **g)
    bad = [r for r in rows + graphs if not r["ok"]]
    if bad:
        raise SystemExit(f"kernels disagree with their plain versions: {bad}")
    return rows


# --------------------------------------------------------------------------
# phase 3: the preemptible GEMM against its plain version
# --------------------------------------------------------------------------
def gemm_case(gen, dtype, shape, timed):
    from repro_torch.kernels.preemptible_matmul import (f32_sum_tolerance,
                                                        matmul_partial_plain,
                                                        matmul_resumable,
                                                        start)
    from repro_torch.kernels.preemptible_matmul.ops import kernel_variant
    m, k, n = shape

    def inputs():
        return (torch.randn((m, k), generator=gen, device="cuda", dtype=dtype),
                torch.randn((k, n), generator=gen, device="cuda", dtype=dtype))
    x, y = inputs()
    ck = start(x, y)
    nk, rows = ck.n_ktiles, []
    for name, ks, ke in (("full", 0, nk),
                         ("middle", nk // 3, nk // 3 + max(1, nk // 3))):
        acc = ck.acc if name == "full" else torch.randn(
            ck.acc.shape, generator=gen, device="cuda")
        out = matmul_resumable(x, y, acc, ks, ke)
        exact = matmul_partial_plain(x, y, acc.double(), ks, ke)
        tol = f32_sum_tolerance(x, y, acc, ks, ke)
        torch.cuda.synchronize()
        diff = (out.double() - exact).abs()
        rows.append(dict(
            kernel="preemptible_matmul", variant=kernel_variant(dtype, 128),
            dtype=str(dtype).split(".")[1],
            M=m, K=k, N=n, k_tiles=[ks, ke], max_abs_err=float(diff.max()),
            err_over_tol=float((diff / tol.clamp_min(1e-300)).max()),
            ok=bool((diff <= tol).all())))
    if not timed:
        return rows
    acc = ck.acc
    sets = [(x, y, acc)] + [inputs() + (torch.zeros_like(acc),) for _ in
                            range(n_copies(nbytes(x, y, acc)) - 1)]
    if dtype == torch.bfloat16:
        lib_call = "torch.mm(x, y, out_dtype=torch.float32)"
        library = (lambda a, b, c: torch.mm(a, b, out_dtype=torch.float32))
    else:
        lib_call = "torch.addmm(acc, x, y)"
        library = (lambda a, b, c: torch.addmm(c, a, b))
    t_ops = 2 * m * n * k / PEAK_OPS[dtype]
    t_bytes = nbytes(x, y, acc, acc) / HBM_BYTES_PER_S
    rows[0].update(
        ms=time_ms(lambda a, b, c: matmul_resumable(a, b, c, 0, nk), sets),
        plain_ms=time_ms(lambda a, b, c: matmul_partial_plain(a, b, c, 0, nk),
                         sets),
        library_ms=time_ms(library, sets), library_call=lib_call,
        bound_ms=max(t_ops, t_bytes) * 1e3,
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        # ms of one launch over the first q K tiles: the fixed cost of a
        # launch (a preemption point) against the cost of a tile
        ms_by_k_tiles={q: time_ms(lambda a, b, c, q=q: matmul_resumable(
            a, b, c, 0, q), sets) for q in (1, 2, 4, 8, 24)})
    return rows


def phase_gemm():
    from repro_torch.examples.preemptible_kernel_demo import full_shape
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for shape in GEMM_SHAPES + [full_shape()]:
            for row in gemm_case(gen, dtype, shape,
                                 timed=shape == full_shape()):
                rows.append(row)
                emit("kernel_check", **row)
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise SystemExit(f"the GEMM disagrees with its plain version: {bad}")
    return rows


# --------------------------------------------------------------------------
# phase 4: tiny models, card against CPU
# --------------------------------------------------------------------------
def phase_tiny():
    from repro_torch.models import get_model
    from repro_torch.models.transformer import tree_map
    from repro_torch.params import params_from_numpy
    from repro_torch.serving import PreemptibleExecutor

    out = {}
    for name in ("qwen3-8b", "olmo-1b", "deepseek-coder-33b"):
        model = get_model(name, tiny=True)
        cpu = model.init_params(generator=torch.Generator().manual_seed(1),
                                dtype=torch.float32, device="cpu")
        gpu = params_from_numpy(tree_map(lambda x: x.numpy(), cpu), "cuda")
        prompt = np.random.default_rng(2).integers(
            1, model.cfg.vocab_size, (1, 12)).astype(np.int32)
        ex_c = PreemptibleExecutor(model, cpu)
        ex_g = PreemptibleExecutor(model, gpu)
        sc, sg = ex_c.start({"tokens": prompt}), ex_g.start({"tokens": prompt})
        while sc.phase == "prefill":
            sc, sg = ex_c.step_prefill(sc), ex_g.step_prefill(sg)
        err, compared = 0.0, 0
        for step in range(8):
            lc, lg = sc.last_logits.float(), sg.last_logits.float().cpu()
            err = max(err, max_err(lc, lg))
            top2 = torch.topk(lc[0, -1], 2).values
            if float(top2[0] - top2[1]) > TINY_TOL:
                compared += 1
                if not np.array_equal(sc.tokens_out[-1], sg.tokens_out[-1]):
                    raise SystemExit(f"{name}: token differs at step {step}")
            # teacher forcing: both continue from the CPU's token
            sg.tokens_out[-1] = sc.tokens_out[-1].copy()
            sc, sg = ex_c.step_decode(sc), ex_g.step_decode(sg)
        if err > TINY_TOL:
            raise SystemExit(f"{name}: card vs CPU logits differ by {err}")
        out[name] = {"max_abs_err": err, "tol": TINY_TOL,
                     "tokens_compared": compared}
    emit("tiny_card_vs_cpu", dtype="float32", **out)


# --------------------------------------------------------------------------
# phase 5: the serving path at full width
# --------------------------------------------------------------------------
def make_requests(cfg, hw, n: int, seed: int):
    from repro_torch.core import arch_ops
    from repro_torch.core.predictor import network_time
    from repro_torch.serving import InferenceRequest
    rng = np.random.default_rng(seed)
    # arrivals inside one 2048-token prefill's predicted time, so PREMA
    # has to preempt
    window = 0.5 * network_time(arch_ops.prefill_ops(cfg, 2048, 1), hw)
    reqs = []
    for i in range(n):
        plen = int(rng.integers(64, 2049))
        reqs.append(InferenceRequest(
            rid=i, arch=cfg.name,
            prompt=rng.integers(1, cfg.vocab_size, (1, plen)).astype(np.int32),
            max_new_tokens=32, priority=int(rng.choice([1, 3, 9])),
            arrival=float(rng.uniform(0, window)),
            true_decode_len=int(rng.integers(8, 33))))
    return reqs, window


def _count_steps(executor, counts):
    """Count the executor's steps (instance attributes shadow the methods,
    so ``step`` and ``run_uninterrupted`` go through them)."""
    for key, name in (("prefill", "step_prefill"), ("decode", "step_decode")):
        fn = getattr(executor, name)

        def counted(st, fn=fn, key=key):
            counts[key] += 1
            return fn(st)
        setattr(executor, name, counted)


def _counters():
    """The wrapper modules whose ``launches`` count kernel launches."""
    from repro_torch.kernels.decode_attention import ops as dec
    from repro_torch.kernels.flash_attention import ops as fl
    from repro_torch.kernels.preemptible_matmul import ops as mm
    return {"flash_attention": fl, "decode_attention": dec,
            "preemptible_matmul": mm}


def _launches():
    """Launches per kernel: ``wrapper/variant`` where a wrapper has two
    kernels, whose counts must add up to the wrapper's own."""
    out = {}
    for name, mod in _counters().items():
        by = getattr(mod, "variant_launches", None)
        if by is None:
            out[name] = mod.launches
            continue
        if sum(by.values()) != mod.launches:
            raise SystemExit(f"{name}: {mod.launches} launches, by variant "
                             f"{by}")
        out.update({f"{name}/{v}": n for v, n in by.items()})
    return out


def _reset_launches():
    for mod in _counters().values():
        mod.launches = 0
        for v in getattr(mod, "variant_launches", {}):
            mod.variant_launches[v] = 0
    _counters()["decode_attention"].layout_copies = 0


def _no_launches():
    return dict.fromkeys(_launches(), 0)


def _check_launches(cfg, counts, where):
    attn_slots = sum(m == "attn" for m, _ in cfg.block_pattern)
    expect = {**_no_launches(),
              "flash_attention/wgmma": counts["prefill"] * attn_slots,
              "decode_attention": counts["decode"] * attn_slots
              * cfg.n_periods}
    got = _launches()
    if got != expect or min(counts.values()) == 0:
        raise SystemExit(f"{where}: kernel launches {got}, expected {expect} "
                         f"from step counts {counts}")
    copies = _counters()["decode_attention"].layout_copies
    if copies:
        raise SystemExit(f"{where}: decode copied K or V {copies} times: the "
                         "model's cache must be read in place")
    return got


def serve_and_check(model, params, reqs, sync):
    """Serve ``reqs`` through the PREMA engine, then rerun each request in
    isolation; checks completion, preemption, tokens and launch counts."""
    from repro_torch.serving import EngineConfig, ServingEngine
    cfg = model.cfg
    engine = ServingEngine({cfg.name: (model, params)},
                           cfg=EngineConfig(policy="prema",
                                            mechanism="dynamic"))
    executor = engine._executors[cfg.name]
    counts = {"prefill": 0, "decode": 0}
    _count_steps(executor, counts)

    _reset_launches()
    t0 = time.perf_counter()
    results = engine.run(reqs)
    sync()
    wall = time.perf_counter() - t0
    engine_launches = _check_launches(cfg, counts, "engine run")
    engine_steps = dict(counts)
    if len(results) != len(reqs):
        raise SystemExit(f"{len(results)} of {len(reqs)} requests completed")
    if sum(r.n_preemptions + r.n_kills for r in results) < 1:
        raise SystemExit("no preemption took place")

    counts.update(prefill=0, decode=0)
    _reset_launches()
    t0 = time.perf_counter()
    for r in results:
        req = next(q for q in reqs if q.rid == r.rid)
        n = r.tokens.shape[1]
        iso = executor.run_uninterrupted({"tokens": req.prompt},
                                         max_new_tokens=n)
        if n < 1 or not np.array_equal(np.stack(iso.tokens_out[:n], 1),
                                       r.tokens):
            raise SystemExit(f"request {r.rid}: tokens differ from its "
                             "isolated run")
        if not bool(torch.isfinite(iso.last_logits.float()).all()):
            raise SystemExit(f"request {r.rid}: non-finite logits")
    sync()
    iso_wall = time.perf_counter() - t0
    iso_launches = _check_launches(cfg, counts, "isolated runs")
    return dict(
        engine=engine, executor=executor, wall_s=wall, isolated_wall_s=iso_wall,
        generated_tokens=sum(int(r.tokens.shape[1]) for r in results),
        checks=dict(requests=len(results),
                    preemptions=sum(r.n_preemptions for r in results),
                    kills=sum(r.n_kills for r in results),
                    tokens_equal_isolated=True, engine_steps=engine_steps,
                    engine_launches=engine_launches,
                    isolated_steps=dict(counts),
                    isolated_launches=iso_launches))


def phase_serve(card: str, n_requests: int = 8, seed: int = 0):
    from repro_torch.hw import H100
    from repro_torch.models import get_model

    torch.use_deterministic_algorithms(True)
    # every kernel writes all of its outputs: no need to fill torch.empty
    torch.utils.deterministic.fill_uninitialized_memory = False
    model = get_model("qwen3-8b")
    cfg = model.cfg
    t0 = time.perf_counter()
    params = model.init_params(
        generator=torch.Generator(device="cuda").manual_seed(seed),
        dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    reqs, window = make_requests(cfg, H100, n_requests, seed)
    torch.cuda.reset_peak_memory_stats()
    run = serve_and_check(model, params, reqs, torch.cuda.synchronize)
    emit("serve", model=cfg.name, dtype="bfloat16", n_layers=cfg.n_layers,
         d_model=cfg.d_model,
         prompt_lens=[int(q.prompt.shape[1]) for q in reqs],
         arrival_window_s=window, param_init_s=init_s,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         **run["checks"])
    emit("serve_virtual_clock", note="engine summary(): virtual clock of "
         "the H100 hardware model, not measured time",
         **{k: float(v) for k, v in run["engine"].summary().items()})
    emit("serve_wall", card=card, wall_s=run["wall_s"],
         generated_tokens=run["generated_tokens"],
         tokens_per_s=run["generated_tokens"] / run["wall_s"],
         isolated_runs_wall_s=run["isolated_wall_s"])
    longest = max(reqs, key=lambda q: q.prompt.shape[1])
    emit("serve_profile", card=card, prompt_len=int(longest.prompt.shape[1]),
         **profile_request(run["executor"], longest.prompt,
                           longest.max_new_tokens))
    return run["checks"]["engine_launches"]


def _family(name: str) -> str:
    low = name.lower()
    if "flash_fwd_" in name:
        return "flash_attention"
    if "decode_split_kernel" in name:
        return "decode_attention"
    if any(k in low for k in ("gemm", "gemv", "nvjet", "xmma", "cutlass")):
        return "gemm"
    return "other"


def _device_breakdown(prof, wall_s: float) -> dict:
    fams = {"flash_attention": 0.0, "decode_attention": 0.0, "gemm": 0.0,
            "other": 0.0}
    kernels = []
    for evt in prof.key_averages():
        us = evt.self_device_time_total
        if us > 0:
            fams[_family(evt.key)] += us / 1e3
            kernels.append((us / 1e3, evt.count, evt.key[:90]))
    device_ms = sum(fams.values())
    return dict(wall_ms=wall_s * 1e3, device_ms=device_ms,
                idle_share=1.0 - device_ms / (wall_s * 1e3),
                family_ms=fams,
                top=[dict(ms=ms, count=n, name=k)
                     for ms, n, k in sorted(kernels, reverse=True)[:6]])


def profile_request(executor, prompt, max_new_tokens: int) -> dict:
    """Device time by kernel family (``torch.profiler``, CUDA activity
    only) for the prefill and then the decode of one isolated request."""
    from torch.profiler import ProfilerActivity, profile
    st = executor.start({"tokens": prompt})
    out = {}
    for phase in ("prefill", "decode"):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            steps = 0
            while st.phase == phase and len(st.tokens_out) < max_new_tokens:
                st = executor.step(st)
                steps += 1
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        out[phase] = dict(steps=steps, **_device_breakdown(prof, wall))
    return out


# --------------------------------------------------------------------------
# phase 6: the GEMM path at full width
# --------------------------------------------------------------------------
def phase_gemm_path(card: str) -> int:
    """The demo's ``--full`` run; it raises unless the preempted and
    uninterrupted accumulators are bitwise equal and within tolerance."""
    from repro_torch.examples import preemptible_kernel_demo as demo
    _reset_launches()
    rep = demo.main(["--full", "--seed", "0"])
    torch.cuda.synchronize()
    got = _launches()
    expect = {**_no_launches(),
              "preemptible_matmul/wgmma": 1 + rep["n_quanta"]}
    if got != expect or rep["n_quanta"] != 48:
        raise SystemExit(f"GEMM path: kernel launches {got}, expected "
                         f"{expect} from 1 + {rep['n_quanta']} launches "
                         "(48 quanta)")
    emit("gemm_path", card=card, launches=got, **rep)
    return got["preemptible_matmul/wgmma"]


# the kernels whose compiled code phase 1 reports: name -> a pattern of
# its mangled name (the decode kernel at bf16, D 128, groups up to 4)
COMPILED_KERNELS = {
    "gemm_resume_wgmma_kernel": "gemm_resume_wgmma_kernel",
    "flash_fwd_wgmma_kernel": "flash_fwd_wgmma_kernel",
    "decode_split_kernel<bf16,128,4>":
        r"decode_split_kernelI\w*bfloat16Li128ELi4E"}


def compiled_kernels(lib_path: Path):
    """Per kernel: its registers, stack and local memory per thread (local
    > 0 means spills) and its count of HGMMA (wgmma), UTMALDG (TMA load)
    and LDGSTS (cp.async) instructions, from ``cuobjdump`` on the built
    library; None where the toolkit has no ``cuobjdump``."""
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(exe):
        return None

    def dump(flag):
        return subprocess.run([exe, flag, str(lib_path)], check=True,
                              capture_output=True, text=True,
                              timeout=300).stdout
    res, sass = dump("-res-usage"), dump("-sass")
    out = {}
    for name, pat in COMPILED_KERNELS.items():
        m = re.search(rf"Function \S*{pat}\S*:\s+REG:(\d+) STACK:(\d+) "
                      rf"SHARED:\d+ LOCAL:(\d+)", res)
        code = "".join(part for part in sass.split("Function : ")[1:]
                       if re.search(pat, part.split(None, 1)[0]))
        out[name] = dict(
            registers=int(m.group(1)) if m else None,
            stack_bytes=int(m.group(2)) if m else None,
            local_bytes=int(m.group(3)) if m else None,
            **{op: len(re.findall(rf"\b{op}\b", code))
               for op in ("HGMMA", "UTMALDG", "LDGSTS")})
    return out


PHASES = ("kernels", "gemm", "tiny", "serve", "path")
# the kernels line: name, launch counter, source, TPU kernel, headline row
KERNELS = [
    ("flash_attention_wgmma_bf16", "flash_attention/wgmma",
     "flash_attention.cu", "src/repro/kernels/flash_attention/kernel.py:90",
     dict(kernel="flash_attention", dtype="bfloat16", S=2048, causal=True)),
    ("flash_attention_cuda_core_f32", "flash_attention/cuda_core",
     "flash_attention.cu", "src/repro/kernels/flash_attention/kernel.py:90",
     dict(kernel="flash_attention", dtype="float32", S=2048, causal=True)),
    ("decode_attention", "decode_attention", "decode_attention.cu",
     "src/repro/kernels/decode_attention/kernel.py:91",
     dict(kernel="decode_attention", dtype="bfloat16", Hq=HQ, T=2560,
          pos=2048)),
    ("preemptible_matmul_wgmma_bf16", "preemptible_matmul/wgmma",
     "preemptible_matmul.cu",
     "src/repro/kernels/preemptible_matmul/kernel.py:59",
     dict(kernel="preemptible_matmul", dtype="bfloat16", M=2048, K=12288,
          N=4096, k_tiles=[0, 96])),
    ("preemptible_matmul_cuda_core_f32", "preemptible_matmul/cuda_core",
     "preemptible_matmul.cu",
     "src/repro/kernels/preemptible_matmul/kernel.py:59",
     dict(kernel="preemptible_matmul", dtype="float32", M=2048, K=12288,
          N=4096, k_tiles=[0, 96])),
]


def kernels_line(rows, launches):
    kernels = []
    for name, counter, src, replaces, head_at in KERNELS:
        variant = counter.partition("/")[2]
        mine = [r for r in rows if r["kernel"] == head_at["kernel"]
                and (not variant or r["variant"] == variant)]
        head = next(r for r in mine
                    if all(r[k] == v for k, v in head_at.items()))
        kernels.append(dict(
            name=name, route="cuda",
            source=f"src/repro_torch/kernels/csrc/{src}", replaces=replaces,
            launches=launches[counter],
            max_abs_err=max(r["max_abs_err"] for r in mine),
            ms=head["ms"], plain_ms=head["plain_ms"],
            bound_ms=head["bound_ms"], bound_by=head["bound_by"],
            library_ms=head["library_ms"], at=head_at,
            **{key: head[key] for key in ("device_ms", "library_device_ms")
               if key in head}))
    return kernels


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES)
                         + "; the kernels line needs all of them")
    phases = ap.parse_args(argv).phases.split(",")
    if not set(phases) <= set(PHASES):
        ap.error(f"phases must be among {PHASES}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import cuda_lib

    card = card_line()
    t0 = time.perf_counter()
    cuda_lib.library()
    build_s = time.perf_counter() - t0
    nvcc = subprocess.run([cuda_lib._nvcc(), "--version"], check=True,
                          capture_output=True, text=True).stdout
    emit("device", card=card, torch=torch.__version__,
         cuda=torch.version.cuda, nvcc=nvcc.strip().splitlines()[-1],
         build_s=build_s,
         compiled=compiled_kernels(cuda_lib.library_path()))
    # the plain versions' f32 products must not run in TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = []
    if "kernels" in phases:
        rows += phase_kernels()
    if "gemm" in phases:
        rows += phase_gemm()
    if "tiny" in phases:
        phase_tiny()
    launches = _no_launches()
    if "serve" in phases:
        launches.update(phase_serve(card))
    if "path" in phases:
        launches["preemptible_matmul/wgmma"] = phase_gemm_path(card)

    print(card)
    if set(phases) == set(PHASES):
        print(json.dumps({"kernels": kernels_line(rows, launches)}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
