#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --phases kernels,gemm   # a subset, no kernels line

Phases, each printing one JSON line; any failure exits non-zero:

1. device: the card's name and power limit, torch, the kernel build
   (``nvcc`` from the sources in this checkout), and per kernel (both
   tensor-core kernels, the wgmma flash kernel's instances at D 64, 80
   and 128 each, decode, and the two CUDA-core kernels) its
   registers, stack, local memory and its HGMMA, UTMALDG, LDGSTS
   (cp.async) and FFMA instructions (``cuobjdump``);
2. each attention kernel against its plain PyTorch version on the card
   at the serving path's shapes (B 1, Hq 32, Hkv 8, D 128; bf16 and f32;
   flash runs its wgmma kernel in bf16 and its CUDA-core kernel in f32,
   both also at D 80, the wgmma kernel also at D 64, and at D 80 ragged
   (S 37 rows at query offset 512, causal, against T 1000); decode also at
   deepseek-coder-33b's Hq 56; both in bf16 also at qwen3-moe-30b-a3b's
   Hq 32 over Hkv 4, decode's group of 8; in bf16 also at
   llama-3.2-vision-11b's cross-attention: flash non-causal at S 37 and
   2048 against T 1600 image keys, decode at T 1600, pos 1599), with
   kernel, plain and
   library (SDPA, a yardstick the port never calls) times by CUDA events
   and the card's bound; for decode also device times from CUDA-graph
   replays, a bitwise run-to-run check, and one call with a device
   ``pos`` captured in a CUDA graph and replayed at four positions;
3. the preemptible GEMM against its plain version run in float64, at the
   reference test's shapes and qwen3-8b's full-width down projection, over
   the whole K range and a middle range seeded from a non-zero
   accumulator, f32 (CUDA-core kernel) and bf16 (wgmma kernel); in f32
   also launches that start off a multiple of 4 rows or read x through
   strides, bitwise equal to one launch; timed at full width beside
   cuBLAS;
4. tiny qwen3-8b, olmo-1b, deepseek-coder-33b, qwen3-moe-30b-a3b,
   phi3.5-moe-42b-a6.6b, xlstm-350m, jamba-1.5-large-398b (its
   attention at slot 4, beside Mamba states), llama-3.2-vision-11b (with
   image embeddings) and hubert-xlarge (frames; its logits at every
   position, no decode) in f32 on the card against the same weights on
   the CPU, with each model's kernel launches and the MoE router's least
   top-k margin on the CPU (a routing flip shows as a large error);
5. the serving path: the PREMA ``ServingEngine`` serving 8 requests on
   full-width qwen3-8b in bf16, checked against isolated runs, with the
   kernels' launch counts, per kernel variant, checked against the
   executor's step counts;
6. the serving path in f32, the JAX package's dtype: 3 requests on
   full-width qwen3-8b (one prompt of 2048 tokens), checked as in 5, its
   prefill all on the CUDA-core flash kernel;
7. the GEMM path: the preemptible-kernel demo at full width
   (``repro_torch.examples.preemptible_kernel_demo --full``) in bf16 and
   in f32, each one uninterrupted launch and 48 preempted quanta that must
   agree bit for bit, with its launch count (all on the dtype's kernel)
   checked;
8. the MoE serving path: 4 requests (one prompt of 2048 tokens) on
   full-width qwen3-moe-30b-a3b in bf16, 61.1 GB of weights, checked as
   in 5: its prefill on the wgmma flash kernel and its decode on the
   decode kernel's group of 8;
9. the dense archs not served above: 3 requests each on full-width
   olmo-1b and qwen1.5-4b in bf16, checked as in 5 (decode at group 1,
   non-parametric LayerNorm, tied embeddings, QKV bias);
10. the recurrent models: 3 requests on full-width xlstm-350m in bf16,
    checked as in 5 with no attention kernel launched, its decode state's
    bytes equal from first to last token; then jamba-1.5-large's Mamba mixer
    alone at full width: its chunk carry against decode in f32, card
    against CPU, and bf16 prefill and decode times;
11. the vision and audio models (``serve_vlm_audio``): 4 requests on
    full-width llama-3.2-vision-11b in bf16 (19.6 GB of weights; each
    request with image embeddings of 1600 x 1280, the first prompt of 2048
    tokens), checked as in 5 with flash launched 5 times a prefill step
    (4 self-attention, 1 cross-attention) and the image K/V at 1600
    positions from the first token to the last; then 3 requests of frames
    on full-width hubert-xlarge in bf16 (the first of 2048), each done
    after its prefill with no token, its logits at every position equal
    bit for bit to its isolated run's, flash once a prefill step on the
    wgmma kernel's D 80 instance, and no decode;
12. the training path (``train``): the flash wrapper refuses an input
    that requires grad; tiny olmo-1b, qwen3-8b, qwen3-moe-30b-a3b,
    xlstm-350m, jamba-1.5-large-398b, llama-3.2-vision-11b and
    hubert-xlarge each take one train step in f32 (grad_accum 2, remat
    ``full``) on the card and on the CPU from the same weights and batch,
    held to TINY_TOL; then full-width olmo-1b (1.177 B parameters) trains
    in f32 through the launcher's parts (``repro_torch.launch.train``):
    seq 4096, global batch 8 in 4 microbatches (the chunked CE), remat
    ``full``, 4 steps with an async checkpoint after step 2, then a
    restart from it whose steps 3-4 must leave every parameter and moment
    equal bit for bit, and the same two steps from it without the mesh
    (``make_train_step`` on the local tensors), also equal bit for bit,
    their walls beside the mesh steps'; the reference's lr at every step,
    no flash or
    decode launch, and one more step profiled twice by kernel family,
    with where the device waited (the longest gaps between its events);
    all of it under the launcher's default ``--mesh host``: an NCCL world of one,
    a (1, 1) DeviceMesh, parameters and moments as DTensors;
13. the distributed path (``distributed``): under that NCCL group and
    mesh, full-width olmo-1b trains 2 steps through the launcher's parts
    and then, its state freed, 2 meshless steps (``make_train_step``) from
    the same seed, which must leave every parameter and moment equal bit
    for bit (the mesh step runs the tensor-parallel code at a 'model' size
    of 1), with each
    run's step wall, tokens/s and peak memory, and one more step of each
    profiled as phase ``train`` profiles its step; the mesh run's state
    resharded onto a fresh (1, 1) mesh and back, losslessly; one
    full-width qwen3-moe-30b-a3b MoE layer in f32 (capacity factor 16)
    through ``moe_ffn_sharded`` at T 4096 and ``moe_ffn_psum`` at T 1 and
    8, outputs and gradients within 1e-5 of the local path's, with CUDA
    event times beside it; ``elastic.plan``'s bytes per card for
    full-width qwen3-8b and olmo-1b training state on 2, 4 and 8 H100s
    (reckoned from shapes); no flash or decode launch;
14. the dry-run (``dryrun``; ``repro_torch.launch.dryrun``, each in a
    subprocess of its own, under a fake process group): the dry-run's
    (1, 1) counterpart of phase 12's full-width step, on fake tensors of
    the card, must count exactly the FLOPs that ``FlopCounterMode`` counts
    over one real step of it (run here meanwhile, no kernel launched),
    its memory peak (``MemTracker``) beside the step's measured one; the
    same for one real train step of full-width xlstm-350m in f32 (seq
    512, global batch 2, remat ``full``; every scan chunk rematerialised)
    against its counterpart, whose scans count their turns, with the
    wall of a second step; tiny xlstm-350m's and jamba's gradients at two
    chunks of their scans equal under remat none, full and dots (the
    chunk checkpoints nested in the period's); and the reference's cells
    olmo-1b x train_4k,
    xlstm-350m x long_500k and train_4k and jamba-1.5-large-398b x
    prefill_32k on the 16x16 mesh through the dry-run's command line
    (fake tensors of the card, its default), and qwen3-8b x train_4k at
    12 of its 36 layers, each one's result and wall; a train cell's FLOPs
    per device over the analytic count (olmo-1b's within 0.9-1.1, its
    dense layers split over 'model'), collective bytes by kind and peak;
15. sharded serving (``serve_sharded``; ``distributed/serve_step.py``):
    (a) the kernels' new modes at serving shapes: the decode kernel at
    qwen3-8b's shape in bf16 (Hq 32 over Hkv 8, and over 4: the group of
    8) over a cache of 32768 positions split into 16 blocks of 2048 (a
    decode_32k rank's block), each with its log-sum-exp at its local pos
    (-1 past the token), merged by ``merge_partials``' combine and held
    to the unsplit kernel and the plain version at pos 0, 2047, 2048,
    20000 and 32767 (``merged_bf16_tolerance``), blocks past pos zero
    and weightless, with device times (CUDA-graph replays) of the 16
    launches and the merge against one launch; flash at S = T 2048,
    causal, Hq 32 over Hkv 8, in bf16 (wgmma) and f32 (CUDA-core), as
    four blocks of 512 query rows at their offsets against the whole
    launch (bit for bit or not, said) and the plain version; (b)
    full-width qwen3-8b in bf16 under the launcher's NCCL (1, 1) mesh:
    ``sharded_prefill`` of a 2048-token prompt and 32
    ``sharded_decode_step``s must equal the meshless ``prefill`` and
    ``decode_step`` bit for bit (logits of every step, the last cache),
    flash launched 36 times and decode 36 times a step, each writing its
    log-sum-exp, with walls and peaks beside the meshless run's; (c) the
    reference's serving cells olmo-1b x prefill_32k, qwen3-8b x
    decode_32k and qwen3-moe-30b-a3b x decode_32k through the dry-run's
    command line on fake tensors of the card (16x16 mesh, the kernels
    through their fake implementations), each in a subprocess: each ok,
    FLOPs per device over the analytic count (the first two within
    0.9-1.3, and fitting 80 GB), collective bytes by kind, peak;
16. the serving examples (``examples``; ``repro_torch.examples``): (a)
    ``quickstart --full`` in bf16, 8 requests on full-width olmo-1b and
    qwen3-8b with ``obs/``'s span tracer, telemetry and SLO monitor
    attached: run spans that never overlap on a device, every lifecycle
    closed, the Perfetto JSON under ``build/examples``, the telemetry
    totals and SLO alerts (the engine's virtual clock of the H100 model);
    (b) ``multi_npu_cluster --full``'s two-device engine on the same
    weights and requests, each request's tokens bit for bit (a)'s; (c)
    ``multi_tenant_serving`` at its tiny configs in f32 (the H100 model,
    then the paper's NPU model, where PREMA preempts), tokens identical
    across NP-FCFS and PREMA; each run's launches checked against its
    step counts.

Each serving phase also holds its profiled prefill's device time against
CUDA events around the same prefill.  Then a ``{"kernels": [...]}`` line
(with flash's ``q_offset`` and decode's ``split_lse`` modes under
``modes``) and, last, the device line.  Without a CUDA device, or without the
repository beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import os

# cuBLAS determinism needs this before CUDA starts
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import argparse
import contextlib
import dataclasses
import gc
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
IMG_T = 1600                                  # llama-3.2-vision-11b's image
                                              # tokens
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


def flash_case(gen, dtype, s, causal, d=D, hkv=HKV, t=None, hq=HQ,
               q_offset=0):
    """S queries against T keys (T = S unless given: cross-attention's
    S != T is non-causal; a causal S != T is a block of query rows at
    ``q_offset``)."""
    from repro_torch.kernels.flash_attention import (bf16_tolerance,
                                                     flash_attention,
                                                     flash_attention_plain)
    from repro_torch.kernels.flash_attention.ops import kernel_variant
    F = torch.nn.functional
    t = s if t is None else t
    q = _model_layout(gen, B, s, hq, d, dtype)
    k = _model_layout(gen, B, t, hkv, d, dtype)
    v = _model_layout(gen, B, t, hkv, d, dtype)
    out = flash_attention(q, k, v, causal, q_offset)
    ref = flash_attention_plain(*as_f32(q, k, v), causal, q_offset)
    variant = kernel_variant(dtype, d)
    if variant == "wgmma":
        bound = bf16_tolerance(q, k, v, causal, q_offset)
        tol_name = "bf16_tolerance"
    else:
        bound, tol_name = tolerance(ref, TOL[dtype]), f"{TOL[dtype]}"
    ratio = over_tol(out, ref, bound)
    torch.cuda.synchronize()
    err = max_err(out, ref)
    sets = [(q, k, v)] + [tuple(_model_layout(gen, B, n, h, d, dtype)
                                for n, h in ((s, hq), (t, hkv), (t, hkv)))
                          for _ in range(n_copies(nbytes(q, k, v)) - 1)]
    # the (query, key) pairs these inputs need: row i sees keys up to
    # i + q_offset when causal
    pairs = (sum(min(t, i + q_offset + 1) for i in range(s)) if causal
             else s * t)
    ops = 4 * B * hq * d * pairs
    mask = None
    if causal and (q_offset or s != t):    # SDPA's is_causal aligns top-left
        mask = (torch.arange(t, device="cuda")[None, :]
                <= torch.arange(s, device="cuda")[:, None] + q_offset)
    moved = nbytes(q, k, v, out)
    t_ops, t_bytes = ops / PEAK_OPS[dtype], moved / HBM_BYTES_PER_S
    row = dict(
        kernel="flash_attention", variant=variant,
        dtype=str(dtype).split(".")[1], D=d, Hq=hq, Hkv=hkv, S=s, T=t,
        causal=causal, **({"q_offset": q_offset} if q_offset else {}),
        max_abs_err=err, tolerance=tol_name, err_over_tol=ratio,
        ok=ratio <= 1.0,
        ms=time_ms(lambda a, b_, c: flash_attention(a, b_, c, causal,
                                                    q_offset), sets),
        plain_ms=time_ms(lambda a, b_, c: flash_attention_plain(
            a, b_, c, causal, q_offset), sets),
        library_ms=time_ms(lambda a, b_, c: F.scaled_dot_product_attention(
            a, b_, c, attn_mask=mask, is_causal=causal and mask is None,
            enable_gqa=True), sets),
        bound_ms=max(t_ops, t_bytes) * 1e3,
        bound_by="operations" if t_ops >= t_bytes else "bytes")
    return row


def decode_case(gen, dtype, t, pos, hq=HQ, hkv=HKV):
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_plain)
    F = torch.nn.functional

    def inputs():
        q = torch.randn((B, hq, D), generator=gen, device="cuda", dtype=dtype)
        return (q, _model_layout(gen, B, t, hkv, D, dtype),
                _model_layout(gen, B, t, hkv, D, dtype))
    q, k, v = inputs()
    out = decode_attention(q, k, v, pos)
    again = decode_attention(q, k, v, pos)
    ref = decode_attention_plain(*as_f32(q, k, v), pos)
    torch.cuda.synchronize()
    err, tol = max_err(out, ref), TOL[dtype]
    ratio = over_tol(out, ref, tolerance(ref, tol))
    bitwise = bool(torch.equal(out, again))
    live = 2 * B * hkv * (pos + 1) * D * k.element_size()
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
        Hkv=hkv, T=t, pos=pos, max_abs_err=err, tolerance=f"{tol}",
        err_over_tol=ratio,
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
    # flash at the other head widths: hubert-xlarge's 80 in bf16 (the
    # wgmma kernel's D 80 instance) and f32 (the CUDA-core kernel), and 64
    # in bf16 (the D 64 instance)
    for dtype, d, s, causal in ((torch.bfloat16, 80, 2048, True),
                                (torch.bfloat16, 80, 37, False),
                                (torch.float32, 80, 2048, True),
                                (torch.bfloat16, 64, 1024, True)):
        rows.append(flash_case(gen, dtype, s, causal, d))
        emit("kernel_check", **rows[-1])
    # the D 80 instance ragged on both sides, Hq 32 over Hkv 8, causal at a
    # query offset: S 37 rows from 512 on against T 1000 keys
    rows.append(flash_case(gen, torch.bfloat16, 37, True, 80, t=1000,
                           q_offset=512))
    emit("kernel_check", **rows[-1])
    # qwen3-moe-30b-a3b's layout, 32 query heads over 4 KV heads: flash
    # at Hkv 4 and decode's group of 8
    rows.append(flash_case(gen, torch.bfloat16, 2048, True, hkv=4))
    emit("kernel_check", **rows[-1])
    rows.append(decode_case(gen, torch.bfloat16, 2560, 2048, hkv=4))
    emit("kernel_check", **rows[-1])
    # llama-3.2-vision-11b's cross-attention: a text prompt against its
    # 1600 image keys (both sides ragged at S 37), and decode over all of
    # them
    for s in (37, 2048):
        rows.append(flash_case(gen, torch.bfloat16, s, False, t=IMG_T))
        emit("kernel_check", **rows[-1])
    rows.append(decode_case(gen, torch.bfloat16, IMG_T, IMG_T - 1))
    emit("kernel_check", **rows[-1])
    # hubert-xlarge's prefill: 16 heads of 80, non-causal, 2048 frames
    rows.append(flash_case(gen, torch.bfloat16, 2048, False, 80, hkv=16,
                           hq=16))
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
        if dtype == torch.float32:
            rows.append(gemm_split_case(x, y, ck.acc, rows[0]))
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


def gemm_split_case(x, y, acc, whole):
    """The f32 kernel's launches whose first row is not a multiple of 4
    (bk 1, 3, 100: the masked path, and x read through its transpose's
    strides) in three launches: bitwise equal to one launch of bk 128."""
    from repro_torch.kernels.preemptible_matmul import matmul_resumable
    k = x.shape[1]
    one = matmul_resumable(x, y, acc, 0, -(-k // 128))
    xt = x.t().contiguous().t()
    equal = {}
    for bk in (1, 3, 100):
        nk = -(-k // bk)
        out = acc.clone()
        cuts = sorted({0, nk // 3, (2 * nk) // 3, nk})
        for i, (lo, hi) in enumerate(zip(cuts, cuts[1:])):
            out = matmul_resumable(xt if i % 2 else x, y, out, lo, hi, bk=bk,
                                   out=out)
        equal[bk] = bool(torch.equal(out, one))
    return dict(kernel="preemptible_matmul", variant="cuda_core",
                dtype="float32", M=whole["M"], K=whole["K"], N=whole["N"],
                check="3 launches at bk 1, 3, 100 (x strided in the 2nd) "
                      "== 1 launch", bitwise_equal=equal,
                max_abs_err=whole["max_abs_err"],
                ok=all(equal.values()))


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
@contextlib.contextmanager
def router_margins(margins: list):
    """While open, each MoE routing on the CPU appends the least gap, over
    its tokens, between the k-th and the (k+1)-th router probability: a
    gap below the card's error could flip which experts a token uses."""
    from repro_torch.models import moe
    route = moe.route

    def recording(x2d, p, cfg):
        if x2d.device.type == "cpu":
            with torch.no_grad():
                probs = torch.softmax(x2d.float() @ p["router"], dim=-1)
                top = torch.sort(probs, dim=-1, descending=True).values
                margins.append(float((top[:, cfg.top_k - 1]
                                      - top[:, cfg.top_k]).min()))
        return route(x2d, p, cfg)
    moe.route = recording
    try:
        yield
    finally:
        moe.route = route


def phase_tiny():
    out = {name: tiny_card_vs_cpu(name) for name in (
        "qwen3-8b", "olmo-1b", "deepseek-coder-33b", "qwen3-moe-30b-a3b",
        "phi3.5-moe-42b-a6.6b", "xlstm-350m", "jamba-1.5-large-398b",
        "llama-3.2-vision-11b", "hubert-xlarge")}
    emit("tiny_card_vs_cpu", dtype="float32", **out)


def model_inputs(cfg, prompt, rng) -> dict:
    """The batch the engine hands a model: ``prompt``'s tokens, or frames
    of as many positions for frame inputs; image embeddings for a VLM
    (numpy f32 from ``rng``)."""
    b, s = prompt.shape
    if cfg.embedding_inputs:
        return {"frames": rng.standard_normal((b, s, cfg.d_model),
                                              dtype=np.float32)}
    batch = {"tokens": prompt}
    if cfg.img_tokens:
        batch["img_embeds"] = rng.standard_normal(
            (b, cfg.img_tokens, cfg.d_vision), dtype=np.float32)
    return batch


def tiny_card_vs_cpu(name: str) -> dict:
    """Prefill and 8 teacher-forced decode steps of tiny ``name`` in f32,
    on the card and on the CPU from the same weights, with the card's
    kernel launches; for an MoE also the router's least top-k margin on
    the CPU; for the encoder-only model its logits at every position."""
    from repro_torch.models import get_model
    from repro_torch.models.transformer import tree_map
    from repro_torch.params import params_from_numpy
    from repro_torch.serving import PreemptibleExecutor

    model = get_model(name, tiny=True)
    cpu = model.init_params(generator=torch.Generator().manual_seed(1),
                            dtype=torch.float32, device="cpu")
    gpu = params_from_numpy(tree_map(lambda x: x.numpy(), cpu), "cuda")
    prompt = np.random.default_rng(2).integers(
        1, model.cfg.vocab_size, (1, 12)).astype(np.int32)
    batch = model_inputs(model.cfg, prompt, np.random.default_rng(3))
    ex_c = PreemptibleExecutor(model, cpu)
    ex_g = PreemptibleExecutor(model, gpu)
    margins = []
    _reset_launches()
    with router_margins(margins):
        sc, sg = ex_c.start(batch), ex_g.start(batch)
        while sc.phase == "prefill":
            sc, sg = ex_c.step_prefill(sc), ex_g.step_prefill(sg)
        err, compared, differs = 0.0, 0, []
        if sc.phase == "done":       # encoder-only: logits everywhere
            err = max_err(sc.last_logits, sg.last_logits.cpu())
        for step in range(8 if sc.phase == "decode" else 0):
            lc, lg = sc.last_logits.float(), sg.last_logits.float().cpu()
            err = max(err, max_err(lc, lg))
            top2 = torch.topk(lc[0, -1], 2).values
            if float(top2[0] - top2[1]) > TINY_TOL:
                compared += 1
                if not np.array_equal(sc.tokens_out[-1], sg.tokens_out[-1]):
                    differs.append(step)
            # teacher forcing: both continue from the CPU's token
            sg.tokens_out[-1] = sc.tokens_out[-1].copy()
            sc, sg = ex_c.step_decode(sc), ex_g.step_decode(sg)
    torch.cuda.synchronize()
    row = {"max_abs_err": err, "tol": TINY_TOL, "tokens_compared": compared,
           "launches": {k: n for k, n in _launches().items() if n}}
    if margins:
        row["router_topk_margin"] = min(margins)
    if differs or err > TINY_TOL:
        raise SystemExit(f"{name}: card vs CPU: {row}, tokens differ at "
                         f"steps {differs}")
    return row


# --------------------------------------------------------------------------
# phase 5: the serving path at full width
# --------------------------------------------------------------------------
def make_requests(cfg, hw, n: int, seed: int, first_len=None):
    """``n`` requests from ``seed``; with ``first_len``, the first prompt
    is replaced by one of that many tokens (from ``seed + 1``) and every
    other draw stays as it was.  A VLM's image embeddings and an audio
    model's frames are drawn from ``seed + 2``."""
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
        prompt = rng.integers(1, cfg.vocab_size, (1, plen)).astype(np.int32)
        if i == 0 and first_len is not None:
            prompt = np.random.default_rng(seed + 1).integers(
                1, cfg.vocab_size, (1, first_len)).astype(np.int32)
        reqs.append(InferenceRequest(
            rid=i, arch=cfg.name, prompt=prompt,
            max_new_tokens=32, priority=int(rng.choice([1, 3, 9])),
            arrival=float(rng.uniform(0, window)),
            true_decode_len=int(rng.integers(8, 33))))
    payload = np.random.default_rng(seed + 2)
    for q in reqs:
        batch = model_inputs(cfg, q.prompt, payload)
        q.img_embeds, q.frames = batch.get("img_embeds"), batch.get("frames")
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
    kernels, whose counts must add up to the wrapper's own;
    ``wrapper/variant/width``, flash's by instance, which must add up to
    the same; and ``wrapper:mode``, those of its launches in a mode (flash
    at a query offset, decode writing its log-sum-exp)."""
    out = {}
    for name, mod in _counters().items():
        out.update({f"{name}:{m}": n
                    for m, n in getattr(mod, "mode_launches", {}).items()})
        widths = getattr(mod, "width_launches", None)
        if widths is not None:
            if sum(widths.values()) != mod.launches:
                raise SystemExit(f"{name}: {mod.launches} launches, by "
                                 f"width {widths}")
            out.update({f"{name}/{w}": n for w, n in widths.items()})
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
        for counts in (getattr(mod, "variant_launches", {}),
                       getattr(mod, "width_launches", {}),
                       getattr(mod, "mode_launches", {})):
            for v in counts:
                counts[v] = 0
    _counters()["decode_attention"].layout_copies = 0


def _no_launches():
    return dict.fromkeys(_launches(), 0)


def _capture_final_logits(executor, reqs, final: dict) -> None:
    """Wrap the executor's ``start`` and ``step_prefill`` (frame inputs):
    ``final[rid]`` gets a copy of the logits of request ``rid``'s state at
    the step that ends in phase ``done``.  A request is known by its
    frames, which the engine hands over as they are."""
    start, step, owner = executor.start, executor.step_prefill, {}

    def started(batch):
        st = start(batch)
        owner[id(st)] = (st, next(q.rid for q in reqs
                                  if q.frames is batch["frames"]))
        return st

    def stepped(st):
        st = step(st)
        if st.phase == "done" and id(st) in owner:
            final[owner[id(st)][1]] = st.last_logits.clone()
        return st
    executor.start, executor.step_prefill = started, stepped


def _check_launches(cfg, dtype, counts, where):
    """``_check_models_launches`` for one model, which decodes unless it is
    encoder-only."""
    if (counts["decode"] == 0) != cfg.encoder_only:
        raise SystemExit(f"{where}: step counts {counts} for "
                         f"{'an encoder-only' if cfg.encoder_only else 'a'} "
                         "model")
    return _check_models_launches({cfg.name: cfg}, dtype,
                                  {cfg.name: counts}, where)


def _check_models_launches(cfgs: dict, dtype, counts: dict, where: str):
    """Prefill launches all on the flash kernel (and its instance) of this
    dtype and each model's head width, none on the other, once per self- or
    cross-attention block and period; decode once per such block and
    step; ``counts`` holds each model's steps (by its name in ``cfgs``),
    every model prefilled."""
    from repro_torch.kernels.flash_attention.ops import kernel_variant
    expect = _no_launches()
    for name, c in counts.items():
        cfg = cfgs[name]
        attn = sum(m in ("attn", "cross_attn") for m, _ in cfg.block_pattern)
        variant = kernel_variant(dtype, cfg.d_head)
        for key in (variant, f"{variant}/{cfg.d_head}") if attn else ():
            expect[f"flash_attention/{key}"] += c["prefill"] * attn
        expect["decode_attention"] += c["decode"] * attn * cfg.n_periods
    got = _launches()
    if (got != expect or set(counts) != set(cfgs)
            or not all(c["prefill"] for c in counts.values())):
        raise SystemExit(f"{where}: kernel launches {got}, expected {expect} "
                         f"from step counts {counts}")
    copies = _counters()["decode_attention"].layout_copies
    if copies:
        raise SystemExit(f"{where}: decode copied K or V {copies} times: the "
                         "model's cache must be read in place")
    return got


def serve_and_check(model, params, dtype, reqs, sync):
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
    final = {}
    if cfg.encoder_only:
        _capture_final_logits(executor, reqs, final)

    _reset_launches()
    t0 = time.perf_counter()
    results = engine.run(reqs)
    sync()
    wall = time.perf_counter() - t0
    engine_launches = _check_launches(cfg, dtype, counts, "engine run")
    engine_steps = dict(counts)
    engine_logits = dict(final)    # the isolated runs below add their own
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
        iso = executor.run_uninterrupted(engine._batch_dict(req),
                                         max_new_tokens=n)
        if cfg.encoder_only:
            # no token: the engine run's logits at every position must
            # equal the isolated run's bit for bit
            if n or not torch.equal(engine_logits[r.rid], iso.last_logits):
                raise SystemExit(f"request {r.rid}: {n} tokens, or logits "
                                 "that differ from its isolated run")
        elif n < 1 or not np.array_equal(np.stack(iso.tokens_out[:n], 1),
                                         r.tokens):
            raise SystemExit(f"request {r.rid}: tokens differ from its "
                             "isolated run")
        if not bool(torch.isfinite(iso.last_logits.float()).all()):
            raise SystemExit(f"request {r.rid}: non-finite logits")
    sync()
    iso_wall = time.perf_counter() - t0
    iso_launches = _check_launches(cfg, dtype, counts, "isolated runs")
    return dict(
        engine=engine, executor=executor, wall_s=wall, isolated_wall_s=iso_wall,
        generated_tokens=sum(int(r.tokens.shape[1]) for r in results),
        checks=dict(requests=len(results),
                    preemptions=sum(r.n_preemptions for r in results),
                    kills=sum(r.n_kills for r in results),
                    **({"logits_equal_isolated": True} if cfg.encoder_only
                       else {"tokens_equal_isolated": True}),
                    engine_steps=engine_steps,
                    engine_launches=engine_launches,
                    isolated_steps=dict(counts),
                    isolated_launches=iso_launches))


def phase_serve(card: str, arch: str = "qwen3-8b", dtype=torch.bfloat16,
                n_requests: int = 8, seed: int = 0, first_len=None):
    """The PREMA engine serving ``n_requests`` on full-width ``arch`` with
    random weights of ``dtype``: checked against isolated runs, with launch
    counts, wall time and one request's device profile, whose decode
    state's bytes must not change from its first to its last token in a
    model without attention."""
    from repro_torch.hw import H100
    from repro_torch.models import get_model
    from repro_torch.models.transformer import tree_leaves

    torch.use_deterministic_algorithms(True)
    # every kernel writes all of its outputs: no need to fill torch.empty
    torch.utils.deterministic.fill_uninitialized_memory = False
    name = str(dtype).split(".")[1]
    model = get_model(arch)
    cfg = model.cfg
    t0 = time.perf_counter()
    params = model.init_params(
        generator=torch.Generator(device="cuda").manual_seed(seed),
        dtype=dtype, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    reqs, window = make_requests(cfg, H100, n_requests, seed, first_len)
    torch.cuda.reset_peak_memory_stats()
    run = serve_and_check(model, params, dtype, reqs, torch.cuda.synchronize)
    weights = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    emit("serve", model=cfg.name, dtype=name, n_layers=cfg.n_layers,
         d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
         n_experts=cfg.n_experts, top_k=cfg.top_k, weights_gb=weights / 1e9,
         prompt_lens=[int(q.prompt.shape[1]) for q in reqs],
         arrival_window_s=window, param_init_s=init_s,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         **run["checks"])
    emit("serve_virtual_clock", model=cfg.name, dtype=name,
         note="engine summary(): virtual clock of the H100 hardware model, "
              "not measured time",
         **{k: float(v) for k, v in run["engine"].summary().items()})
    emit("serve_wall", card=card, model=cfg.name, dtype=name,
         wall_s=run["wall_s"], generated_tokens=run["generated_tokens"],
         tokens_per_s=run["generated_tokens"] / run["wall_s"],
         isolated_runs_wall_s=run["isolated_wall_s"])
    longest = max(reqs, key=lambda q: q.prompt.shape[1])
    prof = profile_request(run["executor"], run["engine"]._batch_dict(longest),
                           longest.max_new_tokens)
    emit("serve_profile", card=card, model=cfg.name, dtype=name,
         prompt_len=int(longest.prompt.shape[1]), **prof)
    pre = prof["prefill"]
    flash = pre["family_ms"]["flash_attention"]
    # the profiler's busy time cannot exceed the events' span around the
    # same work: a reading above it is the profiler's fault
    emit("serve_prefill", card=card, model=cfg.name, dtype=name,
         wall_s=run["wall_s"], prompt_len=int(longest.prompt.shape[1]),
         prefill_wall_ms=pre["wall_ms"], prefill_device_ms=pre["device_ms"],
         prefill_event_ms=pre["event_ms"],
         profile_over_events=pre["device_ms"] / pre["event_ms"],
         profile_within_events=pre["device_ms"] <= pre["event_ms"] * 1.001,
         flash_ms=flash, flash_share_of_device=flash / pre["device_ms"])
    if cfg.encoder_only:
        return run["checks"]["engine_launches"]
    state = prof["decode"]["state"]
    recurrent = all(m != "attn" for m, _ in cfg.block_pattern)
    if recurrent and len(set(state["cache_bytes"])) != 1:
        raise SystemExit(f"{cfg.name}: the decode state's size depends on "
                         f"the context: {state}")
    first, last = state["kv_positions"]
    if "cross_attn" in first and not (
            first["cross_attn"] == last["cross_attn"] == cfg.img_tokens
            and last["attn"] > first["attn"]):
        raise SystemExit(f"{cfg.name}: the image K/V must hold img_tokens "
                         "positions from the first token to the last while "
                         f"the self-attention K/V grow: {state}")
    return run["checks"]["engine_launches"]


def phase_serve_f32(card: str):
    """The serving path in f32, the JAX package's dtype: 3 requests, the
    first with a 2048-token prompt.  The bf16 model is gone by now."""
    gc.collect()
    torch.cuda.empty_cache()
    return phase_serve(card, dtype=torch.float32, n_requests=3,
                       first_len=2048)


def phase_serve_moe(card: str):
    """Full-width qwen3-moe-30b-a3b (48 layers, d_model 2048, 128 experts,
    top 8; 61.1 GB of weights) in bf16: 4 requests, the first with a
    2048-token prompt.  Its prefill runs the wgmma flash kernel at 4 KV
    heads and its decode the decode kernel's group of 8 (32 query heads
    over 4 KV heads).  bf16 only: in f32 its weights are 122 GB, more than
    the card holds.  Every earlier model is freed first."""
    gc.collect()
    torch.cuda.empty_cache()
    return phase_serve(card, "qwen3-moe-30b-a3b", n_requests=4,
                       first_len=2048)


def phase_serve_dense(card: str):
    """3 requests each on full-width olmo-1b (MHA, so decode's group of 1;
    non-parametric LayerNorm, tied embeddings) and qwen1.5-4b (MHA, QKV
    bias) in bf16; the launches of both runs add up."""
    total = _no_launches()
    for arch in ("olmo-1b", "qwen1.5-4b"):
        gc.collect()
        torch.cuda.empty_cache()
        for counter, n in phase_serve(card, arch, n_requests=3).items():
            total[counter] += n
    return total


def phase_serve_ssm(card: str):
    """(a) Full-width xlstm-350m (24 layers, d_model 1024, 4 heads, vocab
    50,304; sLSTM and mLSTM blocks 1:7, no attention) in bf16: 3
    requests, checked as in 5 with no attention launch allowed, and the
    profiled request's decode state's bytes equal at its first and last
    token.
    (b) jamba-1.5-large's Mamba mixer alone at full width.  Every earlier
    model is freed first."""
    gc.collect()
    torch.cuda.empty_cache()
    launches = phase_serve(card, "xlstm-350m", n_requests=3)
    gc.collect()
    torch.cuda.empty_cache()
    mamba_full_width(card)
    return launches


def phase_serve_vlm_audio(card: str):
    """(a) Full-width llama-3.2-vision-11b (40 layers, d_model 4096, 32
    query heads over 8 KV heads, cross-attention at slot 4 of 5; 19.6 GB
    of weights) in bf16: 4 requests, the first with a 2048-token prompt,
    each with image embeddings (1, 1600, 1280); checked as in 5, with
    flash launched 5 times a prefill step (4 self, 1 cross, all wgmma),
    decode 40 times a decode step, and the profiled request's image K/V at
    1600 positions from its first token to its last while its
    self-attention K/V grow.
    (b) Full-width hubert-xlarge (48 layers, d_model 1280, 16 heads of 80,
    GELU, vocab 504) in bf16: 3 requests of frames, the first of 2048;
    each done after its prefill with no token and its engine run's logits
    at every position equal bit for bit to its isolated run's; flash
    once a prefill step, all on the wgmma kernel's D 80 instance, no
    decode.
    Every earlier model is freed first."""
    total = _no_launches()
    for arch, n in (("llama-3.2-vision-11b", 4), ("hubert-xlarge", 3)):
        gc.collect()
        torch.cuda.empty_cache()
        for counter, k in phase_serve(card, arch, n_requests=n,
                                      first_len=2048).items():
            total[counter] += k
    return total


CARRY_TOL = 2e-3     # prefill against incremental decode, as in
                     # tests/test_models.py (rtol = atol = 2e-3)


def mamba_full_width(card: str) -> None:
    """jamba-1.5-large-398b's Mamba mixer at its full widths (d_model
    8192, d_inner 16384, d_state 16, d_conv 4, dt_rank 128; 1.63 GB of
    f32 weights), on x (1, 2048, 8192) from a seeded generator:

    1. f32: ``mamba_prefill`` over 2048 tokens (16 chunks, 15 carries)
       against a prefill over the first 2032 (one chunk) and 16
       ``mamba_decode`` steps: the last 16 outputs and the final ``ssm``
       and ``conv`` within ``CARRY_TOL``;
    2. f32: card against CPU, the same weights, prefill over 256 tokens
       (2 chunks): output and states within TINY_TOL x max(1, max |CPU|);
    3. bf16: ``mamba_prefill`` over 2048 tokens and ``mamba_decode`` timed
       by CUDA events and by the profiler's device time."""
    from repro_torch import configs
    from repro_torch.models import ssm
    from repro_torch.params import F32_LEAVES

    cfg = configs.get_config("jamba-1.5-large-398b")
    gen = torch.Generator(device="cuda").manual_seed(0)
    p = ssm.init_mamba(cfg, gen, None, torch.float32, "cuda")
    x = torch.randn((1, 2048, cfg.d_model), generator=gen, device="cuda")
    with torch.inference_mode():
        carry, vs_cpu = mamba_checks(p, x, cfg)
        timed = time_mamba({k: v if k in F32_LEAVES else v.to(torch.bfloat16)
                            for k, v in p.items()}, x.to(torch.bfloat16), cfg)
    ok = all(r["ok"] for r in (carry, vs_cpu))
    emit("mamba_full_width", card=card, model=cfg.name,
         d_model=cfg.d_model, d_inner=cfg.mamba_d_inner,
         d_state=cfg.mamba_d_state, d_conv=cfg.mamba_d_conv,
         dt_rank=ssm._dt_rank(cfg), weights_gb_f32=nbytes(*p.values()) / 1e9,
         chunk=ssm.SCAN_CHUNK, carry=carry, card_vs_cpu=vs_cpu, bf16=timed)
    if not ok:
        raise SystemExit("jamba's Mamba mixer at full width: prefill against "
                         "decode or card against CPU out of tolerance")


def mamba_checks(p, x, cfg, n_decode: int = 16, s_cpu: int = 256):
    """Checks 1 and 2 of ``mamba_full_width`` for weights ``p`` and inputs
    x (1, S, D) on one device: the prefill over S against a prefill over
    S - ``n_decode`` and ``n_decode`` decode steps, and the prefill over
    ``s_cpu`` tokens there against the same on the CPU."""
    from repro_torch.models import ssm
    s = x.shape[1]
    y_full, st_full = ssm.mamba_prefill(x, p, cfg)
    _, st = ssm.mamba_prefill(x[:, :s - n_decode], p, cfg)
    ys = []
    for t in range(s - n_decode, s):
        y, st = ssm.mamba_decode(x[:, t:t + 1], p, cfg, st)
        ys.append(y)
    pairs = {"out": (torch.cat(ys, 1), y_full[:, s - n_decode:]),
             **{k: (st[k], st_full[k]) for k in st}}
    carry = {k: dict(max_abs_err=max_err(a, b), err_over_tol=over_tol(
        a, b, tolerance(b, (CARRY_TOL, CARRY_TOL))))
        for k, (a, b) in pairs.items()}
    carry = dict(S=s, decode_steps=n_decode, ok=all(
        r["err_over_tol"] <= 1.0 for r in carry.values()),
        tolerance=f"atol = rtol = {CARRY_TOL}", **carry)
    del y_full, st_full, st, ys, pairs

    y_dev, st_dev = ssm.mamba_prefill(x[:, :s_cpu], p, cfg)
    y_cpu, st_cpu = ssm.mamba_prefill(x[:, :s_cpu].cpu(),
                                      {k: v.cpu() for k, v in p.items()}, cfg)
    vs_cpu = {}
    for k, (a, b) in {"out": (y_dev, y_cpu),
                      **{k: (st_dev[k], st_cpu[k]) for k in st_cpu}}.items():
        top = float(b.float().abs().max())
        vs_cpu[k] = dict(max_abs_err=max_err(a.cpu(), b), max_abs_cpu=top,
                         bound=TINY_TOL * max(1.0, top))
    vs_cpu = dict(S=s_cpu, ok=all(r["max_abs_err"] <= r["bound"]
                                  for r in vs_cpu.values()),
                  tolerance="TINY_TOL x max(1, max |CPU|)", **vs_cpu)
    return carry, vs_cpu


def time_mamba(p, x, cfg, decode_steps: int = 64) -> dict:
    """bf16 ``mamba_prefill`` over x's 2048 tokens and ``decode_steps``
    ``mamba_decode`` steps from its state, each by CUDA events (after a
    warm-up) and by the profiler's device time over one call (the decode:
    over all steps); decode's bound is its weights read once at 3.35
    TB/s."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import ssm

    def prefill():
        return ssm.mamba_prefill(x, p, cfg)

    def decode(state):
        for t in range(decode_steps):
            _, state = ssm.mamba_decode(x[:, t:t + 1], p, cfg, state)

    state = prefill()[1]
    out = dict(S=int(x.shape[1]), prefill_event_ms=time_ms(prefill, [()], 3),
               decode_steps=decode_steps,
               decode_event_ms_per_step=time_ms(decode, [(state,)], 1)
               / decode_steps,
               decode_bound_ms_per_step=nbytes(*p.values())
               / HBM_BYTES_PER_S * 1e3)
    for name, fn, steps in (("prefill", prefill, 1),
                            ("decode", lambda: decode(state), decode_steps)):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        row = _device_breakdown(prof, wall)
        out[f"{name}_profile"] = dict(
            device_ms_per_step=row["device_ms"] / steps,
            launches_per_step=row["launches"] / steps, **row)
    return out


def _family(name: str) -> str:
    low = name.lower()
    if "flash_fwd_" in name:
        return "flash_attention"
    if "decode_split_kernel" in name:
        return "decode_attention"
    if any(k in low for k in ("gemm", "gemv", "nvjet", "xmma", "cutlass")):
        return "gemm"
    return "other"


def _device_breakdown(prof, wall_s: float, family=_family,
                      families=("flash_attention", "decode_attention",
                                "gemm", "other")) -> dict:
    """Device time by kernel family (``family`` maps a kernel's name to
    one of ``families``), launches and the six longest kernels, summed
    from the profiler's raw device events (kernels, copies, sets): the
    Python records behind ``key_averages()`` take minutes to build for
    the million launches of a recurrent prefill."""
    by_name = {}
    for evt in prof.profiler.kineto_results.events():
        if evt.device_type() == torch.autograd.DeviceType.CUDA:
            total = by_name.setdefault(evt.name(), [0.0, 0])
            total[0] += evt.duration_ns() / 1e6
            total[1] += 1
    fams = dict.fromkeys(families, 0.0)
    for name, (ms, _) in by_name.items():
        fams[family(name)] += ms
    device_ms = sum(fams.values())
    top = sorted(by_name.items(), key=lambda kv: kv[1][0], reverse=True)
    return dict(wall_ms=wall_s * 1e3, device_ms=device_ms,
                launches=sum(n for _, n in by_name.values()),
                idle_share=1.0 - device_ms / (wall_s * 1e3),
                family_ms=fams,
                top=[dict(ms=ms, count=n, name=k[:90])
                     for k, (ms, n) in top[:6]])


def _device_gaps(prof, wall_s: float, top: int = 5) -> dict:
    """Where the device waited in a profiled region: the union of its
    events' intervals (``span_ms`` from the first to the last, ``busy_ms``
    covered), the time between them (``gap_ms``, and in gaps over 1 ms),
    the wall outside the span (``outside_ms``: host time before the first
    launch and after the last), and the ``top`` longest gaps with their
    offset into the span and the events on either side."""
    ev = sorted((e.start_ns(), e.end_ns(), e.name())
                for e in prof.profiler.kineto_results.events()
                if e.device_type() == torch.autograd.DeviceType.CUDA)
    if not ev:
        return {}
    first, end, prev = ev[0][0], ev[0][1], ev[0][2]
    gaps = []
    for s, e, name in ev[1:]:
        if s > end:
            gaps.append((s - end, end - first, prev, name))
        if e > end:
            end, prev = e, name
    gap = sum(g[0] for g in gaps)
    gaps.sort(reverse=True)
    return dict(span_ms=(end - first) / 1e6, busy_ms=(end - first - gap) / 1e6,
                gap_ms=gap / 1e6,
                gaps_over_1ms=sum(g[0] > 1e6 for g in gaps),
                gap_over_1ms_ms=sum(g[0] for g in gaps if g[0] > 1e6) / 1e6,
                outside_ms=wall_s * 1e3 - (end - first) / 1e6,
                longest=[dict(ms=g / 1e6, at_ms=at / 1e6, after=a[:60],
                              before=b[:60]) for g, at, a, b in gaps[:top]])


def _kv_positions(st, cfg) -> dict:
    """Positions the decode cache holds, per kind of attention slot."""
    return {m: st.cache[f"slot{i}"]["k"].shape[2]
            for i, (m, _) in enumerate(cfg.block_pattern)
            if m in ("attn", "cross_attn")}


def profile_request(executor, batch: dict, max_new_tokens: int) -> dict:
    """Device time by kernel family (``torch.profiler``, CUDA activity
    only) for the prefill and then the decode of one isolated request,
    beside the span of CUDA events recorded around the same steps; for
    the decode also its state's context, bytes (``cache_bytes()``) and
    attention positions per slot kind before its first and after its last
    step.  An encoder-only model has no decode."""
    from torch.profiler import ProfilerActivity, profile
    st = executor.start(batch)
    out = {}
    for phase in ("prefill", "decode"):
        if st.phase != phase:
            break
        before = (st.pos, st.cache_bytes(), _kv_positions(st, executor.cfg)
                  if st.cache is not None else {})
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            start.record()
            steps = 0
            while st.phase == phase and len(st.tokens_out) < max_new_tokens:
                st = executor.step(st)
                steps += 1
            end.record()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        out[phase] = dict(steps=steps, event_ms=start.elapsed_time(end),
                          **_device_breakdown(prof, wall))
        out[phase]["device_ms_per_step"] = out[phase]["device_ms"] / steps
    if "decode" in out:
        out["decode"]["state"] = dict(
            context=[before[0], st.pos],
            cache_bytes=[before[1], st.cache_bytes()],
            kv_positions=[before[2], _kv_positions(st, executor.cfg)])
    return out


# --------------------------------------------------------------------------
# phase 6: the GEMM path at full width
# --------------------------------------------------------------------------
def phase_gemm_path(card: str) -> dict:
    """The demo's ``--full`` run in bf16 (the wgmma kernel) and in f32 (the
    reference demo's dtype, the CUDA-core kernel), each with its launch
    counts read on its own; the demo raises unless the preempted and
    uninterrupted accumulators are bitwise equal and within tolerance."""
    from repro_torch.examples import preemptible_kernel_demo as demo
    from repro_torch.kernels.preemptible_matmul.ops import kernel_variant
    total = {}
    for dtype in ("bfloat16", "float32"):
        counter = "preemptible_matmul/" + kernel_variant(
            getattr(torch, dtype), 128)
        _reset_launches()
        rep = demo.main(["--full", "--dtype", dtype, "--seed", "0"])
        torch.cuda.synchronize()
        got = _launches()
        expect = {**_no_launches(), counter: 1 + rep["n_quanta"]}
        if got != expect or rep["n_quanta"] != 48:
            raise SystemExit(f"GEMM path ({dtype}): kernel launches {got}, "
                             f"expected {expect} from 1 + {rep['n_quanta']} "
                             "launches (48 quanta)")
        emit("gemm_path", card=card, launches=got, **rep)
        total[counter] = got[counter]
    return total


# --------------------------------------------------------------------------
# phase 12: training
# --------------------------------------------------------------------------
TRAIN_TINY = ("olmo-1b", "qwen3-8b", "qwen3-moe-30b-a3b", "xlstm-350m",
              "jamba-1.5-large-398b", "llama-3.2-vision-11b", "hubert-xlarge")
# the full-width run: olmo-1b in f32 at the train_4k shape's sequence,
# global batch 8 in 4 microbatches of 2 (2 x 4096 x 50304 logits > 2**28:
# the chunked CE), 4 steps, an async checkpoint after step 2
TRAIN_ARGS = ["--arch", "olmo-1b", "--steps", "4", "--seq-len", "4096",
              "--global-batch", "8", "--grad-accum", "4", "--remat", "full",
              "--ckpt-every", "2", "--device", "cuda", "--dtype", "float32",
              "--seed", "0"]
TRAIN_CKPT = ROOT / "build" / "train_ckpt"


def tiny_train_card_vs_cpu(name: str) -> dict:
    """One ``make_train_step`` of tiny ``name`` in f32 (grad_accum 2,
    remat ``full``) on the card and on the CPU from the same weights and
    batch: the loss and grad norm within TINY_TOL x max(1, |CPU|), every
    new parameter leaf within TINY_TOL; for an MoE also the router's least
    top-k margin on the CPU."""
    from repro_torch.models import get_model
    from repro_torch.models.transformer import tree_leaves, tree_map
    from repro_torch.params import params_from_numpy
    from repro_torch.training import (DataConfig, TokenDataset, TrainConfig,
                                      init_opt_state, init_train_state,
                                      make_train_step)
    cfg = get_model(name, tiny=True).cfg
    tcfg = TrainConfig(remat="full", grad_accum=2)
    cpu, opt_cpu = init_train_state(cfg, tcfg, generator=torch.Generator()
                                    .manual_seed(1), device="cpu")
    gpu = params_from_numpy(tree_map(lambda x: x.numpy(), cpu), "cuda")
    opt_gpu = init_opt_state(gpu, tcfg.opt)
    batch = TokenDataset(DataConfig(seq_len=16, global_batch=4, seed=2),
                         cfg).batch_at(0)
    step = make_train_step(cfg, tcfg)
    margins = []
    with router_margins(margins):
        pc, _, mc = step(cpu, opt_cpu, batch)
        pg, _, mg = step(gpu, opt_gpu, batch)
    torch.cuda.synchronize()
    row = {k: dict(cpu=float(mc[k]), card=float(mg[k]),
                   bound=TINY_TOL * max(1.0, abs(float(mc[k]))))
           for k in ("loss", "grad_norm")}
    row["params_max_abs_err"] = max(max_err(a.cpu(), b) for a, b in
                                    zip(tree_leaves(pg), tree_leaves(pc)))
    row["lr"] = float(mg["lr"])
    if margins:
        row["router_topk_margin"] = min(margins)
    ok = (row["params_max_abs_err"] <= TINY_TOL
          and all(abs(row[k]["cpu"] - row[k]["card"]) <= row[k]["bound"]
                  for k in ("loss", "grad_norm")))
    if not ok:
        raise SystemExit(f"{name}: a training step on the card differs from "
                         f"the CPU's: {row}")
    return row


def _train_family(name: str) -> str:
    """Kernel families of a training step's gradient part."""
    low = name.lower()
    if any(k in low for k in ("gemm", "gemv", "nvjet", "xmma", "cutlass")):
        return "gemm"
    if any(k in low for k in ("elementwise", "reduce", "softmax",
                              "vectorized", "unrolled")):
        return "softmax_elementwise"
    return "other"


def reference_lr(step: int, opt) -> float:
    """The reference's ``lr_at`` for one step, in numpy f32 op for op."""
    f32 = np.float32
    s = f32(step)
    warm = f32(opt.peak_lr) * s / f32(max(opt.warmup_steps, 1))
    prog = np.clip((s - f32(opt.warmup_steps))
                   / f32(max(opt.total_steps - opt.warmup_steps, 1)),
                   f32(0), f32(1))
    cos = f32(opt.min_lr_frac) + f32((1 - opt.min_lr_frac) * 0.5) * (
        f32(1) + np.cos(f32(np.pi) * prog))
    return float(warm if s < opt.warmup_steps else f32(opt.peak_lr) * cos)


def train_flops(cfg, tokens: int, seq: int) -> dict:
    """Forward FLOPs of one step's work from the shapes: every 2-D product
    (2 per weight and token; the tied table once, as the unembed) and
    attention's two batched products over every chunk of keys (the
    reference's chunked path computes masked chunks too): model FLOPs
    are 3 forwards (forward and backward), the executed ones add the
    recompute of remat ``full`` (the stack and the CE chunks: one more
    forward)."""
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    per_layer = d * (hq + 2 * hkv) * dh + hq * dh * d + 3 * d * f
    gemm = 2 * tokens * (cfg.n_layers * per_layer + d * v)
    attn = cfg.n_layers * 4 * tokens * seq * hq * dh
    fwd = gemm + attn
    return dict(forward=fwd, model=3 * fwd, executed=4 * fwd)


def profile_train_step(run, params, opt, batch) -> dict:
    """One step's device time (``torch.profiler``, CUDA activity) in its
    two parts, as ``make_train_step`` composes them: the gradient
    (microbatches' forward, recompute and backward, accumulation) by
    kernel family, then the update (AdamW), all of it family
    ``optimizer``; the idle share over both walls, and each part's peak
    of allocated memory; per part, where the device waited
    (``_device_gaps``)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.training.train_step import make_grad_fn, update
    grad_fn = make_grad_fn(run.cfg, run.tcfg)
    parts = {}
    torch.cuda.synchronize()
    peaks = {}
    for part in ("gradient", "update"):
        torch.cuda.reset_peak_memory_stats()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            if part == "gradient":
                _, _, grads = grad_fn(params, batch)
            else:
                update(params, grads, opt, run.tcfg)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        peaks[part] = torch.cuda.max_memory_allocated() / 1e9
        parts[part] = _device_breakdown(
            prof, wall, _train_family, ("gemm", "softmax_elementwise",
                                        "other"))
        parts[part]["gaps"] = _device_gaps(prof, wall)
    fam = dict(parts["gradient"]["family_ms"])
    fam["optimizer"] = parts["update"]["device_ms"]
    wall = sum(p["wall_ms"] for p in parts.values())
    device = sum(p["device_ms"] for p in parts.values())
    return dict(wall_ms=wall, device_ms=device, idle_share=1 - device / wall,
                family_ms=fam, peak_mem_gb=peaks,
                launches=sum(p["launches"] for p in parts.values()),
                top=parts["gradient"]["top"], update_top=parts["update"]["top"],
                gaps={k: p["gaps"] for k, p in parts.items()})


def _local(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (the whole leaf on a (1, 1) mesh)."""
    from torch.distributed.tensor import DTensor
    return x.to_local() if isinstance(x, DTensor) else x


def train_full_width(card: str) -> dict:
    """Full-width olmo-1b (16 layers, d_model 2048, 16 heads of 128, vocab
    50,304; 1.177 B parameters) trained in f32 through the launcher's parts
    in order (``repro_torch.launch.train``, under its default ``--mesh
    host``: an NCCL world of one, a (1, 1) mesh, DTensor state): 4 steps
    from a seeded init with an async checkpoint after step 2 (and one
    after step 4, the cadence's); then the step-2 checkpoint restored onto
    the mesh and steps 3-4 run again, every parameter and moment leaf
    required equal bit for bit; a finite loss and grad norm and the
    reference's lr at every step; no flash or decode launch.  The mesh
    step runs the tensor-parallel code at a 'model' size of 1: the
    checkpoint's steps 3-4 are also taken without the mesh
    (``make_train_step`` on the local tensors), and must leave the same
    bits, their walls beside the mesh steps'.  Then one more step
    profiled, twice."""
    from repro_torch.launch import train as launcher
    from repro_torch.models.transformer import tree_leaves, tree_map
    from repro_torch.training import checkpoint, make_train_step

    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    args = launcher.parse_args(TRAIN_ARGS + ["--ckpt-dir", str(TRAIN_CKPT)])
    run = launcher.setup(args)
    cfg, b, s = run.cfg, args.global_batch, args.seq_len
    micro = b // args.grad_accum
    t0 = time.perf_counter()
    start, state = launcher.init_or_resume(run, args)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(x.numel() for x in tree_leaves(state["params"]))
    state_gb = 4 * n_params / 1e9     # one f32 copy of the parameters
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    log = []
    t0 = time.perf_counter()
    launcher.train(run, args, state, start, log)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    saved = sorted(os.listdir(TRAIN_CKPT))

    t0 = time.perf_counter()
    step, again = launcher.restore(run, str(TRAIN_CKPT), step=2)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    args.ckpt_dir = None
    log2 = []
    launcher.train(run, args, again, step, log2)
    n_leaves = len(tree_leaves(state))
    differ = sum(not torch.equal(_local(a), _local(c)) for a, c in
                 zip(tree_leaves(state), tree_leaves(again)))
    del again
    gc.collect()
    torch.cuda.empty_cache()
    # the same two steps from the checkpoint, meshless on the local tensors
    step, plain = launcher.restore(run, str(TRAIN_CKPT), step=2)
    plain = tree_map(_local, plain)
    step_fn = make_train_step(cfg, run.tcfg)
    meshless = []
    for i in range(step, args.steps):
        t = time.perf_counter()
        plain["params"], plain["opt"], m = step_fn(
            plain["params"], plain["opt"], run.data.batch_at(i))
        meshless.append({"step": i + 1, **{k: float(m[k]) for k in
                                           ("loss", "grad_norm", "lr")},
                         "wall_s": time.perf_counter() - t})
    meshless_differ = sum(not torch.equal(_local(a), c) for a, c in
                          zip(tree_leaves(state), tree_leaves(plain)))
    del plain
    gc.collect()
    torch.cuda.empty_cache()
    prof = profile_train_step(run, state["params"], state["opt"],
                              run.data.batch_at(args.steps))
    prof_again = profile_train_step(run, state["params"], state["opt"],
                                    run.data.batch_at(args.steps))
    launches = _launches()
    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)

    lr_ref = [reference_lr(e["step"], run.tcfg.opt) for e in log]
    steady = [e["wall_s"] for e in log[1:]]
    step_s = sum(steady) / len(steady)
    flops = train_flops(cfg, b * s, s)
    row = dict(
        card=card, model=cfg.name, dtype="float32", n_params=n_params,
        seq_len=s, global_batch=b, grad_accum=args.grad_accum,
        microbatch=micro, remat=args.remat,
        chunked_ce=micro * s * cfg.vocab_size > 2 ** 28,
        param_init_s=init_s, steps=log, restart_steps=log2,
        meshless_steps=meshless, meshless_leaves_differ=meshless_differ,
        restart_wall_over_meshless=sum(e["wall_s"] for e in log2)
        / sum(e["wall_s"] for e in meshless),
        checkpoints_written=saved, checkpoint_load_s=load_s,
        train_wall_s=train_s,
        outside_steps_s=train_s - sum(e["wall_s"] for e in log),
        step_wall_s=step_s, step_wall_note="mean of steps 2-4",
        tokens_per_s=b * s / step_s,
        peak_mem_gb=peak_gb,
        reckoned_gb=dict(params=state_gb, grads=state_gb,
                         adamw_moments=2 * state_gb,
                         grad_accumulator=state_gb, total=5 * state_gb),
        profiled_step=prof,
        profiled_again={k: prof_again[k] for k in (
            "wall_ms", "device_ms", "idle_share", "launches", "gaps")},
        flops_per_step=flops,
        model_flops_share_of_f32_peak=flops["model"] / step_s
        / PEAK_OPS[torch.float32],
        executed_flops_share_of_f32_peak=flops["executed"] / step_s
        / PEAK_OPS[torch.float32],
        lr=[e["lr"] for e in log], lr_reference=lr_ref,
        leaves_compared=n_leaves, leaves_differ=differ,
        launches=launches)
    emit("train", **row)
    bad = []
    if differ:
        bad.append(f"{differ} of {n_leaves} leaves differ after restart")
    if meshless_differ:
        bad.append(f"{meshless_differ} of {n_leaves} leaves differ between "
                   "the mesh and the meshless steps 3-4")
    if [e["step"] for e in log] != [1, 2, 3, 4] or [e["step"] for e in
                                                   log2] != [3, 4] \
            or [e["step"] for e in meshless] != [3, 4]:
        bad.append("wrong steps run")
    if not all(np.isfinite(e[k]) for e in log + log2 + meshless
               for k in ("loss", "grad_norm")):
        bad.append("a non-finite loss or grad norm")
    if any(abs(a - r) > 1e-6 * r for a, r in zip(row["lr"], lr_ref)):
        bad.append("lr differs from the reference's schedule")
    if any(n for n in launches.values()):
        bad.append(f"kernel launches while training: {launches}")
    if not row["chunked_ce"] or saved[:1] != ["step_0000000002"]:
        bad.append(f"not the chunked CE, or no step-2 checkpoint: {saved}")
    if bad:
        raise SystemExit(f"full-width training: {bad}")
    return launches


def phase_train(card: str):
    """The training path: the flash wrapper refuses an input that requires
    grad; tiny archs train a step on the card as on the CPU; full-width
    olmo-1b trains in f32 and restarts bit-exact from its async
    checkpoint.  No flash or decode kernel launches in either."""
    from repro_torch.kernels.flash_attention import flash_attention
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    gc.collect()
    torch.cuda.empty_cache()
    q = torch.zeros((1, 2, 8, 16), device="cuda", requires_grad=True)
    k = torch.zeros((1, 2, 8, 16), device="cuda")
    try:
        flash_attention(q, k, k)
    except RuntimeError as e:
        refused = str(e)
    else:
        raise SystemExit("flash_attention took an input that requires grad")
    _reset_launches()
    tiny = {name: tiny_train_card_vs_cpu(name) for name in TRAIN_TINY}
    got = _launches()
    emit("train_tiny_card_vs_cpu", dtype="float32", grad_accum=2,
         remat="full", tol=TINY_TOL, flash_refuses_grad=refused,
         launches=got, **tiny)
    if any(got.values()):
        raise SystemExit(f"kernel launches while training tiny models: {got}")
    gc.collect()
    torch.cuda.empty_cache()
    return train_full_width(card)


# --------------------------------------------------------------------------
# phase 13: distributed
# --------------------------------------------------------------------------
# the mesh run's arguments: phase train's shape, 2 steps, no checkpoint
DIST_ARGS = ["--arch", "olmo-1b", "--steps", "2", "--seq-len", "4096",
             "--global-batch", "8", "--grad-accum", "4", "--remat", "full",
             "--device", "cuda", "--dtype", "float32", "--seed", "0",
             "--mesh", "host"]
MOE_TOL = 1e-5          # relative to the local path's largest magnitude


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def distributed_olmo(run, args) -> dict:
    """Full-width olmo-1b in f32 through the launcher's parts under an NCCL
    world of one and its (1, 1) mesh (parameters and moments DTensors on
    the card, every collective of the sharded step called): 2 steps; then
    the state resharded onto a fresh (1, 1) mesh and back, lossless; then,
    the first state freed, 2 meshless steps (``make_train_step``) from the
    same seed, whose every parameter and moment must equal the mesh run's
    bit for bit.  Each
    run's peak is read before one more step of it is profiled
    (``profile_train_step``, the update's result dropped)."""
    from torch.distributed.tensor import DTensor
    from repro_torch.distributed import elastic
    from repro_torch.distributed.context import use_rules
    from repro_torch.launch import train as launcher
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import tree_leaves
    from repro_torch.training import init_train_state, make_train_step

    def moments(st):
        return tree_leaves({"params": st["params"], "m": st["opt"]["m"],
                            "v": st["opt"]["v"]})

    b, s = args.global_batch, args.seq_len
    t0 = time.perf_counter()
    start, state = launcher.init_or_resume(run, args)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(x.numel() for x in tree_leaves(state["params"]))
    on_mesh = all(isinstance(x, DTensor) and x.device_mesh.device_type ==
                  "cuda" for x in moments(state))
    n_leaves = len(moments(state))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mesh_log = []
    launcher.train(run, args, state, start, mesh_log)
    torch.cuda.synchronize()
    mesh_peak = torch.cuda.max_memory_allocated() / 1e9
    with use_rules(run.mesh, run.rules):
        mesh_prof = profile_train_step(run, state["params"], state["opt"],
                                       run.data.batch_at(args.steps))

    # elastic: onto a fresh (1, 1) mesh and back
    t0 = time.perf_counter()
    fresh = make_mesh((1, 1), ("data", "model"), "cuda")
    there = elastic.reshard(state, run.cfg, fresh)
    torch.cuda.synchronize()
    reshard_s = time.perf_counter() - t0
    there_differ = sum(not torch.equal(_local(a), _local(c)) for a, c in
                       zip(moments(state), moments(there)))
    del there
    back = elastic.reshard(elastic.reshard(state, run.cfg, fresh), run.cfg,
                           run.mesh)
    back_differ = sum(not torch.equal(_local(a), _local(c)) for a, c in
                      zip(moments(state), moments(back)))
    back_on_mesh = all(x.device_mesh is run.mesh.device_mesh
                       for x in moments(back))
    del back
    host = [_local(x).cpu() for x in moments(state)]
    del state
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    p, o = init_train_state(run.cfg, run.tcfg, generator=gen,
                            dtype=torch.float32, device="cuda")
    torch.cuda.synchronize()
    plain_init_s = time.perf_counter() - t0
    step = make_train_step(run.cfg, run.tcfg)
    torch.cuda.reset_peak_memory_stats()
    plain_log = []
    for i in range(start, args.steps):
        t = time.perf_counter()
        p, o, m = step(p, o, run.data.batch_at(i))
        plain_log.append({"step": i + 1, **{k: float(m[k]) for k in
                                            ("loss", "grad_norm", "lr")},
                          "wall_s": time.perf_counter() - t})
    torch.cuda.synchronize()
    plain_peak = torch.cuda.max_memory_allocated() / 1e9
    plain_prof = profile_train_step(run, p, o, run.data.batch_at(args.steps))
    plain = moments({"params": p, "opt": o})
    differ = sum(not torch.equal(h.cuda(), x) for h, x in zip(host, plain))
    max_diff = max(float((h.cuda() - x).abs().max())
                   for h, x in zip(host, plain))
    del p, o, plain, host
    gc.collect()
    torch.cuda.empty_cache()

    def summary(log, init, peak, prof):
        return dict(init_s=init, steps=log,
                    step_wall_s=log[-1]["wall_s"],
                    tokens_per_s=b * s / log[-1]["wall_s"], peak_mem_gb=peak,
                    profiled_step={k: prof[k] for k in (
                        "wall_ms", "device_ms", "idle_share", "family_ms",
                        "launches", "gaps")})
    row = dict(model=run.cfg.name, dtype="float32",
               n_params=n_params, seq_len=s,
               global_batch=b, grad_accum=args.grad_accum, remat=args.remat,
               mesh=dict(zip(run.mesh.axis_names,
                             run.mesh.devices.shape)),
               step_wall_note="the last step's (the first warms up)",
               mesh_run=summary(mesh_log, init_s, mesh_peak, mesh_prof),
               meshless_run=summary(plain_log, plain_init_s, plain_peak,
                                    plain_prof),
               params_and_moments_dtensors_on_cuda=on_mesh,
               leaves_compared=n_leaves,
               leaves_differ=differ, max_abs_diff=max_diff,
               step_wall_ratio=mesh_log[-1]["wall_s"]
               / plain_log[-1]["wall_s"],
               reshard=dict(seconds=reshard_s, onto_fresh_differ=there_differ,
                            back_differ=back_differ,
                            back_on_the_run_mesh=back_on_mesh))
    return row


def distributed_moe_layer(mesh) -> dict:
    """One full-width qwen3-moe-30b-a3b MoE layer in f32 (128 experts,
    d_model 2048, d_ff 768, top 8; capacity_factor 16, so no copy drops)
    under the card's (1, 1) mesh: ``moe_ffn_sharded`` at T 4096 and
    ``moe_ffn_psum`` at T 1 and 8 against the local ``moe.moe_ffn`` on the
    same weights and tokens: outputs and the gradients of x, router,
    w_in, w_gate and w_out within MOE_TOL relative; forward and backward
    times by CUDA events beside the local path's."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch import configs
    from repro_torch.distributed import collectives as col
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.context import use_rules
    from repro_torch.models import moe, moe_sharded

    cfg = dataclasses.replace(configs.get_config("qwen3-moe-30b-a3b"),
                              capacity_factor=16.0)
    gen = torch.Generator(device="cuda").manual_seed(5)
    w = moe.init_moe(cfg, gen, None, torch.float32, "cuda")
    dm = mesh.device_mesh
    place = shd.param_placements({"ffn": w}, cfg, mesh)["ffn"]
    rows = {}
    for t, which in ((4096, "a2a"), (1, "psum"), (8, "psum")):
        x = torch.randn((t, cfg.d_model), generator=gen, device="cuda")
        cot = torch.randn((t, cfg.d_model), generator=gen, device="cuda")
        fn = (moe_sharded.moe_ffn_sharded if which == "a2a"
              else moe_sharded.moe_ffn_psum)

        def local_inputs():
            return (x.clone().requires_grad_(True),
                    {k: v.clone().requires_grad_(True) for k, v in w.items()})

        def sharded_inputs():
            return (x.clone().requires_grad_(True),
                    {k: distribute_tensor(v, dm, place[k]).requires_grad_(True)
                     for k, v in w.items()})

        def local(xr, wr):
            out, _ = moe.moe_ffn(xr, wr, cfg)
            (out * cot).sum().backward()
            return out.detach()

        def sharded(xs, ws):
            with use_rules(mesh, {}) as ctx:
                out, _ = fn(xs, ws, cfg, ctx)
            (out * cot).sum().backward()
            return out.detach()

        with use_rules(mesh, {}) as ctx:
            ok = (moe_sharded.sharded_applicable(cfg, ctx, t)
                  if which == "a2a" else
                  moe_sharded.psum_applicable(cfg, ctx, t))
        xr, wr = local_inputs()
        ref = local(xr, wr)
        xs, ws = sharded_inputs()
        got = sharded(xs, ws)
        err = {"out": _rel(got, ref), "x": _rel(xs.grad, xr.grad)}
        for k, v in ws.items():
            col.sum_replicated(v.grad.to_local(), v.grad.placements, dm)
            err[k] = _rel(v.grad.full_tensor(), wr[k].grad)
        del xr, wr, ref, xs, ws, got
        # forward and backward alone, inputs made before the events
        times = {}
        for name, make, run_fn in (("local", local_inputs, local),
                                   (which, sharded_inputs, sharded)) * 2:
            args = make()
            run_fn(*args)
            args = make()
            torch.cuda.synchronize()
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            run_fn(*args)
            e1.record()
            torch.cuda.synchronize()
            times.setdefault(f"{name}_fwd_bwd_ms", []).append(
                e0.elapsed_time(e1))
            del args
        gc.collect()
        torch.cuda.empty_cache()
        rows[f"{which}_T{t}"] = dict(applicable=ok, rel_err=err, **times)
    bad = {k: r for k, r in rows.items() if not r["applicable"] or
           max(r["rel_err"].values()) > MOE_TOL}
    if bad:
        raise SystemExit(f"MoE expert-parallel paths differ from the local "
                         f"path: {bad}")
    return dict(model=cfg.name, dtype="float32", n_experts=cfg.n_experts,
                d_model=cfg.d_model, d_ff=cfg.d_ff, top_k=cfg.top_k,
                capacity_factor=cfg.capacity_factor, tol=MOE_TOL, paths=rows)


def distributed_plan() -> list:
    """``elastic.plan`` for full-width qwen3-8b and olmo-1b training state
    (f32 parameters and AdamW moments, on meta tensors) from one H100 to
    the launcher's host mesh on 2, 4 and 8 (80 GB each): reckoned, not
    measured."""
    from repro_torch import configs
    from repro_torch.distributed import elastic
    from repro_torch.distributed.context import ShapeMesh
    from repro_torch.training import TrainConfig, init_train_state
    out = []
    axes = ("data", "model")
    for arch in ("qwen3-8b", "olmo-1b"):
        cfg = configs.get_config(arch)
        state = dict(zip(("params", "opt"), init_train_state(
            cfg, TrainConfig(), generator=torch.Generator(), device="meta")))
        for n in (2, 4, 8):
            pl = elastic.plan(state, cfg, ShapeMesh((1, 1), axes),
                              ShapeMesh((1, n), axes))
            out.append(dict(model=arch, n_from=pl.n_from, n_to=pl.n_to,
                            gb_per_device_from=pl.bytes_per_device_from / 1e9,
                            gb_per_device_to=pl.bytes_per_device_to / 1e9,
                            fits_80gb=pl.fits))
    return out


def phase_distributed(card: str):
    """The distributed path on one card: NCCL, a (1, 1) DeviceMesh,
    DTensor state, the sharded step's collectives, the expert-parallel
    MoE paths, elastic resharding and the memory plan; no flash or
    decode launch."""
    import torch.distributed as dist
    from repro_torch.launch import train as launcher
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    gc.collect()
    torch.cuda.empty_cache()
    args = launcher.parse_args(DIST_ARGS)
    run = launcher.setup(args)
    backend = dist.get_backend()
    _reset_launches()
    olmo = distributed_olmo(run, args)
    moe_layer = distributed_moe_layer(run.mesh)
    launches = _launches()
    plan = distributed_plan()
    emit("distributed", card=card, backend=backend,
         world=dist.get_world_size(), olmo_1b=olmo, moe_layer=moe_layer,
         plan_reckoned=plan, launches=launches)
    bad = []
    if backend != "nccl":
        bad.append(f"backend {backend}, not nccl")
    if not olmo["params_and_moments_dtensors_on_cuda"]:
        bad.append("the mesh run's state is not DTensors on the card")
    if olmo["leaves_differ"]:
        bad.append(f"{olmo['leaves_differ']} leaves of the mesh and meshless "
                   f"runs differ, by up to {olmo['max_abs_diff']}")
    if olmo["reshard"]["onto_fresh_differ"] or olmo["reshard"]["back_differ"] \
            or not olmo["reshard"]["back_on_the_run_mesh"]:
        bad.append(f"resharding is not lossless: {olmo['reshard']}")
    runs = (olmo["mesh_run"], olmo["meshless_run"])
    if not all(np.isfinite(e[k]) for r in runs for e in r["steps"]
               for k in ("loss", "grad_norm")):
        bad.append("a non-finite loss or grad norm")
    if any(n for n in launches.values()):
        bad.append(f"kernel launches on the distributed path: {launches}")
    if bad:
        raise SystemExit(f"distributed: {bad}")
    return launches


# --------------------------------------------------------------------------
# phase 14: dryrun
# --------------------------------------------------------------------------
# phase train's full-width step, once, as the launcher runs it
DRYRUN_ARGS = ["--arch", "olmo-1b", "--steps", "1", "--seq-len", "4096",
               "--global-batch", "8", "--grad-accum", "4", "--remat", "full",
               "--device", "cuda", "--dtype", "float32", "--seed", "0"]
# full-width xlstm-350m's first train steps (24 layers, f32): seq 512, four
# chunks of its scans, each rematerialised inside the period's remat;
# the first counted while the dry-runs trace, the second timed after them
DRYRUN_SSM_ARGS = ["--arch", "xlstm-350m", "--steps", "2", "--seq-len",
                   "512", "--global-batch", "2", "--grad-accum", "1",
                   "--remat", "full", "--device", "cuda", "--dtype",
                   "float32", "--seed", "0"]
# a real step's counterpart: the dry-run's (1, 1) cell of the same step on
# fake tensors of the card, the scans' turns counted (arch, seq, global
# batch, grad_accum as its one argument)
DRYRUN_STEP = """
import json, sys, torch
from repro_torch import configs
from repro_torch.configs import Shape
from repro_torch.launch import dryrun
from repro_torch.training import TrainConfig
arch, seq, batch, ga = json.loads(sys.argv[1])
with dryrun.fake_mesh((1, 1), ("data", "model"), "cuda") as mesh:
    r = dryrun.trace_step(configs.get_config(arch),
                          Shape("train", "train", seq, batch), mesh,
                          tcfg=TrainConfig(remat="full", grad_accum=ga),
                          dtype=torch.float32, device="cuda")
print(json.dumps(r))
"""
DRYRUN_STEPS = {"counterpart": ["olmo-1b", 4096, 8, 4],
                "ssm_counterpart": ["xlstm-350m", 512, 2, 1]}
# the reference's own cells, through the dry-run's command line; the
# recurrent archs' train_4k and prefill_32k trace since their scans' turns
# are counted
DRYRUN_CELLS = (("olmo-1b", "train_4k", ["--by-label"]),
                ("xlstm-350m", "long_500k", []),
                ("xlstm-350m", "train_4k", []),
                ("jamba-1.5-large-398b", "prefill_32k", []))
# qwen3-8b x train_4k (GQA whose 8 KV heads do not divide 16, qk-norm, a
# vocabulary of 151,936 over 16) at 12 of its 36 layers, widths full: at
# full depth its trace alone takes some five minutes
DRYRUN_QWEN = """
import json
from repro_torch.launch import dryrun
print(json.dumps(dryrun.run_cell("qwen3-8b", "train_4k", False, verbose=False,
                                 cfg_overrides={"n_layers": 12})))
"""
# the olmo-1b train cell's FLOPs per device over the analytic count, and
# its peak no higher than the 14.83 GB it read with whole dense leaves on
# every 'model' rank (16.42x the analytic count)
DRYRUN_FACTOR = (0.9, 1.1)
DRYRUN_PEAK_GB = 14.83
# tiny xlstm-350m and jamba at two chunks of their scans: the chunk
# checkpoints nested in the period's (remat full) and in its
# selective-checkpoint context (remat dots) give remat none's gradients
REMAT_ARCHS = ("xlstm-350m", "jamba-1.5-large-398b")
REMAT_TOL = 1e-5        # relative to each gradient's largest magnitude


def _start(argv, out: Path):
    """A subprocess of this checkout's package writing its output to
    ``out``; (process, file, start time)."""
    fh = open(out, "w")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen([sys.executable] + argv, env=env, stdout=fh,
                            stderr=subprocess.STDOUT, cwd=ROOT)
    return proc, fh, time.time()


def _finish(job, what: str) -> float:
    """Wait for a ``_start`` job; its wall in seconds, to its output's
    last write (it may be waited for later).  Raises with its output's
    tail when it failed."""
    proc, fh, t0 = job
    try:
        rc = proc.wait(timeout=600)
    finally:
        fh.close()
    if rc:
        tail = Path(fh.name).read_text()[-3000:]
        raise SystemExit(f"dryrun: {what} exited {rc}:\n{tail}")
    return Path(fh.name).stat().st_mtime - t0


def dryrun_real_step(argv, before_timed=None) -> dict:
    """A full-width step through the launcher's parts (its NCCL (1, 1)
    mesh, DTensor state), as phase train runs it: FLOPs counted by
    ``FlopCounterMode`` and the peak of allocated memory over the step;
    where ``argv`` asks for a second step, its wall, uncounted, taken
    after ``before_timed()`` returns."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.launch import train as launcher
    args = launcher.parse_args(argv)
    steps, args.steps = args.steps, 1
    run = launcher.setup(args)
    _, state = launcher.init_or_resume(run, args)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    log = []
    with FlopCounterMode(display=False) as fc:
        launcher.train(run, args, state, 0, log)
    torch.cuda.synchronize()
    row = dict(flops=fc.get_total_flops(),
               peak_bytes=torch.cuda.max_memory_allocated(),
               loss=log[0]["loss"])
    if steps > 1:
        if before_timed is not None:
            before_timed()
        args.steps = 2
        launcher.train(run, args, state, 1, log)
        row.update(step_wall_s=log[1]["wall_s"], loss_2=log[1]["loss"])
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return row


def remat_nesting(device="cuda") -> dict:
    """Loss and every gradient of tiny ``REMAT_ARCHS`` (f32, seq 256: two
    chunks of their scans, batch 2) under remat ``full`` and ``dots``
    against ``none`` on ``device``: bit for bit or not, and the largest
    difference relative to each gradient's largest magnitude, which must
    stay within REMAT_TOL."""
    from repro_torch.models import get_model, ssm
    from repro_torch.models import transformer as tt
    from repro_torch.training import DataConfig, TokenDataset
    from repro_torch.training.train_step import batch_to_device
    rows = {}
    for name in REMAT_ARCHS:
        cfg = get_model(name, tiny=True).cfg
        params = tt.init_params(
            cfg, generator=torch.Generator(device=device).manual_seed(0),
            dtype=torch.float32, device=device)
        batch = batch_to_device(TokenDataset(DataConfig(
            seq_len=2 * ssm.SCAN_CHUNK, global_batch=2, seed=2),
            cfg).batch_at(0), device)
        out = {}
        for remat in ("none", "full", "dots"):
            aliases = tt.tree_map(lambda t: t.detach().requires_grad_(True),
                                  params)
            loss, _ = tt.train_loss(aliases, batch, cfg, remat=remat)
            out[remat] = (loss, torch.autograd.grad(
                loss, tt.tree_leaves(aliases)))
        loss0, grads0 = out.pop("none")
        rows[name] = {"loss": float(loss0.detach()), **{remat: dict(
            bit_for_bit=bool(torch.equal(loss, loss0) and all(
                torch.equal(a, b) for a, b in zip(grads, grads0))),
            max_rel_err=max(_rel(a, b) for a, b in zip(grads, grads0)))
            for remat, (loss, grads) in out.items()}}
    if any(r[m]["max_rel_err"] > REMAT_TOL for r in rows.values()
           for m in ("full", "dots")):
        raise SystemExit(f"dryrun: the remat policies disagree: {rows}")
    return rows


def _counterpart(dry: dict, real: dict, wall: float) -> dict:
    """A real step beside its dry-run counterpart."""
    return dict(
        flops_dryrun=dry["flops"], flops_real_step=real["flops"],
        flops_equal=dry["flops"] == real["flops"],
        peak_dryrun_gb=dry["memory"]["peak"] / 1e9,
        peak_real_step_gb=real["peak_bytes"] / 1e9,
        peak_ratio_dryrun_over_real=dry["memory"]["peak"]
        / real["peak_bytes"],
        memory_dryrun=dry["memory"], memory_source="MemTracker",
        collectives_dryrun={k: dry[k] for k in dry if k.startswith("coll")},
        n_collectives_dryrun=dry["n_collectives"],
        bytes_accessed_dryrun=dry["bytes_accessed"],
        trace_s=dry["trace_s"], wall_s=wall,
        real_step_loss=real["loss"])


def phase_dryrun(card: str):
    """The dry-run (``repro_torch.launch.dryrun``) held against the card:
    (a) the dry-run's (1, 1) counterpart of phase train's step (full-width
    olmo-1b, f32, seq 4096, global batch 8 in 4 microbatches, remat
    ``full``) on fake tensors of the card must count the FLOPs that
    ``FlopCounterMode`` counts over one real step of it, exactly; its
    memory peak stands beside the step's measured one, with their ratio;
    (b) the same for full-width xlstm-350m (24 layers, f32, seq 512, four
    chunks of its scans, global batch 2, remat ``full``): the real step
    runs every one of its 512 steps a layer, each chunk rematerialised,
    the dry-run counts each scan's turns between the first and the last
    once, multiplied; with the wall of a second, uncounted step;
    (c) the reference's cells olmo-1b x train_4k, xlstm-350m x long_500k
    and train_4k and jamba-1.5-large-398b x prefill_32k on the single-pod
    mesh, on fake tensors of the card (the command line's default), and
    qwen3-8b x train_4k at a third of its depth, each cell's result and
    wall, a train cell's FLOPs per device over the analytic count,
    collective bytes by kind and peak beside it; each ok, olmo-1b's
    factor in DRYRUN_FACTOR (the dense layers split over 'model') and its
    peak at or under DRYRUN_PEAK_GB.  Every dry-run runs in a subprocess
    of its own, where its fake process group never meets this process's
    NCCL group; they run while the real steps do, but for xlstm-350m's
    timed one, which runs after them, alone; (d) ``remat_nesting``: the
    chunk checkpoints nested in the period's on this torch.  No kernel
    launches."""
    out = ROOT / "build" / "dryrun"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    jobs = {name: _start(["-c", DRYRUN_STEP, json.dumps(step)],
                         out / f"{name}.log")
            for name, step in DRYRUN_STEPS.items()}
    for arch, shape, extra in DRYRUN_CELLS:
        jobs[f"{arch}|{shape}"] = _start(
            ["-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape",
             shape, "--mesh", "single",
             "--out", str(out / f"{arch}_{shape}.json")] + extra,
            out / f"{arch}_{shape}.log")
    jobs["qwen3-8b|train_4k"] = _start(["-c", DRYRUN_QWEN], out / "qwen.log")
    try:
        torch.use_deterministic_algorithms(True)
        torch.utils.deterministic.fill_uninitialized_memory = False
        gc.collect()
        torch.cuda.empty_cache()
        _reset_launches()
        real = dryrun_real_step(DRYRUN_ARGS)
        walls = {}
        real_ssm = dryrun_real_step(DRYRUN_SSM_ARGS, lambda: walls.update(
            {name: _finish(job, name) for name, job in jobs.items()}))
        nesting = remat_nesting()
        launches = _launches()
    finally:
        for proc, fh, _ in jobs.values():
            proc.kill()
            proc.wait()
            fh.close()
    last = lambda name: json.loads(
        (out / name).read_text().strip().splitlines()[-1])
    cells = {}
    for arch, shape, _ in DRYRUN_CELLS:
        key = f"{arch}|{shape}|single"
        cells[key] = dict(
            json.loads((out / f"{arch}_{shape}.json").read_text())[key],
            wall_s=walls[f"{arch}|{shape}"])
    cells["qwen3-8b|train_4k|single"] = dict(last("qwen.log"),
                                             wall_s=walls["qwen3-8b|train_4k"])
    train_cells = {k: dict(
        flops_over_analytic=c["flops_per_device"]
        / c["analytic_flops_per_device"],
        collective_gb={k2[len("coll_"):]: v / 1e9
                       for k2, v in c["collectives"].items()},
        peak_gb=c["memory"]["peak"] / 1e9, grad_accum=c["grad_accum"],
        overrides=c["deploy_overrides"])
        for k, c in cells.items() if c.get("grad_accum")}
    from repro_torch import configs
    cfg = configs.get_config("olmo-1b")
    counterpart = dict(
        _counterpart(last("counterpart.log"), real, walls["counterpart"]),
        flops_from_shapes_executed=train_flops(cfg, 8 * 4096, 4096)[
            "executed"])
    ssm = dict(_counterpart(last("ssm_counterpart.log"), real_ssm,
                            walls["ssm_counterpart"]),
               step_wall_s=real_ssm["step_wall_s"],
               tokens_per_s=2 * 512 / real_ssm["step_wall_s"],
               real_step_loss_2=real_ssm["loss_2"])
    emit("dryrun", card=card, counterpart=counterpart, ssm_counterpart=ssm,
         remat_nesting=nesting, cells=cells, train_cells=train_cells,
         launches=launches)
    bad = []
    for name, c in (("olmo-1b", counterpart), ("xlstm-350m", ssm)):
        if not c["flops_equal"]:
            bad.append(f"{name}: the dry-run counts {c['flops_dryrun']} "
                       f"FLOPs, the real step {c['flops_real_step']}")
    if any(c["status"] != "ok" for c in cells.values()):
        bad.append(f"a reference cell is not ok: "
                   f"{[c['status'] for c in cells.values()]}")
    olmo = train_cells.get("olmo-1b|train_4k|single", {})
    if not (DRYRUN_FACTOR[0] <= olmo.get("flops_over_analytic", 0)
            <= DRYRUN_FACTOR[1]) or olmo["peak_gb"] > DRYRUN_PEAK_GB:
        bad.append(f"olmo-1b x train_4k: {olmo}")
    if any(n for n in launches.values()):
        bad.append(f"kernel launches in the real steps: {launches}")
    if bad:
        raise SystemExit(f"dryrun: {bad}")
    return launches


# --------------------------------------------------------------------------
# phase 15: serve_sharded
# --------------------------------------------------------------------------
# decode_32k's cache and one rank's block of it on a 'model' axis of 16
SPLIT_T, SPLIT_BLOCK = 32768, 2048
SPLIT_POS = (0, 2047, 2048, 20000, 32767)
SPLIT_TIMED_POS = 20000
OFFSET_S, OFFSET_BLOCK = 2048, 512
SHARDED_PROMPT, SHARDED_STEPS = 2048, 32
# the reference's serving cells through the dry-run's command line on fake
# tensors of the card (16x16 mesh); FLOPs per device over the analytic
# count held to SERVE_FACTOR where the issue of whole leaves showed (16x)
SERVE_CELLS = (("olmo-1b", "prefill_32k"), ("qwen3-8b", "decode_32k"),
               ("qwen3-moe-30b-a3b", "decode_32k"))
SERVE_FACTOR = (0.9, 1.3)
SERVE_FACTOR_CELLS = ("olmo-1b|prefill_32k", "qwen3-8b|decode_32k")
# the new modes' rows, for the kernels line
MODE_ROWS = []


def _split_decode(q, k, v, pos, block=SPLIT_BLOCK):
    """The decode kernel over each block of ``block`` positions of the
    cache, at its local pos (-1 where the block lies past ``pos``), with
    its log-sum-exp: (outputs, lses) stacked over the blocks, as the
    processes of a cache split over 'model' compute them."""
    from repro_torch.kernels.decode_attention import decode_attention
    outs, lses = [], []
    for r in range(k.shape[2] // block):
        sl = slice(r * block, (r + 1) * block)
        o, l = decode_attention(q, k[:, :, sl], v[:, :, sl],
                                min(max(pos - r * block, -1), block - 1),
                                return_lse=True)
        outs.append(o)
        lses.append(l)
    return torch.stack(outs), torch.stack(lses)


def split_decode_case(gen, hkv: int) -> dict:
    """The decode kernel at qwen3-8b's shape (bf16, Hq 32, D 128; Hkv 8,
    or 4 for the group of 8) over a T 32768 cache split into 16 blocks of
    2048 (decode_32k's block on each of 16 'model' ranks), merged by
    ``merge_partials``' combine, against the unsplit kernel and the plain
    version at each pos of SPLIT_POS; blocks past pos must return zeros
    and -1e30 and weigh nothing.  Device times (CUDA-graph replays) of
    the 16 launches and the merge against one launch, at
    SPLIT_TIMED_POS."""
    from repro_torch.distributed.collectives import combine_partials
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_plain)
    from repro_torch.kernels.decode_attention.ref import (
        NEG_INF, merged_bf16_tolerance)
    F = torch.nn.functional
    dtype, t = torch.bfloat16, SPLIT_T

    def inputs():
        return (torch.randn((B, HQ, D), generator=gen, device="cuda",
                            dtype=dtype),
                _model_layout(gen, B, t, hkv, D, dtype),
                _model_layout(gen, B, t, hkv, D, dtype))
    q, k, v = inputs()
    checks = []
    for pos in SPLIT_POS:
        outs, lses = _split_decode(q, k, v, pos)
        merged = combine_partials(outs, lses)
        whole = decode_attention(q, k, v, pos)
        ref = decode_attention_plain(*as_f32(q, k, v), pos)
        tol = merged_bf16_tolerance(ref, outs, lses)
        whole_tol = tolerance(ref, TOL[dtype])
        live = [r for r in range(t // SPLIT_BLOCK) if pos >= r * SPLIT_BLOCK]
        empty = [r for r in range(t // SPLIT_BLOCK) if r not in live]
        empty_zero = all(bool((outs[r] == 0).all())
                         and bool((lses[r] == NEG_INF).all()) for r in empty)
        weightless = bool(torch.equal(
            combine_partials(outs[live], lses[live]), merged))
        ratio = over_tol(merged, ref, tol)
        ratio_whole = over_tol(merged, whole, tol + whole_tol)
        checks.append(dict(
            pos=pos, live_blocks=len(live), max_abs_err=max_err(merged, ref),
            err_over_tol=ratio, vs_whole_max_abs=max_err(merged, whole),
            vs_whole_over_tol=ratio_whole,
            whole_err_over_tol=over_tol(whole, ref, whole_tol),
            empty_blocks_zero=empty_zero,
            empty_blocks_weigh_nothing=weightless,
            ok=ratio <= 1 and ratio_whole <= 1 and empty_zero and weightless))
    pos = SPLIT_TIMED_POS
    sets = [(q, k, v)] + [inputs() for _ in range(1)]

    def split(q_, k_, v_):
        return combine_partials(*_split_decode(q_, k_, v_, pos))

    def library(q_, k_, v_):
        return F.scaled_dot_product_attention(
            q_[:, :, None], k_[:, :, :pos + 1], v_[:, :, :pos + 1],
            enable_gqa=True)
    live_bytes = 2 * B * hkv * (pos + 1) * D * k.element_size()
    ops = 4 * B * HQ * D * (pos + 1)
    t_ops = ops / PEAK_OPS[dtype]
    t_bytes = (nbytes(q, q) + live_bytes) / HBM_BYTES_PER_S
    return dict(
        kernel="decode_attention", mode="split_lse", dtype="bfloat16", Hq=HQ,
        Hkv=hkv, T=t, block=SPLIT_BLOCK, blocks=t // SPLIT_BLOCK,
        tolerance="merged_bf16_tolerance (decode_attention/ref.py)",
        checks=checks, max_abs_err=max(c["max_abs_err"] for c in checks),
        ok=all(c["ok"] for c in checks), timed_pos=pos,
        ms=time_ms(split, sets),
        plain_ms=time_ms(lambda a, b_, c: decode_attention_plain(a, b_, c,
                                                                 pos), sets),
        library_ms=time_ms(library, sets),
        device_ms=graph_ms(split, sets),
        whole_device_ms=graph_ms(
            lambda a, b_, c: decode_attention(a, b_, c, pos), sets),
        library_device_ms=graph_ms(library, sets),
        bound_ms=max(t_ops, t_bytes) * 1e3,
        bound_by="operations" if t_ops >= t_bytes else "bytes")


def offset_flash_case(gen, dtype) -> dict:
    """Flash at S = T 2048, causal, Hq 32 over Hkv 8, as four blocks of
    512 query rows at offsets 0-1536 (``q_offset``: the 'qseq' split of
    prefill), concatenated, against the whole sequence's launch and the
    plain version; whether the blocks equal the whole launch bit for
    bit; times of the four launches against the one."""
    from repro_torch.kernels.flash_attention import (bf16_tolerance,
                                                     flash_attention,
                                                     flash_attention_plain)
    from repro_torch.kernels.flash_attention.ops import kernel_variant
    F = torch.nn.functional
    s = OFFSET_S

    def inputs():
        return tuple(_model_layout(gen, B, s, h, D, dtype)
                     for h in (HQ, HKV, HKV))
    q, k, v = inputs()

    def blocks(q_, k_, v_):
        return torch.cat([flash_attention(q_[:, :, r:r + OFFSET_BLOCK], k_,
                                          v_, True, r)
                          for r in range(0, s, OFFSET_BLOCK)], dim=2)
    got = blocks(q, k, v)
    whole = flash_attention(q, k, v, True)
    ref = flash_attention_plain(*as_f32(q, k, v), True)
    variant = kernel_variant(dtype, D)
    tol = (bf16_tolerance(q, k, v, True) if variant == "wgmma"
           else tolerance(ref, TOL[dtype]))
    ratio = over_tol(got, ref, tol)
    bitwise = bool(torch.equal(got, whole))
    sets = [(q, k, v)] + [inputs() for _ in range(
        n_copies(nbytes(q, k, v)) - 1)]
    ops = 4 * B * HQ * D * s * (s + 1) // 2
    t_ops = ops / PEAK_OPS[dtype]
    t_bytes = nbytes(q, k, v, q) / HBM_BYTES_PER_S
    return dict(
        kernel="flash_attention", mode="q_offset", variant=variant,
        dtype=str(dtype).split(".")[1], D=D, Hq=HQ, Hkv=HKV, S=s, T=s,
        causal=True, block_rows=OFFSET_BLOCK,
        offsets=list(range(0, s, OFFSET_BLOCK)),
        max_abs_err=max_err(got, ref), err_over_tol=ratio,
        bitwise_equal_to_whole=bitwise, vs_whole_max_abs=max_err(got, whole),
        ok=ratio <= 1.0,
        ms=time_ms(blocks, sets),
        whole_ms=time_ms(lambda a, b_, c: flash_attention(a, b_, c, True),
                         sets),
        plain_ms=time_ms(lambda a, b_, c: flash_attention_plain(a, b_, c,
                                                                True), sets),
        library_ms=time_ms(lambda a, b_, c: F.scaled_dot_product_attention(
            a, b_, c, is_causal=True, enable_gqa=True), sets),
        bound_ms=max(t_ops, t_bytes) * 1e3,
        bound_by="operations" if t_ops >= t_bytes else "bytes")


def _grown(cache, cfg, capacity: int):
    """The prefill cache with its self-attention K/V padded to
    ``capacity`` positions (a new tensor per leaf)."""
    out = {}
    for slot, leaves in cache.items():
        mixer = cfg.block_pattern[int(slot[len("slot"):])][0]
        out[slot] = {}
        for name, x in leaves.items():
            if mixer == "attn":
                x = torch.cat([x, x.new_zeros(x.shape[:2] + (
                    capacity - x.shape[2],) + x.shape[3:])], dim=2)
            out[slot][name] = x.contiguous()
    return out


def _serve_run(prefill, decode, tokens, steps: int) -> dict:
    """A prefill then ``steps`` greedy decode steps, synchronized around
    each part: walls, peak allocated memory, each step's logits and the
    last cache."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits, cache = prefill(tokens)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    all_logits = [logits[:, -1]]
    tok = logits[:, -1].argmax(-1)[:, None]
    cache = decode.grow(cache)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    for i in range(steps):
        logits, cache = decode(cache, tok, tokens.shape[1] + i)
        all_logits.append(logits[:, -1])
        tok = logits[:, -1].argmax(-1)[:, None]
    torch.cuda.synchronize()
    return dict(prefill_s=t1 - t0, decode_s=time.perf_counter() - t2,
                peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                logits=torch.stack(all_logits), cache=cache)


def sharded_qwen(card: str) -> tuple:
    """Full-width qwen3-8b in bf16 under the launcher's NCCL (1, 1) mesh:
    ``sharded_prefill`` of a 2048-token prompt and 32
    ``sharded_decode_step``s on DTensor parameters (the meshless run's
    tensors as their local shards) against the meshless ``prefill`` and
    ``decode_step``: logits (prefill and every step) and the last cache
    equal bit for bit; flash 36 launches a prefill, decode 36 a step, each
    writing its lse.  Run in turns (meshless, sharded, sharded,
    meshless), each run's walls and peak.  (row, what failed, the first
    sharded run's launches)."""
    from torch.distributed.tensor import DTensor
    from repro_torch.configs import Shape
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.context import placements, use_rules
    from repro_torch.distributed.serve_step import (sharded_decode_step,
                                                    sharded_prefill)
    from repro_torch.launch.mesh import init_distributed, make_mesh
    from repro_torch.models import get_model, transformer
    from repro_torch.models.transformer import tree_leaves
    import torch.distributed as dist
    init_distributed("cuda")
    mesh = make_mesh((1, 1), ("data", "model"), "cuda")
    dm = mesh.device_mesh
    model = get_model("qwen3-8b")
    cfg = model.cfg
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = model.init_params(generator=gen, dtype=torch.bfloat16,
                               device="cuda")
    dparams = shd.map2(lambda x, pl: DTensor.from_local(x, dm, pl,
                                                        run_check=False),
                       params, shd.param_placements(params, cfg, mesh))
    prompt = torch.randint(0, cfg.vocab_size, (1, SHARDED_PROMPT),
                           generator=gen, device="cuda")
    cap = SHARDED_PROMPT + SHARDED_STEPS
    pre_shape = Shape("prefill", "prefill", SHARDED_PROMPT, 1)
    dec_shape = Shape("decode", "decode", cap, 1)

    def meshless_decode(cache, tok, pos):
        return transformer.decode_step(params, cache, tok, pos, cfg)
    meshless_decode.grow = lambda c: _grown(c, cfg, cap)

    def mesh_prefill(tok):
        with use_rules(mesh, shd.logical_rules(cfg, pre_shape, mesh)):
            logits, cache = sharded_prefill(dparams, {"tokens": tok}, cfg)
        return logits.to_local(), cache

    def mesh_decode(cache, tok, pos):
        with use_rules(mesh, shd.logical_rules(cfg, dec_shape, mesh)):
            logits, cache = sharded_decode_step(dparams, cache, tok, pos,
                                                cfg)
        return logits.to_local(), cache

    def mesh_grow(cache):
        local = _grown({s: {k: x.to_local() for k, x in leaves.items()}
                        for s, leaves in cache.items()}, cfg, cap)
        c_place = shd.map2(lambda _, sp: placements(sp, mesh), local,
                           shd.cache_specs(cfg, dec_shape, mesh))
        return shd.map2(lambda x, pl: DTensor.from_local(x, dm, pl,
                                                         run_check=False),
                        local, c_place)
    mesh_decode.grow = mesh_grow

    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False

    def meshless_run():
        return _serve_run(lambda tok: transformer.prefill(
            params, {"tokens": tok}, cfg), meshless_decode, prompt,
            SHARDED_STEPS)
    # in turns, meshless, sharded, sharded, meshless: the walls of each
    # pair beside each other; the first sharded run's launches counted
    plain = meshless_run()
    _reset_launches()
    sharded = _serve_run(mesh_prefill, mesh_decode, prompt, SHARDED_STEPS)
    launches = _launches()
    cache = [x.to_local() for x in tree_leaves(sharded["cache"])]
    differ = sum(not torch.equal(a, b) for a, b in
                 zip(cache, tree_leaves(plain["cache"])))
    del sharded["cache"], plain["cache"]
    again = _serve_run(mesh_prefill, mesh_decode, prompt, SHARDED_STEPS)
    plain_again = meshless_run()
    differ += not (torch.equal(again["logits"], sharded["logits"]) and
                   torch.equal(plain_again["logits"], plain["logits"]))
    attn = sum(m == "attn" for m, _ in cfg.block_pattern) * cfg.n_periods
    # one prefill and SHARDED_STEPS decode steps: every launch counted
    want = {**_no_launches(), "flash_attention/wgmma": attn,
            f"flash_attention/wgmma/{cfg.d_head}": attn,
            "decode_attention": SHARDED_STEPS * attn,
            "decode_attention:lse": SHARDED_STEPS * attn}
    row = dict(
        card=card, model=cfg.name, dtype="bfloat16",
        backend=dist.get_backend(),
        mesh=[1, 1], prompt_len=SHARDED_PROMPT, decode_steps=SHARDED_STEPS,
        logits_equal=bool(torch.equal(sharded["logits"], plain["logits"])),
        tokens_equal=bool(torch.equal(sharded["logits"].argmax(-1),
                                      plain["logits"].argmax(-1))),
        cache_leaves_differ=differ,
        launches={k: n for k, n in launches.items() if n},
        expected_launches={k: n for k, n in want.items() if n},
        **{f"{k}_{name}": [r[k] for r in runs] for name, runs in (
            ("sharded", (sharded, again)), ("meshless", (plain, plain_again)))
           for k in ("prefill_s", "decode_s", "peak_gb")})
    for k in ("prefill", "decode"):
        row[f"{k}_over_meshless"] = [
            a[f"{k}_s"] / b[f"{k}_s"] for a, b in ((sharded, plain),
                                                   (again, plain_again))]
    bad = []
    if not (row["logits_equal"] and row["tokens_equal"]) or differ:
        bad.append("the sharded run is not the meshless run bit for bit")
    if launches != want:
        bad.append(f"launches {launches}, expected {want}")
    del params, dparams, plain, sharded, again, plain_again
    gc.collect()
    torch.cuda.empty_cache()
    return row, bad, launches


def phase_serve_sharded(card: str):
    """(b) full-width qwen3-8b sharded serving under the NCCL (1, 1) mesh,
    bit for bit the meshless path, first and alone on the host; then (a)
    the two kernels' new modes at serving shapes: decode split over 16
    blocks of a decode_32k cache and merged, at G 4 and G 8; flash as
    four blocks of query rows at their offsets, in bf16 (wgmma) and f32
    (CUDA-core); while (c) the reference's serving cells run through the
    dry-run's command line on fake tensors of the card, the 16x16 mesh,
    each in a subprocess on the host's cores: each ok, FLOPs per device
    over the analytic count, collective bytes by kind, peak and fit."""
    out = ROOT / "build" / "serve_sharded"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    # (b) first, alone: its walls are the host's, which the dry-runs'
    # traces would share
    row, bad, launches = sharded_qwen(card)
    emit("serve_sharded", **row)
    jobs = {f"{arch}|{shape}": _start(
        ["-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
         "--mesh", "single", "--out", str(out / f"{arch}_{shape}.json")],
        out / f"{arch}_{shape}.log") for arch, shape in SERVE_CELLS}
    try:
        gen = torch.Generator(device="cuda").manual_seed(5)
        torch.use_deterministic_algorithms(True)
        torch.utils.deterministic.fill_uninitialized_memory = False
        modes = [split_decode_case(gen, hkv) for hkv in (HKV, 4)]
        modes += [offset_flash_case(gen, dtype)
                  for dtype in (torch.bfloat16, torch.float32)]
        for r in modes:
            emit("kernel_mode", card=card, **r)
        MODE_ROWS.extend(modes)
        walls = {name: _finish(job, name) for name, job in jobs.items()}
    finally:
        for proc, fh, _ in jobs.values():
            proc.kill()
            proc.wait()
            fh.close()
    cells = {}
    for arch, shape in SERVE_CELLS:
        key = f"{arch}|{shape}"
        c = json.loads((out / f"{arch}_{shape}.json").read_text())[
            f"{key}|single"]
        cells[key] = dict(
            status=c["status"], error=c.get("error"), wall_s=walls[key],
            **({} if c["status"] != "ok" else dict(
                flops_per_device=c["flops_per_device"],
                analytic_flops_per_device=c["analytic_flops_per_device"],
                flops_over_analytic=c["flops_per_device"]
                / c["analytic_flops_per_device"],
                collective_gb={k[len("coll_"):]: v / 1e9
                               for k, v in c["collectives"].items()},
                peak_gb=c["memory"]["peak"] / 1e9,
                argument_gb=c["memory"]["argument"] / 1e9,
                fits_hbm=c["fits_hbm"], device=c["device"],
                trace_s=c["compile_s"])))
    emit("serve_sharded_cells", card=card, note="dry-run: reckoned on fake "
         "tensors of the card, not measured", cells=cells)
    bad += [f"{r['kernel']} {r['mode']}: {r}" for r in modes if not r["ok"]]
    for key, c in cells.items():
        if c["status"] != "ok":
            bad.append(f"{key}: {c['status']} {c.get('error')}")
        elif key in SERVE_FACTOR_CELLS and not (
                SERVE_FACTOR[0] <= c["flops_over_analytic"] <= SERVE_FACTOR[1]
                and c["fits_hbm"]):
            bad.append(f"{key}: {c['flops_over_analytic']} x the analytic "
                       f"FLOPs, fits {c['fits_hbm']}")
    if bad:
        raise SystemExit(f"serve_sharded: {bad}")
    return launches


# --------------------------------------------------------------------------
# phase 16: the serving examples, with obs/ attached
# --------------------------------------------------------------------------
@contextlib.contextmanager
def counted_steps(counts: dict):
    """While open, every executor's prefill and decode steps are counted in
    ``counts[model name]`` (the engines the examples make are out of
    reach before they run)."""
    from repro_torch.serving import PreemptibleExecutor as Ex
    saved = {k: getattr(Ex, k) for k in ("step_prefill", "step_decode")}

    def counted(kind, fn):
        def step(self, st):
            counts.setdefault(self.cfg.name, {"prefill": 0, "decode": 0})[
                kind] += 1
            return fn(self, st)
        return step
    try:
        for k, fn in saved.items():
            setattr(Ex, k, counted(k.split("_")[1], fn))
        yield counts
    finally:
        for k, fn in saved.items():
            setattr(Ex, k, fn)


def _spans_check(tracer, rids) -> dict:
    """Run spans never overlap on a device (or batch slot), as
    tests/test_obs_property.py's ``assert_no_overlap`` holds them, and
    every request's lifecycle closes in ``complete``."""
    spans = tracer.spans
    runs = {}
    for sp in spans:
        if sp.phase == "run":
            runs.setdefault((sp.device, sp.slot), []).append((sp.t0, sp.t1))
    overlaps = 0
    for track in runs.values():
        track.sort()
        overlaps += sum(b0 < a1 - 1e-12 for (_, a1), (b0, _) in
                        zip(track, track[1:]))
    last = {}
    for sp in spans:
        if sp.tid not in last or sp.t1 >= last[sp.tid].t1:
            last[sp.tid] = sp
    closed = (sorted(last) == sorted(rids)
              and all(sp.reason == "complete" for sp in last.values())
              and not any(sp.reason == "open" for sp in spans))
    if overlaps or not runs or not closed:
        raise SystemExit(f"spans: {overlaps} overlaps on {len(runs)} tracks, "
                         f"lifecycles closed {closed}")
    return dict(spans=len(spans), run_spans=sum(map(len, runs.values())),
                tracks=len(runs), overlaps=overlaps, lifecycles_closed=closed,
                reasons={r: sum(sp.reason == r for sp in spans)
                         for r in sorted({sp.reason for sp in spans})})


# the engine summary's keys the example lines keep
SUMMARY_KEYS = ("antt", "stp", "fairness", "tail95_high", "sla_met_rate",
                "preemptions", "kills", "mean_ttft", "p95_ttft", "mean_tpot",
                "migrations", "util_mean")


def _summary(engine) -> dict:
    return {k: float(v) for k, v in engine.summary().items()
            if k in SUMMARY_KEYS}


def _sum_launches(*runs) -> dict:
    total = _no_launches()
    for got in runs:
        for k, n in got.items():
            total[k] += n
    return total


def phase_examples(card: str):
    """(a) ``repro_torch.examples.quickstart --full`` in bf16: its 8
    requests on full-width olmo-1b and qwen3-8b (the wgmma flash kernel,
    decode at groups 1 and 4), with ``obs/``'s SpanTracer, Telemetry and
    SLOMonitor attached (``quickstart.observe``): spans that never overlap
    on a device, every lifecycle closed, the Perfetto JSON written under
    ``build/``, the telemetry totals and the SLO alerts, all on the
    engine's virtual clock of the H100 model; (b) ``multi_npu_cluster
    --full``'s two-device engine on the same models and requests (both
    engine devices on this card, sharing its tensors): every request's
    tokens bit for bit (a)'s, with its migrations; (c)
    ``multi_tenant_serving`` at its tiny configs in f32, as on the card by
    default (the H100 model) and under the paper's NPU model, where PREMA
    preempts: its own check, tokens identical across NP-FCFS and PREMA.
    Each run's kernel launches are checked against its step counts."""
    from repro_torch.examples import (multi_npu_cluster, multi_tenant_serving,
                                      quickstart)
    from repro_torch.hw import H100, PAPER_NPU
    from repro_torch.models.transformer import tree_leaves

    gc.collect()
    torch.cuda.empty_cache()
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    out = ROOT / "build" / "examples"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    virtual = "engine virtual clock of the H100 hardware model, not measured"
    t0 = time.perf_counter()
    models = quickstart.build_models("cuda", torch.bfloat16, full=True)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cfgs = {m.cfg.name: m.cfg for m, _ in models.values()}
    weights = sum(x.nbytes for _, p in models.values()
                  for x in tree_leaves(p))

    # (a) quickstart --full under obs/
    observers, counts = [], {}
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    with counted_steps(counts):
        t0 = time.perf_counter()
        engine, results = quickstart.run(
            models, quickstart.make_requests(),
            attach=lambda e, r: observers.extend(quickstart.observe(e, r)))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches_a = _check_models_launches(cfgs, torch.bfloat16, counts,
                                       "quickstart --full")
    tracer, telemetry, slo = observers
    for o in observers:
        o.detach()
    tokens = {r.rid: r.tokens for r in results}
    spans = _spans_check(tracer, list(tokens))
    trace = Path(tracer.export(str(out / "quickstart_trace.json")))
    events = json.loads(trace.read_text())["traceEvents"]
    snap = telemetry.snapshot()
    totals = snap["totals"]
    if (len(results) != 8 or not events
            or not totals["submit"] == totals["complete"] == 8
            or not all(np.isfinite(float(r.ntt)) and r.tokens.shape[1] >= 1
                       for r in results)):
        raise SystemExit(f"quickstart --full: {len(results)} results, "
                         f"{len(events)} trace events, totals {totals}")
    generated = sum(int(r.tokens.shape[1]) for r in results)
    emit("examples_quickstart", card=card, models=list(cfgs), dtype="bfloat16",
         weights_gb=weights / 1e9, param_init_s=init_s, wall_s=wall,
         generated_tokens=generated, tokens_per_s=generated / wall,
         preemptions=sum(r.n_preemptions for r in results),
         kills=sum(r.n_kills for r in results), steps=counts,
         launches={k: n for k, n in launches_a.items() if n},
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    emit("examples_obs", note=virtual, **spans, n_events=tracer.n_events,
         busy_s=tracer.device_busy_seconds(), trace_file=str(
             trace.relative_to(ROOT)), trace_bytes=trace.stat().st_size,
         trace_events=len(events), telemetry_windows=len(snap["windows"]),
         telemetry_window_s=snap["window"], telemetry_totals=totals,
         slo_alerts=[list(a) for a in slo.alerts], slo=slo.snapshot(),
         summary=_summary(engine))

    # (b) the two-device engine on the same models and requests
    multi_npu_cluster.simulate_cluster()
    counts = {}
    _reset_launches()
    with counted_steps(counts):
        t0 = time.perf_counter()
        engine2, results2 = multi_npu_cluster.serve_on_two_devices(models)
        torch.cuda.synchronize()
        wall2 = time.perf_counter() - t0
    launches_b = _check_models_launches(cfgs, torch.bfloat16, counts,
                                       "multi_npu_cluster --full")
    same = {r.rid: bool(np.array_equal(r.tokens, tokens[r.rid]))
            for r in results2}
    devices = {t.tid: t.device for t in engine2.tasks}
    s2 = engine2.summary()
    emit("examples_two_devices", card=card, wall_s=wall2, steps=counts,
         launches={k: n for k, n in launches_b.items() if n},
         tokens_equal_quickstart=all(same.values()), devices=devices,
         migrations=float(s2["migrations"]),
         preemptions=sum(r.n_preemptions for r in results2), note=virtual,
         summary=_summary(engine2))
    if len(same) != 8 or not all(same.values()) or len(set(
            devices.values())) != 2:
        raise SystemExit(f"two devices: tokens equal {same}, devices "
                         f"{devices}")
    del models, engine, engine2, results, results2, observers, tracer
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the multi-tenant comparison at its tiny configs in f32
    models = multi_tenant_serving.build_models("cuda", torch.float32)
    cfgs = {m.cfg.name: m.cfg for m, _ in models.values()}
    reqs = multi_tenant_serving.make_trace(models, np.random.default_rng(7))
    launches_c = []
    for hw_name, hw in (("H100", H100), ("PAPER_NPU", PAPER_NPU)):
        counts = {}
        _reset_launches()
        with counted_steps(counts):
            t0 = time.perf_counter()
            fcfs, prema = multi_tenant_serving.compare(models, reqs, hw)
            torch.cuda.synchronize()
            wall3 = time.perf_counter() - t0
        launches_c.append(_check_models_launches(
            cfgs, torch.float32, counts, f"multi_tenant_serving {hw_name}"))
        emit("examples_multi_tenant", card=card, hw_model=hw_name,
             dtype="float32", wall_s=wall3, steps=counts,
             launches={k: n for k, n in launches_c[-1].items() if n},
             tokens_identical_across_schedulers=True,
             preemptions=float(prema.summary()["preemptions"]),
             note=f"summaries: engine virtual clock of the {hw_name} "
                  "hardware model, not measured",
             fcfs=_summary(fcfs), prema=_summary(prema))
    if not prema.summary()["preemptions"]:
        raise SystemExit("multi_tenant_serving: PREMA never preempted under "
                         "the paper's NPU model")
    return _sum_launches(launches_a, launches_b, *launches_c)


# the kernels whose compiled code phase 1 reports: name -> a pattern of
# its mangled name (each instance of the wgmma flash kernel; the decode
# kernel at bf16, D 128, groups up to 4; the CUDA-core GEMM on its 16-byte
# path, and flash at f32, D 128)
COMPILED_KERNELS = {
    "gemm_resume_wgmma_kernel": "gemm_resume_wgmma_kernel",
    "flash_fwd_wgmma_kernel<64>": r"flash_fwd_wgmma_kernelILi64E",
    "flash_fwd_wgmma_kernel<80>": r"flash_fwd_wgmma_kernelILi80E",
    "flash_fwd_wgmma_kernel<128>": r"flash_fwd_wgmma_kernelILi128E",
    "decode_split_kernel<bf16,128,4>":
        r"decode_split_kernelI\w*bfloat16Li128ELi4E",
    "gemm_resume_simt_kernel<vec>": r"gemm_resume_simt_kernelILb1E",
    "gemm_resume_simt_kernel<any strides>": r"gemm_resume_simt_kernelILb0E",
    "flash_fwd_simt_kernel<f32,128>": r"flash_fwd_simt_kernelIfLi128E"}


def compiled_kernels(lib_path: Path):
    """Per kernel: its registers, stack and local memory per thread (local
    > 0 means spills) and its count of HGMMA (wgmma), UTMALDG (TMA load),
    LDGSTS (cp.async) and FFMA (f32 fused multiply-add) instructions, from
    ``cuobjdump`` on the built library; None where the toolkit has no
    ``cuobjdump``."""
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
               for op in ("HGMMA", "UTMALDG", "LDGSTS", "FFMA")})
    return out


PHASES = ("kernels", "gemm", "tiny", "serve", "serve_f32", "path",
          "serve_moe", "serve_dense", "serve_ssm", "serve_vlm_audio", "train",
          "distributed", "dryrun", "serve_sharded", "examples")
# the kernels line: name, launch counter (``wrapper/variant``, or
# ``wrapper/variant/width`` for one instance), source, TPU kernel, headline
# row
KERNELS = [
    ("flash_attention_wgmma_bf16", "flash_attention/wgmma/128",
     "flash_attention.cu", "src/repro/kernels/flash_attention/kernel.py:90",
     dict(kernel="flash_attention", dtype="bfloat16", D=D, Hkv=HKV, S=2048,
          causal=True)),
    # hubert-xlarge's prefill
    ("flash_attention_wgmma_bf16_d80", "flash_attention/wgmma/80",
     "flash_attention.cu", "src/repro/kernels/flash_attention/kernel.py:90",
     dict(kernel="flash_attention", dtype="bfloat16", D=80, Hq=16, Hkv=16,
          S=2048, causal=False)),
    ("flash_attention_cuda_core_f32", "flash_attention/cuda_core",
     "flash_attention.cu", "src/repro/kernels/flash_attention/kernel.py:90",
     dict(kernel="flash_attention", dtype="float32", D=D, Hkv=HKV, S=2048,
          causal=True)),
    ("decode_attention", "decode_attention", "decode_attention.cu",
     "src/repro/kernels/decode_attention/kernel.py:91",
     dict(kernel="decode_attention", dtype="bfloat16", Hq=HQ, Hkv=HKV,
          T=2560, pos=2048)),
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


# the kernels' modes on the kernels line: entry name -> (mode, launch
# counter, the mode row's fields)
MODES = {
    "flash_attention_wgmma_bf16": ("q_offset", "flash_attention:q_offset",
                                   dict(mode="q_offset", dtype="bfloat16")),
    "flash_attention_cuda_core_f32": ("q_offset", "flash_attention:q_offset",
                                      dict(mode="q_offset", dtype="float32")),
    "decode_attention": ("split_lse", "decode_attention:lse",
                         dict(mode="split_lse", Hkv=HKV)),
}


def _mode(name, launches):
    """The mode row of a kernels-line entry, with its launches on the
    paths (flash's query offset splits query rows over a 'model' axis of
    more than one card, so no path on one card launches it)."""
    if name not in MODES or not MODE_ROWS:
        return {}
    mode, counter, at = MODES[name]
    r = next(r for r in MODE_ROWS if all(r.get(k) == v for k, v in at.items()))
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "device_ms", "whole_device_ms", "whole_ms",
            "library_device_ms", "bitwise_equal_to_whole", "timed_pos")
    return {"modes": {mode: dict(launches=launches[counter],
                                 **{k: r[k] for k in keys if k in r})}}


def kernels_line(rows, launches):
    kernels = []
    for name, counter, src, replaces, head_at in KERNELS:
        _, variant, width = (counter.split("/") + ["", ""])[:3]
        mine = [r for r in rows if r["kernel"] == head_at["kernel"]
                and (not variant or r["variant"] == variant)
                and (not width or r["D"] == int(width))]
        head = next(r for r in mine
                    if all(r.get(k) == v for k, v in head_at.items()))
        kernels.append(dict(
            name=name, route="cuda",
            source=f"src/repro_torch/kernels/csrc/{src}", replaces=replaces,
            launches=launches[counter],
            max_abs_err=max(r["max_abs_err"] for r in mine),
            ms=head["ms"], plain_ms=head["plain_ms"],
            bound_ms=head["bound_ms"], bound_by=head["bound_by"],
            library_ms=head["library_ms"], at=head_at,
            **{key: head[key] for key in ("device_ms", "library_device_ms")
               if key in head}, **_mode(name, launches)))
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
    for phase, run in (("kernels", phase_kernels), ("gemm", phase_gemm),
                       ("tiny", phase_tiny)):
        if phase in phases:
            t0 = time.perf_counter()
            rows += run() or []
            emit("phase_wall", name=phase, s=time.perf_counter() - t0)
    # each path's launches are counted from 0 and read after it; the
    # kernels line adds up what the paths launched
    launches = _no_launches()
    paths = [("serve", phase_serve), ("serve_f32", phase_serve_f32),
             ("path", phase_gemm_path), ("serve_moe", phase_serve_moe),
             ("serve_dense", phase_serve_dense),
             ("serve_ssm", phase_serve_ssm),
             ("serve_vlm_audio", phase_serve_vlm_audio),
             ("train", phase_train), ("distributed", phase_distributed),
             ("dryrun", phase_dryrun), ("serve_sharded", phase_serve_sharded),
             ("examples", phase_examples)]
    for phase, run in paths:
        if phase in phases:
            t0 = time.perf_counter()
            for counter, n in run(card).items():
                launches[counter] += n
            emit("phase_wall", name=phase, s=time.perf_counter() - t0)

    print(card)
    if set(phases) == set(PHASES):
        print(json.dumps({"kernels": kernels_line(rows, launches)}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
