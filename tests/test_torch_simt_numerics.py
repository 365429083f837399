"""The arithmetic of the port's two f32 CUDA-core kernels, simulated on the
CPU, against the tolerances that ``chip_smoke.py`` and the ``cuda`` tests
hold the kernels to.

Flash (``flash_fwd_simt_kernel`` in ``kernels/csrc/flash_attention.cu``):
key tiles of 64; per tile f32 scores summed over d in ascending order,
scaled by D**-0.5 (in log2 units), masked to -1e30, the running maximum and
the rescale alpha = 2**(m_old - m_new) of the accumulator and of each
lane's partial normaliser (lane c holds keys c, c + 16, c + 32, c + 48 of a
tile), P = 2**(s - m) kept in f32, O += P V summed over the tile's keys in
ascending order; at the end the 16 lanes' normalisers are summed and O /
max(l, 1e-30).  At the serving shape (S = T = 2048, D 128, two heads),
causal and not, and at hubert-xlarge's D 80, it must meet (atol, rtol) =
(3e-4, 3e-4) against the plain version run in float64.  A dropped key
tile, a causal mask one key off, the wrong KV head and a skipped alpha
rescale must each exceed it by more than ``FAULT_FACTOR``.

GEMM (``gemm_resume_simt_kernel`` in ``kernels/csrc/preemptible_matmul.cu``):
stages of 64 reduction rows from each launch's first row, rows past the
launch's end staged as zeros, one fmaf per staged row in ascending order.
Launches of K tiles of 1 and of 100 rows (first rows off any multiple of
4) over a ragged K, split into several launches, must give one ascending
fmaf chain bit for bit.

    python tests/test_torch_simt_numerics.py   # prints the flash ratios
"""
import functools
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention.ops import HEAD_DIMS
from repro_torch.kernels.preemptible_matmul import matmul_resumable

torch.set_num_threads(2)
BT = 64                        # keys per tile of the kernel
LANES = 16                     # lanes sharing one query row
ATOL = RTOL = 3e-4             # chip_smoke.TOL[torch.float32]
FAULT_FACTOR = 2.0
NEG_INF = -1e30
LOG2E = 1.4426950408889634


def _inputs(s, t, d, hq=2, hkv=2, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)) for shape in ((1, hq, s, d), (1, hkv, t, d),
                                   (1, hkv, t, d)))


def plain64(q, k, v, causal):
    """The plain version's function in float64: softmax(q k^T D**-0.5,
    masked past the diagonal) v, query head h reading KV head h // g."""
    b, hq, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    kk = k.double().repeat_interleave(hq // hkv, dim=1)
    vv = v.double().repeat_interleave(hq // hkv, dim=1)
    scores = q.double() @ kk.transpose(-1, -2) * d ** -0.5
    if causal:
        keep = torch.arange(t)[None, :] <= torch.arange(s)[:, None]
        scores = torch.where(keep, scores, torch.tensor(NEG_INF,
                                                        dtype=torch.float64))
    return torch.softmax(scores, dim=-1) @ vv


def flash_simt_sim(q, k, v, causal, drop_tile=None, mask_shift=0,
                   kv_shift=0, skip_alpha=False):
    """The kernel's arithmetic in f32 on f32 inputs.  Faults: skip key tile
    ``drop_tile``; causal mask ``key > row + mask_shift``; query head h
    reads KV head (h // g + ``kv_shift``) % Hkv; leave the accumulator
    unrescaled (``skip_alpha``)."""
    b, hq, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = np.float32(d ** -0.5 * LOG2E)
    out = torch.empty((b, hq, s, d), dtype=torch.float32)
    rows = torch.arange(s)[:, None]
    for h in range(hq):
        hk = (h // g + kv_shift) % hkv
        qh, kh, vh = q[0, h], k[0, hk], v[0, hk]
        m = torch.full((s, 1), NEG_INF)
        lane_l = torch.zeros((s, LANES))      # each lane's partial normaliser
        acc = torch.zeros((s, d))
        for it in range(math.ceil(t / BT)):
            if it == drop_tile:
                continue
            k0 = it * BT
            kt, vt = kh[k0:k0 + BT], vh[k0:k0 + BT]
            n = kt.shape[0]
            sc = torch.zeros((s, n))
            for j in range(d):                 # ascending d
                sc = sc + qh[:, j:j + 1] * kt[:, j][None, :]
            x = sc * scale
            keys = k0 + torch.arange(n)[None, :]
            if causal:
                x = torch.where(keys > rows + mask_shift,
                                torch.tensor(NEG_INF), x)
            m_new = torch.maximum(m, x.max(dim=1, keepdim=True).values)
            alpha = torch.exp2(m - m_new)
            m = m_new
            p = torch.exp2(x - m_new)
            pl = torch.zeros((s, BT))
            pl[:, :n] = p
            # lane c adds its keys c, c + 16, ... in that order
            rs = pl[:, 0:LANES]
            for j in range(1, BT // LANES):
                rs = rs + pl[:, LANES * j:LANES * (j + 1)]
            lane_l = alpha * lane_l + rs
            if not skip_alpha:
                acc = acc * alpha
            for key in range(n):               # ascending keys
                acc = acc + p[:, key:key + 1] * vt[key][None, :]
        l = lane_l.sum(dim=1, keepdim=True)
        out[0, h] = acc / l.clamp_min(1e-30)
    return out


# (S = T, D, causal): the serving shape causal and not, and hubert-xlarge's
# head width in its encoder's unmasked attention
SHAPES = {"serving, causal": (2048, 128, True),
          "serving, not causal": (2048, 128, False),
          "D 80, not causal": (1000, 80, False)}
FAULTS = {
    "drop a key tile": dict(drop_tile=1),
    "causal mask one key short": dict(mask_shift=-1),
    "causal mask one key long": dict(mask_shift=1),
    "wrong KV head": dict(kv_shift=1),
    "skip the alpha rescale": dict(skip_alpha=True),
}


def _ratio(out, ref):
    return float(((out.double() - ref).abs()
                  / (ATOL + RTOL * ref.abs())).max())


@functools.lru_cache(maxsize=None)
def ratios(shape):
    """max |sim - ref| / (atol + rtol |ref|) for the kernel (and, at the
    causal serving shape, each fault), ref the plain version in float64."""
    s, d, causal = SHAPES[shape]
    q, k, v = _inputs(s, s, d)
    ref = plain64(q, k, v, causal)
    cases = {"kernel": {}}
    if shape == "serving, causal":
        cases.update(FAULTS)
    return {name: _ratio(flash_simt_sim(q, k, v, causal, **kw), ref)
            for name, kw in cases.items()}


@pytest.mark.parametrize("shape", list(SHAPES))
def test_flash_tiling_meets_the_f32_tolerance(shape):
    assert ratios(shape)["kernel"] <= 1.0, ratios(shape)


@pytest.mark.parametrize("fault", list(FAULTS))
def test_each_flash_fault_exceeds_the_f32_tolerance(fault):
    assert ratios("serving, causal")[fault] > FAULT_FACTOR, \
        ratios("serving, causal")


def test_flash_sim_is_the_plain_version_on_ragged_small_inputs():
    """Grouped heads and a ragged last key tile: the simulation is the same
    function as the plain version, at f32 summation error."""
    for causal in (True, False):
        q, k, v = _inputs(70, 70, 16, hq=4, hkv=2, seed=3)
        ratio = _ratio(flash_simt_sim(q, k, v, causal),
                       plain64(q, k, v, causal))
        assert ratio <= 0.05, ratio


def test_every_flash_head_width_of_the_configs_is_built():
    """Every d_head of the ten configs (and their tiny versions) whose
    layers reach flash attention is a width the flash kernels take."""
    from repro_torch.configs import ARCH_NAMES, get_config, get_tiny_config
    reach = set()
    for name in ARCH_NAMES:
        for cfg in (get_config(name), get_tiny_config(name)):
            if any(m in ("attn", "cross_attn") for m, _ in cfg.block_pattern):
                reach.add(cfg.d_head)
    assert 80 in reach
    assert reach <= set(HEAD_DIMS), sorted(reach - set(HEAD_DIMS))


# --------------------------------------------------------------------------
# the f32 GEMM: stages from each launch's first row, bitwise
# --------------------------------------------------------------------------
STAGE = 64                     # reduction rows per stage of the kernel


def _fma(a, b, c):
    """fmaf on f32 arrays: the product is exact in float64, one rounding of
    the sum to f32 after it (as the card's FFMA, but for double rounding,
    which both sides below share)."""
    return (a.astype(np.float64) * b.astype(np.float64)
            + c.astype(np.float64)).astype(np.float32)


def staged_launch(x, y, acc, lo, hi):
    """One launch of the kernel over reduction rows [lo, hi): stages of
    STAGE rows from lo, rows past hi staged as zeros, an fmaf per staged
    row of each stage in ascending order."""
    m, n = acc.shape
    for k0 in range(lo, hi, STAGE):
        xs = np.zeros((m, STAGE), np.float32)
        ys = np.zeros((STAGE, n), np.float32)
        live = min(hi, k0 + STAGE) - k0
        xs[:, :live] = x[:, k0:k0 + live]
        ys[:live] = y[k0:k0 + live]
        for kk in range(STAGE):
            acc = _fma(xs[:, kk:kk + 1], ys[kk][None, :], acc)
    return acc


def fma_chain(x, y, acc, lo, hi):
    for k in range(lo, hi):
        acc = _fma(x[:, k:k + 1], y[k][None, :], acc)
    return acc


@pytest.mark.parametrize("bk", [1, 100])
@pytest.mark.parametrize("k", [300, 257])
def test_gemm_staging_split_anywhere_equals_one_fma_chain(bk, k):
    """K tiles of ``bk`` rows over a ragged K (not a multiple of 4, 64 or
    bk), run as three launches with first rows off multiples of 4: the
    staged sums equal one ascending fmaf chain bit for bit."""
    rng = np.random.default_rng(k + bk)
    m, n = 5, 7
    x = rng.standard_normal((m, k)).astype(np.float32)
    y = rng.standard_normal((k, n)).astype(np.float32)
    acc0 = rng.standard_normal((m, n)).astype(np.float32)
    nk = -(-k // bk)
    cuts = sorted({0, nk // 3 + 1, (2 * nk) // 3, nk})
    acc = acc0
    for lo, hi in zip(cuts, cuts[1:]):
        acc = staged_launch(x, y, acc, lo * bk, min(hi * bk, k))
    assert np.array_equal(acc, fma_chain(x, y, acc0, 0, k))
    # and not by accident: dropping one row changes the bits
    assert not np.array_equal(acc, fma_chain(x, y, acc0, 1, k))


@pytest.mark.cuda
def test_simt_kernels_on_card():
    """On the card: flash at D 80 (f32 and bf16) against the plain version,
    and f32 GEMM launches at bk 1 and 100 bitwise equal to one launch.
    bf16 at D 80 runs the wgmma kernel, which rounds P to bf16 before
    P @ V as the JAX model does: it is held to ``bf16_tolerance``; f32
    runs the CUDA-core kernel, held to (3e-4, 3e-4)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.flash_attention import (bf16_tolerance,
                                                     flash_attention,
                                                     flash_attention_plain)
    from repro_torch.kernels.flash_attention.ops import kernel_variant
    gen = torch.Generator(device="cuda").manual_seed(2)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (torch.randn((1, 100, h, 80), generator=gen, device="cuda",
                               dtype=dtype).transpose(1, 2)
                   for h in (16, 16, 16))
        for causal in (True, False):
            out = flash_attention(q, k, v, causal).float()
            ref = flash_attention_plain(q.float(), k.float(), v.float(),
                                        causal)
            if kernel_variant(dtype, 80) == "wgmma":
                assert bool(((out - ref).abs()
                             <= bf16_tolerance(q, k, v, causal)).all())
            else:
                torch.testing.assert_close(out, ref, atol=ATOL, rtol=RTOL)
    x = torch.randn((100, 300), generator=gen, device="cuda")
    y = torch.randn((300, 130), generator=gen, device="cuda")
    acc = torch.randn((128, 256), generator=gen, device="cuda")
    one = matmul_resumable(x, y, acc, 0, 3)
    for bk in (1, 100):
        nk = -(-300 // bk)
        out = acc.clone()
        for lo, hi in ((0, nk // 3 + 1), (nk // 3 + 1, nk)):
            out = matmul_resumable(x, y, out, lo, hi, bk=bk, out=out)
        assert torch.equal(out, one)


if __name__ == "__main__":
    for sh in SHAPES:
        print(sh, {name: round(r, 4) for name, r in ratios(sh).items()})
