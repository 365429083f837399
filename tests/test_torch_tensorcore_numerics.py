"""The arithmetic of the port's tensor-core (wgmma) kernels, simulated on
the CPU against the tolerances that ``chip_smoke.py`` and the ``cuda`` tests
hold those kernels to, and the wrappers' choice of kernel and handling of
strides, as functions of dtypes, shapes and strides.

* The bf16 GEMM: each wgmma k16 step adds 16 exact products of bf16 values
  and the accumulator and rounds once to f32, in a mode NVIDIA does not
  document, so both rounding to nearest and truncation are simulated.  The
  kernel's sum must stay within half of ``f32_sum_tolerance``; dropping a
  K tile or the last K column, or ignoring the accumulator, must exceed it
  by more than 2x.
* The bf16 flash kernel at D = 128: f32 scores and online softmax over
  128-key tiles, P rounded to bf16 before P @ V, l summed from the f32 P,
  the output rounded to bf16.  It must stay within ``bf16_tolerance``; a
  dropped key tile, a causal mask one key short or long, and a wrong KV
  head must each exceed it by more than 2x.

    python tests/test_torch_tensorcore_numerics.py   # prints the ratios
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import tma_compatible, tma_operand
from repro_torch.kernels.flash_attention import (bf16_tolerance,
                                                 flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.preemptible_matmul import (f32_sum_tolerance,
                                                    matmul_resumable)
from repro_torch.kernels.preemptible_matmul import ops as mm_ops

torch.set_num_threads(2)
GEMM_SHAPES = [(128, 128, 128), (256, 384, 512), (100, 200, 300),
               (64, 1000, 72), (1, 129, 1), (257, 64, 130), (16, 12288, 16)]


# --------------------------------------------------------------------------
# the bf16 GEMM's k16 steps
# --------------------------------------------------------------------------
def _bf16_pair(m, k, n, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32))
    return x.bfloat16(), y.bfloat16()


def _round(s: np.ndarray, mode: str) -> np.ndarray:
    """float64 values to f32, to nearest or toward zero."""
    r = s.astype(np.float32)
    if mode == "truncate":
        over = np.abs(r.astype(np.float64)) > np.abs(s)
        r = np.where(over, np.nextafter(r, np.float32(0)), r)
    return r


def k16_steps(x, y, acc, lo, hi, mode, skip=()):
    """The wgmma kernel's sum: for each k16 step at absolute K positions
    16g (launches start on a multiple of 64), the accumulator plus the 16
    exact products, rounded once to f32.  ``skip`` drops reduction rows."""
    a = acc.copy()
    keep = np.ones(x.shape[1], bool)
    keep[list(skip)] = False
    for g in range(lo, hi, 16):
        e = min(g + 16, hi)
        xs = np.where(keep[g:e], x[:, g:e], 0).astype(np.float64)
        a = _round(a + xs @ y[g:e].astype(np.float64), mode)
    return a


def gemm_ratios(shape, mode):
    """max |sum - float64| / f32_sum_tolerance for the simulated kernel and
    each fault, over the full K range and a middle range seeded from a
    non-zero accumulator (bk = 128, as at every caller)."""
    m, k, n = shape
    xt, yt = _bf16_pair(m, k, n, seed=5)
    x, y = xt.float().numpy(), yt.float().numpy()
    nk = -(-k // 128)
    rng = np.random.default_rng(6)
    out = {}
    for name, ks, ke in (("full", 0, nk),
                         ("middle", nk // 3, nk // 3 + max(1, nk // 3))):
        acc = (np.zeros((m, n), np.float32) if name == "full" else
               rng.standard_normal((m, n)).astype(np.float32))
        lo, hi = ks * 128, min(ke * 128, k)
        exact = acc + x[:, lo:hi].astype(np.float64) @ y[lo:hi].astype(
            np.float64)
        tol = f32_sum_tolerance(xt, yt, torch.from_numpy(acc), ks,
                                ke).numpy()
        cases = {
            "kernel": k16_steps(x, y, acc, lo, hi, mode),
            "drop one K tile": k16_steps(x, y, acc, lo, hi, mode,
                                         range(lo, min(lo + 128, hi))),
            "drop the last K column": k16_steps(x, y, acc, lo, hi, mode,
                                                {hi - 1})}
        if name == "middle":
            cases["ignore acc_in"] = k16_steps(x, y, 0 * acc, lo, hi, mode)
        out[name] = {c: float((np.abs(v - exact) / tol).max())
                     for c, v in cases.items()}
    return out


@pytest.mark.parametrize("shape", GEMM_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("mode", ["nearest", "truncate"])
def test_k16_steps_pass_the_tolerance_and_faults_fail_it(shape, mode):
    for ratios in gemm_ratios(shape, mode).values():
        assert ratios.pop("kernel") < 0.5
        assert min(ratios.values()) > 2.0, ratios


def test_k16_steps_split_anywhere_on_64_rows_are_bitwise_equal():
    """The resume contract on the tensor cores: launches that start on a
    multiple of 64 see the same k16 steps as one uninterrupted launch."""
    xt, yt = _bf16_pair(40, 640, 24, seed=7)
    x, y = xt.float().numpy(), yt.float().numpy()
    acc = np.zeros((40, 24), np.float32)
    one = k16_steps(x, y, acc, 0, 640, "truncate")
    split = acc
    for lo, hi in ((0, 128), (128, 384), (384, 640)):
        split = k16_steps(x, y, split, lo, hi, "truncate")
    assert np.array_equal(one, split)


# --------------------------------------------------------------------------
# the bf16 flash kernel: P in bf16 before P @ V
# --------------------------------------------------------------------------
def _attention_inputs(hq, hkv, s, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(
        (1, h, s, 128)).astype(np.float32)).bfloat16()
        for h in (hq, hkv, hkv))


def flash_wgmma_sim(q, k, v, causal, drop_tile=None, shift=0, kv_shift=0):
    """The wgmma flash kernel's arithmetic on bf16 inputs, in f32: scores,
    online softmax over 128-key tiles in log2 units, P rounded to bf16 for
    P @ V, l from the f32 P, the output rounded to bf16.  Faults: skip key
    tile ``drop_tile``; causal mask key <= row + ``shift``; query head h
    reads KV head (h // g + ``kv_shift``) % Hkv."""
    _, hq, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = d ** -0.5 * math.log2(math.e)
    out = torch.empty((1, hq, s, d))
    rows = torch.arange(s)[:, None]
    for h in range(hq):
        hk = (h // g + kv_shift) % hkv
        qh, kh, vh = q[0, h].float(), k[0, hk].float(), v[0, hk].float()
        m = torch.full((s, 1), -1e30)
        l = torch.zeros((s, 1))
        acc = torch.zeros((s, d))
        for it, k0 in enumerate(range(0, t, 128)):
            if it == drop_tile:
                continue
            cols = torch.arange(k0, min(k0 + 128, t))[None, :]
            x = (qh @ kh[k0:k0 + 128].T) * scale
            if causal:
                x = torch.where(cols <= rows + shift, x, -1e30)
            m_new = torch.maximum(m, x.max(dim=1, keepdim=True).values)
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(x - m_new)
            l = alpha * l + p.sum(dim=1, keepdim=True)
            acc = alpha * acc + p.bfloat16().float() @ vh[k0:k0 + 128]
            m = m_new
        out[0, h] = acc / l.clamp_min(1e-30)
    return out.bfloat16()


FLASH_CASES = [(4, 2, 2048, True), (4, 2, 300, True), (4, 2, 300, False)]


def flash_ratios(hq, hkv, s, causal):
    q, k, v = _attention_inputs(hq, hkv, s)
    ref = flash_attention_plain(q.float(), k.float(), v.float(), causal)
    tol = bf16_tolerance(q, k, v, causal)
    cases = {"kernel": {}, "drop a key tile": dict(drop_tile=1),
             "wrong KV head": dict(kv_shift=1)}
    if causal:
        cases.update({"mask one key short": dict(shift=-1),
                      "mask one key long": dict(shift=1)})
    return {name: float(((flash_wgmma_sim(q, k, v, causal, **kw).float()
                          - ref).abs() / tol).max())
            for name, kw in cases.items()}


@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=lambda c: f"S{c[2]}-{'causal' if c[3] else 'full'}")
def test_bf16_p_passes_the_flash_bound_and_faults_fail_it(case):
    ratios = flash_ratios(*case)
    assert ratios.pop("kernel") < 1.0
    assert min(ratios.values()) > 2.0, ratios


def test_flash_bound_with_zero_v_is_its_absolute_term():
    """Both relative terms of the bound scale with V: with V = 0 only the
    1e-5 for f32 sums in another order is left."""
    q, k, v = _attention_inputs(2, 1, 64)
    tol = bf16_tolerance(q, k, torch.zeros_like(v), True)
    assert torch.equal(tol, torch.full_like(tol, 1e-5))


# --------------------------------------------------------------------------
# which kernel a CUDA launch runs, and what TMA can read
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype,d,variant", [
    (torch.bfloat16, 128, "wgmma"), (torch.bfloat16, 64, "cuda_core"),
    (torch.bfloat16, 8, "cuda_core"), (torch.float32, 128, "cuda_core"),
    (torch.float32, 16, "cuda_core")])
def test_flash_kernel_variant(dtype, d, variant):
    assert flash_ops.kernel_variant(dtype, d) == variant


@pytest.mark.parametrize("dtype,bk,variant", [
    (torch.bfloat16, 128, "wgmma"), (torch.bfloat16, 64, "wgmma"),
    (torch.bfloat16, 256, "wgmma"), (torch.float32, 128, "cuda_core"),
    (torch.float32, 100, "cuda_core"), (torch.float32, 1, "cuda_core")])
def test_gemm_kernel_variant(dtype, bk, variant):
    assert mm_ops.kernel_variant(dtype, bk) == variant


@pytest.mark.parametrize("bk", [1, 16, 32, 100, 96])
def test_gemm_bf16_bk_off_the_stage_raises(bk):
    with pytest.raises(ValueError):
        mm_ops.kernel_variant(torch.bfloat16, bk)


@pytest.mark.parametrize("strides,esize,ptr,ok", [
    ((4096, 1), 2, 0, True),            # contiguous bf16 rows of 4096
    ((300, 1), 2, 0, False),            # 600-byte rows
    ((304, 1), 2, 0, True),             # padded to 608 bytes
    ((1, 4096), 2, 0, False),           # a transposed view
    ((4096, 1), 2, 2, False),           # base off by one element
    ((0, 1), 2, 0, False),              # a broadcast row
    ((4, 1), 4, 0, True),               # f32 rows of 16 bytes
    ((1048576, 128, 4096, 1), 2, 0, True),   # (B,H,S,D) view of (B,S,H,D)
    ((1048576, 128, 4096, 2), 2, 0, False)])
def test_tma_compatible(strides, esize, ptr, ok):
    assert tma_compatible(strides, esize, ptr) is ok


def test_tma_operand_keeps_what_tma_reads_and_copies_the_rest():
    base = torch.randn((3, 64, 4, 128)).bfloat16()
    view = base.transpose(1, 2)                  # the model's layout
    assert tma_operand(view) is view
    for t in (torch.randn((100, 300)).bfloat16(),          # 600-byte rows
              torch.randn((300, 100)).bfloat16().t(),      # column-major
              torch.randn((64, 129)).bfloat16()[:, 1:],    # misaligned base
              torch.randn((1, 8)).bfloat16().expand(5, 8)):   # broadcast
        c = tma_operand(t)
        assert c is not t and torch.equal(c, t)
        assert tma_compatible(c.stride(), c.element_size(), c.data_ptr())


def test_cpu_tensors_launch_nothing():
    before = dict(flash_ops.variant_launches), dict(mm_ops.variant_launches)
    q, k, v = _attention_inputs(2, 1, 16)
    flash_attention(q, k, v)
    x, y = _bf16_pair(8, 128, 8, seed=1)
    matmul_resumable(x, y, torch.zeros((8, 8)), 0, 1, bk=32)  # any bk
    assert (flash_ops.variant_launches, mm_ops.variant_launches) == before
    assert flash_ops.launches == sum(flash_ops.variant_launches.values())


if __name__ == "__main__":
    for shp in GEMM_SHAPES + [(64, 12288, 64)]:
        for md in ("nearest", "truncate"):
            for rng_name, r in gemm_ratios(shp, md).items():
                print(shp, md, rng_name,
                      {c: round(v, 4) for c, v in r.items()})
    for c in FLASH_CASES:
        print(c, {n: round(v, 4) for n, v in flash_ratios(*c).items()})
        qq, kk, vv = _attention_inputs(*c[:3])
        r = flash_attention_plain(qq.float(), kk.float(), vv.float(), c[3])
        e = (flash_wgmma_sim(qq, kk, vv, c[3]).float() - r).abs()
        print("  kernel against the bound without the P term:",
              round(float((e / (1e-5 + 2.0 ** -8 * r.abs())).max()), 2))
