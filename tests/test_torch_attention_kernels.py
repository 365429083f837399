"""The attention wrappers of the port (their plain versions, on the CPU)
against the JAX Pallas kernels run in interpret mode, on the same inputs
(made with numpy): 3e-4 in f32, 3e-2 in bf16."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import decode_attention as jax_decode
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_plain)
from repro_torch.kernels.flash_attention import (bf16_tolerance,
                                                 flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.flash_attention import ops as flash_ops

torch.set_num_threads(2)
TOL = {"float32": 3e-4, "bfloat16": 3e-2}

# the cases of tests/test_kernels_attention.py
CASES = [  # b, hq, hkv, s, t, d, causal
    (2, 4, 2, 128, 128, 64, True),
    (1, 8, 8, 256, 256, 32, True),
    (2, 4, 1, 100, 100, 64, True),      # ragged (padding path)
    (1, 4, 2, 64, 192, 64, False),      # cross-attention shape
    (1, 2, 2, 128, 128, 128, True),
    (1, 4, 2, 100, 100, 80, False),     # hubert-xlarge's head width
]
DECODE_CASES = [  # b, hq, hkv, t, d, pos
    (2, 8, 2, 512, 64, 300),
    (1, 4, 4, 1024, 128, 1023),
    (2, 16, 2, 700, 64, 0),
    (1, 32, 4, 4096, 128, 2048),
]


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    return jnp.asarray(a, dtype), torch.from_numpy(a).to(getattr(torch, dtype))


def _close(t_out, j_out, tol):
    np.testing.assert_allclose(t_out.float().numpy(),
                               np.asarray(j_out, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_vs_pallas(case, dtype):
    b, hq, hkv, s, t, d, causal = case
    rng = np.random.default_rng(0)
    (qj, qt), (kj, kt), (vj, vt) = (
        _pair(rng.standard_normal(shape).astype(np.float32), dtype)
        for shape in ((b, hq, s, d), (b, hkv, t, d), (b, hkv, t, d)))
    ref = jax_flash(qj, kj, vj, causal=causal, bq=64, bt=64, interpret=True)
    _close(flash_attention(qt, kt, vt, causal=causal), ref, TOL[dtype])


@pytest.mark.parametrize("case", DECODE_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_vs_pallas(case, dtype):
    b, hq, hkv, t, d, pos = case
    rng = np.random.default_rng(1)
    (qj, qt), (kj, kt), (vj, vt) = (
        _pair(rng.standard_normal(shape).astype(np.float32), dtype)
        for shape in ((b, hq, d), (b, hkv, t, d), (b, hkv, t, d)))
    ref = jax_decode(qj, kj, vj, jnp.int32(pos), bt=256, interpret=True)
    _close(decode_attention(qt, kt, vt, pos), ref, TOL[dtype])


@pytest.mark.parametrize("case", DECODE_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_tensor_pos_matches_int_and_pallas(case, dtype):
    """A 0-dim int32 ``pos`` (the kernel reads it from device memory) gives
    the int path's result bit for bit and the Pallas kernel's within TOL."""
    b, hq, hkv, t, d, pos = case
    rng = np.random.default_rng(1)
    (qj, qt), (kj, kt), (vj, vt) = (
        _pair(rng.standard_normal(shape).astype(np.float32), dtype)
        for shape in ((b, hq, d), (b, hkv, t, d), (b, hkv, t, d)))
    out = decode_attention(qt, kt, vt, torch.tensor(pos, dtype=torch.int32))
    assert torch.equal(out, decode_attention(qt, kt, vt, pos))
    ref = jax_decode(qj, kj, vj, jnp.int32(pos), bt=256, interpret=True)
    _close(out, ref, TOL[dtype])


def test_flash_reads_strided_model_layout():
    """The model hands (B,S,H,D) tensors over as transposed views."""
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.standard_normal((1, 33, 4, 16)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 33, 2, 16)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((1, 33, 2, 16)).astype(np.float32))
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2))
    ref = flash_attention(q.transpose(1, 2).contiguous(),
                          k.transpose(1, 2).contiguous(),
                          v.transpose(1, 2).contiguous())
    assert torch.equal(out, ref)


def test_decode_pos_zero_attends_only_first():
    rng = np.random.default_rng(3)
    b, hq, hkv, t, d = 1, 4, 2, 256, 32
    q = torch.from_numpy(rng.standard_normal((b, hq, d)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((b, hkv, t, d)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((b, hkv, t, d)).astype(np.float32))
    out = decode_attention(q, k, v, 0)
    expect = torch.repeat_interleave(v[:, :, 0], hq // hkv, dim=1)
    torch.testing.assert_close(out, expect, rtol=1e-5, atol=1e-5)


def _inputs(hq=4, hkv=2, d=16, dtype=torch.float32, t=8):
    q = torch.zeros((1, hq, 5, d), dtype=dtype)
    kv = torch.zeros((1, hkv, t, d), dtype=dtype)
    return q, kv, kv.clone()


@pytest.mark.parametrize("bad", [
    dict(d=48), dict(d=256), dict(dtype=torch.float16),
    dict(dtype=torch.float64), dict(hq=6, hkv=4)])
def test_wrappers_reject_bad_inputs(bad):
    q, k, v = _inputs(**bad)
    with pytest.raises(ValueError):
        flash_attention(q, k, v)
    with pytest.raises(ValueError):
        decode_attention(q[:, :, 0], k, v, 3)


def test_flash_takes_head_width_80_and_names_its_widths():
    """hubert-xlarge's head width 80 reaches flash, not decode (the model is
    an encoder); any width outside a wrapper's list raises before a launch,
    naming the widths it takes."""
    q, k, v = _inputs(d=80)
    assert flash_attention(q, k, v).shape == q.shape
    with pytest.raises(ValueError, match=r"\(8, 16, 32, 64, 80, 128\)"):
        flash_attention(*_inputs(d=96))
    with pytest.raises(ValueError, match=r"\(8, 16, 32, 64, 128\)"):
        decode_attention(q[:, :, 0], k, v, 3)


def test_decode_rejects_pos_outside_cache():
    """A host pos must lie in [-1, T): -1 is a block of a split cache
    that holds no key for the token."""
    q, k, v = _inputs()
    for pos in (-2, 8):
        with pytest.raises(ValueError):
            decode_attention(q[:, :, 0], k, v, pos)


@pytest.mark.parametrize("dtype,shape,device", [
    (torch.int64, (), "cpu"), (torch.float32, (), "cpu"),
    (torch.int32, (1,), "cpu"), (torch.int32, (), "meta")],
    ids=["int64", "float32", "one-dim", "other-device"])
def test_decode_rejects_bad_pos_tensor(dtype, shape, device):
    q, k, v = _inputs()
    pos = torch.full(shape, 3, dtype=dtype, device=device)
    with pytest.raises(ValueError):
        decode_attention(q[:, :, 0], k, v, pos)


def test_decode_tensor_pos_is_clamped_to_the_cache():
    """No value of a tensor ``pos`` reads outside the cache: it is clamped
    to [-1, T), as the kernel clamps it on the card (-1: no key, zeros)."""
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.standard_normal((1, 4, 16)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((1, 2, 8, 16)).astype(
        np.float32)) for _ in range(2))
    for pos, clamped in ((-5, -1), (8, 7), (1000, 7)):
        out = decode_attention(q, k, v, torch.tensor(pos, dtype=torch.int32))
        assert torch.equal(out, decode_attention(q, k, v, clamped))


# kernel against the plain version run in f32 on the same values, as
# (atol, rtol).  A bf16 kernel that keeps P in f32 (decode) rounds its f32
# result once: within half a bf16 ulp (2**-8 relative) plus f32 summation
# error.  The bf16 flash kernel at D 64, 80, 128 (wgmma) rounds P to bf16
# before P @ V and is held to ``bf16_tolerance``.
CARD_TOL = {torch.float32: (3e-4, 3e-4), torch.bfloat16: (1e-5, 2.0 ** -8)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_match_plain_on_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(0)
    atol, rtol = CARD_TOL[dtype]

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda", dtype=dtype)

    def check(out, ref):
        torch.testing.assert_close(out.float(), ref, rtol=rtol, atol=atol)
    variant = flash_ops.kernel_variant(dtype, 128)
    before = dict(flash_ops.variant_launches)
    for s, causal in ((37, True), (100, False), (256, True)):
        q, k, v = (rand(1, s, h, 128).transpose(1, 2) for h in (32, 8, 8))
        out = flash_attention(q, k, v, causal)
        ref = flash_attention_plain(q.float(), k.float(), v.float(), causal)
        if variant == "wgmma":
            assert bool(((out.float() - ref).abs()
                         <= bf16_tolerance(q, k, v, causal)).all())
        else:
            check(out, ref)
    assert flash_ops.variant_launches[variant] == before[variant] + 3
    assert sum(flash_ops.variant_launches.values()) == sum(before.values()) + 3
    k, v = (rand(1, 300, 8, 128).transpose(1, 2) for _ in range(2))
    q = rand(1, 32, 128)
    for pos in (0, 63, 64, 299):
        check(decode_attention(q, k, v, pos),
              decode_attention_plain(q.float(), k.float(), v.float(), pos))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_graph_replays_device_pos_on_card(dtype):
    """One decode call with a device ``pos``, captured in a CUDA graph and
    replayed at several positions: the grid does not depend on pos."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(1)
    atol, rtol = CARD_TOL[dtype]

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda", dtype=dtype)
    k, v = (rand(1, 300, 8, 128).transpose(1, 2) for _ in range(2))
    q = rand(1, 32, 128)
    pos = torch.zeros((), dtype=torch.int32, device="cuda")
    decode_attention(q, k, v, pos)       # warm-up outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = decode_attention(q, k, v, pos)
    for p in (0, 63, 64, 299):
        pos.fill_(p)
        graph.replay()
        torch.testing.assert_close(
            out.float(),
            decode_attention_plain(q.float(), k.float(), v.float(), p),
            rtol=rtol, atol=atol)
        assert torch.equal(out, decode_attention(q, k, v, p))
