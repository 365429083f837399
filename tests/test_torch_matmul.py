"""The port's preemptible matmul (its plain version, on the CPU) against
``repro.kernels.preemptible_matmul`` run in interpret mode, on the same
inputs (made with numpy): the twins of ``tests/test_kernels_matmul.py`` at
its tolerances (f32 1e-3, bf16 2e-2, property 2e-3), the checkpoint's
integer fields exactly, the resume contract bitwise, value semantics, a
JAX checkpoint resumed in the port, the demo, and the tolerance that
``chip_smoke.py`` holds the kernel to.

    python tests/test_torch_matmul.py   # prints the tolerance simulation
"""
import io
import runpy
from contextlib import redirect_stdout
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels import preemptible_matmul as jmm
from repro_torch.examples import preemptible_kernel_demo as demo
from repro_torch.kernels.preemptible_matmul import (advance, f32_sum_tolerance,
                                                    finish, matmul,
                                                    matmul_partial_plain,
                                                    matmul_resumable, start)
from repro_torch.kernels.preemptible_matmul import ops as mm_ops
from repro_torch.params import matmul_checkpoint_from_numpy

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
SHAPES = [(128, 128, 128), (256, 384, 512), (100, 200, 300), (64, 1000, 72),
          (1, 129, 1), (257, 64, 130)]
TOL = {"float32": 1e-3, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(m, k, n, dtype="float32", seed=0):
    """The same values as a JAX pair and a torch pair (bf16 rounds the
    same f32 numbers to nearest even in both)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    y = rng.standard_normal((k, n)).astype(np.float32)
    return ((jnp.asarray(x, JDT[dtype]), jnp.asarray(y, JDT[dtype])),
            (torch.from_numpy(x).to(TDT[dtype]),
             torch.from_numpy(y).to(TDT[dtype])))


def _np(a):
    return np.asarray(a, dtype=np.float32) if not isinstance(
        a, torch.Tensor) else a.float().numpy()


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_matches_jax(shape, dtype):
    (jx, jy), (x, y) = _inputs(*shape, dtype)
    out = matmul(x, y, out_dtype=torch.float32)
    tol = TOL[dtype]
    np.testing.assert_allclose(
        _np(out), _np(jmm.matmul(jx, jy, out_dtype=jnp.float32)),
        rtol=tol, atol=tol)
    np.testing.assert_allclose(
        _np(out), _np(jmm.matmul_ref(jx, jy, out_dtype=jnp.float32)),
        rtol=tol, atol=tol)
    assert matmul(x, y).dtype == x.dtype


@pytest.mark.parametrize("pattern", [(1, 2, 1, 1), (3, 2)])
def test_resume_equals_uninterrupted_bitwise(pattern):
    (jx, jy), (x, y) = _inputs(256, 640, 256)
    one = start(x, y)
    one = advance(one, x, y, n_tiles=one.n_ktiles)
    chunked = start(x, y)
    for step in pattern:
        chunked = advance(chunked, x, y, n_tiles=step)
    assert chunked.done
    assert torch.equal(finish(chunked), finish(one))
    jone = jmm.start(jx, jy)
    jone = jmm.advance(jone, jx, jy, n_tiles=jone.n_ktiles)
    np.testing.assert_allclose(_np(finish(one)), _np(jmm.finish(jone)),
                               rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("shape,pattern", [((257, 300, 130), (1, 1, 1)),
                                           ((100, 640, 72), (2, 1, 3))])
def test_checkpoint_fields_match_jax(shape, pattern):
    (jx, jy), (x, y) = _inputs(*shape)
    ck, jck = start(x, y), jmm.start(jx, jy)
    for step in (0,) + pattern:
        if step:
            ck, jck = (advance(ck, x, y, n_tiles=step),
                       jmm.advance(jck, jx, jy, n_tiles=step))
        assert (ck.k_tile, ck.n_ktiles, ck.shape, ck.done) == (
            jck.k_tile, jck.n_ktiles, jck.shape, jck.done)
        assert tuple(ck.acc.shape) == jck.acc.shape
        assert ck.context_bytes() == jck.context_bytes()
        np.testing.assert_allclose(_np(ck.acc), _np(jck.acc),
                                   rtol=1e-3, atol=1e-3)
    m, n = shape[0], shape[2]
    assert not ck.acc[m:].any() and not ck.acc[:, n:].any()   # padding


def test_partial_accumulator_matches_partial_ref():
    (jx, jy), (x, y) = _inputs(128, 512, 128)
    ck = advance(start(x, y), x, y, n_tiles=2)     # K tiles [0, 2)
    ref = _np(jmm.matmul_partial_ref(jx, jy, jnp.zeros((128, 128)), 0, 2))
    np.testing.assert_allclose(_np(ck.acc[:128, :128]), ref,
                               rtol=1e-4, atol=1e-4)
    assert not ck.done and ck.k_tile == 2
    # a middle range seeded from a non-zero accumulator
    acc = np.random.default_rng(1).standard_normal((128, 128)).astype(
        np.float32)
    np.testing.assert_allclose(
        _np(matmul_partial_plain(x, y, torch.from_numpy(acc), 1, 3)),
        _np(jmm.matmul_partial_ref(jx, jy, jnp.asarray(acc), 1, 3)),
        rtol=1e-4, atol=1e-4)


def test_checkpoint_bytes_is_accumulator_size():
    x, y = torch.ones((256, 256)), torch.ones((256, 512))
    ck = start(x, y)
    assert ck.context_bytes() == 256 * 512 * 4
    assert ck.context_bytes() == jmm.start(jnp.ones((256, 256)),
                                           jnp.ones((256, 512))).context_bytes()


@settings(max_examples=15, deadline=None)
@given(m=st.integers(1, 200), k=st.integers(1, 300), n=st.integers(1, 200),
       seed=st.integers(0, 2 ** 16))
def test_property_random_shapes(m, k, n, seed):
    (jx, jy), (x, y) = _inputs(m, k, n, seed=seed)
    np.testing.assert_allclose(
        _np(matmul(x, y, out_dtype=torch.float32)),
        _np(jmm.matmul(jx, jy, out_dtype=jnp.float32)), rtol=2e-3, atol=2e-3)


def test_advance_leaves_its_checkpoint_unchanged():
    _, (x, y) = _inputs(100, 640, 72)
    ck = advance(start(x, y), x, y, n_tiles=1)
    before = ck.acc.clone()
    a = advance(ck, x, y, n_tiles=2)
    b = advance(ck, x, y, n_tiles=2)
    assert torch.equal(ck.acc, before) and ck.k_tile == 1
    assert torch.equal(a.acc, b.acc) and a.k_tile == b.k_tile == 3
    assert a.acc.data_ptr() != ck.acc.data_ptr() != b.acc.data_ptr()


def test_in_place_and_strided_inputs():
    _, (x, y) = _inputs(100, 300, 72)
    acc = torch.randn((128, 128), generator=torch.Generator().manual_seed(3))
    ref = matmul_partial_plain(x, y, acc, 1, 3)
    # x and y as transposed views of other layouts
    xt, yt = x.t().contiguous().t(), y.t().contiguous().t()
    assert torch.equal(matmul_resumable(xt, yt, acc, 1, 3), ref)
    out = matmul_resumable(x, y, acc, 1, 3, out=acc)
    assert out is acc and torch.equal(acc, ref)


@pytest.mark.parametrize("split", [1, 3])
def test_jax_checkpoint_resumes_in_port(split):
    (jx, jy), (x, y) = _inputs(257, 640, 130)
    jck = jmm.advance(jmm.start(jx, jy), jx, jy, n_tiles=split)
    ck = matmul_checkpoint_from_numpy(np.asarray(jck.acc), jck.k_tile,
                                      jck.n_ktiles, jck.shape, "cpu")
    assert ck.context_bytes() == jck.context_bytes()
    assert (ck.k_tile, ck.n_ktiles, ck.shape) == (jck.k_tile, jck.n_ktiles,
                                                  jck.shape)
    while not ck.done:
        ck = advance(ck, x, y, n_tiles=2)
    jdone = jmm.advance(jck, jx, jy, n_tiles=jck.n_ktiles)
    np.testing.assert_allclose(_np(finish(ck)), _np(jmm.finish(jdone)),
                               rtol=1e-3, atol=1e-3)


def _k_tile_lines(text):
    return [ln for ln in text.splitlines() if "k_tile=" in ln or
            ln.startswith("GEMM ")]


def test_demo_prints_the_reference_lines():
    jax_out = io.StringIO()
    with redirect_stdout(jax_out):
        runpy.run_path(str(ROOT / "examples" / "preemptible_kernel_demo.py"),
                       run_name="__main__")
    port_out = io.StringIO()
    with redirect_stdout(port_out):
        report = demo.main(["--device", "cpu"])
    lines = _k_tile_lines(port_out.getvalue())
    assert len(lines) == 5
    assert lines == _k_tile_lines(jax_out.getvalue())
    assert report["max_abs_err"] < 1e-3


def test_full_run_at_small_shape_on_cpu():
    """The ``--full`` path's checks, at a shape the CPU takes quickly; its
    full shape is qwen3-8b's down projection of a 2048-token prefill."""
    assert demo.full_shape() == (2048, 12288, 4096)
    _, (x, y) = _inputs(200, 1000, 130, "bfloat16")
    with redirect_stdout(io.StringIO()):
        rep = demo.preempted_vs_uninterrupted(x, y, quantum=2)
    assert rep["bitwise_equal"] and rep["n_ktiles"] == 8
    assert rep["n_quanta"] == 4 and rep["err_over_tol"] < 1.0
    assert rep["checkpoint_bytes"] == 256 * 256 * 4
    assert rep["uninterrupted_ms"] is None    # no device time on the CPU


BAD = {
    "mixed dtypes": lambda x, y, a: matmul_resumable(x, y.bfloat16(), a, 0, 1),
    "f16 inputs": lambda x, y, a: matmul_resumable(x.half(), y.half(), a, 0, 1),
    "f64 acc": lambda x, y, a: matmul_resumable(x, y, a.double(), 0, 1),
    "small acc": lambda x, y, a: matmul_resumable(x, y, a[:10], 0, 1),
    "inner dims": lambda x, y, a: matmul_resumable(x, y[:100], a, 0, 1),
    "vector": lambda x, y, a: matmul_resumable(x[0], y, a, 0, 1),
    "past the end": lambda x, y, a: matmul_resumable(x, y, a, 1, 4),
    "backwards": lambda x, y, a: matmul_resumable(x, y, a, 2, 1),
    "bad bk": lambda x, y, a: matmul_resumable(x, y, a, 0, 1, bk=0),
    "bad out": lambda x, y, a: matmul_resumable(x, y, a, 0, 1, out=a[:, :64]),
    "other GEMM": lambda x, y, a: advance(start(x, y), x[:64], y, 1),
    "unfinished": lambda x, y, a: finish(start(x, y)),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_bad_inputs_raise(case):
    _, (x, y) = _inputs(100, 300, 72)
    with pytest.raises(ValueError):
        BAD[case](x, y, torch.zeros((128, 128)))


# --------------------------------------------------------------------------
# the tolerance chip_smoke.py holds the kernel to, against simulated faults
# --------------------------------------------------------------------------
def _tf32(a):
    """f32 values rounded to TF32's 10-bit mantissa (nearest even)."""
    b = a.astype(np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0xFFF + ((b >> 13) & 1)) & ~np.uint64(0x1FFF)
    return b.astype(np.uint32).view(np.float32)


def _fma_chain(x, y, acc, lo, hi, skip=()):
    """The kernel's sum: each element one f32 register seeded from ``acc``,
    adding the exact product of row k in ascending k, rounded to f32."""
    a = acc.copy()
    for k in range(lo, hi):
        if k not in skip:
            a = (a + np.outer(x[:, k].astype(np.float64),
                              y[k].astype(np.float64))).astype(np.float32)
    return a


def tolerance_ratios(shape, dtype):
    """max |result - float64 plain| / tolerance for the kernel's sum and for
    each fault, over the full K range and a middle range seeded from a
    non-zero accumulator."""
    m, k, n = shape
    _, (xt, yt) = _inputs(m, k, n, dtype, seed=5)
    x, y = xt.float().numpy(), yt.float().numpy()
    nk = -(-k // 128)
    rng = np.random.default_rng(6)
    out = {}
    for name, ks, ke in (("full", 0, nk), ("middle", nk // 3,
                                           nk // 3 + max(1, nk // 3))):
        acc = (np.zeros((m, n), np.float32) if name == "full" else
               rng.standard_normal((m, n)).astype(np.float32))
        lo, hi = ks * 128, min(ke * 128, k)
        exact = acc + x[:, lo:hi].astype(np.float64) @ y[lo:hi].astype(
            np.float64)
        tol = f32_sum_tolerance(xt, yt, torch.from_numpy(acc), ks, ke).numpy()
        cases = {"kernel": _fma_chain(x, y, acc, lo, hi),
                 "drop one K tile": _fma_chain(x, y, acc, lo, hi,
                                               set(range(lo, min(lo + 128,
                                                                 hi)))),
                 "drop the last K column": _fma_chain(x, y, acc, lo, hi,
                                                      {hi - 1})}
        if name == "middle":
            cases["ignore acc_in"] = _fma_chain(x, y, 0 * acc, lo, hi)
        if dtype == "float32":      # TF32 leaves bf16 values as they are
            cases["TF32"] = _fma_chain(_tf32(x), _tf32(y), acc, lo, hi)
        out[name] = {c: float((np.abs(v - exact) / tol).max())
                     for c, v in cases.items()}
    return out


@pytest.mark.parametrize("shape", SHAPES + [(16, 12288, 16)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tolerance_passes_the_kernel_sum_and_fails_each_fault(shape, dtype):
    for ratios in tolerance_ratios(shape, dtype).values():
        assert ratios.pop("kernel") < 0.5
        assert min(ratios.values()) > 2.0, ratios


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_on_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(0)
    variant = mm_ops.kernel_variant(dtype, 128)
    before = mm_ops.variant_launches[variant]
    for m, k, n in SHAPES:
        x = torch.randn((m, k), generator=gen, device="cuda", dtype=dtype)
        y = torch.randn((k, n), generator=gen, device="cuda", dtype=dtype)
        ck = start(x, y)
        acc = torch.randn(ck.acc.shape, generator=gen, device="cuda")
        for ks, ke in ((0, ck.n_ktiles), (ck.n_ktiles // 3, ck.n_ktiles)):
            got = matmul_resumable(x, y, acc, ks, ke)
            exact = matmul_partial_plain(x, y, acc.double(), ks, ke)
            tol = f32_sum_tolerance(x, y, acc, ks, ke)
            assert bool(((got.double() - exact).abs() <= tol).all())
        one = advance(ck, x, y, ck.n_ktiles)
        chunked = ck
        while not chunked.done:
            chunked = advance(chunked, x, y, 1)
        assert torch.equal(one.acc, chunked.acc)
    # per shape: 2 checked ranges, 1 uninterrupted launch, 1 per K tile
    expect = sum(3 + -(-k // 128) for _, k, _ in SHAPES)
    assert mm_ops.variant_launches[variant] == before + expect


if __name__ == "__main__":
    for s in SHAPES + [(64, 12288, 64)]:
        for dt in ("float32", "bfloat16"):
            for rng_name, r in tolerance_ratios(s, dt).items():
                print(s, dt, rng_name,
                      {c: round(v, 4) for c, v in r.items()})
