"""Cross-attention and the image projection of the port against
``repro.models`` on the same weights and inputs (made with numpy), on the
tiny llama-3.2-vision-11b with QKV bias and qk-norm switched on or off:
``cross_attn_prefill`` against ``cross_attn_forward`` and
``cross_attn_kv``, ``cross_attn_decode`` against ``cross_attn_decode``, at
2e-4 in f32 and 3e-2 in bf16 (the bf16 bound of
tests/test_torch_attention_kernels.py); ``img_proj`` in bf16 within one
bf16 ulp of JAX's, which computes the product in f32 and rounds once."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfgs
from repro.models import attention as ja
from repro.models import transformer as jt
from repro_torch import configs as tcfgs
from repro_torch.models import attention as ta
from repro_torch.models import transformer as tt
from repro_torch.params import params_from_numpy

torch.set_num_threads(2)
VLM = "llama-3.2-vision-11b"
TOL = {"float32": 2e-4, "bfloat16": 3e-2}
OPTIONS = [(False, False), (True, True), (True, False), (False, True)]


def _cfgs(qkv_bias, qk_norm):
    over = dict(qkv_bias=qkv_bias, qk_norm=qk_norm)
    return (dataclasses.replace(jcfgs.get_tiny_config(VLM), **over),
            dataclasses.replace(tcfgs.get_tiny_config(VLM), **over))


def _weights(jcfg, dtype, seed=0):
    """A cross-attention layer's weights from ``init_attn`` with random
    biases and norm scales, as numpy in ``dtype``."""
    tree = jax.tree.map(np.asarray, ja.init_attn(
        jax.random.PRNGKey(seed), jcfg, jnp.float32, cross=True))
    rng = np.random.default_rng(seed)
    for name in tree:
        if name in ("bq", "bk", "bv"):
            tree[name] = 0.1 * rng.standard_normal(tree[name].shape)
        elif name in ("q_norm", "k_norm"):
            tree[name] = 1 + 0.1 * rng.standard_normal(tree[name].shape)
    return {k: np.asarray(jnp.asarray(v, dtype)) for k, v in tree.items()}


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _both(tree, x, img_h, dtype):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    return (jax.tree.map(jnp.asarray, tree),
            params_from_numpy(tree, "cpu", tdt),
            (jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)),
            (jnp.asarray(img_h, jdt), torch.from_numpy(img_h).to(tdt)))


def _close(got, ref, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("qkv_bias,qk_norm", OPTIONS)
@pytest.mark.parametrize("s,t", [(1, 8), (5, 8), (37, 100)])
def test_cross_attn_prefill_matches_jax(dtype, qkv_bias, qk_norm, s, t):
    """Ragged S against a different T, both smaller and larger; the image
    K/V it returns for the cache equal ``cross_attn_kv``'s."""
    jcfg, tcfg = _cfgs(qkv_bias, qk_norm)
    jp, tp, (xj, xt), (ij, it) = _both(
        _weights(jcfg, getattr(jnp, dtype)), _x((2, s, jcfg.d_model), 1),
        _x((2, t, jcfg.d_model), 2), dtype)
    yj = ja.cross_attn_forward(xj, jp, jcfg, ij)
    kvj = ja.cross_attn_kv(jp, jcfg, ij)
    yt, kvt = ta.cross_attn_prefill(xt, tp, tcfg, it)
    assert yt.dtype == getattr(torch, dtype) and yt.shape == (2, s, jcfg.d_model)
    _close(yt, yj, TOL[dtype])
    for name in ("k", "v"):
        assert kvt[name].shape == (2, t, jcfg.n_kv_heads, jcfg.d_head)
        _close(kvt[name], kvj[name], TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("qkv_bias,qk_norm", OPTIONS)
def test_cross_attn_decode_matches_jax(dtype, qkv_bias, qk_norm):
    """One token over every image position of the cache that
    ``cross_attn_kv`` builds; the cache comes back unchanged."""
    jcfg, tcfg = _cfgs(qkv_bias, qk_norm)
    jp, tp, (xj, xt), (ij, it) = _both(
        _weights(jcfg, getattr(jnp, dtype), seed=3),
        _x((2, 1, jcfg.d_model), 4), _x((2, 40, jcfg.d_model), 5), dtype)
    cj = ja.cross_attn_kv(jp, jcfg, ij)
    _, ct = ta.cross_attn_prefill(xt, tp, tcfg, it)
    before = {k: v.clone() for k, v in ct.items()}
    yj, cj2 = ja.cross_attn_decode(xj, jp, jcfg, cj)
    yt, ct2 = ta.cross_attn_decode(xt, tp, tcfg, ct)
    _close(yt, yj, TOL[dtype])
    assert ct2 is ct
    for name in ("k", "v"):
        assert torch.equal(ct2[name], before[name])
        _close(ct2[name], cj2[name], TOL[dtype])


def _img_h(dtype, seed=6):
    """``img_h`` of both packages' ``_embed_inputs`` on tiny VLM weights of
    ``dtype`` and f32 image embeddings, as the engine hands them over."""
    jcfg, tcfg = jcfgs.get_tiny_config(VLM), tcfgs.get_tiny_config(VLM)
    jdt = getattr(jnp, dtype)
    tree = jax.tree.map(np.asarray, jt.init_params(
        jax.random.PRNGKey(seed), jcfg, jdt))
    batch = {"tokens": np.arange(1, 6, dtype=np.int32)[None],
             "img_embeds": _x((1, jcfg.img_tokens * 8, jcfg.d_vision), seed)}
    _, ij = jt._embed_inputs(jax.tree.map(jnp.asarray, tree), jcfg,
                             {k: jnp.asarray(v) for k, v in batch.items()})
    _, it = tt._embed_inputs(params_from_numpy(tree, "cpu"), tcfg,
                             {k: torch.from_numpy(v) for k, v in batch.items()})
    return it, np.asarray(ij.astype(jnp.float32)), tree["img_proj"]["w"], batch


def test_img_proj_bf16_within_one_ulp_of_jax():
    """Both round one f32 product to bf16; f32 sums in another order can
    move a value across a rounding boundary, by one ulp at most."""
    it, ij, _, _ = _img_h("bfloat16")
    assert it.dtype == torch.bfloat16
    got = it.float().numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ij), 1e-30))) - 7)
    assert (np.abs(got - ij) <= ulp).all()
    assert np.mean(got == ij) > 0.95


def test_img_proj_rounds_an_f32_product():
    """The port's ``img_h`` is the f32 product rounded once: exactly, where
    a product of the inputs rounded to bf16 first would differ."""
    it, _, w, batch = _img_h("bfloat16")
    emb = torch.from_numpy(batch["img_embeds"])
    wt = params_from_numpy({"w": w}, "cpu")["w"]
    once = (emb @ wt.float()).to(torch.bfloat16)
    assert torch.equal(it, once)
    assert not torch.equal(it, emb.to(torch.bfloat16) @ wt)


def test_img_proj_f32_matches_jax():
    it, ij, _, _ = _img_h("float32")
    assert it.dtype == torch.float32
    np.testing.assert_allclose(it.numpy(), ij, rtol=1e-5, atol=1e-5)
