"""The port's model against ``repro.models`` on bridged weights (tiny
configs, f32; the dense archs, the two MoE archs, xlstm-350m, the hybrid
jamba-1.5-large, the VLM llama-3.2-vision-11b with its image inputs and
cross-attention, and the encoder-only hubert-xlarge on frame inputs):
prefill and decode logits and every cache leaf at 2e-4, prefill beyond
2048 keys (the reference's chunked attention) at 2e-4, prefill against
incremental decode inside the port at 2e-3, cache sizes exactly, and the
parameter tree of every arch."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import get_model as jax_get_model
from repro.models import transformer as jt
from repro_torch import configs
from repro_torch.models import get_model
from repro_torch.models import transformer as tt
from repro_torch.params import params_from_numpy

torch.set_num_threads(2)
DENSE = ["olmo-1b", "qwen3-8b", "qwen1.5-4b", "deepseek-coder-33b"]
MOE = ["qwen3-moe-30b-a3b", "phi3.5-moe-42b-a6.6b"]
SSM = ["xlstm-350m", "jamba-1.5-large-398b"]
VLM, AUDIO = "llama-3.2-vision-11b", "hubert-xlarge"
TOL = 2e-4


def bridged_params(name, seed=0):
    """JAX init_params with its constant leaves (biases, norm scales, the
    recurrent mixers' dt_bias, D and gate biases) replaced by random
    values, as numpy; the same tree feeds both packages.  A_log keeps its
    values, so A = -exp(A_log) stays negative."""
    model = jax_get_model(name, tiny=True)
    tree = jax.tree.map(np.asarray, model.init_params(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)

    def perturb(path, leaf):
        name = getattr(path[-1], "key", "")
        if name in ("bq", "bk", "bv", "bias"):
            return rng.standard_normal(leaf.shape).astype(leaf.dtype) * 0.1
        if name in ("dt_bias", "D", "b_i", "b_f", "b_zifo"):
            return (leaf + 0.3 * rng.standard_normal(leaf.shape)).astype(
                leaf.dtype)
        if name in ("scale", "q_norm", "k_norm"):
            return (1 + 0.1 * rng.standard_normal(leaf.shape)).astype(leaf.dtype)
        return leaf
    return model, jax.tree_util.tree_map_with_path(perturb, tree)


def _tokens(cfg, s, seed=1):
    return np.random.default_rng(seed).integers(1, cfg.vocab_size, (1, s)).astype(np.int32)


def _batch(cfg, s, seed=1):
    """The model's inputs for ``s`` positions, as numpy: the tokens of
    ``_tokens``, or frames for the audio model; a VLM's image embeddings
    are drawn after its tokens."""
    rng = np.random.default_rng(seed)
    if cfg.embedding_inputs:
        return {"frames": rng.standard_normal((1, s, cfg.d_model)).astype(
            np.float32)}
    batch = {"tokens": rng.integers(1, cfg.vocab_size, (1, s)).astype(np.int32)}
    if cfg.img_tokens:
        batch["img_embeds"] = rng.standard_normal(
            (1, cfg.img_tokens, cfg.d_vision)).astype(np.float32)
    return batch


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _assert_caches_close(got, ref, tol, prefix=None):
    """Every leaf of two stacked caches; ``prefix`` cuts the reference's
    attention leaves to their first ``prefix`` positions."""
    assert sorted(got) == sorted(ref)
    for slot, leaves in ref.items():
        assert sorted(got[slot]) == sorted(leaves)
        for name, r in leaves.items():
            r = np.asarray(r)
            g = got[slot][name].numpy()
            if prefix is not None and name in ("k", "v"):
                g = g[:, :, :prefix]
            np.testing.assert_allclose(g, r, rtol=tol, atol=tol,
                                       err_msg=f"{slot}/{name}")


@pytest.mark.parametrize("arch", DENSE + MOE + SSM + [VLM, AUDIO])
def test_prefill_and_decode_match_jax(arch):
    """The VLM also compares its image K/V, and decodes against the image
    K/V of its prefill; the encoder-only model has logits at every
    position, an empty cache and no decode."""
    jmodel, tree = bridged_params(arch)
    cfg = jmodel.cfg
    tcfg = get_model(arch, tiny=True).cfg
    jp = jax.tree.map(jnp.asarray, tree)
    tp = params_from_numpy(tree, "cpu")
    batch = _batch(cfg, 8)
    lj, pcj = jax.jit(jmodel.prefill)(jp, _jnp(batch))
    lt, pct = tt.prefill(tp, _torch(batch), tcfg)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=TOL, atol=TOL)
    _assert_caches_close(pct, jax.tree.map(np.asarray, pcj), TOL)
    if cfg.encoder_only:
        assert lt.shape == (1, 8, cfg.vocab_size) and pct == {}
        return

    toks = batch["tokens"]
    cj = jmodel.init_cache(1, 12, dtype=jnp.float32)
    ct = tt.init_cache(tcfg, 1, 12, dtype=torch.float32, device="cpu")
    for i, (mixer, _) in enumerate(cfg.block_pattern):
        if mixer == "cross_attn":
            cj[f"slot{i}"] = pcj[f"slot{i}"]
            ct[f"slot{i}"] = {k: v.clone() for k, v in pct[f"slot{i}"].items()}
    step = jax.jit(jmodel.decode_step)
    for t in range(toks.shape[1]):
        lj, cj = step(jp, cj, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
        lt, ct = tt.decode_step(tp, ct, torch.from_numpy(toks[:, t:t + 1]), t, tcfg)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=TOL, atol=TOL)
    # attention's K/V and every recurrent state (Mamba, mLSTM, sLSTM)
    _assert_caches_close(ct, jax.tree.map(np.asarray, cj), TOL)


@pytest.mark.parametrize("arch", ["olmo-1b", "qwen3-8b", "qwen3-moe-30b-a3b"]
                         + SSM)
def test_prefill_matches_incremental_decode(arch):
    model = get_model(arch, tiny=True)
    cfg = model.cfg
    params = model.init_params(generator=torch.Generator().manual_seed(0),
                               dtype=torch.float32, device="cpu")
    toks = torch.from_numpy(_tokens(cfg, 8, seed=2))
    logits_pre, cache_pre = model.prefill(params, {"tokens": toks})
    cache = model.init_cache(1, 12, dtype=torch.float32, device="cpu")
    for t in range(toks.shape[1]):
        logits, cache = model.decode_step(params, cache, toks[:, t:t + 1], t)
    torch.testing.assert_close(logits, logits_pre, rtol=2e-3, atol=2e-3)
    _assert_caches_close(cache, cache_pre, 2e-3, prefix=8)


@pytest.mark.parametrize("arch", DENSE + MOE + SSM + [VLM, AUDIO])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cache_bytes_match_jax(arch, dtype):
    jcfg = jax_get_model(arch).cfg
    tcfg = get_model(arch).cfg
    for batch, seq in ((1, 128), (2, 2048)):
        assert tt.cache_bytes(tcfg, batch, seq, getattr(torch, dtype)) == \
            jt.cache_bytes(jcfg, batch, seq, getattr(jnp, dtype))


@pytest.mark.parametrize("arch", ["qwen3-8b", "olmo-1b", "qwen3-moe-30b-a3b",
                                  AUDIO])
def test_long_prefill_matches_jax(arch):
    """S = 3072: above 2048 keys and a multiple of 1024, the reference
    attends through its ``lax.scan`` online softmax (hubert's without a
    causal mask); the port through the same flash path as below.  The
    MoE's capacity there is 960."""
    jmodel, tree = bridged_params(arch)
    batch = _batch(jmodel.cfg, 3072)
    lj, _ = jax.jit(jmodel.prefill)(jax.tree.map(jnp.asarray, tree),
                                    _jnp(batch))
    lt, ct = tt.prefill(params_from_numpy(tree, "cpu"), _torch(batch),
                        get_model(arch, tiny=True).cfg)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=TOL, atol=TOL)
    assert int(lt[0, -1].argmax()) == int(np.asarray(lj)[0, -1].argmax())
    if jmodel.cfg.encoder_only:
        assert lt.shape[1] == 3072 and ct == {}
    else:
        assert ct["slot0"]["k"].shape[2] == 3072


@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_init_params_shapes_match_jax(arch):
    """The same leaves with the same shapes and dtypes: no ``embed`` for
    frame inputs, which have an ``lm_head``; ``img_proj`` for image
    inputs."""
    jmodel = jax_get_model(arch, tiny=True)
    ref = jax.tree.map(lambda a: (a.shape, str(a.dtype)), jax.eval_shape(
        jmodel.init_params, jax.random.PRNGKey(0)))
    got = tt.tree_map(lambda t: (tuple(t.shape), str(t.dtype).split(".")[1]),
                      get_model(arch, tiny=True).init_params(
                          generator=torch.Generator().manual_seed(0),
                          dtype=torch.float32, device="cpu"))
    assert got == ref


@pytest.mark.parametrize("tiny", [True, False], ids=["tiny", "full"])
@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_every_arch_builds(arch, tiny):
    """Every mixer and input kind is ported: the model builds and its cache
    spec has each block's leaves, the image K/V at img_tokens positions."""
    model = get_model(arch, tiny=tiny)
    spec = model.cache_spec(1, 16)
    assert sorted(spec) == [f"slot{i}" for i in range(model.cfg.period)]
    for i, (mixer, _) in enumerate(model.cfg.block_pattern):
        if mixer in ("attn", "cross_attn"):
            t = model.cfg.img_tokens if mixer == "cross_attn" else 16
            assert spec[f"slot{i}"]["k"].shape == (
                model.cfg.n_periods, 1, t, model.cfg.n_kv_heads,
                model.cfg.d_head)


def test_bridge_keeps_bf16_bits():
    a = np.asarray(jnp.asarray(np.random.default_rng(3).standard_normal((4, 5)),
                               jnp.bfloat16))
    t = params_from_numpy({"w": a}, "cpu")["w"]
    assert t.dtype == torch.bfloat16
    assert np.array_equal(t.view(torch.int16).numpy(), a.view(np.int16))


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    model = get_model("qwen3-8b", tiny=True)
    with pytest.raises(RuntimeError, match="cuda"):
        model.init_params(generator=torch.Generator())
    with pytest.raises(RuntimeError, match="cuda"):
        model.init_cache(1, 8)
