"""The port's dense model against ``repro.models`` on bridged weights (tiny
configs, f32): prefill and decode logits at 2e-4, prefill against
incremental decode inside the port at 2e-3, cache sizes exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import get_model as jax_get_model
from repro.models import transformer as jt
from repro_torch.models import get_model
from repro_torch.models import transformer as tt
from repro_torch.params import params_from_numpy

torch.set_num_threads(2)
DENSE = ["olmo-1b", "qwen3-8b", "qwen1.5-4b", "deepseek-coder-33b"]
TOL = 2e-4


def bridged_params(name, seed=0):
    """JAX init_params with its constant leaves (biases, norm scales)
    replaced by random values, as numpy; the same tree feeds both
    packages."""
    model = jax_get_model(name, tiny=True)
    tree = jax.tree.map(np.asarray, model.init_params(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)

    def perturb(path, leaf):
        name = getattr(path[-1], "key", "")
        if name in ("bq", "bk", "bv", "bias"):
            return rng.standard_normal(leaf.shape).astype(leaf.dtype) * 0.1
        if name in ("scale", "q_norm", "k_norm"):
            return (1 + 0.1 * rng.standard_normal(leaf.shape)).astype(leaf.dtype)
        return leaf
    return model, jax.tree_util.tree_map_with_path(perturb, tree)


def _tokens(cfg, s, seed=1):
    return np.random.default_rng(seed).integers(1, cfg.vocab_size, (1, s)).astype(np.int32)


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_match_jax(arch):
    jmodel, tree = bridged_params(arch)
    cfg = jmodel.cfg
    jp = jax.tree.map(jnp.asarray, tree)
    tp = params_from_numpy(tree, "cpu")
    toks = _tokens(cfg, 8)
    lj, _ = jax.jit(jmodel.prefill)(jp, {"tokens": jnp.asarray(toks)})
    lt, _ = tt.prefill(tp, {"tokens": torch.from_numpy(toks)}, get_model(arch, tiny=True).cfg)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=TOL, atol=TOL)

    tcfg = get_model(arch, tiny=True).cfg
    cj = jmodel.init_cache(1, 12, dtype=jnp.float32)
    ct = tt.init_cache(tcfg, 1, 12, dtype=torch.float32, device="cpu")
    step = jax.jit(jmodel.decode_step)
    for t in range(toks.shape[1]):
        lj, cj = step(jp, cj, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
        lt, ct = tt.decode_step(tp, ct, torch.from_numpy(toks[:, t:t + 1]), t, tcfg)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(ct["slot0"]["k"].numpy(), np.asarray(cj["slot0"]["k"]),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch", ["olmo-1b", "qwen3-8b"])
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
    torch.testing.assert_close(cache["slot0"]["k"][:, :, :8], cache_pre["slot0"]["k"],
                               rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cache_bytes_match_jax(arch, dtype):
    jcfg = jax_get_model(arch).cfg
    tcfg = get_model(arch).cfg
    for batch, seq in ((1, 128), (2, 2048)):
        assert tt.cache_bytes(tcfg, batch, seq, getattr(torch, dtype)) == \
            jt.cache_bytes(jcfg, batch, seq, getattr(jnp, dtype))


def test_init_params_shapes_match_jax():
    jmodel = jax_get_model("qwen1.5-4b", tiny=True)
    ref = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                       jax.eval_shape(jmodel.init_params, jax.random.PRNGKey(0)))
    got = tt.tree_map(lambda t: (tuple(t.shape), str(t.dtype).split(".")[1]),
                      get_model("qwen1.5-4b", tiny=True).init_params(
                          generator=torch.Generator().manual_seed(0),
                          dtype=torch.float32, device="cpu"))
    assert got == ref


def test_bridge_keeps_bf16_bits():
    a = np.asarray(jnp.asarray(np.random.default_rng(3).standard_normal((4, 5)),
                               jnp.bfloat16))
    t = params_from_numpy({"w": a}, "cpu")["w"]
    assert t.dtype == torch.bfloat16
    assert np.array_equal(t.view(torch.int16).numpy(), a.view(np.int16))


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "phi3.5-moe-42b-a6.6b",
                                  "xlstm-350m", "jamba-1.5-large-398b",
                                  "llama-3.2-vision-11b", "hubert-xlarge"])
def test_unported_archs_raise(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_model(arch, tiny=True)


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    model = get_model("qwen3-8b", tiny=True)
    with pytest.raises(RuntimeError, match="cuda"):
        model.init_params(generator=torch.Generator())
    with pytest.raises(RuntimeError, match="cuda"):
        model.init_cache(1, 8)
