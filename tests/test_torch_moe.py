"""The port's MoE feed-forward against ``repro.models.moe`` on the same
weights (tiny qwen3-moe and phi3.5-moe): capacity exactly, routing indices
exactly (tied probabilities and overflowing queues included), outputs at
1e-5 in f32 and within a stated bound in bf16; and the router stays f32
whatever dtype the weights are bridged or drawn in.  ``moe_ffn`` runs under
``torch.use_deterministic_algorithms(True)``, as on the card."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import get_model as jax_get_model
from repro.models import moe as jmoe
from repro.models import transformer as jt
from repro_torch import configs
from repro_torch.models import get_model
from repro_torch.models import moe
from repro_torch.models import transformer as tt
from repro_torch.params import params_from_numpy

torch.set_num_threads(2)
MOE = ["qwen3-moe-30b-a3b", "phi3.5-moe-42b-a6.6b"]
TOL = 1e-5


@pytest.fixture(autouse=True)
def deterministic():
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


def _weights(arch, dtype=jnp.float32, seed=0):
    """One MoE slot's weights from the JAX initialiser, as numpy, and both
    packages' tiny configs."""
    jcfg = jconfigs.get_tiny_config(arch)
    tree = jax.tree.map(np.asarray,
                        jmoe.init_moe(jax.random.PRNGKey(seed), jcfg, dtype))
    return jcfg, configs.get_tiny_config(arch), tree


def _x(t, d, seed=1):
    return np.random.default_rng(seed).standard_normal((t, d)).astype(np.float32)


def _both(jcfg, tcfg, tree, x, dtype=None):
    """moe_ffn and route of both packages on the same x and weights."""
    tp = params_from_numpy(tree, "cpu")
    xt = torch.from_numpy(x)
    xj = jnp.asarray(x)
    if dtype is not None:
        xt, xj = xt.to(torch.bfloat16), xj.astype(jnp.bfloat16)
    jout = [np.asarray(a, np.float32) for a in
            jmoe.moe_ffn(xj, tree, jcfg) + jmoe.route(xj, tree, jcfg)]
    tout = [a.float().numpy() for a in
            moe.moe_ffn(xt, tp, tcfg) + moe.route(xt, tp, tcfg)]
    return jout, tout


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("tiny", [True, False])
def test_capacity_matches_jax(arch, tiny):
    get = jconfigs.get_tiny_config if tiny else jconfigs.get_config
    jcfg = get(arch)
    tcfg = (configs.get_tiny_config if tiny else configs.get_config)(arch)
    for t in list(range(1, 130)) + [255, 256, 1000, 2048, 3072, 4095, 8192]:
        got = moe.capacity(t, tcfg)
        assert isinstance(got, int)
        assert got == jmoe.capacity(t, jcfg), t
    if not tiny and arch == "qwen3-moe-30b-a3b":
        assert (moe.capacity(1, tcfg), moe.capacity(2048, tcfg)) == (8, 160)


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("t", [1, 7, 64])
def test_route_matches_jax(arch, t):
    jcfg, tcfg, tree = _weights(arch)
    x = _x(t, jcfg.d_model)
    gw_j, idx_j, aux_j = jmoe.route(jnp.asarray(x), tree, jcfg)
    gw_t, idx_t, aux_t = moe.route(torch.from_numpy(x),
                                   params_from_numpy(tree, "cpu"), tcfg)
    assert np.array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_allclose(gw_t.numpy(), np.asarray(gw_j), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=TOL, atol=TOL)
    assert gw_t.dtype == aux_t.dtype == torch.float32


@pytest.mark.parametrize("arch", MOE)
def test_moe_ffn_matches_jax(arch):
    jcfg, tcfg, tree = _weights(arch)
    (out_j, aux_j, _, idx_j, _), (out_t, aux_t, _, idx_t, _) = _both(
        jcfg, tcfg, tree, _x(64, jcfg.d_model))
    assert np.array_equal(idx_t, idx_j)
    np.testing.assert_allclose(out_t, out_j, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(aux_t, aux_j, rtol=TOL, atol=TOL)


def test_tied_probabilities_order_as_jax():
    """Router columns 2 and 5 copied from column 0 (scaled up so the three
    lead): every token's probabilities tie across the top-k boundary, so
    which of the tied experts is chosen, and so every queue position,
    depends on the tie order.  ``torch.topk`` orders ties differently from
    ``jax.lax.top_k``; the port's stable sort must give JAX's indices."""
    jcfg, tcfg, tree = _weights("qwen3-moe-30b-a3b")
    r = tree["router"].copy()
    r[:, 0] *= 4.0
    r[:, 2] = r[:, 5] = r[:, 0]
    tree = {**tree, "router": r}
    x = _x(32, jcfg.d_model)
    (out_j, _, _, idx_j, _), (out_t, _, _, idx_t, _) = _both(jcfg, tcfg, tree, x)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(x) @ r, axis=-1))
    top = -np.sort(-probs, axis=-1)
    k = jcfg.top_k
    ties = top[:, k - 1] == top[:, k]
    assert ties.sum() >= 8, "the case must tie across the top-k boundary"
    assert np.array_equal(idx_t, idx_j)
    np.testing.assert_allclose(out_t, out_j, rtol=TOL, atol=TOL)


def _overflow_case():
    """T = 64 with router column 3 biased so every token routes a copy to
    expert 3: its queue (64) exceeds the capacity (24), so copies are
    dropped onto slot cap - 1, which a kept copy holds."""
    jcfg, tcfg, tree = _weights("qwen3-moe-30b-a3b")
    r = tree["router"].copy()
    r[:, 3] += 0.5 * np.sign(np.random.default_rng(2).standard_normal(
        jcfg.d_model)).astype(np.float32)
    x = _x(64, jcfg.d_model)
    x += 4.0 * np.sign(r[:, 3])[None, :] / jcfg.d_model ** 0.5
    tree = {**tree, "router": r}
    assert moe.capacity(64, tcfg) == 24
    return jcfg, tcfg, tree, x


def test_overflow_matches_jax():
    jcfg, tcfg, tree, x = _overflow_case()
    (out_j, aux_j, _, idx_j, _), (out_t, aux_t, _, idx_t, _) = _both(
        jcfg, tcfg, tree, x)
    assert (idx_j == 3).sum() > moe.capacity(64, tcfg)
    assert np.array_equal(idx_t, idx_j)
    np.testing.assert_allclose(out_t, out_j, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(aux_t, aux_j, rtol=TOL, atol=TOL)


def test_overflow_fails_an_assigning_scatter(monkeypatch):
    """The same case with the dispatch scatter made to assign instead of
    accumulate: the dropped copies' zeros overwrite the kept copy at slot
    cap - 1, and the outputs leave the tolerance."""
    jcfg, tcfg, tree, x = _overflow_case()
    put = torch.Tensor.index_put_
    monkeypatch.setattr(torch.Tensor, "index_put_",
                        lambda self, idx, v, accumulate=False:
                        put(self, idx, v, accumulate=False))
    (out_j, *_), (out_t, *_) = _both(jcfg, tcfg, tree, x)
    assert np.abs(out_t - out_j).max() > 100 * TOL


# bf16: both packages round the same values at the same places (the
# scatter is exact, then h, the gate, their product, the expert output,
# the gate weight and the weighted copy, and the sum over k once), but
# sum the products in f32 in different orders, so a rounding may land one
# bf16 ulp apart at any of those places.  Held to 2**-6 relative plus
# 2**-6 of the largest output: a few ulps (2**-8 each) through the chain.
BF16_TOL = 2.0 ** -6


@pytest.mark.parametrize("arch", MOE)
def test_moe_ffn_bf16_matches_jax(arch):
    jcfg, tcfg, tree = _weights(arch, jnp.bfloat16)
    assert tree["router"].dtype == np.float32
    (out_j, _, _, idx_j, _), (out_t, _, _, idx_t, _) = _both(
        jcfg, tcfg, tree, _x(64, jcfg.d_model), dtype=torch.bfloat16)
    assert np.array_equal(idx_t, idx_j)
    bound = BF16_TOL * (np.abs(out_j) + np.abs(out_j).max())
    assert (np.abs(out_t - out_j) <= bound).all(), \
        float((np.abs(out_t - out_j) / bound).max())


def test_router_stays_f32_in_bf16():
    jmodel = jax_get_model("qwen3-moe-30b-a3b", tiny=True)
    tree = jax.tree.map(np.asarray, jmodel.init_params(jax.random.PRNGKey(0)))
    bridged = params_from_numpy(tree, "cpu", dtype=torch.bfloat16)
    drawn = get_model("qwen3-moe-30b-a3b", tiny=True).init_params(
        generator=torch.Generator().manual_seed(0), dtype=torch.bfloat16,
        device="cpu")
    for params in (bridged, drawn):
        ffn = params["slots"]["slot0"]["ffn"]
        assert ffn["router"].dtype == torch.float32
        assert {ffn[w].dtype for w in ("w_in", "w_gate", "w_out")} == \
            {torch.bfloat16}
        assert params["embed"]["table"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", MOE)
def test_init_params_shapes_match_jax(arch):
    jmodel = jax_get_model(arch, tiny=True)
    ref = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                       jax.eval_shape(lambda k: jmodel.init_params(
                           k, dtype=jnp.bfloat16), jax.random.PRNGKey(0)))
    got = tt.tree_map(lambda t: (tuple(t.shape), str(t.dtype).split(".")[1]),
                      get_model(arch, tiny=True).init_params(
                          generator=torch.Generator().manual_seed(0),
                          dtype=torch.bfloat16, device="cpu"))
    assert got == ref


@pytest.mark.parametrize("arch", MOE)
def test_block_aux_matches_jax(arch):
    """One prefill block: hidden state and the MoE's aux loss, the third
    value ``_apply_block`` returns as the reference's does."""
    jmodel = jax_get_model(arch, tiny=True)
    tree = jax.tree.map(np.asarray, jmodel.init_params(jax.random.PRNGKey(0)))
    cfg = jmodel.cfg
    h = _x(12, cfg.d_model)[None]
    slot_j = jax.tree.map(lambda a: a[0], tree["slots"]["slot0"])
    hj, _, aux_j = jt._apply_block(0, jnp.asarray(h), slot_j, cfg, "prefill",
                                   None, None, None)
    tp = params_from_numpy(tree, "cpu")
    ht, _, aux_t = tt._apply_block(0, torch.from_numpy(h),
                                   tt.period_params(tp["slots"], 0)["slot0"],
                                   get_model(arch, tiny=True).cfg, "prefill",
                                   None, None, None)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=TOL, atol=TOL)
    assert float(aux_t) > 0


# twins of tests/test_models.py's two MoE tests, on the port
def test_moe_capacity_and_routing():
    cfg = configs.get_tiny_config("qwen3-moe-30b-a3b")
    gen = torch.Generator().manual_seed(0)
    p = moe.init_moe(cfg, gen, None, torch.float32, "cpu")
    x = torch.randn((64, cfg.d_model), generator=gen)
    gw, idx, aux = moe.route(x, p, cfg)
    assert gw.shape == (64, cfg.top_k)
    torch.testing.assert_close(gw.sum(-1), torch.ones(64), rtol=0, atol=1e-5)
    assert int(idx.max()) < cfg.n_experts
    assert float(aux) > 0
    out, _ = moe.moe_ffn(x, p, cfg)
    assert out.shape == x.shape
    assert bool(torch.isfinite(out).all())


def test_moe_identical_tokens_get_identical_outputs():
    """Routing determinism: duplicate tokens land on the same experts and
    produce the same combined output (capacity permitting)."""
    cfg = configs.get_tiny_config("phi3.5-moe-42b-a6.6b")
    gen = torch.Generator().manual_seed(0)
    p = moe.init_moe(cfg, gen, None, torch.float32, "cpu")
    x = torch.randn((1, cfg.d_model), generator=gen).repeat(4, 1)
    out, _ = moe.moe_ffn(x, p, cfg)
    torch.testing.assert_close(out, out[:1].expand(4, -1), rtol=1e-5,
                               atol=1e-5)
