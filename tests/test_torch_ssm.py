"""The port's recurrent mixers against ``repro.models.ssm`` on the same
weights (Mamba at tiny jamba-1.5-large's widths; mLSTM and sLSTM at tiny
xlstm-350m's, whose two heads make the sLSTM gate layout matter).

Prefill at S = 12 (one chunk) and S = 256 (two chunks of ``SCAN_CHUNK``,
so Mamba's (ssm, conv tail) carry is crossed), then 4 decode steps from
the JAX prefill's state: outputs and every state leaf at 1e-5 in f32 and
within ``BF16_TOL`` in bf16.  Also: the leaves the reference keeps in f32
stay f32 through both bridges, ``init_*`` shapes, dtypes and constants
equal JAX's, and the decode cache's size does not depend on ``max_seq``.
The constant leaves (``dt_bias``, ``D``, ``b_i``, ``b_f``, ``b_zifo``) are
perturbed, so a port that ignored one would fail.  Under autograd the
scans keep chunk-boundary states, not every step's (fault 3.3)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import get_model as jax_get_model
from repro.models import ssm as jssm
from repro_torch import configs
from repro_torch.models import get_model
from repro_torch.models import ssm
from repro_torch.models import transformer as tt
from repro_torch.params import params_from_numpy

torch.set_num_threads(2)
ARCH = {"mamba": "jamba-1.5-large-398b", "mlstm": "xlstm-350m",
        "slstm": "xlstm-350m"}
MIXERS = sorted(ARCH)
TOL = 1e-5
# bf16: both packages round the same values at the same places (the
# projections, the conv taps and their sums, silu, the cast of each step's
# output, the gating product), but a rounding may land one bf16 ulp apart
# where the two compute an op in another order or precision (a fused silu,
# a dot against a sum of rounded products); the f32 states carry such a
# difference on, damped by the forget gates.  Held to 2**-6 relative plus
# 2**-6 of the largest value: a few ulps (2**-8 each) through the chain.
BF16_TOL = 2.0 ** -6
# leaves that hold a constant at init, perturbed here so they matter
CONSTANT_LEAVES = ("dt_bias", "D", "b_i", "b_f", "b_zifo")


def _weights(mixer, dtype=jnp.float32, seed=0):
    """JAX ``init_<mixer>`` at the tiny config, as numpy, with its constant
    leaves moved off their constants (A_log stays, so A = -exp(A_log) < 0)."""
    jcfg = jconfigs.get_tiny_config(ARCH[mixer])
    tree = jax.tree.map(np.asarray, getattr(jssm, f"init_{mixer}")(
        jax.random.PRNGKey(seed), jcfg, dtype))
    rng = np.random.default_rng(seed)
    for name in CONSTANT_LEAVES:
        if name in tree:
            leaf = tree[name]
            tree[name] = (leaf.astype(np.float32) + 0.3 * rng.standard_normal(
                leaf.shape)).astype(leaf.dtype)
    return jcfg, configs.get_tiny_config(ARCH[mixer]), tree


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(jnp.asarray(t, jnp.float32))


def _run_both(mixer, s, dtype, n_decode=4, tree=None):
    """Prefill over ``s`` tokens, then ``n_decode`` steps, in both packages;
    each package's decode runs from the JAX prefill's state (bridged), so
    decode is compared from the same state.  Returns a list of
    (what, port, jax) arrays."""
    jcfg, tcfg, wtree = _weights(mixer, getattr(jnp, dtype))
    tree = wtree if tree is None else tree
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jp = jax.tree.map(jnp.asarray, tree)
    tp = params_from_numpy(tree, "cpu")
    x = _x((2, s, jcfg.d_model))
    yj, cj = jax.jit(getattr(jssm, f"{mixer}_prefill"), static_argnums=2)(
        jnp.asarray(x, jdt), jp, jcfg)
    yt, ct = getattr(ssm, f"{mixer}_prefill")(torch.from_numpy(x).to(tdt),
                                              tp, tcfg)
    out = [("prefill out", yt, yj)]
    out += [(f"prefill {k}", ct[k], cj[k]) for k in cj]
    dec = jax.jit(getattr(jssm, f"{mixer}_decode"), static_argnums=2)
    state = params_from_numpy(jax.tree.map(np.asarray, cj), "cpu")
    for i in range(n_decode):
        xs = _x((2, 1, jcfg.d_model), seed=10 + i)
        yt, ct = getattr(ssm, f"{mixer}_decode")(
            torch.from_numpy(xs).to(tdt), tp, tcfg, state)
        yj, cj = dec(jnp.asarray(xs, jdt), jp, jcfg, cj)
        out.append((f"decode {i} out", yt, yj))
        out += [(f"decode {i} {k}", ct[k], cj[k]) for k in cj]
        state = params_from_numpy(jax.tree.map(np.asarray, cj), "cpu")
    for what, t, j in out:
        assert tuple(t.shape) == tuple(j.shape), what
        assert str(t.dtype).split(".")[1] == str(j.dtype), what
    return out


@pytest.mark.parametrize("s", [12, 256])
@pytest.mark.parametrize("mixer", MIXERS)
def test_prefill_and_state_match_jax(mixer, s):
    for what, t, j in _run_both(mixer, s, "float32", n_decode=0):
        np.testing.assert_allclose(_np(t), _np(j), rtol=TOL, atol=TOL,
                                   err_msg=what)


@pytest.mark.parametrize("mixer", MIXERS)
def test_decode_matches_jax_from_the_same_state(mixer):
    for what, t, j in _run_both(mixer, 12, "float32")[1:]:
        np.testing.assert_allclose(_np(t), _np(j), rtol=TOL, atol=TOL,
                                   err_msg=what)


@pytest.mark.parametrize("s", [12, 256])
@pytest.mark.parametrize("mixer", MIXERS)
def test_bf16_matches_jax(mixer, s):
    for what, t, j in _run_both(mixer, s, "bfloat16"):
        got, ref = _np(t), _np(j)
        bound = BF16_TOL * (np.abs(ref) + np.abs(ref).max())
        assert (np.abs(got - ref) <= bound).all(), \
            (what, float((np.abs(got - ref) / bound).max()))


def test_slstm_gate_layout_per_head():
    """x_pre is read as (B, H, 4·dh) and split into z, i, f, o per head.
    Reading it as (B, 4, H, dh) is the same as the right reading of
    ``w_zifo``/``b_zifo`` with their columns permuted from (gate, head, d)
    to (head, gate, d); with two heads that permutation is not the
    identity, so such a port leaves the tolerance by far while the port
    stays inside it."""
    _, _, tree = _weights("slstm")
    d, h = tree["w_out"].shape[0], 2
    dh = d // h
    perm = np.arange(4 * d).reshape(4, h, dh).transpose(1, 0, 2).reshape(-1)
    wrong = dict(tree, w_zifo=tree["w_zifo"][:, perm],
                 b_zifo=tree["b_zifo"][perm])
    right = _run_both("slstm", 12, "float32", n_decode=1)
    bad = _run_both("slstm", 12, "float32", n_decode=1, tree=wrong)
    for (what, t, j), (_, tw, _) in zip(right, bad):
        np.testing.assert_allclose(_np(t), _np(j), rtol=TOL, atol=TOL,
                                   err_msg=what)
    assert np.abs(_np(bad[0][1]) - _np(right[0][2])).max() > 1000 * TOL


F32_NAMES = {"mamba": ("A_log", "D"), "mlstm": ("w_i", "w_f", "b_i", "b_f"),
             "slstm": ("r_zifo", "b_zifo")}


@pytest.mark.parametrize("arch", ["xlstm-350m", "jamba-1.5-large-398b"])
def test_f32_leaves_stay_f32_in_bf16(arch):
    jmodel = jax_get_model(arch, tiny=True)
    # the bridge reads names and dtypes: zeros of JAX's f32 shapes will do
    tree = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), jax.eval_shape(
        jmodel.init_params, jax.random.PRNGKey(0)))
    bridged = params_from_numpy(tree, "cpu", dtype=torch.bfloat16)
    drawn = get_model(arch, tiny=True).init_params(
        generator=torch.Generator().manual_seed(0), dtype=torch.bfloat16,
        device="cpu")
    seen = set()
    for params in (bridged, drawn):
        for i, (mixer, _) in enumerate(jmodel.cfg.block_pattern):
            if mixer == "attn":
                continue
            leaves = params["slots"][f"slot{i}"]["mixer"]
            for name, leaf in leaves.items():
                want = torch.float32 if name in F32_NAMES[mixer] \
                    else torch.bfloat16
                assert leaf.dtype == want, (mixer, name)
            seen.add(mixer)
    assert seen == ({"mamba"} if arch.startswith("jamba")
                    else {"mlstm", "slstm"})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mixer", MIXERS)
def test_init_matches_jax(mixer, dtype):
    """Shapes and dtypes of ``init_<mixer>`` stacked over 3 periods equal
    JAX's (vmapped as its init_params does), its constant leaves are
    exact, and its random leaves have the reference's standard
    deviations."""
    jcfg = jconfigs.get_tiny_config(ARCH[mixer])
    tcfg = configs.get_tiny_config(ARCH[mixer])
    init = getattr(jssm, f"init_{mixer}")
    ref = jax.vmap(lambda k: init(k, jcfg, getattr(jnp, dtype)))(
        jax.random.split(jax.random.PRNGKey(0), 3))
    got = getattr(ssm, f"init_{mixer}")(
        tcfg, torch.Generator().manual_seed(0), 3, getattr(torch, dtype),
        "cpu")
    assert sorted(got) == sorted(ref)
    for name, r in ref.items():
        g = got[name]
        assert (tuple(g.shape), str(g.dtype).split(".")[1]) == \
            (r.shape, str(r.dtype)), name
        r = _np(r)
        if name in CONSTANT_LEAVES or name == "A_log":
            np.testing.assert_array_equal(_np(g), r, err_msg=name)
        else:
            assert abs(_np(g).std() / r.std() - 1) < 0.25, name
    if mixer == "mamba":
        np.testing.assert_array_equal(
            _np(got["A_log"])[0, 0], np.log(np.arange(1, tcfg.mamba_d_state + 1,
                                                      dtype=np.float32)))
        assert float(got["dt_bias"].float().flatten()[0]) == \
            float(torch.tensor(-4.6, dtype=getattr(torch, dtype)))
    if mixer == "mlstm":
        assert float(got["b_f"].min()) == float(got["b_f"].max()) == 3.0


@pytest.mark.parametrize("arch", ["xlstm-350m", "jamba-1.5-large-398b"])
def test_recurrent_cache_is_constant_in_max_seq(arch):
    """Twin of tests/test_models.py::test_ssm_decode_state_constant_size:
    xlstm's whole cache, and jamba's recurrent slots, have one size at
    max_seq 128 and 4096; jamba's attention slot grows 32-fold."""
    cfg = get_model(arch, tiny=True).cfg
    c1 = tt.init_cache(cfg, 1, 128, dtype=torch.float32, device="cpu")
    c2 = tt.init_cache(cfg, 1, 4096, dtype=torch.float32, device="cpu")
    for i, (mixer, _) in enumerate(cfg.block_pattern):
        n1 = sum(x.numel() for x in c1[f"slot{i}"].values())
        n2 = sum(x.numel() for x in c2[f"slot{i}"].values())
        assert n2 == (32 * n1 if mixer == "attn" else n1), (i, mixer)
    if arch == "xlstm-350m":
        assert tt.cache_bytes(cfg, 1, 128, torch.float32) == \
            tt.cache_bytes(cfg, 1, 4096, torch.float32)


def test_init_cache_matches_jax():
    """Every leaf's shape and dtype in bf16, and the values: zeros, the
    xLSTM stabilisers m at -1e30."""
    for arch in ARCH.values():
        jmodel = jax_get_model(arch, tiny=True)
        ref = jmodel.init_cache(2, 16, dtype=jnp.bfloat16)
        got = tt.init_cache(get_model(arch, tiny=True).cfg, 2, 16,
                            dtype=torch.bfloat16, device="cpu")
        assert sorted(got) == sorted(ref)
        for slot, leaves in ref.items():
            assert sorted(got[slot]) == sorted(leaves)
            for name, r in leaves.items():
                g = got[slot][name]
                assert (tuple(g.shape), str(g.dtype).split(".")[1]) == \
                    (r.shape, str(r.dtype)), (arch, slot, name)
                np.testing.assert_array_equal(_np(g), _np(r))


def test_mamba_conv_is_a_sum_of_taps(monkeypatch):
    """The causal conv runs as a shifted sum over the taps (prefill) and a
    dot with the window (decode), never through ``conv1d``: on the card
    cuDNN may run an f32 convolution in TF32."""
    def refuse(*args, **kwargs):
        raise AssertionError("conv1d called")
    monkeypatch.setattr(torch.nn.functional, "conv1d", refuse)
    monkeypatch.setattr(torch, "conv1d", refuse)
    out = _run_both("mamba", 12, "float32", n_decode=1)
    for what, t, j in out:
        np.testing.assert_allclose(_np(t), _np(j), rtol=TOL, atol=TOL,
                                   err_msg=what)


@pytest.mark.parametrize("mixer", MIXERS)
def test_backward_keeps_chunk_boundary_states_not_every_step(mixer):
    """Fault 3.3's repair, read through ``saved_tensors_hooks``: at S =
    1024 and 2048 the tensors of the decode state's shapes that autograd
    keeps for one layer's backward (f32, tiny widths, batch 2) are the
    carries into the S / ``SCAN_CHUNK`` chunks, one per chunk and state
    leaf (8 and 16; sLSTM's four leaves share a shape), where the loop
    without chunk checkpoints kept every step's (at least S per leaf).
    The bound: the state bytes kept are at most S / SCAN_CHUNK times the
    state's bytes; read here, 8 and 16 times them exactly: mLSTM 135,296
    and 270,592 bytes, sLSTM 8,192 and 16,384, Mamba 90,112 and 180,224,
    where the loop without chunk checkpoints kept 34.65 and 69.30 MB,
    2.88 and 5.77 MB, 8.45 and 16.91 MB (each step's state)."""
    cfg = configs.get_tiny_config(ARCH[mixer])
    p = getattr(ssm, f"init_{mixer}")(cfg, torch.Generator().manual_seed(0),
                                       None, torch.float32, "cpu")
    for s in (1024, 2048):
        x = torch.randn((2, s, cfg.d_model), requires_grad=True)
        kept = {}

        def pack(t):
            kept[t.untyped_storage()._cdata] = (tuple(t.shape),
                                               t.numel() * t.element_size())
            return t
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            y, cache = getattr(ssm, f"{mixer}_prefill")(x, p, cfg)
        # the carries as the loop holds them (Mamba's conv tail time-major)
        leaves = [tuple(v.shape) for v in cache.values()]
        if mixer == "mamba":
            leaves = [leaves[0], tuple(cache["conv"].transpose(0, 1).shape)]
        state = [kb for shape, kb in kept.values() if shape in leaves]
        n_chunks = s // ssm.SCAN_CHUNK
        assert len(state) == n_chunks * len(leaves), (s, len(state))
        state_bytes = sum(v.numel() * v.element_size()
                          for v in cache.values())
        assert sum(state) == n_chunks * state_bytes
        assert y.shape == x.shape
