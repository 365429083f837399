"""The port's building blocks against ``repro.models.layers`` on the same
inputs (made with numpy), in f32 at 1e-5."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfgs
from repro.models import layers as jl
from repro_torch import configs as tcfgs
from repro_torch.models import layers as tl

torch.set_num_threads(2)
TOL = 1e-5


def _close(t_out, j_out, tol=TOL):
    np.testing.assert_allclose(t_out.detach().numpy(), np.asarray(j_out),
                               rtol=tol, atol=tol)


def _cfgs(name="qwen3-8b", **over):
    return (dataclasses.replace(jcfgs.get_tiny_config(name), **over),
            dataclasses.replace(tcfgs.get_tiny_config(name), **over))


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm", "layernorm_np"])
def test_apply_norm(norm):
    rng = np.random.default_rng(0)
    jc, tc = _cfgs(norm=norm)
    x = rng.standard_normal((2, 5, jc.d_model)).astype(np.float32) * 3 + 1
    p = {}
    if norm != "layernorm_np":
        p["scale"] = rng.standard_normal(jc.d_model).astype(np.float32)
    if norm == "layernorm":
        p["bias"] = rng.standard_normal(jc.d_model).astype(np.float32)
    out_j = jl.apply_norm(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}, jc)
    out_t = tl.apply_norm(torch.from_numpy(x),
                          {k: torch.from_numpy(v) for k, v in p.items()}, tc)
    _close(out_t, out_j)


def test_rms_norm_head():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    _close(tl.rms_norm_head(torch.from_numpy(x), torch.from_numpy(scale)),
           jl.rms_norm_head(jnp.asarray(x), jnp.asarray(scale)))


@pytest.mark.parametrize("theta", [1e4, 1e6])
@pytest.mark.parametrize("per_batch", [False, True])
def test_rope(theta, per_batch):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    pos = (rng.integers(0, 3000, (2, 7)) if per_batch
           else np.arange(7)[None]).astype(np.int32)
    _close(tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
           jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp(act):
    rng = np.random.default_rng(3)
    jc, tc = _cfgs(mlp_act=act)
    d, f = jc.d_model, jc.d_ff
    x = rng.standard_normal((2, 5, d)).astype(np.float32)
    p = {"w_in": rng.standard_normal((d, f)).astype(np.float32) * d ** -0.5,
         "w_out": rng.standard_normal((f, d)).astype(np.float32) * f ** -0.5}
    if act == "silu":
        p["w_gate"] = rng.standard_normal((d, f)).astype(np.float32) * d ** -0.5
    _close(tl.apply_mlp(torch.from_numpy(x),
                        {k: torch.from_numpy(v) for k, v in p.items()}, tc),
           jl.apply_mlp(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}, jc))


@pytest.mark.parametrize("tied", [True, False])
def test_embed_and_unembed(tied):
    rng = np.random.default_rng(4)
    jc, tc = _cfgs(tie_embeddings=tied)
    v, d = jc.vocab_size, jc.d_model
    params = {"embed": {"table": rng.standard_normal((v, d)).astype(np.float32)}}
    if not tied:
        params["lm_head"] = {"w": rng.standard_normal((d, v)).astype(np.float32)}
    tokens = rng.integers(0, v, (2, 6)).astype(np.int32)
    jp = {k: {n: jnp.asarray(a) for n, a in sub.items()} for k, sub in params.items()}
    tp = {k: {n: torch.from_numpy(a) for n, a in sub.items()} for k, sub in params.items()}
    h_j = jl.embed_tokens(jnp.asarray(tokens), jp["embed"])
    h_t = tl.embed_tokens(torch.from_numpy(tokens), tp["embed"])
    _close(h_t, h_j, tol=0)
    _close(tl.unembed(h_t, tp, tc), jl.unembed(h_j, jp, jc))
