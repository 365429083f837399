"""The port's ServingEngine against ``repro.serving.ServingEngine`` on
bridged weights (tiny olmo-1b and qwen3-8b, f32), with ``hw=TPU_V5E``
passed to both: every request result and the summary agree."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import serving as jserving
from repro.hw import TPU_V5E as JAX_TPU_V5E
from repro.models import get_model as jax_get_model
from repro_torch import serving as tserving
from repro_torch.hw import TPU_V5E
from repro_torch.launch import serve
from repro_torch.models import get_model
from repro_torch.params import params_from_numpy

torch.set_num_threads(2)
ARCHS = ("olmo-1b", "qwen3-8b")


@pytest.fixture(scope="module")
def models():
    jm, tm = {}, {}
    for name in ARCHS:
        jmodel = jax_get_model(name, tiny=True)
        tree = jax.tree.map(np.asarray, jmodel.init_params(jax.random.PRNGKey(1)))
        jm[name] = (jmodel, jax.tree.map(jnp.asarray, tree))
        tm[name] = (get_model(name, tiny=True), params_from_numpy(tree, "cpu"))
    return jm, tm


def _requests(mod, seed, n=8, window=1e-4):
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        plen = int(rng.integers(4, 12))
        reqs.append(mod.InferenceRequest(
            rid=i, arch=ARCHS[i % 2],
            prompt=rng.integers(1, 200, (1, plen)).astype(np.int32),
            max_new_tokens=6, priority=int(rng.choice([1, 3, 9])),
            arrival=float(rng.uniform(0, window)),
            true_decode_len=int(rng.integers(2, 7))))
    return reqs


@pytest.mark.parametrize("policy,mechanism,window", [
    ("prema", "dynamic", 1e-4), ("prema", "checkpoint", 1e-6),
    ("token", "kill", 1e-4)])
def test_engine_matches_jax(models, policy, mechanism, window):
    jm, tm = models
    results = {}
    engines = {}
    for key, mod, ms, hw in (("jax", jserving, jm, JAX_TPU_V5E),
                             ("torch", tserving, tm, TPU_V5E)):
        eng = mod.ServingEngine(ms, cfg=mod.EngineConfig(
            hw=hw, policy=policy, mechanism=mechanism))
        results[key] = sorted(eng.run(_requests(mod, 7, window=window)),
                              key=lambda r: r.rid)
        engines[key] = eng
    assert len(results["torch"]) == len(results["jax"]) == 8
    assert sum(r.n_preemptions + r.n_kills for r in results["torch"]) > 0
    for rt, rj in zip(results["torch"], results["jax"]):
        assert rt.rid == rj.rid
        assert np.array_equal(rt.tokens, rj.tokens), rt.rid
        assert rt.ntt == rj.ntt
        assert (rt.n_preemptions, rt.n_kills) == (rj.n_preemptions, rj.n_kills)
        assert rt.ckpt_overhead == rj.ckpt_overhead
    assert engines["torch"].summary() == engines["jax"].summary()


def test_contention_never_changes_tokens(models):
    _, tm = models
    reqs = _requests(tserving, 11, n=10, window=1e-6)
    eng = tserving.ServingEngine(tm, cfg=tserving.EngineConfig(
        policy="prema", mechanism="dynamic"))
    results = eng.run(reqs)
    assert len(results) == 10
    for r in results:
        req = next(q for q in reqs if q.rid == r.rid)
        ex = tserving.PreemptibleExecutor(*tm[r.arch])
        iso = ex.run_uninterrupted({"tokens": req.prompt},
                                   max_new_tokens=r.tokens.shape[1])
        assert np.array_equal(np.stack(iso.tokens_out[:r.tokens.shape[1]], 1),
                              r.tokens), r.rid


def test_engine_defaults_to_h100():
    from repro_torch.hw import H100
    assert tserving.EngineConfig().hw is H100


def test_serve_launcher_runs_on_cpu(capsys):
    serve.main(["--device", "cpu", "--dtype", "float32", "--n-requests", "4"])
    out = capsys.readouterr().out
    assert out.startswith("4 requests | ANTT") and "preemptions" in out
