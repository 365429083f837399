"""The port's ServingEngine against ``repro.serving.ServingEngine`` on
bridged weights (tiny olmo-1b with qwen3-8b, olmo-1b with qwen3-moe as
the reference's own serving tests mix them, xlstm-350m with the hybrid
jamba-1.5-large, and the VLM llama-3.2-vision-11b with the encoder-only
hubert-xlarge on requests that carry image embeddings and frames; f32),
with ``hw=TPU_V5E`` passed to both: every request result and the summary
agree."""
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
# the reference's tiny_models (tests/test_serving.py)
MOE_ARCHS = ("olmo-1b", "qwen3-moe-30b-a3b")
# the two archs with recurrent mixers (jamba also has attention and MoE)
SSM_ARCHS = ("xlstm-350m", "jamba-1.5-large-398b")
# image and frame inputs
VLM_AUDIO_ARCHS = ("llama-3.2-vision-11b", "hubert-xlarge")


def _bridge(archs):
    jm, tm = {}, {}
    for name in archs:
        jmodel = jax_get_model(name, tiny=True)
        tree = jax.tree.map(np.asarray, jmodel.init_params(jax.random.PRNGKey(1)))
        jm[name] = (jmodel, jax.tree.map(jnp.asarray, tree))
        tm[name] = (get_model(name, tiny=True), params_from_numpy(tree, "cpu"))
    return jm, tm


@pytest.fixture(scope="module")
def models():
    return _bridge(ARCHS)


@pytest.fixture(scope="module")
def moe_models():
    return _bridge(MOE_ARCHS)


@pytest.fixture(scope="module")
def ssm_models():
    return _bridge(SSM_ARCHS)


@pytest.fixture(scope="module")
def vlm_audio_models():
    return _bridge(VLM_AUDIO_ARCHS)


def _requests(mod, seed, n=8, window=1e-4, archs=ARCHS):
    """``n`` requests alternating over ``archs``; a VLM request carries
    image embeddings and an audio one frames, drawn after its other
    fields."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        plen = int(rng.integers(4, 12))
        reqs.append(mod.InferenceRequest(
            rid=i, arch=archs[i % 2],
            prompt=rng.integers(1, 200, (1, plen)).astype(np.int32),
            max_new_tokens=6, priority=int(rng.choice([1, 3, 9])),
            arrival=float(rng.uniform(0, window)),
            true_decode_len=int(rng.integers(2, 7))))
        cfg = get_model(archs[i % 2], tiny=True).cfg
        if cfg.img_tokens:
            reqs[-1].img_embeds = rng.standard_normal(
                (1, cfg.img_tokens, cfg.d_vision)).astype(np.float32)
        if cfg.embedding_inputs:
            reqs[-1].frames = rng.standard_normal(
                (1, plen, cfg.d_model)).astype(np.float32)
    return reqs


CASES = [("prema", "dynamic", 1e-4), ("prema", "checkpoint", 1e-6),
         ("token", "kill", 1e-4)]
# the MoE mix's predicted times differ, so PREMA preempts only when its
# requests arrive closer together
MOE_CASES = [("prema", "dynamic", 1e-5), ("prema", "checkpoint", 1e-6),
             ("token", "kill", 1e-4)]
SSM_CASES = [("prema", "dynamic", 1e-5), ("prema", "checkpoint", 1e-6),
             ("token", "kill", 1e-4)]
VLM_AUDIO_CASES = [("prema", "dynamic", 1e-4), ("prema", "checkpoint", 1e-6),
                   ("token", "kill", 1e-4)]


@pytest.mark.parametrize("policy,mechanism,window", CASES)
def test_engine_matches_jax(models, policy, mechanism, window):
    _check_engines(models, policy, mechanism, window, ARCHS)


@pytest.mark.parametrize("policy,mechanism,window", MOE_CASES)
def test_engine_matches_jax_with_moe(moe_models, policy, mechanism, window):
    _check_engines(moe_models, policy, mechanism, window, MOE_ARCHS)


@pytest.mark.parametrize("policy,mechanism,window", SSM_CASES)
def test_engine_matches_jax_with_ssm(ssm_models, policy, mechanism, window):
    _check_engines(ssm_models, policy, mechanism, window, SSM_ARCHS)


@pytest.mark.parametrize("policy,mechanism,window", VLM_AUDIO_CASES)
def test_engine_matches_jax_with_vlm_audio(vlm_audio_models, policy,
                                           mechanism, window):
    """The audio requests end after their prefill with no token; the VLM
    requests decode."""
    results = _check_engines(vlm_audio_models, policy, mechanism, window,
                             VLM_AUDIO_ARCHS)
    for r in results:
        assert (r.tokens.shape[1] == 0) == (r.arch == "hubert-xlarge"), r.rid


# the batched engine loop's layouts (ROADMAP §3.2): co-resident slots,
# the same with each prompt's prefill as one monolithic step, and two
# devices as a prefill pool and a decode pool
LAYOUTS = {"slots4": dict(batch_slots=4),
           "slots4_monolithic": dict(batch_slots=4, chunked_prefill=False),
           "prefill_decode_pools": dict(n_devices=2,
                                        device_roles=["prefill", "decode"])}
# each arch mix with PREMA's preemptive case, its requests close enough
# together that every layout preempts and restores (four slots admit the
# dense and VLM/audio mixes' requests at 1e-4 apart without preempting)
MIXES = {"dense": ("models", ARCHS, ("prema", "dynamic", 1e-6)),
         "moe": ("moe_models", MOE_ARCHS, MOE_CASES[0]),
         "ssm": ("ssm_models", SSM_ARCHS, SSM_CASES[0]),
         "vlm_audio": ("vlm_audio_models", VLM_AUDIO_ARCHS,
                       ("prema", "dynamic", 1e-6))}


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("mix", MIXES)
def test_batched_engine_matches_jax(request, monkeypatch, mix, layout):
    """The batched loop with ``execute=True`` (the port's executor starts,
    restores and steps several residents per iteration) against the
    reference's on the same requests.  Every case preempts, and the
    port's engine restores an executor state at least once."""
    fixture, archs, (policy, mechanism, window) = MIXES[mix]
    restores = []
    restore = tserving.PreemptibleExecutor.restore
    monkeypatch.setattr(tserving.PreemptibleExecutor, "restore",
                        staticmethod(lambda st: restores.append(1)
                                     or restore(st)))
    _check_engines(request.getfixturevalue(fixture), policy, mechanism,
                   window, archs, **LAYOUTS[layout])
    assert restores


def _check_engines(models, policy, mechanism, window, archs, **layout):
    """Both engines on the same requests; every result and the summary
    must agree, and some request must be preempted or killed."""
    jm, tm = models
    results = {}
    engines = {}
    for key, mod, ms, hw in (("jax", jserving, jm, JAX_TPU_V5E),
                             ("torch", tserving, tm, TPU_V5E)):
        eng = mod.ServingEngine(ms, cfg=mod.EngineConfig(
            hw=hw, policy=policy, mechanism=mechanism, **layout))
        results[key] = sorted(eng.run(_requests(mod, 7, window=window,
                                                archs=archs)),
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
    return results["torch"]


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


@pytest.mark.parametrize("archs", [[], ["--archs", "qwen3-moe-30b-a3b"],
                                   ["--archs", *SSM_ARCHS]],
                         ids=["default", "moe", "ssm"])
def test_serve_launcher_runs_on_cpu(capsys, archs):
    serve.main(archs + ["--device", "cpu", "--dtype", "float32",
                        "--n-requests", "4"])
    out = capsys.readouterr().out
    assert out.startswith("4 requests | ANTT") and "preemptions" in out
