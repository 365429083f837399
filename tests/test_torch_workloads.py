"""The port's copy of ``workloads/`` against ``repro.workloads``: the same
seeded serving trace replays to the same results through both
``ServingEngine``s (virtual time, then tiny olmo-1b executing on the CPU
on bridged weights), and a paper trace through both ``NPUSimulator``s."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import serving as jserving
from repro import workloads as jworkloads
from repro.core import trace as jtrace
from repro.core.predictor import Predictor as JPredictor
from repro.core.scheduler import make_policy as jmake_policy
from repro.core.simulator import NPUSimulator as JNPUSimulator
from repro.core.simulator import SimConfig as JSimConfig
from repro.hw import PAPER_NPU as J_PAPER_NPU
from repro.hw import TPU_V5E as J_TPU_V5E
from repro.models import get_model as jax_get_model
from repro_torch import serving as tserving
from repro_torch import workloads as tworkloads
from repro_torch.configs import paper_workloads as tpw
from repro_torch.core.predictor import LengthRegressor, Predictor
from repro_torch.core.scheduler import make_policy
from repro_torch.core.simulator import NPUSimulator, SimConfig
from repro_torch.hw import PAPER_NPU, TPU_V5E
from repro_torch.models import get_model
from repro_torch.params import params_from_numpy

torch.set_num_threads(2)
ARCH = "olmo-1b"


def _serving_trace(wl, seed=9, n=10):
    """The mix of ``tests/test_batching.py::_serving_trace``."""
    mix = wl.TrafficMix(tenants=(
        wl.TenantSpec(name="chat", models=(ARCH,), batch=1,
                      prompt_len_range=(4, 10), decode_len_range=(2, 5),
                      max_new_tokens=6, sla_scale=6.0),),
        arrivals=wl.Poisson(rate=5000.0), kind="serving")
    return wl.generate(mix, np.random.default_rng(seed), n)


@pytest.fixture(scope="module")
def models():
    jmodel = jax_get_model(ARCH, tiny=True)
    tree = jax.tree.map(np.asarray, jmodel.init_params(jax.random.PRNGKey(0)))
    return ({ARCH: (jmodel, jax.tree.map(jax.numpy.asarray, tree))},
            {ARCH: (get_model(ARCH, tiny=True),
                    params_from_numpy(tree, "cpu"))})


def test_generate_matches_reference():
    jt, tt = _serving_trace(jworkloads), _serving_trace(tworkloads)
    assert len(tt.records) == 10
    assert ([dataclasses.asdict(r) for r in tt.records]
            == [dataclasses.asdict(r) for r in jt.records])
    assert tt.kind == jt.kind == "serving"


@pytest.mark.parametrize("execute", [False, True])
def test_engine_replays_trace_like_reference(models, execute):
    jm, tm = models
    out = {}
    for key, mod, wl, ms, hw in (("jax", jserving, jworkloads, jm, J_TPU_V5E),
                                 ("torch", tserving, tworkloads, tm, TPU_V5E)):
        eng = mod.ServingEngine(ms, cfg=mod.EngineConfig(
            hw=hw, policy="prema", mechanism="dynamic", execute=execute))
        res = sorted(eng.run(_serving_trace(wl)), key=lambda r: r.rid)
        out[key] = (res, eng.summary())
    (rt, st), (rj, sj) = out["torch"], out["jax"]
    assert len(rt) == len(rj) == 10
    for a, b in zip(rt, rj):
        assert (a.rid, a.arch, a.tenant, a.priority) == (b.rid, b.arch,
                                                         b.tenant, b.priority)
        assert np.array_equal(a.tokens, b.tokens), a.rid
        assert (a.arrival, a.first_token_time, a.completion, a.isolated_time,
                a.ckpt_overhead, a.sla_target) == (
            b.arrival, b.first_token_time, b.completion, b.isolated_time,
            b.ckpt_overhead, b.sla_target)
        assert (a.n_preemptions, a.n_kills, a.n_decoded) == (
            b.n_preemptions, b.n_kills, b.n_decoded)
    if execute:
        assert all(r.tokens.shape[1] > 0 for r in rt)
    assert st == sj


def test_simulator_replays_paper_trace_like_reference():
    jpred = JPredictor(J_PAPER_NPU)
    jtrace.build_regressors(jpred, np.random.default_rng(1234))
    pred = Predictor(PAPER_NPU)   # the same fit, through the port's copies
    rng = np.random.default_rng(1234)
    for name in ("RNN-MT1", "RNN-MT2", "RNN-ASR"):
        pred.register_regressor(
            name, LengthRegressor().fit(tpw.profile_length_pairs(name, rng)))

    def run(wl, sim, p):
        tr = wl.generate(wl.paper_mix(arrivals=wl.Poisson(rate=150.0)),
                         np.random.default_rng(21), 12, pred=p)
        return sorted((t.tid, t.model, t.completion, t.n_preemptions,
                       t.n_kills) for t in sim.run(tr))
    ref = run(jworkloads, JNPUSimulator(J_PAPER_NPU, jmake_policy("prema", True),
                                        JSimConfig(mechanism="dynamic")), jpred)
    got = run(tworkloads, NPUSimulator(PAPER_NPU, make_policy("prema", True),
                                       SimConfig(mechanism="dynamic")), pred)
    assert len(got) == 12
    assert got == ref
