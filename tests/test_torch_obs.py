"""``obs/`` (a copy) on the port's ServingEngine against the reference's
``obs/`` on ``repro.serving.ServingEngine``, on the JAX package's tiny
weights bridged through ``params_from_numpy`` (f32, ``hw=TPU_V5E`` in
both): the SpanTracer's spans and Perfetto JSON, the Telemetry snapshot
and the SLOMonitor's alerts must be equal, and the two event logs must
not diverge.  The port's observers are attached by
``repro_torch.examples.quickstart.observe``; the reference's the same
way.  Also the copied ``observability_tour`` against its source."""
import contextlib
import importlib.util
import io
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro import serving as jserving
from repro.hw import TPU_V5E as JAX_TPU_V5E
from repro.models import get_model as jax_get_model
from repro_torch import serving
from repro_torch.examples import observability_tour, quickstart
from repro_torch.hw import TPU_V5E
from repro_torch.models import get_model
from repro_torch.obs import first_divergence
from repro_torch.params import params_from_numpy

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("olmo-1b", "qwen3-8b")
# preemptive traces: (policy, mechanism, arrival window, engine layout)
CASES = {"prema_dynamic": ("prema", "dynamic", 1e-5, {}),
         "prema_checkpoint": ("prema", "checkpoint", 1e-6, {}),
         "token_kill": ("token", "kill", 1e-5, {}),
         "prema_slots4": ("prema", "dynamic", 1e-5, {"batch_slots": 4})}


@pytest.fixture(scope="module")
def models():
    jm, tm = {}, {}
    for name in ARCHS:
        jmodel = jax_get_model(name, tiny=True)
        tree = jax.tree.map(np.asarray,
                            jmodel.init_params(jax.random.PRNGKey(3)))
        jm[name] = (jmodel, jax.tree.map(jax.numpy.asarray, tree))
        tm[name] = (get_model(name, tiny=True), params_from_numpy(tree, "cpu"))
    return jm, tm


def _requests(mod, window, n=8, seed=5):
    rng = np.random.default_rng(seed)
    return [mod.InferenceRequest(
        rid=i, arch=ARCHS[i % 2],
        prompt=rng.integers(1, 200, (1, int(rng.integers(4, 12)))).astype(
            np.int32),
        max_new_tokens=6, priority=int(rng.choice([1, 3, 9])),
        arrival=float(rng.uniform(0, window)),
        true_decode_len=int(rng.integers(2, 7))) for i in range(n)]


def _reference_observe(engine, reqs):
    """``quickstart.observe`` with the reference's ``obs/``."""
    tasks = [engine._make_job(r).task for r in reqs]
    iso = [t.isolated_time for t in tasks]
    kw = dict(target=0.9, window=100 * max(iso), min_samples=2,
              alert_burn=1.5, clear_burn=0.75)
    rules = [jobs.SLORule(name="sla", **kw),
             jobs.SLORule(name="ttft", metric="ttft", ttft_target=min(iso),
                          **kw)]
    return (jobs.SpanTracer().attach(engine),
            jobs.Telemetry(jobs.TelemetryConfig(window=max(iso))).attach(
                engine, tasks=tasks),
            jobs.SLOMonitor(rules).attach(engine, tasks=tasks))


@pytest.fixture(scope="module", params=list(CASES))
def observed(request, models):
    """Both engines of one case, each with its observers attached."""
    policy, mechanism, window, layout = CASES[request.param]
    jm, tm = models
    out = {}
    for key, mod, ms, hw, attach in (
            ("jax", jserving, jm, JAX_TPU_V5E, _reference_observe),
            ("torch", serving, tm, TPU_V5E, quickstart.observe)):
        eng = mod.ServingEngine(ms, cfg=mod.EngineConfig(
            hw=hw, policy=policy, mechanism=mechanism, **layout))
        reqs = _requests(mod, window)
        observers = attach(eng, reqs)
        results = eng.run(reqs)
        for o in observers:
            o.detach()
        out[key] = (eng, results, observers)
    return out


def _json(x):
    return json.dumps(x, sort_keys=True, default=str)


def test_observers_match_reference(observed, tmp_path):
    (jeng, jres, (jtr, jtel, jslo)) = observed["jax"]
    (eng, res, (tr, tel, slo)) = observed["torch"]
    assert sum(r.n_preemptions + r.n_kills for r in res) > 0
    assert sorted((r.rid, r.tokens.tolist()) for r in res) == sorted(
        (r.rid, r.tokens.tolist()) for r in jres)
    assert first_divergence(eng.events.log, jeng.events.log) is None
    assert len(eng.events.log) == len(jeng.events.log) > 0
    assert [tuple(s) for s in tr.spans] == [tuple(s) for s in jtr.spans]
    assert tr.n_events == jtr.n_events
    assert _json(tr.to_chrome()) == _json(jtr.to_chrome())
    assert (json.loads(Path(tr.export(str(tmp_path / "t.json"))).read_text())
            == json.loads(Path(jtr.export(str(tmp_path / "j.json")))
                          .read_text()))
    assert _json(tel.snapshot()) == _json(jtel.snapshot())
    assert slo.alerts == jslo.alerts
    assert _json(slo.snapshot()) == _json(jslo.snapshot())


def test_spans_close_and_never_overlap(observed):
    """On the port's engine: per device (and batch slot) run spans never
    overlap (tests/test_obs_property.py's invariant), every request's
    lifecycle closes in ``complete``, and the telemetry counts every
    request submitted and completed once."""
    eng, res, (tr, tel, slo) = observed["torch"]
    spans = tr.spans
    assert all(s.reason != "open" for s in spans)
    runs = {}
    for s in spans:
        if s.phase == "run":
            runs.setdefault((s.device, s.slot), []).append((s.t0, s.t1))
    assert runs
    for track in runs.values():
        track.sort()
        assert all(b0 >= a1 - 1e-12 for (_, a1), (b0, _) in zip(track,
                                                                track[1:]))
    last = {}
    for s in spans:
        last[s.tid] = max(last.get(s.tid, s), s, key=lambda x: x.t1)
    assert sorted(last) == sorted(r.rid for r in res)
    assert all(s.reason == "complete" for s in last.values())
    totals = tel.snapshot()["totals"]
    assert totals["submit"] == totals["complete"] == len(res)


def _reference_tour():
    spec = importlib.util.spec_from_file_location(
        "reference_observability_tour",
        ROOT / "examples" / "observability_tour.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_observability_tour_prints_reference(tmp_path, monkeypatch):
    """The copied tour prints what its source prints and writes the same
    Perfetto trace and telemetry (each run in a directory of its own)."""
    outs = {}
    for key, main in (("torch", observability_tour.main),
                      ("jax", _reference_tour().main)):
        (tmp_path / key).mkdir()
        monkeypatch.chdir(tmp_path / key)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main()
        outs[key] = buf.getvalue()
    assert outs["torch"] and outs["torch"] == outs["jax"]
    for name in ("obs_tour_trace.json", "obs_tour_telemetry.jsonl"):
        assert ((tmp_path / "torch" / name).read_text()
                == (tmp_path / "jax" / name).read_text())
