"""The port's examples (``repro_torch.examples``) against the reference's
(``examples/*.py``, loaded from their files) on the CPU.

The three serving examples run on the JAX package's tiny weights bridged
through ``params_from_numpy``, f32, with ``hw=TPU_V5E`` passed to the
port (the reference engine's default hardware model; the port's is the
H100): every request result, ``summary()`` and what they print must be
equal.  The five examples that compute with no framework are copies and
must print the reference's output.
"""
import contextlib
import dataclasses
import importlib.util
import io
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.models import get_model as jax_get_model
from repro_torch.examples import (multi_npu_cluster, multi_tenant_serving,
                                  quickstart)
from repro_torch.hw import TPU_V5E
from repro_torch.models import get_model
from repro_torch.params import params_from_numpy

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
# the copied examples, each printing what its source prints
COPIED = ("chaos_recovery", "closed_loop_admission", "elastic_autoscale",
          "traffic_load_sweep")
# the multi-tenant trace's length: the reference's 16 requests take about
# a minute here, 10 keep two preemptions under PREMA
N_TENANT_REQUESTS = 10


def _reference(name):
    """``examples/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _recording(mod, monkeypatch):
    """Replace ``mod.ServingEngine`` by a subclass that records every
    engine it makes; returns the list."""
    made = []

    class Recorded(mod.ServingEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)
    monkeypatch.setattr(mod, "ServingEngine", Recorded)
    return made


def _printed(fn, *a, **kw):
    """(what ``fn`` returns, what it prints)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*a, **kw)
    return out, buf.getvalue()


def _bridged(archs):
    """The JAX package's tiny weights of ``archs`` from PRNGKey(0), as the
    reference examples draw them (one key for every model), on the
    port's models."""
    key = jax.random.PRNGKey(0)
    out = {}
    for name in archs:
        tree = jax.tree.map(np.asarray,
                            jax_get_model(name, tiny=True).init_params(key))
        out[name] = (get_model(name, tiny=True),
                     params_from_numpy(tree, "cpu"))
    return out


def _check_same(port_engine, ref_engine, n):
    """Every result of the two engines and their summaries are equal."""
    got = sorted(port_engine.completed, key=lambda r: r.rid)
    ref = sorted(ref_engine.completed, key=lambda r: r.rid)
    assert len(got) == len(ref) == n
    for a, b in zip(got, ref):
        da, db = dataclasses.asdict(a), dataclasses.asdict(b)
        assert np.array_equal(da.pop("tokens"), db.pop("tokens")), a.rid
        assert da == db, a.rid
        assert a.ntt == b.ntt
    assert port_engine.summary() == ref_engine.summary()


@pytest.fixture(scope="module")
def dense_models():
    return _bridged(quickstart.ARCHS)


def test_quickstart_matches_reference(dense_models, monkeypatch):
    """The port's quickstart on the reference's weights and hardware model
    serves its 8 requests as the reference's ``main`` does, and prints the
    same table and summary."""
    ref = _reference("quickstart")
    made = _recording(ref, monkeypatch)
    _, ref_out = _printed(ref.main)
    (engine, results), out = _printed(
        quickstart.run, dense_models, quickstart.make_requests(),
        hw=TPU_V5E)
    assert len(results) == 8
    assert sum(r.n_preemptions + r.n_kills for r in results) > 0
    _check_same(engine, made[0], 8)
    assert out == ref_out


def test_simulate_cluster_prints_reference():
    ref = _reference("multi_npu_cluster")
    assert (_printed(multi_npu_cluster.simulate_cluster)[1]
            == _printed(ref.simulate_cluster)[1])


def test_two_device_engine_matches_reference(dense_models, monkeypatch):
    """The 2-device engine (both devices on the CPU, sharing its tensors)
    places, serves and prints as the reference's, on quickstart's
    requests, whose tokens it leaves as quickstart's single device does."""
    ref = _reference("multi_npu_cluster")
    made = _recording(ref, monkeypatch)
    _, ref_out = _printed(ref.serve_on_two_devices)
    (engine, results), out = _printed(
        multi_npu_cluster.serve_on_two_devices, dense_models, hw=TPU_V5E)
    _check_same(engine, made[0], 8)
    assert out == ref_out
    assert [t.device for t in engine.tasks] == [t.device
                                               for t in made[0].tasks]
    assert len({t.device for t in engine.tasks}) == 2
    one, _ = _printed(quickstart.run, dense_models,
                      quickstart.make_requests(), hw=TPU_V5E)[0]
    single = {r.rid: r.tokens for r in one.completed}
    assert all(np.array_equal(r.tokens, single[r.rid]) for r in results)


@pytest.fixture(scope="module")
def tenant_run():
    """Both packages' NP-FCFS and PREMA engines on the same multi-tenant
    trace, and what the port printed."""
    ref = _reference("multi_tenant_serving")
    jm = ref.build_models(jax.random.PRNGKey(0))
    tm = _bridged(multi_tenant_serving.ARCHS)
    reqs = multi_tenant_serving.make_trace(
        tm, np.random.default_rng(7), n=N_TENANT_REQUESTS)
    ref_reqs = ref.make_trace(jm, np.random.default_rng(7),
                              n=N_TENANT_REQUESTS)
    engines, out = _printed(multi_tenant_serving.compare, tm, reqs,
                            hw=TPU_V5E)
    ref_engines = (ref.run(jm, ref_reqs, "fcfs", False, "drain"),
                   ref.run(jm, ref_reqs, "prema", True, "dynamic"))
    return dict(zip(("fcfs", "prema"), zip(engines, ref_engines))), out, \
        (reqs, ref_reqs)


@pytest.mark.parametrize("policy", ["fcfs", "prema"])
def test_multi_tenant_matches_reference(tenant_run, policy):
    """Each scheduler's engine on the four tiny archs (dense, MoE, xLSTM,
    the VLM with image embeddings) equals the reference's."""
    engines, _, _ = tenant_run
    port, ref = engines[policy]
    _check_same(port, ref, N_TENANT_REQUESTS)
    if policy == "prema":
        assert port.summary()["preemptions"] > 0


def test_multi_tenant_trace_is_the_reference_trace(tenant_run):
    _, _, (reqs, ref_reqs) = tenant_run
    for a, b in zip(reqs, ref_reqs):
        da, db = dataclasses.asdict(a), dataclasses.asdict(b)
        for k in ("prompt", "img_embeds"):
            x, y = da.pop(k), db.pop(k)
            assert (x is None and y is None) or np.array_equal(x, y)
        assert da == db


def test_multi_tenant_tokens_identical_across_schedulers(tenant_run):
    """The example's own check: preemption never changes tokens."""
    _, out, _ = tenant_run
    assert "token outputs identical across schedulers: OK" in out
    assert "preemptions under PREMA: 0," not in out


@pytest.mark.parametrize("name", COPIED)
def test_copied_example_prints_reference(name):
    """A copied example's ``main`` prints what its source's prints."""
    port = importlib.import_module(f"repro_torch.examples.{name}")
    out = _printed(port.main)[1]
    assert out and out == _printed(_reference(name).main)[1]


def test_serving_examples_run_on_the_card_by_default():
    """Without ``--device`` the examples ask for ``cuda``; where there is
    no card that is an error, not the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for main in (quickstart.main, multi_npu_cluster.main,
                 multi_tenant_serving.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _printed(main, [])
