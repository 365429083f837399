"""``obs.host``, the port's host-clock spans and counters, on tiny olmo-1b
(f32, CPU) through ``ServingEngine.run``: a priority-1 request that PREMA
checkpoints twice for three priority-9 ones.  Off by default; on under
``torch.profiler`` or ``host.recording()``; every span nests in its
parent, each ``exec.decode`` lies inside a ``time.perf_counter`` wrapper
of ``step_decode`` set as an instance attribute (the clock the benchmark
reads), and recording changes no served token."""
import contextlib
import gc
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.models import get_model
from repro_torch.obs import host
from repro_torch.serving import EngineConfig, InferenceRequest, ServingEngine

torch.set_num_threads(2)
SPANS = {"engine.round", "engine.pick", "engine.checkpoint", "engine.restore",
         "engine.complete", "exec.start", "exec.prefill", "exec.decode",
         "exec.grow", "exec.h2d", "exec.model", "exec.sample", "block",
         "block.mixer", "block.ffn", "attn.kernel", "gc"}
COUNTERS = {"kv_grows", "kv_grow_bytes", "host_syncs", "gc_collections"}
# each span's possible parents
PARENTS = {"engine.pick": ("engine.round",), "engine.checkpoint": ("engine.round",),
           "engine.restore": ("engine.round",), "engine.complete": ("engine.round",),
           "exec.start": ("engine.round",), "exec.prefill": ("engine.round",),
           "exec.decode": ("engine.round",), "exec.grow": ("exec.decode",),
           "exec.h2d": ("exec.decode",), "exec.model": ("exec.decode",),
           "exec.sample": ("exec.decode", "exec.prefill"),
           "block": ("exec.model", "exec.prefill"), "block.mixer": ("block",),
           "block.ffn": ("block",), "attn.kernel": ("block.mixer",)}


@pytest.fixture(scope="module")
def model():
    m = get_model("olmo-1b", tiny=True)
    return m, m.init_params(generator=torch.Generator().manual_seed(0),
                            dtype=torch.float32, device="cpu")


@pytest.fixture(autouse=True)
def fresh_recorder():
    host.disable()
    host.reset()
    yield
    host.disable()
    host.reset()


def _requests(name):
    rng = np.random.default_rng(0)
    reqs = [InferenceRequest(rid=0, arch=name, priority=1, arrival=0.0,
                             prompt=rng.integers(1, 200, (1, 40)).astype(np.int32),
                             max_new_tokens=24)]
    return reqs + [InferenceRequest(rid=i, arch=name, priority=9, arrival=1e-6 * i,
                                    prompt=rng.integers(1, 200, (1, 8)).astype(np.int32),
                                    max_new_tokens=2) for i in (1, 2, 3)]


def _engine(model):
    return ServingEngine({model[0].cfg.name: model},
                         cfg=EngineConfig(policy="prema", mechanism="checkpoint"))


def _serve(model, collect=False):
    """The run's results by rid, and its decode steps' wrapper intervals
    (``time.perf_counter``, as the benchmark's harness wraps them).  With
    ``collect``, each completion runs a full collection."""
    engine = _engine(model)
    walls = []
    for ex in engine._executors.values():
        decode = ex.step_decode

        def timed(st, decode=decode):
            t0 = time.perf_counter()
            st = decode(st)
            walls.append((t0, time.perf_counter()))
            return st
        ex.step_decode = timed
    if collect:
        engine.events.subscribe("complete", lambda ev: gc.collect())
    results = {r.rid: r.tokens for r in engine.run(_requests(model[0].cfg.name))}
    return results, walls


def _profiled(model):
    with profile(activities=[ProfilerActivity.CPU]):
        return _serve(model, collect=True)


def test_off_records_nothing_and_registers_no_callback(model):
    seen = []
    engine = _engine(model)
    engine.events.subscribe("dispatch",
                            lambda ev: seen.append(host._on_gc in gc.callbacks))
    engine.run(_requests(model[0].cfg.name))
    assert seen and not any(seen)
    assert not host.ON and host._on_gc not in gc.callbacks
    assert host.summary() == {} and host.counters() == {} and host.spans() == []


def test_profiler_records_every_span_and_counter(model):
    _profiled(model)
    assert set(host.summary()) == SPANS
    assert set(host.counters()) == COUNTERS
    c = host.counters()
    assert c["host_syncs"] == host.summary()["exec.sample"]["count"]
    assert c["kv_grows"] == host.summary()["exec.grow"]["count"]
    assert c["kv_grow_bytes"] == sum(after - before for _, _, _, (before, after)
                                     in host.spans(name="exec.grow"))
    # the next run without a profiler turns it off again
    n = len(host.spans())
    _serve(model)
    assert not host.ON and host._on_gc not in gc.callbacks
    assert len(host.spans()) == n


def test_children_nest_inside_their_parents(model):
    _profiled(model)
    by_name = {}
    for name, t0, t1, attrs in host.spans():
        by_name.setdefault(name, []).append((t0, t1, attrs))
    for child, parents in PARENTS.items():
        outer = [(t0, t1) for p in parents for t0, t1, _ in by_name[p]]
        for t0, t1, _ in by_name[child]:
            assert any(p0 <= t0 and t1 <= p1 for p0, p1 in outer), child
    layers = model[0].cfg.n_layers
    for t0, t1, _ in by_name["exec.model"]:
        inside = [a for b0, b1, a in by_name["block"] if t0 <= b0 and b1 <= t1]
        assert inside == [(i, "attn") for i in range(layers)]


def test_one_decode_span_per_step_inside_the_wrapper(model):
    _, walls = _profiled(model)
    decode = sorted((t0, t1, pos) for _, t0, t1, pos in host.spans(name="exec.decode"))
    assert len(decode) == len(walls) > 0
    for (w0, w1), (t0, t1, _) in zip(sorted(walls), decode):
        assert w0 * 1e9 <= t0 <= t1 <= w1 * 1e9
    # the attribute is the context length: three priority-9 requests decode
    # once after 8 prompt tokens, the priority-1 one 23 times after 40
    assert sorted(pos for _, _, pos in decode) == [8] * 3 + list(range(40, 63))


def test_served_tokens_are_bit_identical_with_recording_on(model):
    off, _ = _serve(model)
    with host.recording():
        on, _ = _serve(model)
    assert host.summary()["exec.decode"]["count"] > 0
    assert off.keys() == on.keys()
    for rid in off:
        np.testing.assert_array_equal(off[rid], on[rid])


def test_aggregates_stay_exact_past_the_raw_bound(model, monkeypatch):
    with host.recording():
        _serve(model)
    whole = {k: v["count"] for k, v in host.summary().items() if k != "gc"}
    host.reset()
    monkeypatch.setattr(host, "RAW_LIMIT", 50)
    with host.recording():
        _serve(model)
    bounded = host.summary()
    assert {k: bounded[k]["count"] for k in whole} == whole
    assert len(host.spans()) == 50
    assert host.dropped() == sum(v["count"] for v in bounded.values()) - 50
    host.reset()
    for d in (3, 1, 4, 1, 5, 9, 2, 6):
        host.add("x", 100, 100 + d)
    assert host.summary()["x"] == {"count": 8, "total_ms": 31e-6,
                                   "mean_us": 31 / 8 / 1e3, "max_us": 9e-3}
    assert host.dropped() == 0 and len(host.spans()) == 8
    host.reset()
    assert host.dropped() == 0 and host.summary() == {}


def test_spans_in_an_interval():
    with host.recording():
        host.add("a", 10, 20)
        host.add("b", 15, 40, 7)
        host.add("a", 50, 60)
        host.count("n", 2)
        host.count("n")
    assert [s[0] for s in host.spans(21, 49)] == ["b"]
    assert host.spans(20, 50, "a") == [("a", 10, 20, None), ("a", 50, 60, None)]
    assert host.spans(61) == [] and len(host.spans(None, 15)) == 2
    assert host.counters() == {"n": 3}


def test_a_forced_collection_is_one_gc_span():
    auto = gc.isenabled()
    gc.disable()
    try:
        with host.recording():
            assert host._on_gc in gc.callbacks
            gc.collect()
        assert host._on_gc not in gc.callbacks
        gc.collect()
    finally:
        if auto:
            gc.enable()
    (span,) = host.spans(name="gc")
    assert span[3][0] == 2 and span[2] > span[1]
    assert host.counters() == {"gc_collections": 1}


def test_switch_and_profiler_combine():
    with host.recording():
        with host.recording():
            assert host.ON
        assert host.ON
    assert not host.ON
    with contextlib.ExitStack() as stack:
        stack.enter_context(profile(activities=[ProfilerActivity.CPU]))
        assert host.arm()
        host.enable()
        host.disable()
        assert host.ON
    assert not host.arm() and host._on_gc not in gc.callbacks
