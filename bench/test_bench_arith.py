"""The benchmark's arithmetic against hand counts: percentiles, ANTT, the
kernels' and the model's operation and byte counts, the readers, the
traffic generator and the reading of a device trace."""
import types

import numpy as np
import pytest
import torch

from bench import harness, traffic, yardstick

CFG = dict(hidden_size=8, intermediate_size=16, num_hidden_layers=2,
           num_attention_heads=2, num_key_value_heads=2, vocab_size=10)


def test_percentile_and_antt():
    assert yardstick.percentile(range(1, 11), 90) == pytest.approx(9.1)
    assert yardstick.percentile([5.0], 90) == 5.0
    assert yardstick.antt([2.0, 3.0], [1.0, 3.0]) == pytest.approx(1.5)


def test_kernel_counts():
    # S 4 causal: 10 kept pairs; 2 heads of width 8: 4 * 2 * 8 * 10
    assert yardstick.flash_ops(4, 2, 8) == 640
    # Q, K, V, O: 4 * S 4 * 2 heads * 8 * 2 bytes
    assert yardstick.flash_bytes(4, 2, 2, 8) == 512
    assert yardstick.decode_attn_ops(5, 2, 8) == 4 * 2 * 8 * 5
    # K and V: 2 * 5 positions * 2 heads * 8; q and o: 2 * 2 * 8; 2 bytes
    assert yardstick.decode_attn_bytes(5, 2, 2, 8) == 2 * (160 + 32)
    assert yardstick.bound_s(989e12, 0) == pytest.approx(1.0)
    assert yardstick.bound_s(0, 3.35e12) == pytest.approx(1.0)


def test_model_flops():
    # per layer: Q K V O 4 * 8 * 8 = 256, SwiGLU 3 * 8 * 16 = 384
    assert yardstick.layer_matmul_params(CFG) == 640
    s = 3
    hand = 2 * s * 2 * 640 + 2 * yardstick.flash_ops(s, 2, 4) + 2 * 8 * 10
    assert yardstick.prefill_model_flops(CFG, s) == hand
    t = 7
    hand = 2 * 2 * 640 + 2 * 4 * 2 * 4 * t + 2 * 8 * 10
    assert yardstick.decode_model_flops(CFG, t) == hand


def window(trace=None):
    R, S = harness.Req, harness.Step
    reqs = {0: R(0, 9, 1, 100, 1, admit=0.0, start=0.01, first=0.05, last=0.05,
                 done=0.06, own=0.05, own_first=0.04, n_tokens=1),
            1: R(1, 9, 1, 200, 2, admit=0.0, start=0.06, first=0.10, last=0.12,
                 done=0.13, own=0.06, own_first=0.04, n_tokens=2, preemptions=1),
            2: R(2, 1, 1, 1000, 3, admit=0.0, start=0.13, first=0.20, last=0.40,
                 done=0.41, own=0.28, n_tokens=3, preempted_in_prefill=True)}
    steps = [S("start", 0, 0.01, 0.02, 100), S("prefill", 0, 0.02, 0.05, 100),
             S("decode", 1, 0.10, 0.12, 201), S("prefill", 2, 0.13, 0.20, 1000),
             S("decode", 2, 0.20, 0.30, 1001), S("decode", 2, 0.30, 0.40, 1002)]
    return harness.Window(workload="x", cfg=CFG, mix={}, setup_s=3.0,
                          wall_s=0.5, reqs=reqs, steps=steps,
                          rounds=[(0.0, 0.45)], trace=trace)


def test_readers():
    w = window()
    read = harness.reader
    assert read("hi_ttft_p90_ms.preempt")(w) == pytest.approx(
        yardstick.percentile([50.0, 100.0], 90))
    # first token minus admission over own time to it: 0.05 / 0.04, 0.10 / 0.04
    assert read("hi_nttft_p90")(w) == pytest.approx(
        yardstick.percentile([1.25, 2.5], 90))
    assert read("tokens_per_s")(w) == pytest.approx(6 / 0.5)
    # decode wall: request 1 0.02 s over 1 token, request 2 0.2 s over 2
    assert read("tpot_ms")(w) == pytest.approx(0.22 / 3 * 1e3)
    assert read("preemptions_per_hi")(w) == pytest.approx(0.5)
    # requests 0 and 1 (2 was preempted in its prefill): 0.04 + 0.04 s, 300 tokens
    assert read("prefill_ms_per_ktok")(w) == pytest.approx(0.08 / 300 * 1e6)
    assert read("decode_step_ms")(w) == pytest.approx(0.22 / 3 * 1e3)
    inside = 0.01 + 0.03 + 0.02 + 0.07 + 0.1 + 0.1
    assert read("engine_host_ms.preempt")(w) == pytest.approx((0.45 - inside) / 5 * 1e3)
    assert read("setup_s")(w) == 3.0
    flops = (yardstick.prefill_model_flops(CFG, 100) / 2
             + yardstick.prefill_model_flops(CFG, 1000) / 2
             + sum(yardstick.decode_model_flops(CFG, t) for t in (201, 1001, 1002)))
    assert read("mfu")(w) == pytest.approx(flops / (0.5 * 989e12) * 100)
    for name in ("flash_roofline", "decode_attn_roofline", "device_idle_share",
                 "device_idle_share.preempt"):
        assert read(name)(w) is None
    # the preempt cell's copies read as their originals
    for name in ("tokens_per_s", "mfu"):
        assert read(f"{name}.preempt")(w) == read(name)(w)


def test_nttft_without_a_first_token():
    """Requests with no first token, or of priority 1, are left out; a
    window with none left reads nothing."""
    w = window()
    for r in w.reqs.values():
        if r.rid != 2:
            r.first = r.own_first = None
    assert harness.reader("hi_nttft_p90")(w) is None
    assert harness.reader("hi_ttft_p90_ms.preempt")(w) is None


def test_cycle_summary():
    """The engine's summary on its virtual clock: each key's mean over the
    first cycle of rounds, or over all rounds where a window holds fewer."""
    virtual = [{"antt": 1.2, "stp": 2.0}, {"antt": 1.5, "stp": 4.0},
               {"antt": 9.0, "stp": 0.0}]
    assert harness.cycle_summary(virtual, {"cycle_rounds": 2}) == pytest.approx(
        {"antt": 1.35, "stp": 3.0})
    assert harness.cycle_summary(virtual, {"cycle_rounds": 11}) == pytest.approx(
        {"antt": 11.7 / 3, "stp": 2.0})
    assert harness.cycle_summary(virtual, {}) == pytest.approx(
        {"antt": 11.7 / 3, "stp": 2.0})


def test_rooflines_from_a_trace():
    kern = {"flash_fwd_wgmma_kernel<4>": [2e-6, 2], "decode_split_kernel": [1e-5, 6]}
    w = window(harness.Trace(by_name=kern, busy_s=0.1, window_s=0.4, gaps=[]))
    bound = sum(yardstick.bound_s(yardstick.flash_ops(s, 2, 4),
                                  yardstick.flash_bytes(s, 2, 2, 4)) for s in (100, 1000))
    assert harness.reader("flash_roofline")(w) == pytest.approx(bound / 2e-6 * 100)
    bound = 2 * sum(yardstick.bound_s(yardstick.decode_attn_ops(t, 2, 4),
                                      yardstick.decode_attn_bytes(t, 2, 2, 4))
                    for t in (201, 1001, 1002))
    assert harness.reader("decode_attn_roofline")(w) == pytest.approx(bound / 1e-5 * 100)
    assert harness.reader("device_idle_share")(w) == pytest.approx(75.0)
    assert harness.reader("device_idle_share.preempt")(w) == pytest.approx(75.0)
    # a launch count that is not one per layer and step reads nothing
    kern["decode_split_kernel"][1] = 5
    assert harness.reader("decode_attn_roofline")(w) is None


class _Event:
    def __init__(self, name, s, e):
        self._v = (name, s, e)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def device_type(self):
        return torch.autograd.DeviceType.CUDA


def test_read_trace():
    """Device clock = host clock + 1000 ns.  Marks at 0 and 10,000; kernels
    [2000, 3000], [2500, 4000], [7000, 8000]: busy 3000 ns, gaps 2000 (host
    in a decode step), 3000 (host in the engine) and 1000."""
    ev = [_Event("spin_kernel", 1000, 1100), _Event("a", 2000, 3000),
          _Event("b", 2500, 4000), _Event("a", 7000, 8000),
          _Event("spin_kernel", 9000, 9100)]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: ev)))
    steps = [harness.Step("decode", 0, 100e-9, 1900e-9, 10)]
    tr = harness.read_trace(prof, (0, 8000), steps)
    assert tr.busy_s == pytest.approx(3000e-9)
    assert tr.window_s == pytest.approx(7900e-9)
    assert tr.by_name == {"a": [pytest.approx(2000e-9), 2],
                          "b": [pytest.approx(1500e-9), 1]}
    labels = {round(g * 1e9): lab for g, lab, _ in tr.gaps}
    assert labels == {900: "host in decode", 3000: "host in engine",
                      1000: "host in engine"}
    bd = harness.breakdown(tr)
    assert bd["device_ops"][0] == ["a", pytest.approx(2000e-9)]
    assert len(bd["idle_gaps"]) <= 10
    assert tr.traced(steps) == steps


def test_read_trace_without_its_end():
    """The profiler dropped everything after 5000 ns, the second mark
    with it: the window ends at the last decode step the trace holds
    (host 3500 ns, device 4500), and the later step is not covered."""
    ev = [_Event("spin_kernel", 1000, 1100), _Event("a", 2000, 3000),
          _Event("b", 3500, 4400), _Event("a", 4600, 5000)]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: ev)))
    steps = [harness.Step("decode", 0, 1000e-9, 3500e-9, 10),
             harness.Step("decode", 0, 3600e-9, 6000e-9, 11)]
    tr = harness.read_trace(prof, (0, None), steps)
    assert tr.window_s == pytest.approx(3400e-9)
    assert tr.busy_s == pytest.approx(1900e-9)
    assert tr.by_name == {"a": [pytest.approx(1000e-9), 1],
                          "b": [pytest.approx(900e-9), 1]}
    assert tr.traced(steps) == steps[:1]
    with pytest.raises(RuntimeError):
        harness.read_trace(types.SimpleNamespace(profiler=types.SimpleNamespace(
            kineto_results=types.SimpleNamespace(events=lambda: ev[1:]))), (0, None), steps)


def test_traffic_is_the_same_work_in_another_order():
    mix = traffic.load_mix("preempt")
    a, b = traffic.block(mix, 0), traffic.block(mix, 1)

    def key(x):
        return sorted((s["priority"], s["prompt_len"], s["output_len"]) for s in x)
    assert key(a) == key(b) and a != b
    counts = [s["priority"] for s in a]
    assert counts.count(9) == 18 and counts.count(1) == 2
    assert all(64 <= s["prompt_len"] <= 512 for s in a if s["priority"] == 9)
    cell = {"mean_gap_s": 0.01, "cycle_rounds": 3}

    def sizes(reqs):
        return [(q["prompt"].shape[1], q["max_new_tokens"], q["arrival"]) for q in reqs]
    s7 = [traffic.round_requests(mix, cell, 7, r, 100) for r in range(3)]
    s8 = [traffic.round_requests(mix, cell, 2**40 + 8, r, 100) for r in range(3)]
    assert [q["rid"] for q in s7[0] + s7[1]] == list(range(40))
    # a whole cycle holds the same rounds for every seed, in another order
    assert sorted(map(sizes, s7)) == sorted(map(sizes, s8))
    assert list(map(sizes, s7)) != list(map(sizes, s8))
    # without a seeded start every seed runs the stream from its first round
    first = dict(cell, seeded_start=False)
    f7 = [traffic.round_requests(mix, first, 7, r, 100) for r in range(4)]
    f8 = [traffic.round_requests(mix, first, 2**40 + 8, r, 100) for r in range(4)]
    assert list(map(sizes, f7)) == list(map(sizes, f8))
    assert sizes(f7[3]) == sizes(f7[0]) != sizes(f7[1])
    assert sorted(map(sizes, f7[:3])) == sorted(map(sizes, s7))
    assert not np.array_equal(f7[0][0]["prompt"], f8[0][0]["prompt"])
    assert not np.array_equal(s7[0][0]["prompt"], s8[2][0]["prompt"])
    gaps = np.diff([0.0] + [q["arrival"] for q in s7[0]])
    assert gaps.mean() == pytest.approx(0.01)
    again = traffic.round_requests(mix, cell, 7, 0, 100)
    assert all(np.array_equal(x["prompt"], y["prompt"]) for x, y in zip(s7[0], again))
    dec = traffic.load_mix("decode")
    rounds = [traffic.round_requests(dec, {"cycle_rounds": 4}, 3, r, 100)[0]
              for r in range(4)]
    assert sorted(q["max_new_tokens"] for q in rounds) == [144, 176, 208, 240]
    assert all(q["arrival"] == 0.0 for q in rounds)
    with pytest.raises(ValueError):
        traffic.round_requests(dec, {"cycle_rounds": 3}, 3, 0, 100)
