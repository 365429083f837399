"""The readers of the program's host-clock spans (``repro_torch.obs.host``)
against hand counts on a synthetic window and recorder: each clips to the
window's rounds, ``hi_ttft_gc_share`` sums each priority-9 request's
overlap with the collector's pauses, and each reads nothing from an empty
recorder or a program without one."""
import sys

import pytest

from bench import harness
import repro_torch.obs
from repro_torch.obs import host

NEW = ("decode_launch_ms", "decode_sync_ms", "kv_grow_ms_per_ktok",
       "checkpoint_ms", "gc_ms_per_s", "hi_ttft_gc_share", "gc_ms_per_s.preempt")
MS = 1_000_000      # ns


@pytest.fixture(autouse=True)
def empty_recorder():
    host.reset()
    yield
    host.reset()


def window():
    """Rounds 0-450 ms: priority-9 requests 0 (admitted 0, first token 50
    ms) and 1 (0 and 100 ms), priority-1 request 2 (0 and 200 ms) with
    three decode steps of batch 1."""
    R, S = harness.Req, harness.Step
    reqs = {0: R(0, 9, 1, 100, 1, admit=0.0, first=0.05),
            1: R(1, 9, 1, 200, 2, admit=0.0, first=0.10),
            2: R(2, 1, 1, 1000, 3, admit=0.0, first=0.20)}
    steps = [S("prefill", 2, 0.13, 0.20, 1000), S("decode", 2, 0.20, 0.30, 1001),
             S("decode", 2, 0.30, 0.40, 1002), S("decode", 2, 0.40, 0.44, 1003)]
    return harness.Window(workload="x", cfg={}, mix={}, setup_s=1.0,
                          wall_s=0.45, reqs=reqs, steps=steps,
                          rounds=[(0.0, 0.2), (0.2, 0.45)], trace=None)


def record():
    """Spans in ms; those from 450 ms on lie after the window (the check's
    pauses), one pause straddles its end."""
    for t0, t1 in ((0, 200), (200, 450)):
        host.add("engine.round", t0 * MS, t1 * MS, 1)
    host.add("exec.sample", 190 * MS, 199 * MS)        # end of a prefill
    for t0, t1, model, sample in ((200, 300, 60, 30), (300, 400, 50, 40),
                                  (400, 440, 20, 10)):
        host.add("exec.model", (t0 + 5) * MS, (t0 + 5 + model) * MS)
        host.add("exec.sample", (t1 - sample) * MS, t1 * MS)
        host.add("exec.decode", t0 * MS, t1 * MS, 1000)
    host.add("exec.grow", 201 * MS, 204 * MS, (100, 200))
    host.add("exec.grow", 460 * MS, 470 * MS, (200, 300))
    host.add("exec.model", 470 * MS, 480 * MS)
    host.add("engine.checkpoint", 120 * MS, 122 * MS, 2)
    host.add("engine.checkpoint", 300 * MS, 306 * MS, 2)
    host.add("engine.checkpoint", 500 * MS, 600 * MS, 2)
    for t0, t1 in ((40, 60), (250, 260), (440, 470), (480, 600)):
        host.add("gc", t0 * MS, t1 * MS, (2, 0))


def test_readers_against_hand_counts():
    record()
    w = window()
    read = harness.reader
    assert read("decode_launch_ms")(w) == pytest.approx((60 + 50 + 20) / 3)
    # the prefill's sample (190-199 ms) is not a decode step's
    assert read("decode_sync_ms")(w) == pytest.approx((30 + 40 + 10) / 3)
    # 3 ms of growth inside the window over 3 decode tokens
    assert read("kv_grow_ms_per_ktok")(w) == pytest.approx(3 / 3 * 1000)
    assert read("checkpoint_ms")(w) == pytest.approx((2 + 6) / 2)
    # 20 + 10 + the 10 ms of 440-470 inside the window, over 0.45 s
    assert read("gc_ms_per_s")(w) == pytest.approx(40 / 0.45)
    assert read("gc_ms_per_s.preempt")(w) == read("gc_ms_per_s")(w)
    # request 0 [0, 50] overlaps 40-60 for 10 ms, request 1 [0, 100] for 20;
    # the priority-1 request's overlap (250-260) does not count
    assert read("hi_ttft_gc_share")(w) == pytest.approx(30 / 150 * 100)


def test_overlap_arithmetic_by_hand():
    """Pauses before, across and after each interval, and one inside
    two requests' intervals at once, counted for each."""
    host.add("engine.round", 0, 450 * MS)
    for t0, t1 in ((5, 15), (30, 35), (45, 70), (90, 120)):
        host.add("gc", t0 * MS, t1 * MS, (0, 0))
    w = window()
    # request 0 [10, 50]: 5 + 5 + 5; request 1 [20, 100]: 5 + 25 + 10
    w.reqs[0].admit, w.reqs[1].admit = 0.010, 0.020
    hand = (5 + 5 + 5) + (5 + 25 + 10)
    assert harness.reader("hi_ttft_gc_share")(w) == pytest.approx(
        hand / (40 + 80) * 100)


@pytest.mark.parametrize("name", NEW)
def test_nothing_from_an_empty_recorder(name):
    assert harness.reader(name)(window()) is None
    # spans that all lie outside the window read nothing either
    host.add("engine.round", 500 * MS, 600 * MS)
    host.add("exec.decode", 500 * MS, 600 * MS, 1)
    host.add("exec.model", 510 * MS, 520 * MS)
    host.add("engine.checkpoint", 530 * MS, 540 * MS, 1)
    assert harness.reader(name)(window()) is None


@pytest.mark.parametrize("name", NEW)
def test_nothing_from_a_program_without_the_recorder(name, monkeypatch):
    record()
    monkeypatch.delattr(repro_torch.obs, "host")
    monkeypatch.setitem(sys.modules, "repro_torch.obs.host", None)
    assert harness.reader(name)(window()) is None
