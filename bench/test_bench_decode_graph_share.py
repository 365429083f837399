"""``decode_graph_share`` against hand counts on synthetic spans: the
share of the window's decode steps holding a graph's capture or replay,
and nothing from a recorder without decode steps or graph spans (a
program that replays no graph) or from a program without the recorder."""
import sys

import pytest

from bench import harness
import repro_torch.obs
from repro_torch.obs import host

MS = 1_000_000      # ns


@pytest.fixture(autouse=True)
def empty_recorder():
    host.reset()
    yield
    host.reset()


def window():
    """Rounds 0-500 ms, one request of batch 1."""
    R, S = harness.Req, harness.Step
    return harness.Window(workload="x", cfg={}, mix={}, setup_s=1.0,
                          wall_s=0.5, reqs={0: R(0, 3, 1, 100, 6)},
                          steps=[S("decode", 0, 0.1, 0.2, 100)],
                          rounds=[(0.0, 0.25), (0.25, 0.5)], trace=None)


def record(graphs=True):
    """Five decode steps of 100-500 ms; the first eager, the second
    captured and replayed, the third and fourth replayed, the fifth eager
    again (a growth); a replay outside the window (in the check) and a
    capture between two steps belong to no step of it."""
    for t0 in (0, 100, 200, 300, 400):
        host.add("exec.decode", (t0 + 1) * MS, (t0 + 90) * MS, t0)
        host.add("exec.model", (t0 + 10) * MS, (t0 + 50) * MS)
    if not graphs:
        return
    host.add("exec.capture", 110 * MS, 130 * MS)
    for t0 in (100, 200, 300):
        host.add("exec.replay", (t0 + 30) * MS, (t0 + 40) * MS)
    host.add("exec.capture", 392 * MS, 398 * MS)
    host.add("exec.replay", 600 * MS, 610 * MS)


def test_share_by_hand():
    record()
    assert harness.reader("decode_graph_share")(window()) == pytest.approx(
        3 / 5 * 100)


def test_a_window_of_replays_alone_reads_100():
    for t0 in (0, 100):
        host.add("exec.decode", t0 * MS, (t0 + 50) * MS, t0)
        host.add("exec.replay", (t0 + 10) * MS, (t0 + 20) * MS)
    assert harness.reader("decode_graph_share")(window()) == 100.0


@pytest.mark.parametrize("graphs", [False, True], ids=["no_graph_span",
                                                        "no_decode_step"])
def test_nothing_to_read(graphs):
    if graphs:
        host.add("exec.replay", 600 * MS, 610 * MS)   # after the window
    else:
        record(graphs=False)
    assert harness.reader("decode_graph_share")(window()) is None


def test_nothing_from_a_program_without_the_recorder(monkeypatch):
    record()
    monkeypatch.delattr(repro_torch.obs, "host")
    monkeypatch.setitem(sys.modules, "repro_torch.obs.host", None)
    assert harness.reader("decode_graph_share")(window()) is None
