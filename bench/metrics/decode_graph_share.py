"""Share of the window's decode steps (the program's spans ``exec.decode``)
whose model ran from a CUDA graph, captured or replayed (an
``exec.capture`` or ``exec.replay`` span inside the step), in %.  Read
from ``repro_torch.obs.host``; nothing where the window holds no decode
step, or where the recorder holds no graph span at all (a program that
replays no graph)."""
import bisect

GRAPH_SPANS = ("exec.capture", "exec.replay")


def read(w):
    try:
        from repro_torch.obs import host
    except ImportError:          # a program without the recorder
        return None
    if not any(host.spans(name=name) for name in GRAPH_SPANS):
        return None
    lo, hi = int(w.rounds[0][0] * 1e9), int(w.rounds[-1][1] * 1e9)
    steps = sorted((t0, t1) for _, t0, t1, _ in host.spans(lo, hi, "exec.decode"))
    if not steps:
        return None
    starts = [t0 for t0, _ in steps]
    graphed = set()
    for name in GRAPH_SPANS:
        for _, t0, t1, _ in host.spans(lo, hi, name):
            i = bisect.bisect_right(starts, t0) - 1
            if i >= 0 and t1 <= steps[i][1]:
                graphed.add(i)
    return len(graphed) / len(steps) * 100
