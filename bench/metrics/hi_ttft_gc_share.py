"""Share of the priority-9 requests' time to first token spent in Python's
garbage collector: for each such request the ``gc`` spans' overlap with
its admission-to-first-token interval (the clock of ``hi_ttft_p90_ms``),
summed, over the sum of those intervals, in %.  Read from
``repro_torch.obs.host``; nothing where it recorded no engine round in
the window."""
import bisect


def read(w):
    try:
        from repro_torch.obs import host
    except ImportError:          # a program without the recorder
        return None
    lo, hi = int(w.rounds[0][0] * 1e9), int(w.rounds[-1][1] * 1e9)
    ttft = [(int(r.admit * 1e9), int(r.first * 1e9)) for r in w.reqs.values()
            if r.priority == 9 and r.first is not None and r.admit is not None]
    if not ttft or not host.spans(lo, hi, "engine.round"):
        return None
    pauses = sorted((t0, t1) for _, t0, t1, _ in host.spans(lo, hi, "gc"))
    starts = [t0 for t0, _ in pauses]
    overlap = 0
    for a, b in ttft:
        # pauses do not overlap one another: start at the last one that
        # begins by ``a``
        for t0, t1 in pauses[max(bisect.bisect_right(starts, a) - 1, 0):]:
            if t0 >= b:
                break
            overlap += max(0, min(b, t1) - max(a, t0))
    return overlap / sum(b - a for a, b in ttft) * 100
