"""Python's garbage collector: its pauses (``gc`` spans) inside the window,
cut at its ends, in ms per second of window.  Read from
``repro_torch.obs.host``; nothing where it recorded no engine round in
the window."""


def read(w):
    try:
        from repro_torch.obs import host
    except ImportError:          # a program without the recorder
        return None
    lo, hi = int(w.rounds[0][0] * 1e9), int(w.rounds[-1][1] * 1e9)
    if not host.spans(lo, hi, "engine.round"):
        return None
    paused = sum(min(t1, hi) - max(t0, lo)
                 for _, t0, t1, _ in host.spans(lo, hi, "gc"))
    return paused / 1e6 / ((hi - lo) / 1e9)
