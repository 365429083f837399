"""Host time growing the KV buffers (``exec.grow``: a ``torch.cat`` of
every layer's K and V when the cache is full) over the window's decode
tokens, each sequence of a batch counted, in ms per 1000 tokens.  Read
from ``repro_torch.obs.host``; nothing where it holds no decode step."""


def read(w):
    try:
        from repro_torch.obs import host
    except ImportError:          # a program without the recorder
        return None
    lo, hi = int(w.rounds[0][0] * 1e9), int(w.rounds[-1][1] * 1e9)
    tokens = sum(w.reqs[s.rid].batch for s in w.steps if s.kind == "decode")
    if not tokens or not host.spans(lo, hi, "exec.decode"):
        return None
    grow = sum(t1 - t0 for _, t0, t1, _ in host.spans(lo, hi, "exec.grow"))
    return grow / 1e6 / tokens * 1e3
