"""All decode wall (first token to last, each request) over all decode
tokens of the window, in ms: a mean over tokens, not a median of gaps."""


def read(w):
    runs = [r for r in w.reqs.values() if r.done is not None and r.n_tokens > 1]
    tokens = sum(r.n_tokens - 1 for r in runs)
    if not tokens:
        return None
    return sum(r.last - r.first for r in runs) / tokens * 1e3
