"""Wall from ``start`` to the first token of the requests not preempted in
their prefill, over their prompt tokens, in ms per 1000 tokens."""


def read(w):
    runs = [r for r in w.reqs.values()
            if r.first is not None and not r.preempted_in_prefill]
    tokens = sum(r.prompt_len * r.batch for r in runs)
    if not tokens:
        return None
    return sum(r.first - r.start for r in runs) / tokens * 1e6
