"""Every token the window's finished requests were served, each sequence
of a batch counted, over the window's wall."""


def read(w):
    tokens = sum(r.n_tokens * r.batch for r in w.reqs.values()
                 if r.done is not None)
    return tokens / w.wall_s
