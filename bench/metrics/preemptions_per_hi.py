"""Preemptions (checkpoints and kills) over priority-9 requests: a count
that shows PREMA's preempt and restore ran."""


def read(w):
    hi = sum(r.priority == 9 for r in w.reqs.values())
    return sum(r.preemptions for r in w.reqs.values()) / hi if hi else None
