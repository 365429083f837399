"""The paper's average normalized turnaround on the host's clock: the mean
over finished requests of (completion - admission) / own service, where
own service is the wall of the request's own executor calls plus that of
its own checkpoints (preempt event to the next executor call or
dispatch)."""
from bench import yardstick


def read(w):
    done = [r for r in w.reqs.values() if r.done is not None and r.own > 0]
    if not done:
        return None
    return yardstick.antt([r.done - r.admit for r in done],
                          [r.own for r in done])
