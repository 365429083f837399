"""90th percentile, over every priority-9 request of the window, of its
first token's host time minus its admission (its ``submit`` event), in ms.
Per layer in ``olmo-1b.preempt``: on the host's clock it moves with the
host's speed by more than any bound holds (PERF.md section 2)."""
from bench import yardstick


def read(w):
    ttft = [(r.first - r.admit) * 1e3 for r in w.reqs.values()
            if r.priority == 9 and r.first is not None]
    return yardstick.percentile(ttft, 90) if ttft else None
