"""90th percentile, over every priority-9 request of the window, of its
normalized time to first token: first token minus admission over the
request's own time up to its first token (its ``start`` and prefill calls
and any checkpoint charged to it), both on the host's clock.  PREMA's
normalized turnaround (Eq. 1) taken to the first token: the wait behind
other requests' work, in units of the request's own service."""
from bench import yardstick


def read(w):
    ratio = [(r.first - r.admit) / r.own_first for r in w.reqs.values()
             if r.priority == 9 and r.first is not None and r.own_first]
    return yardstick.percentile(ratio, 90) if ratio else None
