"""The engine's own host time per executor step in the preempt cells:
the rounds' wall minus the wall inside executor calls (start, prefill and
decode steps), over the prefill and decode steps, in ms.  It holds the
scheduler, the arbiter, the predictor, the event bus and the checkpoint's
stream sync."""


def read(w):
    inside = sum(s.t1 - s.t0 for s in w.steps)
    steps = sum(s.kind != "start" for s in w.steps)
    rounds = sum(t1 - t0 for t0, t1 in w.rounds)
    return (rounds - inside) / steps * 1e3 if steps else None
