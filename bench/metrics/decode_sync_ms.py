"""Mean host time per decode step inside ``exec.sample`` (the argmax and
its copy to the host, the step's one sync: how long the host waits for
the device), over the window's decode steps, in ms; the samples at the
end of a prefill are left out.  Read from ``repro_torch.obs.host``;
nothing where it holds no decode step."""
import bisect


def read(w):
    try:
        from repro_torch.obs import host
    except ImportError:          # a program without the recorder
        return None
    lo, hi = int(w.rounds[0][0] * 1e9), int(w.rounds[-1][1] * 1e9)
    steps = sorted((t0, t1) for _, t0, t1, _ in host.spans(lo, hi, "exec.decode"))
    if not steps:
        return None
    starts = [t0 for t0, _ in steps]
    waited = 0
    for _, t0, t1, _ in host.spans(lo, hi, "exec.sample"):
        i = bisect.bisect_right(starts, t0) - 1
        if i >= 0 and t1 <= steps[i][1]:
            waited += t1 - t0
    return waited / len(steps) / 1e6
