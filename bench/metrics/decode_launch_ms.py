"""Mean host time of the model call in a decode step (the program's span
``exec.model``: ``transformer.decode_step``, which issues every layer's
kernels and returns without waiting for the device), over the window's
decode steps, in ms.  Read from the program's host-clock recorder
(``repro_torch.obs.host``, on while the profiler runs); nothing where it
holds no decode step."""


def read(w):
    try:
        from repro_torch.obs import host
    except ImportError:          # a program without the recorder
        return None
    lo, hi = int(w.rounds[0][0] * 1e9), int(w.rounds[-1][1] * 1e9)
    model = [t1 - t0 for _, t0, t1, _ in host.spans(lo, hi, "exec.model")]
    return sum(model) / len(model) / 1e6 if model else None
