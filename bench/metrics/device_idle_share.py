"""Share of the traced window in which no operation ran on the device
(``torch.profiler``'s CUDA activity), in %."""


def read(w):
    if w.trace is None:
        return None
    return (1.0 - w.trace.busy_s / w.trace.window_s) * 100
