"""Model FLOPs of every prefill and decode step of the window (the
configuration's architecture module counts one step, by the frozen
formulas of yardstick.py, from its sizes) over the window's wall times
989 TFLOP/s, in %."""
from bench import harness, yardstick


def read(w):
    step_flops = harness.arch(w.cfg).step_flops
    flops = 0
    for s in w.steps:
        if s.kind in ("prefill", "decode"):
            flops += w.reqs[s.rid].batch * step_flops(w.cfg, s.kind, s.size)
    return flops / (w.wall_s * yardstick.PEAK_BF16_FLOPS) * 100
