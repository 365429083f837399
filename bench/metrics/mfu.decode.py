"""The decode step's share of the card's peak: model FLOPs of every
decode step (the architecture module's count) over their summed wall
times 989 TFLOP/s, in %."""
from bench import harness, yardstick


def read(w):
    steps = [s for s in w.steps if s.kind == "decode"]
    wall = sum(s.t1 - s.t0 for s in steps)
    if not wall:
        return None
    step_flops = harness.arch(w.cfg).step_flops
    flops = sum(w.reqs[s.rid].batch * step_flops(w.cfg, "decode", s.size)
                for s in steps)
    return flops / (wall * yardstick.PEAK_BF16_FLOPS) * 100
