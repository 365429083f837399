"""The decode step's share of the card's peak: model FLOPs of every
decode step over their summed wall times 989 TFLOP/s, in %."""
from bench import yardstick


def read(w):
    steps = [s for s in w.steps if s.kind == "decode"]
    wall = sum(s.t1 - s.t0 for s in steps)
    if not wall:
        return None
    flops = sum(w.reqs[s.rid].batch * yardstick.decode_model_flops(w.cfg, s.size)
                for s in steps)
    return flops / (wall * yardstick.PEAK_BF16_FLOPS) * 100
