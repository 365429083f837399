"""Model FLOPs of every prefill and decode step of the window (frozen
formulas of yardstick.py from the configuration's sizes) over the
window's wall times 989 TFLOP/s, in %."""
from bench import yardstick


def read(w):
    layers = w.cfg["num_hidden_layers"]
    flops = 0
    for s in w.steps:
        if s.kind == "prefill":
            flops += (w.reqs[s.rid].batch
                      * yardstick.prefill_model_flops(w.cfg, s.size) / layers)
        elif s.kind == "decode":
            flops += w.reqs[s.rid].batch * yardstick.decode_model_flops(w.cfg, s.size)
    return flops / (w.wall_s * yardstick.PEAK_BF16_FLOPS) * 100
