"""The prefill's share of the card's peak: model FLOPs of the prompts of
requests not preempted in their prefill (a whole prompt: the
architecture's periods times one prefill step's count) over their wall
from ``start`` to first token times 989 TFLOP/s, in %."""
from bench import harness, yardstick


def read(w):
    runs = [r for r in w.reqs.values()
            if r.first is not None and not r.preempted_in_prefill]
    wall = sum(r.first - r.start for r in runs)
    if not wall:
        return None
    mod = harness.arch(w.cfg)
    flops = sum(r.batch * mod.periods(w.cfg)
                * mod.step_flops(w.cfg, "prefill", r.prompt_len) for r in runs)
    return flops / (wall * yardstick.PEAK_BF16_FLOPS) * 100
