"""The prefill's share of the card's peak: model FLOPs of the prompts of
requests not preempted in their prefill over their wall from ``start`` to
first token times 989 TFLOP/s, in %."""
from bench import yardstick


def read(w):
    runs = [r for r in w.reqs.values()
            if r.first is not None and not r.preempted_in_prefill]
    wall = sum(r.first - r.start for r in runs)
    if not wall:
        return None
    flops = sum(r.batch * yardstick.prefill_model_flops(w.cfg, r.prompt_len)
                for r in runs)
    return flops / (wall * yardstick.PEAK_BF16_FLOPS) * 100
