"""The flash kernel's share of its bound over the window: the sum of each
launch's bound (max of operations over 989 TFLOP/s and bytes over
3.35 TB/s, from the prompt it ran on) over the kernels' device time in
the trace, in %.  As many launches a prefill step as the architecture has
attention layers in a period; where the trace holds no flash kernel, or
not that many, nothing is read."""
from bench import harness, yardstick


def read(w):
    if w.trace is None:
        return None
    sec, launches = w.trace.kernels("flash_fwd_")
    cfg = w.cfg
    mod = harness.arch(cfg)
    hq, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    dh, per = mod.head_dim(cfg), mod.attention_per_period(cfg)
    sizes = [(s.size, w.reqs[s.rid].batch) for s in w.trace.traced(w.steps)
             if s.kind == "prefill"]
    if not launches or launches != per * len(sizes):
        return None
    bound = per * sum(yardstick.bound_s(yardstick.flash_ops(s, hq, dh, b),
                                        yardstick.flash_bytes(s, hq, hkv, dh, b))
                      for s, b in sizes)
    return bound / sec * 100
