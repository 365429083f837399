"""The decode kernel's share of its bound over the window: the sum of each
launch's bound (bytes-bound: K and V of the context, the query and the
output) over the kernels' device time in the trace, in %.  One launch per
attention layer and decode step; where the trace does not hold that many
decode kernels, nothing is read."""
from bench import harness, yardstick


def read(w):
    if w.trace is None:
        return None
    sec, launches = w.trace.kernels("decode_split_kernel")
    cfg = w.cfg
    mod = harness.arch(cfg)
    hq, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    dh, layers = mod.head_dim(cfg), mod.attention_layers(cfg)
    ctx = [(s.size, w.reqs[s.rid].batch) for s in w.trace.traced(w.steps)
           if s.kind == "decode"]
    if not launches or launches != layers * len(ctx):
        return None
    bound = layers * sum(
        yardstick.bound_s(yardstick.decode_attn_ops(t, hq, dh, b),
                          yardstick.decode_attn_bytes(t, hq, hkv, dh, b))
        for t, b in ctx)
    return bound / sec * 100
