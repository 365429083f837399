"""The plain reference against the program's model on the CPU, at tiny
sizes of both configurations, in float32: prefill's last logits and five
decode steps' logits through the program's executor must equal the
reference's full forward over the same tokens."""
import numpy as np
import pytest
import torch

from bench import harness, reference

TINY = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=4, vocab_size=256,
            serve_dtype="float32")


def tiny(name):
    bm = harness.load_benchmark()
    conf = next(c for c in bm["configs"] if c["name"] == name)
    spec = harness.resolve(bm, next(w["name"] for w in bm["workloads"]
                                    if w["config"] == name))
    assert spec["cfg"]["source"] == conf["source"]
    return dict(spec["cfg"], **TINY)


@pytest.mark.parametrize("name", ["olmo-1b", "qwen1.5-4b"])
def test_reference_equals_program(name):
    from repro_torch.serving import PreemptibleExecutor
    cfg = tiny(name)
    w = harness.draw_weights(cfg, 2**40 + 7, "cpu")
    ex = PreemptibleExecutor(harness.build_model(cfg), harness.port_params(w))
    prompt = np.random.default_rng(3).integers(0, 256, (1, 12)).astype(np.int32)
    st = ex.start({"tokens": prompt})
    while st.phase == "prefill":
        st = ex.step_prefill(st)
    got = [st.last_logits[0, -1].float()]
    for _ in range(5):
        st = ex.step_decode(st)
        got.append(st.last_logits[0, -1].float())
    served = np.stack(st.tokens_out, 1)[0]
    seq = torch.cat([torch.as_tensor(prompt[0]), torch.as_tensor(served[:-1])])
    ref = reference.logits_at(cfg, w, seq, range(11, 17))
    torch.testing.assert_close(torch.stack(got), ref, atol=1e-4, rtol=1e-4)
    # greedy tokens sit at gap 0 wherever the reference's top two differ
    gap = reference.gaps(ref, torch.as_tensor(served))
    assert float(gap.max()) < 1e-4


def test_rope_theta_and_bias_matter():
    """The reference reads the configuration's RoPE base and biases: the
    same weights under another base or without biases give other logits."""
    cfg = tiny("qwen1.5-4b")
    w = harness.draw_weights(cfg, 5, "cpu")
    seq = torch.arange(40) % 256
    base = reference.logits_at(cfg, w, seq, [39])
    other = reference.logits_at(dict(cfg, rope_theta=10000.0), w, seq, [39])
    unbiased = {k: v for k, v in w.items() if k not in ("bq", "bk", "bv")}
    nobias = reference.logits_at(cfg, unbiased, seq, [39])
    assert float((base - other).abs().max()) > 1e-3
    assert float((base - nobias).abs().max()) > 1e-3
