"""The plain reference against the program's model on the CPU, at the tiny
size each configuration's architecture module gives (``tiny(cfg)``), in
float32: prefill's last logits and five decode steps' logits through the
program's executor must equal the reference's full forward over the same
tokens.  And the weights and the reference's logits, now drawn and
computed through the architecture modules, bit for bit as the harness
drew and computed them before it dispatched by architecture."""
import hashlib
import json

import numpy as np
import pytest
import torch

from bench import harness, reference

BM = harness.load_benchmark()

# sha256 of every weight tensor (names, shapes, dtypes and bytes, by name)
# and of the reference's logits and its fp8 control's at every row of 24
# seeded tokens, for the tiny copies; taken from the harness before the
# architecture modules (dense only, its forward in reference.py)
FROZEN = {
    ("olmo-1b", 5): (
        "8315cee879f34dba8003b23c84e9249f83b19f717ba2848a96de757eda0503af",
        "5ed174d77790ecfa7280d7061e3ab441c4a6697ceff292372ceabec4e05ad38a"),
    ("olmo-1b", 2**40 + 7): (
        "1229da76f259063fe6128fd823259ffa22881e70d9d6de12d653af2de8e2778a",
        "867a244f1a56c7d79976c59b3c1f4aac06d0b608564091610512d6513f72504a"),
    ("qwen1.5-4b", 5): (
        "8993746001a7a04cfb8e074d2b664026e68975f99fc5abe1427c6129ca150553",
        "ff681f2f57e443a8c03e95520ff683333039d9cfeb35f37e51bf3a9010cd3f54"),
    ("qwen1.5-4b", 2**40 + 7): (
        "f71824a0be60458654d623ecc13bb9dfd5a1480558f1f774136ae246b3902cea",
        "8e65ddac9652c45cb92dc4b95de75c17a0ce62cdf46b869e524a2ce71c8ac776"),
}


def tiny(name):
    conf = next(c for c in BM["configs"] if c["name"] == name)
    cfg = json.loads((harness.REPO / conf["file"]).read_text())
    assert cfg["source"] == conf["source"]
    return dict(cfg, **harness.arch(cfg).tiny(cfg))


def digest(tensors):
    h = hashlib.sha256()
    for k in sorted(tensors):
        t = tensors[k].detach().contiguous().cpu()
        h.update(f"{k}{tuple(t.shape)}{t.dtype}".encode())
        h.update(t.numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name", [c["name"] for c in BM["configs"]])
def test_reference_equals_program(name):
    from repro_torch.serving import PreemptibleExecutor
    cfg = tiny(name)
    vocab = cfg["vocab_size"]
    w = harness.draw_weights(cfg, 2**40 + 7, "cpu")
    ex = PreemptibleExecutor(harness.build_model(cfg), harness.port_params(cfg, w))
    prompt = np.random.default_rng(3).integers(0, vocab, (1, 12)).astype(np.int32)
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


@pytest.mark.parametrize("name,seed", sorted(FROZEN), ids=str)
def test_weights_and_reference_as_before(name, seed):
    cfg = tiny(name)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        w = harness.draw_weights(cfg, seed, "cpu")
        seq = torch.as_tensor(np.random.default_rng(3).integers(0, 256, 24))
        logits = {"ref": reference.logits_at(cfg, w, seq, range(24)),
                  "fp8": reference.logits_at(cfg, w, seq, range(24), fp8=True)}
    finally:
        torch.set_num_threads(threads)
    assert (digest(w), digest(logits)) == FROZEN[name, seed]


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
