"""A whole run on the CPU at a tiny size (the look for a card skipped),
with the timed path broken underneath: ``correct`` has to come out false
for each fault a serving cell can have, and true without one.  (Half of
a batch left out and the exchange between chips do not apply: every
request here is one sequence, on one chip.)"""
import pytest

from bench import harness

TINY = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=4, vocab_size=256)


def token_altered(monkeypatch):
    """Every seventh token the executor produces is replaced by the next
    id."""
    from repro_torch.serving import executor
    greedy, calls = executor._greedy, [0]

    def altered(logits):
        tok = greedy(logits)
        calls[0] += 1
        return (tok + 1) % TINY["vocab_size"] if calls[0] % 7 == 0 else tok
    monkeypatch.setattr(executor, "_greedy", altered)


def decode_unchanged(monkeypatch):
    """A decode step that returns its state as it came."""
    from repro_torch.serving import PreemptibleExecutor
    monkeypatch.setattr(PreemptibleExecutor, "step_decode", lambda self, st: st)


def layer_dropped(monkeypatch):
    """The first prefill period's output is dropped: the step hands on the
    hidden state it was given."""
    from repro_torch.serving import PreemptibleExecutor
    step = PreemptibleExecutor.step_prefill

    def dropped(self, st):
        h = st.h
        st = step(self, st)
        if st.period_idx == 1 and st.phase == "prefill":
            st.h = h
        return st
    monkeypatch.setattr(PreemptibleExecutor, "step_prefill", dropped)


@pytest.mark.parametrize("fault,correct", [(None, True), (token_altered, False),
                                           (decode_unchanged, False),
                                           (layer_dropped, False)])
def test_fault_fails_the_check(monkeypatch, fault, correct):
    bm = harness.load_benchmark()
    spec = harness.resolve(bm, "olmo-1b.preempt")
    spec["cfg"] = dict(spec["cfg"], **TINY)
    if fault is not None:
        fault(monkeypatch)
    line = harness.run_cell("olmo-1b.preempt", 2**35 + 1, 0.0, False,
                            harness.now(), device="cpu", spec=spec, bm=bm)
    assert line["correct"] is correct, line["compared"]
    assert list(line)[-1] == "compared"
