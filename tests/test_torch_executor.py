"""The port's preemptible executor: bit-exact preempt/resume inside the
port, and tokens and checkpoint sizes equal to the JAX executor's on
bridged weights (tiny configs, f32; dense, xlstm-350m, the hybrid
jamba-1.5-large, whose cache mixes attention KV with Mamba states, the VLM
llama-3.2-vision-11b, whose cache holds static image K/V beside the
growing self-attention K/V, and the encoder-only hubert-xlarge, done after
its prefill)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import get_model as jax_get_model
from repro.serving import PreemptibleExecutor as JaxExecutor
from repro_torch.models import get_model, transformer
from repro_torch.params import params_from_numpy
from repro_torch.serving import PreemptibleExecutor

torch.set_num_threads(2)
VLM, AUDIO = "llama-3.2-vision-11b", "hubert-xlarge"


def _inputs(cfg, tokens, seed):
    """A request's batch: ``tokens`` (1, S), or frames of S positions for
    the audio model; a VLM's image embeddings from ``seed``."""
    rng = np.random.default_rng(seed)
    if cfg.embedding_inputs:
        return {"frames": rng.standard_normal(
            (1, tokens.shape[1], cfg.d_model)).astype(np.float32)}
    batch = {"tokens": tokens}
    if cfg.img_tokens:
        batch["img_embeds"] = rng.standard_normal(
            (1, cfg.img_tokens, cfg.d_vision)).astype(np.float32)
    return batch


def _bridged(name):
    jmodel = jax_get_model(name, tiny=True)
    tree = jax.tree.map(np.asarray, jmodel.init_params(jax.random.PRNGKey(0)))
    return (JaxExecutor(jmodel, jax.tree.map(jnp.asarray, tree)),
            PreemptibleExecutor(get_model(name, tiny=True),
                                params_from_numpy(tree, "cpu")))


def _executor(arch, seed=0):
    model = get_model(arch, tiny=True)
    return PreemptibleExecutor(model, model.init_params(
        generator=torch.Generator().manual_seed(seed), dtype=torch.float32,
        device="cpu"))


def test_preempt_resume_bit_exact():
    for arch in ("qwen3-8b", "xlstm-350m", "jamba-1.5-large-398b"):
        ex = _executor(arch)
        batch = {"tokens": np.array([[5, 7, 9, 11, 2, 4, 6, 8]], np.int32)}
        ref = ex.run_uninterrupted(batch, max_new_tokens=6)
        st = ex.start(batch)
        while st.phase == "prefill":
            st = PreemptibleExecutor.restore(PreemptibleExecutor.checkpoint(ex.step(st)))
        while st.phase == "decode" and len(st.tokens_out) < 6:
            st = PreemptibleExecutor.restore(PreemptibleExecutor.checkpoint(ex.step(st)))
        assert np.array_equal(np.stack(ref.tokens_out, 1),
                              np.stack(st.tokens_out, 1)), arch
        assert torch.equal(ref.last_logits, st.last_logits), arch


@pytest.mark.parametrize("arch", ["xlstm-350m", "jamba-1.5-large-398b", VLM,
                                  AUDIO])
def test_preempt_resume_bit_exact_with_another_request_between(arch):
    """A request preempted after its prefill and again after two decode
    steps, with a second request run to its end on the same executor in
    each gap, resumes to the tokens and logits of its uninterrupted run:
    the recurrent states, and a VLM's image states and K/V, it holds are
    its own.  The encoder-only model is preempted inside its prefill,
    after one period, and resumes to the logits of its uninterrupted run
    at every position."""
    ex = _executor(arch)
    cfg = ex.cfg
    a = _inputs(cfg, np.array([[5, 7, 9, 11, 2, 4, 6, 8]], np.int32), 1)
    b = _inputs(cfg, np.array([[3, 1, 4, 1, 5, 9, 2, 6, 5, 3]], np.int32), 2)
    ref_a = ex.run_uninterrupted(a, max_new_tokens=6)
    ref_b = ex.run_uninterrupted(b, max_new_tokens=4)
    st = ex.start(a)
    stops = (1,) if cfg.encoder_only else (ex.n_periods, 2)
    for n_steps in stops:
        for _ in range(n_steps):
            st = ex.step(st)
        st = PreemptibleExecutor.checkpoint(st)
        other = ex.run_uninterrupted(b, max_new_tokens=4)
        assert np.array_equal(np.stack(other.tokens_out, 1),
                              np.stack(ref_b.tokens_out, 1)) \
            if other.tokens_out else torch.equal(other.last_logits,
                                                 ref_b.last_logits)
        st = PreemptibleExecutor.restore(st)
    if cfg.encoder_only:
        assert st.phase == "prefill" and st.period_idx == 1
        while st.phase == "prefill":
            st = ex.step(st)
        assert st.phase == "done" and st.tokens_out == []
        assert st.last_logits.shape == (1, 8, cfg.vocab_size)
        assert torch.equal(ref_a.last_logits, st.last_logits)
        return
    assert st.phase == "decode" and len(st.tokens_out) == 3
    while len(st.tokens_out) < 6:
        st = ex.step(st)
    assert np.array_equal(np.stack(ref_a.tokens_out, 1),
                          np.stack(st.tokens_out, 1))
    assert torch.equal(ref_a.last_logits, st.last_logits)


def _attn_slots(cfg, mixer="attn"):
    return [f"slot{i}" for i, (m, _) in enumerate(cfg.block_pattern)
            if m == mixer]


@pytest.mark.parametrize("arch", ["olmo-1b", "qwen3-8b", "xlstm-350m",
                                  "jamba-1.5-large-398b", VLM, AUDIO])
def test_tokens_and_sizes_match_jax_at_every_boundary(arch):
    """20 tokens from an 8-token prompt: the KV buffers grow twice (at
    pos 8 and 24), the VLM's image K/V keep their img_tokens positions;
    xlstm-350m has none, and its cache keeps its size.  The encoder-only
    model is done after its n_periods prefill steps, with logits at every
    position and no token."""
    jex, tex = _bridged(arch)
    cfg = tex.cfg
    attn, cross = _attn_slots(cfg), _attn_slots(cfg, "cross_attn")
    prompt = np.random.default_rng(5).integers(1, 250, (1, 8)).astype(np.int32)
    batch = _inputs(cfg, prompt, 6)
    js = jex.start({k: jnp.asarray(v) for k, v in batch.items()})
    ts = tex.start(batch)
    caps, steps = [], 0
    while ts.phase != "done" and len(ts.tokens_out) < 20:
        js, ts = jex.step(js), tex.step(ts)
        steps += 1
        assert ts.phase == js.phase and ts.pos == js.pos
        assert ts.context_bytes() == js.context_bytes()
        assert ts.cache_bytes() == js.cache_bytes()
        if ts.phase != "prefill":
            np.testing.assert_allclose(ts.last_logits.numpy(),
                                       np.asarray(js.last_logits),
                                       rtol=2e-4, atol=2e-4)
        if ts.phase == "decode":
            caps.append(ts.cache[attn[0]]["k"].shape[2] if attn
                        else ts.cache_bytes())
            for slot in cross:
                assert ts.cache[slot]["k"].shape[2] == cfg.img_tokens
    if cfg.encoder_only:
        assert ts.phase == "done" and steps == tex.n_periods
        assert ts.tokens_out == js.tokens_out == []
        assert ts.last_logits.shape == (1, 8, cfg.vocab_size)
        return
    assert np.array_equal(np.stack(ts.tokens_out, 1), np.stack(js.tokens_out, 1))
    assert len(set(caps)) == 1 if not attn else sorted(set(caps)) == [8, 24, 40]


def test_grow_cache_keeps_contents():
    model = get_model("olmo-1b", tiny=True)
    ex = PreemptibleExecutor(model, model.init_params(
        generator=torch.Generator().manual_seed(1), dtype=torch.float32,
        device="cpu"))
    st = ex.start({"tokens": np.arange(1, 9, dtype=np.int32)[None]})
    while st.phase == "prefill":
        st = ex.step(st)
    before = {k: v.clone() for k, v in st.cache["slot0"].items()}
    ex._grow_cache(st, 16)
    for name, old in before.items():
        new = st.cache["slot0"][name]
        assert new.shape[2] == old.shape[2] + 16
        assert torch.equal(new[:, :, :8], old)
        assert not new[:, :, 8:].any()


def test_decode_past_capacity_grows_attention_only():
    """Tiny jamba and the tiny VLM: a decode at pos == capacity pads the
    self-attention slots' K/V by 16 positions, keeping their contents, and
    leaves every Mamba slot's leaves with their shapes and the values the
    step computes from them (equal to a step on a cache that was never
    grown), and the VLM's image K/V (slot 4) as they were."""
    for arch, attn in (("jamba-1.5-large-398b", ["slot4"]),
                       (VLM, ["slot0", "slot1", "slot2", "slot3"])):
        _check_decode_past_capacity(arch, attn)


def _check_decode_past_capacity(arch, attn):
    ex = _executor(arch, seed=1)
    st = ex.start(_inputs(ex.cfg, np.arange(1, 9, dtype=np.int32)[None], 3))
    while st.phase == "prefill":
        st = ex.step(st)
    assert _attn_slots(ex.cfg) == attn
    before = {slot: {k: v.clone() for k, v in leaves.items()}
              for slot, leaves in st.cache.items()}
    twin = {slot: {k: v.clone() for k, v in leaves.items()}
            for slot, leaves in st.cache.items()}
    assert st.pos == before[attn[0]]["k"].shape[2] == 8
    st = ex.step_decode(st)
    tok = torch.as_tensor(st.tokens_out[-2][:, None])
    for slot in twin:          # the same step on a cache padded by hand
        if slot in attn:
            twin[slot] = {k: torch.cat([v, v.new_zeros(v.shape[:2] + (16,)
                                                       + v.shape[3:])], 2)
                          for k, v in twin[slot].items()}
    logits, twin = transformer.decode_step(ex.params, twin, tok, 8, ex.cfg)
    assert torch.equal(logits, st.last_logits)
    for slot, leaves in before.items():
        for name, old in leaves.items():
            new = st.cache[slot][name]
            if slot in attn:
                assert new.shape[2] == old.shape[2] + 16
                assert torch.equal(new[:, :, :8], old)
                assert not new[:, :, 9:].any()
            elif slot in _attn_slots(ex.cfg, "cross_attn"):
                assert new.shape[2] == ex.cfg.img_tokens
                assert torch.equal(new, old), (slot, name)
            else:
                assert new.shape == old.shape, (slot, name)
                assert not torch.equal(new, old), (slot, name)
            assert torch.equal(new, twin[slot][name]), (slot, name)
