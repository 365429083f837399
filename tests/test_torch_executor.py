"""The port's preemptible executor: bit-exact preempt/resume inside the
port, and tokens and checkpoint sizes equal to the JAX executor's on
bridged weights (tiny configs, f32; dense, xlstm-350m, the hybrid
jamba-1.5-large, whose cache mixes attention KV with Mamba states, the VLM
llama-3.2-vision-11b, whose cache holds static image K/V beside the
growing self-attention K/V, and the encoder-only hubert-xlarge, done after
its prefill).  The tests marked ``cuda`` replay the decode step from CUDA
graphs on the card, where JAX is not installed, against the eager step."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

try:            # the tests marked cuda run where JAX is not installed
    import jax
    import jax.numpy as jnp
    from repro.models import get_model as jax_get_model
    from repro.serving import PreemptibleExecutor as JaxExecutor
except ImportError:
    pass
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.models import get_model, transformer
from repro_torch.models.registry import build
from repro_torch.obs import host
from repro_torch.params import params_from_numpy
from repro_torch.serving import PreemptibleExecutor
from repro_torch.serving import executor as executor_mod

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
    _check_preempt_resume_between(_executor(arch))


def _check_preempt_resume_between(ex):
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


# --------------------------------------------------------------------------
# On the card: the decode step replayed from CUDA graphs
# --------------------------------------------------------------------------
def _card_executor(n_layers=3, seed=0):
    """olmo-1b at full widths and ``n_layers`` layers, bf16, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = dataclasses.replace(get_model("olmo-1b").cfg, n_layers=n_layers)
    model = build(cfg)
    return PreemptibleExecutor(model, model.init_params(
        generator=torch.Generator(device="cuda").manual_seed(seed),
        dtype=torch.bfloat16, device="cuda"))


def _decode_all(ex, prompt, n):
    """Tokens and every decode step's logits of one request, and each
    step's cache capacity."""
    st = ex.start({"tokens": prompt})
    while st.phase == "prefill":
        st = ex.step(st)
    logits, caps = [], []
    while len(st.tokens_out) < n:
        st = ex.step(st)
        logits.append(st.last_logits)
        caps.append(st.cache["slot0"]["k"].shape[2])
    return np.stack(st.tokens_out, 1), logits, caps


@pytest.mark.cuda
@pytest.mark.parametrize("deterministic", [False, True],
                         ids=["default", "deterministic"])
def test_graph_replay_equals_the_eager_step_on_card(deterministic,
                                                    monkeypatch):
    """Full-width olmo-1b (3 layers) in bf16, a 100-token prompt and 60
    tokens: the cache grows at pos 100, 125 and 156, so three graphs are
    captured; the tokens and every step's logits equal the eager run's
    bit for bit, also under deterministic algorithms (where the cache
    write's ``index_copy_`` takes another kernel), in a process of its
    own that sets cuBLAS's deterministic workspace before it starts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if deterministic and os.environ.get("CUBLAS_WORKSPACE_CONFIG") is None:
        # cuBLAS reads its workspace setting once a process
        src = os.path.join(os.path.dirname(__file__), "..", "src")
        path = os.pathsep.join(
            filter(None, [src, os.environ.get("PYTHONPATH")]))
        run = subprocess.run(
            [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
             "--noconftest",
             f"{__file__}::test_graph_replay_equals_the_eager_step_on_card"
             "[deterministic]"],
            env={**os.environ, "CUBLAS_WORKSPACE_CONFIG": ":4096:8",
                 "PYTHONPATH": path},
            capture_output=True, text=True, timeout=600)
        assert run.returncode == 0, run.stdout[-4000:] + run.stderr[-4000:]
        return
    ex = _card_executor()
    prompt = np.random.default_rng(3).integers(
        0, ex.cfg.vocab_size, (1, 100)).astype(np.int32)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(deterministic)
    try:
        with host.recording():
            host.reset()
            got = _decode_all(ex, prompt, 60)
            counts = host.counters()
            host.reset()
        monkeypatch.setattr(executor_mod, "graph_engages",
                            lambda cfg, dev: False)
        want = _decode_all(ex, prompt, 60)
    finally:
        torch.use_deterministic_algorithms(was)
    assert sorted(set(got[2])) == [125, 156, 195] and got[2] == want[2]
    assert counts["decode_graph_captures"] == 3
    assert counts["decode_graph_replays"] == 59 - 3
    assert np.array_equal(got[0], want[0])
    for step, (g, w) in enumerate(zip(got[1], want[1])):
        assert torch.equal(g, w), step


@pytest.mark.cuda
def test_preempt_resume_bit_exact_with_graphs_on_card():
    """``test_preempt_resume_bit_exact_with_another_request_between`` on
    the card: request a is preempted after its prefill and after two
    decode steps (the growth, then the capture), request b runs to its
    end between, capturing and replaying its own graph; a resumes by
    replaying its graph, to its uninterrupted run's tokens and logits."""
    ex = _card_executor()
    with host.recording():
        host.reset()
        _check_preempt_resume_between(ex)
        counts = host.counters()
        host.reset()
    # a: 2 uninterrupted runs; b: 3 runs; each captures once
    assert counts["decode_graph_captures"] == 5
    assert counts["decode_graph_replays"] == 2 * 4 + 3 * 2


@pytest.mark.cuda
def test_replays_count_their_decode_launches_on_card():
    """The decode kernel's counter counts device launches: one a layer
    and step, whether the step ran eagerly, was captured (then replayed
    once) or replayed; a capture counts its launches apart."""
    ex = _card_executor(n_layers=4)
    prompt = np.arange(1, 41, dtype=np.int32)[None]
    before = (decode_ops.launches, decode_ops.mode_launches["lse"],
              decode_ops.captured)
    with host.recording():
        host.reset()
        tokens, _, caps = _decode_all(ex, prompt, 30)
        counts = host.counters()
        host.reset()
    steps = tokens.shape[1] - 1
    assert sorted(set(caps)) == [56, 72]
    assert counts["decode_graph_captures"] == 2
    assert counts["decode_graph_replays"] == steps - 2
    assert decode_ops.launches - before[0] == 4 * steps
    assert decode_ops.mode_launches["lse"] == before[1]
    assert decode_ops.captured - before[2] == 4 * 2


@pytest.mark.cuda
def test_graph_holds_its_merge_tickets_on_card(monkeypatch):
    """Request a (batch 1) captures its graph on the decode kernel's 64
    merge tickets and is preempted after a replay.  One decode step of a
    batch-5 request needs 80 (16 KV heads a sequence), which replace the
    kernel's own; then small tensors of 7s are allocated until one takes
    the block a's tickets had, which only a freed block allows.  a
    resumes, replaying its graph, to its uninterrupted run's tokens and
    logits, and the 7s stay 7s: the graph works on the tickets it holds,
    and they are never handed on."""
    ex = _card_executor()
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, ex.cfg.vocab_size, (1, 40)).astype(np.int32)
    wide = rng.integers(0, ex.cfg.vocab_size, (5, 24)).astype(np.int32)
    want_tokens, want_logits, _ = _decode_all(ex, prompt, 8)
    monkeypatch.setattr(decode_ops, "_tickets", {})
    st = ex.start({"tokens": prompt})
    while st.phase == "prefill":
        st = ex.step(st)
    logits = []
    for _ in range(3):              # the growth, the capture, a replay
        st = ex.step(st)
        logits.append(st.last_logits)
    dev = st.graph.inputs.device
    held = (st.graph.tickets is decode_ops._tickets[dev],
            decode_ops._tickets[dev].numel())
    addr = decode_ops._tickets[dev].data_ptr()
    st = PreemptibleExecutor.checkpoint(st)
    other = ex.start({"tokens": wide})
    while other.phase == "prefill":
        other = ex.step(other)
    other = ex.step(other)
    assert decode_ops._tickets[dev].numel() == 80
    fillers = []
    while len(fillers) < 1 << 16 and (
            not fillers or fillers[-1].data_ptr() != addr):
        fillers.append(torch.full((64,), 7, dtype=torch.int32, device=dev))
    st = PreemptibleExecutor.restore(st)
    while len(st.tokens_out) < 8:
        st = ex.step(st)
        logits.append(st.last_logits)
    assert all(bool((f == 7).all()) for f in fillers)
    assert np.array_equal(np.stack(st.tokens_out, 1), want_tokens)
    for step, (g, w) in enumerate(zip(logits, want_logits)):
        assert torch.equal(g, w), step
    assert fillers[-1].data_ptr() != addr
    assert held == (True, 64)
