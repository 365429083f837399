"""The port's preemptible executor: bit-exact preempt/resume inside the
port, and tokens and checkpoint sizes equal to the JAX executor's on
bridged weights (tiny configs, f32)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import get_model as jax_get_model
from repro.serving import PreemptibleExecutor as JaxExecutor
from repro_torch.models import get_model
from repro_torch.params import params_from_numpy
from repro_torch.serving import PreemptibleExecutor

torch.set_num_threads(2)


def _bridged(name):
    jmodel = jax_get_model(name, tiny=True)
    tree = jax.tree.map(np.asarray, jmodel.init_params(jax.random.PRNGKey(0)))
    return (JaxExecutor(jmodel, jax.tree.map(jnp.asarray, tree)),
            PreemptibleExecutor(get_model(name, tiny=True),
                                params_from_numpy(tree, "cpu")))


def test_preempt_resume_bit_exact():
    model = get_model("qwen3-8b", tiny=True)
    ex = PreemptibleExecutor(model, model.init_params(
        generator=torch.Generator().manual_seed(0), dtype=torch.float32,
        device="cpu"))
    batch = {"tokens": np.array([[5, 7, 9, 11, 2, 4, 6, 8]], np.int32)}
    ref = ex.run_uninterrupted(batch, max_new_tokens=6)
    st = ex.start(batch)
    while st.phase == "prefill":
        st = PreemptibleExecutor.restore(PreemptibleExecutor.checkpoint(ex.step(st)))
    while st.phase == "decode" and len(st.tokens_out) < 6:
        st = PreemptibleExecutor.restore(PreemptibleExecutor.checkpoint(ex.step(st)))
    assert np.array_equal(np.stack(ref.tokens_out, 1), np.stack(st.tokens_out, 1))
    assert torch.equal(ref.last_logits, st.last_logits)


@pytest.mark.parametrize("arch", ["olmo-1b", "qwen3-8b"])
def test_tokens_and_sizes_match_jax_at_every_boundary(arch):
    """20 tokens from an 8-token prompt: the KV buffers grow twice (at
    pos 8 and 24)."""
    jex, tex = _bridged(arch)
    prompt = np.random.default_rng(5).integers(1, 250, (1, 8)).astype(np.int32)
    js, ts = jex.start({"tokens": jnp.asarray(prompt)}), tex.start({"tokens": prompt})
    caps = []
    while len(ts.tokens_out) < 20:
        js, ts = jex.step(js), tex.step(ts)
        assert ts.phase == js.phase and ts.pos == js.pos
        assert ts.context_bytes() == js.context_bytes()
        assert ts.cache_bytes() == js.cache_bytes()
        if ts.phase == "decode":
            caps.append(ts.cache["slot0"]["k"].shape[2])
            np.testing.assert_allclose(ts.last_logits.numpy(),
                                       np.asarray(js.last_logits),
                                       rtol=2e-4, atol=2e-4)
    assert np.array_equal(np.stack(ts.tokens_out, 1), np.stack(js.tokens_out, 1))
    assert sorted(set(caps)) == [8, 24, 40]


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
