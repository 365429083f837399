"""The decode step's device position and the executor's CUDA graphs, on
the CPU: ``transformer.decode_step`` with a 0-dim int32 ``pos`` gives the
logits and cache of the host-int step bit for bit (tiny dense decoders,
f32 and bf16, across a growth of the cache); which models and contexts
the graphs engage on; when a step is captured, replayed or run eagerly,
through the executor with a stand-in graph that reruns the captured
function at each replay (its outputs rewritten in place, as a CUDA
graph's are).  The graphs themselves run in ``test_torch_executor.py``'s
tests marked ``cuda``."""
import types

import numpy as np
import pytest
import torch

from repro_torch.distributed.context import ShardCtx, use_ctx
from repro_torch.models import get_model, transformer
from repro_torch.obs import host
from repro_torch.serving import PreemptibleExecutor
from repro_torch.serving import executor as executor_mod

torch.set_num_threads(2)
DENSE = ("olmo-1b", "qwen3-8b", "qwen1.5-4b")
PROMPT = np.array([[5, 7, 9, 11, 2, 4, 6, 8]], np.int32)


def _executor(arch, dtype=torch.float32, seed=0):
    model = get_model(arch, tiny=True)
    return PreemptibleExecutor(model, model.init_params(
        generator=torch.Generator().manual_seed(seed), dtype=dtype,
        device="cpu"))


def _prefilled(ex, prompt=PROMPT):
    st = ex.start({"tokens": prompt})
    while st.phase == "prefill":
        st = ex.step_prefill(st)
    return st


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("arch", DENSE)
@torch.inference_mode()
def test_device_pos_step_is_bit_identical(arch, dtype):
    """Seven steps from an 8-token prompt, the cache grown by 16 at pos 8
    for both: every step's logits and, at the end, every cache leaf equal
    the host-int step's bit for bit."""
    ex = _executor(arch, dtype)
    host_st, dev_st = _prefilled(ex), _prefilled(ex)
    tok = torch.as_tensor(host_st.tokens_out[-1][:, None])
    for pos in range(8, 15):
        if pos == 8:
            ex._grow_cache(host_st, 16)
            ex._grow_cache(dev_st, 16)
        want, host_st.cache = transformer.decode_step(
            ex.params, host_st.cache, tok, pos, ex.cfg)
        got, dev_st.cache = transformer.decode_step(
            ex.params, dev_st.cache, tok,
            torch.tensor(pos, dtype=torch.int32), ex.cfg)
        assert got.dtype == want.dtype == dtype
        assert torch.equal(got, want), pos
        tok = torch.argmax(want[:, -1], dim=-1).to(torch.int32)[:, None]
    for slot, leaves in host_st.cache.items():
        for name, want in leaves.items():
            assert want.shape[2] == 24
            assert torch.equal(dev_st.cache[slot][name], want), (slot, name)


def _serving_ctx():
    """A serving context whose rules split the cache's positions over
    'model', on a stand-in mesh of one process (no process group)."""
    dm = types.SimpleNamespace(get_coordinate=lambda: [0], size=lambda i: 1)
    mesh = types.SimpleNamespace(axis_names=("model",), device_mesh=dm)
    return ShardCtx(mesh, {"kv_seq": "model"}, serve=True)


@torch.inference_mode()
def test_device_pos_raises_under_a_kv_seq_split():
    ex = _executor("olmo-1b")
    st = _prefilled(ex)
    tok = torch.as_tensor(st.tokens_out[-1][:, None])
    ctx = _serving_ctx()
    with use_ctx(ctx):
        assert ctx.shard_split("kv_seq") is not None
        with pytest.raises(ValueError, match="kv_seq"):
            transformer.decode_step(ex.params, st.cache, tok,
                                    torch.tensor(7, dtype=torch.int32),
                                    ex.cfg)


@pytest.mark.parametrize("arch,engages", [
    ("olmo-1b", True), ("qwen3-8b", True), ("qwen1.5-4b", True),
    ("deepseek-coder-33b", True), ("qwen3-moe-30b-a3b", False),
    ("jamba-1.5-large-398b", False), ("xlstm-350m", False),
    ("llama-3.2-vision-11b", False), ("hubert-xlarge", False)])
def test_graph_engages_on_dense_decoders_on_cuda_alone(arch, engages):
    """MoE, Mamba, xLSTM, cross-attention and encoder-only models stay
    eager; so does every model with CPU weights or in a sharding
    context."""
    cfg = get_model(arch, tiny=True).cfg
    cuda = torch.device("cuda")
    assert executor_mod.graph_engages(cfg, cuda) is engages
    assert executor_mod.graph_engages(cfg, torch.device("cpu")) is False
    with use_ctx(_serving_ctx()):
        assert executor_mod.graph_engages(cfg, cuda) is False


def test_decode_plan():
    plan = executor_mod.decode_plan
    assert plan(None, None, 24) == "eager"        # the first step
    assert plan(None, 16, 24) == "eager"          # the first after growth
    assert plan(None, 24, 24) == "capture"        # the second
    assert plan(24, 24, 24) == "replay"
    assert plan(16, 16, 24) == "eager"            # a stale graph is not used


class _StandIn:
    """Replays by rerunning the captured function and writing its outputs
    over the ones it returned at capture."""

    def __init__(self, fn, out):
        self.fn, self.out = fn, out

    def replay(self):
        for static, new in zip(self.out, self.fn()):
            static.copy_(new)


@pytest.fixture
def stand_in_graphs(monkeypatch):
    def capture(fn, device):
        out = fn()
        return _StandIn(fn, out), out
    monkeypatch.setattr(executor_mod, "graph_engages", lambda cfg, dev: True)
    monkeypatch.setattr(executor_mod, "_capture_graph", capture)


def _eager_run(arch, prompt, n):
    """Tokens and every step's logits of the eager executor."""
    ex = _executor(arch)
    st, logits = _prefilled(ex, prompt), []
    while len(st.tokens_out) < n:
        st = ex.step_decode(st)
        logits.append(st.last_logits)
    return np.stack(st.tokens_out, 1), logits


@pytest.mark.parametrize("arch", DENSE)
def test_capture_schedule_through_the_executor(arch, stand_in_graphs):
    """20 tokens from an 8-token prompt: the cache grows at pos 8 (to 24)
    and 24 (to 40).  Each growth step runs eagerly, the next step
    captures, the rest of the capacity replays; growth drops the graph,
    and so does the end of the run.  Tokens and every step's logits equal
    the eager executor's bit for bit; a request that decodes one step at
    its capacity captures nothing."""
    want_tokens, want_logits = _eager_run(arch, PROMPT, 20)
    ex = _executor(arch)
    with host.recording():
        host.reset()
        st = _prefilled(ex)
        plans, graphs = [], []
        while len(st.tokens_out) < 20:
            before = host.counters()
            st = ex.step_decode(st)
            new = {k: n - before.get(k, 0) for k, n in host.counters().items()}
            plans.append("capture" if new.get("decode_graph_captures")
                         else "replay" if new.get("decode_graph_replays")
                         else "eager")
            graphs.append(st.graph and st.graph.capacity)
            assert torch.equal(st.last_logits, want_logits[len(plans) - 1])
        counts = host.counters()
        spans = host.summary()
        host.reset()
    assert np.array_equal(np.stack(st.tokens_out, 1), want_tokens)
    assert plans == (["eager", "capture"] + ["replay"] * 14
                     + ["eager", "capture", "replay"])
    assert graphs == [None] + [24] * 15 + [None, 40, 40]
    assert counts["decode_graph_captures"] == spans["exec.capture"]["count"] == 2
    assert counts["decode_graph_replays"] == spans["exec.replay"]["count"] == 17
    assert counts["kv_grows"] == 2 and counts["host_syncs"] == 20
    assert spans["exec.model"]["count"] == spans["exec.decode"]["count"] == 19
    done = ex.run_uninterrupted({"tokens": PROMPT}, max_new_tokens=20)
    assert done.graph is None and done.phase == "done"
    with host.recording():
        host.reset()
        short = ex.run_uninterrupted({"tokens": PROMPT}, max_new_tokens=2)
        assert "decode_graph_captures" not in host.counters()
        host.reset()
    assert np.array_equal(np.stack(short.tokens_out, 1), want_tokens[:, :2])


def test_preempt_resume_with_another_request_between(stand_in_graphs):
    """Request a is preempted after three steps at its second capacity
    (eager, capture, replay) and request b runs to its end between, with
    graphs of its own; a resumes, replaying its own graph, to the tokens
    and logits of its uninterrupted eager run."""
    b_prompt = np.array([[3, 1, 4, 1, 5, 9, 2, 6, 5, 3]], np.int32)
    want_a, logits_a = _eager_run("olmo-1b", PROMPT, 12)
    want_b, _ = _eager_run("olmo-1b", b_prompt, 12)
    ex = _executor("olmo-1b")
    st = _prefilled(ex)
    for _ in range(3):
        st = ex.step_decode(st)
    mine = st.graph
    assert mine is not None and mine.capacity == 24
    st = PreemptibleExecutor.checkpoint(st)
    other = ex.run_uninterrupted({"tokens": b_prompt}, max_new_tokens=12)
    assert np.array_equal(np.stack(other.tokens_out, 1), want_b)
    st = PreemptibleExecutor.restore(st)
    while len(st.tokens_out) < 12:
        st = ex.step_decode(st)
    assert st.graph is mine
    assert np.array_equal(np.stack(st.tokens_out, 1), want_a)
    assert torch.equal(st.last_logits, logits_a[-1])

