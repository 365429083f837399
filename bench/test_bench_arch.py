"""The architecture modules (``arch/<arch>.py``, ``ref/<arch>.py``).

For the dense configurations the counts the readers take through
``arch/dense.py`` equal, at full width over every prompt of 64-2048 and
every context of 64-2304 tokens, the formulas the readers used before
they asked a module: the integers exactly, the FLOP quotients to 1e-12.

And a configuration of another architecture needs only new files: a tiny
hybrid of the program's own block kinds, (attention, MLP) then (Mamba,
MoE), whose ``arch`` and ``ref`` modules are written into a temporary
directory, runs a preempt round through ``harness.serve`` and
``harness.check`` on the CPU, and ``mfu`` and the rooflines' launch
counts read through its module.  Its reference wraps the program's own
prefill over every position: it tests the plumbing, not a model."""
import json
import textwrap

import pytest

from bench import harness, reckon_gap, reference, yardstick

BM = harness.load_benchmark()
DENSE = [c["name"] for c in BM["configs"]
         if json.loads((harness.REPO / c["file"]).read_text()).get("arch",
                                                                  "dense") == "dense"]
PROMPTS = range(64, 2049)
CONTEXTS = range(64, 2305)


def full(name):
    conf = next(c for c in BM["configs"] if c["name"] == name)
    return json.loads((harness.REPO / conf["file"]).read_text())


# the counts as the readers wrote them before they asked a module
def old_layer_params(cfg):
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    hq, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    return d * (d // hq) * (2 * hq + 2 * hkv) + 3 * d * f


def old_prefill_flops(cfg, s):
    d, hq, n = cfg["hidden_size"], cfg["num_attention_heads"], cfg["num_hidden_layers"]
    return (2 * s * n * old_layer_params(cfg) + n * 4 * hq * (d // hq) * s * (s + 1) // 2
            + 2 * d * cfg["vocab_size"])


def old_decode_flops(cfg, t):
    d, hq, n = cfg["hidden_size"], cfg["num_attention_heads"], cfg["num_hidden_layers"]
    return (2 * n * old_layer_params(cfg) + n * 4 * hq * (d // hq) * t
            + 2 * d * cfg["vocab_size"])


def window(cfg, steps, trace=None):
    reqs = {0: harness.Req(0, 9, 1, 0, 1)}
    return harness.Window(workload="x", cfg=cfg, mix={}, setup_s=1.0, wall_s=2.0,
                          reqs=reqs, steps=steps, rounds=[(0.0, 2.0)], trace=trace)


@pytest.mark.parametrize("name", DENSE)
def test_dense_counts_as_before(name):
    cfg = full(name)
    mod = harness.arch(cfg)
    n, hq = cfg["num_hidden_layers"], cfg["num_attention_heads"]
    assert mod.attention_layers(cfg) == n and mod.attention_per_period(cfg) == 1
    assert mod.periods(cfg) == n and mod.head_dim(cfg) == cfg["hidden_size"] // hq
    for s in PROMPTS:
        assert mod.step_flops(cfg, "prefill", s) == pytest.approx(
            old_prefill_flops(cfg, s) / n, rel=1e-12, abs=0)
    for t in CONTEXTS:
        assert mod.step_flops(cfg, "decode", t) == old_decode_flops(cfg, t)


@pytest.mark.parametrize("name", DENSE)
def test_dense_readers_as_before(name):
    """``mfu``, ``mfu.prefill``, ``mfu.decode`` and both rooflines over a
    window of one prefill step at every prompt length and one decode step
    at every context, against the readers' former arithmetic."""
    cfg = full(name)
    n, d, hq, hkv = (cfg["num_hidden_layers"], cfg["hidden_size"],
                     cfg["num_attention_heads"], cfg["num_key_value_heads"])
    dh = d // hq
    steps = ([harness.Step("prefill", 0, 0.0, 0.001, s) for s in PROMPTS]
             + [harness.Step("decode", 0, 0.0, 0.002, t) for t in CONTEXTS])
    trace = harness.Trace(by_name={"flash_fwd_wgmma_kernel<128>": [1.0, len(PROMPTS)],
                                   "decode_split_kernel": [1.0, n * len(CONTEXTS)]},
                          busy_s=1.0, window_s=2.0, gaps=[])
    w = window(cfg, steps, trace)
    read = harness.reader
    flops = (sum(1 * old_prefill_flops(cfg, s) / n for s in PROMPTS)
             + sum(old_decode_flops(cfg, t) for t in CONTEXTS))
    assert read("mfu")(w) == pytest.approx(flops / (2.0 * 989e12) * 100, rel=1e-12)
    decode = sum(old_decode_flops(cfg, t) for t in CONTEXTS)
    assert read("mfu.decode")(w) == pytest.approx(
        decode / (0.002 * len(CONTEXTS) * 989e12) * 100, rel=1e-12)
    flash = sum(yardstick.bound_s(yardstick.flash_ops(s, hq, dh, 1),
                                  yardstick.flash_bytes(s, hq, hkv, dh, 1))
                for s in PROMPTS)
    assert read("flash_roofline")(w) == pytest.approx(flash * 100, rel=1e-12)
    dec = n * sum(yardstick.bound_s(yardstick.decode_attn_ops(t, hq, dh, 1),
                                    yardstick.decode_attn_bytes(t, hq, hkv, dh, 1))
                  for t in CONTEXTS)
    assert read("decode_attn_roofline")(w) == pytest.approx(dec * 100, rel=1e-12)
    for s in (64, 777, 2048):
        r = harness.Req(0, 9, 1, s, 1, start=0.0, first=0.5)
        w1 = window(cfg, [], None)
        w1.reqs = {0: r}
        assert read("mfu.prefill")(w1) == pytest.approx(
            old_prefill_flops(cfg, s) / (0.5 * 989e12) * 100, rel=1e-12)


HYBRID_ARCH = '''
"""A tiny hybrid: periods of (attention, MLP) then (Mamba, MoE)."""
import torch


def arch_config(cfg):
    from repro_torch.configs import ArchConfig
    return ArchConfig(
        name=cfg["name"], family="hybrid", n_layers=cfg["num_hidden_layers"],
        d_model=cfg["hidden_size"], n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"], d_ff=cfg["intermediate_size"],
        vocab_size=cfg["vocab_size"],
        block_pattern=(("attn", "mlp"), ("mamba", "moe")),
        n_experts=cfg["num_experts"], top_k=cfg["num_experts_per_tok"],
        capacity_factor=float(cfg["num_experts"]), tie_embeddings=False,
        dtype=cfg["serve_dtype"])


def draw_weights(cfg, gen, device):
    from repro_torch.models import transformer
    tree = transformer.init_params(arch_config(cfg), generator=gen,
                                   dtype=getattr(torch, cfg["serve_dtype"]),
                                   device=device)
    flat = {}

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                flat["/".join(path + (k,))] = v
    walk(tree, ())
    return flat


def port_params(w):
    params = {}
    for name, t in w.items():
        *path, leaf = name.split("/")
        node = params
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = t
    return params


def periods(cfg):
    return cfg["num_hidden_layers"] // 2


def step_flops(cfg, kind, size):
    """2 x tokens x the weights a token multiplies in one period."""
    d, f, hq = cfg["hidden_size"], cfg["intermediate_size"], cfg["num_attention_heads"]
    attn = d * (d // hq) * (2 * hq + 2 * cfg["num_key_value_heads"])
    mamba = 2 * d * 2 * d + 2 * d * d
    ffn = (1 + cfg["num_experts_per_tok"]) * 3 * d * f + d * cfg["num_experts"]
    tokens = size if kind == "prefill" else 1
    return 2 * tokens * (attn + mamba + ffn)


def attention_layers(cfg):
    return periods(cfg)


def attention_per_period(cfg):
    return 1


def head_dim(cfg):
    return cfg["hidden_size"] // cfg["num_attention_heads"]


def tiny(cfg):
    return {}
'''

HYBRID_REF = '''
"""The program's own prefill, every position unembedded."""
import torch

from bench import harness


@torch.no_grad()
def logits_at(cfg, w, tokens, rows, fp8=False):
    from repro_torch.models import transformer
    from repro_torch.models.layers import apply_norm, unembed
    mod = harness.arch(cfg)
    acfg, params = mod.arch_config(cfg), mod.port_params(w)
    h, _ = transformer._embed_inputs(params, acfg, {"tokens": tokens[None].long()})
    for p in range(acfg.n_periods):
        slots = transformer.period_params(params["slots"], p)
        for i in range(acfg.period):
            h, _, _ = transformer._apply_block(i, h, slots[f"slot{i}"], acfg,
                                               "prefill", None, None, None)
    h = apply_norm(h, params["final_norm"], acfg)
    return unembed(h[:, list(rows)], params, acfg)[0].float()
'''

HYBRID = dict(name="hybrid-tiny", arch="hybrid", hidden_size=64,
              intermediate_size=128, num_hidden_layers=4, num_attention_heads=4,
              num_key_value_heads=2, num_experts=4, num_experts_per_tok=2,
              vocab_size=256, serve_dtype="float32")


def test_a_new_architecture_needs_only_new_files(tmp_path, monkeypatch):
    for sub, text in (("arch", HYBRID_ARCH), ("ref", HYBRID_REF)):
        (tmp_path / sub).mkdir()
        (tmp_path / sub / "hybrid.py").write_text(textwrap.dedent(text))
    monkeypatch.setattr(harness, "ARCH", tmp_path / "arch")
    monkeypatch.setattr(reference, "REF", tmp_path / "ref")
    cfg, seed = dict(HYBRID), 2**40 + 9
    spec = harness.resolve(BM, "olmo-1b.preempt")
    spec["cfg"] = cfg
    # the mix's load on this model's own predicted service times
    iso = reckon_gap.mean_isolated_s(cfg, spec["mix"])
    spec["cell"] = dict(spec["cell"], mean_gap_s=iso / spec["mix"]["load"])
    model = harness.build_model(cfg)
    assert model.cfg.block_pattern == (("attn", "mlp"), ("mamba", "moe"))
    w = harness.draw_weights(cfg, seed, "cpu")
    rec = harness.Recorder()
    results, by_rid, _ = harness.serve(model, harness.port_params(cfg, w), spec,
                                       seed, 0.0, rec)
    assert len(results) == len(by_rid) == spec["mix"]["round_requests"]
    assert sum(r.preemptions for r in rec.reqs.values()) > 0
    got = harness.check(w, cfg, results, by_rid, seed, 64, "cpu")
    assert got["tokens"] >= 64 and got["widest_gap"] < 1e-3, got

    mod = harness.arch(cfg)
    assert (mod.periods(cfg), mod.attention_layers(cfg)) == (2, 2)
    wall = rec.rounds[-1][1] - rec.rounds[0][0]
    w_ = harness.Window(workload="x", cfg=cfg, mix=spec["mix"], setup_s=0.0,
                        wall_s=wall, reqs=rec.reqs, steps=rec.steps,
                        rounds=rec.rounds, trace=None)
    flops = sum(mod.step_flops(cfg, s.kind, s.size) for s in rec.steps
                if s.kind != "start")
    assert flops > 0
    assert harness.reader("mfu")(w_) == pytest.approx(
        flops / (wall * 989e12) * 100, rel=1e-12)
    # one flash launch a prefill step (one attention layer a period), one
    # decode launch per attention layer and decode step: the rooflines read;
    # a launch more and they read nothing
    n_pre = sum(s.kind == "prefill" for s in rec.steps)
    n_dec = sum(s.kind == "decode" for s in rec.steps)
    kern = {"flash_fwd_wgmma_kernel<16>": [1.0, n_pre],
            "decode_split_kernel": [1.0, 2 * n_dec]}
    w_.trace = harness.Trace(by_name=kern, busy_s=1.0, window_s=wall, gaps=[])
    for name in ("flash_roofline", "decode_attn_roofline"):
        assert harness.reader(name)(w_) > 0
    for k in kern:
        kern[k][1] += 1
    for name in ("flash_roofline", "decode_attn_roofline"):
        assert harness.reader(name)(w_) is None
