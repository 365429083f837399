"""The port's sharded serving (``distributed/serve_step.py``) against the
single process and the JAX package's sharded prefill and decode, and the
kernels' new modes and custom ops against their plain versions.

One subprocess spawns eight gloo processes on a (2, 4) ("data", "model")
mesh (``file://`` rendezvous under the test's temporary directory) and
runs sharded prefill and four decode steps of tiny archs from the JAX
package's weights, the rows split over 'data', heads (or query rows), d_ff,
the vocabulary, Mamba's channels and the experts over 'model', decode's
cache split over positions ('model', or both axes for the
``long_500k``-named shape) with the blocks' partials merged.  Beside it a
second subprocess runs the JAX package's own prefill and decode under the
reference's shardings on eight virtual CPU devices.  The tests below hold
the first to the port's single process and to the second.  All in f32.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro import configs as jconfigs
from repro.training import TrainConfig as JTrainConfig
from repro.training import init_train_state as j_init_train_state
from repro_torch import configs
from repro_torch.distributed.collectives import combine_partials
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.decode_attention.ref import (NEG_INF,
                                                      decode_attention_plain,
                                                      merged_bf16_tolerance)
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_plain
from repro_torch.kernels.preemptible_matmul.ref import matmul_partial_plain
from repro_torch.models import transformer
from repro_torch.models.transformer import tree_leaves
from repro_torch.params import params_from_numpy
from repro_torch.training import checkpoint

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 300
# the sharded run against the single process, scaled by max(1, max |ref|)
# as chip_smoke.py's TINY_TOL: the sharded products sum in other orders
# (row-parallel partial sums, the expert-parallel dispatch, the merge of
# the cache's blocks), and a recurrent state that grows past 1 carries
# the difference at its own scale
SHARD_TOL = 1e-5
TOL = 2e-4          # tests/test_torch_model.py's, against the JAX package
PROMPT, CAPACITY, STEPS = 16, 32, 4
# name -> (arch, overrides): qwen3-8b's 2 KV heads do not divide 4, nor do
# qwen1.5-4b's 6 heads (its prefill splits the query rows: flash at an
# offset)
CFGS = {"olmo-1b": ("olmo-1b", {}),
        "qwen3-8b": ("qwen3-8b", {}),
        "qwen1.5-4b-6-heads": ("qwen1.5-4b", {"n_heads": 6,
                                              "n_kv_heads": 6}),
        "qwen3-moe-30b-a3b": ("qwen3-moe-30b-a3b", {}),
        "jamba-1.5-large-398b": ("jamba-1.5-large-398b", {}),
        "llama-3.2-vision-11b": ("llama-3.2-vision-11b", {}),
        "hubert-xlarge": ("hubert-xlarge", {}),
        "xlstm-350m": ("xlstm-350m", {})}
# (run, config, decode shape name, batch): "decode" takes decode_32k's
# rules (the cache's positions over 'model', rows over 'data');
# "long_500k" the long-context rules (batch 1, positions and Mamba's
# channels over both axes)
RUNS = tuple((k, k, "decode", 4) for k in CFGS) + (
    ("jamba-long_500k", "jamba-1.5-large-398b", "long_500k", 1),)

WORKER = textwrap.dedent('''
    import dataclasses, datetime, sys

    import numpy as np
    import torch
    import torch.distributed as dist

    RUNS, CFGS, PROMPT, CAPACITY, STEPS = %r, %r, %r, %r, %r


    def main(rank, world, tmp):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{tmp}/pg",
                                rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=120))
        from torch.distributed.tensor import distribute_tensor
        from repro_torch import configs
        from repro_torch.configs import Shape
        from repro_torch.distributed import elastic, sharding as shd
        from repro_torch.distributed.context import placements, use_rules
        from repro_torch.distributed.serve_step import (sharded_decode_step,
                                                        sharded_prefill)
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.models import moe, moe_sharded
        from repro_torch.models.transformer import tree_leaves
        from repro_torch.training import checkpoint
        mesh = make_mesh((2, 4), ("data", "model"), "cpu")
        dm = mesh.device_mesh

        # which of apply_moe's branches each phase takes
        paths = {}

        def counted(mod, fn, key):
            f = getattr(mod, fn)

            def g(*a, **k):
                paths[key] = paths.get(key, 0) + 1
                return f(*a, **k)
            setattr(mod, fn, g)
        counted(moe_sharded, "moe_ffn_sharded", "a2a")
        counted(moe_sharded, "moe_ffn_psum", "psum")
        counted(moe, "moe_ffn", "whole")

        def whole(tree):
            return [x.full_tensor().numpy() for x in tree_leaves(tree)]

        out, log = {}, {}
        for run, key, shape_name, b in RUNS:
            arch, over = CFGS[key]
            cfg = dataclasses.replace(configs.get_tiny_config(arch),
                                      capacity_factor=16.0, **over)
            _, state = checkpoint.load(f"{tmp}/{key}")
            params = elastic.distribute(
                state["params"], shd.param_placements(state["params"], cfg,
                                                      mesh), mesh)
            with np.load(f"{tmp}/{run}_inputs.npz") as z:
                batch = {k: torch.from_numpy(z[k]) for k in z.files}
            pre = Shape("prefill", "prefill", PROMPT, b)
            paths.clear()
            with use_rules(mesh, shd.logical_rules(cfg, pre, mesh)):
                logits, cache = sharded_prefill(params, batch, cfg)
            log[run] = {"prefill_paths": dict(paths)}
            out[f"{run}/prefill"] = logits.full_tensor().numpy()
            if cfg.encoder_only:
                continue
            for i, x in enumerate(whole(cache)):
                out[f"{run}/prefill_cache_{i}"] = x
            # the cache grown to CAPACITY positions, placed for decode
            dec = Shape(shape_name, "decode", CAPACITY, b)
            grown = {}
            for slot, leaves in cache.items():
                mixer = cfg.block_pattern[int(slot[len("slot"):])][0]
                grown[slot] = {}
                for name, x in leaves.items():
                    x = x.full_tensor()
                    if mixer == "attn":
                        pad = x.new_zeros(x.shape[:2] + (CAPACITY - PROMPT,)
                                          + x.shape[3:])
                        x = torch.cat([x, pad], dim=2)
                    grown[slot][name] = x
            c_place = shd.map2(lambda _, sp: placements(sp, mesh), grown,
                               shd.cache_specs(cfg, dec, mesh))
            cache = shd.map2(lambda x, pl: distribute_tensor(x, dm, pl),
                             grown, c_place)
            tokens = logits.full_tensor()[:, -1].argmax(-1)[:, None]
            paths.clear()
            with use_rules(mesh, shd.logical_rules(cfg, dec, mesh)):
                for i in range(STEPS):
                    logits, cache = sharded_decode_step(
                        params, cache, tokens, PROMPT + i, cfg)
                    logits = logits.full_tensor()
                    out[f"{run}/decode_{i}"] = logits.numpy()
                    tokens = logits[:, -1].argmax(-1)[:, None]
            log[run]["decode_paths"] = dict(paths)
            for i, x in enumerate(whole(cache)):
                out[f"{run}/decode_cache_{i}"] = x
        if rank == 0:
            np.savez(f"{tmp}/result.npz", **out)
            import json
            with open(f"{tmp}/result.json", "w") as fh:
                json.dump(log, fh)
        dist.destroy_process_group()


    if __name__ == "__main__":
        import torch.multiprocessing as mp
        mp.start_processes(main, args=(8, sys.argv[1]), nprocs=8,
                           start_method="spawn")
''' % (RUNS, CFGS, PROMPT, CAPACITY, STEPS))

# the JAX package's prefill and decode under its own shardings on a (2, 4)
# mesh of eight virtual CPU devices: parameters by param_specs, inputs by
# batch_specs, prefill's cache pinned to the decode sharding of its length
# (as the reference's dry-run pins it), the decode cache by cache_specs
JAX_WORKER = textwrap.dedent('''
    import dataclasses, functools, sys

    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro import configs
    from repro.configs import Shape
    from repro.distributed import sharding as shd
    from repro.distributed.context import use_rules
    from repro.launch.mesh import make_mesh
    from repro.models import transformer
    from repro.training import TrainConfig, init_train_state

    RUNS, CFGS, PROMPT, CAPACITY, STEPS = %r, %r, %r, %r, %r
    tmp = sys.argv[1]
    mesh = make_mesh((2, 4), ("data", "model"))
    put = lambda tree, spec: jax.tree.map(
        jax.device_put, tree, shd.as_shardings(spec, mesh))
    out = {}
    for run, key, shape_name, b in RUNS:
        arch, over = CFGS[key]
        cfg = dataclasses.replace(configs.get_tiny_config(arch),
                                  capacity_factor=16.0, **over)
        params, _ = init_train_state(jax.random.PRNGKey(0), cfg,
                                     TrainConfig(remat="none"))
        with np.load(f"{tmp}/{run}_inputs.npz") as z:
            batch = {k: jnp.asarray(z[k]) for k in z.files}
        pre = Shape("prefill", "prefill", PROMPT, b)
        with use_rules(mesh, shd.logical_rules(cfg, pre, mesh)):
            params = put(params, shd.param_specs(jax.tree.map(
                lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), params),
                cfg, mesh))
            batch = put(batch, {k: v for k, v in shd.batch_specs(
                cfg, pre, mesh).items() if k in batch})
            cache_out = None if cfg.encoder_only else shd.as_shardings(
                shd.cache_specs(cfg, Shape("cache", "decode", PROMPT, b),
                                mesh), mesh)
            logits, cache = jax.jit(
                functools.partial(transformer.prefill, cfg=cfg),
                out_shardings=(None, cache_out))(params, batch)
        out[f"{run}/prefill"] = np.asarray(logits)
        if cfg.encoder_only:
            continue
        dec = Shape(shape_name, "decode", CAPACITY, b)
        grown = {}
        for slot, leaves in cache.items():
            mixer = cfg.block_pattern[int(slot[len("slot"):])][0]
            grown[slot] = {}
            for name, x in leaves.items():
                x = np.asarray(x)
                if mixer == "attn":
                    x = np.concatenate([x, np.zeros(
                        x.shape[:2] + (CAPACITY - PROMPT,) + x.shape[3:],
                        x.dtype)], axis=2)
                grown[slot][name] = x
        tokens = np.argmax(np.asarray(logits)[:, -1], -1)[:, None]
        with use_rules(mesh, shd.logical_rules(cfg, dec, mesh)):
            cache = put(grown, shd.cache_specs(cfg, dec, mesh))
            step = jax.jit(functools.partial(transformer.decode_step,
                                             cfg=cfg))
            for i in range(STEPS):
                logits, cache = step(params, cache,
                                     jnp.asarray(tokens, jnp.int32),
                                     jnp.int32(PROMPT + i))
                out[f"{run}/decode_{i}"] = np.asarray(logits)
                tokens = np.argmax(np.asarray(logits)[:, -1], -1)[:, None]
    np.savez(f"{tmp}/jax_result.npz", **out)
''' % (RUNS, CFGS, PROMPT, CAPACITY, STEPS))


def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")


def _cfgs(key):
    """The tiny config at drop-free capacity in both packages."""
    arch, over = CFGS[key]
    return (dataclasses.replace(jconfigs.get_tiny_config(arch),
                                capacity_factor=16.0, **over),
            dataclasses.replace(configs.get_tiny_config(arch),
                                capacity_factor=16.0, **over))


def _inputs(cfg, b: int, seed: int) -> dict:
    """A prompt batch made with numpy: tokens, or frames, and image
    embeddings for the VLM."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.embedding_inputs:
        out["frames"] = rng.standard_normal(
            (b, PROMPT, cfg.d_model)).astype(np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab_size,
                                     (b, PROMPT)).astype(np.int32)
    if cfg.img_tokens:
        out["img_embeds"] = rng.standard_normal(
            (b, cfg.img_tokens, cfg.d_vision)).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def serve_run(tmp_path_factory):
    """The JAX package's initial weights of each config, saved as the
    port's checkpoints, and each run's inputs; then the eight-process job
    and, beside it, the JAX package's sharded runs.  Returns the two
    results, the job's log and the weights (numpy trees)."""
    tmp = tmp_path_factory.mktemp("serve")
    for i, (run, key, _, b) in enumerate(RUNS):
        np.savez(tmp / f"{run}_inputs.npz", **_inputs(_cfgs(key)[1], b, i))
    (tmp / "jax_worker.py").write_text(JAX_WORKER)
    (tmp / "worker.py").write_text(WORKER)
    jax_run = subprocess.Popen(
        [sys.executable, str(tmp / "jax_worker.py"), str(tmp)],
        env=dict(_env(), JAX_PLATFORMS="cpu",
                 XLA_FLAGS="--xla_force_host_platform_device_count=8"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        weights = {}
        for key in CFGS:
            jcfg, _ = _cfgs(key)
            params, _ = j_init_train_state(jax.random.PRNGKey(0), jcfg,
                                           JTrainConfig(remat="none"))
            weights[key] = jax.tree.map(np.asarray, params)
            checkpoint.save(str(tmp / key), 0, {
                "params": params_from_numpy(weights[key], "cpu")})
        r = subprocess.run([sys.executable, str(tmp / "worker.py"),
                            str(tmp)], env=_env(), capture_output=True,
                           text=True, timeout=TIMEOUT_S)
        assert r.returncode == 0, r.stderr[-3000:]
        _, err = jax_run.communicate(timeout=TIMEOUT_S)
        assert jax_run.returncode == 0, err[-3000:]
    finally:
        jax_run.kill()
        jax_run.wait()
    with np.load(tmp / "result.npz") as z:
        got = {k: z[k] for k in z.files}
    with np.load(tmp / "jax_result.npz") as z:
        jax_got = {k: z[k] for k in z.files}
    log = json.loads((tmp / "result.json").read_text())
    return got, jax_got, log, weights, tmp


def _single_process(run, key, b, weights, tmp):
    """The port's meshless ``prefill`` and ``decode_step`` on the same
    weights and inputs, the cache grown as the job grows it: (prefill
    logits and cache, each step's logits, the last cache)."""
    _, cfg = _cfgs(key)
    params = params_from_numpy(weights[key], "cpu")
    with np.load(tmp / f"{run}_inputs.npz") as z:
        batch = {k: torch.from_numpy(z[k]) for k in z.files}
    logits, cache = transformer.prefill(params, batch, cfg)
    out = {"prefill": logits.numpy(),
           "prefill_cache": [x.numpy() for x in tree_leaves(cache)]}
    if cfg.encoder_only:
        return out
    grown = {}
    for slot, leaves in cache.items():
        mixer = cfg.block_pattern[int(slot[len("slot"):])][0]
        grown[slot] = {}
        for name, x in leaves.items():
            if mixer == "attn":
                x = torch.cat([x, x.new_zeros(x.shape[:2] + (
                    CAPACITY - PROMPT,) + x.shape[3:])], dim=2)
            grown[slot][name] = x.clone()
    tokens = logits[:, -1].argmax(-1)[:, None]
    out["decode"] = []
    for i in range(STEPS):
        logits, grown = transformer.decode_step(params, grown, tokens,
                                                PROMPT + i, cfg)
        out["decode"].append(logits.numpy())
        tokens = logits[:, -1].argmax(-1)[:, None]
    out["decode_cache"] = [x.numpy() for x in tree_leaves(grown)]
    return out


def _close(a, b, tol, scaled=False) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    d = float(np.abs(a - b).max())
    bound = tol * max(1.0, float(np.abs(b).max())) if scaled else tol
    assert d < bound, (d, bound)
    return d


def _tokens(logits):
    return np.argmax(logits[:, -1], -1)


@pytest.mark.parametrize("run,key,shape,b", RUNS, ids=[r[0] for r in RUNS])
def test_sharded_serving_matches_single_process(serve_run, run, key, shape,
                                                b):
    """Sharded prefill and four decode steps on the (2, 4) mesh give the
    single process's tokens, logits within 1e-5, and caches (gathered
    whole) within 1e-5, after prefill and after the last step; each bound
    times max(1, the largest magnitude of the single process's tensor)."""
    got, _, _, weights, tmp = serve_run
    ref = _single_process(run, key, b, weights, tmp)
    _close(got[f"{run}/prefill"], ref["prefill"], SHARD_TOL, scaled=True)
    if "decode" not in ref:
        return
    for i, x in enumerate(ref["prefill_cache"]):
        _close(got[f"{run}/prefill_cache_{i}"], x, SHARD_TOL, scaled=True)
    assert np.array_equal(_tokens(got[f"{run}/prefill"]),
                          _tokens(ref["prefill"]))
    for i in range(STEPS):
        _close(got[f"{run}/decode_{i}"], ref["decode"][i], SHARD_TOL,
               scaled=True)
        assert np.array_equal(_tokens(got[f"{run}/decode_{i}"]),
                              _tokens(ref["decode"][i]))
    for i, x in enumerate(ref["decode_cache"]):
        _close(got[f"{run}/decode_cache_{i}"], x, SHARD_TOL, scaled=True)


@pytest.mark.parametrize("run,key,shape,b", RUNS, ids=[r[0] for r in RUNS])
def test_sharded_serving_matches_jax_sharded(serve_run, run, key, shape, b):
    """The same runs against the JAX package's prefill and decode under the
    reference's shardings on eight virtual devices: every logit within
    2e-4, the same tokens."""
    got, jax_got, _, _, _ = serve_run
    names = [k for k in jax_got if k.startswith(f"{run}/")]
    assert names
    for k in names:
        _close(got[k], jax_got[k], TOL)
        assert np.array_equal(_tokens(got[k]), _tokens(jax_got[k]))


def test_moe_serving_takes_the_expert_parallel_paths(serve_run):
    """The MoE's prefill dispatches through the all_to_all path and its
    decode through the psum path, never every expert on whole weights:
    one call per MoE layer (jamba's long-context prefill too)."""
    _, _, log, _, _ = serve_run
    for run, key in (("qwen3-moe-30b-a3b", "qwen3-moe-30b-a3b"),
                     ("jamba-1.5-large-398b", "jamba-1.5-large-398b"),
                     ("jamba-long_500k", "jamba-1.5-large-398b")):
        cfg = _cfgs(key)[1]
        n_moe = sum(f == "moe" for _, f in cfg.block_pattern) * cfg.n_periods
        assert log[run]["prefill_paths"] == {"a2a": n_moe}, log[run]
        assert log[run]["decode_paths"] == {"psum": n_moe * STEPS}, log[run]


# --------------------------------------------------------------------------
# The kernels' new modes, on their plain versions
# --------------------------------------------------------------------------
def _qkv(rng, b, hq, hkv, s, t, d, dtype=torch.float32):
    f = lambda *sh: torch.from_numpy(rng.standard_normal(sh).astype(
        np.float32)).to(dtype)
    return f(b, hq, s, d), f(b, hkv, t, d), f(b, hkv, t, d)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_row_blocks_at_offsets_make_the_whole_output(dtype):
    """Blocks of query rows at their offsets (``q_offset``), against every
    key, concatenate to the whole sequence's causal output; offset 0 is
    the whole call.  Through the wrapper, whose CPU path is the plain
    version."""
    rng = np.random.default_rng(0)
    q, k, v = _qkv(rng, 2, 4, 2, 64, 64, 16, dtype)
    whole = flash_attention(q, k, v, causal=True)
    assert torch.equal(flash_attention(q, k, v, True, 0), whole)
    blocks = [flash_attention(q[:, :, r:r + 16], k, v, causal=True,
                              q_offset=r) for r in range(0, 64, 16)]
    torch.testing.assert_close(torch.cat(blocks, dim=2).float(),
                               whole.float(), atol=1e-6, rtol=1e-6)
    # a block that ignored the offset would mask keys it must see
    wrong = flash_attention_plain(q[:, :, 16:32], k, v, True, 0)
    assert float((wrong.float() - blocks[1].float()).abs().max()) > 1e-2
    with pytest.raises(ValueError):
        flash_attention(q, k, v, causal=True, q_offset=-1)


@pytest.mark.parametrize("pos", [0, 5, 16, 31, 47, 63])
def test_split_decode_merged_equals_the_whole_cache(pos):
    """The cache split into 4 blocks of 16: each block's decode at its local
    pos (clamped to [-1, 15]; -1 for a block past the token) with its
    log-sum-exp, merged by ``combine_partials``, equals the decode over
    the whole cache; a block past pos returns zeros and -1e30 and weighs
    nothing."""
    rng = np.random.default_rng(1)
    q, k, v = _qkv(rng, 2, 8, 2, 1, 64, 16)
    q = q[:, :, 0]
    whole, lse = decode_attention(q, k, v, pos, return_lse=True)
    outs, lses = [], []
    for r in range(4):
        lp = min(max(pos - 16 * r, -1), 15)
        o, l = decode_attention(q, k[:, :, 16 * r:16 * (r + 1)],
                                v[:, :, 16 * r:16 * (r + 1)], lp,
                                return_lse=True)
        if lp < 0:
            assert torch.equal(o, torch.zeros_like(o))
            assert bool((l == NEG_INF).all())
        outs.append(o)
        lses.append(l)
    merged = combine_partials(torch.stack(outs), torch.stack(lses))
    torch.testing.assert_close(merged, whole, atol=1e-6, rtol=1e-6)
    # the merged log-sum-exp of the blocks is the whole cache's
    torch.testing.assert_close(torch.logsumexp(torch.stack(lses), 0), lse,
                               atol=1e-5, rtol=1e-6)
    live = [r for r in range(4) if pos - 16 * r >= 0]
    alone = combine_partials(torch.stack(outs)[live],
                             torch.stack(lses)[live])
    assert torch.equal(alone, merged)


def test_merged_bf16_partials_within_their_tolerance():
    """bf16 partials of 4 blocks, each rounded once, merge within
    ``merged_bf16_tolerance`` of the f32 decode over the whole cache; a
    dropped block exceeds it."""
    rng = np.random.default_rng(2)
    q, k, v = _qkv(rng, 1, 8, 2, 1, 64, 16)
    q = q[:, :, 0]
    ref = decode_attention_plain(q, k, v, 63)
    parts = [decode_attention_plain(q, k[:, :, 16 * r:16 * (r + 1)],
                                    v[:, :, 16 * r:16 * (r + 1)], 15,
                                    return_lse=True) for r in range(4)]
    outs = torch.stack([o.to(torch.bfloat16) for o, _ in parts])
    lses = torch.stack([l for _, l in parts])
    tol = merged_bf16_tolerance(ref, outs, lses)
    merged = combine_partials(outs, lses).float()
    assert bool(((merged - ref).abs() <= tol).all())
    dropped = combine_partials(outs[:3], lses[:3]).float()
    assert float(((dropped - ref).abs() / tol).max()) > 2


# --------------------------------------------------------------------------
# The kernels' custom ops under fake tensors
# --------------------------------------------------------------------------
def _flop_count(fn, *args) -> int:
    with FlopCounterMode(display=False) as fc:
        fn(*args)
    return fc.get_total_flops()


OPS = ("flash_attention", "decode_attention", "matmul_resumable")


@pytest.mark.parametrize("op", OPS)
def test_custom_op_traces_fake_tensors(op):
    """Each kernel launch is a ``prema::`` custom op whose fake
    implementation gives the output's shape, dtype and strides under
    ``FakeTensorMode`` (no storage, no kernel, no launch counted) and
    whose FLOP formula equals ``FlopCounterMode``'s count of the plain
    version on the same shapes."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.preemptible_matmul import ops as mm_ops
    before = (flash_ops.launches, decode_ops.launches, mm_ops.launches,
              dict(decode_ops._tickets))
    rng = np.random.default_rng(3)
    if op == "flash_attention":
        q, k, v = _qkv(rng, 2, 8, 2, 24, 40, 16, torch.bfloat16)
        q = q.transpose(1, 2).contiguous().transpose(1, 2)   # (B,S,H,D)
        plain = _flop_count(flash_attention_plain, q, k, v, True, 8)
        with FakeTensorMode() as mode:
            fq, fk, fv = (mode.from_tensor(x) for x in (q, k, v))
            with FlopCounterMode(display=False) as fc:
                out = torch.ops.prema.flash_attention(fq, fk, fv, True, 8)
        assert (out.shape, out.dtype, out.stride()) == (q.shape, q.dtype,
                                                         q.stride())
    elif op == "decode_attention":
        q, k, v = _qkv(rng, 2, 8, 2, 1, 40, 16, torch.bfloat16)
        q = q[:, :, 0]
        plain = _flop_count(decode_attention_plain, q, k, v, 7, True)
        with FakeTensorMode() as mode:
            fq, fk, fv = (mode.from_tensor(x) for x in (q, k, v))
            with FlopCounterMode(display=False) as fc:
                out, lse = torch.ops.prema.decode_attention(
                    fq, fk, fv, decode_ops._tickets_for(fq, 4), None, 7,
                    True)
        assert (out.shape, out.dtype) == (q.shape, q.dtype)
        assert (lse.shape, lse.dtype) == ((2, 8), torch.float32)
    else:
        x = torch.randn(64, 300)
        y = torch.randn(300, 48)
        acc = torch.zeros(128, 128)
        plain = _flop_count(matmul_partial_plain, x, y, acc, 1, 3, 100)
        with FakeTensorMode() as mode:
            fx, fy, facc = (mode.from_tensor(t) for t in (x, y, acc))
            with FlopCounterMode(display=False) as fc:
                torch.ops.prema.matmul_resumable(fx, fy, facc, facc, 100,
                                                 300)
    assert fc.get_total_flops() == plain > 0
    assert (flash_ops.launches, decode_ops.launches, mm_ops.launches,
            dict(decode_ops._tickets)) == before
