"""The port's sharded training, expert-parallel MoE and elastic restart on
gloo process groups in subprocesses (the torch twins of
tests/test_distributed_integration.py, which runs the reference on
virtual CPU devices).

One subprocess spawns eight processes on a (2, 4) ("data", "model") mesh
(``file://`` rendezvous under the test's temporary directory, so workers
of a parallel test run never share a port) and runs every mesh job once:
sharded train steps of tiny archs (drop-free capacity, as the reference's
test) from the JAX package's weights, each microbatch's rows split over
'data' and the same on the 4 'model' processes, which split the dense
layers (heads or query rows, d_ff, the vocabulary, Mamba's channels) and
the MoE through each of ``apply_moe``'s three sharded branches; a reshard
(2, 4) → (1, 2), the three MoE dispatch paths with gradients, and
``hint``'s divisibility guard.  Beside it a second subprocess runs the
JAX package's own sharded step on eight virtual CPU devices, as
tests/test_distributed_integration.py does, for the steps whose MoE
load-balance loss is computed per shard.  The tests below read both.
The 8-process job also runs the launcher's sharded init against the whole
init resharded, and the dry-run reckons that init's peak for full-width
qwen3-8b on fake tensors.  The launcher runs under
``torch.distributed.run`` on two processes (a (1, 2) mesh, tensor
parallel) and resumes on one; and on one process its mesh path is held
bit for bit to the meshless ``make_train_step``.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro import configs as jconfigs
from repro.training import TrainConfig as JTrainConfig
from repro.training import init_train_state as j_init_train_state
from repro.training import make_train_step as j_make_train_step
from repro_torch import configs
from repro_torch.launch import train as launcher
from repro_torch.models.transformer import tree_leaves
from repro_torch.params import params_from_numpy
from repro_torch.training import (DataConfig, TokenDataset, TrainConfig,
                                  checkpoint, init_opt_state, init_train_state,
                                  make_train_step)
from repro_torch.training.train_step import make_grad_fn

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
# the tiny configs the steps run (drop-free capacity): name -> (arch,
# overrides); six experts do not divide over the 4 'model' processes, nor
# do six heads (qwen1.5-4b: sequence-parallel attention)
CFGS = {"olmo-1b": ("olmo-1b", {}),
        "qwen3-moe-30b-a3b": ("qwen3-moe-30b-a3b", {}),
        "qwen3-moe-6-experts": ("qwen3-moe-30b-a3b", {"n_experts": 6}),
        "qwen3-8b": ("qwen3-8b", {}),
        "qwen1.5-4b-6-heads": ("qwen1.5-4b", {"n_heads": 6,
                                              "n_kv_heads": 6}),
        "llama-3.2-vision-11b": ("llama-3.2-vision-11b", {}),
        "hubert-xlarge": ("hubert-xlarge", {}),
        "jamba-1.5-large-398b": ("jamba-1.5-large-398b", {})}
# the sharded steps: (name, config, aux_weight, grad_accum, seq_len, the
# MoE branch of apply_moe they must take).  "a2a": moe_ffn_sharded,
# whose load-balance loss is per shard (each process's tokens), so not
# the single process's, and is held to the JAX package's sharded step;
# the MoE also without that loss.  A microbatch's rows split over 'data'
# and are the same on the 4 'model' processes, which split its tokens for
# the all_to_all.  "psum": 8 tokens a microbatch, fewer than one per
# local expert, so moe_ffn_psum.  "whole": the experts do not divide, so
# every token through moe_ffn on whole weights.  The tensor-parallel
# steps after them: qwen3-8b's 2 KV heads do not divide 4 (replicated KV
# weights, each query head reading its KV head) under qk-norm;
# qwen1.5-4b's 6 heads do not, so its attention splits the query rows
# (QKV bias); the VLM's cross-attention; hubert's frames, lm_head, GELU
# and non-causal attention; jamba's Mamba channels beside its attention
# and its MoE (all_to_all, without the per-shard loss).
STEPS = (("olmo-1b", "olmo-1b", 0.01, 1, 16, None),
         ("qwen3-moe-30b-a3b", "qwen3-moe-30b-a3b", 0.01, 1, 16, "a2a"),
         ("qwen3-moe-30b-a3b-accum4", "qwen3-moe-30b-a3b", 0.01, 4, 16,
          "a2a"),
         ("qwen3-moe-30b-a3b-no-aux", "qwen3-moe-30b-a3b", 0.0, 1, 16, "a2a"),
         ("qwen3-moe-30b-a3b-no-aux-accum4", "qwen3-moe-30b-a3b", 0.0, 4, 16,
          "a2a"),
         ("qwen3-moe-30b-a3b-psum", "qwen3-moe-30b-a3b", 0.01, 4, 4, "psum"),
         ("qwen3-moe-6-experts", "qwen3-moe-6-experts", 0.01, 1, 16,
          "whole"),
         ("olmo-1b-accum4", "olmo-1b", 0.01, 4, 16, None),
         ("qwen3-8b", "qwen3-8b", 0.01, 1, 16, None),
         ("qwen1.5-4b-6-heads", "qwen1.5-4b-6-heads", 0.01, 1, 16, None),
         ("llama-3.2-vision-11b", "llama-3.2-vision-11b", 0.01, 1, 16, None),
         ("hubert-xlarge", "hubert-xlarge", 0.01, 1, 16, None),
         ("jamba-1.5-large-398b", "jamba-1.5-large-398b", 0.0, 1, 16, "a2a"))
# the steps also held to the JAX package's single-device step
JAX_STEPS = ("olmo-1b", "qwen3-moe-30b-a3b", "olmo-1b-accum4", "qwen3-8b",
             "qwen1.5-4b-6-heads", "llama-3.2-vision-11b", "hubert-xlarge",
             "jamba-1.5-large-398b")
EP_AUX = tuple(s for s in STEPS if s[2] and s[5] == "a2a")
# the launcher's sharded init: a dense, an MoE, a recurrent and a hybrid
# arch (compression on, so the error-feedback buffers too)
INIT_ARCHS = ("olmo-1b", "qwen3-moe-30b-a3b", "xlstm-350m",
              "jamba-1.5-large-398b")
G_ATOL, G_RTOL = 1e-5, 1e-4   # tests/test_torch_training.py's
TIMEOUT_S = 300

WORKER = textwrap.dedent('''
    import dataclasses, datetime, json, sys

    import numpy as np
    import torch
    import torch.distributed as dist


    STEPS, CFGS, INIT_ARCHS = %r, %r, %r


    def main(rank, world, tmp):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{tmp}/pg",
                                rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=120))
        from torch.distributed.tensor import DTensor, Replicate, distribute_tensor
        from repro_torch import configs
        from repro_torch.configs import Shape
        from repro_torch.distributed import collectives as col
        from repro_torch.distributed import elastic, sharding as shd
        from repro_torch.distributed.context import hint, use_rules
        from repro_torch.launch.mesh import make_mesh
        from torch.utils.flop_counter import FlopCounterMode
        from repro_torch.models import moe, moe_sharded, transformer
        from repro_torch.models.transformer import tree_leaves
        from repro_torch.training import (DataConfig, TokenDataset,
                                          TrainConfig, checkpoint,
                                          init_train_state, make_train_step)
        mesh = make_mesh((2, 4), ("data", "model"), "cpu")
        dm = mesh.device_mesh
        out = {}

        # which of apply_moe's branches each step takes
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

        # the shapes of the leaves self-attention (wq) and the MLP (w_in)
        # compute on
        used = {}

        def recording(fn, leaf):
            def g(x, p, *a):
                used.setdefault(leaf, set()).add(tuple(p[leaf].shape))
                return fn(x, p, *a)
            return g
        init, pre, dec, fwd = transformer._MIXERS["attn"]
        transformer._MIXERS["attn"] = (init, pre, dec, recording(fwd, "wq"))
        transformer.apply_mlp = recording(transformer.apply_mlp, "w_in")

        # one sharded train step from the test's weights
        for name, key, aux_weight, grad_accum, seq, _ in STEPS:
            arch, over = CFGS[key]
            cfg = dataclasses.replace(configs.get_tiny_config(arch),
                                      capacity_factor=16.0, **over)
            tcfg = TrainConfig(remat="none", aux_weight=aux_weight,
                               grad_accum=grad_accum)
            shapes = dict(zip(("params", "opt"), init_train_state(
                cfg, tcfg, generator=torch.Generator(), device="meta")))
            _, state = checkpoint.load(
                f"{tmp}/{key}", mesh=mesh,
                placements=elastic.state_placements(shapes, cfg, mesh))
            batch = TokenDataset(DataConfig(seq_len=seq, global_batch=8),
                                 cfg).batch_at(0)
            rules = shd.logical_rules(cfg, Shape("t", "train", seq, 8), mesh)
            paths.clear()
            used.clear()
            with use_rules(mesh, rules), FlopCounterMode(display=False) as fc:
                p, o, m = make_train_step(cfg, tcfg)(
                    state["params"], state["opt"], batch)
            checkpoint.save(f"{tmp}/{name}_step", 1, {"params": p, "opt": o})
            out[name] = {"loss": float(m["loss"]),
                         "grad_norm": float(m["grad_norm"]),
                         "paths": dict(paths),
                         "flops": fc.get_total_flops(),
                         "shapes": {k: sorted(v) for k, v in used.items()},
                         "dtensors": all(isinstance(x, DTensor) for x in
                                         tree_leaves({"p": p, "o": o["m"]}))}

        # elastic: the olmo-1b state from (2, 4) onto (1, 2)
        cfg = configs.get_tiny_config("olmo-1b")
        _, whole = checkpoint.load(f"{tmp}/olmo-1b_step")
        s8 = elastic.reshard(whole, cfg, mesh)
        m2 = make_mesh((1, 2), ("data", "model"), "cpu")
        plan = elastic.plan(s8, cfg, mesh, m2, hbm_bytes=16 * 1024 ** 3)
        s2 = elastic.reshard(s8, cfg, m2)
        if m2.device_mesh.get_coordinate() is not None:
            d = max(float((elastic.full_value(x) - w).abs().max())
                    for x, w in zip(tree_leaves(s2), tree_leaves(whole)))
            out["reshard"] = {"d": d, "n_from": plan.n_from,
                              "n_to": plan.n_to, "fits": plan.fits,
                              "grew": plan.bytes_per_device_to >
                              plan.bytes_per_device_from,
                              "local_rows": s2["params"]["embed"]["table"]
                              .to_local().shape[0]}

        # the three MoE dispatch paths on drop-free inputs, with gradients
        paths.clear()
        cfg = dataclasses.replace(
            configs.get_tiny_config("phi3.5-moe-42b-a6.6b"),
            capacity_factor=16.0)
        rng = np.random.default_rng(0)
        d_, f_, e_ = cfg.d_model, cfg.d_ff, cfg.n_experts
        w = {"router": rng.standard_normal((d_, e_)) * d_ ** -0.5,
             "w_in": rng.standard_normal((e_, d_, f_)) * d_ ** -0.5,
             "w_gate": rng.standard_normal((e_, d_, f_)) * d_ ** -0.5,
             "w_out": rng.standard_normal((e_, f_, d_)) * f_ ** -0.5}
        w = {k: torch.tensor(v, dtype=torch.float32) for k, v in w.items()}
        place = shd.param_placements({"ffn": w}, cfg, mesh)["ffn"]
        rules = {"experts": "model", "batch": ("data",)}
        out["moe"] = {}
        for t, which in ((64, "a2a"), (6, "psum"), (1, "psum")):
            x = torch.tensor(rng.standard_normal((t, d_)), dtype=torch.float32)
            cot = torch.tensor(rng.standard_normal((t, d_)),
                               dtype=torch.float32)
            xr = x.clone().requires_grad_(True)
            wr = {k: v.clone().requires_grad_(True) for k, v in w.items()}
            ref, _ = moe.moe_ffn(xr, wr, cfg)
            (ref * cot).sum().backward()
            xs = x.clone().requires_grad_(True)
            ws = {k: distribute_tensor(v, dm, place[k]).requires_grad_(True)
                  for k, v in w.items()}
            with use_rules(mesh, rules) as ctx:
                if which == "a2a":
                    ok = moe_sharded.sharded_applicable(cfg, ctx, t)
                    got, _ = moe_sharded.moe_ffn_sharded(xs, ws, cfg, ctx)
                else:
                    ok = moe_sharded.psum_applicable(cfg, ctx, t)
                    got, _ = moe_sharded.moe_ffn_psum(xs, ws, cfg, ctx)
            (got * cot).sum().backward()
            # every process differentiated the same loss: each gradient is
            # the world's sum, over its shards and its copies
            gx = xs.grad.clone()
            dist.all_reduce(gx)
            grads = {"x": (gx / world, xr.grad),
                     "out": (got.detach(), ref.detach())}
            for k in w:
                g = ws[k].grad
                col.sum_replicated(g.to_local(), g.placements, dm)
                grads[k] = (g.full_tensor() / world, wr[k].grad)
            out["moe"][f"{which}_{t}"] = {"applicable": bool(ok), **{
                k: float((a - b).abs().max() / max(1.0, float(b.abs().max())))
                for k, (a, b) in grads.items()}}

        # int8 compression quantizes each leaf's whole value (blocks of
        # 256 of the global array), whatever its shards
        from repro_torch.models.transformer import tree_map
        from repro_torch.training import compression
        cfg = configs.get_tiny_config("olmo-1b")
        shapes = init_train_state(cfg, TrainConfig(), device="meta",
                                  generator=torch.Generator())[0]
        gen = torch.Generator().manual_seed(3)
        g = tree_map(lambda x: torch.randn(x.shape, generator=gen), shapes)
        e = tree_map(lambda x: 1e-3 * torch.randn(x.shape, generator=gen),
                     shapes)
        place = shd.param_placements(shapes, cfg, mesh)
        got = compression.compress_with_feedback(
            elastic.distribute(g, place, mesh),
            elastic.distribute(e, place, mesh))
        ref = compression.compress_with_feedback(g, e)
        out["int8_equal"] = all(
            torch.equal(elastic.full_value(a), b)
            for a, b in zip(tree_leaves(list(got)), tree_leaves(list(ref))))

        # hint re-places a DTensor per the rules, replicating a dim that
        # does not divide
        with use_rules(mesh, {"batch": "data"}):
            odd = hint(distribute_tensor(torch.ones(3, 4), dm,
                                         [Replicate()] * 2), "batch", None)
            even = hint(distribute_tensor(torch.ones(4, 4), dm,
                                          [Replicate()] * 2), "batch", None)
            plain = torch.ones(4, 4)
            out["hint"] = {"odd": [str(p) for p in odd.placements],
                           "even": [str(p) for p in even.placements],
                           "even_local": list(even.to_local().shape),
                           "plain_unchanged": hint(plain, "batch", None)
                           is plain}
        # the launcher's seeded init, each leaf placed as it is drawn,
        # against the whole state drawn and then resharded
        out["init"] = {}
        for arch in INIT_ARCHS:
            cfg = configs.get_tiny_config(arch)
            tcfg = TrainConfig(compress_grads=True)
            got, ref = (dict(zip(("params", "opt"), init_train_state(
                cfg, tcfg, generator=torch.Generator().manual_seed(0),
                device="cpu", place=place))) for place in (
                    elastic.placer(cfg, mesh), None))
            ref = elastic.reshard(ref, cfg, mesh)
            bad = torch.zeros(3, dtype=torch.int64)   # differ, storage, sharded
            pairs = list(zip(tree_leaves(got), tree_leaves(ref)))
            for a, b in pairs:
                if isinstance(b, DTensor):
                    la, lb = a.to_local(), b.to_local()
                    bad[0] += not (a.placements == b.placements
                                   and a.shape == b.shape
                                   and torch.equal(la, lb))
                    bad[1] += la.untyped_storage().nbytes() != la.nbytes
                    bad[2] += any(p.is_shard() for p in a.placements)
                else:
                    bad[0] += isinstance(a, DTensor) or not torch.equal(a, b)
            dist.all_reduce(bad)
            out["init"][arch] = {"leaves": len(pairs),
                                 "differ": int(bad[0]),
                                 "larger_storage": int(bad[1]),
                                 "sharded_leaves": int(bad[2]) // world}
        if rank == 0:
            with open(f"{tmp}/result.json", "w") as fh:
                json.dump(out, fh)
        dist.destroy_process_group()


    if __name__ == "__main__":
        import torch.multiprocessing as mp
        mp.start_processes(main, args=(8, sys.argv[1]), nprocs=8,
                           start_method="spawn")
''' % (STEPS, CFGS, INIT_ARCHS))

# the JAX package's sharded step on a (2, 4) mesh of eight virtual CPU
# devices, from its own seeded init (the weights the fixture saves)
JAX_WORKER = textwrap.dedent('''
    import dataclasses, json, sys

    import jax
    import numpy as np

    from repro import configs
    from repro.configs import Shape
    from repro.distributed import sharding as shd
    from repro.distributed.context import use_rules
    from repro.launch.mesh import make_mesh
    from repro.training import TrainConfig, init_train_state, make_train_step
    from repro.training.data import DataConfig, TokenDataset

    mesh = make_mesh((2, 4), ("data", "model"))
    out = {}
    STEPS, CFGS = %r, %r
    for name, key, aux_weight, grad_accum, seq, _ in STEPS:
        arch, over = CFGS[key]
        cfg = dataclasses.replace(configs.get_tiny_config(arch),
                                  capacity_factor=16.0, **over)
        tcfg = TrainConfig(remat="none", aux_weight=aux_weight,
                           grad_accum=grad_accum)
        batch = TokenDataset(DataConfig(seq_len=seq, global_batch=8),
                             cfg).batch_at(0)
        params, opt = init_train_state(jax.random.PRNGKey(0), cfg, tcfg)
        with use_rules(mesh, shd.logical_rules(
                cfg, Shape("t", "train", seq, 8), mesh)):
            spec = shd.param_specs(jax.tree.map(
                lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), params),
                cfg, mesh)
            params = jax.tree.map(jax.device_put, params,
                                  shd.as_shardings(spec, mesh))
            p, o, m = jax.jit(make_train_step(cfg, tcfg))(params, opt,
                                                          batch)
        leaves = jax.tree.leaves({"p": p, "m": o["m"], "v": o["v"]})
        np.savez(f"{sys.argv[1]}/jax_{name}.npz",
                 *[np.asarray(x) for x in leaves])
        out[name] = {"loss": float(m["loss"]),
                     "grad_norm": float(m["grad_norm"])}
    with open(f"{sys.argv[1]}/jax_result.json", "w") as fh:
        json.dump(out, fh)
''' % (EP_AUX, CFGS))


def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")


def _cfgs(key):
    """The tiny config at drop-free capacity in both packages."""
    arch, over = CFGS[key]
    return (dataclasses.replace(jconfigs.get_tiny_config(arch),
                                capacity_factor=16.0, **over),
            dataclasses.replace(configs.get_tiny_config(arch),
                                capacity_factor=16.0, **over))


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    """The JAX package's initial weights of each config, saved as the
    port's checkpoints; then the eight-process jobs and, beside them, the
    JAX package's sharded steps.  Returns the directory, the jobs'
    results and the weights (numpy trees)."""
    tmp = tmp_path_factory.mktemp("mesh")
    (tmp / "jax_worker.py").write_text(JAX_WORKER)
    jax_run = subprocess.Popen(
        [sys.executable, str(tmp / "jax_worker.py"), str(tmp)],
        env=dict(_env(), JAX_PLATFORMS="cpu",
                 XLA_FLAGS="--xla_force_host_platform_device_count=8"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        weights = {}
        for key in CFGS:
            jcfg, cfg = _cfgs(key)
            params, _ = j_init_train_state(jax.random.PRNGKey(0), jcfg,
                                           JTrainConfig(remat="none"))
            weights[key] = jax.tree.map(np.asarray, params)
            p = params_from_numpy(weights[key], "cpu")
            checkpoint.save(str(tmp / key), 0, {
                "params": p, "opt": init_opt_state(p, TrainConfig().opt)})
        (tmp / "worker.py").write_text(WORKER)
        r = subprocess.run([sys.executable, str(tmp / "worker.py"),
                            str(tmp)], env=_env(), capture_output=True,
                           text=True, timeout=TIMEOUT_S)
        assert r.returncode == 0, r.stderr[-3000:]
        _, err = jax_run.communicate(timeout=TIMEOUT_S)
        assert jax_run.returncode == 0, err[-3000:]
    finally:
        jax_run.kill()
        jax_run.wait()
    res = json.loads((tmp / "result.json").read_text())
    res["jax"] = json.loads((tmp / "jax_result.json").read_text())
    return tmp, res, weights


def _sharded_step(tmp, name):
    _, state = checkpoint.load(str(tmp / f"{name}_step"))
    return state


@pytest.mark.parametrize("name,key,aux_weight,grad_accum,seq,path", STEPS,
                         ids=[s[0] for s in STEPS])
def test_sharded_train_step_matches_single_process(mesh_run, name, key,
                                                   aux_weight, grad_accum,
                                                   seq, path):
    """One step on the (2, 4) mesh of eight processes (parameters and
    moments DTensors, rows split over 'data', dense layers over 'model',
    the MoE through the branch of ``apply_moe`` the step names) equals
    the port's single-process step from the same weights: parameters and
    moments within 1e-6.  With the all_to_all path's load-balance loss on, its EP
    value (per shard, as the reference's) moves every gradient and so the
    moments: the loss agrees within the reference's 5e-2, and the
    parameters within 1e-6 where the single process's gradient is large
    (``test_train_step_matches_jax``'s rule: AdamW's first step moves a
    weight by lr times its gradient's sign), within 2 lr elsewhere
    (``test_sharded_step_with_ep_aux_matches_jax_sharded`` holds those
    steps to the JAX package's sharded step); the same step without that
    loss, and the psum and whole-weight branches with it, hold everything
    to 1e-6."""
    tmp, res, weights = mesh_run
    _, cfg = _cfgs(key)
    tcfg = TrainConfig(remat="none", aux_weight=aux_weight,
                       grad_accum=grad_accum)
    p = params_from_numpy(weights[key], "cpu")
    batch = TokenDataset(DataConfig(seq_len=seq, global_batch=8),
                         cfg).batch_at(0)
    p1, o1, m1 = make_train_step(cfg, tcfg)(p, init_opt_state(p, tcfg.opt),
                                            batch)
    got = _sharded_step(tmp, name)
    assert res[name]["dtensors"]
    # every MoE layer of every microbatch took the named branch
    n_moe = sum(f == "moe" for _, f in cfg.block_pattern) * cfg.n_periods
    assert res[name]["paths"] == ({path: n_moe * grad_accum} if path
                                  else {}), res[name]
    ep_aux = bool(aux_weight) and path == "a2a"
    assert abs(res[name]["loss"] - float(m1["loss"])) < \
        (5e-2 if ep_aux else 1e-5), res[name]
    assert int(got["opt"]["step"]) == 1
    if not ep_aux:      # the moments are 0.1 g and 0.05 g^2
        # each distinct shard counted once in the norm
        assert res[name]["grad_norm"] == pytest.approx(
            float(m1["grad_norm"]), rel=1e-5)
        for a, b in zip(tree_leaves(got["opt"]), tree_leaves(o1)):
            assert float((a - b).abs().max()) < 1e-6
    _, _, grads = make_grad_fn(cfg, tcfg)(p, batch)
    lr = float(m1["lr"])
    for a, b, g in zip(tree_leaves(got["params"]), tree_leaves(p1),
                       tree_leaves(grads)):
        d = (a - b).abs()
        if ep_aux:      # 2 lr, and the rounding of each new weight
            assert bool((d <= 2 * lr * (1 + 1e-5) + 2 ** -22 * b.abs())
                        .all())
            d = d[g.abs() > 100 * (G_ATOL + G_RTOL * g.abs())]
        assert float(d.max()) < 1e-6


@pytest.mark.parametrize("name,key,aux_weight,grad_accum,seq,path", EP_AUX,
                         ids=[s[0] for s in EP_AUX])
def test_sharded_step_with_ep_aux_matches_jax_sharded(mesh_run, name, key,
                                                      aux_weight, grad_accum,
                                                      seq, path):
    """The steps whose MoE load-balance loss is computed per shard (the
    all_to_all path, in one batch and in 4 microbatches) against the JAX
    package's own sharded step on a (2, 4) mesh of virtual devices, which
    computes the same per-shard loss over the same tokens: the loss and
    grad norm within 1e-5 relative, each gradient (the first moment over
    1 - b1) within tests/test_torch_training.py's gradient tolerance, the
    second moment and the new parameters within 1e-6."""
    tmp, res, _ = mesh_run
    ref = res["jax"][name]
    assert res[name]["loss"] == pytest.approx(ref["loss"], rel=1e-5)
    assert res[name]["grad_norm"] == pytest.approx(ref["grad_norm"],
                                                   rel=1e-5)
    got = _sharded_step(tmp, name)
    b1 = TrainConfig().opt.b1
    with np.load(tmp / f"jax_{name}.npz") as z:
        jleaves = [z[f"arr_{i}"] for i in range(len(z.files))]
    leaves = tree_leaves({"p": got["params"], "m": got["opt"]["m"],
                          "v": got["opt"]["v"]})
    n = len(leaves) // 3          # m, p, v in JAX's sorted order
    assert len(jleaves) == len(leaves)
    for i, (a, b) in enumerate(zip(leaves, jleaves)):
        a, b = a.numpy().astype(np.float64), b.astype(np.float64)
        if i < n:                 # first moments: (1 - b1) g
            g, gj = a / (1 - b1), b / (1 - b1)
            assert np.all(np.abs(g - gj) <= G_ATOL + G_RTOL * np.abs(gj)), \
                (i, float(np.abs(g - gj).max()))
        else:
            assert float(np.abs(a - b).max()) < 1e-6, i


@pytest.mark.parametrize("name,key,aux_weight,grad_accum,seq,path",
                         [s for s in STEPS if s[0] in JAX_STEPS],
                         ids=[s[0] for s in STEPS if s[0] in JAX_STEPS])
def test_sharded_train_step_matches_jax(mesh_run, name, key, aux_weight,
                                        grad_accum, seq, path):
    """The same step against the JAX package's single-device step, within
    the reference's own bounds (tests/test_distributed_integration.py:
    loss 5e-2, parameters 5e-3)."""
    tmp, res, weights = mesh_run
    jcfg, cfg = _cfgs(key)
    jtcfg = JTrainConfig(remat="none", aux_weight=aux_weight,
                         grad_accum=grad_accum)
    _, jopt = j_init_train_state(jax.random.PRNGKey(0), jcfg, jtcfg)
    batch = TokenDataset(DataConfig(seq_len=seq, global_batch=8),
                         cfg).batch_at(0)
    params = jax.tree.map(jnp.asarray, weights[key])
    jp, _, jm = jax.jit(j_make_train_step(jcfg, jtcfg))(
        params, jopt, jax.tree.map(jnp.asarray, batch))
    assert abs(res[name]["loss"] - float(jm["loss"])) < 5e-2
    got = tree_leaves(_sharded_step(tmp, name)["params"])
    d = max(float(np.abs(a.numpy().astype(np.float64) -
                         np.asarray(b, np.float64)).max())
            for a, b in zip(got, jax.tree.leaves(jp)))
    assert d < 5e-3, d


def test_dense_layers_split_over_model(mesh_run):
    """Each 'model' process computes its shard of the dense layers: in the
    olmo-1b step self-attention and the MLP compute on (D, H/4, Dh) and
    (D, F/4) leaves, and in the olmo-1b-accum4 step (a microbatch's 2
    rows, one on each 'data' process and the same on its 4 'model'
    processes) a process counts about 1/8 of the single-process step's
    FLOPs, where whole leaves on those rows would count 1/2."""
    _, res, weights = mesh_run
    _, cfg = _cfgs("olmo-1b")
    d, h, dh, f = cfg.d_model, cfg.n_heads, cfg.d_head, cfg.d_ff
    assert res["olmo-1b"]["shapes"] == {"wq": [[d, h // 4, dh]],
                                        "w_in": [[d, f // 4]]}
    tcfg = TrainConfig(remat="none", grad_accum=4)
    p = params_from_numpy(weights["olmo-1b"], "cpu")
    batch = TokenDataset(DataConfig(seq_len=16, global_batch=8),
                         cfg).batch_at(0)
    with FlopCounterMode(display=False) as fc:
        make_train_step(cfg, tcfg)(p, init_opt_state(p, tcfg.opt), batch)
    ratio = res["olmo-1b-accum4"]["flops"] / fc.get_total_flops()
    assert abs(ratio - 1 / 8) < 0.01, ratio


def test_elastic_reshard_between_meshes(mesh_run):
    """Resharding from 8 processes to 2 is lossless, and the planner sees
    the bytes per device grow."""
    _, res, _ = mesh_run
    r = res["reshard"]
    assert r["d"] == 0.0
    assert (r["n_from"], r["n_to"]) == (8, 2)
    assert r["grew"] and r["fits"]
    # the embedding table (vocab over 'model') keeps half its rows
    assert r["local_rows"] == configs.get_tiny_config("olmo-1b").vocab_size // 2


@pytest.mark.parametrize("case", ["a2a_64", "psum_6", "psum_1"])
def test_moe_paths_numerically_identical(mesh_run, case):
    """The local scatter, the all_to_all and the psum dispatch give the
    same outputs and gradients (x, router, w_in, w_gate, w_out) on
    drop-free inputs, within 1e-5 of the largest magnitude (at least 1)."""
    _, res, _ = mesh_run
    r = dict(res["moe"][case])
    assert r.pop("applicable")
    assert set(r) == {"out", "x", "router", "w_in", "w_gate", "w_out"}
    assert all(v < 1e-5 for v in r.values()), r


def test_compression_quantizes_whole_leaves(mesh_run):
    """``--compress-grads`` on DTensor gradients gives, bit for bit, the
    int8 result and error feedback of the whole leaves (a leaf sharded
    over dims other than its first would group other blocks of 256 if
    its shards were quantized apart)."""
    _, res, _ = mesh_run
    assert res["int8_equal"]


def test_hint_divisibility_guard_on_a_mesh(mesh_run):
    """``hint`` re-places a DTensor to the rules' placements, replicates a
    dimension the mesh axis does not divide (3 rows over 2), and passes a
    plain tensor through."""
    _, res, _ = mesh_run
    h = res["hint"]
    assert h["odd"] == ["R", "R"]
    assert h["even"] == ["S(0)", "R"] and h["even_local"] == [2, 4]
    assert h["plain_unchanged"]


@pytest.mark.parametrize("arch", INIT_ARCHS)
def test_sharded_init_matches_reshard(mesh_run, arch):
    """The launcher's init (``elastic.placer``: each leaf placed as it is
    drawn, the moments and error feedback made as shards) gives every one
    of the 8 processes, bit for bit, the shards and placements that
    drawing the whole state from the same seed and ``reshard``-ing it
    gives; every local tensor's storage holds its own bytes and no more
    (no view of a whole leaf survives)."""
    _, res, _ = mesh_run
    r = res["init"][arch]
    assert r["differ"] == 0 and r["larger_storage"] == 0, r
    assert r["sharded_leaves"] > 0, r


def test_sharded_init_peak_on_fake_tensors():
    """The dry-run's reckoning of the launcher's init of full-width
    qwen3-8b (f32 state of 98.3 GB) on one rank of a fake (1, 4) mesh, on
    fake tensors: the peak stays within this rank's shards (24.6 GB) and
    the largest whole leaf; drawing the whole state and then resharding,
    as the launcher did before, peaks above the whole state."""
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen3-8b", "--init-memory", "1", "4", "--device", "cpu"],
        env=_env(), capture_output=True, text=True, timeout=TIMEOUT_S)
    assert r.returncode == 0, r.stderr[-3000:]
    sharded, whole = json.loads(r.stdout.splitlines()[-1])["init_memory"]
    print(sharded, whole)
    assert sharded["sharded"] and not whole["sharded"]
    assert sharded["local"] == whole["local"]
    assert abs(sharded["local"] / 1e9 - 24.57) < 0.01
    assert abs(sharded["whole"] / 1e9 - 98.29) < 0.01
    assert sharded["local"] <= sharded["peak"] <= (
        sharded["local"] + sharded["largest_leaf"])
    assert whole["peak"] > whole["whole"]


def _launch(args, tmp_path, procs=None):
    cmd = [sys.executable]
    if procs:
        cmd += ["-m", "torch.distributed.run", "--standalone",
                "--nproc-per-node", str(procs)]
    cmd += ["-m", "repro_torch.launch.train", "--arch", "olmo-1b", "--tiny",
            "--device", "cpu", *args]
    r = subprocess.run(cmd, cwd=tmp_path, env=_env(), capture_output=True,
                       text=True, timeout=TIMEOUT_S)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout


def test_launcher_resumes_elastically_on_fewer_processes(tmp_path):
    """Three steps under ``torch.distributed.run`` on two processes ((1, 2)
    mesh: the same rows on both, the dense layers split over 'model'),
    checkpointed; the same checkpoint
    resumed on one process prints the reference's elastic line and
    finishes five steps within 1e-6 of an uninterrupted one-process
    run."""
    ckpt, ref = str(tmp_path / "ckpt"), str(tmp_path / "ref")
    out = _launch(["--steps", "3", "--ckpt-dir", ckpt], tmp_path, procs=2)
    assert "2 device(s)" in out and checkpoint.latest_step(ckpt) == 3
    out = _launch(["--steps", "5", "--ckpt-dir", ckpt], tmp_path)
    assert out.startswith("elastic-resumed step 3 onto 1-device mesh")
    _launch(["--steps", "5", "--ckpt-dir", ref], tmp_path)
    _, a = checkpoint.load(ckpt, 5)
    _, b = checkpoint.load(ref, 5)
    assert int(a["opt"]["step"]) == int(b["opt"]["step"]) == 5
    d = max(float((x - y).abs().max()) for x, y in zip(tree_leaves(a),
                                                       tree_leaves(b)))
    assert d < 1e-6, d


def test_launcher_mesh_host_is_bit_exact():
    """On one process the launcher's ``--mesh host`` path (a gloo world of
    one, a (1, 1) mesh, DTensor state, every collective called) gives the
    meshless ``make_train_step``'s parameters and moments bit for bit."""
    args = launcher.parse_args(
        ["--arch", "olmo-1b", "--tiny", "--device", "cpu", "--steps", "2",
         "--global-batch", "4", "--grad-accum", "2", "--remat", "full"])
    run = launcher.setup(args)
    assert run.mesh.devices.shape == (1, 1)
    start, state = launcher.init_or_resume(run, args)
    launcher.train(run, args, state, start)
    p, o = init_train_state(run.cfg, run.tcfg,
                            generator=torch.Generator().manual_seed(0),
                            device="cpu")
    for i in range(2):
        p, o, _ = make_train_step(run.cfg, run.tcfg)(p, o,
                                                     run.data.batch_at(i))
    got = tree_leaves({"p": state["params"], "m": state["opt"]["m"],
                       "v": state["opt"]["v"]})
    ref = tree_leaves({"p": p, "m": o["m"], "v": o["v"]})
    assert all(torch.equal(a.to_local(), b) for a, b in zip(got, ref))
