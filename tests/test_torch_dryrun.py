"""The port's dry-run (``repro_torch.launch.dryrun``, with
``launch/op_count.py``'s counts) against the reference's
(``repro/launch/dryrun.py``).

Every cell runs in a subprocess, as tests/test_distributed_integration.py
runs the reference's, so the fake process group never becomes this
process's default group: one subprocess traces the cells the tests below
read (the contract cell, olmo-1b ``train_4k`` at grad_accum 1 and 4, and
tiny steps on a (2, 4) fake mesh); another spawns eight gloo processes on
a real (2, 4) mesh and counts the collectives those steps issue.  Only the
cell configuration (``deploy_overrides``, ``applicable``,
``train_config_for``) runs here, against the reference's functions
called directly.
"""
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro import configs as jconfigs
from repro_torch import configs
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.context import ShapeMesh
from repro_torch.launch import dryrun
from repro_torch.models.transformer import tree_leaves
from repro_torch.training import TrainConfig, init_train_state

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 300
MESHES = {"single": ShapeMesh((16, 16), ("data", "model")),
          "multi": ShapeMesh((2, 16, 16), ("pod", "data", "model"))}
# the steps of tests/test_torch_distributed.py's eight-process job whose
# collectives are counted: (name, arch, overrides, TrainConfig fields);
# tiny olmo-1b, tiny qwen3-moe through the all_to_all path, and the
# tensor-parallel paths of GQA with replicated KV weights (qwen3-8b),
# sequence-parallel attention (six heads over 4) and Mamba's channels
# beside an MoE (jamba)
STEPS = (("olmo-1b", "olmo-1b", {}, {"remat": "none"}),
         ("qwen3-moe-30b-a3b", "qwen3-moe-30b-a3b", {}, {"remat": "none"}),
         ("olmo-1b-accum4", "olmo-1b", {}, {"remat": "none",
                                            "grad_accum": 4}),
         ("qwen3-8b", "qwen3-8b", {}, {"remat": "none"}),
         ("qwen1.5-4b-6-heads", "qwen1.5-4b", {"n_heads": 6, "n_kv_heads": 6},
          {"remat": "none"}),
         ("jamba-1.5-large-398b", "jamba-1.5-large-398b", {},
          {"remat": "none"}))
STEP_SEQ, STEP_BATCH = 16, 8
# grad_accum 4 against 1 at the olmo-1b train_4k cell: a microbatch's rows
# split over 'data' and its dense layers over 'model', so each rank
# computes about the same FLOPs in four microbatches as in one
ACCUM4_FACTOR = (0.9, 1.15)

CELLS = textwrap.dedent('''
    import dataclasses, json, os, sys
    import torch
    from repro_torch import configs
    from repro_torch.configs import Shape
    from repro_torch.launch import dryrun
    from repro_torch.training import TrainConfig

    STEPS, SEQ, BATCH = %r, %r, %r
    out = {}
    r = dryrun.run_cell("xlstm-350m", "long_500k", multi_pod=False,
                        verbose=False, device="cpu")
    out["contract"] = {"status": r["status"], "fits": r["fits_hbm"],
                       "has_flops": r["flops_per_device"] > 0,
                       "chips": r["n_chips"]}
    out["xlstm"] = r
    os.environ["REPRO_GRAD_ACCUM"] = "1"
    out["olmo_ga1"] = dryrun.run_cell("olmo-1b", "train_4k", False,
                                      verbose=False, device="cpu")
    out["olmo2_ga1"] = dryrun.run_cell("olmo-1b", "train_4k", False,
                                       verbose=False, device="cpu",
                                       cfg_overrides={"n_layers": 2})
    del os.environ["REPRO_GRAD_ACCUM"]
    out["olmo2_ga4"] = dryrun.run_cell("olmo-1b", "train_4k", False,
                                       verbose=False, device="cpu",
                                       cfg_overrides={"n_layers": 2})
    for shape in ("prefill", "decode"):
        out[f"olmo2_{shape}"] = dryrun.run_cell(
            "olmo-1b", f"{shape}_32k", False, verbose=False, device="cpu",
            cfg_overrides={"n_layers": 2})
    # the command line on both meshes in one process, then resumed
    path = sys.argv[1]
    argv = ["--arch", "xlstm-350m", "--shape", "long_500k", "--mesh", "both",
            "--device", "cpu", "--out", path]
    dryrun.main(argv)
    with open(path) as fh:
        out["main"] = json.load(fh)
    dryrun.main(argv)
    out["steps"] = {}
    with dryrun.fake_mesh((2, 4), ("data", "model"), "cpu") as mesh:
        for name, arch, over, tkw in STEPS:
            cfg = dataclasses.replace(configs.get_tiny_config(arch),
                                      capacity_factor=16.0, **over)
            out["steps"][name] = dryrun.trace_step(
                cfg, Shape("t", "train", SEQ, BATCH), mesh,
                tcfg=TrainConfig(**tkw), dtype=torch.float32, device="cpu",
                by_label=True)
    print(json.dumps(out))
''' % (STEPS, STEP_SEQ, STEP_BATCH))

GLOO = textwrap.dedent('''
    import dataclasses, datetime, json, sys
    import torch
    import torch.distributed as dist

    STEPS, SEQ, BATCH = %r, %r, %r


    def main(rank, world, tmp):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{tmp}/pg",
                                rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=120))
        from repro_torch import configs
        from repro_torch.configs import Shape
        from repro_torch.distributed import collectives as col
        from repro_torch.distributed import elastic, sharding as shd
        from repro_torch.distributed.context import use_rules
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.training import (DataConfig, TokenDataset,
                                          TrainConfig, init_train_state,
                                          make_train_step)
        mesh = make_mesh((2, 4), ("data", "model"), "cpu")
        counts = {}

        # the four process-group calls collectives.py makes (its three
        # autograd Functions' and sum_replicated's), each with its result
        # buffer first
        def counted(kind, fn):
            def g(buf, *a, **k):
                c = counts.setdefault(kind, [0, 0])
                c[0] += 1
                c[1] += buf.nbytes
                return fn(buf, *a, **k)
            return g
        real = (col._all_gather_flat, col._reduce_scatter_flat,
                dist.all_to_all_single, dist.all_reduce)
        out = {}
        for name, arch, over, tkw in STEPS:
            cfg = dataclasses.replace(configs.get_tiny_config(arch),
                                      capacity_factor=16.0, **over)
            tcfg = TrainConfig(**tkw)
            params, opt = init_train_state(
                cfg, tcfg, generator=torch.Generator().manual_seed(0),
                device="cpu")
            state = elastic.reshard({"params": params, "opt": opt}, cfg,
                                    mesh)
            batch = TokenDataset(DataConfig(seq_len=SEQ, global_batch=BATCH),
                                 cfg).batch_at(0)
            rules = shd.logical_rules(cfg, Shape("t", "train", SEQ, BATCH),
                                      mesh)
            counts.clear()
            col._all_gather_flat = counted("all-gather", real[0])
            col._reduce_scatter_flat = counted("reduce-scatter", real[1])
            dist.all_to_all_single = counted("all-to-all", real[2])
            dist.all_reduce = counted("all-reduce", real[3])
            try:
                with use_rules(mesh, rules):
                    make_train_step(cfg, tcfg)(state["params"], state["opt"],
                                               batch)
            finally:
                (col._all_gather_flat, col._reduce_scatter_flat,
                 dist.all_to_all_single, dist.all_reduce) = real
            out[name] = dict(counts)
        if rank == 0:
            with open(f"{tmp}/counts.json", "w") as fh:
                json.dump(out, fh)
        dist.destroy_process_group()


    if __name__ == "__main__":
        import torch.multiprocessing as mp
        mp.start_processes(main, args=(8, sys.argv[1]), nprocs=8,
                           start_method="spawn")
''' % (STEPS, STEP_SEQ, STEP_BATCH))


def _env():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    env.pop("REPRO_GRAD_ACCUM", None)
    env.pop("REPRO_REMAT", None)
    return env


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both subprocesses, side by side: the traced cells' results and the
    gloo job's counts."""
    tmp = tmp_path_factory.mktemp("gloo")
    (tmp / "worker.py").write_text(GLOO)
    gloo = subprocess.Popen([sys.executable, str(tmp / "worker.py"),
                             str(tmp)], env=_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        r = subprocess.run([sys.executable, "-c", CELLS,
                            str(tmp / "dryrun.json")], env=_env(),
                           capture_output=True, text=True, timeout=TIMEOUT_S)
        assert r.returncode == 0, r.stderr[-3000:]
        _, err = gloo.communicate(timeout=TIMEOUT_S)
        assert gloo.returncode == 0, err[-3000:]
    finally:
        gloo.kill()
        gloo.wait()
    lines = r.stdout.strip().splitlines()
    cells = json.loads(lines[-1])
    cells["main_printed"] = lines[:-1]
    return cells, json.loads((tmp / "counts.json").read_text())


@pytest.fixture(scope="module")
def cells(runs):
    return runs[0]


@pytest.fixture(scope="module")
def gloo_counts(runs):
    return runs[1]


@pytest.fixture(scope="module")
def jdryrun():
    """The reference's dry-run module, imported without letting its
    ``XLA_FLAGS`` (512 host devices) reach this process's JAX."""
    old = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as mod
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return mod


def test_dryrun_cell_end_to_end(cells):
    """The twin of tests/test_distributed_integration.py's contract test:
    xlstm-350m x long_500k on the single-pod mesh."""
    assert cells["contract"] == {"status": "ok", "fits": True,
                                 "has_flops": True, "chips": 256}


def test_ok_cell_has_every_reference_key(cells):
    r = cells["xlstm"]
    for key in ("arch", "shape", "mesh", "n_chips", "status",
                "deploy_overrides", "compile_s", "flops_per_device",
                "flops_per_device_raw", "analytic_flops_per_device",
                "model_flops_global", "bytes_per_device_raw",
                "collective_bytes_per_device", "collective_bytes_raw",
                "collectives", "n_collectives", "memory", "fits_hbm"):
        assert key in r, key
    assert set(r["memory"]) == {"argument", "output", "temp", "peak"}
    # eager torch runs every loop iteration: nothing to correct
    assert r["flops_per_device_raw"] == r["flops_per_device"]
    assert r["collective_bytes_raw"] == r["collective_bytes_per_device"]
    assert r["collective_bytes_per_device"] == sum(r["collectives"].values())
    assert r["n_collectives"] == sum(r["collective_counts"].values())


def test_main_runs_both_meshes_and_resumes(cells):
    """``main --mesh both`` runs the single-pod and the multi-pod cell in
    one process (a fake group of 256, torn down, then one of 512); run
    again on its ``--out``, it runs nothing."""
    got = {k: (r["status"], r["n_chips"], r["mesh"])
           for k, r in cells["main"].items()}
    assert got == {"xlstm-350m|long_500k|single": ("ok", 256, "single"),
                   "xlstm-350m|long_500k|multi": ("ok", 512, "multi")}
    printed = cells["main_printed"]
    assert sum(line.startswith("cached: ") for line in printed) == 2
    assert sum("dry-run: 2 ok, 0 skipped, 0 errors" in line
               for line in printed) == 2


@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_cell_config_matches_reference(arch, jdryrun, monkeypatch):
    """Every (arch, shape) pair: the reference's deploy pads and
    applicability, a skipped cell's reason; ``train_config_for`` on both
    meshes, also with the reference's environment overrides."""
    for shape_name, jshape in jconfigs.SHAPES.items():
        jcfg = jconfigs.get_config(arch)
        pads = jdryrun.deploy_overrides(jcfg, jshape)
        ok, why = jconfigs.applicable(
            dataclasses.replace(jcfg, **pads) if pads else jcfg, jshape)
        cfg, applied, got_ok, got_why = dryrun.cell_config(arch, shape_name)
        assert (applied, got_ok, got_why) == (pads, ok, why), shape_name
        if not ok:
            assert dryrun.run_cell(arch, shape_name, False) == {
                "arch": arch, "shape": shape_name, "mesh": "single",
                "status": "skipped", "reason": why}
    for env in ({}, {"REPRO_GRAD_ACCUM": "2", "REPRO_REMAT": "dots"}):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        for mesh in MESHES.values():
            want = jdryrun.train_config_for(jconfigs.get_config(arch), mesh)
            got = dryrun.train_config_for(configs.get_config(arch), mesh)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_card_skips_serving_cells_that_run_kernels(arch, monkeypatch):
    """On fake ``cuda`` tensors no serving cell is skipped for its kernels
    any more (the launches are custom ops with fake implementations): a
    cell is skipped for the reference's reasons alone, and every runnable
    serving cell reaches its trace on the card's device.  The trace itself
    is stubbed here (this host's torch has no CUDA build); phase
    ``serve_sharded`` of ``chip_smoke.py`` runs serving cells on the card's
    fake tensors, and ``test_two_layer_serving_flops_match_the_analytic_count``
    traces them on the CPU's."""
    traced = []

    @contextlib.contextmanager
    def no_mesh(shape, axes, device="cuda"):
        yield MESHES["single"]

    def stub(cfg, shape, mesh, tcfg=None, device="cuda", **kw):
        traced.append((shape.name, device))
        return {"flops": 1.0, "bytes_accessed": 1, "collective_bytes": 0.0,
                "n_collectives": 0, "collective_counts": {}, "trace_s": 0.0,
                "memory": {"argument": 1, "output": 1, "temp": 0,
                           "peak": 1}}
    monkeypatch.setattr(dryrun, "fake_mesh", no_mesh)
    monkeypatch.setattr(dryrun, "trace_step", stub)
    for shape_name, shape in configs.SHAPES.items():
        if shape.kind == "train":
            continue
        _, _, ok, why = dryrun.cell_config(arch, shape_name)
        r = dryrun.run_cell(arch, shape_name, False, verbose=False,
                            device="cuda")
        if ok:
            assert r["status"] == "ok" and r["device"] == "cuda", r
            assert traced[-1] == (shape_name, "cuda")
        else:
            assert r == dict(arch=arch, shape=shape_name, mesh="single",
                             status="skipped", reason=why)


@pytest.mark.parametrize("cell", ["olmo2_prefill", "olmo2_decode"])
def test_two_layer_serving_flops_match_the_analytic_count(cells, cell):
    """The two-layer full-width olmo-1b prefill_32k and decode_32k cells on
    the 16x16 mesh count 0.9-1.3x the reference's analytic FLOPs per
    device: heads, d_ff and the vocabulary split over 'model', the rows
    over 'data', decode's cache positions over 'model' (each rank's
    block of 2048), where whole leaves on every rank once counted 16x.
    The attention kernels' FLOP formulas count what their plain versions
    compute, so this trace on the CPU's fake tensors counts what the
    card's does."""
    r = cells[cell]
    assert r["status"] == "ok", r
    ratio = r["flops_per_device"] / r["analytic_flops_per_device"]
    assert 0.9 <= ratio <= 1.3, ratio
    assert r["fits_hbm"]


def test_train_flops_match_the_analytic_count(cells):
    """olmo-1b x train_4k at grad_accum 1: 256 rows over 256 ranks, one
    each, so the counted FLOPs are the reference's analytic
    ``4 x forward / chips`` but for what ``arch_ops`` leaves out; the
    analytic numbers are the reference's formulas, to the last bit."""
    from repro.core import arch_ops as jarch_ops
    r = cells["olmo_ga1"]
    assert r["status"] == "ok" and r["grad_accum"] == 1
    ratio = r["flops_per_device"] / r["analytic_flops_per_device"]
    assert 1.0 <= ratio <= 1.03, ratio
    jcfg, shape = jconfigs.get_config("olmo-1b"), jconfigs.SHAPES["train_4k"]
    fwd = jarch_ops.flops(jcfg, shape.seq_len, shape.global_batch, "prefill")
    assert r["analytic_flops_per_device"] == 4.0 * fwd / 256
    assert r["model_flops_global"] == (6.0 * jcfg.active_param_count()
                                       * shape.global_batch * shape.seq_len)


def test_grad_accum_4_costs_what_grad_accum_1_costs(cells):
    """At the reference's own grad_accum 4 each rank computes about what
    it computes at grad_accum 1: a microbatch's 64 rows split over 'data'
    (4 a rank) and the 16 'model' ranks split its dense layers, where the
    port once had them repeat the same rows on whole leaves (a factor of
    16).  Two layers keep the test short; widths are full."""
    ga1, ga4 = cells["olmo2_ga1"], cells["olmo2_ga4"]
    assert (ga1["grad_accum"], ga4["grad_accum"]) == (1, 4)
    factor = ga4["flops_per_device"] / ga1["flops_per_device"]
    assert ACCUM4_FACTOR[0] <= factor <= ACCUM4_FACTOR[1], factor


@pytest.mark.parametrize("cell", ["olmo2_ga1", "olmo2_ga4"])
def test_two_layer_train_flops_match_the_analytic_count(cells, cell):
    """The two-layer full-width olmo-1b train_4k cell counts 0.9-1.1x the
    reference's analytic FLOPs per device, at grad_accum 1 and 4.  The
    analytic count is a prefill's four times over, whose unembedding
    covers the last position only; a train step unembeds every position
    (forward, the chunked CE's recompute, two products backward), which
    at two layers is a third of the step, so it is added to the count:
    four unembeddings of every position, less the prefill's one."""
    r = cells[cell]
    cfg, shape = configs.get_config("olmo-1b"), configs.SHAPES["train_4k"]
    unembed = 2.0 * shape.global_batch * cfg.d_model * cfg.vocab_size
    analytic = r["analytic_flops_per_device"] + 4 * unembed * (
        shape.seq_len - 1) / r["n_chips"]
    ratio = r["flops_per_device"] / analytic
    assert 0.9 <= ratio <= 1.1, ratio


@pytest.mark.parametrize("name", [s[0] for s in STEPS])
def test_fake_mesh_collectives_match_gloo(cells, gloo_counts, name):
    """On a (2, 4) mesh the fake step counts each kind of collective, and
    its result bytes, as the eight gloo processes issue them; the labelled
    FLOPs and bytes add up to the totals."""
    fake = cells["steps"][name]
    got = {k: [n, fake[f"coll_{k}"]]
           for k, n in fake["collective_counts"].items()}
    assert got == gloo_counts[name]
    arch = dict((s[0], s[1]) for s in STEPS)[name]
    kinds = {"all-gather", "reduce-scatter", "all-reduce"} | (
        {"all-to-all"} if configs.get_tiny_config(arch).is_moe else set())
    assert set(got) == kinds
    if len(fake["flops_by_label"]) < 25:
        assert sum(fake["flops_by_label"].values()) == fake["flops"]
    if len(fake["coll_by_label"]) < 25:
        assert sum(fake["coll_by_label"].values()) == \
            fake["collective_bytes"]


def test_argument_is_the_local_shards(cells):
    """``memory.argument`` of olmo-1b x train_4k is the local bytes of the
    bf16 parameters and f32 moments as ``param_specs`` shards them on the
    16x16 mesh, the step counter, and the whole int32 batch the step
    takes; the peak holds at least the arguments."""
    cfg = configs.get_config("olmo-1b")
    params, _ = init_train_state(cfg, TrainConfig(),
                                 generator=torch.Generator(),
                                 dtype=torch.bfloat16, device="meta")
    specs = shd.param_specs(params, cfg, MESHES["single"])
    local = 0
    for p, spec in zip(tree_leaves(params), tree_leaves(specs)):
        axes = tuple(a for dim in spec if dim for a in
                     ((dim,) if isinstance(dim, str) else dim))
        local += p.numel() // shd.axis_size(MESHES["single"], axes)
    batch = 2 * 256 * 4096 * 4
    mem = cells["olmo_ga1"]["memory"]
    assert mem["argument"] == local * (2 + 4 + 4) + 4 + batch
    assert mem["peak"] >= mem["argument"]
    assert mem["temp"] == mem["peak"] - mem["argument"]
