"""The port's checkpointing (``repro_torch.training.checkpoint``): the
torch twins of the 6 tests of tests/test_checkpoint.py (atomic publish,
bit-exact restart, pruning, async save, reload onto a device, a missing
checkpoint), the tree's nesting and dtypes kept, and the training
launcher's run and resume on the CPU."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.launch import train as launcher
from repro_torch.models.transformer import tree_leaves
from repro_torch.training import (DataConfig, TokenDataset, TrainConfig,
                                  checkpoint, init_train_state,
                                  make_train_step)

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]


def _train(params, opt, step_fn, data, start, n):
    for i in range(start, start + n):
        params, opt, _ = step_fn(params, opt, data.batch_at(i))
    return params, opt


def _init(cfg, tcfg):
    return init_train_state(cfg, tcfg, generator=torch.Generator()
                            .manual_seed(0), device="cpu")


def test_restart_is_bit_exact(tmp_path):
    """Crash after step 3, restore, continue → identical params and
    moments at step 6 as an uninterrupted 6-step run."""
    cfg = configs.get_tiny_config("olmo-1b")
    tcfg = TrainConfig(remat="none")
    data = TokenDataset(DataConfig(seq_len=16, global_batch=4), cfg)
    step_fn = make_train_step(cfg, tcfg)

    params, opt = _init(cfg, tcfg)
    p_ref, o_ref = _train(params, opt, step_fn, data, 0, 6)

    params, opt = _init(cfg, tcfg)
    params, opt = _train(params, opt, step_fn, data, 0, 3)
    checkpoint.save(str(tmp_path), 3, {"params": params, "opt": opt})
    del params, opt                                   # "node failure"

    step, state = checkpoint.load(str(tmp_path))
    assert step == 3
    p2, o2 = _train(state["params"], state["opt"], step_fn, data, 3, 3)
    for a, b in zip(tree_leaves({"p": p_ref, "o": o_ref}),
                    tree_leaves({"p": p2, "o": o2})):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_atomic_publish_never_leaves_tmp(tmp_path):
    state = {"x": torch.arange(10)}
    checkpoint.save(str(tmp_path), 1, state)
    entries = os.listdir(tmp_path)
    assert entries == ["step_0000000001"]


def test_prune_keeps_newest(tmp_path):
    state = {"x": torch.arange(4)}
    for s in range(5):
        checkpoint.save(str(tmp_path), s, state, keep=2)
    steps = sorted(os.listdir(tmp_path))
    assert steps == ["step_0000000003", "step_0000000004"]
    assert checkpoint.latest_step(str(tmp_path)) == 4


def test_async_save(tmp_path):
    """The snapshot is taken before ``save`` returns: changing the state
    afterwards does not change what is written."""
    state = {"x": torch.arange(100)}
    th = checkpoint.save(str(tmp_path), 7, state, blocking=False)
    state["x"].add_(1)
    th.join(timeout=60)
    assert not th.is_alive()
    step, loaded = checkpoint.load(str(tmp_path))
    assert step == 7 and torch.equal(loaded["x"], torch.arange(100))


def test_reload_onto_a_device(tmp_path):
    """The same checkpoint restores onto the device the restarted job
    names (the one-card counterpart of the reference's shardings)."""
    state = {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8)}
    checkpoint.save(str(tmp_path), 1, state)
    step, loaded = checkpoint.load(str(tmp_path), device=torch.device("cpu"))
    assert loaded["w"].device == torch.device("cpu")
    assert torch.equal(loaded["w"], state["w"])


def test_missing_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        checkpoint.load(str(tmp_path / "nope"))


def test_tree_dtypes_and_leaf_order_survive(tmp_path):
    """Nested dicts (an empty one included: a LayerNorm without parameters)
    and bf16, int32 and f32 leaves come back as they were; leaves are
    stored in ``jax.tree.leaves``' order and the tree as JSON, no pickle."""
    state = {"params": {"z": torch.randn(3, 2).to(torch.bfloat16),
                        "a": {"norm": {}, "w": torch.randn(4)}},
             "opt": {"step": torch.tensor(5, dtype=torch.int32)}}
    checkpoint.save(str(tmp_path), 2, state)
    d = tmp_path / "step_0000000002"
    assert sorted(os.listdir(d)) == ["leaf_0.npy", "leaf_1.npy",
                                     "leaf_2.npy", "meta.json"]
    meta = json.loads((d / "meta.json").read_text())
    assert meta["tree"] == {"params": {"z": 2, "a": {"norm": {}, "w": 1}},
                            "opt": {"step": 0}}
    assert meta["dtypes"] == ["int32", "float32", "bfloat16"]
    _, loaded = checkpoint.load(str(tmp_path))
    assert list(loaded) == ["params", "opt"]
    assert loaded["params"]["a"]["norm"] == {}
    for a, b in zip(tree_leaves(loaded), tree_leaves(state)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _run_launcher(args, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300,
        check=True).stdout


def test_launcher_completes_and_resumes(tmp_path):
    """``python -m repro_torch.launch.train --arch olmo-1b --tiny --steps 5
    --device cpu --ckpt-dir <tmp>`` runs and checkpoints step 5; a second
    run with ``--steps 8`` resumes there (the reference's elastic line) and
    checkpoints step 8."""
    ckpt = str(tmp_path / "ckpt")
    base = ["--arch", "olmo-1b", "--tiny", "--device", "cpu",
            "--ckpt-dir", ckpt]
    out = _run_launcher(base + ["--steps", "5"], tmp_path)
    assert "step     4 loss" in out
    assert checkpoint.latest_step(ckpt) == 5
    out = _run_launcher(base + ["--steps", "8"], tmp_path)
    assert out.startswith("elastic-resumed step 5 onto 1-device mesh")
    assert "step     7 loss" in out
    assert checkpoint.latest_step(ckpt) == 8


def test_launcher_restart_is_bit_exact(tmp_path):
    """The launcher's parts in order, as a caller drives them: 4 steps with
    an async checkpoint after step 2, then a restart from it, steps 3 and 4
    again: every parameter and moment equal bit for bit."""
    args = launcher.parse_args(
        ["--arch", "qwen3-8b", "--tiny", "--device", "cpu", "--steps", "4",
         "--global-batch", "4", "--grad-accum", "2", "--remat", "full",
         "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"])
    run = launcher.setup(args)
    start, state = launcher.init_or_resume(run, args)
    log = []
    launcher.train(run, args, state, start, log)
    assert start == 0 and [e["step"] for e in log] == [1, 2, 3, 4]
    assert all(np.isfinite(e["loss"]) and np.isfinite(e["grad_norm"])
               for e in log)
    step, again = checkpoint.load(str(tmp_path), step=2, device=run.device)
    args.ckpt_dir = None
    launcher.train(run, args, again, step)
    assert int(again["opt"]["step"]) == 4
    for a, b in zip(tree_leaves(state), tree_leaves(again)):
        assert torch.equal(a, b)


def test_train_lm_example_runs_and_resumes(tmp_path):
    from repro_torch.examples import train_lm
    losses = train_lm.main(["--device", "cpu", "--ckpt-dir", str(tmp_path)])
    assert losses[-1] < losses[0]
    assert checkpoint.latest_step(str(tmp_path)) == 40
    assert train_lm.main(["--device", "cpu", "--ckpt-dir", str(tmp_path),
                          "--resume"]) == []
