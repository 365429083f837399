"""Train a small LM with the full substrate: data pipeline, AdamW + cosine
schedule, remat, checkpoint/restart (port of ``examples/train_lm.py``).

By default runs a quick 40-step demo at reduced width; pass ``--full`` for
the ~100M / 300-step configuration.  Runs on ``cuda`` unless ``--device
cpu`` is given.

    PYTHONPATH=src python -m repro_torch.examples.train_lm --device cpu \
        --ckpt-dir /tmp/repro_torch_train_lm [--full] [--resume]
"""
import argparse
import time

import torch

from repro_torch.configs import ArchConfig
from repro_torch.models.transformer import tree_leaves
from repro_torch.params import resolve_device
from repro_torch.training import (DataConfig, OptConfig, TokenDataset,
                                  TrainConfig, checkpoint, init_train_state,
                                  make_train_step)


def make_cfg(full: bool) -> ArchConfig:
    if full:  # ~100M params
        return ArchConfig(
            name="lm-100m", family="dense", n_layers=8, d_model=768,
            n_heads=12, n_kv_heads=12, d_ff=3072, vocab_size=32768,
            block_pattern=(("attn", "mlp"),), norm="rmsnorm",
            mlp_act="silu", tie_embeddings=True)
    return ArchConfig(
        name="lm-demo", family="dense", n_layers=4, d_model=256,
        n_heads=8, n_kv_heads=8, d_ff=1024, vocab_size=8192,
        block_pattern=(("attn", "mlp"),), norm="rmsnorm",
        mlp_act="silu", tie_embeddings=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = make_cfg(args.full)
    steps = 300 if args.full else 40
    tcfg = TrainConfig(
        opt=OptConfig(peak_lr=3e-4, warmup_steps=20, total_steps=steps),
        remat="full" if args.full else "none", grad_accum=1)
    data = TokenDataset(DataConfig(seq_len=256 if args.full else 64,
                                   global_batch=8, seed=0), cfg)
    step_fn = make_train_step(cfg, tcfg)

    start = 0
    if args.resume and checkpoint.latest_step(args.ckpt_dir) is not None:
        start, state = checkpoint.load(args.ckpt_dir, device=device)
        params, opt = state["params"], state["opt"]
        print(f"resumed from step {start}")
    else:
        params, opt = init_train_state(
            cfg, tcfg, generator=torch.Generator(device=device).manual_seed(0),
            device=device)
    n_params = sum(x.numel() for x in tree_leaves(params))
    print(f"{cfg.name}: {n_params/1e6:.1f}M params, {steps} steps")

    t0 = time.time()
    losses = []
    for i in range(start, steps):
        params, opt, m = step_fn(params, opt, data.batch_at(i))
        if i % 10 == 0 or i == steps - 1:
            losses.append(float(m["loss"]))
            print(f"step {i:4d}  loss {float(m['loss']):.4f}  "
                  f"lr {float(m['lr']):.2e}  "
                  f"gnorm {float(m['grad_norm']):.2f}  "
                  f"{(time.time()-t0):.1f}s")
        if (i + 1) % 50 == 0:
            checkpoint.save(args.ckpt_dir, i + 1,
                            {"params": params, "opt": opt}, blocking=False)
    checkpoint.save(args.ckpt_dir, steps, {"params": params, "opt": opt})
    print("done; checkpoint at", args.ckpt_dir)
    return losses


if __name__ == "__main__":
    main()
