"""Training launcher (port of ``repro/launch/train.py``): config → mesh →
sharded init (or elastic checkpoint restore) → train step → data pipeline
→ periodic async checkpoints.

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b --tiny \
        --steps 50 --ckpt-dir /tmp/ckpt --device cpu
    PYTHONPATH=src python -m torch.distributed.run --standalone \
        --nproc-per-node 2 -m repro_torch.launch.train --arch olmo-1b \
        --tiny --device cpu --ckpt-dir /tmp/ckpt

Runs on ``cuda`` (NCCL, one card per process) unless ``--device cpu`` is
given (gloo), in f32 (the reference's dtype) unless ``--dtype`` says
otherwise; ``--seed`` seeds the weights' generator and the data.  As the
reference, it always trains under a mesh: ``--mesh host`` (the default)
is ``(1, world)`` over ``("data", "model")``, ``(1, 1)`` in one process;
``single``/``multi`` the production meshes (256/512 processes).  The
parameters and moments are DTensors with the rules' placements; a
checkpoint resumes on whatever mesh the restarted job runs
("elastic-resumed step N onto M-device mesh").  The step loop, its
printing (rank 0's) and the checkpoint cadence are the reference's; the
launcher waits for its async saves before it returns.  ``main`` runs the
launcher; ``parse_args``, ``setup``, ``init_or_resume`` and ``train`` are
its parts, in that order, for callers that drive them one at a time.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable, List, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch import configs
from repro_torch.configs import ArchConfig
from repro_torch.distributed import elastic
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.context import Mesh, use_rules
from repro_torch.launch.mesh import (init_distributed, make_mesh,
                                     make_production_mesh)
from repro_torch.models.transformer import tree_leaves
from repro_torch.params import resolve_device
from repro_torch.training import (DataConfig, OptConfig, TokenDataset,
                                  TrainConfig, checkpoint, init_train_state,
                                  make_train_step)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b",
                    choices=list(configs.ARCH_NAMES))
    ap.add_argument("--tiny", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--remat", default="none",
                    choices=["none", "dots", "full"])
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="float32", choices=sorted(DTYPES))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", default="host",
                    choices=["host", "single", "multi"],
                    help="host = (1, world) over this world's processes; "
                         "single/multi = production meshes (need 256/512 "
                         "processes)")
    return ap.parse_args(argv)


@dataclasses.dataclass
class Run:
    """What a training run is made of, before its state exists."""
    cfg: ArchConfig
    tcfg: TrainConfig
    data: TokenDataset
    device: torch.device
    dtype: torch.dtype
    step_fn: Callable
    mesh: Mesh
    rules: dict


def _print(*a, **kw):
    """Rank 0 prints, as the reference's single controller does."""
    if dist.get_rank() == 0:
        print(*a, **kw)


def setup(args: argparse.Namespace) -> Run:
    """Config, data and step; the process group (started here unless one
    runs), the mesh and the sharding rules of the run's shape."""
    cfg = (configs.get_tiny_config(args.arch) if args.tiny
           else configs.get_config(args.arch))
    tcfg = TrainConfig(
        opt=OptConfig(total_steps=args.steps),
        remat=args.remat, grad_accum=args.grad_accum,
        compress_grads=args.compress_grads)
    device = resolve_device(args.device)
    if args.mesh == "host":
        init_distributed(device)
        mesh = make_mesh((1, dist.get_world_size()), ("data", "model"),
                         device)
    else:
        mesh = make_production_mesh(multi_pod=args.mesh == "multi",
                                    device=device)
    shape = configs.Shape("train", "train", args.seq_len, args.global_batch)
    data = TokenDataset(DataConfig(args.seq_len, args.global_batch,
                                   seed=args.seed), cfg)
    return Run(cfg, tcfg, data, device, DTYPES[args.dtype],
               make_train_step(cfg, tcfg), mesh,
               shd.logical_rules(cfg, shape, mesh))


def restore(run: Run, ckpt_dir: str, step: Optional[int] = None):
    """(step, state) of a checkpoint (the newest unless ``step`` is given),
    each leaf distributed onto the run's mesh."""
    shapes = dict(zip(("params", "opt"), init_train_state(
        run.cfg, run.tcfg, generator=torch.Generator(), dtype=run.dtype,
        device="meta")))
    return checkpoint.load(ckpt_dir, step, device=run.device, mesh=run.mesh,
                           placements=elastic.state_placements(
                               shapes, run.cfg, run.mesh))


def init_or_resume(run: Run, args: argparse.Namespace):
    """(start step, state): the newest checkpoint in ``--ckpt-dir``, else a
    seeded init, distributed onto the run's mesh; the state is
    ``{"params", "opt"}``, as a checkpoint holds it.  The init places each
    leaf as it is drawn (``elastic.placer``) and makes the moments as
    shards, so no process holds more than its shards and one whole
    leaf."""
    if args.ckpt_dir and checkpoint.latest_step(args.ckpt_dir):
        start, state = restore(run, args.ckpt_dir)
        _print(f"elastic-resumed step {start} onto "
               f"{run.mesh.devices.size}-device mesh")
        return start, state
    gen = torch.Generator(device=run.device).manual_seed(args.seed)
    params, opt = init_train_state(
        run.cfg, run.tcfg, generator=gen, dtype=run.dtype, device=run.device,
        place=elastic.placer(run.cfg, run.mesh, run.dtype))
    return 0, {"params": params, "opt": opt}


def train(run: Run, args: argparse.Namespace, state: dict, start: int,
          log: Optional[List[dict]] = None) -> None:
    """Steps ``start`` to ``args.steps - 1`` under the run's sharding
    rules, each replacing ``state``'s params and opt state with the step's
    new ones, so the old are freed as the step ends (no caller keeps a
    second copy alive).  A state of whole tensors (``checkpoint.load``
    without a mesh) is first distributed onto the run's mesh.  Each step's
    loss, grad norm, lr and wall (ending when its metrics reach the host)
    are appended to ``log`` when given."""
    if not isinstance(tree_leaves(state["params"])[0], DTensor):
        state.update(elastic.reshard(state, run.cfg, run.mesh))
    n_params = sum(x.numel() for x in tree_leaves(state["params"]))
    _print(f"{run.cfg.name}: {n_params/1e6:.1f}M params on "
           f"{run.mesh.devices.size} device(s), {args.steps} steps")
    saves = []
    t0 = time.time()
    with use_rules(run.mesh, run.rules):
        for i in range(start, args.steps):
            t_step = time.perf_counter()
            state["params"], state["opt"], m = run.step_fn(
                state["params"], state["opt"], run.data.batch_at(i))
            if log is not None:
                log.append({"step": i + 1, **{k: float(m[k]) for k in
                                              ("loss", "grad_norm", "lr")},
                            "wall_s": time.perf_counter() - t_step})
            if i % 10 == 0 or i == args.steps - 1:
                _print(f"step {i:5d} loss {float(m['loss']):.4f} "
                       f"lr {float(m['lr']):.2e} "
                       f"({time.time()-t0:.1f}s)", flush=True)
            if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
                saves.append(checkpoint.save(args.ckpt_dir, i + 1, state,
                                             blocking=False))
    for th in saves:
        th.join()


def main(argv=None):
    args = parse_args(argv)
    run = setup(args)
    start, state = init_or_resume(run, args)
    train(run, args, state, start)
    if args.ckpt_dir:
        checkpoint.save(args.ckpt_dir, args.steps, state)
    dist.destroy_process_group()
    return state


if __name__ == "__main__":
    main()
