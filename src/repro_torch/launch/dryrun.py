"""Multi-pod dry-run: trace every (arch x shape x mesh) cell on fake
tensors under a fake process group (port of ``repro/launch/dryrun.py``).

For each runnable cell this module starts a fake process group of 256 or
512 ranks in this process (it is rank 0; no collective moves data), builds
the reference's mesh over it, makes the parameters, optimizer state,
batch and cache as fake tensors (``FakeTensorMode``: shapes and dtypes, no
memory) placed by the port's sharding rules, and runs one rank's step:

    train_4k    -> make_train_step      (the sharded gradient, then AdamW)
    prefill_32k -> sharded_prefill      (encoder forward for encoder-only
                                         archs)
    decode_32k  -> sharded_decode_step  (one token against a full KV/SSM
                                         cache)
    long_500k   -> sharded_decode_step  (524k context; sub-quadratic archs
                                         only)

while ``launch/op_count.py`` counts its FLOPs, bytes and collectives and
``MemTracker`` follows the bytes of its live tensors.  Nothing is
compiled: where the reference reads XLA's cost and memory analyses of the
compiled HLO, the port counts what its eager step runs.

The cell is the reference's: ``deploy_overrides``, ``applicable`` and
``train_config_for`` (with ``REPRO_REMAT`` and ``REPRO_GRAD_ACCUM``) are
its functions, bf16 parameters, moments by ``train_config_for``.  The step
is the port's, as it runs:

* a train cell's moments are placed as their parameters (``opt_specs``
  without the ZeRO split of ``state_specs``), as the port's launcher and
  ``apply_updates``, which updates a moment on its parameter's shard,
  place them; its batch is the whole global batch on every rank, as the
  launcher hands it over, and ``_sharded_grad`` takes this rank's rows;
* a serving cell runs the port's sharded serving step
  (``distributed/serve_step.py``) on the parameters placed by
  ``param_specs`` and, for decode, a full cache placed by
  ``cache_specs``, with this rank's rows of the batch as ``batch_specs``
  places them: heads (or query rows) of prefill, d_ff, the vocabulary,
  Mamba's channels and the experts over 'model', decode's cache over
  ``kv_seq`` with the blocks' partials merged across ranks.  Its FLOPs,
  bytes and collectives are reported as counted.

The fake tensors carry ``device``, ``cuda`` unless the caller asks for
``cpu``.  A train cell runs no kernel on either, so it traces the card's
path on both.  On ``cuda`` a serving cell's attention reaches the flash
and decode kernels, as on the card: their launches are custom ops
(``prema::flash_attention``, ``prema::decode_attention``) whose fake
implementations give the outputs' shapes and whose FLOP formulas count
what their plain versions compute, so every serving cell traces the
card's path there; ``--device cpu`` traces the plain path (whose prefill
materializes the attention scores, so its memory is not the card's).
The reference's model never reaches its Pallas kernels.

Memory: ``argument`` is the bytes of what the step is handed on this rank
(local shards of the parameters, moments and cache; the batch as the step
takes it), ``output`` those of what it returns, ``peak`` ``MemTracker``'s
peak over the step with the arguments tracked, ``temp`` ``peak -
argument``; ``fits_hbm`` is held to one H100's 80 GB.

``init_memory`` (``--init-memory DATA MODEL``) reckons the launcher's
seeded init the same way: its peak on one rank of a fake mesh, placed
leaf by leaf, beside the whole state drawn and then resharded.

Usage (on a machine with CUDA; add ``--device cpu`` elsewhere):
    python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k --mesh single
    python -m repro_torch.launch.dryrun --all --out results/dryrun_torch.json
    python -m repro_torch.launch.dryrun --arch qwen3-8b --init-memory 1 4
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed._tools.mem_tracker import MemTracker
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor

from repro_torch import configs
from repro_torch.configs import SHAPES, ArchConfig, Shape, applicable
from repro_torch.core import arch_ops
from repro_torch.distributed import elastic
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.context import Mesh, placements, use_rules
from repro_torch.distributed.serve_step import (sharded_decode_step,
                                                sharded_prefill)
from repro_torch.hw import H100
from repro_torch.launch.op_count import counting, nbytes
from repro_torch.models import transformer
from repro_torch.models.transformer import tree_map
from repro_torch.training.optimizer import OptConfig, init_opt_state
from repro_torch.training.train_step import (TrainConfig, init_train_state,
                                             make_train_step)

HBM_PER_CHIP = H100.hbm_bytes


def train_config_for(cfg: ArchConfig, mesh=None,
                     global_batch: int = 256) -> TrainConfig:
    """Per-arch training memory policy (the reference's): microbatching
    bounds live activations; >100B models additionally use bf16 optimizer
    moments and a bf16 gradient accumulator.

    grad_accum is clamped so each microbatch still divides the
    batch-sharding degree."""
    n = cfg.param_count()
    big = n > 1e11
    ga = 4 if n < 2e9 else (8 if n < 1.5e10 else 16)
    if mesh is not None:
        sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
        batch_shards = sizes.get("pod", 1) * sizes.get("data", 1)
        ga = min(ga, max(1, global_batch // batch_shards))
    remat = os.environ.get("REPRO_REMAT", "full")
    ga = int(os.environ.get("REPRO_GRAD_ACCUM", ga))
    return TrainConfig(
        opt=OptConfig(moment_dtype="bfloat16" if big else "float32"),
        remat=remat, grad_accum=ga,
        accum_dtype="bfloat16" if big else "float32")


def deploy_overrides(cfg: ArchConfig, shape: Shape, tp: int = 16) -> Dict:
    """Deployment config transforms (the reference's): query heads pad up
    to the TP multiple when they don't divide it (padded heads carry zero
    output weights).  GQA keeps the group integral; MHA must pad KV too,
    so it only pads for train/prefill."""
    out: Dict = {}
    if cfg.n_heads % tp != 0:
        mha = cfg.n_kv_heads == cfg.n_heads
        if mha and shape.kind == "decode":
            return out
        m = -(-cfg.n_heads // tp) * tp
        while (m % tp != 0) or (not mha and m % cfg.n_kv_heads != 0):
            m += tp
        out["n_heads"] = m
        if mha:
            out["n_kv_heads"] = m
    return out


def cell_config(arch: str, shape_name: str,
                cfg_overrides: Optional[Dict] = None,
                deploy_pads: bool = True
                ) -> Tuple[ArchConfig, Dict, bool, str]:
    """(config, overrides applied, runnable, reason if not) of a cell, in
    the reference's order: deploy pads, then the caller's overrides, then
    ``applicable``."""
    cfg = configs.get_config(arch)
    shape = SHAPES[shape_name]
    applied: Dict = {}
    if deploy_pads:
        applied.update(deploy_overrides(cfg, shape))
    if cfg_overrides:
        applied.update(cfg_overrides)
    if applied:
        cfg = dataclasses.replace(cfg, **applied)
    ok, why = applicable(cfg, shape)
    return cfg, applied, ok, why


@contextlib.contextmanager
def fake_mesh(shape: Sequence[int], axes: Sequence[str],
              device="cuda") -> Iterator[Mesh]:
    """A fake process group of ``prod(shape)`` ranks, this process rank 0,
    and a mesh of ``shape`` over it; the group is destroyed when the block
    ends.  Refuses to start where a process group already runs, so the
    fake group never stands in for a real one."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group runs in this process; the "
                           "dry-run needs a process of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=int(np.prod(shape)))
    try:
        yield Mesh(init_device_mesh(torch.device(device).type, tuple(shape),
                                    mesh_dim_names=tuple(axes)))
    finally:
        dist.destroy_process_group()


def _placed(shape, dtype, pl, mesh, device) -> DTensor:
    """A DTensor of ``shape`` placed as ``pl``, from its local shard (zeros;
    fake under ``FakeTensorMode``): no collective."""
    dm = mesh.device_mesh
    local = list(shape)
    for i, p in enumerate(pl):
        if p.is_shard():
            local[p.dim] //= dm.size(i)
    return DTensor.from_local(torch.zeros(local, dtype=dtype, device=device),
                              dm, pl, run_check=False)


def _batch(cfg: ArchConfig, shape: Shape, mesh, device, placed: bool = False
           ) -> Dict[str, torch.Tensor]:
    """The cell's inputs (zeros; fake under ``FakeTensorMode``): the whole
    global batch, or with ``placed`` DTensors placed by ``batch_specs``
    (this rank's rows)."""
    b, s = shape.global_batch, shape.seq_len
    leaves = {}
    if cfg.embedding_inputs:
        leaves["frames"] = ((b, s, cfg.d_model), torch.bfloat16)
    else:
        leaves["tokens"] = ((b, s if shape.kind != "decode" else 1),
                            torch.int32)
    if shape.kind == "train":
        leaves["labels"] = ((b, s), torch.int32)
    if cfg.img_tokens:
        leaves["img_embeds"] = ((b, cfg.img_tokens, cfg.d_vision),
                                torch.bfloat16)
    if not placed:
        return {k: torch.zeros(sh, dtype=dt, device=device)
                for k, (sh, dt) in leaves.items()}
    place = _specs_placements(shd.batch_specs(cfg, shape, mesh), mesh)
    return {k: _placed(sh, dt, place[k], mesh, device)
            for k, (sh, dt) in leaves.items()}


def _specs_placements(specs, mesh):
    return shd.map2(lambda _, s: placements(s, mesh), specs, specs)


def _params(cfg, dtype, device):
    """Parameters of ``init_params``' shapes and dtypes on ``device``, made
    from its meta-device draw (no generator meets a fake tensor)."""
    meta = transformer.init_params(cfg, generator=torch.Generator(),
                                   dtype=dtype, device="meta")
    return tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype,
                                          device=device), meta)


def _train_step(cfg, shape, mesh, tcfg, dtype, device):
    """(arguments, step) of a train cell: the parameters and moments
    placed on ``mesh``, the whole batch; the step ``make_train_step``'s."""
    params = _params(cfg, dtype, device)
    opt = init_opt_state(params, tcfg.opt)
    p_specs = shd.param_specs(params, cfg, mesh)
    o_specs = shd.opt_specs(opt, p_specs)
    place = {"params": _specs_placements(p_specs, mesh),
             "opt": {k: (None if k == "step" else
                         _specs_placements(o_specs[k], mesh))
                     for k in opt}}
    state = elastic.distribute({"params": params, "opt": opt}, place, mesh)
    batch = _batch(cfg, shape, mesh, device)
    step = make_train_step(cfg, tcfg)
    return (state["params"], state["opt"], batch), step


def _serve_step(cfg, shape, mesh, dtype, device):
    """(arguments, step) of a prefill or decode cell: the parameters, the
    cache and this rank's rows of the batch as DTensors placed by the
    rules; the step ``sharded_prefill`` or ``sharded_decode_step`` at the
    cache's last position."""
    meta = transformer.init_params(cfg, generator=torch.Generator(),
                                   dtype=dtype, device="meta")
    params = shd.map2(lambda x, pl: _placed(x.shape, x.dtype, pl, mesh,
                                            device),
                      meta, shd.param_placements(meta, cfg, mesh))
    batch = _batch(cfg, shape, mesh, device, placed=True)
    if shape.kind == "prefill":
        return (params, batch), lambda p, b: sharded_prefill(p, b, cfg)
    c_shape = transformer.cache_spec(cfg, shape.global_batch, shape.seq_len,
                                     dtype)
    c_place = _specs_placements(shd.cache_specs(cfg, shape, mesh), mesh)
    cache = shd.map2(lambda s, pl: _placed(s.shape, s.dtype, pl, mesh,
                                           device), c_shape, c_place)
    return (params, cache, batch), lambda p, c, b: sharded_decode_step(
        p, c, b["tokens"], shape.seq_len - 1, cfg)


def trace_step(cfg: ArchConfig, shape: Shape, mesh, *,
               tcfg: Optional[TrainConfig] = None,
               dtype: torch.dtype = torch.bfloat16, device="cuda",
               by_label: bool = False) -> Dict[str, object]:
    """One rank's step of ``shape`` on ``mesh`` (which runs over a fake
    process group), on fake tensors of ``device``: ``op_count``'s counts,
    the memory, and the seconds it took to trace (``trace_s``).  A train
    shape needs ``tcfg``."""
    with FakeTensorMode(allow_non_fake_inputs=True):
        if shape.kind == "train":
            args, step = _train_step(cfg, shape, mesh, tcfg, dtype, device)
            grad = contextlib.nullcontext()
        else:
            args, step = _serve_step(cfg, shape, mesh, dtype, device)
            grad = torch.no_grad()
        tracker = MemTracker()
        tracker.track_external(*args)
        t0 = time.perf_counter()
        with use_rules(mesh, shd.logical_rules(cfg, shape, mesh)), grad, \
                tracker, counting(by_label) as counts:
            out = step(*args)
        trace_s = time.perf_counter() - t0
    dev = torch.device(device).type
    peak = sum(snap["Total"] for d, snap in
               tracker.get_tracker_snapshot("peak").items()
               if d.type == dev)
    arg = nbytes(args)
    return dict(counts, trace_s=trace_s, memory={
        "argument": arg, "output": nbytes(out), "temp": peak - arg,
        "peak": peak})


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             verbose: bool = True,
             cfg_overrides: Optional[Dict] = None,
             deploy_pads: bool = True, by_label: bool = False,
             device="cuda") -> Dict:
    """The reference's ``run_cell``: one (arch x shape x mesh) cell, with
    its result keys, traced on fake tensors of ``device``; ``compile_s``
    is the seconds the trace took.  With ``by_label`` also
    ``flops_by_label`` and ``coll_by_label``."""
    cfg, applied, ok, why = cell_config(arch, shape_name, cfg_overrides,
                                        deploy_pads)
    mesh_name = "multi" if multi_pod else "single"
    shape = SHAPES[shape_name]
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped", "reason": why}
    mesh_axes = (((2, 16, 16), ("pod", "data", "model")) if multi_pod
                 else ((16, 16), ("data", "model")))
    with fake_mesh(*mesh_axes, device=device) as mesh:
        n_chips = int(mesh.devices.size)
        tcfg = (train_config_for(cfg, mesh, shape.global_batch)
                if shape.kind == "train" else None)
        r = trace_step(cfg, shape, mesh, tcfg=tcfg, device=device,
                       by_label=by_label)

    # analytic flops for the MODEL_FLOPS ratio (per device)
    if shape.kind == "train":
        fwd = arch_ops.flops(cfg, shape.seq_len, shape.global_batch,
                             "prefill")
        analytic = 4.0 * fwd / n_chips      # fwd + 2x bwd + remat fwd
    elif shape.kind == "prefill":
        analytic = float(arch_ops.flops(cfg, shape.seq_len,
                                        shape.global_batch, "prefill")) / n_chips
    else:
        analytic = float(arch_ops.flops(cfg, shape.seq_len,
                                        shape.global_batch, "decode")) / n_chips
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    n_active = cfg.active_param_count()
    model_flops = (6.0 if shape.kind == "train" else 2.0) * n_active * tokens

    mem = r["memory"]
    result = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "n_chips": n_chips,
        "status": "ok",
        "deploy_overrides": applied,
        "compile_s": round(r["trace_s"], 1),
        "flops_per_device": r["flops"],
        "flops_per_device_raw": r["flops"],
        "analytic_flops_per_device": analytic,
        "model_flops_global": model_flops,
        "bytes_per_device_raw": float(r["bytes_accessed"]),
        "collective_bytes_per_device": r["collective_bytes"],
        "collective_bytes_raw": r["collective_bytes"],
        "collectives": {k: v for k, v in r.items() if k.startswith("coll_")
                        and k != "coll_by_label"},
        "n_collectives": r["n_collectives"],
        "collective_counts": r["collective_counts"],
        "memory": mem,
        # the reference's max(argument + temp, peak) <= HBM: temp is
        # peak - argument here, so both sides are the peak
        "fits_hbm": bool(mem["peak"] <= HBM_PER_CHIP),
        "device": torch.device(device).type,
    }
    if tcfg is not None:
        result["grad_accum"] = tcfg.grad_accum
    if by_label:
        result.update({k: r[k] for k in ("flops_by_label", "coll_by_label")})
    if verbose:
        print(f"[{mesh_name}] {arch} x {shape_name}: "
              f"trace {r['trace_s']:.0f}s  "
              f"flops/dev {r['flops']:.3e} (analytic {analytic:.3e})  "
              f"coll {r['collective_bytes']/1e6:.1f} MB  "
              f"mem arg {mem['argument']/1e9:.2f} + temp "
              f"{mem['temp']/1e9:.2f} GB  fits={result['fits_hbm']}",
              flush=True)
    return result


def init_memory(arch: str, mesh_shape: Sequence[int] = (1, 4), *,
                sharded: bool = True, device="cuda") -> Dict[str, float]:
    """The launcher's seeded init of full-width ``arch`` (f32, a default
    ``TrainConfig``) on rank 0 of a fake ("data", "model") mesh of
    ``mesh_shape``, on fake tensors of ``device``: ``MemTracker``'s peak
    over the init, and this rank's state bytes (``local``) once it is done.
    ``sharded`` is the launcher's init, each leaf placed as it is drawn;
    without it the init draws the whole state, then ``elastic.reshard``
    cuts this rank's shards from it.  Also the whole state's bytes and the
    largest whole leaf's, from the meta device."""
    cfg = configs.get_config(arch)
    tcfg = TrainConfig()
    meta = init_train_state(cfg, tcfg, generator=torch.Generator(),
                            device="meta")
    leaves = [x.nbytes for x in transformer.tree_leaves(list(meta))]
    with fake_mesh(mesh_shape, ("data", "model"), device) as mesh, \
            FakeTensorMode(allow_non_fake_inputs=True):
        place = elastic.placer(cfg, mesh) if sharded else None
        tracker = MemTracker()
        with tracker:
            gen = torch.Generator(device=device).manual_seed(0)
            params, opt = init_train_state(cfg, tcfg, generator=gen,
                                           device=device, place=place)
            state = {"params": params, "opt": opt}
            if not sharded:
                state = elastic.reshard(state, cfg, mesh)
            del params, opt
        dev = torch.device(device).type
        peak = sum(snap["Total"] for d, snap in
                   tracker.get_tracker_snapshot("peak").items()
                   if d.type == dev)
        local = nbytes(state)
    return {"arch": arch, "mesh": list(mesh_shape), "sharded": sharded,
            "peak": peak, "local": local, "whole": sum(leaves),
            "largest_leaf": max(leaves)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--by-label", action="store_true",
                    help="also attribute FLOPs and collective bytes to the "
                         "port's functions (the top 25 of each)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="device of the fake tensors (cuda traces the "
                         "card's path, the kernels through their fake "
                         "implementations; cpu the plain path)")
    ap.add_argument("--out", default="results/dryrun_torch.json")
    ap.add_argument("--init-memory", type=int, nargs=2, default=None,
                    metavar=("DATA", "MODEL"),
                    help="reckon the launcher's init of full-width --arch "
                         "on a fake mesh of this shape (print one JSON "
                         "line, sharded and whole-then-reshard; no --out)")
    args = ap.parse_args(argv)
    if args.init_memory:
        print(json.dumps({"init_memory": [
            init_memory(args.arch, args.init_memory, sharded=sharded,
                        device=args.device) for sharded in (True, False)]}))
        return

    if args.all:
        archs = configs.ARCH_NAMES
        shapes = list(SHAPES)
        meshes = [False, True]
    else:
        archs = [args.arch] if args.arch else configs.ARCH_NAMES
        shapes = [args.shape] if args.shape else list(SHAPES)
        meshes = {"single": [False], "multi": [True],
                  "both": [False, True]}[args.mesh]

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    results = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)

    for multi in meshes:
        for arch in archs:
            for shape in shapes:
                key = f"{arch}|{shape}|{'multi' if multi else 'single'}"
                done = results.get(key, {})
                # a cell of the other device is traced anew
                if (done.get("status") in ("ok", "skipped")
                        and done.get("device", args.device) == args.device):
                    print(f"cached: {key}", flush=True)
                    continue
                try:
                    results[key] = run_cell(arch, shape, multi,
                                            by_label=args.by_label,
                                            device=args.device)
                except Exception as e:  # record failures, keep going
                    results[key] = {
                        "arch": arch, "shape": shape,
                        "mesh": "multi" if multi else "single",
                        "status": "error", "error": str(e)[:2000]}
                    print(f"ERROR {key}: {str(e)[:300]}", flush=True)
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1)

    n_ok = sum(1 for r in results.values() if r["status"] == "ok")
    n_skip = sum(1 for r in results.values() if r["status"] == "skipped")
    n_err = sum(1 for r in results.values() if r["status"] == "error")
    print(f"\ndry-run: {n_ok} ok, {n_skip} skipped, {n_err} errors "
          f"-> {args.out}")


if __name__ == "__main__":
    main()
