#!/usr/bin/env python3
"""Where the time of sharded decode goes on one CUDA card: full-width
qwen3-8b in bf16, one decode step at a cache of 2048 positions, through
``transformer.decode_step`` (meshless) and ``sharded_decode_step`` under
an NCCL (1, 1) mesh, each on the same random weights.

    python3 tools/profile_sharded_decode.py

Prints JSON lines: the ms a step of each by the host's clock around
8 steps ending in a synchronize, in turns (meshless, sharded, sharded,
meshless); for one profiled step of each (``torch.profiler``) the host's
and the device's ms, and the collectives' calls and host ms by kind; and
the host ms of one all-gather over the mesh's 'data' group (one process)
of 8 KB and of 50 MB.  Last, the card's name and power limit.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

CACHE_POS, STEPS = 2048, 8


def _profiled(fn) -> dict:
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn(CACHE_POS)
        torch.cuda.synchronize()
    ev = prof.key_averages()
    coll = {}
    for e in ev:
        for kind in ("_AllGather", "_AllReduce", "_AllToAll"):
            if e.key == kind:
                coll[kind] = dict(calls=e.count,
                                  host_ms=e.cpu_time_total / 1e3)
    return dict(
        host_ms=sum(e.self_cpu_time_total for e in ev) / 1e3,
        device_ms=sum(e.self_device_time_total for e in ev) / 1e3,
        device_copy_ms=sum(e.self_device_time_total for e in ev
                           if e.key.startswith("Memcpy DtoD")) / 1e3,
        collectives=coll)


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_sharded_decode: no CUDA device", file=sys.stderr)
        return 1
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch.configs import Shape
    from repro_torch.distributed import collectives as col
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.context import placements, use_rules
    from repro_torch.distributed.serve_step import sharded_decode_step
    from repro_torch.launch.mesh import init_distributed, make_mesh
    from repro_torch.models import get_model, transformer

    init_distributed("cuda")
    mesh = make_mesh((1, 1), ("data", "model"), "cuda")
    dm = mesh.device_mesh
    model = get_model("qwen3-8b")
    cfg = model.cfg
    params = model.init_params(
        generator=torch.Generator(device="cuda").manual_seed(0),
        dtype=torch.bfloat16, device="cuda")
    local = lambda x, pl: DTensor.from_local(x, dm, pl, run_check=False)
    dparams = shd.map2(local, params,
                       shd.param_placements(params, cfg, mesh))
    t = CACHE_POS + 2 * STEPS + 2
    cache = transformer.init_cache(cfg, 1, t, torch.bfloat16, device="cuda")
    shape = Shape("decode", "decode", t, 1)
    dcache = shd.map2(lambda x, sp: local(x.clone(), placements(sp, mesh)),
                      cache, shd.cache_specs(cfg, shape, mesh))
    tok = torch.zeros((1, 1), dtype=torch.long, device="cuda")
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False

    def meshless(pos):
        return transformer.decode_step(params, cache, tok, pos, cfg)

    def sharded(pos):
        with use_rules(mesh, shd.logical_rules(cfg, shape, mesh)):
            return sharded_decode_step(dparams, dcache, tok, pos, cfg)

    def ms_a_step(fn):
        fn(CACHE_POS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(STEPS):
            fn(CACHE_POS + 1 + i)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / STEPS * 1e3

    turns = [("meshless", meshless), ("sharded", sharded),
             ("sharded", sharded), ("meshless", meshless)]
    print(json.dumps({"ms_a_step": [[name, ms_a_step(fn)]
                                    for name, fn in turns]}), flush=True)
    for name, fn in (("meshless", meshless), ("sharded", sharded)):
        print(json.dumps({"profiled_step": name, **_profiled(fn)}),
              flush=True)
    gathers = {}
    for numel, label in ((4096, "8KB"), (25_000_000, "50MB")):
        x = torch.empty(numel, dtype=torch.bfloat16, device="cuda")
        col.all_gather(x, 0, dm, ("data",))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            col.all_gather(x, 0, dm, ("data",))
        torch.cuda.synchronize()
        gathers[label] = (time.perf_counter() - t0) / 50 * 1e3
    print(json.dumps({"all_gather_ms_on_a_group_of_one": gathers}),
          flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip())
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
