#!/usr/bin/env python3
"""Runs one cell of BENCHMARK.json once, on the machine it is started on:

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the result (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
also ``breakdown``, and last ``compared``: each number the check compared
beside its limit, which also end standard error).  Without as many CUDA
devices as the cell asks for it exits with code 2 and prints no result.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
# every cache the program or its libraries keep lives in the checkout
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions",
          "TRITON_CACHE_DIR": "triton", "CUDA_CACHE_PATH": "cuda"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = str(REPO / "build" / "cache" / sub)
    here = Path(__file__).resolve().parent
    sys.path[:] = [str(REPO / "src"), str(REPO)] + [
        p for p in sys.path if Path(p or ".").resolve() != here]
    import torch

    from bench import harness
    bm = harness.load_benchmark()
    chips = next(w["chips"] for w in bm["workloads"]
                 if w["name"] == args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    line = harness.run_cell(args.workload, args.seed, args.seconds,
                            bool(args.trace), T_PROCESS, bm=bm)
    # the window has closed: nothing of the JAX side may have been loaded
    loaded = harness.jax_side(list(sys.modules))
    if loaded:
        print(f"modules of the JAX side are loaded: {loaded}", file=sys.stderr)
        return 1
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
