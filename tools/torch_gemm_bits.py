#!/usr/bin/env python3
"""Hold the f32 preemptible GEMM of this checkout against another
checkout's, bit for bit, on one CUDA card.

    python3 tools/torch_gemm_bits.py OTHER_CHECKOUT

Each checkout's ``repro_torch`` (its kernels built from its own sources
into its own ``build/``) runs the CUDA-core kernel in a process of its
own, on the same seeded inputs: qwen3-8b's down projection (2048 x 12288 x
4096) and the shapes of ``chip_smoke.GEMM_SHAPES``, each over the whole K
range from a zero accumulator and over a middle range from a random one.
Prints one JSON line per shape: whether the accumulators are equal byte
for byte, else the first element that differs.  Then the full-width
launch's ms by CUDA events in four processes, in the order other, this,
this, other, and the card's name and power limit.  Exits non-zero if any
accumulator differs.
"""
from __future__ import annotations

import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FULL = (2048, 12288, 4096)


def _shapes():
    sys.path.insert(0, str(ROOT))
    from chip_smoke import GEMM_SHAPES
    return [FULL] + list(GEMM_SHAPES)


def dump(src: str, out: str) -> None:
    """In this process: run ``src``'s kernel at every shape, save the
    accumulators and the full-width launch's ms to ``out``."""
    sys.path.insert(0, src)
    import torch
    from repro_torch.kernels.preemptible_matmul import (matmul_resumable,
                                                        ops, start)
    gen = torch.Generator(device="cuda").manual_seed(0)
    accs, ms = [], None
    for m, k, n in _shapes():
        x = torch.randn((m, k), generator=gen, device="cuda")
        y = torch.randn((k, n), generator=gen, device="cuda")
        ck = start(x, y)
        nk = ck.n_ktiles
        seed = torch.randn(ck.acc.shape, generator=gen, device="cuda")
        accs.append(matmul_resumable(x, y, ck.acc, 0, nk).cpu())
        accs.append(matmul_resumable(x, y, seed, nk // 3,
                                     nk // 3 + max(1, nk // 3)).cpu())
        if (m, k, n) == FULL:
            matmul_resumable(x, y, ck.acc, 0, nk)          # warm
            torch.cuda.synchronize()
            begin = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            begin.record()
            for _ in range(10):
                matmul_resumable(x, y, ck.acc, 0, nk, out=seed)
            end.record()
            end.synchronize()
            ms = begin.elapsed_time(end) / 10
    if ops.variant_launches["cuda_core"] != ops.launches:
        raise SystemExit("a launch did not run the CUDA-core kernel")
    torch.save({"accs": accs, "ms": ms}, out)


def _run(src: Path, out: Path) -> dict:
    subprocess.run([sys.executable, __file__, "--dump", str(src), str(out)],
                   check=True)
    import torch
    return torch.load(out)


def main(other: str) -> int:
    import torch
    mine, theirs = ROOT / "src", Path(other).resolve() / "src"
    with tempfile.TemporaryDirectory() as tmp:
        runs = [(name, _run(src, Path(tmp) / f"{i}.pt")) for i, (name, src)
                in enumerate((("other", theirs), ("this", mine),
                              ("this", mine), ("other", theirs)))]
    a, b = runs[1][1]["accs"], runs[0][1]["accs"]
    same = True
    for i, shape in enumerate(_shapes()):
        for j, rng in enumerate(("whole K", "middle K")):
            x, y = a[2 * i + j], b[2 * i + j]
            equal = x.shape == y.shape and bool(
                torch.equal(x.view(torch.int32), y.view(torch.int32)))
            row = dict(shape=list(shape), range=rng, bytes_equal=equal)
            if not equal:
                same = False
                if x.shape == y.shape:
                    at = tuple((x.view(torch.int32) != y.view(torch.int32))
                               .nonzero()[0].tolist())
                    row.update(first_difference=at, this=float(x[at]),
                               other=float(y[at]))
            print(json.dumps(row), flush=True)
    print(json.dumps({"full_width_ms": [[n, r["ms"]] for n, r in runs]}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0 if same else 1


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dump"]:
        dump(sys.argv[2], sys.argv[3])
    elif len(sys.argv) == 2:
        sys.exit(main(sys.argv[1]))
    else:
        sys.exit(__doc__)
