#!/usr/bin/env python3
"""Hold the bf16 wgmma flash kernel of this checkout against another
checkout's, bit for bit at D 128, and time hubert-xlarge's D 80 launch in
both, on one CUDA card.

    python3 tools/torch_flash_bits.py OTHER_CHECKOUT

Each checkout's ``repro_torch`` (its kernels built from its own sources
into its own ``build/``) runs in a process of its own, on the same seeded
inputs in the model's (B, S, H, D) layout: the D 128 shapes of
``chip_smoke.py``'s kernels phase (S = T 37, 1024 and 2048, causal and
not, Hq 32 over Hkv 8; Hkv 4 at 2048; S 37 and 2048 against T 1600
non-causal) and four blocks of 512 query rows at their offsets, each
launch on the wgmma kernel.  Prints one JSON line per shape: whether the
outputs are equal byte for byte, else the first element that differs.
Then, from four processes in the order other, this, this, other, the ms
by CUDA events of hubert-xlarge's launch (bf16, D 80, Hq = Hkv 16, S = T
2048, non-causal) with the kernel each checkout ran it on, and of the D
128 launch at S = T 2048 causal; the largest difference between the two
checkouts' D 80 outputs; and the card's name and power limit.  Exits
non-zero if any D 128 output differs.
"""
from __future__ import annotations

import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# (Hq, Hkv, S, T, causal, q_offset) at D 128
SHAPES = [(32, 8, s, s, causal, 0) for s in (37, 1024, 2048)
          for causal in (True, False)]
SHAPES += [(32, 4, 2048, 2048, True, 0), (32, 8, 37, 1600, False, 0),
           (32, 8, 2048, 1600, False, 0)]
SHAPES += [(32, 8, 512, 2048, True, r) for r in (0, 512, 1024, 1536)]
HUBERT = (16, 16, 2048, 2048, False, 0)     # at D 80
TIMED = (32, 8, 2048, 2048, True, 0)        # at D 128
REPS = 20


def _inputs(gen, shape, d):
    import torch
    hq, hkv, s, t, _, _ = shape
    return tuple(torch.randn((1, n, h, d), generator=gen, device="cuda",
                             dtype=torch.bfloat16).transpose(1, 2)
                 for n, h in ((s, hq), (t, hkv), (t, hkv)))


def _ms(fn, sets) -> float:
    """Mean ms of ``fn`` by CUDA events over REPS calls, rotating over
    ``sets`` (more bytes than the 50 MB L2 holds)."""
    import torch
    for s in sets[:2]:
        fn(*s)
    torch.cuda.synchronize()
    begin = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    begin.record()
    for i in range(REPS):
        fn(*sets[i % len(sets)])
    end.record()
    end.synchronize()
    return begin.elapsed_time(end) / REPS


def dump(src: str, out: str) -> None:
    """In this process: run ``src``'s kernel at every shape, save the
    outputs, hubert-xlarge's D 80 output and both timings to ``out``."""
    sys.path.insert(0, src)
    import torch
    from repro_torch.kernels.flash_attention import flash_attention, ops
    gen = torch.Generator(device="cuda").manual_seed(0)
    outs = []
    for shape in SHAPES:
        q, k, v = _inputs(gen, shape, 128)
        outs.append(flash_attention(q, k, v, shape[4], shape[5]).cpu())
    if ops.variant_launches["wgmma"] != ops.launches:
        raise SystemExit("a D 128 launch did not run the wgmma kernel")
    timed = {}
    for name, shape, d in (("hubert_d80", HUBERT, 80),
                           ("d128_causal", TIMED, 128)):
        sets = [_inputs(gen, shape, d) for _ in range(4)]
        before = dict(ops.variant_launches)
        first = flash_attention(*sets[0], shape[4])
        kernel = [v for v, n in ops.variant_launches.items()
                  if n > before[v]]
        timed[name] = dict(kernel=kernel, ms=_ms(
            lambda a, b, c: flash_attention(a, b, c, shape[4]), sets))
        if name == "hubert_d80":
            hubert = first.cpu()
    torch.save({"outs": outs, "hubert": hubert, "timed": timed}, out)


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
    a, b = runs[1][1]["outs"], runs[0][1]["outs"]
    same = True
    for shape, x, y in zip(SHAPES, a, b):
        equal = x.shape == y.shape and bool(
            torch.equal(x.view(torch.int16), y.view(torch.int16)))
        hq, hkv, s, t, causal, q_offset = shape
        row = dict(D=128, Hq=hq, Hkv=hkv, S=s, T=t, causal=causal,
                   q_offset=q_offset, bytes_equal=equal)
        if not equal:
            same = False
            if x.shape == y.shape:
                at = tuple((x.view(torch.int16) != y.view(torch.int16))
                           .nonzero()[0].tolist())
                row.update(first_difference=at, this=float(x[at]),
                           other=float(y[at]))
        print(json.dumps(row), flush=True)
    diff = float((runs[1][1]["hubert"].float()
                  - runs[0][1]["hubert"].float()).abs().max())
    print(json.dumps({"timed": [[n, r["timed"]] for n, r in runs],
                      "hubert_d80_this_vs_other_max_abs": diff}))
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
