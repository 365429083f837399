"""The one traffic generator: every mix is a data file under ``traffic/``.

A mix names its request classes (share, priority, batch, prompt and
output length ranges), how arrivals are drawn, and how many requests make
one round (one fresh engine) and one block (the unit over which sizes are
stratified).  Each block holds the same multiset of sizes: each class's
prompts sit at the midpoints of equal shares of a log-uniform range, its
outputs likewise of a uniform one, paired by a fixed scramble.  Poisson
gaps are the midpoints of the exponential's equal shares, scaled to the
cell's mean gap.

The orders of the sizes and of the gaps come from one stream of
``cycle_rounds`` rounds (a number in the cell's file) that is the same for
every seed; a seed starts it at round ``seed mod cycle_rounds`` and draws
the token ids.  So two seeds send the same work in another order, and a
window that holds whole cycles holds the same rounds whatever the seed: a
run's spread is the program's, not the draw's.  A cell whose window holds
a part of a cycle as well, and whose metrics follow the rounds it holds,
sets ``"seeded_start": false`` in its file: every seed then runs the
stream from its first round, so a window of R rounds holds the same sizes
and arrivals whatever the seed, and the seed draws the token ids alone.
"""
from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Dict, List

import numpy as np

ROOT = Path(__file__).resolve().parent


def load_mix(name: str) -> Dict:
    return json.loads((ROOT / "traffic" / f"{name}.json").read_text())


def seed_words(seed: int) -> int:
    """Any whole number as a non-negative 64-bit seed."""
    return int(seed) % 2**64


def _class_counts(mix: Dict) -> List[int]:
    n = mix["block_requests"]
    counts = [int(round(c["share"] * n)) for c in mix["classes"]]
    counts[int(np.argmax(counts))] += n - sum(counts)
    return counts


def block_sizes(mix: Dict) -> List[Dict]:
    """The stratified multiset of one block, class by class: the i-th
    prompt share paired with a fixed scramble of the output shares."""
    out = []
    for c, k in zip(mix["classes"], _class_counts(mix)):
        lo, hi = c["prompt"]
        olo, ohi = c["output"]
        scramble = np.random.default_rng(0).permutation(k)
        for i in range(k):
            u, v = (i + 0.5) / k, (scramble[i] + 0.5) / k
            out.append(dict(priority=c["priority"], batch=c["batch"],
                            prompt_len=int(round(lo * (hi / lo) ** u)),
                            output_len=olo + int(v * (ohi - olo + 1))))
    return out


def block(mix: Dict, b: int) -> List[Dict]:
    """Block ``b`` of the stream: the multiset in its fixed order."""
    sizes = block_sizes(mix)
    rng = np.random.default_rng([1, b])
    return [sizes[i] for i in rng.permutation(len(sizes))]


def arrivals(mix: Dict, cell: Dict, n: int, rng) -> np.ndarray:
    """Virtual arrival times (engine seconds) of a round's ``n`` requests."""
    if mix["arrivals"] == "one_per_round":
        if n != 1:
            raise ValueError("'one_per_round' needs round_requests == 1")
        return np.zeros(1)
    if mix["arrivals"] != "poisson":
        raise ValueError(f"unknown arrivals {mix['arrivals']!r}")
    gaps = np.array([-math.log(1.0 - (i + 0.5) / n) for i in range(n)])
    gaps *= cell["mean_gap_s"] / gaps.mean()
    return np.cumsum(rng.permutation(gaps))


def round_requests(mix: Dict, cell: Dict, seed: int, r: int,
                   vocab: int) -> List[Dict]:
    """Round ``r``'s requests for ``seed``: the stream's round
    ``(seed + r) mod cycle_rounds`` (``r mod cycle_rounds`` where the cell
    sets ``seeded_start`` false), with token ids drawn from (seed, r).
    Each request: rid (unique over rounds), priority, prompt (batch, len)
    int32, max_new_tokens and virtual arrival."""
    n, per_block = mix["round_requests"], mix["block_requests"]
    cycle = cell["cycle_rounds"]
    if (cycle * n) % per_block:
        raise ValueError(f"cycle_rounds {cycle} x round_requests {n} is not "
                         f"whole blocks of {per_block}")
    start = seed_words(seed) if cell.get("seeded_start", True) else 0
    q = (start + r) % cycle
    first = q * n
    blocks = {b: block(mix, b)
              for b in range(first // per_block, (first + n - 1) // per_block + 1)}
    sizes = [blocks[i // per_block][i % per_block]
             for i in range(first, first + n)]
    at = arrivals(mix, cell, n, np.random.default_rng([2, q]))
    rng = np.random.default_rng([seed_words(seed), 3, r])
    reqs = []
    for i, (s, t) in enumerate(zip(sizes, at)):
        prompt = rng.integers(0, vocab, (s["batch"], s["prompt_len"]),
                              dtype=np.int64).astype(np.int32)
        reqs.append(dict(rid=r * n + i, priority=s["priority"], prompt=prompt,
                         max_new_tokens=s["output_len"], arrival=float(t)))
    return reqs
