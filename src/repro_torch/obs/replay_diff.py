# Copied from src/repro/obs/replay_diff.py; `repro.` rewritten to `repro_torch.`.
"""Cross-layer replay debugging: first divergence between two event logs.

The determinism contract says same seed + same workload ⇒ bit-identical
event logs across execution layers (engine vs simulator, fast core vs
``core/_legacy_cluster.py``, live run vs ``ExecutedTrace`` replay).
When that breaks, the useful fact is not *that* the logs differ but
*where they differ first* — everything after the earliest divergence is
cascade.  :func:`first_divergence` finds that event and packages it with
surrounding context from both logs.

CLI::

    PYTHONPATH=src python -m repro_torch.obs.replay_diff a.jsonl b.jsonl [-C N]

exits 0 when identical, 1 at the first divergence (printed with
context), 2 on unreadable input.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple


def _as_events(src) -> Tuple[List, str]:
    """Accept a path, an ExecutedTrace, a bus-bearing layer, or a plain
    event list; return (events, label)."""
    from repro_torch.workloads.trace_io import ExecutedTrace
    if isinstance(src, str):
        return ExecutedTrace.load(src).events, src
    if isinstance(src, ExecutedTrace):
        return src.events, "trace"
    bus = getattr(src, "events", src)
    log = getattr(bus, "log", None)
    if log is not None:
        return list(log), type(src).__name__
    return list(src), "events"


@dataclasses.dataclass
class Divergence:
    """Where two logs first disagree.  ``index`` is the position of the
    earliest differing event (== the length of the shorter log when one
    is a strict prefix of the other, with ``a``/``b`` None on the side
    that ran out)."""
    index: int
    a: Optional[object]
    b: Optional[object]
    context_a: List
    context_b: List
    label_a: str = "a"
    label_b: str = "b"

    def render(self) -> str:
        lines = [f"first divergence at event #{self.index}:"]
        for label, ev, ctx in ((self.label_a, self.a, self.context_a),
                               (self.label_b, self.b, self.context_b)):
            lines.append(f"--- {label} ---")
            start = self.index - len(ctx) + (1 if ev is not None else 0)
            for i, c in enumerate(ctx):
                mark = ">>" if start + i == self.index else "  "
                lines.append(f"{mark} #{start + i}: {tuple(c)}")
            if ev is None:
                lines.append(f">> #{self.index}: <log ended "
                             f"({self.index} events)>")
        return "\n".join(lines)


def first_divergence(a, b, context: int = 3) -> Optional[Divergence]:
    """Earliest differing event between two executed logs, or None when
    they are bit-identical.  ``a``/``b`` may be JSONL paths,
    ``ExecutedTrace`` objects, execution layers / buses, or event lists;
    ``context`` is the number of *preceding* events included per side."""
    ea, la = _as_events(a)
    eb, lb = _as_events(b)
    if la == lb:
        la, lb = f"{la}[0]", f"{lb}[1]"
    n = min(len(ea), len(eb))
    idx = None
    for i in range(n):
        if ea[i] != eb[i]:
            idx = i
            break
    if idx is None:
        if len(ea) == len(eb):
            return None
        idx = n    # strict prefix: diverges where the shorter log ends
    lo = max(0, idx - context)

    def side(evs):
        ev = evs[idx] if idx < len(evs) else None
        hi = idx + 1 if ev is not None else idx
        return ev, list(evs[lo:hi])

    eva, ctx_a = side(ea)
    evb, ctx_b = side(eb)
    return Divergence(index=idx, a=eva, b=evb, context_a=ctx_a,
                      context_b=ctx_b, label_a=la, label_b=lb)


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.replay_diff",
        description="first-divergence diff of two executed event logs")
    p.add_argument("a", help="executed-trace JSONL (run A)")
    p.add_argument("b", help="executed-trace JSONL (run B)")
    p.add_argument("-C", "--context", type=int, default=3,
                   help="preceding events to show per side (default 3)")
    ns = p.parse_args(argv)
    try:
        div = first_divergence(ns.a, ns.b, context=ns.context)
    except (OSError, ValueError) as e:
        print(f"error: {e}")
        return 2
    if div is None:
        print("identical")
        return 0
    print(div.render())
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
