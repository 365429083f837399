"""Host-clock spans and counters inside the port: the serving engine's
round, pick, checkpoint, restore and completion, the executor's calls and
their parts, each model block and its mixer and MLP, the attention
kernels' calls, and the Python garbage collector's pauses.

Unlike the rest of ``obs/`` this does not ride the event bus: bus events
carry the engine's virtual time, spans here the host's.  The clock is
``time.perf_counter_ns``, the clock of ``time.perf_counter``, so a span
lines up with any host-clock record taken with either, and with a device
trace placed on that clock.

It records only while the operator has switched it on (:func:`enable`,
:func:`disable` or the :func:`recording` context) or a ``torch.profiler``
session is active, so that a profiled run gets the host spans that explain
its device trace.  :func:`arm` decides, once at each ``ServingEngine.run``
entry and once per executor call; the module flag ``ON`` holds the answer
until the next :func:`arm`.  A span site reads ``ON`` and, when it is
false, does nothing else::

    t0 = host.ON and host.now()
    ...
    if t0:
        host.add("exec.decode", t0, host.now(), attrs)

The collector's pauses are spans named ``gc`` from a ``gc.callbacks``
entry that is registered only while recording.

Kept, for the process, like the profiler it follows: per span name exact
aggregates (count, total and longest ns); the raw spans ``(name, t0_ns,
t1_ns, attrs)`` up to ``RAW_LIMIT``, later ones only counted
(:func:`dropped`); integer counters.  :func:`reset` clears them.
"""
from __future__ import annotations

import contextlib
import gc
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch

now = time.perf_counter_ns
RAW_LIMIT = 1 << 20

ON = False                      # read by every span site
_switch = False                 # the operator's
_agg: Dict[str, List[int]] = {}                 # name -> [count, total, max]
_raw: List[Tuple[str, int, int, Any]] = []
_dropped = 0
_counters: Dict[str, int] = {}
_gc_t0 = 0


def arm() -> bool:
    """Record from here on if the operator switched recording on or a
    profiler session is active; registers or removes the collector's
    callback when that changes.  Returns ``ON``."""
    global ON
    on = _switch or torch.autograd.profiler._is_profiler_enabled
    if on != ON:
        ON = on
        if on:
            gc.callbacks.append(_on_gc)
        else:
            gc.callbacks.remove(_on_gc)
    return on


def enable() -> None:
    global _switch
    _switch = True
    arm()


def disable() -> None:
    """Stop recording, unless a profiler session is active."""
    global _switch
    _switch = False
    arm()


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Record inside the block; the switch is as it was afterwards."""
    global _switch
    was = _switch
    enable()
    try:
        yield
    finally:
        _switch = was
        arm()


def add(name: str, t0: int, t1: int, attrs: Any = None) -> None:
    """One finished span, ``t0`` and ``t1`` from :data:`now`."""
    global _dropped
    d = t1 - t0
    a = _agg.get(name)
    if a is None:
        _agg[name] = [1, d, d]
    else:
        a[0] += 1
        a[1] += d
        if d > a[2]:
            a[2] = d
    if len(_raw) < RAW_LIMIT:
        _raw.append((name, t0, t1, attrs))
    else:
        _dropped += 1


def count(name: str, n: int = 1) -> None:
    _counters[name] = _counters.get(name, 0) + n


def _on_gc(phase: str, info: Dict[str, int]) -> None:
    global _gc_t0
    if phase == "start":
        _gc_t0 = now()
    elif _gc_t0:
        add("gc", _gc_t0, now(), (info["generation"], info["collected"]))
        count("gc_collections")
        _gc_t0 = 0


def reset() -> None:
    """Forget every span and counter (the switch and ``ON`` stay)."""
    global _dropped
    _agg.clear()
    _raw.clear()
    _counters.clear()
    _dropped = 0


def spans(t0_ns: Optional[int] = None, t1_ns: Optional[int] = None,
          name: Optional[str] = None) -> List[Tuple[str, int, int, Any]]:
    """The raw spans (of ``name``, if given) that overlap
    [``t0_ns``, ``t1_ns``], in the order they ended."""
    lo = float("-inf") if t0_ns is None else t0_ns
    hi = float("inf") if t1_ns is None else t1_ns
    return [s for s in _raw
            if (name is None or s[0] == name) and s[2] >= lo and s[1] <= hi]


def counters() -> Dict[str, int]:
    return dict(_counters)


def dropped() -> int:
    """Spans past ``RAW_LIMIT``: in the aggregates, not in :func:`spans`."""
    return _dropped


def summary() -> Dict[str, Dict[str, float]]:
    """Per span name: count, total ms, mean and longest µs (exact, the
    dropped spans included)."""
    return {name: {"count": n, "total_ms": total / 1e6,
                   "mean_us": total / n / 1e3, "max_us": longest / 1e3}
            for name, (n, total, longest) in sorted(_agg.items())}
