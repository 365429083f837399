# Copied from src/repro/core/faults.py; `repro.` rewritten to `repro_torch.`.
"""Deterministic failure injection: device crashes and repairs.

PREMA's preemption machinery (checkpoint / drain / kill, paper §IV) is
exactly what a fault-tolerant cluster needs — a checkpoint is a
crash-consistent snapshot — so this module closes the loop the ROADMAP
asked for: devices can *fail* mid-run and the in-flight task's
un-checkpointed progress is lost, not silently dropped.

:class:`FaultInjector` is the one source of failure times.  Two layers
compose:

* **Stochastic MTBF/MTTR processes** — per-device exponential
  time-between-failures (``mtbf``) and time-to-repair (``mttr``) streams.
  Each device draws from its own ``numpy`` Generator keyed ``(seed,
  dev)``, in a fixed fail→repair→fail order, so the schedule is a pure
  function of ``(seed, mtbf, mttr)`` per device — independent of how
  devices interleave and of what the workload does.  ``horizon`` bounds
  how far ahead failures are generated.
* **Scripted faults** — explicit ``fail_at`` / ``recover_at`` instants
  per device, for regression tests and benchmarks that need one exact
  crash ("kill device 1 at t=3.2ms").

The injector only *answers questions* (``first_failure`` / ``repair_at``
/ ``next_failure`` and the scripted entries); the execution layer owns
the clock and turns the answers into ``device_fail`` /
``device_recover`` events on the shared bus
(:class:`repro_torch.core.events.EventBus`).  ``ClusterSimulator`` integrates
it through ``ClusterConfig(faults=...)`` (see ``core/cluster.py``): on
failure the resident task is re-queued from its last durable checkpoint
(KILL-style restart when none exists), the device contributes zero
capacity until repaired, and ``core/autoscaler.py`` can provision
replacement capacity (``AutoscalerConfig(replace_failed=True)``).

A ``FaultInjector`` with no MTBF and no script is inert: a run configured
with one is bit-identical to a run with ``faults=None``
(tests/test_fastpath_parity.py).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# A scripted entry: (time, "fail" | "recover", device index).
ScriptEntry = Tuple[float, str, int]

SCRIPT_KINDS = ("fail", "recover")


@dataclasses.dataclass
class FaultInjector:
    """Deterministic per-device failure/repair schedule.

    ``mtbf``/``mttr`` are mean seconds between failures / to repair
    (exponential); ``None`` mtbf disables the stochastic process (a pure
    script).  ``script`` holds explicit ``(t, "fail"|"recover", dev)``
    entries; both sources may be combined.  ``horizon`` (seconds) stops
    generating stochastic failures past that instant — leave ``None`` to
    let the execution layer bound the run (it stops rescheduling once
    all work has settled).
    """

    mtbf: Optional[float] = None
    mttr: float = 0.0
    seed: int = 0
    script: Sequence[ScriptEntry] = ()
    horizon: Optional[float] = None

    def __post_init__(self):
        if self.mtbf is not None and self.mtbf <= 0:
            raise ValueError("mtbf must be > 0 (or None to disable)")
        if self.mttr < 0:
            raise ValueError("mttr must be >= 0")
        for t, kind, dev in self.script:
            if kind not in SCRIPT_KINDS:
                raise ValueError(f"script kind must be in {SCRIPT_KINDS}, "
                                 f"got {kind!r}")
            if dev < 0:
                raise ValueError(f"script device must be >= 0, got {dev}")
        self._rngs: Dict[int, np.random.Generator] = {}

    # -- lifecycle ------------------------------------------------------
    def reset(self) -> None:
        """Start of a run: rewind every per-device stream (same injector
        instance ⇒ same schedule on every run)."""
        self._rngs = {}

    @property
    def active(self) -> bool:
        """Whether this injector can ever produce a fault."""
        return self.mtbf is not None or len(self.script) > 0

    def scripted(self) -> List[ScriptEntry]:
        """The explicit entries, in time order (stable on ties)."""
        return sorted(self.script, key=lambda e: (e[0], SCRIPT_KINDS.index(e[1]), e[2]))

    # -- stochastic draws ----------------------------------------------
    def _rng(self, dev: int) -> np.random.Generator:
        rng = self._rngs.get(dev)
        if rng is None:
            rng = self._rngs[dev] = np.random.default_rng([self.seed, dev])
        return rng

    def _clip(self, t: float) -> Optional[float]:
        if self.horizon is not None and t > self.horizon:
            return None
        return t

    def first_failure(self, dev: int, now: float) -> Optional[float]:
        """Absolute time of device ``dev``'s first stochastic failure at
        or after ``now`` (None: no stochastic process / past horizon)."""
        if self.mtbf is None:
            return None
        return self._clip(now + float(self._rng(dev).exponential(self.mtbf)))

    # the draw order per device is fixed (fail, repair, fail, ...), so
    # next_failure after a repair is the same stream continuing
    next_failure = first_failure

    def repair_at(self, dev: int, now: float) -> float:
        """Absolute time device ``dev`` comes back after failing at
        ``now``.  Scripted failures with no scripted recovery heal
        through the same MTTR process; ``mttr == 0`` repairs instantly."""
        if self.mttr <= 0:
            return now
        return now + float(self._rng(dev).exponential(self.mttr))

    def describe(self) -> Dict:
        """Configuration summary for benchmark JSON metadata."""
        return {"mtbf": self.mtbf, "mttr": self.mttr, "seed": self.seed,
                "n_scripted": len(self.script), "horizon": self.horizon}
