# Copied from src/repro/workloads/arrivals.py; `repro.` rewritten to `repro_torch.`.
"""Arrival processes: when the sampled tasks hit the cluster.

Every process maps ``(rng, service_times) -> arrival times`` for one task
each; ``service_times[i]`` is task *i*'s isolated service estimate, which
processes that pace themselves off the work itself (``uniform_window``,
``closed_loop``) consume and open-loop processes ignore.  All sampling goes
through the passed ``numpy.random.Generator``, so a (process, seed) pair is
a complete, replayable description of the arrival pattern.

=================  ========================================================
``uniform_window``  the paper's §III dispatch: uniform over a contention
                    window (a fraction of the summed isolated time) —
                    bit-compatible with the pre-refactor generator.
``poisson``         open-loop memoryless arrivals at a fixed rate (req/s);
                    the classic sustained-traffic model.
``mmpp``            Markov-modulated Poisson: exponentially-dwelling ON/OFF
                    states with per-state rates — bursty traffic.
``diurnal``         non-homogeneous Poisson with a sinusoidal rate curve
                    (thinning), for day/night load patterns.
``closed_loop``     N clients issuing think-time-separated requests.  The
                    *reactive* form (:meth:`ClosedLoop.drive`) paces each
                    client off its previous request's actual completion/
                    drop event; :meth:`ClosedLoop.sample` is the
                    pre-sampled open-loop approximation (completion ≈
                    isolated service time) for replayable traces.
=================  ========================================================
"""
from __future__ import annotations

import collections
import dataclasses
import math
from typing import Dict, Optional

import numpy as np

from repro_torch.core.registry import Registry


class ArrivalProcess:
    """Base: ``sample`` returns one arrival time per service-time entry."""
    name = "base"

    def sample(self, rng: np.random.Generator,
               service_times: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def describe(self) -> Dict:
        d = {k: v for k, v in dataclasses.asdict(self).items()}
        d["process"] = self.name
        return d


@dataclasses.dataclass
class UniformWindow(ArrivalProcess):
    """§III compatibility: arrivals uniform over ``window`` seconds, which
    defaults to ``contention x sum(service_times)`` (0 → all at t=0,
    1 → spread over the whole serial makespan)."""
    contention: float = 0.5
    window: Optional[float] = None
    name = "uniform_window"

    def sample(self, rng, service_times):
        window = self.window
        if window is None:
            window = self.contention * float(np.sum(service_times))
        # one scalar draw per task, mirroring the legacy generator's loop
        # (bit-compatibility is part of this process's contract)
        return np.asarray([float(rng.uniform(0.0, window))
                           for _ in range(len(service_times))])


@dataclasses.dataclass
class Poisson(ArrivalProcess):
    """Open-loop Poisson arrivals at ``rate`` requests/second."""
    rate: float
    name = "poisson"

    def __post_init__(self):
        if self.rate <= 0:
            raise ValueError("poisson rate must be > 0")

    def sample(self, rng, service_times):
        n = len(service_times)
        return np.cumsum(rng.exponential(1.0 / self.rate, size=n))


@dataclasses.dataclass
class MMPP(ArrivalProcess):
    """Two-state Markov-modulated Poisson process (bursty ON/OFF traffic).

    Dwell times in each state are exponential with means ``mean_on`` /
    ``mean_off``; arrivals are Poisson at ``rate_on`` / ``rate_off`` while
    the state holds.  ``rate_off = 0`` gives a pure on-off burst source.
    """
    rate_on: float
    rate_off: float
    mean_on: float
    mean_off: float
    name = "mmpp"

    def __post_init__(self):
        if self.rate_on < 0 or self.rate_off < 0:
            raise ValueError("mmpp rates must be >= 0")
        if self.rate_on == 0 and self.rate_off == 0:
            raise ValueError("mmpp needs a positive rate in >= 1 state")
        if self.mean_on <= 0 or self.mean_off <= 0:
            raise ValueError("mmpp dwell means must be > 0")

    @classmethod
    def bursty(cls, rate: float, duty: float = 0.3,
               cycle: Optional[float] = None) -> "MMPP":
        """ON/OFF source with long-run average ``rate``: ON for
        ``duty x cycle`` at ``rate/duty``, silent otherwise."""
        if not 0 < duty <= 1:
            raise ValueError("duty must be in (0, 1]")
        if cycle is None:
            cycle = 20.0 / rate      # ~20 arrivals per ON burst
        return cls(rate_on=rate / duty, rate_off=0.0,
                   mean_on=duty * cycle, mean_off=(1.0 - duty) * cycle)

    def sample(self, rng, service_times):
        n = len(service_times)
        out = np.empty(n)
        t, k, on = 0.0, 0, True
        while k < n:
            rate = self.rate_on if on else self.rate_off
            dwell = rng.exponential(self.mean_on if on else self.mean_off)
            if rate > 0:
                # memorylessness: arrivals vs. state-switch race
                dt = rng.exponential(1.0 / rate)
                while dt < dwell and k < n:
                    t += dt
                    dwell -= dt
                    out[k] = t
                    k += 1
                    dt = rng.exponential(1.0 / rate)
            t += dwell
            on = not on
        return out


@dataclasses.dataclass
class Diurnal(ArrivalProcess):
    """Non-homogeneous Poisson with rate
    ``base_rate * (1 + amplitude * sin(2*pi*(t/period + phase)))`` via
    thinning.  ``phase`` (cycle fractions) shifts where in the day the
    trace starts: 0 starts on the rising edge, 0.75 at the trough — the
    autoscale benchmarks start there so scale-up is observable."""
    base_rate: float
    amplitude: float = 0.5
    period: float = 1.0
    phase: float = 0.0
    name = "diurnal"

    def __post_init__(self):
        if not 0 <= self.amplitude < 1:
            raise ValueError("amplitude must be in [0, 1)")

    def rate_at(self, t: float) -> float:
        return self.base_rate * (1.0 + self.amplitude * math.sin(
            2.0 * math.pi * (t / self.period + self.phase)))

    def sample(self, rng, service_times):
        n = len(service_times)
        lam_max = self.base_rate * (1.0 + self.amplitude)
        out = np.empty(n)
        t, k = 0.0, 0
        while k < n:
            t += rng.exponential(1.0 / lam_max)
            if rng.uniform() * lam_max <= self.rate_at(t):
                out[k] = t
                k += 1
        return out


@dataclasses.dataclass
class ClosedLoop(ArrivalProcess):
    """``n_clients`` synchronous clients with exponential think time.

    The *reactive* form (the real closed loop): :meth:`drive` runs an
    execution layer directly, dealing tasks to clients round-robin; each
    client issues its next request one freshly-sampled think time after
    its previous request's **actual** ``complete`` (or ``drop``) event,
    observed through the layer's event bus (``core/events.py``).  Under
    congestion the clients slow down with the system — offered throughput
    self-limits instead of growing an unbounded queue.

    ``open_frac``/``open_rate`` give the open/closed *hybrid* (partly-open
    loop): that fraction of the workload arrives as an open-loop Poisson
    stream at ``open_rate`` req/s regardless of completions, the rest is
    closed-loop.

    :meth:`sample` remains the pre-sampled open-loop *approximation*
    (completion ≈ isolated service time) for contexts that need a
    replayable arrival-time trace without running a simulator; it ignores
    the hybrid knobs.
    """
    n_clients: int
    think_time: float
    open_frac: float = 0.0      # hybrid: fraction arriving open-loop
    open_rate: float = 0.0      # hybrid: open-loop Poisson rate (req/s)
    name = "closed_loop"

    def __post_init__(self):
        if self.n_clients < 1:
            raise ValueError("n_clients must be >= 1")
        if not 0.0 <= self.open_frac <= 1.0:
            raise ValueError("open_frac must be in [0, 1]")
        if self.open_frac > 0 and self.open_rate <= 0:
            raise ValueError("hybrid mode (open_frac > 0) needs open_rate > 0")

    def sample(self, rng, service_times):
        n = len(service_times)
        clocks = np.zeros(self.n_clients)
        out = np.empty(n)
        for i in range(n):
            c = i % self.n_clients
            out[i] = clocks[c]
            clocks[c] += float(service_times[i]) + rng.exponential(
                self.think_time)
        return out

    def drive(self, layer, items, seed: int = 0):
        """Run ``layer`` (simulator, cluster, or engine) under reactive
        closed-loop arrivals over ``items`` (Tasks or InferenceRequests);
        returns the layer's ``run`` result.  See :class:`ClosedLoopDriver`."""
        return ClosedLoopDriver(self, items, seed=seed).run(layer)


class ClosedLoopDriver:
    """Event-driven client pool behind :class:`ClosedLoop`.

    ``items`` are dealt to clients round-robin (after carving off the
    leading ``open_frac`` slice as the hybrid open-loop stream — items are
    i.i.d. draws from the mix, so a prefix split is unbiased).  Each
    client owns its own RNG stream keyed by ``(seed, client)``, so think
    times resample deterministically in that client's completion order:
    same seed + same workload ⇒ bit-identical arrivals and event logs.

    The driver works against any layer exposing the common execution
    surface: ``events`` (an :class:`repro_torch.core.events.EventBus`),
    ``submit(item, at)`` (mid-run injection), and ``run(initial_items)``.
    A client whose request is shed by admission control observes the
    ``drop`` event and moves on to its next request after a think time,
    like a rejected user coming back later.
    """

    def __init__(self, process: ClosedLoop, items, seed: int = 0):
        items = list(items)
        self.process = process
        n_open = int(round(process.open_frac * len(items)))
        self._open_items = items[:n_open]
        self._queues = [collections.deque()
                        for _ in range(process.n_clients)]
        for i, item in enumerate(items[n_open:]):
            self._queues[i % process.n_clients].append(item)
        self._rngs = [np.random.default_rng([seed, c])
                      for c in range(process.n_clients)]
        self._open_rng = np.random.default_rng([seed, process.n_clients])
        self._owner: Dict[int, int] = {}      # in-flight tid -> client
        self.n_offered = 0

    @staticmethod
    def _tid(item) -> int:
        return item.tid if hasattr(item, "tid") else item.rid

    @staticmethod
    def _set_arrival(item, t: float) -> None:
        item.arrival = float(t)
        if hasattr(item, "last_wake"):
            item.last_wake = float(t)

    def _next_for(self, client: int, at: float, layer) -> None:
        queue = self._queues[client]
        if not queue:
            return
        item = queue.popleft()
        think = float(self._rngs[client].exponential(
            self.process.think_time))
        self._owner[self._tid(item)] = client
        self.n_offered += 1
        layer.submit(item, at + think)

    def run(self, layer):
        """Drive one run of ``layer``; returns ``layer.run``'s result."""
        bus = layer.events
        initial = []
        t = 0.0
        for item in self._open_items:       # open-loop Poisson side stream
            t += float(self._open_rng.exponential(1.0 / self.process.open_rate))
            self._set_arrival(item, t)
            self.n_offered += 1
            initial.append(item)
        for c, queue in enumerate(self._queues):
            if not queue:
                continue
            item = queue.popleft()
            t0 = float(self._rngs[c].exponential(self.process.think_time))
            self._set_arrival(item, t0)
            self._owner[self._tid(item)] = c
            self.n_offered += 1
            initial.append(item)

        def settled(ev) -> None:
            client = self._owner.pop(ev.tid, None)
            if client is not None:
                self._next_for(client, ev.t, layer)

        bus.on_complete(settled)
        bus.on_drop(settled)
        try:
            return layer.run(initial)
        finally:
            bus.unsubscribe("complete", settled)
            bus.unsubscribe("drop", settled)


_REGISTRY = Registry("arrival process")
_REGISTRY.register("uniform_window", UniformWindow)
_REGISTRY.register("poisson", Poisson)
_REGISTRY.register("mmpp", MMPP)
_REGISTRY.register("diurnal", Diurnal)
_REGISTRY.register("closed_loop", ClosedLoop)

ARRIVAL_NAMES = _REGISTRY.names


def make_arrival(name: str, **kwargs) -> ArrivalProcess:
    return _REGISTRY.make(name, **kwargs)
