# Copied from src/repro/core/ready_queue.py; `repro.` rewritten to `repro_torch.`.
"""Indexed ready queue: the event core's O(log n) policy-selection engine.

The historical ready queue was a plain ``List[Task]`` that every policy
rescanned on every wake-up: ``accrue_tokens`` walked all waiting tasks in
Python, ``token_threshold`` took a full max, and ``select`` was an O(n)
``min`` with a tuple-key lambda.  Under sustained backlog (the million-task
traces ``benchmarks/simperf.py`` measures) that goes quadratic in queued
work and dominates the run.  :class:`ReadyQueue` replaces the list with

* dense float64 arrays (tokens, last-wake, priority, accrual denominator)
  so Algorithm-2 token accrual is one vectorized numpy pass — elementwise
  float64 ops are **bit-identical** to the scalar loop, which is what lets
  the fast path keep the frozen-path parity contract
  (tests/test_fastpath_parity.py);
* per-policy indexed heaps over keys that are *frozen while a task waits*
  (arrival, priority, predicted-remaining: ``executed`` only moves while
  running or at the preempt/kill that precedes re-insertion), with lazy
  dead-entry skipping — entries carry a membership generation and are
  discarded on peek when stale;
* token *level buckets*: tokens are monotone non-decreasing and seeded at
  the task's priority (≥ 1), so the paper's "max token rounded down to a
  priority level" threshold always selects exactly the highest non-empty
  bucket of ``[1,3) / [3,9) / [9,∞)`` — an O(1) peek instead of a max
  plus a filter pass.  Level crossings are detected vectorized during
  accrual and re-push the task into its new bucket's heap.

The queue quacks like the list it replaces (``append`` / ``remove`` /
``len`` / ``in`` / iteration), so the simulator loops swap it in without
branching and custom ``Policy`` subclasses that iterate the ready set keep
working (iteration first syncs ``tokens``/``last_wake`` back onto the Task
objects).  Built-in policies dispatch to the fast selectors in
``scheduler.py`` when handed a ReadyQueue and keep their historical
list-scanning code otherwise.
"""
from __future__ import annotations

import heapq
from typing import Iterator, List, Optional

import numpy as np

from repro_torch.core.task import PRIORITY_LEVELS, Task

# Bucket boundaries: PRIORITY_LEVELS == (1, 3, 9).  Tokens start at the
# task's priority (>= 1) and never decrease, so bucket membership tracks
# "tokens >= level" exactly.
_L1 = float(PRIORITY_LEVELS[1])
_L2 = float(PRIORITY_LEVELS[2])

# Policies with an indexed fast path; anything else (round-robin's stateful
# cycle, custom subclasses) falls back to iteration over the queue.
INDEXED_POLICIES = ("fcfs", "hpf", "sjf", "token", "prema")
_LEVELED = ("token", "prema")


class ReadyQueue:
    """Slotted ready set for one policy's key discipline.

    ``policy`` picks which heap keys are maintained:

    =========  =========================  ==========================
    policy     heap key (frozen)          structure
    =========  =========================  ==========================
    fcfs       (arrival, tid)             single heap
    hpf        (-priority, arrival, tid)  single heap
    sjf        (predicted_rem, tid)       single heap
    token      (arrival, tid)             one heap per token bucket
    prema      (predicted_rem, tid)       one heap per token bucket
    other      —                          iteration fallback only
    =========  =========================  ==========================
    """

    def __init__(self, policy: str = "fcfs", capacity: int = 64):
        self.policy = policy
        self._leveled = policy in _LEVELED
        self._indexed = policy in INDEXED_POLICIES
        cap = max(int(capacity), 8)
        self._n = 0
        self._tok = np.empty(cap)           # tokens
        self._lw = np.empty(cap)            # last_wake
        self._pr = np.empty(cap)            # float(priority)
        self._dn = np.empty(cap)            # max(predicted_total, 1e-9)
        self._nb = np.empty(cap)            # next bucket boundary (inf at top)
        self._scratch = np.empty(cap)       # accrual workspace
        self._lev = np.zeros(cap, dtype=np.int8)
        self._accrued_at = float("-inf")    # last accrual instant
        self._dirty = False                 # membership changed since then
        self._tasks: List[Optional[Task]] = [None] * cap
        self._gens: List[int] = [0] * cap   # membership generation per slot
        self._keys: List[float] = [0.0] * cap   # primary heap key per slot
        self._slot = {}                     # tid -> slot
        self._gen_counter = 0
        if self._leveled:
            self._heaps = ([], [], [])      # one per token bucket
        elif self._indexed:
            self._heaps = ([],)
        else:
            self._heaps = ()
        self._counts = [0, 0, 0]            # bucket populations

    # -- container protocol (list-compatible surface) ------------------
    def __len__(self) -> int:
        return self._n

    def __bool__(self) -> bool:
        return self._n > 0

    def __contains__(self, task: Task) -> bool:
        s = self._slot.get(task.tid)
        return s is not None and self._tasks[s] is task

    def __iter__(self) -> Iterator[Task]:
        """Iterate current members (syncing queue-held token state back
        onto the Task objects first, so policies that scan attributes see
        fresh values)."""
        self.sync_tasks()
        return iter(self._tasks[:self._n])

    def sync_tasks(self) -> None:
        """Write queue-held ``tokens``/``last_wake`` back to every member."""
        for i in range(self._n):
            t = self._tasks[i]
            t.tokens = float(self._tok[i])
            t.last_wake = float(self._lw[i])

    # ------------------------------------------------------------------
    def _grow(self) -> None:
        cap = len(self._tasks) * 2
        for name in ("_tok", "_lw", "_pr", "_dn", "_nb", "_scratch"):
            arr = np.empty(cap)
            arr[:self._n] = getattr(self, name)[:self._n]
            setattr(self, name, arr)
        lev = np.zeros(cap, dtype=np.int8)
        lev[:self._n] = self._lev[:self._n]
        self._lev = lev
        pad = cap - len(self._tasks)
        self._tasks.extend([None] * pad)
        self._gens.extend([0] * pad)
        self._keys.extend([0.0] * pad)

    def append(self, task: Task) -> None:
        """Insert a task; captures its frozen policy key and current token
        state.  (Named after the list method it replaces.)"""
        if self._n == len(self._tasks):
            self._grow()
        i = self._n
        self._n = i + 1
        tid = task.tid
        tok = task.tokens
        self._tok[i] = tok
        self._lw[i] = task.last_wake
        self._pr[i] = float(task.priority)
        self._dn[i] = max(task.predicted_total, 1e-9)
        self._tasks[i] = task
        self._slot[tid] = i
        self._gen_counter += 1
        gen = self._gen_counter
        self._gens[i] = gen
        lev = 2 if tok >= _L2 else (1 if tok >= _L1 else 0)
        self._lev[i] = lev
        self._nb[i] = _L1 if lev == 0 else (_L2 if lev == 1 else np.inf)
        self._counts[lev] += 1
        self._dirty = True
        if not self._indexed:
            return
        if self.policy in ("fcfs", "token"):
            key = task.arrival
        elif self.policy == "hpf":
            key = task.arrival       # secondary; primary is -priority below
        else:                        # sjf / prema
            key = task.predicted_remaining
        self._keys[i] = key
        heap = self._heaps[lev if self._leveled else 0]
        if self.policy == "hpf":
            heapq.heappush(heap, (-task.priority, key, tid, gen))
        else:
            heapq.heappush(heap, (key, tid, gen))

    def remove(self, task: Task) -> None:
        """Remove a member (syncs token state back onto the Task); its
        heap entries die lazily via the generation check."""
        i = self._slot.pop(task.tid)
        task.tokens = float(self._tok[i])
        task.last_wake = float(self._lw[i])
        self._counts[self._lev[i]] -= 1
        last = self._n - 1
        if i != last:   # swap-remove: move the tail slot down
            for arr in (self._tok, self._lw, self._pr, self._dn, self._nb,
                        self._lev):
                arr[i] = arr[last]
            self._tasks[i] = self._tasks[last]
            self._gens[i] = self._gens[last]
            self._keys[i] = self._keys[last]
            self._slot[self._tasks[i].tid] = i
        self._tasks[last] = None
        self._n = last

    # -- Algorithm 2, vectorized ---------------------------------------
    def accrue(self, now: float) -> None:
        """Token accrual for every waiting task in one numpy pass.

        Elementwise float64 ops reproduce the scalar loop bit-exactly:
        ``idle = max(0, now - last_wake); tokens += priority *
        (idle / max(predicted_total, 1e-9))``.
        """
        n = self._n
        if n == 0:
            return
        if now == self._accrued_at and not self._dirty:
            return   # same-instant re-wake with no new members: a +0.0
        tok = self._tok[:n]
        lw = self._lw[:n]
        idle = self._scratch[:n]
        np.subtract(now, lw, out=idle)
        np.maximum(idle, 0.0, out=idle)
        idle /= self._dn[:n]
        idle *= self._pr[:n]
        tok += idle
        lw[:] = now
        self._accrued_at = now
        self._dirty = False
        if not self._leveled:
            return
        # bucket crossings (monotone upward): re-push into the new bucket
        moved = np.nonzero(tok >= self._nb[:n])[0]
        if moved.size == 0:
            return
        counts, heaps = self._counts, self._heaps
        for i in moved:
            t = tok[i]
            new = 2 if t >= _L2 else 1
            counts[self._lev[i]] -= 1
            counts[new] += 1
            self._lev[i] = new
            self._nb[i] = _L2 if new == 1 else np.inf
            heapq.heappush(heaps[new],
                           (self._keys[i], self._tasks[i].tid, self._gens[i]))

    # -- selection ------------------------------------------------------
    def threshold(self) -> float:
        """Paper token threshold: max tokens rounded down to a priority
        level == the highest non-empty bucket's level."""
        if self._counts[2]:
            return _L2
        if self._counts[1]:
            return _L1
        return float(PRIORITY_LEVELS[0])

    def _peek(self, heap, leveled_at: int = -1) -> Optional[Task]:
        slot, gens = self._slot, self._gens
        while heap:
            entry = heap[0]
            tid, gen = entry[-2], entry[-1]
            i = slot.get(tid)
            if (i is not None and gens[i] == gen
                    and (leveled_at < 0 or self._lev[i] == leveled_at)):
                t = self._tasks[i]
                t.tokens = float(self._tok[i])
                t.last_wake = float(self._lw[i])
                return t
            heapq.heappop(heap)
        return None

    def select(self) -> Optional[Task]:
        """The policy's candidate under its key discipline (peek, no
        removal); token state is synced onto the returned Task so
        ``may_preempt`` sees fresh values."""
        if self._n == 0:
            return None
        if self._leveled:
            lev = 2 if self._counts[2] else (1 if self._counts[1] else 0)
            return self._peek(self._heaps[lev], leveled_at=lev)
        return self._peek(self._heaps[0])


def make_ready(policy_name: str):
    """Ready-set factory for the simulator loops: an indexed
    :class:`ReadyQueue` for policies with a fast path, iteration-fallback
    queue otherwise (custom policies scan it like the list it mimics)."""
    return ReadyQueue(policy_name if policy_name in INDEXED_POLICIES
                      else "plain")
