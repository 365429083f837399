# Copied from src/repro/serving/kv_cache.py; `repro.` rewritten to `repro_torch.`.
"""KV/SSM-cache memory accounting with host-offload (vDNN-style, §VI-G).

On a real pod the cache pool lives in HBM; checkpointed contexts of
preempted tasks stay resident until the pool nears capacity, at which point
the DMA engine proactively migrates the coldest contexts to host memory
(overlapped with compute; we charge the PCIe transfer when it cannot be
hidden).  The engine consults this manager for the extra latency a
CHECKPOINT/restore pays under memory pressure.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

PCIE_BW = 32e9  # bytes/sec host link


@dataclasses.dataclass
class _Entry:
    nbytes: int
    on_host: bool = False
    last_touch: float = 0.0


class KVCacheManager:
    def __init__(self, capacity_bytes: int, pcie_bw: float = PCIE_BW,
                 hide_fraction: float = 0.75):
        """``hide_fraction`` of transfer time is hidden behind compute
        (proactive migration while the NPU is busy, §VI-G)."""
        self.capacity = int(capacity_bytes)
        self.pcie_bw = pcie_bw
        self.hide_fraction = hide_fraction
        self._entries: Dict[int, _Entry] = {}
        self.stats = {"offloads": 0, "fetches": 0, "offload_bytes": 0,
                      "peak_device_bytes": 0}

    # ------------------------------------------------------------------
    @property
    def device_bytes(self) -> int:
        return sum(e.nbytes for e in self._entries.values() if not e.on_host)

    @property
    def n_resident(self) -> int:
        """Registered contexts currently HBM-resident (not offloaded) —
        the batched engine's per-device co-residency count."""
        return sum(1 for e in self._entries.values() if not e.on_host)

    def register(self, rid: int, nbytes: int, now: float = 0.0) -> float:
        """Allocate a context; returns extra latency paid for evictions."""
        self._entries[rid] = _Entry(nbytes=int(nbytes), last_touch=now)
        lat = self._make_room(now)
        self.stats["peak_device_bytes"] = max(self.stats["peak_device_bytes"],
                                              self.device_bytes)
        return lat

    def resize(self, rid: int, nbytes: int, now: float = 0.0) -> float:
        if rid not in self._entries:
            return self.register(rid, nbytes, now)
        self._entries[rid].nbytes = int(nbytes)
        self._entries[rid].last_touch = now
        return self._make_room(now)

    def grow(self, rid: int, delta_bytes: int, now: float = 0.0) -> float:
        """Extend a context in place — the per-iteration KV append of
        batched decode (one token's cache slice per resident per step).
        Returns eviction latency, like :meth:`resize`."""
        e = self._entries.get(rid)
        if e is None:
            return self.register(rid, delta_bytes, now)
        e.nbytes += int(delta_bytes)
        e.last_touch = now
        lat = self._make_room(now)
        self.stats["peak_device_bytes"] = max(self.stats["peak_device_bytes"],
                                              self.device_bytes)
        return lat

    def release(self, rid: int):
        self._entries.pop(rid, None)

    def touch(self, rid: int, now: float) -> float:
        """Mark active; fetch back from host if offloaded.  Returns fetch
        latency (not hidden — the task is about to run)."""
        e = self._entries.get(rid)
        if e is None:
            return 0.0
        e.last_touch = now
        if e.on_host:
            e.on_host = False
            self.stats["fetches"] += 1
            return e.nbytes / self.pcie_bw
        return 0.0

    # ------------------------------------------------------------------
    def _make_room(self, now: float) -> float:
        """Evict cold contexts (LRU) until under capacity."""
        lat = 0.0
        if self.device_bytes <= self.capacity:
            return lat
        victims = sorted(
            (rid for rid, e in self._entries.items() if not e.on_host),
            key=lambda rid: self._entries[rid].last_touch)
        for rid in victims:
            if self.device_bytes <= self.capacity:
                break
            e = self._entries[rid]
            e.on_host = True
            self.stats["offloads"] += 1
            self.stats["offload_bytes"] += e.nbytes
            lat += e.nbytes / self.pcie_bw * (1.0 - self.hide_fraction)
        return lat
