"""Residency bookkeeping for tiered graph storage.

A copy of the JAX package's ``storage/tiers.py`` (the port imports nothing
of that package).

One ``TierStore`` per compiled graph. Every dense/level block registers
at ``enable_tiering`` time with its device footprint (int8 cells plus
the packed bit planes when the block is bit-kernel eligible); the store
then tracks, per block:

* **resident** — the device arrays (``(cells, bits)``) held hot, or a
  ``sharded`` flag when the mesh backend owns the placement,
* **pinned** — overlay-touched blocks that must stay hot until the next
  compaction fold rebuilds the graph (a fresh fold gets a fresh store,
  which is how pins reset),
* **access counters** — a total plus an exponentially decayed "recent"
  score the placement sweep and the eviction policy order by.

Placement policy: promote on miss (a streamed block stays resident if
it fits under ``budget * headroom`` after evicting colder unpinned
blocks), demote coldest-first, never evict pinned blocks (pins may
overshoot the budget — the gauges make that visible rather than hiding
it). All bookkeeping runs under one internal lock; device arrays are
only *referenced* here, never synced, so the lock discipline lint's
no-host-sync-under-lock rule holds.

Metric families owned here (see docs/operations.md "Metrics
reference"): ``engine_tier_hot_bytes`` / ``engine_tier_cold_bytes`` /
``engine_tier_hot_blocks`` / ``engine_tier_cold_blocks`` /
``engine_tier_pinned_blocks`` gauges, ``engine_tier_hits_total`` /
``engine_tier_misses_total`` / ``engine_tier_promotions_total`` /
``engine_tier_demotions_total`` counters, and the
``engine_tier_miss_stall_seconds`` histogram that prices what demand
streaming costs the dispatch path.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

from ..utils.metrics import metrics

# Fraction of the budget admissions aim for; the slack absorbs the next
# stream-in without an eviction storm on every miss.
HEADROOM = 0.85

# Multiplicative decay applied to each block's "recent" score per
# placement sweep; ~5 sweeps of silence cost a block its heat.
DECAY = 0.5


class _Entry:
    __slots__ = ("idx", "nbytes", "level", "payload", "sharded", "pinned",
                 "accesses", "recent")

    def __init__(self, idx: int, nbytes: int, level: int):
        self.idx = idx
        self.nbytes = int(nbytes)
        self.level = int(level)
        self.payload: Optional[tuple] = None
        self.sharded = False
        self.pinned = False
        self.accesses = 0
        self.recent = 0.0


class TierStore:
    def __init__(self, budget_bytes: int, arena, headroom: float = HEADROOM):
        self.budget_bytes = max(0, int(budget_bytes))
        self.arena = arena
        self.headroom = float(headroom)
        self._lock = threading.Lock()
        self._entries: Dict[int, _Entry] = {}
        self._hot_bytes = 0
        # Demand-set cache: (seed ranges, query ranges, overlay watermark)
        # -> active block tuple. Bounded; see demand_cache_get/put.
        self._demand: Dict[tuple, tuple] = {}
        self._hits = metrics.counter("engine_tier_hits_total")
        self._misses = metrics.counter("engine_tier_misses_total")
        self._promotions = metrics.counter("engine_tier_promotions_total")
        self._demotions = metrics.counter("engine_tier_demotions_total")
        self._stall = metrics.histogram("engine_tier_miss_stall_seconds")
        from .prefetch import Prefetcher
        self.prefetcher = Prefetcher()

    # ------------------------------------------------------------------
    # registration / introspection

    def register(self, idx: int, nbytes: int, level: int) -> None:
        with self._lock:
            self._entries[idx] = _Entry(idx, nbytes, level)

    def total_bytes(self) -> int:
        with self._lock:
            return sum(e.nbytes for e in self._entries.values())

    def hot_bytes(self) -> int:
        with self._lock:
            return self._hot_bytes

    def stats(self) -> dict:
        with self._lock:
            hot = [e for e in self._entries.values()
                   if e.payload is not None or e.sharded]
            cold_n = len(self._entries) - len(hot)
            return {
                "blocks": len(self._entries),
                "hot_blocks": len(hot),
                "cold_blocks": cold_n,
                "hot_bytes": self._hot_bytes,
                "cold_bytes": sum(e.nbytes for e in self._entries.values()
                                  if e.payload is None and not e.sharded),
                "pinned_blocks": sum(1 for e in self._entries.values()
                                     if e.pinned),
                "accesses": {i: e.accesses
                             for i, e in self._entries.items()},
            }

    def entry_resident(self, idx: int) -> bool:
        with self._lock:
            e = self._entries.get(idx)
            return bool(e and (e.payload is not None or e.sharded))

    def entry_accesses(self, idx: int) -> int:
        with self._lock:
            e = self._entries.get(idx)
            return e.accesses if e else 0

    def peek(self, idx: int) -> Optional[tuple]:
        """Resident payload without recording an access (incremental
        edits and tests; dispatches go through lookup)."""
        with self._lock:
            e = self._entries.get(idx)
            return e.payload if e else None

    # ------------------------------------------------------------------
    # dispatch path

    def lookup(self, active: Sequence[int]
               ) -> Tuple[Dict[int, tuple], List[int]]:
        """Record one access per active block; return the resident
        payloads and the (level-ordered) list of blocks that must
        stream in."""
        hot: Dict[int, tuple] = {}
        missing: List[_Entry] = []
        n_hit = n_miss = 0
        with self._lock:
            for i in active:
                e = self._entries[i]
                e.accesses += 1
                e.recent += 1.0
                if e.payload is not None:
                    hot[i] = e.payload
                    n_hit += 1
                else:
                    missing.append(e)
                    n_miss += 1
        if n_hit:
            self._hits.inc(n_hit)
        if n_miss:
            self._misses.inc(n_miss)
        missing.sort(key=lambda e: (e.level, e.idx))
        return hot, [e.idx for e in missing]

    def observe_stall(self, seconds: float) -> None:
        self._stall.observe(max(0.0, float(seconds)))

    def admit(self, idx: int, payload: tuple,
              pinned: bool = False) -> bool:
        """Promote a freshly streamed block if it fits under
        ``budget * headroom`` after evicting colder unpinned residents;
        otherwise leave it transient (the dispatch that streamed it
        holds the only reference and it dies with the dispatch).
        Pinned admits always stick."""
        cap = int(self.budget_bytes * self.headroom)
        evicted: List[int] = []
        with self._lock:
            e = self._entries[idx]
            if e.payload is not None:
                e.payload = payload
                e.pinned = e.pinned or pinned
                return True
            if not pinned and e.nbytes + self._hot_bytes > cap:
                victims = sorted(
                    (v for v in self._entries.values()
                     if v.payload is not None and not v.pinned),
                    key=lambda v: (v.recent, v.accesses))
                freed = 0
                need = e.nbytes + self._hot_bytes - cap
                take = []
                for v in victims:
                    if freed >= need or v.recent >= e.recent:
                        break
                    take.append(v)
                    freed += v.nbytes
                if freed < need:
                    return False
                for v in take:
                    v.payload = None
                    self._hot_bytes -= v.nbytes
                    evicted.append(v.idx)
            e.payload = payload
            e.pinned = e.pinned or pinned
            self._hot_bytes += e.nbytes
        self._promotions.inc()
        if evicted:
            self._demotions.inc(len(evicted))
        return True

    def replace(self, idx: int, payload: tuple) -> None:
        """Swap the resident payload in place (incremental cell edits on
        a hot block). No-op for cold blocks."""
        with self._lock:
            e = self._entries.get(idx)
            if e is not None and e.payload is not None:
                e.payload = payload

    def demote(self, idx: int) -> bool:
        with self._lock:
            e = self._entries.get(idx)
            if e is None or e.payload is None or e.pinned:
                return False
            e.payload = None
            self._hot_bytes -= e.nbytes
        self._demotions.inc()
        return True

    def pin(self, idx: int) -> None:
        with self._lock:
            e = self._entries.get(idx)
            if e is not None:
                e.pinned = True

    def mark_sharded(self, idxs: Sequence[int]) -> None:
        """Account blocks the mesh backend placed (sharded device
        arrays are owned by ShardedGraph, not streamed per dispatch)."""
        with self._lock:
            for i in idxs:
                e = self._entries.get(i)
                if e is not None and not e.sharded:
                    e.sharded = True
                    self._hot_bytes += e.nbytes

    # ------------------------------------------------------------------
    # placement sweep (compaction thread)

    def place(self) -> List[int]:
        """Periodic sweep: decay recency, demote resident unpinned
        blocks that have gone cold while over headroom, and return the
        pinned-but-cold block indices the caller should materialize
        (overlay-touched blocks promote eagerly so the write path never
        pays their stream-in)."""
        cap = int(self.budget_bytes * self.headroom)
        demoted: List[int] = []
        want_hot: List[int] = []
        with self._lock:
            for e in self._entries.values():
                e.recent *= DECAY
            if self._hot_bytes > cap:
                for e in sorted((v for v in self._entries.values()
                                 if v.payload is not None and not v.pinned),
                                key=lambda v: (v.recent, v.accesses)):
                    if self._hot_bytes <= cap:
                        break
                    e.payload = None
                    self._hot_bytes -= e.nbytes
                    demoted.append(e.idx)
            want_hot = [e.idx for e in self._entries.values()
                        if e.pinned and e.payload is None and not e.sharded]
        if demoted:
            self._demotions.inc(len(demoted))
        return want_hot

    # ------------------------------------------------------------------
    # demand-set cache

    def demand_cache_get(self, key: tuple) -> Optional[tuple]:
        with self._lock:
            return self._demand.get(key)

    def demand_cache_put(self, key: tuple, active: tuple) -> None:
        with self._lock:
            if len(self._demand) >= 64:
                self._demand.pop(next(iter(self._demand)))
            self._demand[key] = active

    # ------------------------------------------------------------------
    # gauges

    def publish_gauges(self) -> None:
        s = self.stats()
        metrics.gauge("engine_tier_hot_bytes").set(s["hot_bytes"])
        metrics.gauge("engine_tier_cold_bytes").set(s["cold_bytes"])
        metrics.gauge("engine_tier_hot_blocks").set(s["hot_blocks"])
        metrics.gauge("engine_tier_cold_blocks").set(s["cold_blocks"])
        metrics.gauge("engine_tier_pinned_blocks").set(s["pinned_blocks"])

    def close(self) -> None:
        self.prefetcher.shutdown()
