"""Revision-keyed authorization decision cache with singleflight dedup.

A copy of the JAX package's ``engine/decision_cache.py`` (it holds no
JAX), kept here so the port imports nothing of that package, with one
repair: a schema cut's :meth:`DecisionCache.retire_affected` also
retires the fills in flight for the affected pairs (see there).

The serving-curve observation (Samyama arxiv 2603.08036, RedisGraph
arxiv 1905.01294): repeat-heavy traffic — watch fan-out,
dashboard polling, fleet-wide lists by the same service account — pays a
full slot-space fixpoint dispatch per request even when the query is
byte-identical to one answered microseconds ago at the same store
revision. This layer turns that into O(distinct queries per revision)
device dispatches:

- **Cache**: a sharded-lock LRU keyed by ``(kind, store revision, query
  fields)`` holding check verdicts (positive AND negative) and lookup
  masks. Invalidation is free: every write bumps ``store.revision``, so
  stale keys simply stop being probed and age out of the LRU.
- **Expiration exactness**: revision bumps do not cover relationship
  *expiration* (the clock revokes grants without a write), so every entry
  carries a deadline — the store's next upcoming expiration boundary at
  fill time (:meth:`~.store.Store.next_expiry`). An entry is valid only
  while ``now < deadline``; explicit-``now`` queries bypass the cache
  entirely (engine.py routes them around this module).
- **Singleflight**: concurrent misses on the same key share ONE in-flight
  engine future instead of dispatching twice. Piggybacked callers block
  on the winner's :class:`Flight`; errors propagate to every waiter and
  are NOT cached. Joining an in-flight computation shares the winner's
  dispatch-time clock — exactly the semantics of a fused
  :class:`~.batcher.LookupBatcher` batch, which this layer sits in front
  of (the batcher only ever sees true misses).

Values are stored raw; the ENGINE copies masks on read so callers can
never mutate a cached array (copy-on-read). Metrics:
``engine_decision_cache_hits_total`` / ``_misses_total`` (labeled by
kind), ``_evictions_total``, ``_piggybacks_total``, and gauges
``engine_decision_cache_entries`` / ``_mask_bytes``.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Optional

from ..utils.metrics import metrics

#: sentinel distinguishing "no entry" from any cached value (False/None
#: are legitimate verdicts — negative checks are cached too)
MISS = object()


class Flight:
    """One in-flight computation for a cache key — the singleflight unit.

    The leader registers the flight, dispatches the underlying engine
    future, then :meth:`launch`\\ es a ``finish`` thunk (result + cache
    fill). Followers (and the leader itself) call :meth:`result`, which
    runs ``finish`` exactly once and memoizes; errors re-raise to every
    caller and are never cached."""

    __slots__ = ("_lock", "_ready", "_finish", "_done", "_value", "_error",
                 "deadline")

    def __init__(self):
        self._lock = threading.Lock()
        self._ready = threading.Event()
        self._finish = None
        self._done = False
        self._value = None
        self._error: Optional[BaseException] = None
        # set by the leader's finish; lets a late joiner detect that the
        # resolved value's expiration deadline has already passed
        self.deadline = float("inf")

    def launch(self, finish) -> None:
        self._finish = finish
        self._ready.set()

    def abort(self, err: BaseException) -> None:
        """The leader's dispatch itself failed before a future existed:
        fail every waiter instead of leaving them parked forever."""
        with self._lock:
            self._error = err
            self._done = True
        self._ready.set()

    @property
    def done(self) -> bool:
        return self._done

    def result(self):
        self._ready.wait()
        with self._lock:
            if not self._done:
                try:
                    self._value = self._finish()
                except BaseException as e:  # noqa: BLE001 - fan out
                    self._error = e
                self._done = True
        if self._error is not None:
            raise self._error
        return self._value


class _Shard:
    __slots__ = ("lock", "entries", "mask_bytes")

    def __init__(self):
        self.lock = threading.Lock()
        # key -> (value, deadline, nbytes); insertion order IS recency
        self.entries: OrderedDict = OrderedDict()
        self.mask_bytes = 0


class DecisionCache:
    """Sharded-lock LRU + singleflight registry. Thread-safe.

    Budgets are split evenly across shards: ``max_entries`` bounds entry
    count (check verdicts and lookup masks alike) and ``max_mask_bytes``
    bounds resident mask payload bytes; whichever trips first evicts from
    that shard's cold end."""

    def __init__(self, max_entries: int = 65536,
                 max_mask_bytes: int = 256 << 20, shards: int = 16):
        shards = max(1, int(shards))
        self.max_entries = max(1, int(max_entries))
        self.max_mask_bytes = max(0, int(max_mask_bytes))
        self._shards = [_Shard() for _ in range(shards)]
        self._entry_budget = max(1, self.max_entries // shards)
        self._byte_budget = self.max_mask_bytes / shards
        self._flights: dict = {}
        self._flights_lock = threading.Lock()
        # set by clear(): an in-flight fill racing disable_decision_cache
        # must not re-populate (and re-inc the gauges of) a cache nothing
        # will ever clear again
        self._closed = False
        # the affected-pair sets of every retire_affected so far, in
        # order: a fill that began before one of them (put's ``since``)
        # never lands for a pair it retired
        self._retired: list = []

    def epoch(self) -> int:
        """The retirement count now: a fill reads it before it picks the
        graph it dispatches on, and passes it to :meth:`put` as
        ``since``."""
        return len(self._retired)

    @staticmethod
    def _pair(key: tuple) -> tuple:
        """(resource type, permission) of a check or lookup key."""
        return (key[2], key[4]) if key[0] == "check" else (key[2], key[3])

    # -- LRU -----------------------------------------------------------------

    def _shard(self, key) -> _Shard:
        return self._shards[hash(key) % len(self._shards)]

    def get(self, key: tuple, now: float, record: bool = True):
        """The cached value for ``key`` (may be False/None), or
        :data:`MISS`. A valid hit refreshes recency; an entry whose
        deadline has passed is dropped on the spot. ``record=False``
        probes without touching hit/miss counters (the middleware
        fast-path probe, whose misses are re-counted by the real call)."""
        sh = self._shard(key)
        with sh.lock:
            ent = sh.entries.get(key)
            if ent is not None:
                if now < ent[1]:
                    sh.entries.move_to_end(key)
                    if record:
                        metrics.counter("engine_decision_cache_hits_total",
                                        kind=key[0]).inc()
                    return ent[0]
                # expired at the watermark: exact expiration semantics —
                # the entry dies the instant the boundary passes
                del sh.entries[key]
                sh.mask_bytes -= ent[2]
                metrics.gauge("engine_decision_cache_entries").dec()
                metrics.gauge("engine_decision_cache_mask_bytes").dec(ent[2])
        if record:
            metrics.counter("engine_decision_cache_misses_total",
                            kind=key[0]).inc()
        return MISS

    def note_hits(self, kind: str, n: int) -> None:
        """Credit ``n`` hits counted outside :meth:`get` (the record-less
        probe path, once it is known the whole probe was served)."""
        if n:
            metrics.counter("engine_decision_cache_hits_total",
                            kind=kind).inc(n)

    def put(self, key: tuple, value, deadline: float, nbytes: int,
            now: float, since: Optional[int] = None) -> None:
        """Insert/refresh an entry. Born-dead entries (deadline already
        passed — a tuple expired while the query was in flight) are not
        stored, nor is a fill that began at retirement epoch ``since``
        when a later :meth:`retire_affected` covered its pair."""
        if deadline <= now:
            return
        nbytes = int(nbytes)
        sh = self._shard(key)
        evicted = 0
        freed = 0
        added = 0
        with sh.lock:
            # re-checked under the shard lock: clear() sets the flag
            # BEFORE draining shards, so a fill can never land in a shard
            # clear() has already passed
            if self._closed:
                return
            if since is not None and any(
                    self._pair(key) in a for a in self._retired[since:]):
                return
            old = sh.entries.pop(key, None)
            if old is not None:
                sh.mask_bytes -= old[2]
                freed += old[2]
                added -= 1
            sh.entries[key] = (value, deadline, nbytes)
            sh.mask_bytes += nbytes
            freed -= nbytes
            added += 1
            while len(sh.entries) > 1 and (
                    len(sh.entries) > self._entry_budget
                    or sh.mask_bytes > self._byte_budget):
                _, (_, _, nb) = sh.entries.popitem(last=False)
                sh.mask_bytes -= nb
                freed += nb
                evicted += 1
        if evicted:
            metrics.counter("engine_decision_cache_evictions_total").inc(
                evicted)
        metrics.gauge("engine_decision_cache_entries").inc(added - evicted)
        metrics.gauge("engine_decision_cache_mask_bytes").dec(freed)

    def clear(self) -> None:
        """Drop every entry (and fix the gauges) and refuse future fills:
        called when the engine disables the cache so /metrics does not
        report phantom residency — including from a fill that was already
        in flight when the cache was detached. Its flights go too, and
        :meth:`flight` on a closed cache joins none: a caller that read
        this cache just before a restore replaced it must not piggyback
        on a flight of the replaced lineage."""
        self._closed = True
        with self._flights_lock:
            self._flights.clear()
        dropped = 0
        freed = 0
        for sh in self._shards:
            with sh.lock:
                dropped += len(sh.entries)
                freed += sh.mask_bytes
                sh.entries.clear()
                sh.mask_bytes = 0
        metrics.gauge("engine_decision_cache_entries").dec(dropped)
        metrics.gauge("engine_decision_cache_mask_bytes").dec(freed)

    def retire_below(self, revision: int) -> int:
        """Drop every entry keyed at a revision below ``revision``.

        Keys embed the store revision (``key[1]``), so entries of
        superseded revisions can never be probed again — under sustained
        write churn they would otherwise squat in the LRU until budget
        eviction, displacing live entries. Probing is revision-exact, so
        this sweep can never change an answer; the background compactor
        runs it at fold cadence (compaction.py) — amortized, never on
        the serving path. Entries AT ``revision`` survive: a compaction
        swap preserves the revision, so their keys stay exactly valid
        across it. Returns the number of entries dropped."""
        revision = int(revision)
        dropped = 0
        freed = 0
        for sh in self._shards:
            with sh.lock:
                dead = [k for k in sh.entries if k[1] < revision]
                for k in dead:
                    _, _, nb = sh.entries.pop(k)
                    sh.mask_bytes -= nb
                    freed += nb
                dropped += len(dead)
        if dropped:
            metrics.counter("engine_decision_cache_retired_total").inc(
                dropped)
            metrics.gauge("engine_decision_cache_entries").dec(dropped)
            metrics.gauge("engine_decision_cache_mask_bytes").dec(freed)
        return dropped

    def retire_affected(self, affected) -> int:
        """Drop only the entries whose query lies inside a schema diff's
        ``affected`` set of ``(resource_type, permission-or-relation)``
        pairs — the migration cutover's surgical alternative to a full
        flush. A check key carries the resource type at ``key[2]`` and
        the permission at ``key[4]``; a lookup key carries them at
        ``key[2]``/``key[3]``. Everything outside the set keeps its
        verdicts: the cutover swap preserves the store revision, so
        surviving keys stay exactly probe-valid — and the no-verdict-flap
        invariant depends on them answering identically across the flip.

        The cut keeps the revision, so a fill that dispatched on the old
        graph would land under the same key after the entries went (this
        races in the reference): the affected pairs' flights leave the
        registry (no caller joins an old-graph flight after this), and
        :meth:`put` refuses a fill whose ``since`` predates this call.
        The caller swaps the graph before it retires. Returns the number
        of entries dropped."""
        affected = frozenset(affected)
        if not affected:
            return 0
        # recorded before the sweep: a fill either lands before the sweep
        # reaches its shard (and is swept) or sees the record (and skips)
        self._retired.append(affected)
        with self._flights_lock:
            for k in [k for k in self._flights
                      if self._pair(k) in affected]:
                del self._flights[k]
        dropped = 0
        freed = 0
        for sh in self._shards:
            with sh.lock:
                dead = []
                for k in sh.entries:
                    if self._pair(k) in affected:
                        dead.append(k)
                for k in dead:
                    _, _, nb = sh.entries.pop(k)
                    sh.mask_bytes -= nb
                    freed += nb
                dropped += len(dead)
        if dropped:
            metrics.counter("engine_decision_cache_retired_total").inc(
                dropped)
            metrics.gauge("engine_decision_cache_entries").dec(dropped)
            metrics.gauge("engine_decision_cache_mask_bytes").dec(freed)
        return dropped

    def stats(self) -> dict:
        with_entries = sum(len(sh.entries) for sh in self._shards)
        return {
            "entries": with_entries,
            "mask_bytes": sum(sh.mask_bytes for sh in self._shards),
        }

    # -- singleflight --------------------------------------------------------

    def flight(self, key: tuple, now: float) -> tuple[bool, Flight]:
        """Join or create the in-flight computation for ``key``. Returns
        ``(is_leader, flight)``; a follower's join is counted as a
        piggyback (one saved dispatch). A lingering resolved flight whose
        deadline has passed is replaced, never served stale."""
        with self._flights_lock:
            if self._closed:
                return True, Flight()  # a private flight: nobody joins it
            f = self._flights.get(key)
            if f is not None and f.done and now >= f.deadline:
                del self._flights[key]
                f = None
            if f is not None:
                metrics.counter(
                    "engine_decision_cache_piggybacks_total").inc()
                return False, f
            f = Flight()
            self._flights[key] = f
            return True, f

    def release(self, key: tuple, flight: Flight) -> None:
        """Retire ``flight`` from the registry (after the cache fill, so
        a racing prober lands on the cache entry, not a dead flight)."""
        with self._flights_lock:
            if self._flights.get(key) is flight:
                del self._flights[key]


def check_key(revision: int, item,
              ctx_digest: Optional[str] = None) -> tuple:
    """``ctx_digest`` (engine.context_digest) joins the key for
    caveat-contexted queries so a conditional verdict can never leak
    across request contexts; context-free queries keep the historical
    key shape unchanged."""
    base = ("check", revision, item.resource_type, item.resource_id,
            item.permission, item.subject_type, item.subject_id,
            item.subject_relation)
    return base if ctx_digest is None else base + (ctx_digest,)


def lookup_key(revision: int, resource_type: str, permission: str,
               subject_type: str, subject_id: str,
               subject_relation: Optional[str],
               ctx_digest: Optional[str] = None) -> tuple:
    base = ("lookup", revision, resource_type, permission, subject_type,
            subject_id, subject_relation)
    return base if ctx_digest is None else base + (ctx_digest,)
