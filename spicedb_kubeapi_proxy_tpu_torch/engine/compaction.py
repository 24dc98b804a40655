"""Background compaction of the delta overlay into a fresh compiled base.

Counterpart of the JAX package's ``engine/compaction.py``. The write path
appends into a fixed-capacity overlay (ops/reachability.py
``incremental_update``): O(write) per mutation, but occupancy only grows,
and a full overlay would mean a synchronous full recompile on the next
fully-consistent read. The **compactor** thread folds the accumulated
tail into a fresh compiled base (``compile_graph`` off the write path;
the old base keeps serving), replays whatever landed during the fold,
and swaps the engine's graph at a recorded revision. The swap preserves
the revision: compaction is semantically a no-op, and the decision
cache's entries keyed below it are retired at the swap.

Overflow becomes **back-pressure** instead of a stall: when the overlay
cannot absorb a write, :class:`OverlayBackpressure` sheds it before any
store mutation with a bounded ``Retry-After`` sized from recent fold
times. ``notify`` is cheap and called on every overlay advance; crossing
``threshold`` (a fraction of the overlay slots or dead-ledger rows) wakes
the worker.

On a tiered graph (storage/) the worker doubles as the placement engine:
every ``PLACE_EVERY`` advanced graphs it runs one sweep
(``reachability.tier_maintain``: decay access recency, demote blocks that
went cold, re-materialize pinned overlay blocks), off the serving path.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque

from ..admission import AdmissionRejected
from ..utils.metrics import metrics
from .store import StoreError

log = logging.getLogger("sdbkp.torch.engine.compaction")

DEFAULT_COMPACT_THRESHOLD = 0.75

# Retry-After bounds for overlay-full sheds: never below the fold's
# scheduling granularity, never an unbounded "come back whenever"
MIN_RETRY_AFTER = 0.05
MAX_RETRY_AFTER = 5.0

# conservative slot-space edges one write record can expand to (direct +
# userset + arrow terms): the headroom margin the shed check reserves
EDGES_PER_RECORD = 4


def validate_overlay_config(
        delta_capacity: int,
        compact_threshold: float = DEFAULT_COMPACT_THRESHOLD) -> None:
    """Bounds of the delta-capacity / compact-threshold settings (the
    engine's constructor checks its ``delta_capacity`` here); raises
    ``ValueError`` with a setting-named message."""
    if delta_capacity < 64:
        raise ValueError("delta-capacity must be >= 64 (the overlay "
                         "floor)")
    if not 0.0 <= compact_threshold <= 1.0:
        raise ValueError("compact-threshold must be in [0, 1] "
                         "(fraction of overlay capacity; 0 disables "
                         "background compaction)")


class OverlayBackpressure(AdmissionRejected):
    """The delta overlay cannot absorb the write and a compaction is in
    flight: shed before any store mutation, with a bounded Retry-After.
    Retrying is always safe — nothing was applied."""

    def __init__(self, retry_after: float, occupancy: int, capacity: int,
                 what: str = "overlay slots"):
        super().__init__(
            "write",
            f"delta {what} full ({occupancy}/{capacity}); "
            "compaction in progress — retry after the fold",
            retry_after=retry_after,
            dependency="engine-compaction")
        self.occupancy = occupancy
        self.capacity = capacity
        self.what = what


class WriteTooLarge(StoreError):
    """The write's records need more slots than the whole overlay (or
    dead ledger) holds: no fold makes room for it, so it is refused for
    good, not shed with a Retry-After (a retry would be shed forever).
    The writer splits it into writes of at most ``limit`` records, as
    the rebalance mover does (engine/remote.py ``mover_chunk_cap``)."""

    def __init__(self, n_records: int, limit: int):
        super().__init__(
            f"write of {n_records} records is larger than the delta "
            f"overlay can ever absorb; split it into writes of at most "
            f"{limit} records")
        self.n_records = n_records
        self.limit = limit


class Compactor:
    """Threshold-triggered background overlay folds + write back-pressure.

    Owned by an :class:`~.engine.Engine` (``enable_compaction``). Once
    enabled, the worker is the only caller of ``compile_graph`` in steady
    state: the serving path's fallback recompile stays for correctness
    (layout growth, stratification inversions), but headroom sheds writes
    before the overlay can overflow."""

    def __init__(self, engine, threshold: float = DEFAULT_COMPACT_THRESHOLD):
        if not 0.0 < threshold <= 1.0:
            raise ValueError(
                f"compact threshold must be in (0, 1], got {threshold}")
        self.engine = engine
        self.threshold = float(threshold)
        self._cond = threading.Condition()
        self._pending = False
        # tiered placement sweeps, requested every PLACE_EVERY advances
        self._place_pending = False
        self._notify_count = 0
        self._closed = False
        # recent fold wall times, feeding the Retry-After estimate
        self._durations: deque = deque(maxlen=8)
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="engine-compactor")
        self._thread.start()

    # -- triggers ------------------------------------------------------------

    def notify(self, cg) -> None:
        """Cheap occupancy check, called with every advanced graph."""
        if cg is None or cg.delta_pos is None or not cg.delta_cap:
            return
        if cg.tier is not None:
            # placement rides the same cheap per-advance hook
            self._notify_count += 1
            if self._notify_count % self.PLACE_EVERY == 0:
                self.request_placement()
        if (cg.n_delta >= self.threshold * cg.delta_cap
                or cg.n_dead >= self.threshold * len(cg.dead_buf)):
            self.request()

    def request(self) -> None:
        """Ask for an async fold (idempotent while one is queued)."""
        with self._cond:
            if self._closed:
                return
            self._pending = True
            self._cond.notify()

    # advanced-graph notifies between placement sweeps
    PLACE_EVERY = 64

    def request_placement(self) -> None:
        """Ask for an async tier placement sweep (idempotent)."""
        with self._cond:
            if self._closed:
                return
            self._place_pending = True
            self._cond.notify()

    def retry_after(self) -> float:
        """Bounded shed hint: the median recent fold time — how long a
        polite writer should wait for overlay headroom to reappear."""
        if self._durations:
            d = sorted(self._durations)[len(self._durations) // 2]
        else:
            d = 0.2  # no fold observed yet: a compile-sized guess
        return min(max(d, MIN_RETRY_AFTER), MAX_RETRY_AFTER)

    @staticmethod
    def max_write_records(cg) -> "int | None":
        """The most records one write may carry into ``cg``'s overlay:
        what an empty overlay and dead ledger absorb. None when the
        graph has no overlay (nothing to shed against)."""
        if cg is None or cg.delta_pos is None or not cg.delta_cap:
            return None
        return min(cg.delta_cap, len(cg.dead_buf)) // EDGES_PER_RECORD

    def check_headroom(self, cg, n_records: int) -> None:
        """Write-path back-pressure: raise :class:`OverlayBackpressure`
        when the current overlay cannot absorb ``n_records`` more write
        records (conservatively ``EDGES_PER_RECORD`` slots each), and kick
        the worker once occupancy crosses the threshold; refuse a write
        no fold could make room for (:class:`WriteTooLarge`). Called
        before the store mutation, so a shed write leaves no trace."""
        if cg is None or cg.delta_pos is None or not cg.delta_cap:
            return
        need = EDGES_PER_RECORD * max(int(n_records), 1)
        limit = self.max_write_records(cg)
        if n_records > limit:
            raise WriteTooLarge(int(n_records), limit)
        slots_full = cg.n_delta + need > cg.delta_cap
        ledger_full = cg.n_dead + need > len(cg.dead_buf)
        if (slots_full or ledger_full
                or cg.n_delta + need > self.threshold * cg.delta_cap):
            self.request()
        if slots_full or ledger_full:
            metrics.counter("engine_overlay_backpressure_total").inc()
            # name the binding resource: delete-heavy churn exhausts the
            # dead ledger while slot occupancy stays low
            if slots_full:
                raise OverlayBackpressure(self.retry_after(),
                                          cg.n_delta, cg.delta_cap)
            raise OverlayBackpressure(self.retry_after(),
                                      cg.n_dead, len(cg.dead_buf),
                                      what="dead-ledger rows")

    # -- worker --------------------------------------------------------------

    def _run(self) -> None:
        while True:
            with self._cond:
                while not (self._pending or self._place_pending) \
                        and not self._closed:
                    self._cond.wait()
                if self._closed and not self._pending:
                    return
                do_fold, self._pending = self._pending, False
                do_place, self._place_pending = self._place_pending, False
            if do_place and not do_fold:
                # a fold supersedes placement: it rebuilds the graph, and
                # with it a fresh, unpinned TierStore
                from ..ops.reachability import tier_maintain

                try:
                    tier_maintain(self.engine._compiled)
                except Exception:
                    log.exception("tier placement sweep failed "
                                  "(will retry on next cadence)")
                continue
            try:
                self.compact()
            except Exception:
                log.exception("compaction failed (will retry on next "
                              "threshold crossing)")

    def compact(self) -> bool:
        """One synchronous fold: compile a fresh base off the write path
        (the current graph keeps serving), replay the records that landed
        during the compile, and swap. Returns True when the swap
        published. Also the direct entry point for tests and drains."""
        e = self.engine
        t0 = time.perf_counter()
        lineage = e._lineage
        fresh = e._compile_fresh()
        with e._lock:
            if e._lineage != lineage:
                # the store was restored during the fold (the fresh base
                # is of the old contents, and the next read compiles
                # anew), or a schema migration cut over (the fresh base
                # was compiled under the old schema: the cut keeps the
                # revision, so the check below would let it publish;
                # this races in the reference)
                return False
            cur = e._head  # writes still applying their patches included
            if cur is not None and cur.revision > fresh.revision:
                # writes landed during the fold: bring the fresh base
                # current with one small incremental replay
                fresh = e._replay_onto(fresh)
            if fresh is None or (cur is not None
                                 and cur.revision > fresh.revision):
                # could not catch up (a bulk load or trimmed history raced
                # the fold): go again from a newer snapshot
                self.request()
                return False
            e._head = fresh
            e._publish(fresh)
        cache = e._decision_cache
        if cache is not None:
            # entries AT the swap revision stay valid (the swap keeps the
            # revision); those below it can never be probed again: retire
            # them at fold cadence rather than let churn fill the LRU
            cache.retire_below(fresh.revision)
        dur = time.perf_counter() - t0
        self._durations.append(dur)
        metrics.counter("engine_compactions_total").inc()
        metrics.histogram("engine_compaction_seconds").observe(dur)
        metrics.gauge("engine_delta_occupancy").set(fresh.n_delta)
        log.info("compacted overlay into base at revision %d in %.3fs",
                 fresh.revision, dur)
        return True

    def close(self, drain: bool = False) -> None:
        """Stop the worker; ``drain=True`` folds one last time first."""
        if drain:
            try:
                self.compact()
            except Exception:
                log.exception("final compaction failed")
        with self._cond:
            self._closed = True
            self._cond.notify()
        self._thread.join(timeout=60.0)
