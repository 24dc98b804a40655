"""The proxy-side scatter-gather planner over hash-partitioned shards.

A copy of the JAX package's ``scaleout/planner.py`` over the port's
engine clients, with one deliberate difference: a read whose routing
epoch moved while its legs ran (a slice cut, a commit or an install of a
map transition) runs again instead of merging a straddled gather
(``_stable_read``), so lists and checks stay exact during a live move.

``ShardedEngine`` exposes the exact engine surface the authz middleware
consumes (check_bulk, lookup_resources[_mask], lookup_subjects, write/
delete/read relationships, watch streams, store.exists) and plans each
operation against the :class:`~.shardmap.ShardMap`:

- **single-shard ops** — a check, write, or anchored read whose closure
  lives on one group — route DIRECTLY to the owning group (no scatter;
  ``scaleout_ops_total{mode="single"}`` counts them per group);
- **scatter ops** — LookupResources / list-prefilter masks /
  LookupSubjects / watch streams — fan out to every group
  (``shard_fanout`` span) and gather CLIENT-SIDE (``shard_merge``
  span): namespaced slices are disjoint so the union is exact, global
  objects are replicated so duplicates dedupe;
- **cross-shard writes** — tuples spanning groups (including every
  global-tuple write, which replicates) — split per shard, journaled
  durably BEFORE the first shard applies (:mod:`.journal`), and
  replayed to completion after a mid-split crash;
- **per-shard admission** — each scatter leg passes its own group's
  engine-host admission; ONE overloaded group sheds only its slice, and
  the partial-shed scatter fails CLOSED with ``Retry-After`` = the max
  over the shedding shards (never a half answer).

Consistency is a **revision vector** (one component per group): gathers
merge at the vector of the per-shard revisions they observed, the
optional client-side decision cache keys entries by the vector and
refuses to serve once ANY component advances, and watch resumption
tokens are vectors, never scalars.
"""

from __future__ import annotations

import json
import queue as _queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import asdict
from typing import Optional

import numpy as np

from ..admission import (
    AdmissionRejected,
    LOOKUP_PREFILTER,
    WATCH_RECOMPUTE,
)
from ..engine.engine import CheckItem, SchemaViolation, WatchEvent
from ..engine.remote import (
    NotLeaderError,
    RemoteInterner,
    TRANSPORT_ERRORS,
)
from ..engine.store import PreconditionFailed, StoreError
from ..utils.resilience import BreakerOpen
from ..engine.store import RelationshipFilter, WriteOp
from ..models.tuples import Relationship
from ..obs.trace import tracer
from ..utils.metrics import metrics
from .journal import SplitJournal
from .rebalance import (
    CUT as CUT_STATE,
    MapTransition,
    RebalanceCoordinator,
    RebalanceError,
    abort_transition,
    plan_moves,
)
from .shardmap import (
    RevisionVector,
    ShardMap,
    ShardMapError,
    split_resource,
)

import logging

log = logging.getLogger("sdbkp.torch.scaleout")

# classes whose proxy-side admission cost scales with the scatter width
_SCATTER_CLASSES = frozenset({LOOKUP_PREFILTER.name,
                              WATCH_RECOMPUTE.name})

# failures that PROVE a write never applied: the engine answered with a
# rejection (precondition/schema/store), the role gate refused it
# pre-dispatch (not_leader), admission shed it before any side effect,
# or the breaker never let an attempt reach the wire. Everything else —
# transport deaths, exhausted deadlines, protocol errors — is AMBIGUOUS
# (bytes may have reached a store that applied them), and a split-write
# journal entry must then stay pending rather than close half-applied.
_PROVABLY_NOT_APPLIED = (PreconditionFailed, SchemaViolation,
                         StoreError, NotLeaderError, AdmissionRejected,
                         BreakerOpen)


def _op_counter(group: int, op: str, mode: str):
    return metrics.counter("scaleout_ops_total", group=str(group),
                           op=op, mode=mode)


def _rel_to_dict(r: Relationship) -> dict:
    return asdict(r)


def _rel_from_dict(d: dict) -> Relationship:
    return Relationship(**d)


class ShardVectorCache:
    """Decision cache keyed by ``(query key, revision vector)``: an
    entry filled at vector V serves ONLY while the planner's tracked
    vector still equals V — the moment any component shard advances,
    every V-keyed entry is unreachable (the satellite pin: an old-vector
    entry never serves after any component advances). Bounded LRU.

    Entries are additionally TIME-BOUNDED (``ttl`` seconds): the
    planner cannot see the engine-side expiration/caveat verdict-flip
    watermarks, so a time-window grant could otherwise serve from here
    past its revocation instant while no write advances the vector.
    The TTL caps that staleness class; the per-group host-side caches
    stay exact regardless."""

    def __init__(self, max_entries: int = 8192, ttl: float = 5.0,
                 clock=time.monotonic):
        from collections import OrderedDict

        self.max_entries = max_entries
        self.ttl = ttl
        self._clock = clock
        self._lock = threading.Lock()
        self._map: "OrderedDict" = OrderedDict()

    def get(self, key, vector: RevisionVector):
        with self._lock:
            got = self._map.get((key, vector))
            if got is not None and \
                    self._clock() - got[1] > self.ttl:
                del self._map[(key, vector)]
                got = None
            if got is None:
                metrics.counter("scaleout_cache_misses_total").inc()
                return None
            self._map.move_to_end((key, vector))
            metrics.counter("scaleout_cache_hits_total").inc()
            return got[0]

    def put(self, key, vector: RevisionVector, value) -> None:
        with self._lock:
            self._map[(key, vector)] = (value, self._clock())
            self._map.move_to_end((key, vector))
            while len(self._map) > self.max_entries:
                self._map.popitem(last=False)

    def retire_below(self, vector: RevisionVector) -> None:
        """Drop entries whose vector is dominated by (and not equal to)
        ``vector`` — they can never serve again."""
        with self._lock:
            dead = [k for k in self._map
                    if k[1] != vector and vector.dominates(k[1])]
            for k in dead:
                del self._map[k]


class _ShardedStoreShim:
    """The sliver of Store the proxy touches (idempotency/lock existence
    probes), routed through the planner."""

    def __init__(self, planner: "ShardedEngine"):
        self._p = planner

    def exists(self, f: RelationshipFilter) -> bool:
        return self._p.exists(f)


class ShardedWatchStream:
    """Merged server-push watch subscription over every group: one
    reader thread per group feeds a shared queue; ``next_batch()``
    returns each group's batches as they land, with every event's
    revision REWRITTEN to the planner's running revision vector (join of
    everything seen so far with that shard's component advanced) — so
    consumers that track "the latest revision seen" hold a resumption
    token that is exact per shard and monotone across the merge."""

    _POLL = 0.25

    def __init__(self, planner: "ShardedEngine",
                 from_vector: RevisionVector):
        self._p = planner
        self._q: _queue.Queue = _queue.Queue(maxsize=1024)
        self._closed = threading.Event()
        self._streams: list = []
        self._streams_lock = threading.Lock()
        self._threads: list = []
        self._vec_lock = threading.Lock()
        from_vector = from_vector.extend(len(planner.groups))
        self.revision = from_vector
        self._n_pumps = 0
        for gi, client in enumerate(planner.groups):
            self._start_pump(gi, client, int(from_vector[gi]))

    def _start_pump(self, gi: int, client, from_rev: int) -> None:
        t = threading.Thread(
            target=self._pump, args=(gi, client, from_rev),
            name=f"shard-watch-g{gi}", daemon=True)
        self._threads.append(t)
        self._n_pumps = max(self._n_pumps, gi + 1)
        t.start()

    def _ensure_pumps(self) -> None:
        """A rebalance may ADD groups after this stream opened: start a
        pump for each (from revision 0 — a new group's history is
        nothing but moved tuples, and the delivery filter suppresses
        everything below its slices' cut revisions)."""
        groups = self._p.groups
        if len(groups) <= self._n_pumps:
            return
        with self._vec_lock:
            self.revision = self.revision.extend(len(groups))
        for gi in range(self._n_pumps, len(groups)):
            self._start_pump(gi, groups[gi], 0)

    def _register_stream(self, s) -> bool:
        """Track an opened per-group stream; closes it immediately if
        close() already ran (a pump mid-connect must not leak the
        socket and park its thread until the heartbeat timeout)."""
        with self._streams_lock:
            if not self._closed.is_set():
                self._streams.append(s)
                return True
        try:
            s.close()
        except Exception:  # noqa: BLE001 - teardown best effort
            pass
        return False

    def _put(self, item) -> bool:
        """Bounded-queue put that re-checks ``close()``: a pump thread
        whose consumer stopped draining must unpark when the stream
        closes, not sit in ``Queue.put`` forever."""
        while not self._closed.is_set():
            try:
                self._q.put(item, timeout=0.5)
                return True
            except _queue.Full:
                continue
        return False

    def _pump(self, gi: int, client, from_rev: int) -> None:
        try:
            if hasattr(client, "watch_push_stream"):
                s = client.watch_push_stream(from_rev)
                if not self._register_stream(s):
                    return
                while not self._closed.is_set():
                    events = s.next_batch()
                    if events and not self._put((gi, events, None)):
                        return
            else:
                # in-process engines: blocking wait_events loop
                rev = from_rev
                while not self._closed.is_set():
                    events = client.wait_events(rev, self._POLL)
                    if events:
                        rev = max(e.revision for e in events)
                        if not self._put((gi, events, None)):
                            return
        except Exception as e:  # noqa: BLE001 - surfaced to next_batch
            if not self._closed.is_set():
                self._put((gi, None, e))

    def next_batch(self) -> list:
        """Blocks for the next batch from ANY group; ``[]`` means the
        wait timed out (liveness heartbeat semantics). Events pass the
        planner's rebalance delivery filter — the resumption token
        still advances past suppressed mover echoes, so a consumer
        resuming from ``self.revision`` never sees them either."""
        if len(self._p.groups) < self._n_pumps:
            # a SHRINK committed under this stream: its per-component
            # indexing (and the consumer's resumption arithmetic) no
            # longer matches the contracted group space — fail closed
            # with re-list semantics instead of mis-stamping events
            raise StoreError(
                "shard-group space shrank beneath this watch stream; "
                "re-list and re-watch")
        self._ensure_pumps()
        try:
            gi, events, err = self._q.get(timeout=self._p.PUSH_WAIT)
        except _queue.Empty:
            return []
        if err is not None:
            raise err
        with self._vec_lock:
            if gi >= len(self.revision):
                self.revision = self.revision.extend(gi + 1)
            out = []
            for e in events:
                self.revision = self.revision.bump(gi, e.revision)
                if self._p._deliver_event(gi, e.relationship,
                                          e.revision):
                    out.append(WatchEvent(self.revision, e.operation,
                                          e.relationship))
            self._p._observe_revision(gi, max(
                e.revision for e in events))
        return out

    def close(self) -> None:
        with self._streams_lock:
            self._closed.set()
            streams = list(self._streams)
        for s in streams:
            try:
                s.close()
            except Exception:  # noqa: BLE001 - teardown best effort
                pass


class ShardedEngine:
    """See module docstring. ``groups`` are engine clients with the
    remote-engine surface (RemoteEngine / FailoverEngine — or in-process
    Engines in tests: the planner only calls the shared surface)."""

    PUSH_WAIT = 15.0

    def __init__(self, shard_map: ShardMap, groups: list,
                 journal: Optional[SplitJournal] = None,
                 cache: Optional[ShardVectorCache] = None,
                 recover: bool = True, retry_budget=None,
                 client_factory=None, frontier=None):
        if len(groups) != shard_map.n_groups:
            raise ValueError(
                f"shard map names {shard_map.n_groups} groups, got "
                f"{len(groups)} clients")
        self.map = shard_map
        self.groups = list(groups)
        # clients a SHRINK commit removed from routing: ownership
        # parks here until close() — the planner may not own a test's
        # in-process engine, but a factory-built remote client's
        # sockets/heartbeats must not leak past teardown
        self._retired_clients: list = []
        self.journal = journal
        self.cache = cache
        # cross-shard frontier exchange (scaleout/frontier.py): a
        # FrontierConfig enables the planner-coordinated iterative
        # join for closures that cross shard boundaries; None keeps
        # the classic shard-local closure contract
        self.frontier = frontier
        self._frontier_pairs = (None if frontier is None
                                else frontier.pairs)
        # the SAME RetryBudget instance the group clients hold
        # (utils/resilience.py): the planner's scatter-leg re-issues
        # draw from it too, so a browned-out shard sees one bounded
        # retry stream instead of per-layer multiplication
        self.retry_budget = retry_budget
        # builds an engine client for a group's endpoint list — how a
        # restarted planner reconstructs clients for groups a persisted
        # rebalance transition ADDED beyond the booted map
        self.client_factory = client_factory
        self.store = _ShardedStoreShim(self)
        self.dependency = "engine-shards"
        self._pool = ThreadPoolExecutor(
            max_workers=max(4, 2 * len(groups)),
            thread_name_prefix="shard-scatter")
        self._vec_lock = threading.Lock()
        self._vector = shard_map.zero_vector()
        # live tuple mover (rebalance.py): at most one ACTIVE map
        # transition routes reads/writes/watches; completed ones stay
        # archived for token translation and watch-event filtering
        self._active_transition: Optional[MapTransition] = None
        self._archived_transitions: list = []
        # bumped when a transition installs or commits: with the active
        # transition's generation it is the read-routing epoch a gather
        # checks (_stable_read)
        self._route_gen = 0
        self._coordinator: Optional[RebalanceCoordinator] = None
        # coordinated live schema migration (migration/migrator.py per
        # group + this planner's cross-group cut): at most one in
        # flight; the dict is the aggregate status surface
        self._migration: Optional[dict] = None
        self._migration_thread: Optional[threading.Thread] = None
        metrics.gauge("scaleout_groups").set(shard_map.n_groups)
        metrics.gauge("scaleout_map_version").set(shard_map.version)
        if journal is not None:
            # BEFORE split recovery and before any request: a persisted
            # transition with cut slices changes routing — serving
            # without it would misroute the cut slices' tuples
            self._recover_transition()
            # schema-migration crash matrix: a persisted "cutting"
            # record means some group may already serve the new schema
            # — finish the coordinated cut (idempotent per group);
            # anything earlier aborts cleanly (no group cut yet)
            self._recover_migration()
        if recover and journal is not None:
            try:
                self.recover_splits()
            except Exception as e:  # noqa: BLE001 - boot must not gate
                # an unreachable shard must not turn a one-slice outage
                # into a full-proxy outage: the entries stay PENDING
                # (visible as /readyz pending_splits and the counter),
                # and replay retries on the next recover_splits call —
                # lazily before the next split write, or the next boot
                log.warning("deferred split-write recovery (%d pending "
                            "entries): %s",
                            self.journal.pending_count(), e)
                metrics.counter(
                    "scaleout_split_replay_deferred_total").inc()

    # -- revision vector -----------------------------------------------------

    def _observe_revision(self, shard: int, revision) -> None:
        """Advance the tracked vector; retires cache entries that can
        never serve again."""
        try:
            revision = int(revision)
        except (TypeError, ValueError):
            return
        with self._vec_lock:
            if shard >= len(self.groups):
                # a RETIRED group's straggler (a watch pump or probe
                # that outlived its shrink): the group's history is
                # closed — extending the contracted vector back out
                # would resurrect the dropped component
                return
            if shard >= len(self._vector):
                # a rebalance-added group: grow the tracked vector
                self._vector = self._vector.extend(shard + 1)
            self._vector = self._vector.bump(shard, revision)
        # no eager cache sweep: dominated entries are already
        # unreachable (get() matches the exact vector) and the TTL
        # ages them out — an O(entries) retire_below per revision
        # advance would put a full-scan under the cache lock on every
        # write and every watch batch

    @property
    def vector(self) -> RevisionVector:
        with self._vec_lock:
            return self._vector

    def revision_vector(self, refresh: bool = True) -> RevisionVector:
        """The per-shard revision vector; ``refresh`` scatters a
        revision probe so the answer reflects every group NOW."""
        if refresh:
            revs = self._scatter("revision",
                                 lambda gi, c: c.revision)
            for gi, r in revs.items():
                self._observe_revision(gi, r)
        return self.vector

    @property
    def revision(self) -> RevisionVector:
        """The engine-surface revision property: a VECTOR (consumers
        that only order tokens — the watch hub — work unchanged; the
        decision audit's ``isinstance(int)`` guard skips it). Serves
        the TRACKED vector once any traffic has flowed — the dtx
        activity reads this after every dual-write, and an
        unconditional refresh would add n_groups round trips per kube
        write for a token _observe_revision already holds. Only a
        never-observed (all-zero) vector pays the scatter, so a fresh
        planner's first watch still starts from the current state
        instead of replaying every shard's history."""
        return self.revision_vector(refresh=not any(self.vector))

    # -- online rebalance (scaleout/rebalance.py) ----------------------------

    def begin_rebalance(self, new_map: ShardMap,
                        new_clients: Optional[dict] = None,
                        retire: Optional[int] = None,
                        **coordinator_cfg) -> RebalanceCoordinator:
        """Start a live map transition V -> ``new_map.version`` on a
        background mover thread (``--rebalance-to``). ``new_clients``
        maps ADDED group indices to their engine clients (or a
        ``client_factory`` builds them from the map's endpoints).
        Returns the coordinator; routing changes take effect per slice
        as the protocol advances — no drain, ever.

        A target with FEWER groups is a SHRINK: the ``retire``-d group
        (default: the last one) is emptied through the same
        copy/catch-up/dual-write/cutover machinery, GC'd, and removed
        at commit. Only the LAST group may retire — every survivor's
        ring points are keyed by group index, so retiring the tail
        leaves their placement untouched; to retire a middle group,
        rebalance its slices onto the tail first."""
        if self._active_transition is not None:
            raise RebalanceError(
                "a rebalance is already in flight (to map version "
                f"{self._active_transition.new_map.version})")
        if new_map.n_groups < self.map.n_groups:
            if retire is None:
                retire = self.map.n_groups - 1
            if retire != self.map.n_groups - 1:
                raise RebalanceError(
                    "only the LAST group can retire (group indices are "
                    "identity across a transition: removing a middle "
                    "index would silently renumber every later group's "
                    "ring points); move its slices to the tail first")
            if any(not past.gc_complete
                   for past in self._archived_transitions):
                raise RebalanceError(
                    "cannot shrink while an earlier transition's GC is "
                    "incomplete: its lingering copies are filtered by "
                    "group index, and the shrink renumbers the index "
                    "space out from under that filter — re-run GC (it "
                    "resumes at boot) and retry")
            t = MapTransition(self.map, new_map,
                              plan_moves(self.map, new_map,
                                         retire=retire),
                              retire=retire)
        else:
            t = MapTransition(self.map, new_map,
                              plan_moves(self.map, new_map))
        self._install_transition(t, new_clients)
        coord = RebalanceCoordinator(self, t, **coordinator_cfg)
        self._coordinator = coord
        return coord.start()

    def _install_transition(self, t: MapTransition,
                            new_clients: Optional[dict] = None,
                            persist: bool = True) -> None:
        """Extend the group/vector space with the transition's added
        groups and make the transition route — persisted before any
        data moves."""
        for gi in t.new_groups:
            if gi < len(self.groups):
                continue
            if gi != len(self.groups):
                raise RebalanceError(
                    f"transition adds group {gi} but only "
                    f"{len(self.groups)} groups exist")
            client = (new_clients or {}).get(gi)
            if client is None and self.client_factory is not None:
                client = self.client_factory(t.new_map.groups[gi])
            if client is None:
                raise RebalanceError(
                    f"no client for rebalance-added group {gi}; pass "
                    "new_clients or a client_factory")
            with self._vec_lock:
                self.groups.append(client)
                self._vector = self._vector.extend(len(self.groups))
        self._active_transition = t
        self._route_gen += 1
        if persist and self.journal is not None:
            self.journal.save_transition(t.to_doc())

    def commit_rebalance(self, t: MapTransition) -> None:
        """Every slice cut: map V+1 becomes THE map (atomic swap); the
        transition is archived — its cut table keeps filtering watch
        replays and translating V-minted resumption tokens. A SHRINK
        commit additionally removes the retiring group from the routing
        space: its client leaves ``groups`` (closed at planner
        teardown — the planner may not own its lifecycle mid-test) and
        the tracked vector drops its component; the translation
        watermark is recorded first."""
        if not t.all_cut():
            raise RebalanceError(
                "commit before every slice cut would misroute the "
                "uncut slices")
        if t.retire is not None:
            if t.retire_cut is None:
                t.retire_cut = t.retire_watermark()
            with self._vec_lock:
                self.map = t.new_map
                retired = self.groups.pop(t.retire)
                self._vector = self._vector.drop_component(t.retire)
            self._retired_clients.append(retired)
        else:
            with self._vec_lock:
                self.map = t.new_map
        self._active_transition = None
        self._route_gen += 1
        self._archived_transitions.append(t)
        # bound the era-walk/translation memory: resumption tokens old
        # enough to predate the 8 most recent transitions get re-list
        # semantics (their groups' watch logs have long been trimmed
        # past those cut revisions anyway)
        del self._archived_transitions[:-8]
        self._retire_stale_archives()
        metrics.gauge("scaleout_groups").set(t.new_map.n_groups)
        metrics.gauge("scaleout_map_version").set(t.new_map.version)

    def _retire_stale_archives(self) -> None:
        """Drop archived transitions that reference a group index
        OUTSIDE today's group space (beyond their own retiree). They
        accumulate across grow→shrink cycles and pin two stale filters:
        a ``gc_complete=False`` archive holds ``_copies_may_linger``
        open forever (per-row owner filtering on every scatter, and the
        ``exists`` probe degraded to full row gathers) even though the
        shrink that removed the group already copy-REPLACED the ranges
        its GC owed; and their era tables make every watch-delivery
        walk compare today's group indices against a dead index space.
        Safe to drop: ``begin_rebalance`` refuses to shrink past
        incomplete GC, and a dropped archive's resumption tokens get
        re-list semantics (exactly what tokens older than the 8-ring
        already get)."""
        n = len(self.groups)
        kept = []
        for past in self._archived_transitions:
            refs = ({sl.src for sl in past.slices}
                    | {sl.dst for sl in past.slices}
                    | set(past.new_groups))
            if past.retire is not None:
                # its own retiree is the one out-of-space index an
                # archive may keep: the era walk and token translation
                # for the shrink itself live there
                refs.discard(past.retire)
            if any(gi >= n for gi in refs):
                metrics.counter(
                    "scaleout_archives_retired_total").inc()
                continue
            kept.append(past)
        self._archived_transitions = kept

    def _recover_transition(self) -> None:
        """Boot-time crash matrix (see rebalance.py): committed or
        all-cut -> finish the commit; some-cut -> install + RESUME (the
        flip already moved data authoritatively); none-cut -> clean
        abort (routing never left V)."""
        doc = self.journal.load_transition()
        if doc is None:
            return
        if doc.get("phase") == "done":
            # a COMPLETED transition's durable marker (see
            # run_to_completion): the doc's target map is authoritative
            done_ver = int(doc["new_map"]["version"])
            if done_ver == self.map.version:
                # the operator rolled --shard-map to the new version:
                # the marker has served its purpose
                self.journal.clear_transition()
                return
            t = MapTransition.from_doc(doc, self.map)
            t.gc_complete = True
            # persist=False: installing must not clobber the durable
            # "done" marker with a "running" record
            self._install_transition(t, persist=False)
            self.commit_rebalance(t)
            log.warning(
                "booted with --shard-map v%d but rebalance to v%d "
                "already completed — serving the completed map (update "
                "the flag to clear this)", doc["old_version"], done_ver)
            return
        t = MapTransition.from_doc(doc, self.map)
        if t.retire is not None and t.any_cut():
            # SHRINK crash matrix, collapsed: GC runs BEFORE commit (it
            # must address the sources in OLD index space), so any
            # post-cut crash — mid-move, mid-GC, or between GC and
            # commit — resumes the coordinator, which skips cut slices,
            # re-runs GC only if the persisted gc_complete says it owes
            # one (idempotent deletes), then commits and renumbers
            log.warning(
                "resuming interrupted shrink to map v%d (%d/%d slices "
                "cut, gc_complete=%s)", t.new_map.version,
                sum(1 for s in t.slices if s.state == "cut"),
                len(t.slices), t.gc_complete)
            self._install_transition(t)
            self._coordinator = RebalanceCoordinator(self, t).start()
            metrics.counter("scaleout_rebalance_transitions_total",
                            outcome="resumed").inc()
            return
        if doc.get("phase") == "committed" or t.all_cut():
            # raises if rebalance-added groups have no clients: serving
            # without them would misroute every cut slice (fail closed)
            self._install_transition(t)
            self.commit_rebalance(t)
            coord = RebalanceCoordinator(self, t)

            def _finish_gc():
                # OFF the boot path: the GC is a full source scan plus
                # batched deletes — leftover copies are inert until it
                # lands (the scatter-merge owner filter guards them)
                try:
                    coord._gc()
                    t.gc_complete = True
                    self.journal.save_transition(t.to_doc("done"))
                except Exception as e:  # noqa: BLE001 - re-runnable
                    log.warning(
                        "rebalance GC after recovered commit "
                        "incomplete (leftover source copies are inert "
                        "and re-dropped at the next boot): %s", e)

            threading.Thread(target=_finish_gc, daemon=True,
                             name="rebalance-gc").start()
            metrics.counter("scaleout_rebalance_transitions_total",
                            outcome="recovered").inc()
        elif t.any_cut():
            log.warning(
                "resuming interrupted rebalance to map v%d (%d/%d "
                "slices already cut)", t.new_map.version,
                sum(1 for s in t.slices if s.state == "cut"),
                len(t.slices))
            self._install_transition(t)
            self._coordinator = RebalanceCoordinator(self, t).start()
            metrics.counter("scaleout_rebalance_transitions_total",
                            outcome="resumed").inc()
        else:
            log.warning("aborting interrupted rebalance to map v%d "
                        "(no slice had cut — routing never left "
                        "v%d)", t.new_map.version, self.map.version)
            try:
                # drain pending dual-write splits FIRST: their
                # destination mirror legs would otherwise be re-created
                # AFTER the abort's copy drop and linger as stale rows
                self.recover_splits()
            except Exception as e:  # noqa: BLE001 - deferred like boot
                log.warning("split replay before rebalance abort "
                            "deferred: %s", e)
            abort_transition(self, t)

    def _read_anchor(self, resource_type: str, resource_id: str) -> int:
        """The ONE group answering reads anchored at this object right
        now: the moving-slice read owner during a transition (src until
        the slice's cut, dst after), the map owner otherwise. Global
        anchors keep the CURRENT map's deterministic anchor — every
        group in it holds the replicated globals throughout."""
        t = self._active_transition
        if t is not None:
            sl = t.slice_for(resource_type, resource_id)
            if sl is not None:
                return t.read_owner(sl)
        return self.map.anchor_shard(resource_type, resource_id)

    def _copies_may_linger(self) -> bool:
        """True while ANY transition's mover copies can still exist
        off-owner: an active transition, or an archived one whose GC
        has not finished. Once every transition is GC-complete the
        per-row owner filters have nothing to guard and the scatter
        fast paths return."""
        if self._active_transition is not None:
            return True
        return any(not t.gc_complete
                   for t in self._archived_transitions)

    def _admit_gathered(self, gi: int, resource_type: str,
                        resource_id: str) -> bool:
        """Scatter-merge filter while moved copies exist anywhere: a
        namespaced row is accepted only from its current read owner —
        a destination's not-yet-caught-up copy (or a source's
        not-yet-GC'd leftover) can never leak a stale grant into the
        union (fail-open)."""
        if not self._copies_may_linger():
            return True
        _, namespaced = split_resource(resource_id)
        if not namespaced:
            return True
        return self._read_anchor(resource_type, resource_id) == gi

    def _transitions(self) -> list:
        """Archived transitions in completion order, plus the active
        one last."""
        ts = list(self._archived_transitions)
        if self._active_transition is not None:
            ts.append(self._active_transition)
        return ts

    def _deliver_event(self, gi: int, rel, revision) -> bool:
        """Watch-event filter: read-owner-only delivery keeps merged
        streams gap- and duplicate-free across cutovers. Evaluated as
        an ERA WALK over the whole transition sequence: a key's
        ownership history is a chain of (owner, revision-window) eras
        bounded by each transition's cut revisions, and an event is
        delivered iff it falls inside one of ITS group's eras — which
        silences copy/catch-up touches and dual-write mirrors on a
        destination (below its cut), GC deletes on a source (above its
        cut), and still delivers a group's events again when a LATER
        transition moves the slice back to it."""
        ts = self._transitions()
        if not ts:
            return True
        try:
            rev = int(revision)
        except (TypeError, ValueError):
            return True
        ns, namespaced = split_resource(rel.resource_id)
        if not namespaced:
            for t in ts:
                if not t.deliver_global(gi, rev):
                    return False
            return True
        affecting = []
        for t in ts:
            sl = t.slice_for_key(ns, rel.resource_type)
            if sl is not None:
                affecting.append((t, sl))
        if not affecting:
            return True
        # walk the eras: cur = the owner of the open era, low = the
        # era's lower revision bound IN cur's OWN revision space
        ok = False
        cur = affecting[0][1].src
        low = None
        for t, sl in affecting:
            state, src_cut, dst_cut = t.cut_info(sl)
            if state != CUT_STATE:
                # the era is still open at the source; pre-cut copies
                # and mirrors on the destination are echoes
                break
            if gi == sl.src and src_cut is not None \
                    and (low is None or rev > low) and rev <= src_cut:
                ok = True
            cur, low = sl.dst, dst_cut
        if gi == cur and (low is None or rev > low):
            ok = True
        return ok

    def _known_map_versions(self) -> set:
        out = {self.map.version}
        t = self._active_transition
        if t is not None:
            out.add(t.old_map.version)
            out.add(t.new_map.version)
        for past in self._archived_transitions:
            out.add(past.old_map.version)
            out.add(past.new_map.version)
        return out

    def _resolve_token(self, revision) -> RevisionVector:
        """Watch resumption token -> a vector over TODAY's group space.
        A token minted under a different map that recorded transitions
        connect to today's is TRANSLATED step by step along the chain:
        a GROW extends it with zero components (the rebalance event
        filter suppresses the pre-cut records there); a SHRINK drops
        the retired component — but only when the token already sits
        at or past the transition's retire watermark (a token below it
        missed retiring-group events no surviving group re-delivers:
        StoreError, re-list semantics). A token from an unknown map
        version, or with a component count no transition explains, is
        REJECTED instead of misindexed. Version-tagged tokens enter
        the chain at their minting epoch; untagged ones at the first
        length match (exact for tagged, best-effort for raw vectors)."""
        if isinstance(revision, RevisionVector):
            vec, ver = revision, None
        elif isinstance(revision, int):
            vec, ver = RevisionVector(
                (int(revision),) * len(self.groups)), None
        else:
            vec, ver = RevisionVector.parse_versioned(revision)
        if ver is not None and ver not in self._known_map_versions():
            raise ShardMapError(
                f"watch token was minted under shard-map version {ver},"
                f" which this planner has no transition for (current: "
                f"{self.map.version}); re-list and re-watch")
        n = len(self.groups)
        if len(vec) == n and (ver is None or ver == self.map.version):
            return vec
        # committed transitions in commit order; the active one joins
        # only while it still GROWS the space (its added groups already
        # route) — an uncommitted shrink keeps the old space routing,
        # so its tokens bind directly above
        chain = list(self._archived_transitions)
        act = self._active_transition
        if act is not None and act.retire is None:
            chain.append(act)
        if ver is not None and ver != self.map.version:
            start = next((i for i, t in enumerate(chain)
                          if t.old_map.version == ver), None)
        else:
            start = next((i for i, t in enumerate(chain)
                          if t.old_map.n_groups == len(vec)), None)
        if start is not None:
            for t in chain[start:]:
                if t.old_map.n_groups != len(vec):
                    continue  # a retired archive left a gap; skip
                if t.retire is not None:
                    cut = (t.retire_cut if t.retire_cut is not None
                           else t.retire_watermark())
                    if vec[t.retire] < int(cut or 0):
                        raise StoreError(
                            "watch token predates the shrink to map "
                            f"v{t.new_map.version}: its component for "
                            f"retired group {t.retire} stops at "
                            f"{vec[t.retire]} but the group delivered "
                            f"through {cut}; re-list and re-watch")
                    vec = vec.drop_component(t.retire)
                else:
                    vec = vec.extend(t.new_map.n_groups)
            if len(vec) == n:
                return vec
        raise ShardMapError(
            f"watch token has {len(vec)} components but the planner "
            f"routes {n} groups and no recorded transition maps "
            "between them; re-list and re-watch")

    def _enter_write_gates(self, ops) -> tuple:
        """Cutover gates for every moving slice a write touches (sid
        order — no lock-order inversions); non-moving writes never
        wait. The cutover freeze drains these before the atomic flip."""
        t = self._active_transition
        if t is None:
            return ()
        slices = {}
        for op in ops:
            sl = t.slice_for(op.rel.resource_type, op.rel.resource_id)
            if sl is not None:
                slices[sl.sid] = sl
        gates = []
        for sid in sorted(slices):
            slices[sid].gate.enter()
            gates.append(slices[sid].gate)
        return tuple(gates)

    def rebalance_status(self) -> Optional[dict]:
        t = self._active_transition
        return None if t is None else t.progress()

    # -- coordinated live schema migration (migration/migrator.py) -----------
    # Every group runs its own SchemaMigrator with ``hold_at_dual``; the
    # planner journals the cross-group decision and releases every group
    # into its cut only after ALL of them sit at dual with zero lag — so
    # no request ever scatters across groups evaluating different
    # schemas past the cut point.

    MIGRATION_POLL = 0.05

    @staticmethod
    def _mig_begin(client, schema_text: str, **cfg) -> dict:
        if hasattr(client, "migrate_begin"):
            return client.migrate_begin(schema_text, hold_at_dual=True,
                                        **cfg)
        return client.begin_schema_migration(schema_text,
                                             hold_at_dual=True, **cfg)

    @staticmethod
    def _mig_status(client) -> Optional[dict]:
        if hasattr(client, "migrate_status"):
            return client.migrate_status()
        return client.migration_status()

    @staticmethod
    def _mig_cut(client) -> dict:
        if hasattr(client, "migrate_cut"):
            return client.migrate_cut(wait=True)
        return client.cut_schema_migration(wait=True)

    @staticmethod
    def _mig_abort(client) -> None:
        try:
            if hasattr(client, "migrate_abort"):
                client.migrate_abort()
            else:
                client.abort_schema_migration()
        except Exception:  # noqa: BLE001 - abort fan-out best-effort
            pass

    def begin_schema_migration(self, schema_text: str,
                               wait: bool = False,
                               timeout: float = 600.0,
                               **cfg) -> dict:
        """Coordinated migration of EVERY group to ``schema_text``.
        Group 0 classifies first — an incompatible change raises its
        typed :class:`SchemaError` on this stack before any other group
        changes state. Returns the aggregate status; ``wait=True``
        blocks through the coordinated cut."""
        m = self._migration
        if m is not None and m.get("phase") not in ("done", "aborted",
                                                    "failed"):
            raise StoreError("a coordinated schema migration is "
                             "already running")
        doc = {"phase": "begin", "schema_text": schema_text,
               "groups": len(self.groups)}
        if self.journal is not None:
            self.journal.save_migration(doc)
        begun: list = []
        try:
            for gi, c in enumerate(self.groups):
                self._mig_begin(c, schema_text, **cfg)
                begun.append(gi)
        except BaseException:
            # typed refusal (or a group begin failing): no group has cut
            # — roll every begun group back and clear the record so the
            # journal never claims a migration that is not running
            for gi in begun:
                self._mig_abort(self.groups[gi])
            if self.journal is not None:
                self.journal.clear_migration()
            raise
        self._migration = {"phase": "dual-wait",
                           "groups": len(self.groups), "at_dual": 0,
                           "error": None}
        if self.journal is not None:
            doc["phase"] = "dual-wait"
            self.journal.save_migration(doc)
        t = threading.Thread(target=self._coordinate_cut,
                             args=(time.monotonic() + timeout,),
                             name="schema-migration", daemon=True)
        self._migration_thread = t
        t.start()
        if wait:
            t.join(timeout)
        return dict(self._migration)

    def _coordinate_cut(self, deadline: float) -> None:
        """Poll every group to dual/zero-lag, journal the cut decision,
        then release all groups (each group's own record makes its cut
        idempotent under re-issue)."""
        m = self._migration
        try:
            while True:
                sts = []
                for c in self.groups:
                    try:
                        sts.append(self._mig_status(c))
                    except Exception:  # noqa: BLE001 - transient
                        # a group mid-failover: treat as not-ready and
                        # keep polling (the deadline bounds this); only
                        # a group ANSWERING failed/aborted/None is a
                        # definitive coordination failure
                        sts.append({"phase": "unreachable"})
                bad = [s for s in sts
                       if s is None or s.get("phase") in ("failed",
                                                          "aborted")]
                if bad:
                    raise RuntimeError(
                        f"{len(bad)} group(s) failed/aborted before "
                        "the coordinated cut")
                ready = sum(1 for s in sts
                            if s.get("phase") == "dual"
                            and not s.get("lag"))
                m["at_dual"] = ready
                if ready == len(self.groups):
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"groups at dual: {ready}/{len(self.groups)} "
                        "when the coordination deadline expired")
                time.sleep(self.MIGRATION_POLL)
            # the point of no return is PERSISTED before any group is
            # released: a planner crash after this line re-issues the
            # cuts at boot instead of aborting a half-cut fleet
            if self.journal is not None:
                self.journal.save_migration(
                    {"phase": "cutting", "groups": len(self.groups)})
            m["phase"] = "cutting"
            for c in self.groups:
                self._mig_cut(c)
            # the fleet now serves a NEW schema: re-derive the frontier
            # reference pairs on next use (config-pinned pairs stand)
            self._frontier_pairs = (None if self.frontier is None
                                    else self.frontier.pairs)
            if self.journal is not None:
                self.journal.clear_migration()
            metrics.counter("scaleout_schema_migrations_total",
                            outcome="done").inc()
            # a terminal phase admits the next begin: published only
            # once this attempt's journal record is gone
            m["phase"] = "done"
        except BaseException as e:  # noqa: BLE001 - worker boundary
            m["error"] = str(e)
            try:
                self._roll_back_groups()
                if self.journal is not None:
                    self.journal.clear_migration()
            finally:
                # published only after the rollback: a re-begin issued
                # the moment "failed" shows must not meet this attempt's
                # migration still running on a slow-to-abort group
                m["phase"] = "failed"
            metrics.counter("scaleout_schema_migrations_total",
                            outcome="failed").inc()
            log.error("coordinated schema migration failed: %s", e)

    def _roll_back_groups(self, budget: float = 30.0) -> None:
        """Abort every group and poll until none still runs a migration
        (bounded by ``budget``), re-issuing the abort to any group that
        does: an abort lost to a failover or a client timeout would
        otherwise leave that group held at dual, refusing every later
        begin."""
        deadline = time.monotonic() + budget
        pending = list(self.groups)
        while True:
            for c in pending:
                self._mig_abort(c)
            still = []
            for c in pending:
                try:
                    st = self._mig_status(c)
                except Exception:  # noqa: BLE001 - unreachable: retry
                    still.append(c)
                    continue
                if st is not None and st.get("phase") not in (
                        "done", "aborted", "failed"):
                    still.append(c)
            pending = still
            if not pending or time.monotonic() >= deadline:
                if pending:
                    log.warning("coordinated migration rollback: %d "
                                "group(s) still migrating after %.0f s",
                                len(pending), budget)
                return
            time.sleep(self.MIGRATION_POLL)

    def _recover_migration(self) -> None:
        """Boot-time crash matrix for the COORDINATED record: "cutting"
        persisted -> some group may already serve S' — re-issue every
        cut (idempotent: an already-cut group just reports done);
        anything earlier -> no group cut, abort them all cleanly."""
        doc = self.journal.load_migration()
        if doc is None:
            return
        if doc.get("phase") == "cutting":
            log.warning("resuming interrupted coordinated schema "
                        "migration cut across %d groups",
                        len(self.groups))
            for c in self.groups:
                try:
                    self._mig_cut(c)
                except Exception as e:  # noqa: BLE001 - per-group
                    # the group's OWN persisted record finishes its cut
                    # at its next boot; this planner must still serve
                    log.warning("migration cut re-issue failed: %s", e)
            self._migration = {"phase": "done",
                               "groups": len(self.groups),
                               "recovered": True}
            metrics.counter("scaleout_schema_migrations_total",
                            outcome="boot-resumed").inc()
        else:
            log.warning("aborting interrupted coordinated schema "
                        "migration (phase %r, no cut persisted)",
                        doc.get("phase"))
            for c in self.groups:
                self._mig_abort(c)
            self._migration = {"phase": "aborted",
                               "groups": len(self.groups),
                               "recovered": True}
            metrics.counter("scaleout_schema_migrations_total",
                            outcome="boot-aborted").inc()
        self.journal.clear_migration()

    def migration_status(self) -> Optional[dict]:
        """Aggregate coordinated-migration status (or the per-group
        worst phase while one is in flight); None when this planner
        never migrated."""
        m = self._migration
        if m is None:
            return None
        out = dict(m)
        if m.get("phase") in ("dual-wait", "cutting"):
            lags = []
            for c in self.groups:
                try:
                    s = self._mig_status(c)
                except Exception:  # noqa: BLE001 - status best-effort
                    s = None
                if s is not None and s.get("lag") is not None:
                    lags.append(int(s["lag"]))
            out["lag"] = max(lags) if lags else None
        return out

    # -- scatter machinery ---------------------------------------------------

    def n_shards(self) -> int:
        return self.map.n_groups

    def admission_fanout(self, cls) -> int:
        """How many shards one op of ``cls`` will touch — the proxy-side
        admission multiplier (a scatter is charged once per touched
        shard)."""
        if cls is not None and cls.name in _SCATTER_CLASSES:
            # during a rebalance the scatter width includes the
            # transition-added groups
            return len(self.groups)
        return 1

    # scatter ops whose legs are PURE READS: a failed leg may be
    # re-issued once through the shared retry budget (writes/deletes
    # never — their at-least-once story is the journal's)
    _RETRYABLE_SCATTER = frozenset({
        "lookup_resources", "lookup_subjects", "read_relationships",
        "exists", "watch_since", "revision", "check_bulk",
        "frontier_expand",
    })

    def _scatter(self, op: str, fn,
                 shards: Optional[list] = None) -> dict:
        """Run ``fn(group_index, client)`` on the named shards (default:
        all) concurrently; returns {shard: result}. One shard shedding
        (AdmissionRejected) fails the WHOLE scatter closed with
        Retry-After = max over the shedding shards; a read leg dying on
        the transport gets ONE budget-gated re-issue (the group client
        already spent its own retries — this layer's re-issue draws
        from the SAME RetryBudget, so the stack stays bounded); any
        other error propagates after the fan-in."""
        targets = list(range(len(self.groups))) if shards is None \
            else sorted(set(shards))
        with tracer.span("shard_fanout", op=op, shards=len(targets)):
            if len(targets) == 1:
                gi = targets[0]
                _op_counter(gi, op, "scatter").inc()
                return {gi: fn(gi, self.groups[gi])}
            futs = {gi: self._pool.submit(fn, gi, self.groups[gi])
                    for gi in targets}
            results: dict = {}
            sheds: dict = {}
            first_err = None
            for gi, f in futs.items():
                _op_counter(gi, op, "scatter").inc()
                try:
                    results[gi] = f.result()
                except AdmissionRejected as e:
                    sheds[gi] = e
                except Exception as e:  # noqa: BLE001 - re-raised below
                    # re-issue only TRANSPORT deaths: an open breaker or
                    # a deadline-family rejection is deterministic on
                    # the immediate retry — withdrawing a token for it
                    # would drain the shared budget on attempts that
                    # cannot succeed (the group client already spent
                    # its own classified handling on those)
                    if op in self._RETRYABLE_SCATTER \
                            and isinstance(e, TRANSPORT_ERRORS) \
                            and self.retry_budget is not None \
                            and self.retry_budget.allow():
                        try:
                            results[gi] = fn(gi, self.groups[gi])
                            metrics.counter(
                                "scaleout_scatter_retries_total",
                                group=str(gi)).inc()
                            continue
                        except AdmissionRejected as e2:
                            sheds[gi] = e2
                            continue
                        except Exception as e2:  # noqa: BLE001
                            e = e2
                    if first_err is None:
                        first_err = e
        if sheds:
            # partial shed fails CLOSED: a gather missing one shard's
            # slice would silently hide that shard's resources (fail
            # open for list-prefilter denials). Retry-After is the max
            # over shards so a polite client outwaits the slowest one.
            metrics.counter("scaleout_partial_shed_total").inc()
            worst = max(sheds.values(), key=lambda e: e.retry_after)
            raise AdmissionRejected(
                worst.op_class,
                f"{len(sheds)}/{len(targets)} shards shed the scatter",
                retry_after=worst.retry_after,
                dependency="shard-admission")
        if first_err is not None:
            raise first_err
        return results

    def _single(self, gi: int, op: str, fn):
        _op_counter(gi, op, "single").inc()
        return fn(self.groups[gi])

    # -- checks --------------------------------------------------------------

    def _check_key(self, items: list, context: Optional[dict]):
        # context values include LISTS (the middleware's `groups`):
        # canonical JSON makes the key hashable and deterministic;
        # anything non-serializable simply bypasses the cache
        try:
            ctx = json.dumps(context, sort_keys=True,
                             separators=(",", ":")) if context else ""
        except (TypeError, ValueError):
            return None
        items_k = tuple(
            (it.resource_type, it.resource_id, it.permission,
             it.subject_type, it.subject_id, it.subject_relation)
            for it in items)
        return ("check", items_k, ctx)

    def try_cached_check(self, items: list,
                         context: Optional[dict] = None
                         ) -> Optional[list]:
        """Vector-keyed probe: the full verdict list only when a cached
        entry exists at EXACTLY the planner's current tracked vector."""
        if self.cache is None or not items:
            return None
        key = self._check_key(items, context)
        if key is None:
            return None
        return self.cache.get(key, self.vector)

    # -- reads across a routing change ---------------------------------------
    # A gather keeps a moving slice's rows from the slice's read owner as
    # of the MERGE, but each group answered when its leg ran: a slice cut,
    # a commit or an install in between can drop the slice from both sides
    # (the source's rows filtered as a non-owner, the destination's leg run
    # before its last catch-up), and a routed call can reach a source whose
    # rows the post-commit GC already dropped. The JAX package under-lists
    # (fail-closed, not exact) in that window; here a read whose routing
    # epoch moved while it ran runs again. Epochs move a bounded number of
    # times a transition, so the loop ends; the cap fails closed.
    ROUTE_RETRIES = 64

    def _route_epoch(self) -> tuple:
        t = self._active_transition
        return (self._route_gen, id(t),
                None if t is None else t.generation)

    def _stable_read(self, fn):
        for _ in range(self.ROUTE_RETRIES):
            before = self._route_epoch()
            try:
                out = fn()
            except IndexError:
                # a shrink's commit took a group out of ``groups`` while
                # the read indexed it: the epoch moved with it
                if self._route_epoch() == before:
                    raise
            else:
                if self._route_epoch() == before:
                    return out
            metrics.counter("scaleout_read_route_retries_total").inc()
        raise StoreError(
            "shard routing changed under every attempt of a read; retry")

    def check_bulk(self, items: list, now: Optional[float] = None,
                   context: Optional[dict] = None) -> list:
        return self._stable_read(
            lambda: self._check_bulk(items, now, context))

    def _check_bulk(self, items: list, now: Optional[float] = None,
                    context: Optional[dict] = None) -> list:
        """Plan the bulk: items grouped by their resource's owning
        shard; a single-shard bulk routes directly (NO scatter), a
        mixed bulk scatters only to the owning shards and reassembles
        in item order."""
        if not items:
            return []
        by_shard: dict[int, list] = {}
        for idx, it in enumerate(items):
            gi = self._read_anchor(it.resource_type, it.resource_id)
            by_shard.setdefault(gi, []).append(idx)
        cache_key = None
        if self.cache is not None and now is None:
            cache_key = self._check_key(items, context)
        vec_before = self.vector
        if len(by_shard) == 1:
            gi = next(iter(by_shard))
            out = self._single(
                gi, "check_bulk",
                lambda c: c.check_bulk(items, now=now, context=context))
        else:
            results = self._scatter(
                "check_bulk",
                lambda gi, c, _b=by_shard: c.check_bulk(
                    [items[i] for i in _b[gi]], now=now, context=context),
                shards=list(by_shard))
            out = [False] * len(items)
            with tracer.span("shard_merge", op="check_bulk"):
                for gi, idxs in by_shard.items():
                    for pos, verdict in zip(idxs, results[gi]):
                        out[pos] = bool(verdict)
        if self.frontier is not None and not all(out):
            # cross-shard closure pass for the locally-denied residue:
            # runs BEFORE the cache put so a frontier-granted verdict
            # caches at vec_before like any other (and a denial stays
            # a denial only after the exchange had its say)
            out = self._frontier_recheck(items, out, now, context)
        if cache_key is not None:
            # keyed at the vector observed BEFORE dispatch: any write
            # landing during the dispatch advances the tracked vector
            # and makes this entry unreachable (conservative, never
            # stale-serving)
            self.cache.put(cache_key, vec_before, list(out))
        return out

    def check(self, item: CheckItem, now: Optional[float] = None,
              context: Optional[dict] = None) -> bool:
        return self.check_bulk([item], now=now, context=context)[0]

    # -- lookups (scatter-gather) --------------------------------------------

    def lookup_resources(self, resource_type: str, permission: str,
                         subject_type: str, subject_id: str,
                         subject_relation: Optional[str] = None,
                         now: Optional[float] = None,
                         context: Optional[dict] = None) -> list:
        return self._stable_read(lambda: self._lookup_resources(
            resource_type, permission, subject_type, subject_id,
            subject_relation, now, context))

    def _lookup_resources(self, resource_type, permission, subject_type,
                          subject_id, subject_relation, now,
                          context) -> list:
        results = self._scatter(
            "lookup_resources",
            lambda gi, c: c.lookup_resources(
                resource_type, permission, subject_type, subject_id,
                subject_relation, now=now, context=context))
        with tracer.span("shard_merge", op="lookup_resources"):
            seen = set()
            out = []
            for gi in sorted(results):
                for rid in results[gi]:
                    if not self._admit_gathered(gi, resource_type, rid):
                        continue  # a mover copy, not the read owner
                    if rid not in seen:
                        seen.add(rid)
                        out.append(rid)
        if self.frontier is not None:
            # widen by the subject's cross-shard closure: each userset
            # the subject transitively belongs to is looked up as a
            # subject in its own right (exact for monotone schemas —
            # reference_pairs refused anything else)
            self._frontier_lookup_union(
                out, seen, resource_type, permission, subject_type,
                subject_id, subject_relation, now, context)
        metrics.histogram("scaleout_scatter_fanout").observe(
            len(results))
        return out

    def lookup_resources_mask(self, resource_type: str, permission: str,
                              subject_type: str, subject_id: str,
                              subject_relation: Optional[str] = None,
                              now: Optional[float] = None,
                              context: Optional[dict] = None):
        """Gathered mask: per-shard masks merge client-side into ONE
        (mask, id view) pair over the sorted union of allowed ids — the
        canonical gather form, independent of per-shard interner layout
        (so two deployments sharding the same tuples differently produce
        byte-identical masks)."""
        ids = self.lookup_resources(
            resource_type, permission, subject_type, subject_id,
            subject_relation, now=now, context=context)
        ids = sorted(ids)
        return (np.ones(len(ids), dtype=bool), RemoteInterner(ids))

    def lookup_subjects(self, resource_type: str, resource_id: str,
                        permission: str, subject_type: str,
                        subject_relation: Optional[str] = None,
                        now: Optional[float] = None,
                        context: Optional[dict] = None) -> list:
        return self._stable_read(lambda: self._lookup_subjects(
            resource_type, resource_id, permission, subject_type,
            subject_relation, now, context))

    def _lookup_subjects(self, resource_type, resource_id, permission,
                         subject_type, subject_relation, now,
                         context) -> list:
        """Anchored at ONE resource. A NAMESPACED anchor is exact on
        its owning shard alone: the resource's closure is shard-local
        (namespaced slice + replicated globals), and a subject whose
        tuples live only on OTHER shards has no path into that closure
        — so one direct call, not an n_groups scatter. GLOBAL anchors
        scatter and union: each shard's candidate subject universe
        covers its own namespaced slice, and a permitted subject must
        hold global tuples (visible to every shard), so the union is
        exact and mostly deduplicates."""
        _, namespaced = split_resource(resource_id)
        if namespaced:
            # owning shard under the CURRENT placement — a moving
            # slice's anchor follows the rebalance read owner
            owner = self._read_anchor(resource_type, resource_id)
            return self._single(
                owner, "lookup_subjects",
                lambda c: c.lookup_subjects(
                    resource_type, resource_id, permission,
                    subject_type, subject_relation, now=now,
                    context=context))
        results = self._scatter(
            "lookup_subjects",
            lambda gi, c: c.lookup_subjects(
                resource_type, resource_id, permission, subject_type,
                subject_relation, now=now, context=context))
        with tracer.span("shard_merge", op="lookup_subjects"):
            out = sorted({sid for got in results.values()
                          for sid in got})
        return out

    # -- cross-shard frontier exchange (scaleout/frontier.py) ----------------

    def _frontier_pair_set(self) -> tuple:
        """The schema's reference pairs, resolved lazily on first use:
        config-pinned, else asked of group 0 over the wire
        (``frontier_pairs`` op), else derived from its in-process
        schema. Every group serves the same schema (the coordinated
        migration guarantees it), so one group's answer is THE answer;
        the coordinated cut resets the cache so a migrated schema
        re-derives. A non-monotone schema raises FrontierError here —
        the exchange refuses to run rather than compose wrong."""
        if self.frontier is None:
            return ()
        pairs = self._frontier_pairs
        if pairs is None:
            c = self.groups[0]
            if hasattr(c, "frontier_pairs"):
                pairs = c.frontier_pairs()
            else:
                from .frontier import reference_pairs
                pairs = reference_pairs(c.schema)
            pairs = tuple(sorted((str(t), str(r)) for t, r in pairs))
            self._frontier_pairs = pairs
        return pairs

    def _frontier_leg(self, gi: int, c, descs, pairs, now, context):
        if hasattr(c, "frontier_expand"):
            return c.frontier_expand(descs, pairs, now=now,
                                     context=context)
        from .frontier import expand_local
        return expand_local(c, descs, pairs, now=now, context=context)

    def frontier_closure(self, subject_type: str, subject_id: str,
                         subject_relation: Optional[str] = None,
                         now: Optional[float] = None,
                         context: Optional[dict] = None) -> set:
        """The subject's cross-shard membership closure: every userset
        descriptor ``(type, id, relation)`` the subject transitively
        belongs to, computed by the iterative frontier exchange
        (scaleout/frontier.py module docstring). Each round scatters
        ONLY the newly-resolved boundary descriptors — the wire-bytes
        counters measure exactly the canonical encoding of what moved,
        in both directions. The round budget is HARD and fails CLOSED:
        an exhausted exchange returns the partial closure, which can
        only under-approximate (deny / under-list, never over-grant)."""
        pairs = self._frontier_pair_set()
        if not pairs:
            return set()
        from .frontier import encode_frontier
        max_rounds = max(1, int(self.frontier.max_rounds))
        seed = (str(subject_type), str(subject_id),
                None if subject_relation is None
                else str(subject_relation))
        visited = {seed}
        frontier = {seed}
        closure: set = set()
        rounds = 0
        outcome = "converged"
        with tracer.span("frontier_exchange",
                         subject=f"{seed[0]}:{seed[1]}"):
            while frontier:
                if rounds >= max_rounds:
                    outcome = "budget-exhausted"
                    log.warning(
                        "frontier exchange for %s:%s exhausted its "
                        "%d-round budget with %d descriptors still "
                        "unexpanded; proceeding with the partial "
                        "closure (fail-closed: may deny/under-list, "
                        "never over-grants)", seed[0], seed[1],
                        max_rounds, len(frontier))
                    break
                rounds += 1
                payload = encode_frontier(frontier)
                metrics.counter(
                    "scaleout_frontier_boundary_tuples_total").inc(
                        len(frontier))
                descs = sorted(
                    frontier, key=lambda d: (d[0], d[1], d[2] or ""))
                results = self._scatter(
                    "frontier_expand",
                    lambda gi, c, _d=descs: self._frontier_leg(
                        gi, c, _d, pairs, now, context))
                nxt: set = set()
                for gi in sorted(results):
                    got = results[gi]
                    metrics.counter(
                        "scaleout_frontier_wire_bytes_total",
                        direction="scatter").inc(len(payload))
                    metrics.counter(
                        "scaleout_frontier_wire_bytes_total",
                        direction="gather").inc(
                            len(encode_frontier(got)))
                    for d in got:
                        # mover copies filter here like any gather: a
                        # not-yet-cut destination (or un-GC'd source)
                        # must not smuggle a membership its read owner
                        # doesn't serve
                        if self._admit_gathered(gi, d[0], d[1]):
                            nxt.add(d)
                fresh = nxt - visited
                visited |= fresh
                closure |= fresh
                frontier = fresh
        metrics.histogram("scaleout_frontier_rounds").observe(rounds)
        metrics.counter("scaleout_frontier_exchanges_total",
                        outcome=outcome).inc()
        return closure

    def _frontier_recheck(self, items: list, out: list, now, context
                          ) -> list:
        """Second check pass for locally-denied items: compute each
        denied subject's closure once, then re-check the item on its
        resource's read owner with every closure descriptor as the
        subject — the owner holds the ``resource -> userset`` tuple and
        the engine seeds userset subjects natively, so ANY True means
        the cross-shard path exists and the item is granted. Monotone
        schemas only (enforced at pair derivation), so the union of
        verdicts is exact."""
        closures: dict = {}
        for pos, it in enumerate(items):
            if out[pos]:
                continue
            skey = (it.subject_type, it.subject_id,
                    it.subject_relation)
            if skey not in closures:
                closures[skey] = sorted(
                    self.frontier_closure(*skey, now=now,
                                          context=context),
                    key=lambda d: (d[0], d[1], d[2] or ""))
            descs = closures[skey]
            if not descs:
                continue
            gi = self._read_anchor(it.resource_type, it.resource_id)
            checks = [CheckItem(it.resource_type, it.resource_id,
                                it.permission, t, i, rel)
                      for (t, i, rel) in descs]
            verdicts = self._single(
                gi, "check_bulk",
                lambda c, _ck=checks: c.check_bulk(
                    _ck, now=now, context=context))
            if any(verdicts):
                out[pos] = True
        return out

    def _frontier_lookup_union(self, out: list, seen: set,
                               resource_type: str, permission: str,
                               subject_type: str, subject_id: str,
                               subject_relation, now, context) -> None:
        """Widen a gathered lookup by the subject's closure: each
        closure descriptor runs its own scatter as the subject, and the
        results union in (owner-filtered and deduped like the primary
        gather). Appends into ``out``/``seen`` in place."""
        closure = sorted(
            self.frontier_closure(subject_type, subject_id,
                                  subject_relation, now=now,
                                  context=context),
            key=lambda d: (d[0], d[1], d[2] or ""))
        for t, i, rel in closure:
            results = self._scatter(
                "lookup_resources",
                lambda gi, c, _t=t, _i=i, _r=rel: c.lookup_resources(
                    resource_type, permission, _t, _i, _r,
                    now=now, context=context))
            for gi in sorted(results):
                for rid in results[gi]:
                    if not self._admit_gathered(gi, resource_type,
                                                rid):
                        continue
                    if rid not in seen:
                        seen.add(rid)
                        out.append(rid)

    # -- relationship reads --------------------------------------------------

    def _filter_shards(self, f: RelationshipFilter) -> Optional[list]:
        """Owning shards of a filter, or None for "all" (scatter)."""
        if f.resource_type and f.resource_id:
            # namespaced: the current read owner (rebalance-aware);
            # global: replicated — ONE deterministic group
            return [self._read_anchor(f.resource_type, f.resource_id)]
        return None

    def read_relationships(self, f: RelationshipFilter) -> list:
        return self._stable_read(lambda: self._read_relationships(f))

    def _read_relationships(self, f: RelationshipFilter) -> list:
        shards = self._filter_shards(f)
        if shards is not None and len(shards) == 1:
            return self._single(shards[0], "read_relationships",
                                lambda c: list(c.read_relationships(f)))
        results = self._scatter(
            "read_relationships",
            lambda gi, c: list(c.read_relationships(f)), shards=shards)
        with tracer.span("shard_merge", op="read_relationships"):
            seen = set()
            out = []
            for gi in sorted(results):
                for rel in results[gi]:
                    if not self._admit_gathered(gi, rel.resource_type,
                                                rel.resource_id):
                        continue  # a mover copy, not the read owner
                    k = rel.key()
                    if k not in seen:
                        seen.add(k)
                        out.append(rel)
        return out

    def exists(self, f: RelationshipFilter) -> bool:
        return self._stable_read(lambda: self._exists(f))

    def _exists(self, f: RelationshipFilter) -> bool:
        shards = self._filter_shards(f)
        if shards is not None and len(shards) == 1:
            return self._single(shards[0], "exists",
                                lambda c: c.store.exists(f))
        if self._copies_may_linger():
            # an UNANCHORED probe during/after a move: a bare boolean
            # from a group holding not-yet-caught-up (or not-yet-GC'd)
            # copies could answer True for a tuple its read owner
            # already deleted — gather the rows instead, so the
            # per-row owner filter applies (fail-closed, never stale)
            return bool(self.read_relationships(f))
        results = self._scatter("exists",
                                lambda gi, c: c.store.exists(f),
                                shards=shards)
        return any(results.values())

    # -- writes --------------------------------------------------------------

    def _plan_write(self, ops: list) -> dict[int, list]:
        """shard -> [WriteOp...]: namespaced tuples go to their owner,
        global tuples replicate to EVERY group (including rebalance-
        added ones — their global replica stays complete from the
        moment the transition installs). A moving slice in its
        dual-write window MIRRORS to both owners; a cut slice routes
        to the new owner only."""
        t = self._active_transition
        plan: dict[int, list] = {}
        for op in ops:
            gi = self.map.shard_of(op.rel.resource_type,
                                   op.rel.resource_id)
            if gi is None:
                for g in range(len(self.groups)):
                    plan.setdefault(g, []).append(op)
                continue
            owners = (gi,)
            if t is not None:
                sl = t.slice_for(op.rel.resource_type,
                                 op.rel.resource_id)
                if sl is not None:
                    owners = t.write_owners(sl)
                    if len(owners) > 1:
                        metrics.counter(
                            "scaleout_rebalance_dual_writes_total"
                        ).inc()
            for g in owners:
                plan.setdefault(g, []).append(op)
        return plan

    def _route_preconditions(self, pcs: list, plan_shards) -> dict:
        """shard -> [Precondition...], with EVERY decision point at or
        before the FIRST shard's apply: once the first shard has
        applied, the only failures left are transport/availability —
        which recovery may replay to completion. A precondition that
        could reject on a LATER shard would make the journal replay a
        write its caller was told failed.

        - anchored GLOBAL (replicated — the dtx lock tuple): binds
          atomically on the FIRST split shard only; replicas agree, so
          shard 0's verdict is THE verdict, and concurrent lock races
          serialize on that one store's atomic check-and-write;
        - namespaced with its owner = the first shard: binds there
          atomically;
        - everything else (unanchored, owner later in the split, owner
          outside the split): one routed existence probe decides it up
          front — NOT atomic with the split (loss table)."""
        out: dict[int, list] = {gi: [] for gi in plan_shards}
        first = min(plan_shards)
        for pc in pcs:
            f = pc.filter
            anchored = bool(f.resource_type and f.resource_id)
            gi = None
            if anchored and split_resource(f.resource_id)[1]:
                # namespaced anchor: the CURRENT read owner (a moving
                # slice's pc binds where its data is served from)
                gi = self._read_anchor(f.resource_type, f.resource_id)
            if gi is None and anchored:
                out[first].append(pc)
            elif gi is not None and gi == first:
                out[gi].append(pc)
            else:
                holds = self.exists(f)
                if holds != pc.must_exist:
                    raise PreconditionFailed(
                        "cross-shard precondition on "
                        f"{f.resource_type or '*'}:"
                        f"{f.resource_id or '*'} failed")
        return out

    def write_relationships(self, ops: list,
                            preconditions: list = ()):
        # cutover gates for any moving slice this write touches: held
        # across planning AND dispatch, so the flip's freeze observes
        # a quiesced slice (non-moving writes never wait here)
        gates = self._enter_write_gates(ops)
        try:
            plan = self._plan_write(ops)
            if not plan:
                return self.vector
            if len(plan) == 1:
                gi = next(iter(plan))
                # preconditions route like the split path: ones this
                # shard can decide (its own slice, or a replicated
                # global) bind atomically; a namespaced pc owned
                # ELSEWHERE is probed through the planner — the target
                # shard's store simply doesn't hold it (a must_exist
                # would always fail, a must_not_exist would always
                # pass: fail open)
                pcs = self._route_preconditions(list(preconditions),
                                                [gi]).get(gi, [])
                rev = self._single(
                    gi, "write_relationships",
                    lambda c: c.write_relationships(plan[gi], pcs))
                self._observe_revision(gi, rev)
                return self.vector
            return self._split_write(plan, list(preconditions))
        finally:
            for g in gates:
                g.exit()

    def _split_write(self, plan: dict, preconditions: list):
        """Cross-shard split: journal the full plan durably, apply
        shard-by-shard in index order through each group's ordinary
        WAL/ack path, mark progress, delete the entry when complete. A
        crash between any two steps leaves a pending journal entry the
        next planner replays (creates degraded to touches: idempotent
        against a shard that applied before the crash)."""
        if self.journal is not None and self.journal.pending_count():
            # deferred recovery (an unreachable shard at boot): retry
            # BEFORE journaling new work so replays keep write order
            try:
                self.recover_splits()
            except Exception as e:  # noqa: BLE001 - still best-effort
                log.warning("split-write recovery still deferred: %s",
                            e)
        pcs_by_shard = self._route_preconditions(preconditions,
                                                 list(plan))
        sid = None
        if self.journal is not None:
            t = self._active_transition
            sid = self.journal.begin(
                {gi: [{"op": o.op, "rel": _rel_to_dict(o.rel)}
                      for o in plan[gi]] for gi in plan},
                [{"filter": asdict(p.filter),
                  "must_exist": p.must_exist}
                 for p in preconditions],
                self.map.version,
                # a dual-write window split is tagged with BOTH
                # versions: its recorded owners are already the union
                # of the two placements, so replay must not re-route it
                map_version_to=(t.new_map.version
                                if t is not None else None))
        with tracer.span("shard_fanout", op="split_write",
                         shards=len(plan)):
            first = True
            for gi in sorted(plan):
                try:
                    rev = self._single(
                        gi, "write_relationships",
                        lambda c, _gi=gi: c.write_relationships(
                            plan[_gi], pcs_by_shard.get(_gi, [])))
                except _PROVABLY_NOT_APPLIED:
                    if first and sid is not None:
                        # provably nothing applied anywhere — close
                        # the entry so recovery doesn't resurrect a
                        # write whose rejection the caller already
                        # saw. Later shards can only fail via the
                        # transport (every decision point is at the
                        # first shard — _route_preconditions), so a
                        # pending entry is always safe to complete.
                        self.journal.finish(sid)
                    raise
                # any OTHER failure is AMBIGUOUS (transport death,
                # exhausted deadline — FailoverEngine's own rule: 'an
                # exhausted deadline may have dispatched'): the write
                # MAY have applied even on the first shard, so the
                # entry STAYS pending and recovery touch-replays
                # everything — the caller's error means at-LEAST-once,
                # never silently half-applied. A global split racing a
                # shrink's commit is one: its last leg indexes a group
                # the commit took out of ``groups`` (an IndexError), and
                # recover_splits re-routes the entry on the new map
                first = False
                self._observe_revision(gi, rev)
                if sid is not None:
                    self.journal.mark_applied(sid, gi)
        if sid is not None:
            self.journal.finish(sid)
        return self.vector

    def delete_relationships(self, f: RelationshipFilter,
                             preconditions: list = ()) -> int:
        owner = None
        namespaced = False
        if f.resource_type and f.resource_id:
            _, namespaced = split_resource(f.resource_id)
            if namespaced:
                owner = self.map.shard_of(f.resource_type, f.resource_id)
        t = self._active_transition
        gates: tuple = ()
        if t is not None:
            # cutover gates: an anchored delete gates its own slice; an
            # unanchored/global delete may touch ANY moving slice, so it
            # gates them all — a delete slipping between the flip's
            # final drain and the cut record would vanish from the new
            # owner (stale allow after cutover)
            if namespaced:
                sl = t.slice_for(f.resource_type, f.resource_id)
                slices = [sl] if sl is not None else []
            else:
                slices = sorted(t.slices, key=lambda s: s.sid)
            for sl in slices:
                sl.gate.enter()
            gates = tuple(sl.gate for sl in slices)
        try:
            return self._delete_routed(f, preconditions, owner, t,
                                       namespaced)
        finally:
            for g in gates:
                g.exit()

    def _delete_routed(self, f: RelationshipFilter, preconditions,
                       owner, t, namespaced: bool) -> int:
        if owner is not None:
            # a namespaced anchor: ONE owning slice — mirrored to both
            # owners during its dual-write window; preconditions it
            # cannot decide locally probe through the planner (same
            # routing rule as writes). The first owner (= the read
            # owner) decides preconditions and the reported count.
            owners = (owner,)
            if t is not None:
                sl = t.slice_for(f.resource_type, f.resource_id)
                if sl is not None:
                    owners = t.write_owners(sl)
            first = owners[0]
            pcs = self._route_preconditions(list(preconditions),
                                            [first]).get(first, [])
            n = self._single(
                first, "delete_relationships",
                lambda c: c.delete_relationships(f, pcs))
            self._observe_revision(first, self._group_revision(first))
            for gi in owners[1:]:
                self._single(
                    gi, "delete_relationships",
                    lambda c: c.delete_relationships(f, []))
                self._observe_revision(gi, self._group_revision(gi))
            return n
        # global anchor or unanchored filter: every group holds matching
        # rows (replicas, or disjoint namespaced slices). Preconditions
        # bind once — on group 0, the deterministic decision shard, and
        # they are decided BEFORE any other leg deletes anything: group
        # 0's leg runs alone first, so a failed precondition aborts the
        # whole delete with every other shard untouched (concurrent
        # legs would otherwise delete while the caller is told the op
        # failed). Deletes are idempotent by construction, so a failed
        # non-decision leg is safe to re-issue (no journal needed).
        pcs0 = self._route_preconditions(list(preconditions),
                                         [0]).get(0, [])
        results = {0: self._single(
            0, "delete_relationships",
            lambda c: c.delete_relationships(f, pcs0))}
        self._observe_revision(0, self._group_revision(0))
        rest = [g for g in range(len(self.groups)) if g != 0]
        if rest:
            results.update(self._scatter(
                "delete_relationships",
                lambda gi, c: c.delete_relationships(f, []),
                shards=rest))
        for gi in rest:
            self._observe_revision(gi, self._group_revision(gi))
        if f.resource_type and f.resource_id and not namespaced:
            # replicated rows: every group deleted the SAME tuples —
            # report one copy, not n_groups copies
            return int(max(results.values()))
        # disjoint namespaced slices (plus possibly replicated global
        # rows, over-counted — documented in the loss table)
        return int(sum(results.values()))

    def _group_revision(self, gi: int):
        try:
            return self.groups[gi].revision
        except Exception:  # noqa: BLE001 - tracking is best-effort
            return None

    # -- split-write recovery ------------------------------------------------

    def recover_splits(self) -> int:
        """Replay every pending split to completion; returns how many
        entries were finished. Creates degrade to touches (idempotent
        re-application); preconditions are NOT re-checked — the split
        was already past its decision point when it journaled."""
        if self.journal is None:
            return 0
        done = 0
        known_versions = self._known_map_versions()
        for ent in self.journal.pending():
            # a dual-write window split carries BOTH versions; it is
            # valid as long as EITHER names a placement this planner
            # routes (the recorded owners are already the union), and
            # its shard indices address the extended group space
            rerouted = ((ent["map_version"] not in known_versions
                         and ent.get("map_version_to")
                         not in known_versions)
                        or any(gi >= len(self.groups)
                               for gi in ent["plan"]))
            if rerouted:
                # journaled under a DIFFERENT map (rebalance between
                # the crash and this boot, possibly with fewer groups):
                # the recorded shard indices no longer name today's
                # owners — collect every unapplied shard's ops and
                # re-plan them against the CURRENT map instead of
                # dereferencing stale indices (which would crash boot)
                log.warning(
                    "split %s journaled under map version %d (current "
                    "%d): re-routing the unapplied ops through the "
                    "current map", ent["id"], ent["map_version"],
                    self.map.version)
                ops = [WriteOp("touch" if d["op"] == "create"
                               else d["op"], _rel_from_dict(d["rel"]))
                       for gi, raw in sorted(ent["plan"].items())
                       if gi not in ent["applied"]
                       for d in raw]
                # dedupe (a global tuple appears once per old shard)
                seen = set()
                ops = [o for o in ops
                       if not (o.rel.key() in seen
                               or seen.add(o.rel.key()))]
                for gi, part in sorted(self._plan_write(ops).items()):
                    rev = self._single(
                        gi, "write_relationships",
                        lambda c, _o=part: c.write_relationships(_o,
                                                                 []))
                    self._observe_revision(gi, rev)
            else:
                for gi, raw_ops in sorted(ent["plan"].items()):
                    if gi in ent["applied"]:
                        continue
                    ops = [WriteOp("touch" if d["op"] == "create"
                                   else d["op"],
                                   _rel_from_dict(d["rel"]))
                           for d in raw_ops]
                    rev = self._single(
                        gi, "write_relationships",
                        lambda c, _o=ops: c.write_relationships(_o, []))
                    self._observe_revision(gi, rev)
                    self.journal.mark_applied(ent["id"], gi)
            self.journal.finish(ent["id"])
            done += 1
            metrics.counter("scaleout_split_replays_total").inc()
        return done

    # -- watch ---------------------------------------------------------------

    def watch_since(self, revision) -> list:
        """Events after a VECTOR resumption token (translated through
        recorded map transitions when minted under an older map),
        merged shard-by-shard with monotone vector stamps. Moving-slice
        events pass the rebalance delivery filter: read-owner-only, so
        the replay is gap- and duplicate-free across a cutover."""
        vec = self._resolve_token(revision)
        results = self._scatter(
            "watch_since",
            lambda gi, c: c.watch_since(int(vec[gi])))
        with tracer.span("shard_merge", op="watch_since"):
            out = []
            cur = vec
            for gi in sorted(results):
                for e in results[gi]:
                    # the stamp always advances past the record — a
                    # suppressed mover echo must move the resumption
                    # token forward, never be re-delivered
                    cur = cur.bump(gi, e.revision)
                    if self._deliver_event(gi, e.relationship,
                                           e.revision):
                        out.append(WatchEvent(cur, e.operation,
                                              e.relationship))
        return out

    def watch_push_stream(self, from_revision) -> ShardedWatchStream:
        return ShardedWatchStream(self,
                                  self._resolve_token(from_revision))

    def watch_gate(self, resource_type: str, name: str):
        """Schema-derived, identical on every group: ask the anchor
        shard of the named object."""
        gi = self.map.anchor_shard(resource_type, name or "")
        return self._single(gi, "watch_gate",
                            lambda c: c.watch_gate(resource_type, name))

    # -- status / lifecycle --------------------------------------------------

    STATUS_PROBE_TIMEOUT = 1.5

    def sharding_status(self) -> dict:
        """Per-group role/lag + map version for ``/readyz``'s
        ``sharding:`` info line — a degraded group is visible BEFORE it
        sheds. Probes fan out on the scatter pool with a SHORT bound:
        sequential per-group connect timeouts would stall the readiness
        probe past a kubelet's budget and unready the replica — the
        exact outcome the informational line exists to avoid."""
        def probe(c):
            if hasattr(c, "replication_status"):
                return c.replication_status() or {}
            if hasattr(c, "failover_state"):
                return c.failover_state() or {}
            return {"role": "local", "lag": 0}

        futs = [self._pool.submit(probe, c) for c in self.groups]
        groups = []
        for gi, f in enumerate(futs):
            try:
                st = f.result(timeout=self.STATUS_PROBE_TIMEOUT)
            except Exception:  # noqa: BLE001 - status is best-effort
                st = {"role": "unreachable", "lag": None}
            groups.append({"group": gi, "role": st.get("role"),
                           "term": st.get("term"),
                           "lag": st.get("lag")})
        return {
            "version": self.map.version,
            "groups": groups,
            "vector": self.vector.encode(
                map_version=self.map.version),
            "pending_splits": (self.journal.pending_count()
                               if self.journal is not None else 0),
            # the live tuple mover's progress, or None outside a
            # transition window (/readyz renders it as
            # `rebalance: moving=K copied=J lag=...`)
            "rebalance": self.rebalance_status(),
            # the coordinated schema migration's progress, or None
            # (/readyz renders it as `migration: phase=... lag=...`)
            "migration": self.migration_status(),
        }

    def fetch_traces(self, limit: int = 64) -> list:
        out: list = []
        for c in self.groups:
            try:
                if hasattr(c, "fetch_traces"):
                    out.extend(c.fetch_traces(limit))
            except Exception:  # noqa: BLE001 - diagnostics best-effort
                continue
        return out

    def close(self, close_journal: bool = True) -> None:
        """``close_journal=False`` leaves a SHARED journal open (e.g. a
        crashed planner's journal that a successor will replay)."""
        if self._coordinator is not None:
            # park the mover; its persisted state resumes or aborts by
            # the crash matrix at the next boot
            self._coordinator.stop()
        self._pool.shutdown(wait=False, cancel_futures=True)
        for c in list(self.groups) + list(self._retired_clients):
            try:
                if hasattr(c, "close"):
                    c.close()
            except Exception:  # noqa: BLE001 - teardown best effort
                pass
        if close_journal and self.journal is not None:
            self.journal.close()
