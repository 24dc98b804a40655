"""The query engine: CheckBulkPermissions and LookupResources on the GPU.

Counterpart of the JAX package's ``engine/engine.py``, cut to the slices
ported so far: a store with its watch log, the write path (each write
folded into the compiled graph's delta overlay in O(write), with a full
recompile only when the overlay cannot express it, and the optional
background compactor of engine/compaction.py), chunked bulk checks and
list-filter masks through the reachability fixpoint
(ops/reachability.py) under a request caveat context (caveats/), and
the push/pull crossover feedback, and the serving front in front of
the fixpoint: the revision-keyed decision cache with singleflight
(engine/decision_cache.py) and the cross-request lookup batcher
(engine/batcher.py); durability (``enable_persistence``: recovery, the
write-ahead log and checkpoints of persistence/, and the snapshot
save/load of the store), tiered block residency under a device byte
budget (``device_graph_budget_bytes``: storage/ and the tiered dispatch
of ops/reachability.py), and live schema migration
(``begin_schema_migration``: migration/), and the device mesh
(``mesh=``: every query through a parallel/sharded.py ``ShardedGraph``).
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..caveats.ast import (
    CaveatError,
    StringInterner,
    UnencodableListError,
    encode_list,
    encode_scalar,
)
from ..device import resolve_device
from ..models.bootstrap import DEFAULT_BOOTSTRAP, parse_bootstrap
from ..models.schema import (
    Arrow,
    Exclude,
    Intersect,
    Nil,
    RelationRef,
    Schema,
    Union,
    watch_relevance,
)
from ..models.tuples import Relationship, canonical_context
from ..obs.profile import install_kernel_build_hook
from ..obs.trace import tracer
from ..ops import semiring
from ..ops.reachability import (
    DELTA_CAPACITY,
    MAX_DELTA_RECORDS,
    VOID_IDX,
    CompiledGraph,
    _fallback,
    compile_graph,
    incremental_update,
    release_resident,
    retire_base,
)
from ..utils.features import features
from ..utils.metrics import metrics
from .compaction import Compactor, validate_overlay_config
from .decision_cache import MISS, DecisionCache, check_key, lookup_key
from .evaluator import OracleEvaluator
from .store import (
    OP_DELETE,
    Precondition,
    RelationshipFilter,
    Store,
    StoreError,
    WriteOp,
    caveat_pairs,
)

# host query arrays of mask lookups kept for reuse, at most (bytes): the
# compositions of a list mix, 8 rows of a 100,000-object type 6.4 MB each
Q_HOST_BYTES = 64 << 20


class SchemaViolation(StoreError):
    pass


@dataclass(frozen=True)
class WatchEvent:
    revision: int
    operation: str  # "touch" | "delete"
    relationship: Relationship


@dataclass(frozen=True)
class CheckItem:
    resource_type: str
    resource_id: str
    permission: str
    subject_type: str
    subject_id: str
    subject_relation: Optional[str] = None


def context_digest(context) -> Optional[str]:
    """Stable digest of a request caveat-context dict, appended to
    decision-cache keys so conditional verdicts never leak across
    contexts. ``None`` for no or an empty context: context-free queries
    keep their cache keys."""
    if not context:
        return None
    try:
        blob = json.dumps(context, sort_keys=True,
                          separators=(",", ":"), default=str)
    except (TypeError, ValueError):
        blob = repr(sorted((str(k), str(v)) for k, v in context.items()))
    return hashlib.sha1(blob.encode()).hexdigest()


def mask_to_ids(mask, interner) -> list:
    """Allowed id strings from a lookup mask (padding indices guarded)."""
    if mask is None:
        return []
    return [interner.string(i) for i in np.flatnonzero(mask).tolist()
            if i < len(interner)]


def mask_pseudo_objects(mask: np.ndarray) -> np.ndarray:
    """Clear the reserved per-type indices (0 = void, 1 = wildcard '*')."""
    mask[0] = False
    mask[1] = False
    return mask


def validate_caveat(schema: Schema, rel: Relationship) -> None:
    """A caveated write must name a DECLARED caveat and carry a context
    that encodes under the declared parameter types: a malformed context
    stored now would become missing-context denials (or a compile-time
    error) at read time."""
    cdef = (schema.caveat_defs or {}).get(rel.caveat)
    if cdef is None:
        raise SchemaViolation(
            f"relationship names undeclared caveat {rel.caveat!r}")
    if not rel.caveat_context:
        return
    try:
        ctx = rel.context_dict()
    except ValueError as e:
        raise SchemaViolation(
            f"caveat {rel.caveat!r}: invalid context: {e}") from None
    scratch = StringInterner()
    for k, v in (ctx or {}).items():
        p = cdef.param(k)
        if p is None:
            raise SchemaViolation(
                f"caveat {rel.caveat!r} has no parameter {k!r}")
        try:
            if p.type.is_list:
                encode_list(v, p.type.elem, scratch)
            else:
                encode_scalar(v, p.type.name, scratch)
        except UnencodableListError:
            # well-typed but beyond the VM's list tables (an IPv6
            # element): the write is accepted and the parameter resolves
            # UNKNOWN at evaluation (fail closed, counted)
            pass
        except CaveatError as e:
            raise SchemaViolation(
                f"caveat {rel.caveat!r} context {k!r}: {e}") from None


def validate_relationship(schema: Schema, rel: Relationship) -> None:
    """Schema admission for one relationship tuple (the write path's
    gate)."""
    if getattr(rel, "caveat", None):
        validate_caveat(schema, rel)
    d = schema.definitions.get(rel.resource_type)
    if d is None:
        raise SchemaViolation(f"unknown resource type {rel.resource_type!r}")
    if rel.resource_id == "*":
        raise SchemaViolation("resource id may not be the wildcard '*'")
    r = d.relations.get(rel.relation)
    if r is None:
        raise SchemaViolation(
            f"{rel.resource_type} has no relation {rel.relation!r}"
            + (" (permissions are not writable)"
               if rel.relation in d.permissions else ""))
    if schema.definitions.get(rel.subject_type) is None:
        raise SchemaViolation(f"unknown subject type {rel.subject_type!r}")
    ok = False
    expiration_blocked = False
    caveat_blocked = False
    for a in r.allowed:
        if a.type != rel.subject_type:
            continue
        if rel.subject_id == "*":
            if not a.wildcard:
                continue
        elif a.wildcard or (a.relation or None) != rel.subject_relation:
            continue
        if (a.caveat or None) != (rel.caveat or None):
            # SpiceDB matches the caveat trait exactly: a caveated tuple
            # needs a `with <caveat>` entry, and an entry REQUIRING a
            # caveat never accepts an unconditional tuple; another entry
            # of the same subject type may still match
            # (`user | user with ip_allowlist`)
            caveat_blocked = True
            continue
        if rel.expiration is not None and not a.expiration:
            # another entry of the same subject type may allow expiration
            expiration_blocked = True
            continue
        ok = True
        break
    if not ok and expiration_blocked:
        raise SchemaViolation(
            f"{rel.resource_type}#{rel.relation} does not allow "
            "expiring relationships")
    if not ok and caveat_blocked:
        raise SchemaViolation(
            f"{rel.resource_type}#{rel.relation} does not allow "
            + (f"subjects with caveat {rel.caveat!r}" if rel.caveat
               else "uncaveated subjects of this type"))
    if not ok:
        raise SchemaViolation(
            f"subject {rel.subject_type}"
            + (f"#{rel.subject_relation}" if rel.subject_relation else "")
            + f" not allowed on {rel.resource_type}#{rel.relation}")
    if rel.subject_relation and not schema.definitions[
            rel.subject_type].relation_or_permission(rel.subject_relation):
        raise SchemaViolation(
            f"{rel.subject_type} has no relation {rel.subject_relation!r}")


class EngineFuture:
    """A dispatched engine query: ``result()`` post-processes the fixpoint
    future(s); ``iterations()`` is valid after ``result()``."""

    __slots__ = ("_fut", "_fin", "_iters")

    def __init__(self, fut, fin, iters=None):
        self._fut = fut
        self._fin = fin
        self._iters = iters

    def result(self):
        with tracer.span("engine.result"):
            return self._fin(None if self._fut is None
                             else self._fut.result())

    def iterations(self) -> int:
        if self._iters is not None:
            return self._iters()
        return 0 if self._fut is None else self._fut.iterations()


def subject_candidates(schema: Schema, store, resource_type: str,
                       resource_id: str, permission: str,
                       subject_type: str,
                       subject_relation: Optional[str] = None
                       ) -> Optional[set]:
    """The ids of ``subject_type`` (``#subject_relation``) subjects whose
    tuples the schema can lead from ``resource_type:resource_id`` to
    ``permission``: relations, arrows and usersets walked over the live
    tuples, expired and caveated ones included, every operand of an
    intersection or an exclusion taken. A superset of the subjects that
    hold the permission, found one layer of the walk at a time
    (``Store.rows_of``, one pass over the columns a type). None when a
    ``subject_type:*`` tuple is on the way, or when a permission holds an
    expression this walk does not know: every known subject may hold it
    then. With a ``subject_relation``, an object the walk reaches through
    that relation is itself a candidate, whether or not any tuple names
    it as a subject."""
    want_rel = subject_relation or ""
    out: set = set()
    seen: set = set()
    todo = [(resource_type, resource_id, permission)]
    while todo:
        rels: dict = {}  # type -> {relation: {object ids}}
        for t, oid, name in todo:
            if (t, oid, name) in seen:
                continue
            seen.add((t, oid, name))
            if want_rel and t == subject_type and name == want_rel:
                out.add(oid)  # the userset itself is on the way
            d = schema.definitions.get(t)
            if d is None:
                continue
            if name in d.relations:
                rels.setdefault(t, {}).setdefault(name, set()).add(oid)
                continue
            perm = d.permissions.get(name)
            stack = [perm.expr] if perm is not None else []
            while stack:
                e = stack.pop()
                if isinstance(e, RelationRef):
                    todo.append((t, oid, e.name))
                elif isinstance(e, Arrow):
                    rels.setdefault(t, {}).setdefault(
                        ("->", e.tupleset, e.target), set()).add(oid)
                elif isinstance(e, (Union, Intersect)):
                    stack.extend(e.operands)
                elif isinstance(e, Exclude):
                    stack.extend((e.base, e.subtract))
                elif not isinstance(e, Nil):
                    return None
        todo = []
        for t, by_rel in rels.items():
            plain = {r for r in by_rel if isinstance(r, str)}
            arrows = {r[1] for r in by_rel if not isinstance(r, str)}
            ids = set().union(*by_rel.values())
            for rid, rl, st, sid, srl in store.rows_of(t, ids,
                                                      plain | arrows):
                if rl in plain and rid in by_rel[rl]:
                    if sid == "*":
                        if st == subject_type and not want_rel:
                            return None
                    elif st == subject_type and srl == want_rel:
                        out.add(sid)
                    if srl and sid != "*":
                        todo.append((st, sid, srl))
                if rl in arrows and sid != "*":
                    for key, objs in by_rel.items():
                        if not isinstance(key, str) and key[1] == rl \
                                and rid in objs:
                            todo.append((st, sid, key[2]))
                            if srl:
                                todo.append((st, sid, srl))
    return out


class Engine:
    """In-process relationship-graph engine on one device: ``cuda`` by
    default, the CPU only when ``device="cpu"`` is passed; with ``mesh``
    (parallel/mesh.py ``make_mesh``) its queries run over the mesh's
    cells instead."""

    # bulk checks dispatch in chunks of this many items
    CHECK_PIPELINE_CHUNK = 16384
    # the fixpoint's state holds a row of M slots for every distinct
    # subject of a dispatch: a chunk whose subjects need more row-slots
    # than this is split by subject (one lookup_subjects of 4,096
    # candidates over the 10M headline asked for 40 GiB at once; this
    # bound is ~1 GiB there); the JAX package dispatches the whole chunk
    CHECK_MAX_ROW_SLOTS = 1 << 26

    def __init__(self, bootstrap: Optional[str] = None,
                 schema: Optional[Schema] = None,
                 validate_writes: bool = True, device=None,
                 delta_capacity: int = DELTA_CAPACITY,
                 device_graph_budget_bytes: Optional[int] = None,
                 tier_spill_dir: Optional[str] = None, mesh=None):
        self.device = resolve_device(device)
        validate_overlay_config(delta_capacity)
        if schema is None:
            b = parse_bootstrap(bootstrap or DEFAULT_BOOTSTRAP)
            schema, seed = b.schema, b.relationships
        else:
            seed = []
        self.schema = schema
        self.store = Store()
        self.validate_writes = validate_writes
        self._lock = threading.RLock()
        # the newest view published to readers (its device state applied)
        # and the newest committed on the host, whose device patches may
        # still be queued: the revisions between the two are writes whose
        # callers have not returned yet
        self._compiled: Optional[CompiledGraph] = None
        self._head: Optional[CompiledGraph] = None
        # delta-overlay slots of every graph this engine compiles, and the
        # optional background compactor that folds the overlay into a
        # fresh base off the write path
        self._delta_capacity = int(delta_capacity)
        self._compactor = None
        # (base revision, store revision) pair the incremental path
        # declined at write time: the read path must not retry (and
        # re-count) the identical suffix; any further write resets it
        self._incremental_declined: Optional[tuple] = None
        # row composition -> host (q_slots, q_batch) of a mask lookup
        self._q_host: dict[tuple, tuple] = {}
        self._q_host_bytes = 0
        self._q_host_lock = threading.Lock()
        # frontier-occupancy EWMA feeding the push/pull crossover
        self._occ_ewma: Optional[float] = None
        # optional ("data", "graph") mesh of cells: queries route through
        # a ShardedGraph pinned across it instead of one device
        self.mesh = mesh
        self._sharded = None
        # the serving front, both off until enabled: the lookup batcher
        # and the decision cache in front of it
        self._batcher = None
        self._decision_cache: Optional[DecisionCache] = None
        self._persistence = None  # persistence/manager.py, opt-in
        # tiered block residency (storage/): with a budget, every graph
        # this engine compiles keeps its dense blocks in a host-cold arena
        # and streams the ones a dispatch demands onto the device, holding
        # them hot while the budget allows; 0/None = all resident
        self._tier_budget = int(device_graph_budget_bytes or 0)
        self._tier_spill_dir = tier_spill_dir
        # bumped by every restore and every schema cut: a compaction fold
        # compiled from the store, or under the schema, before either must
        # not publish after it
        self._lineage = 0
        # live schema migration (migration/migrator.py): the active
        # SchemaMigrator, the write gate it installs for the cutover's
        # freeze, and the backfill-echo revisions watch streams suppress
        # (a journaled backfill TOUCH of identical content still logs a
        # watch record; replaying it to watchers would break exactly-once
        # across the cut)
        self._migrator = None
        self._write_gate = None
        self._watch_suppress: frozenset = frozenset()
        # held by the backfill from before its write until its echo
        # revision is armed, and taken by every watch read after it
        # fetched its records: a watcher that sees the echo also sees it
        # suppressed (the reference arms it after the write returns, so a
        # push stream woken in between delivers the echo)
        self._echo_lock = threading.Lock()
        # a kernel or native-helper build is the first query's cliff and
        # one event the dispatch path cannot time itself: the listener
        # counts each build into the metrics registry (obs/profile)
        install_kernel_build_hook()
        if seed:
            self.write_relationships([WriteOp("touch", r) for r in seed])

    def enable_lookup_batching(self, window: float = 0.002,
                               max_rows: int = 8) -> None:
        """Coalesce concurrent lookup_resources_mask calls into fused
        device dispatches (engine/batcher.py): up to ``window`` seconds of
        added latency for one dispatch per ``max_rows`` concurrent list
        filters."""
        from .batcher import LookupBatcher

        self._batcher = LookupBatcher(self, window=window, max_rows=max_rows)

    def disable_lookup_batching(self) -> None:
        """Back to one dispatch a lookup. The retired batcher is closed:
        its pending batch flushes, and a racing submit that still holds
        it falls through to the direct path."""
        b, self._batcher = self._batcher, None
        if b is not None:
            b.close()

    def enable_decision_cache(self, max_entries: int = 65536,
                              max_mask_bytes: int = 256 << 20) -> None:
        """Serve repeat queries at an unchanged revision from a
        revision-keyed LRU instead of dispatching, and coalesce concurrent
        identical misses into one dispatch (engine/decision_cache.py).
        Writes move the revision (new keys), expiring tuples and caveat
        time bounds cap every entry's life, and explicit-``now`` queries
        bypass the cache."""
        self._decision_cache = DecisionCache(max_entries=max_entries,
                                             max_mask_bytes=max_mask_bytes)

    def disable_decision_cache(self) -> None:
        """Drop the cache (gauges zeroed); fills in flight resolve but are
        no longer consulted."""
        c, self._decision_cache = self._decision_cache, None
        if c is not None:
            c.clear()

    def enable_compaction(self, threshold: float = 0.75):
        """Start the background overlay compactor (engine/compaction.py):
        a worker thread folds the delta tail into a fresh compiled base
        off the write path and swaps it in at a recorded revision, and a
        write the overlay cannot absorb sheds with a bounded Retry-After
        (:class:`~.compaction.OverlayBackpressure`) instead of forcing a
        synchronous recompile onto the next read. ``threshold`` is the
        occupancy fraction that wakes the worker."""
        with self._lock:
            if self._compactor is not None:
                raise RuntimeError("compaction is already enabled")
            self._compactor = Compactor(self, threshold)
        return self._compactor

    def close_compaction(self, drain: bool = False) -> None:
        """Stop the compactor (``drain=True`` folds once more first);
        writes stop shedding and overlay overflow reverts to the
        synchronous-recompile fallback."""
        with self._lock:
            c, self._compactor = self._compactor, None
        if c is not None:
            c.close(drain=drain)

    @property
    def compactor(self):
        return self._compactor

    def max_write_records(self) -> Optional[int]:
        """The most records one write may carry while the compactor's
        back-pressure is on (what an empty overlay absorbs), else None."""
        c = self._compactor
        return None if c is None else c.max_write_records(self._head)

    # -- durability ---------------------------------------------------------

    def enable_persistence(self, data_dir: str, **kw):
        """Make the store durable under ``data_dir``: recover what a
        previous process left there (newest valid snapshot + WAL tail,
        persistence/recovery.py), then journal every later mutation
        through the write-ahead log with background checkpoints. Returns
        the :class:`~..persistence.Persistence` manager (``.recovery``
        says what was restored); keyword arguments pass through to
        ``Persistence.open`` (``wal_fsync``, checkpoint thresholds...)."""
        from ..persistence import Persistence

        with self._lock:
            if self._persistence is not None:
                raise RuntimeError("persistence is already enabled")
            self._flush_batcher()
            before = (self.store.epoch, self.store.revision)
            try:
                p = Persistence.open(self.store, data_dir, **kw)
            finally:
                # recovery that changed the store (also one that failed
                # part way) replaced what the views were compiled from; an
                # empty data dir changes nothing, and the views stay
                if (self.store.epoch, self.store.revision) != before:
                    self._restored()
            self._persistence = p
        return p

    def close_persistence(self, final_checkpoint: bool = True) -> None:
        """Shut the durability layer down (fsync, and by default a final
        checkpoint so the next boot replays nothing)."""
        with self._lock:
            p, self._persistence = self._persistence, None
        if p is not None:
            p.close(final_checkpoint=final_checkpoint)

    @property
    def persistence(self):
        return self._persistence

    def save_snapshot(self, path: str) -> None:
        """Persist the store (compacted, atomic): a restored engine skips
        the bulk re-load."""
        self.store.save(path)

    def load_snapshot(self, path: str) -> None:
        with self._lock:
            if self._persistence is not None:
                # a file restore bypasses the journal: the WAL would replay
                # over the wrong lineage on the next boot
                raise StoreError(
                    "load_snapshot is incompatible with an enabled "
                    "persistence data dir (recovery owns restores)")
            self._flush_batcher()
            self.store.load(path)
            self._restored()

    def load_snapshot_if_exists(self, path: Optional[str]) -> bool:
        """Boot-time restore: load when the file exists, and say whether
        it did."""
        if not path or not os.path.exists(path):
            return False
        self.load_snapshot(path)
        return True

    def _flush_batcher(self) -> None:
        """Dispatch the lookup batcher's open window now, before a restore
        replaces the store: its lookups were submitted against the old
        contents (caller holds the engine lock)."""
        b = self._batcher
        if b is not None:
            b.flush()

    def _restored(self) -> None:
        """Reset everything keyed on the replaced store's revisions
        (caller holds the engine lock, the batcher's window flushed before
        the store changed). A restore can land on a revision number the
        old lineage also had, with other rows, so: the published and head
        views go (the next read compiles the restored store), the old
        base's device state is freed, and the decision cache is replaced
        by an empty one (the old one is closed, so a fill still in flight
        from the old lineage lands nowhere)."""
        old = self._head
        self._compiled = self._head = None
        self._incremental_declined = None
        self._lineage += 1
        if old is not None:
            release_resident(old)
        sg, self._sharded = self._sharded, None
        if sg is not None:
            sg.release()
        cache = self._decision_cache
        if cache is not None:
            cache.clear()
            self._decision_cache = DecisionCache(
                max_entries=cache.max_entries,
                max_mask_bytes=cache.max_mask_bytes)

    # -- write path ---------------------------------------------------------

    def write_relationships(self, ops: list[WriteOp],
                            preconditions: list[Precondition] = (),
                            *, _headroom: bool = True) -> int:
        """Apply a write and fold it into the compiled graph's overlay.
        ``_headroom=False`` skips the compactor's shed check (a migration
        backfill's last retry)."""
        if self.validate_writes:
            for op in ops:
                validate_relationship(self.schema, op.rel)
        if _headroom:
            self._write_headroom(len(ops))
        with self._gated():
            with self._lock:
                rev = self.store.write(list(ops), list(preconditions))
                cg = self._advance_incremental()
            self._apply_and_publish(cg)
        return rev

    def delete_relationships(self, f: RelationshipFilter,
                             preconditions: list[Precondition] = (),
                             *, _headroom: bool = True) -> int:
        """DeleteRelationships by filter; returns the count deleted."""
        # the filter's cardinality is unknown before the scan: charge one
        # record's headroom (a huge filter delete that overflows still
        # falls back to a counted recompile, it is just not shed first)
        if _headroom:
            self._write_headroom(1)
        with self._gated():
            with self._lock:
                n = self.store.delete_by_filter(f, list(preconditions))
                cg = self._advance_incremental()
            self._apply_and_publish(cg)
        return n

    @contextmanager
    def _gated(self):
        """Hold a migration's write gate (when one is installed) across
        the whole write, its device half included: once the cutover's
        freeze returns, every write it admitted has been acknowledged, and
        none is applied to the old base after the cut."""
        gate = self._write_gate
        if gate is None:
            yield
            return
        gate.enter()
        try:
            yield
        finally:
            gate.exit()

    def _write_headroom(self, n_records: int) -> None:
        """Back-pressure before any store mutation: with the compactor on
        and an overlay that cannot absorb the write, shed it
        (:class:`~.compaction.OverlayBackpressure`) rather than let the
        next read pay a synchronous recompile."""
        c = self._compactor
        if c is not None:
            c.check_headroom(self._head, n_records)

    def _advance_incremental(self) -> Optional[CompiledGraph]:
        """Commit the write just applied to the store into the compiled
        graph's overlay on the host (an O(write) append; the caller holds
        the engine lock, so no read folds it first). Never compiles: a
        decline is counted, remembered, and left to the read path's
        recompile or the compactor. Returns the view to publish once its
        device patch is applied, or None."""
        head = self._head
        if head is None:
            return None
        if head.revision == self.store.revision:
            return head
        inc = self._advance(head)
        if inc is None:
            self._incremental_declined = (head.revision,
                                          self.store.revision)
            if self._compactor is not None:
                self._compactor.request()
        return inc

    def _apply_and_publish(self, cg: Optional[CompiledGraph]) -> None:
        """The device half of a write, outside the engine lock: apply the
        queued patches (this waits for the queries on the device state to
        leave, and reads go on meanwhile against the published view),
        then publish. The write returns only after this, so a read that
        starts after it sees the write."""
        if cg is None:
            return
        cg.resident.flush(cg.patch_seq)
        with self._lock:
            # a recompile or a compaction fold may have published a newer
            # base meanwhile, which holds this write already
            cur = self._compiled
            if cur is None or cg.revision > cur.revision:
                self._publish(cg)

    def read_relationships(self, f: RelationshipFilter) -> list:
        return self.store.read(f)

    def bulk_load(self, rels_cols: dict) -> int:
        got = caveat_pairs(rels_cols) if self.validate_writes else None
        if got is not None:
            # validate the DISTINCT (caveat, context) pairs before any
            # store mutation: an undeclared name or a mistyped context
            # interned here would not fail until the next compile_graph,
            # bricking every later query instead of rejecting one load
            for nm, cx in got[0]:
                if nm:
                    validate_caveat(self.schema, Relationship(
                        "", "", "", "", "", None, None, nm,
                        canonical_context(cx)))
        return self.store.bulk_load(rels_cols)

    @property
    def revision(self) -> int:
        return self.store.revision

    # -- watch --------------------------------------------------------------

    def watch_since(self, revision: int) -> list[WatchEvent]:
        """Watch events past ``revision``, migration-backfill echoes
        left out."""
        return self._events(self.store.watch_since(revision))

    def wait_events(self, revision: int, timeout: float) -> list[WatchEvent]:
        """Block until events past ``revision`` land (or ``timeout`` —
        then ``[]``): the push-latency form of :meth:`watch_since`.
        Migration-backfill echoes are left out, and a batch of echoes only
        keeps the wait going past them (the reference returns ``[]`` at
        once there, and its push loop asks again at once until the next
        real write)."""
        deadline = time.monotonic() + timeout
        while True:
            recs = self.store.wait_since(
                revision, max(deadline - time.monotonic(), 0.0))
            out = self._events(recs)
            if out or not recs or time.monotonic() >= deadline:
                return out
            revision = recs[-1].revision

    def _events(self, records) -> list[WatchEvent]:
        with self._echo_lock:
            sup = self._watch_suppress
        return [WatchEvent(r.revision,
                           "delete" if r.op == OP_DELETE else "touch", r.rel)
                for r in records if r.revision not in sup]

    # -- query path ---------------------------------------------------------

    def _objects_by_name(self) -> dict:
        with self.store._lock:
            return {self.store.types.string(tid): it
                    for tid, it in self.store.objects.items()}

    def _publish_graph_gauges(self, cg: CompiledGraph) -> None:
        metrics.gauge("engine_csr_nnz").set(cg.n_edges)
        metrics.gauge("engine_graph_slots").set(cg.M)
        metrics.gauge("engine_delta_occupancy").set(cg.n_delta)
        if cg.tier is not None:
            cg.tier.publish_gauges()

    def compiled(self) -> CompiledGraph:
        """Fully-consistent snapshot: every acknowledged write is in it.
        The revisions past the published view that the host has committed
        belong to writes still applying their device patches (not
        acknowledged), so the published view stands. Any other stale
        revision (a bulk load, a declined write) is brought current by an
        O(delta) incremental update or, when that declines, a full
        recompile."""
        with self._lock:
            cur, head = self._compiled, self._head
            rev = self.store.revision
            if cur is not None and head.revision == rev:
                return cur
            if cur is not None and (head.revision, rev) \
                    != self._incremental_declined:
                inc = self._advance(head)
                if inc is not None:
                    # no writer applies this patch: apply it here
                    inc.resident.flush(inc.patch_seq)
                    self._publish(inc)
                    return inc
            fresh = self._compile_fresh()
            self._head = fresh
            self._publish(fresh)
            return fresh

    def _compile_fresh(self, schema: Optional[Schema] = None
                       ) -> CompiledGraph:
        """One full compile from the current store snapshot: the serving
        path's fallback (under the engine lock), the compactor's fold and,
        under the target ``schema``, a migration's dual compile (both off
        the lock: the old base keeps serving). Every compiled base gets the
        engine's device, overlay capacity and tier budget."""
        t0 = time.perf_counter()
        cg = compile_graph(schema or self.schema, self.store.snapshot(),
                           device=self.device,
                           delta_capacity=self._delta_capacity)
        if self._tier_budget:
            # each compiled base gets a fresh TierStore: residency and
            # overlay pins start clean ("pinned until folded")
            cg.enable_tiering(self._tier_budget,
                              spill_dir=self._tier_spill_dir)
        metrics.counter("engine_graph_compiles_total").inc()
        metrics.histogram("engine_graph_compile_seconds").observe(
            time.perf_counter() - t0)
        return cg

    def _advance(self, head: CompiledGraph) -> Optional[CompiledGraph]:
        """Bring the host-committed ``head`` current by one incremental
        update, its device patch queued, and make it the new head (caller
        holds the engine lock). None when the update declines: the write
        side remembers the decline, the read side recompiles."""
        inc = self._try_incremental(head)
        if inc is not None:
            self._head = inc
        return inc

    def _publish(self, cg: CompiledGraph) -> None:
        """Serve ``cg`` to readers (its device state applied; caller holds
        the engine lock)."""
        self._compiled = cg
        self._publish_graph_gauges(cg)
        c = self._compactor
        if c is not None:
            c.notify(cg)

    def _install_schema(self, schema: Schema,
                        cg: Optional[CompiledGraph],
                        affected: Optional[frozenset] = None) -> None:
        """Serve ``schema`` from now on, at the unchanged revision: a
        migration's cut, or its resolution at boot (caller holds the
        engine lock). ``cg``, the new schema's graph caught up to the
        store, becomes the head and the published view; None leaves the
        next read to compile under ``schema``. The old base stops serving:
        its device state goes when its last view does, as after a
        compaction fold (queries still dispatching on it finish, none
        fails), its TierStore's prefetch workers with it; the lineage
        moves, so a fold compiled under the old schema never publishes.
        Decision-cache entries of the ``affected`` pairs are retired (their
        in-flight fills with them); with no ``affected`` set, all are."""
        old = self._head
        self.schema = schema
        self._head = cg
        self._compiled = None
        self._incremental_declined = None
        self._lineage += 1
        if cg is not None:
            self._publish(cg)
        if old is not None:
            retire_base(old)
        cache = self._decision_cache
        if cache is not None:
            if affected is None:
                cache.clear()
                self._decision_cache = DecisionCache(
                    max_entries=cache.max_entries,
                    max_mask_bytes=cache.max_mask_bytes)
            else:
                cache.retire_affected(affected)

    def _replay_onto(self, fresh: CompiledGraph
                     ) -> Optional[CompiledGraph]:
        """Bring a freshly compiled base current with the watch records
        that landed after its snapshot (the compactor's catch-up, under
        the engine lock). ``fresh`` itself when nothing landed, None when
        the suffix cannot be replayed (trimmed history, a bulk load,
        overflow): the caller folds again from a newer snapshot."""
        st = self.store
        with st._lock:
            if fresh.revision < st.unlogged_revision:
                return None
            try:
                records = st.watch_since(fresh.revision)
            except StoreError:
                return None
            rev = st.revision
        if not records:
            return fresh
        if len(records) > MAX_DELTA_RECORDS:
            return None
        delta = [(r.op == OP_DELETE, r.rel) for r in records]
        return incremental_update(fresh, delta, rev, st)

    def _try_incremental(self, cur: CompiledGraph
                         ) -> Optional[CompiledGraph]:
        if not features.enabled("IncrementalGraphUpdates"):
            return None
        st = self.store
        with st._lock:
            if cur.revision < st.unlogged_revision:
                # bulk-loaded changes are not in the watch log
                _fallback("unlogged")
                return None
            try:
                records = st.watch_since(cur.revision)
            except StoreError:
                _fallback("history-trimmed")
                return None
            rev = st.revision
        if len(records) > MAX_DELTA_RECORDS:
            _fallback("overflow")
            return None
        t0 = time.perf_counter()
        delta = [(r.op == OP_DELETE, r.rel) for r in records]
        # the device patch is left queued: the writer applies it outside
        # the engine lock (_apply_and_publish)
        new = incremental_update(cur, delta, rev, st, sync_device=False)
        if new is not None:
            metrics.counter("engine_graph_incremental_updates_total").inc()
            metrics.histogram("engine_graph_incremental_seconds").observe(
                time.perf_counter() - t0)
        return new

    def _backend(self, cg: CompiledGraph):
        """The query executor for a compiled graph: the graph itself (one
        device) or a ShardedGraph pinned across the mesh, brought to the
        graph's revision whenever it changes. Both expose the same
        ``query_async`` and ``shared_state`` surface."""
        if self.mesh is None:
            return cg
        t = cg.tier
        if t is not None and t.total_bytes() > t.budget_bytes:
            # beyond-budget tiered graph: the mesh pins every block
            # resident, so a graph that cannot fit takes the
            # single-device demand-streaming path, counted so a mesh
            # deployment sees why its mesh idles
            metrics.counter("engine_tier_mesh_fallback_total").inc()
            return cg
        from ..parallel.sharded import ShardedGraph

        if ShardedGraph.unsupported_reason(cg) is not None:
            # caveated graphs without per-edge caveat rows (hand-built
            # layouts) stay on the single-device path, counted
            metrics.counter("engine_caveat_mesh_fallback_total").inc()
            return cg
        with self._lock:
            sg = self._sharded
            if sg is None or sg.cg is not cg:
                t0 = time.perf_counter()
                if sg is None:
                    sg = ShardedGraph(cg, self.mesh)
                    metrics.counter("engine_sharded_builds_total").inc()
                else:
                    # another revision: the shared mesh state syncs in
                    # O(write), or rebuilds when the layout changed
                    sg = sg.updated(cg)
                    metrics.counter("engine_sharded_updates_total").inc()
                metrics.histogram("engine_sharded_build_seconds").observe(
                    time.perf_counter() - t0)
                self._sharded = sg
            return sg

    def _encode_checks(self, cg, objs, items):
        """Single-pass check-batch encode with per-(type, permission) and
        per-type caches inlined; same semantics as ``encode_target`` /
        ``encode_subject``."""
        n = len(items)
        M = cg.M
        q_slots = np.empty(n, dtype=np.int32)
        q_batch = np.empty(n, dtype=np.int32)
        tp_off: dict[tuple, int] = {}
        ti: dict[str, tuple] = {}
        subjects: dict[tuple, int] = {}
        seed_rows: list[tuple[int, int]] = []
        for i, it in enumerate(items):
            t = it.resource_type
            key = (t, it.permission)
            off = tp_off.get(key)
            if off is None:
                o = cg.offset_of(t, it.permission)
                off = tp_off[key] = -1 if o is None else o
            if off < 0:
                q_slots[i] = M
            else:
                ent = ti.get(t)
                if ent is None:
                    interner = objs.get(t)
                    ent = ti[t] = (interner.id_map() if interner is not None
                                   else None, cg.type_sizes.get(t, 0))
                to_id, size = ent
                if to_id is None:
                    q_slots[i] = off + VOID_IDX
                else:
                    oi = to_id.get(it.resource_id)
                    q_slots[i] = off + (
                        oi if oi is not None and oi < size else VOID_IDX)
            skey = (it.subject_type, it.subject_id, it.subject_relation)
            row = subjects.get(skey)
            if row is None:
                row = subjects[skey] = len(seed_rows)
                seed_rows.append(cg.encode_subject(
                    it.subject_type, it.subject_id, it.subject_relation,
                    objs))
            q_batch[i] = row
        return np.asarray(seed_rows, dtype=np.int32), q_slots, q_batch

    def check(self, item: CheckItem, now: Optional[float] = None,
              context: Optional[dict] = None) -> bool:
        return self.check_bulk([item], now=now, context=context)[0]

    def _cache_deadline(self, cg: CompiledGraph, now0: float,
                        context: Optional[dict]) -> float:
        """Validity horizon of a decision-cache entry filled at ``now0``:
        the store's next expiration boundary joined with the caveat
        table's next verdict-flip instant (a time-window caveat grants or
        revokes without a write, as an expiry does)."""
        deadline = self.store.next_expiry(now0)
        cav = cg.caveats
        if cav is not None and cav.metas:
            deadline = min(deadline, cav.next_time_bound(
                now0, cav.request_ts(context)))
        return deadline

    def _digest(self, cg: CompiledGraph, context) -> Optional[str]:
        """The cache keys' context digest on ``cg``: none on a graph
        without caveat instances (its answers cannot depend on the
        context), else the digest of the declared caveat parameters
        only, so undeclared request fields do not split the entries."""
        cav = cg.caveats
        if cav is None or not cav.metas:
            return None
        return context_digest(cav.relevant_context(context))

    def watch_gate(self, resource_type: str, name: str
                   ) -> tuple[frozenset, bool]:
        """(relevant types, reachable expiration) for watch streams: the
        types whose writes can affect ``resource_type#name``
        (models/schema.py ``watch_relevance``), and whether a relation the
        watched permission reaches allows expiring tuples."""
        return watch_relevance(self.schema, resource_type, name)

    def try_cached_check(self, items: list[CheckItem],
                         context: Optional[dict] = None
                         ) -> Optional[list[bool]]:
        """Non-blocking decision-cache probe: every verdict when every
        item is a hit at the current revision, else ``None``. Never
        compiles, dispatches or blocks beyond a shard lock."""
        cache = self._decision_cache
        if cache is None:
            return None
        if not items:
            return []
        rev = self.store.revision
        # the parameter-scoped digest only when the published graph
        # provably is this revision; otherwise the full context's digest,
        # which at worst misses
        cg = self._compiled
        if cg is not None and cg.revision == rev:
            digest = self._digest(cg, context)
        else:
            digest = context_digest(context)
        now = time.time()
        out: list[bool] = []
        for it in items:
            v = cache.get(check_key(rev, it, digest), now, record=False)
            if v is MISS:
                return None
            out.append(v)
        # counted only once the whole probe served (a partial probe falls
        # through to check_bulk_async, which counts its own)
        cache.note_hits("check", len(out))
        return out

    def check_bulk(self, items: list[CheckItem],
                   now: Optional[float] = None,
                   context: Optional[dict] = None) -> list[bool]:
        """CheckBulkPermissions: distinct subjects batch along B; the
        items dispatch in chunks of ``CHECK_PIPELINE_CHUNK``. ``context``
        is the request's caveat context (client IP, caller attributes);
        the evaluation clock is injected as the ``now`` caveat
        parameter unless the context supplies it."""
        return self.check_bulk_async(items, now=now,
                                     context=context).result()

    def check_bulk_async(self, items: list[CheckItem],
                         now: Optional[float] = None,
                         context: Optional[dict] = None) -> EngineFuture:
        """Dispatch a bulk check; ``.result()`` waits for the verdicts.

        With the decision cache on (and no explicit ``now``: a pinned
        clock bypasses it), verdicts come from the cache and only the
        miss residue dispatches, against the same snapshot the hits were
        keyed at, so the answer reflects one revision. Both polarities
        are cached at that revision (plus the context digest on a
        caveated graph) until the cache deadline."""
        with tracer.span("engine.check", items=len(items)):
            cache = self._decision_cache
            if cache is None or now is not None or not items:
                return self._check_bulk_dispatch(items, now, context=context)
            # read before the graph: a schema cut in between retires the fill
            since = cache.epoch()
            cg = self.compiled()
            now0 = time.time()
            digest = self._digest(cg, context)
            keys = [check_key(cg.revision, it, digest) for it in items]
            out: list = [None] * len(items)
            miss_idx: list[int] = []
            for i, k in enumerate(keys):
                v = cache.get(k, now0)
                if v is MISS:
                    miss_idx.append(i)
                else:
                    out[i] = v
            if not miss_idx:
                return EngineFuture(None, lambda _: list(out))
            inner = self._check_bulk_dispatch(
                [items[i] for i in miss_idx], now0, cg=cg, context=context)

            def fin(_):
                got = inner.result()
                deadline = self._cache_deadline(cg, now0, context)
                for j, i in enumerate(miss_idx):
                    v = bool(got[j])
                    cache.put(keys[i], v, deadline, 0, now0, since=since)
                    out[i] = v
                return list(out)

            return EngineFuture(None, fin, iters=inner.iterations)

    def _check_bulk_dispatch(self, items: list[CheckItem],
                             now: Optional[float] = None,
                             cg: Optional[CompiledGraph] = None,
                             context: Optional[dict] = None
                             ) -> EngineFuture:
        """The bulk check without the cache: one chunked device pass.
        ``cg`` pins a snapshot already taken (the cached path's)."""
        if not items:
            return EngineFuture(None, lambda _: [])
        if cg is None:
            cg = self.compiled()
        objs = self._objects_by_name()
        t0 = time.perf_counter()
        self._apply_crossover(cg)
        backend = self._backend(cg)
        n = len(items)
        chunk = self.CHECK_PIPELINE_CHUNK
        if now is None:
            now = time.time()  # one clock for every chunk of the call
        # the request context encodes ONCE for the whole logical call:
        # every chunk shares it (a per-chunk encode would also count a
        # request-list overflow once per chunk)
        cav_req = None
        cavs = cg.caveats
        if cavs is not None and cavs.metas:
            cav_req, _ = cavs.encode_request(context, now)
        futs, where = [], []
        rows_max = max(1, self.CHECK_MAX_ROW_SLOTS // max(1, cg.M))
        # every chunk runs against one device state: a write waits for the
        # whole call, so one bulk check never spans two revisions
        with backend.shared_state():
            for s in range(0, n, chunk):
                part = items[s:s + chunk]
                with tracer.span("engine.encode_checks", items=len(part)):
                    seeds, q_slots, q_batch = self._encode_checks(
                        cg, objs, part)
                if len(seeds) <= rows_max:
                    where.append(slice(s, s + len(q_slots)))
                    futs.append(backend.query_async(
                        seeds, q_slots, q_batch, now=now, context=context,
                        cav_req=cav_req))
                    continue
                for r0 in range(0, len(seeds), rows_max):
                    sel = np.flatnonzero((q_batch >= r0)
                                         & (q_batch < r0 + rows_max))
                    where.append(s + sel)
                    futs.append(backend.query_async(
                        seeds[r0:r0 + rows_max], q_slots[sel],
                        q_batch[sel] - r0, now=now, context=context,
                        cav_req=cav_req))
        metrics.counter("engine_checks_total").inc(n)
        # the device's share of a request trace, finished by fin
        dev_span = tracer.begin("device", kind="check", rows=n)

        def iters():
            return max(f.iterations() for f in futs)

        def fin(_):
            got = np.empty(n, dtype=bool)
            for w, f in zip(where, futs):
                got[w] = f.result()
            out = got.tolist()
            metrics.histogram("engine_check_seconds").observe(
                time.perf_counter() - t0)
            it = iters()
            metrics.histogram("engine_fixpoint_iterations").observe(it)
            self._count_semiring_modes(futs)
            # caveat instances that resolved to missing context: DISTINCT
            # instances per logical call (every chunk shares one graph and
            # one context, so the chunks' counts are equal: max, not sum)
            self._count_missing(max(f.caveats_missing() for f in futs))
            if dev_span is not None:
                dev_span.set("fixpoint_iters", it)
                dev_span.finish()
            return out

        return EngineFuture(None, fin, iters=iters)

    def lookup_resources(self, resource_type: str, permission: str,
                         subject_type: str, subject_id: str,
                         subject_relation: Optional[str] = None,
                         now: Optional[float] = None,
                         context: Optional[dict] = None) -> list[str]:
        """LookupResources: ids of ``resource_type`` on which the subject
        has ``permission``, from one fixpoint."""
        mask, interner = self.lookup_resources_mask(
            resource_type, permission, subject_type, subject_id,
            subject_relation, now=now, context=context)
        return mask_to_ids(mask, interner)

    def lookup_subjects(self, resource_type: str, resource_id: str,
                        permission: str, subject_type: str,
                        subject_relation: Optional[str] = None,
                        now: Optional[float] = None,
                        context: Optional[dict] = None,
                        chunk: int = 4096) -> list[str]:
        """LookupSubjects: the subjects of ``subject_type`` that hold
        ``permission`` on one resource, as bulk checks over the store's
        known subjects of that type (every distinct subject id in any
        relationship). A wildcard grant passes every known subject; the
        literal ``'*'`` is never reported. Sorted. The JAX package checks
        every known subject; the port checks only those the schema can
        lead from the resource to (``subject_candidates``, every subject
        with a verdict of True among them), and every known subject
        (``Store.subject_ids``) when a wildcard is on the way. With a
        ``subject_relation`` it keeps only the candidates some tuple
        names as a subject, as the JAX package's are: the same answer, at
        the cost of the resource's neighbourhood instead of the whole
        store."""
        cands = subject_candidates(self.schema, self.store, resource_type,
                                   resource_id, permission, subject_type,
                                   subject_relation)
        if cands is None or subject_relation:
            # the JAX package's candidates: every subject some tuple names
            known = self.store.subject_ids(subject_type)
            cands = known if cands is None else cands.intersection(known)
        cands = sorted(sid for sid in cands if sid != "*")
        out: list[str] = []
        for i in range(0, len(cands), chunk):
            part = cands[i:i + chunk]
            got = self.check_bulk(
                [CheckItem(resource_type, resource_id, permission,
                           subject_type, sid, subject_relation)
                 for sid in part], now=now, context=context)
            out.extend(sid for sid, ok in zip(part, got) if ok)
        metrics.counter("engine_lookup_subjects_total").inc()
        return out

    def lookup_resources_mask(self, resource_type: str, permission: str,
                              subject_type: str, subject_id: str,
                              subject_relation: Optional[str] = None,
                              now: Optional[float] = None,
                              context: Optional[dict] = None):
        """The list-filter hot path: (bool mask over the type's object
        index space, per-type interner)."""
        return self.lookup_resources_mask_async(
            resource_type, permission, subject_type, subject_id,
            subject_relation, now=now, context=context).result()

    def lookup_resources_mask_async(self, resource_type: str,
                                    permission: str, subject_type: str,
                                    subject_id: str,
                                    subject_relation: Optional[str] = None,
                                    now: Optional[float] = None,
                                    context: Optional[dict] = None
                                    ) -> EngineFuture:
        """Non-blocking mask lookup; ``.result()`` -> (mask, interner).
        With batching on, concurrent calls fuse into one dispatch.

        The decision cache (when on; now-less queries only) sits in front
        of everything: a repeat at an unchanged revision is served on the
        host with no device work, and concurrent identical misses share
        one flight: one caller dispatches (through the batcher when on,
        which so only sees true misses), the rest wait on its result.
        Cached masks are copied on read."""
        with tracer.span("engine.lookup", resource_type=resource_type,
                         permission=permission):
            cache = self._decision_cache
            if cache is None or now is not None:
                return self._lookup_submit(resource_type, permission,
                                           subject_type, subject_id,
                                           subject_relation, now, context)
            # read before the graph: a schema cut in between retires the fill
            since = cache.epoch()
            cg = self.compiled()
            key = lookup_key(cg.revision, resource_type, permission,
                             subject_type, subject_id, subject_relation,
                             self._digest(cg, context))
            now0 = time.time()
            hit = cache.get(key, now0)
            if hit is not MISS:
                mask, interner = hit
                return EngineFuture(None, lambda _: (
                    None if mask is None else mask.copy(), interner))
            leader, flight = cache.flight(key, now0)
            if not leader:

                def fin_follower(_):
                    mask, interner = flight.result()
                    return (None if mask is None else mask.copy(), interner)

                return EngineFuture(None, fin_follower)
            try:
                inner = self._lookup_submit(resource_type, permission,
                                            subject_type, subject_id,
                                            subject_relation, None, context)
            except BaseException as e:  # the dispatch died before a future
                flight.abort(e)
                cache.release(key, flight)
                raise

            def finish():
                try:
                    value = inner.result()
                except BaseException:
                    cache.release(key, flight)  # errors are never cached
                    raise
                mask, interner = value
                deadline = self._cache_deadline(cg, now0, context)
                flight.deadline = deadline
                cache.put(key, (mask, interner), deadline,
                          0 if mask is None else int(mask.nbytes), now0,
                          since=since)
                cache.release(key, flight)
                return value

            flight.launch(finish)

            def fin_leader(_):
                mask, interner = flight.result()
                return (None if mask is None else mask.copy(), interner)

            return EngineFuture(None, fin_leader,
                                iters=getattr(inner, "iterations", None))

    def _lookup_submit(self, resource_type: str, permission: str,
                       subject_type: str, subject_id: str,
                       subject_relation: Optional[str],
                       now: Optional[float],
                       context: Optional[dict] = None):
        """Route one true-miss lookup: fused through the batcher when on,
        direct otherwise."""
        cg = self._compiled
        current = cg is not None and cg.revision == self.store.revision
        # a context matters only on a graph that may hold caveat
        # instances; contexted lookups on a provably caveat-less current
        # graph fuse with the context-free ones
        ctx_matters = bool(context) and not (
            current and (cg.caveats is None or not cg.caveats.metas))
        if ctx_matters:
            metrics.counter("engine_lookups_contexted_total").inc()
        if self._batcher is not None and now is None:
            # explicit-now callers bypass the batcher: a fused batch runs
            # at one dispatch-time clock. A fused batch evaluates ONE
            # caveat mask, so it holds lookups of one context digest: the
            # parameter-scoped one where the published graph provably is
            # this revision, else the full context's, which at worst
            # splits a batch. The batcher dispatches a contexted lookup
            # at once where its digest has shown no company
            key = None
            if ctx_matters:
                key = (self._digest(cg, context) if current
                       else context_digest(context))
            return self._batcher.submit(
                resource_type, permission, subject_type, subject_id,
                subject_relation, context=context, key=key,
                contexted=ctx_matters)
        return self._lookup_direct(resource_type, permission, subject_type,
                                   subject_id, subject_relation, now,
                                   context)

    # -- semiring mode feedback ---------------------------------------------

    def _apply_crossover(self, cg: CompiledGraph) -> None:
        """Stamp the occupancy-derived push/pull crossover onto the graph
        about to run."""
        cg.spmm_crossover = semiring.crossover_from_occupancy(self._occ_ewma)
        metrics.gauge("engine_semiring_crossover").set(cg.spmm_crossover)

    def _observe_occupancy(self, frac: float) -> None:
        """Fold one observed final-frontier fill fraction into the EWMA."""
        e = self._occ_ewma
        self._occ_ewma = frac if e is None else 0.9 * e + 0.1 * frac

    @staticmethod
    def _count_missing(missing: int) -> None:
        """Caveat instances that resolved to missing context in one
        logical call: denied fail-closed, and counted."""
        if missing:
            metrics.counter(
                "engine_caveat_denied_missing_context_total").inc(missing)

    @staticmethod
    def _count_semiring_modes(futs) -> None:
        """Per-mode hop counters off completed futures (the pull share
        clamps at zero: level applications count as pushes only)."""
        push = pull = 0
        for f in futs:
            p = f.push_steps()
            push += p
            pull += max(f.iterations() - p, 0)
        if push:
            metrics.counter("engine_semiring_push_steps_total").inc(push)
        if pull:
            metrics.counter("engine_semiring_pull_steps_total").inc(pull)

    def _q_arrays(self, composition: tuple) -> tuple:
        """The host query arrays ``(q_slots, q_batch)`` of a lookup whose
        rows read the windows of ``composition`` (an ``(offset, size)``
        a row, in row order). Cached, oldest out past ``Q_HOST_BYTES``:
        they are a pure function of it, and rebuilding rows x a type's
        objects each dispatch is measurable host time."""
        with self._q_host_lock:
            ent = self._q_host.get(composition)
        if ent is not None:
            return ent
        ent = (np.concatenate([off + np.arange(n, dtype=np.int32)
                               for off, n in composition]),
               np.concatenate([np.full(n, row, dtype=np.int32)
                               for row, (_, n) in enumerate(composition)]))
        size = ent[0].nbytes + ent[1].nbytes
        with self._q_host_lock:
            if size <= Q_HOST_BYTES and composition not in self._q_host:
                while self._q_host_bytes + size > Q_HOST_BYTES:
                    old = self._q_host.pop(next(iter(self._q_host)))
                    self._q_host_bytes -= old[0].nbytes + old[1].nbytes
                self._q_host[composition] = ent
                self._q_host_bytes += size
        return ent

    def _lookup_direct(self, resource_type: str, permission: str,
                       subject_type: str, subject_id: str,
                       subject_relation: Optional[str],
                       now: Optional[float],
                       context: Optional[dict] = None) -> EngineFuture:
        with tracer.span("engine.dispatch", rows=1):
            cg = self.compiled()
            objs = self._objects_by_name()
            off = cg.offset_of(resource_type, permission)
            n = cg.type_sizes.get(resource_type)
            interner = objs.get(resource_type)
            metrics.counter("engine_lookups_total").inc()
            if off is None or interner is None:
                return EngineFuture(None, lambda _: (None, None))
            seeds = np.asarray([cg.encode_subject(
                subject_type, subject_id, subject_relation, objs)],
                dtype=np.int32)
            q_slots, q_batch = self._q_arrays(((off, n),))
            t0 = time.perf_counter()
            self._apply_crossover(cg)
            fut = self._backend(cg).query_async(
                seeds, q_slots, q_batch, now=now,
                q_cache_key=("lookup", off, n), q_contiguous=True,
                context=context)
        # the device's share of a request trace, finished by fin
        dev_span = tracer.begin("device", kind="lookup", rows=n)

        def fin(out):
            metrics.histogram("engine_lookup_seconds").observe(
                time.perf_counter() - t0)
            iters = fut.iterations()
            metrics.histogram("engine_fixpoint_iterations").observe(iters)
            self._count_missing(fut.caveats_missing())
            m = mask_pseudo_objects(np.array(out, copy=True))
            # final-frontier occupancy of the queried window feeds the
            # EWMA behind the push/pull crossover
            occ = int(m.sum())
            metrics.histogram(
                "engine_frontier_occupancy",
                buckets=(0, 1, 8, 64, 512, 4096, 32768, 262144, 2**21),
            ).observe(occ)
            self._observe_occupancy(float(occ) / max(m.size, 1))
            self._count_semiring_modes((fut,))
            if dev_span is not None:
                dev_span.set("fixpoint_iters", iters)
                dev_span.set("frontier_occupancy", occ)
                dev_span.finish()
            return m, interner

        return EngineFuture(fut, fin)

    # -- live schema migration (migration/migrator.py) -----------------------

    def begin_schema_migration(self, schema_text: str,
                               record_path: Optional[str] = None,
                               wait: bool = False, **cfg) -> dict:
        """Start a zero-downtime migration of this engine to the schema
        in ``schema_text``: diff-classify, dual-compile, journaled
        backfill, and a revision-preserving cutover. Returns the initial
        status dict; ``wait=True`` blocks until done/failed. Raises
        :class:`~..models.schema.IncompatibleSchemaChange` (a
        ``SchemaError``) before any state changes when the transition is
        not performable online."""
        from ..migration import SchemaMigrator

        with self._lock:
            if self._migrator is not None and self._migrator.active:
                raise StoreError("a schema migration is already running")
            prev = self._migrator
            m = SchemaMigrator(self, schema_text,
                               record_path=record_path
                               or self._default_migration_record(), **cfg)
            self._migrator = m
        try:
            m.start()
        except BaseException:
            # a refused plan (e.g. an incompatible diff) must not leave a
            # never-started migrator installed as active: that would
            # refuse every later begin
            with self._lock:
                if self._migrator is m:
                    self._migrator = prev
            raise
        if wait:
            m.join()
        return m.status()

    def _default_migration_record(self) -> Optional[str]:
        """Persist the migration phase machine beside the WAL when the
        engine is durable; memory-only engines migrate without a record
        (a crash loses the store anyway)."""
        p = self._persistence
        d = getattr(p, "data_dir", None) if p is not None else None
        if d is None:
            return None
        return os.path.join(d, "migration.json")

    def migration_status(self) -> Optional[dict]:
        """Phase/lag status of the running (or last) migration, or
        ``None`` when this engine never migrated."""
        m = self._migrator
        return None if m is None else m.status()

    def abort_schema_migration(self) -> dict:
        """Abort the running migration (refused once its cut persisted)."""
        m = self._migrator
        if m is None:
            raise StoreError("no schema migration to abort")
        return m.abort()

    def cut_schema_migration(self, wait: bool = True) -> dict:
        """Release a migration holding at the dual phase into its cutover
        (the coordinated-cut hook). Idempotent: a migration already cut
        (or done) returns its status."""
        m = self._migrator
        if m is None:
            raise StoreError("no schema migration to cut")
        m.request_cut()
        if wait:
            m.join()
        return m.status()

    def recover_schema_migration(self,
                                 record_path: Optional[str] = None
                                 ) -> Optional[dict]:
        """Boot-time crash matrix: consult the persisted migration record
        (if any) and either abort cleanly (no cut persisted) or finish the
        cutover (cut persisted). Returns the outcome dict, or ``None``
        when there was nothing to recover."""
        from ..migration import recover

        return recover(self, record_path
                       or self._default_migration_record())

    # -- debugging ----------------------------------------------------------

    def oracle(self, now: Optional[float] = None,
               context: Optional[dict] = None) -> OracleEvaluator:
        """The plain host evaluator over the current store."""
        return OracleEvaluator(self.schema, self.store.snapshot(), now=now,
                               context=context)
