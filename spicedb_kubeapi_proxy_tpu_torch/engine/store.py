"""Mutable relationship store: columnar and revisioned.

The slice of the JAX package's ``engine/store.py`` the port's engine
needs: :class:`Columns`, :class:`Snapshot`, ``Store.bulk_load``,
``Store.write`` (CREATE/TOUCH/DELETE with preconditions),
``Store.delete_by_filter``, ``Store.read``, ``Store.next_expiry``, the
watch log (``watch_since`` / ``wait_since``) that the incremental graph
update replays, the append-only caveat-instance table, and durability:
the ``journal`` hook every revision-advancing mutation calls under the
store lock (persistence/manager.py), ``apply_effects`` (WAL replay),
snapshots (``save`` / ``save_dir`` / ``state_bytes`` and ``load`` /
``load_state_bytes``, the same npz keys and meta JSON as the reference,
so either package loads the other's files) and the interner ``epoch``
a restore rotates. Replication comes with a later slice.

Layout is columnar int32 (see :class:`Columns`) so that 10M-relationship
graphs bulk-load and snapshot without per-row Python objects. The row-key
index the write path needs is hybrid (:class:`StoreIndex`): large chunks
(bulk loads) get a vectorized sorted hash index, small write chunks land
in a plain dict; liveness is checked at lookup time so tombstoning a row
needs no index maintenance.
"""

from __future__ import annotations

import bisect
import io
import json
import os
import tempfile
import threading
import time
import uuid
from dataclasses import asdict, dataclass, field
from typing import Optional

import numpy as np

from .. import native
from ..models.tuples import Relationship, canonical_context
from ..utils.metrics import metrics
from .interning import Interner

# Operation codes (write ops)
OP_CREATE = 1
OP_TOUCH = 2
OP_DELETE = 3

_OPS = {"create": OP_CREATE, "touch": OP_TOUCH, "delete": OP_DELETE}

NO_EXPIRATION = np.float64(np.inf)


class StoreError(Exception):
    pass


class PreconditionFailed(StoreError):
    """A write's precondition did not hold."""


class AlreadyExists(StoreError):
    """CREATE of an existing relationship."""


@dataclass
class Columns:
    """Columnar relationship block: parallel int32 arrays + expiration
    + caveat-instance id (0 = unconditional; else an index into the
    store's append-only ``caveat_instances`` table)."""

    rt: np.ndarray  # resource type id      (types interner)
    rid: np.ndarray  # resource object id   (per-type objects interner)
    rl: np.ndarray  # relation id           (relations interner)
    st: np.ndarray  # subject type id
    sid: np.ndarray  # subject object id
    srl: np.ndarray  # subject relation id; 0 == none (ELLIPSIS)
    exp: np.ndarray  # float64 unix seconds; +inf == never expires
    cav: np.ndarray = None  # int32 caveat-instance id; 0 == none

    def __post_init__(self):
        if self.cav is None:
            self.cav = np.zeros(len(self.rt), dtype=np.int32)

    def __len__(self) -> int:
        return len(self.rt)

    @staticmethod
    def empty() -> "Columns":
        z = np.empty(0, dtype=np.int32)
        return Columns(z, z.copy(), z.copy(), z.copy(), z.copy(), z.copy(),
                       np.empty(0, dtype=np.float64), z.copy())

    @staticmethod
    def concat(blocks: list["Columns"]) -> "Columns":
        if not blocks:
            return Columns.empty()
        return Columns(*[
            np.concatenate([getattr(b, f) for b in blocks])
            for f in ("rt", "rid", "rl", "st", "sid", "srl", "exp", "cav")
        ])

    def take(self, idx) -> "Columns":
        return Columns(self.rt[idx], self.rid[idx], self.rl[idx], self.st[idx],
                       self.sid[idx], self.srl[idx], self.exp[idx],
                       self.cav[idx])


@dataclass(frozen=True)
class RelationshipFilter:
    """SpiceDB-style relationship filter. ``None`` fields match anything."""

    resource_type: Optional[str] = None
    resource_id: Optional[str] = None
    relation: Optional[str] = None
    subject_type: Optional[str] = None
    subject_id: Optional[str] = None
    subject_relation: Optional[str] = None


@dataclass(frozen=True)
class Precondition:
    filter: RelationshipFilter
    must_exist: bool  # False => must NOT exist


@dataclass(frozen=True)
class WriteOp:
    op: str  # create | touch | delete
    rel: Relationship


@dataclass(frozen=True)
class WatchRecord:
    revision: int
    op: int  # OP_TOUCH (covers create) | OP_DELETE
    rel: Relationship


@dataclass
class Snapshot:
    """Immutable view handed to the graph compiler."""

    revision: int
    cols: Columns
    types: Interner
    relations: Interner
    objects: dict[int, Interner]  # type id -> per-type object interner
    # append-only (name, canonical ctx JSON) caveat-instance table;
    # index 0 reserved for "no caveat". Shared with the live store
    # (monotone like the interners), so sharing with an immutable
    # snapshot is safe.
    caveat_instances: list = field(default_factory=lambda: [("", "")])


# chunks at or above this many rows get the vectorized sorted index; below
# it a dict is faster to build and query
INDEX_SMALL_CHUNK = 4096

_MIX1 = np.uint64(0x9E3779B97F4A7C15)
_MIX2 = np.uint64(0xBF58476D1CE4E5B9)
_S29 = np.uint64(29)
_S32 = np.uint64(32)


def _hash_key_cols(rt, rid, rl, st, sid, srl) -> np.ndarray:
    """Vectorized 64-bit mix of the six key columns (splitmix-style).
    Collisions are verified against the actual columns at lookup. MUST
    stay arithmetic-identical to mix_key in native/graphcore.cpp."""
    with np.errstate(over="ignore"):  # uint64 wraparound is the point
        h = np.asarray(rt).astype(np.uint64)
        for c in (rid, rl, st, sid, srl):
            h = (h ^ np.asarray(c).astype(np.uint64)) * _MIX1
            h = h ^ (h >> _S29)
        h = h * _MIX2
        return h ^ (h >> _S32)


class _SortedChunkIndex:
    """Vectorized index over one big chunk: row-key hashes argsorted once,
    lookups by binary search with collision verification."""

    __slots__ = ("hashes", "order", "cols")

    def __init__(self, cols: Columns):
        built = native.index_build(cols.rt, cols.rid, cols.rl,
                                   cols.st, cols.sid, cols.srl)
        if built is not None:  # multithreaded C++ hash + radix sort
            self.hashes, self.order = built
        else:
            h = _hash_key_cols(cols.rt, cols.rid, cols.rl,
                               cols.st, cols.sid, cols.srl)
            self.order = np.argsort(h)
            self.hashes = h[self.order]
        self.cols = cols

    def find(self, key: tuple) -> Optional[int]:
        h0 = _hash_key_cols(*key)
        lo = int(np.searchsorted(self.hashes, h0, side="left"))
        hi = int(np.searchsorted(self.hashes, h0, side="right"))
        c = self.cols
        rt, rid, rl, st, sid, srl = key
        for j in range(lo, hi):
            ri = int(self.order[j])
            if (c.rt[ri] == rt and c.rid[ri] == rid and c.rl[ri] == rl
                    and c.st[ri] == st and c.sid[ri] == sid
                    and c.srl[ri] == srl):
                return ri
        return None


class StoreIndex:
    """Hybrid row-key index. ``get`` returns the (chunk, row) of the LIVE
    row holding a key, or None — dead rows are filtered at lookup time."""

    def __init__(self):
        self._dict: dict[tuple, tuple[int, int]] = {}
        self._sorted: list[tuple[int, _SortedChunkIndex]] = []
        self._built = 0  # chunks indexed so far
        # chunk indexes computed ahead of time by a background thread
        # (keyed by chunk identity: chunks are immutable once appended)
        self._prebuilt: dict[int, _SortedChunkIndex] = {}
        self._prelock = threading.Lock()

    def prebuild(self, chunks: list[Columns]) -> None:
        """Build sorted indexes for big chunks not yet synced. Safe from a
        background thread: reads only immutable chunk arrays and publishes
        under its own lock. ``Store.bulk_load`` starts it, so the first
        write after a 10M-row load joins a build already running (usually
        finished) instead of paying it inline."""
        for cols in chunks[self._built:]:
            if len(cols) < INDEX_SMALL_CHUNK:
                continue
            key = id(cols)
            with self._prelock:
                if key in self._prebuilt:
                    continue
            idx = _SortedChunkIndex(cols)
            with self._prelock:
                self._prebuilt[key] = idx

    def sync(self, chunks: list[Columns]) -> None:
        for ci in range(self._built, len(chunks)):
            cols = chunks[ci]
            if len(cols) >= INDEX_SMALL_CHUNK:
                with self._prelock:
                    idx = self._prebuilt.pop(id(cols), None)
                self._sorted.append((ci, idx if idx is not None
                                     else _SortedChunkIndex(cols)))
            else:
                arr = np.stack([cols.rt, cols.rid, cols.rl, cols.st,
                                cols.sid, cols.srl], axis=1)
                for ri, row in enumerate(arr.tolist()):
                    self._dict[tuple(row)] = (ci, ri)
        self._built = len(chunks)

    def get(self, key: tuple, alive: list) -> Optional[tuple[int, int]]:
        pos = self._dict.get(key)
        if pos is not None and alive[pos[0]][pos[1]]:
            return pos
        for ci, idx in self._sorted:
            ri = idx.find(key)
            if ri is not None and alive[ci][ri]:
                return ci, ri
        return None


def _distinct(col: np.ndarray, limit: int = 64) -> tuple[list, np.ndarray]:
    """(distinct values, each row's index into them) of a string column.
    A low-cardinality column (a caveat name or context column carries a
    handful of values over millions of rows) takes one vectorized
    comparison per distinct value, far cheaper than sorting or re-encoding
    the strings; past ``limit`` values, ``np.unique``."""
    codes = np.zeros(len(col), dtype=np.int64)
    vals: list = []
    open_ = np.ones(len(col), dtype=bool)
    while len(vals) < limit:
        first = int(np.argmax(open_))
        if not open_[first]:
            return vals, codes
        hit = col == col[first]
        codes[hit] = len(vals)
        vals.append(str(col[first]))
        open_ &= ~hit
    uniq, inv = np.unique(col, return_inverse=True)
    return [str(v) for v in uniq.tolist()], inv.reshape(-1)


def caveat_pairs(rels_cols: dict) -> Optional[tuple[list, np.ndarray]]:
    """The distinct (caveat name, context) pairs of a bulk load's
    ``caveat`` / ``caveat_context`` columns, and each row's index into
    them; None without a caveat column. Pairs come in the sorted order of
    their ``name:context`` strings, the order the reference interns them
    in, so instance ids match."""
    names = rels_cols.get("caveat")
    if names is None:
        return None
    names = np.asarray(names, dtype=str)
    ctxs = rels_cols.get("caveat_context")
    ctxs = (np.asarray(ctxs, dtype=str) if ctxs is not None
            else np.full(len(names), "", dtype=str))
    if not len(names):
        return [], np.zeros(0, dtype=np.int64)
    nv, nc = _distinct(names)
    cv, cc = _distinct(ctxs)
    keys, row_key = np.unique(nc * len(cv) + cc, return_inverse=True)
    pairs = [(nv[k // len(cv)], cv[k % len(cv)]) for k in keys.tolist()]
    order = sorted(range(len(pairs)),
                   key=lambda i: pairs[i][0] + ":" + pairs[i][1])
    rank = np.empty(len(order), dtype=np.int64)
    rank[order] = np.arange(len(order))
    return [pairs[i] for i in order], rank[row_key.reshape(-1)]


class Store:
    """Thread-safe mutable relationship store."""

    # Per-type object interners reserve index 0 for "void" (unknown ids at
    # query time) and 1 for the wildcard object '*'.
    RESERVED_OBJECTS = ("\x00void", "*")

    def __init__(self):
        self._lock = threading.RLock()
        # interner epoch: interners only ever append within an epoch, so a
        # client may cache id->string tables keyed on (epoch, len); a
        # restore rebuilds the interners and mints a new epoch
        self.epoch = uuid.uuid4().hex
        self.types = Interner()
        # relation id 0 reserved for "no subject relation"
        self.relations = Interner(reserved=("",))
        self.objects: dict[int, Interner] = {}
        # caveat-instance table: one row per distinct (caveat name,
        # canonical context JSON) pair; append-only, so snapshots and
        # compiled graphs share it by reference. Index 0 reserved for
        # "no caveat".
        self.caveat_instances: list[tuple[str, str]] = [("", "")]
        self._caveat_key: dict[tuple, int] = {("", ""): 0}
        self._chunks: list[Columns] = []
        self._alive: list[np.ndarray] = []  # bool per chunk
        self._index = StoreIndex()
        self._prebuild_thread: Optional[threading.Thread] = None
        # revision-advance signal: wait_since() blocks on this instead of
        # polling
        self._watch_cond = threading.Condition(self._lock)
        self.revision = 0
        # highest revision whose changes are NOT in the watch log
        # (bulk_load): incremental graph updates can only start from
        # revisions at or after this point
        self.unlogged_revision = 0
        self._watch_log: list[WatchRecord] = []
        # history retention: beyond the cap the oldest half is dropped and
        # watchers that far behind get a StoreError (re-list + re-watch)
        self.watch_retention = 1_000_000
        self._watch_oldest_rev = 0
        # (revision, sorted unique finite expirations of live rows),
        # rebuilt lazily at most once per revision; _has_finite_exp is the
        # monotone fast path for stores that never wrote an expiring tuple
        self._expiry_bounds: Optional[tuple] = None
        self._has_finite_exp = False
        # durability hook (persistence/manager.py): called UNDER the
        # write lock with (record_meta, blob) after each revision-advancing
        # mutation, so journal order is revision order and the record is
        # on disk before the transaction returns. None = in-memory only
        self.journal = None

    # -- interning helpers -------------------------------------------------

    def _obj_interner(self, type_id: int) -> Interner:
        it = self.objects.get(type_id)
        if it is None:
            it = Interner(reserved=self.RESERVED_OBJECTS)
            self.objects[type_id] = it
        return it

    def _intern_rel(self, rel: Relationship) -> tuple:
        rt = self.types.intern(rel.resource_type)
        st = self.types.intern(rel.subject_type)
        return (
            rt,
            self._obj_interner(rt).intern(rel.resource_id),
            self.relations.intern(rel.relation),
            st,
            self._obj_interner(st).intern(rel.subject_id),
            self.relations.intern(rel.subject_relation or ""),
        )

    def _intern_cav(self, rel: Relationship) -> int:
        """Caveat-instance id for a relationship (0 = unconditional)."""
        if not rel.caveat:
            return 0
        k = (rel.caveat, rel.caveat_context or "")
        i = self._caveat_key.get(k)
        if i is None:
            i = len(self.caveat_instances)
            self.caveat_instances.append(k)
            self._caveat_key[k] = i
        return i

    def _extern_rel(self, key: tuple, exp: float,
                    cav: int = 0) -> Relationship:
        rt, rid, rl, st, sid, srl = key
        name, ctx = self.caveat_instances[cav] if cav else ("", "")
        return Relationship(
            self.types.string(rt),
            self.objects[rt].string(rid),
            self.relations.string(rl),
            self.types.string(st),
            self.objects[st].string(sid),
            self.relations.string(srl) or None,
            None if not np.isfinite(exp) else float(exp),
            name or None,
            ctx or None,
        )

    # -- index -------------------------------------------------------------

    def _ensure_index(self) -> StoreIndex:
        t = self._prebuild_thread
        if t is not None:
            if t.is_alive():
                t.join()
            self._prebuild_thread = None
        self._index.sync(self._chunks)
        return self._index

    def _start_index_prebuild(self) -> None:
        """Overlap the big-chunk index build with whatever follows a bulk
        load or a restore (the graph compile)."""
        prev = self._prebuild_thread
        if prev is not None and prev.is_alive():
            # back-to-back loads: an abandoned thread could publish a stale
            # _prebuilt entry after sync() passed its chunk
            prev.join()
        idx, chunks = self._index, list(self._chunks)
        t = threading.Thread(target=idx.prebuild, args=(chunks,),
                             daemon=True, name="store-index-prebuild")
        self._prebuild_thread = t
        t.start()

    def _append_rows(self, cols: Columns) -> None:
        # the index picks the new chunk up at the next sync (lazy)
        self._chunks.append(cols)
        self._alive.append(np.ones(len(cols), dtype=bool))

    # -- filter matching ---------------------------------------------------

    def _filter_mask(self, cols: Columns, f: RelationshipFilter,
                     now: Optional[float] = None) -> np.ndarray:
        mask = np.ones(len(cols), dtype=bool)

        def match_str(interner: Interner, col: np.ndarray, value):
            nonlocal mask
            if value is None:
                return
            i = interner.lookup(value)
            if i is None:
                mask &= False
            else:
                mask &= col == i

        match_str(self.types, cols.rt, f.resource_type)
        match_str(self.relations, cols.rl, f.relation)
        match_str(self.types, cols.st, f.subject_type)
        # object ids live in per-type interners; resolve per present type
        for value, tcol, icol in ((f.resource_id, cols.rt, cols.rid),
                                  (f.subject_id, cols.st, cols.sid)):
            if value is None:
                continue
            ok = np.zeros(len(cols), dtype=bool)
            for tid in np.unique(tcol[mask]).tolist():
                oi = self.objects.get(tid)
                v = oi.lookup(value) if oi else None
                if v is not None:
                    ok |= (tcol == tid) & (icol == v)
            mask &= ok
        if f.subject_relation is not None:
            i = self.relations.lookup(f.subject_relation)
            mask &= (cols.srl == i) if i is not None else False
        if now is not None:
            mask &= cols.exp > now
        return mask

    # -- public API --------------------------------------------------------

    def _observe_revision(self) -> None:
        """Gauges refreshed by every revision-advancing mutation (write,
        delete, bulk load, replay, restore)."""
        metrics.gauge("store_revision").set(self.revision)
        metrics.gauge("store_watch_log_records").set(len(self._watch_log))

    def write(self, ops: list[WriteOp],
              preconditions: list[Precondition] = ()) -> int:
        """Apply a write transaction; returns the new revision.

        CREATE errors on an existing live tuple (SpiceDB AlreadyExists);
        TOUCH upserts (refreshing expiration); DELETE is idempotent.
        Duplicate updates for the same tuple in one write are rejected.
        Every applied change lands in the watch log at the new revision
        and, with a journal attached, in one ``write`` record before the
        call returns.
        """
        t0 = time.perf_counter()
        with self._lock:
            now = time.time()
            for pc in preconditions:
                if self.exists(pc.filter, _now=now) != pc.must_exist:
                    raise PreconditionFailed(
                        f"precondition {'exists' if pc.must_exist else 'does not exist'} "
                        f"failed for {pc.filter}"
                    )
            idx = self._ensure_index()

            # Pass 1 — plan + validate before any mutation so the whole
            # batch is atomic.
            seen: set[tuple] = set()
            plan: list[tuple[int, tuple, float, int]] = []
            for wop in ops:
                code = _OPS[wop.op]
                key = self._intern_rel(wop.rel)
                exp = wop.rel.expiration if wop.rel.expiration is not None \
                    else NO_EXPIRATION
                if key in seen:
                    raise StoreError(
                        f"duplicate update for relationship in one write: {wop.rel}"
                    )
                seen.add(key)
                pos = idx.get(key, self._alive)
                live = pos is not None and bool(
                    self._chunks[pos[0]].exp[pos[1]] > now
                )
                if code == OP_CREATE and live:
                    raise AlreadyExists(f"relationship already exists: {wop.rel}")
                if code == OP_DELETE:
                    if pos is not None:  # tombstone even expired rows
                        plan.append((OP_DELETE, key, NO_EXPIRATION, 0))
                    continue
                plan.append((OP_TOUCH, key, float(exp),
                             self._intern_cav(wop.rel)))

            if not plan:
                return self.revision

            # Pass 2 — apply.
            rev = self.revision + 1
            new_rows: list[tuple[tuple, float, int]] = []
            journaled = self.journal is not None
            effects: list[dict] = []  # journal record (concrete, replayable)
            for code, key, exp, cav in plan:
                pos = idx.get(key, self._alive)
                if pos is not None:
                    self._alive[pos[0]][pos[1]] = False
                if code == OP_DELETE:
                    rel = self._extern_rel(key, NO_EXPIRATION)
                    self._watch_log.append(WatchRecord(rev, OP_DELETE, rel))
                    if journaled:
                        effects.append({"op": "delete", "rel": asdict(rel)})
                    continue
                new_rows.append((key, exp, cav))
                rel = self._extern_rel(key, exp, cav)
                self._watch_log.append(WatchRecord(rev, OP_TOUCH, rel))
                if journaled:
                    effects.append({"op": "touch", "rel": asdict(rel)})
            if new_rows:
                keys = np.array([k for k, _, _ in new_rows], dtype=np.int32)
                exp_col = np.array([e for _, e, _ in new_rows],
                                   dtype=np.float64)
                cav_col = np.array([c for _, _, c in new_rows],
                                   dtype=np.int32)
                self._append_rows(Columns(
                    keys[:, 0].copy(), keys[:, 1].copy(), keys[:, 2].copy(),
                    keys[:, 3].copy(), keys[:, 4].copy(), keys[:, 5].copy(),
                    exp_col, cav_col,
                ))
                if not self._has_finite_exp and np.isfinite(exp_col).any():
                    self._has_finite_exp = True
            self._trim_watch_log()
            self.revision = rev
            self._observe_revision()
            if journaled:
                self.journal({"kind": "write", "rev": rev,
                              "effects": effects}, None)
            self._watch_cond.notify_all()
            # the store's share of one applied write (the "journal" stage
            # of the per-write split; the overlay append and the read's
            # dispatch are timed by their own layers)
            metrics.histogram("store_write_seconds").observe(
                time.perf_counter() - t0)
            return rev

    def bulk_load(self, rels_cols: dict,
                  _revision: Optional[int] = None) -> int:
        """Fast path for large graph loads: columnar string arrays
        {resource_type, resource_id, relation, subject_type, subject_id,
        subject_relation?, expiration?, caveat?, caveat_context?}. Rows
        are assumed deduplicated.
        Not logged to watch: ``unlogged_revision`` moves to the new
        revision, so no compiled graph older than the load is advanced
        incrementally across it. With a journal attached the columns are
        journaled as one ``bulk_load`` record (persistence/codec.py);
        ``_revision`` pins the assigned revision, which is how WAL replay
        (persistence/recovery.py) re-applies a load at the revision it was
        acknowledged with."""
        with self._lock:
            if _revision is not None and _revision <= self.revision:
                raise StoreError(
                    f"bulk_load replay revision {_revision} is not past "
                    f"current revision {self.revision}")
            n = len(rels_cols["resource_id"])

            def intern_typed(type_col, id_col):
                tids = self.types.intern_many(type_col)
                # fixed-width ndarrays pass through (zero-copy input to the
                # native hash-unique); lists become object arrays
                ids = (id_col if isinstance(id_col, np.ndarray)
                       else np.asarray(id_col, dtype=object))
                out = np.empty(n, dtype=np.int32)
                for tid in np.unique(tids).tolist():
                    sel = tids == tid
                    out[sel] = self._obj_interner(int(tid)).intern_many(
                        ids[sel]
                    )
                return tids, out

            rt, rid = intern_typed(rels_cols["resource_type"],
                                   rels_cols["resource_id"])
            st, sid = intern_typed(rels_cols["subject_type"],
                                   rels_cols["subject_id"])
            rl = self.relations.intern_many(rels_cols["relation"])
            srl_col = rels_cols.get("subject_relation")
            srl = (self.relations.intern_many(srl_col) if srl_col is not None
                   else np.zeros(n, dtype=np.int32))
            exp_col = rels_cols.get("expiration")
            exp = (np.asarray(exp_col, dtype=np.float64) if exp_col is not None
                   else np.full(n, NO_EXPIRATION))
            exp = np.where(np.isnan(exp), NO_EXPIRATION, exp)
            got = caveat_pairs(rels_cols)
            if got is not None:
                pairs, row_pair = got
                codes = np.asarray(
                    [0 if not nm else self._intern_cav(Relationship(
                        "", "", "", "", "", None, None, nm,
                        canonical_context(cx))) for nm, cx in pairs],
                    dtype=np.int32)
                cav = codes[row_pair]
            else:
                cav = np.zeros(n, dtype=np.int32)
            self._append_rows(Columns(rt, rid, rl, st, sid, srl, exp, cav))
            if not self._has_finite_exp and np.isfinite(exp).any():
                self._has_finite_exp = True
            self.revision = (_revision if _revision is not None
                             else self.revision + 1)
            self.unlogged_revision = self.revision
            self._observe_revision()
            if self.journal is not None:
                from ..persistence.codec import encode_bulk_cols

                self.journal({"kind": "bulk_load", "rev": self.revision},
                             encode_bulk_cols(rels_cols))
            self._watch_cond.notify_all()
            self._start_index_prebuild()
            return self.revision

    def read(self, f: RelationshipFilter, now: Optional[float] = None
             ) -> list[Relationship]:
        """ReadRelationships: live, unexpired tuples matching the filter."""
        with self._lock:
            if now is None:
                now = time.time()
            out: list[Relationship] = []
            for cols, alive in zip(self._chunks, self._alive):
                mask = self._filter_mask(cols, f, now=now) & alive
                for ri in np.flatnonzero(mask).tolist():
                    key = (int(cols.rt[ri]), int(cols.rid[ri]), int(cols.rl[ri]),
                           int(cols.st[ri]), int(cols.sid[ri]), int(cols.srl[ri]))
                    out.append(self._extern_rel(key, cols.exp[ri],
                                                int(cols.cav[ri])))
            return out

    def exists(self, f: RelationshipFilter, _now: Optional[float] = None) -> bool:
        with self._lock:
            now = _now if _now is not None else time.time()
            for cols, alive in zip(self._chunks, self._alive):
                if np.any(self._filter_mask(cols, f, now=now) & alive):
                    return True
            return False

    def delete_by_filter(self, f: RelationshipFilter,
                         preconditions: list[Precondition] = ()) -> int:
        """DeleteRelationships: delete all matching tuples; returns count.
        Preconditions are checked under the same lock acquisition as the
        delete so they cannot be invalidated in between."""
        with self._lock:
            now = time.time()
            for pc in preconditions:
                if self.exists(pc.filter, _now=now) != pc.must_exist:
                    raise PreconditionFailed(
                        f"precondition "
                        f"{'exists' if pc.must_exist else 'does not exist'} "
                        f"failed for {pc.filter}")
            count = 0
            rev = self.revision + 1
            journaled = self.journal is not None
            effects: list[dict] = []
            for cols, alive in zip(self._chunks, self._alive):
                rows = np.flatnonzero(self._filter_mask(cols, f, now=now)
                                      & alive)
                if len(rows) == 0:
                    continue
                alive[rows] = False
                count += len(rows)
                for ri in rows.tolist():
                    key = (int(cols.rt[ri]), int(cols.rid[ri]),
                           int(cols.rl[ri]), int(cols.st[ri]),
                           int(cols.sid[ri]), int(cols.srl[ri]))
                    # the index needs no touch-up: lookups check aliveness
                    rel = self._extern_rel(key, NO_EXPIRATION)
                    self._watch_log.append(WatchRecord(rev, OP_DELETE, rel))
                    if journaled:
                        effects.append({"op": "delete", "rel": asdict(rel)})
            if count:
                self._trim_watch_log()
                self.revision = rev
                self._observe_revision()
                if journaled:
                    self.journal({"kind": "delete", "rev": rev,
                                  "effects": effects}, None)
                self._watch_cond.notify_all()
            return count

    def apply_effects(self, effects: list, revision: int) -> None:
        """Replay hook: apply concrete touch/delete effects and pin the
        revision (WAL replay at boot, persistence/recovery.py; follower
        catch-up later). The effects re-apply decisions a live ``write`` /
        ``delete_by_filter`` already made, so there are no preconditions,
        no duplicate checks and no clock reads; within one call the LAST
        effect per key wins. Nothing lands in the watch log: replayed
        history is a new lineage for watchers (as a snapshot restore is),
        and ``unlogged_revision`` advances so incremental graph updates
        restart from the recovered point."""
        with self._lock:
            revision = int(revision)
            if revision <= self.revision:
                raise StoreError(
                    f"apply_effects revision {revision} is not past "
                    f"current revision {self.revision}")
            idx = self._ensure_index()
            final: dict[tuple, Optional[tuple]] = {}
            journaled: list[dict] = []
            for eff in effects:
                rel = eff["rel"]
                if isinstance(rel, dict):
                    rel = Relationship(**rel)
                key = self._intern_rel(rel)
                if eff["op"] == "delete":
                    final[key] = None
                else:
                    final[key] = ((float(rel.expiration)
                                   if rel.expiration is not None
                                   else float(NO_EXPIRATION)),
                                  self._intern_cav(rel))
                journaled.append({"op": eff["op"], "rel": asdict(rel)})
            new_rows: list[tuple[tuple, float, int]] = []
            for key, ent in final.items():
                pos = idx.get(key, self._alive)
                if pos is not None:
                    self._alive[pos[0]][pos[1]] = False
                if ent is not None:
                    new_rows.append((key, ent[0], ent[1]))
            if new_rows:
                keys = np.array([k for k, _, _ in new_rows], dtype=np.int32)
                exp_col = np.array([e for _, e, _ in new_rows],
                                   dtype=np.float64)
                cav_col = np.array([c for _, _, c in new_rows],
                                   dtype=np.int32)
                self._append_rows(Columns(
                    keys[:, 0].copy(), keys[:, 1].copy(), keys[:, 2].copy(),
                    keys[:, 3].copy(), keys[:, 4].copy(), keys[:, 5].copy(),
                    exp_col, cav_col,
                ))
                if not self._has_finite_exp and np.isfinite(exp_col).any():
                    self._has_finite_exp = True
            self._expiry_bounds = None
            self.revision = revision
            self.unlogged_revision = revision
            self._observe_revision()
            # watchers from before the jump must re-list: their revisions
            # describe history this store never logged
            self._watch_oldest_rev = revision
            if self.journal is not None:
                self.journal({"kind": "apply", "rev": revision,
                              "effects": journaled}, None)
            self._watch_cond.notify_all()

    def next_expiry(self, now: float) -> float:
        """Earliest expiration boundary strictly after ``now`` among live
        tuples (a result computed at ``now`` stays exact until then);
        ``+inf`` when no live tuple carries a finite expiration."""
        with self._lock:
            if not self._has_finite_exp:
                return float("inf")
            ent = self._expiry_bounds
            if ent is None or ent[0] != self.revision:
                vals = []
                for cols, alive in zip(self._chunks, self._alive):
                    sel = alive & np.isfinite(cols.exp)
                    if sel.any():
                        vals.append(cols.exp[sel])
                arr = (np.unique(np.concatenate(vals)) if vals
                       else np.empty(0, dtype=np.float64))
                self._expiry_bounds = ent = (self.revision, arr)
            arr = ent[1]
            i = int(np.searchsorted(arr, now, side="right"))
            return float(arr[i]) if i < len(arr) else float("inf")

    def _trim_watch_log(self) -> None:
        # caller holds the lock
        if len(self._watch_log) > self.watch_retention:
            drop = len(self._watch_log) // 2
            self._watch_oldest_rev = self._watch_log[drop - 1].revision
            del self._watch_log[:drop]

    def wake_waiters(self) -> None:
        """Release every thread parked in :meth:`wait_since` (they return
        ``[]``), so a shutdown never waits out a timeout."""
        with self._watch_cond:
            self._watch_cond.notify_all()

    def wait_since(self, revision: int, timeout: float) -> list[WatchRecord]:
        """Block until events past ``revision`` exist (or ``timeout``
        elapses — then ``[]``), and return them."""
        with self._watch_cond:
            if revision > self.revision:
                # a revision from the future: raise now (watch_since) rather
                # than park until the numbers happen to overlap
                return self.watch_since(revision)
            if self.revision <= revision:
                self._watch_cond.wait(timeout)
            if self.revision <= revision:
                return []
            return self.watch_since(revision)

    def watch_since(self, revision: int) -> list[WatchRecord]:
        """Watch records with revision > ``revision``, in revision order.
        Raises StoreError when the history before ``revision`` has been
        trimmed, or when ``revision`` is ahead of the store (a superseded
        lineage: waiting for the numbers to catch up would skip every
        event in the overlap)."""
        with self._lock:
            if revision > self.revision:
                raise StoreError(
                    f"watch revision {revision} is ahead of the store "
                    f"(revision {self.revision}); re-list and re-watch")
            if revision < self._watch_oldest_rev:
                raise StoreError(
                    f"watch history before revision {self._watch_oldest_rev} "
                    "has been trimmed; re-list and re-watch")
            i = bisect.bisect_right(self._watch_log, revision,
                                    key=lambda r: r.revision)
            return self._watch_log[i:]

    # -- durability ---------------------------------------------------------

    def _collect_state(self) -> tuple[Columns, dict]:
        """(compacted live columns, meta) under the lock: the snapshot
        payload of file saves and the full-state transfer."""
        with self._lock:
            live = [cols.take(np.flatnonzero(alive))
                    for cols, alive in zip(self._chunks, self._alive)
                    if np.any(alive)]
            cols = Columns.concat(live)
            meta = {
                "revision": self.revision,
                "types": self.types.strings(),
                "relations": self.relations.strings(),
                "objects": {str(tid): it.strings()
                            for tid, it in self.objects.items()},
                "caveat_instances": [list(p)
                                     for p in self.caveat_instances],
            }
        return cols, meta

    @staticmethod
    def _state_arrays(cols: Columns, meta: dict) -> dict:
        """The snapshot's npz members: the eight columns and the meta
        JSON as uint8 (the reference's keys, so either package reads the
        other's snapshots)."""
        return {"rt": cols.rt, "rid": cols.rid, "rl": cols.rl,
                "st": cols.st, "sid": cols.sid, "srl": cols.srl,
                "exp": cols.exp, "cav": cols.cav,
                "meta": np.frombuffer(json.dumps(meta).encode(),
                                      dtype=np.uint8)}

    def save(self, path: str) -> int:
        """Persist the store to one compressed npz (live rows compacted
        into one chunk plus the interner string tables); returns the saved
        revision. The watch log is not persisted: a watcher resuming
        against a restored store must re-list."""
        cols, meta = self._collect_state()
        # a unique temp per save, streamed, fsynced, then renamed: the
        # checkpointer prunes WAL segments on the strength of this file
        fd, tmp = tempfile.mkstemp(
            dir=os.path.dirname(os.path.abspath(path)),
            prefix=os.path.basename(path) + ".tmp.")
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez_compressed(f, **self._state_arrays(cols, meta))
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        return int(meta["revision"])

    @staticmethod
    def encode_state(cols: Columns, meta: dict) -> bytes:
        """A ``_collect_state`` pair in the snapshot npz format, in memory
        (lock-free: the collected arrays are copies)."""
        bio = io.BytesIO()
        np.savez_compressed(bio, **Store._state_arrays(cols, meta))
        return bio.getvalue()

    def state_bytes(self) -> tuple[int, bytes]:
        """(revision, full-state payload): ``save``'s npz in memory."""
        cols, meta = self._collect_state()
        return int(meta["revision"]), self.encode_state(cols, meta)

    @staticmethod
    def _parse_state(z) -> tuple[dict, Columns]:
        # np.asarray, not astype: matching-dtype columns pass through, so
        # mmap-backed directory snapshots stay lazily paged
        names = z.files if hasattr(z, "files") else set(z.keys())
        meta = json.loads(bytes(np.asarray(z["meta"]).tobytes()).decode())
        cols = Columns(
            np.asarray(z["rt"], dtype=np.int32),
            np.asarray(z["rid"], dtype=np.int32),
            np.asarray(z["rl"], dtype=np.int32),
            np.asarray(z["st"], dtype=np.int32),
            np.asarray(z["sid"], dtype=np.int32),
            np.asarray(z["srl"], dtype=np.int32),
            np.asarray(z["exp"], dtype=np.float64),
            # snapshots from before caveats carry no cav column
            (np.asarray(z["cav"], dtype=np.int32)
             if "cav" in names else None),
        )
        return meta, cols

    def save_dir(self, path: str) -> int:
        """Save a snapshot as a ``persistence/codec.save`` directory (one
        flat ``.npy`` a column), the only layout ``load(..., mmap=True)``
        can memory-map. Returns the saved revision."""
        from ..persistence import codec

        cols, meta = self._collect_state()
        codec.save(path, self._state_arrays(cols, meta))
        return int(meta["revision"])

    def load(self, path: str, mmap: bool = False) -> None:
        """Replace this store's contents with a saved snapshot: the
        single-file npz, or a :meth:`save_dir` directory (with ``mmap``
        its columns are mapped read-only and paged in on demand)."""
        if os.path.isdir(path):
            from ..persistence import codec

            meta, cols = self._parse_state(codec.load(path, mmap=mmap))
        else:
            with np.load(path) as z:
                meta, cols = self._parse_state(z)
        self._install_state(meta, cols)

    def load_state_bytes(self, payload: bytes) -> None:
        """Replace this store's contents from a :meth:`state_bytes`
        payload, journaled as a ``load_state`` record."""
        with np.load(io.BytesIO(payload)) as z:
            meta, cols = self._parse_state(z)
        self._install_state(meta, cols, journal_payload=payload)

    def _install_state(self, meta: dict, cols: Columns,
                       journal_payload: Optional[bytes] = None) -> None:
        with self._lock:
            self.epoch = uuid.uuid4().hex  # cached id maps are now invalid
            self.types = Interner()
            for s in meta["types"]:
                self.types.intern(s)
            self.relations = Interner()
            for s in meta["relations"]:
                self.relations.intern(s)
            self.objects = {}
            for tid, strings in meta["objects"].items():
                it = Interner()
                for s in strings:
                    it.intern(s)
                self.objects[int(tid)] = it
            insts = meta.get("caveat_instances") or [["", ""]]
            self.caveat_instances = [tuple(p) for p in insts]
            self._caveat_key = {tuple(p): i for i, p in enumerate(insts)}
            self._chunks = [cols]
            self._alive = [np.ones(len(cols), dtype=bool)]
            self._index = StoreIndex()
            self._start_index_prebuild()
            # a restore may land on the SAME revision number with other
            # rows: the expiry watermark must not be served from the old
            self._expiry_bounds = None
            self._has_finite_exp = bool(np.isfinite(cols.exp).any())
            self.revision = int(meta["revision"])
            self.unlogged_revision = self.revision
            self._watch_log = []
            self._observe_revision()
            # watchers from before the restore must re-list + re-watch
            # (their revisions describe another lineage)
            self._watch_oldest_rev = self.revision
            if self.journal is not None and journal_payload is not None:
                self.journal({"kind": "load_state", "rev": self.revision},
                             journal_payload)
            self._watch_cond.notify_all()

    def snapshot(self) -> Snapshot:
        """Immutable columnar view of all live tuples for the compiler.
        Expired tuples are retained (with their timestamps) — the device
        fixpoint masks them against the query-time clock."""
        with self._lock:
            blocks = [
                cols.take(np.flatnonzero(alive))
                for cols, alive in zip(self._chunks, self._alive)
                if np.any(alive)
            ]
            # interners are monotone (never shrink / renumber), so sharing
            # them with an immutable snapshot is safe
            return Snapshot(
                revision=self.revision,
                cols=Columns.concat(blocks),
                types=self.types,
                relations=self.relations,
                objects=self.objects,
                caveat_instances=self.caveat_instances,
            )

    def __len__(self) -> int:
        return int(sum(int(a.sum()) for a in self._alive))
