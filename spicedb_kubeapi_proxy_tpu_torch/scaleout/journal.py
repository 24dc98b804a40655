"""Durable intent journal for cross-shard split writes.

A write whose tuples span shards loses single-store atomicity: the
planner applies one per-shard sub-write at a time through each group's
ordinary WAL/ack path. This journal is the dtx-style safety net around
that split — the same event-sourced idea as ``dtx/runner.py``'s workflow
log, specialized to the one deterministic workflow a split write is:

1. ``begin()`` records the FULL per-shard plan (ops + preconditions +
   map version) durably BEFORE the first shard is touched;
2. ``mark_applied()`` records each shard's completion as its group acks;
3. ``finish()`` deletes the entry once every shard has applied.

A crash mid-split leaves the entry with a partial ``applied`` set; the
next planner over the same journal replays the REMAINING shards to
completion (``pending()``), with creates degraded to touches so the
replay is idempotent against a shard that applied but crashed before
``mark_applied`` landed. Fail-closed direction: a split is either
completed or still visibly pending — never silently half-applied.
"""

from __future__ import annotations

import json
import os
import sqlite3
import threading
import time
import uuid

from ..utils.metrics import metrics


class SplitJournal:
    """SQLite-backed (same durability story as the dtx workflow DB —
    and defaulting to the same directory). Thread-safe: the planner's
    scatter pool shares one connection under a lock."""

    def __init__(self, db_path: str):
        self.db_path = db_path
        d = os.path.dirname(os.path.abspath(db_path))
        os.makedirs(d, exist_ok=True)
        self._lock = threading.Lock()
        self._db = sqlite3.connect(db_path, check_same_thread=False)
        self._db.execute(
            "CREATE TABLE IF NOT EXISTS split_writes ("
            " id TEXT PRIMARY KEY,"
            " created REAL NOT NULL,"
            " map_version INTEGER NOT NULL,"
            " plan TEXT NOT NULL,"       # JSON {shard: [op dicts...]}
            " preconditions TEXT NOT NULL,"
            " applied TEXT NOT NULL,"    # JSON [shard, ...]
            # rebalance dual-writes are journaled under BOTH versions:
            # the map the split routed by and the transition's target
            # (NULL outside a rebalance window) — so replay after a
            # mid-window crash knows the recorded owners are already
            # the union of both placements, not a stale single-map plan
            " map_version_to INTEGER)")
        self._migrate()
        # the live-rebalance transition record: at most ONE row — the
        # tuple mover persists every slice-state change here before it
        # takes routing effect (the crash matrix's source of truth)
        self._db.execute(
            "CREATE TABLE IF NOT EXISTS rebalance_transition ("
            " id INTEGER PRIMARY KEY CHECK (id = 0),"
            " updated REAL NOT NULL,"
            " doc TEXT NOT NULL)")
        # the planner's coordinated schema-migration record: same
        # single-row persist-before-effect discipline on the schema axis
        # (migration/migrator.py holds each group's per-engine record;
        # this one holds the cross-group cut decision)
        self._db.execute(
            "CREATE TABLE IF NOT EXISTS schema_migration ("
            " id INTEGER PRIMARY KEY CHECK (id = 0),"
            " updated REAL NOT NULL,"
            " doc TEXT NOT NULL)")
        self._db.commit()

    def _migrate(self) -> None:
        """Journals created before the rebalance PR lack the
        ``map_version_to`` column; add it in place (NULL for every
        pre-existing entry — exactly the "no transition" meaning)."""
        cols = {r[1] for r in self._db.execute(
            "PRAGMA table_info(split_writes)").fetchall()}
        if "map_version_to" not in cols:
            self._db.execute("ALTER TABLE split_writes "
                             "ADD COLUMN map_version_to INTEGER")

    # -- write path ----------------------------------------------------------

    def begin(self, plan: dict, preconditions: list,
              map_version: int,
              map_version_to: "int | None" = None) -> str:
        """Durably record the split BEFORE any shard applies; returns
        the entry id. ``plan`` maps shard index -> serialized op list.
        ``map_version_to`` tags splits planned inside a rebalance
        window with the transition's target version."""
        sid = uuid.uuid4().hex
        with self._lock:
            self._db.execute(
                "INSERT INTO split_writes VALUES (?,?,?,?,?,?,?)",
                (sid, time.time(), map_version,
                 json.dumps({str(k): v for k, v in plan.items()}),
                 json.dumps(preconditions), json.dumps([]),
                 map_version_to))
            self._db.commit()
        metrics.counter("scaleout_split_writes_total").inc()
        return sid

    def mark_applied(self, sid: str, shard: int) -> None:
        with self._lock:
            row = self._db.execute(
                "SELECT applied FROM split_writes WHERE id=?",
                (sid,)).fetchone()
            if row is None:
                return
            applied = set(json.loads(row[0]))
            applied.add(int(shard))
            self._db.execute(
                "UPDATE split_writes SET applied=? WHERE id=?",
                (json.dumps(sorted(applied)), sid))
            self._db.commit()

    def finish(self, sid: str) -> None:
        with self._lock:
            self._db.execute("DELETE FROM split_writes WHERE id=?",
                             (sid,))
            self._db.commit()

    # -- recovery ------------------------------------------------------------

    def pending(self) -> list[dict]:
        """Every unfinished split, oldest first: ``{id, map_version,
        map_version_to, plan: {shard int: [op dicts]}, preconditions,
        applied: set}``."""
        with self._lock:
            rows = self._db.execute(
                "SELECT id, map_version, plan, preconditions, applied, "
                "map_version_to FROM split_writes "
                "ORDER BY created").fetchall()
        out = []
        for sid, ver, plan, pcs, applied, ver_to in rows:
            out.append({
                "id": sid,
                "map_version": int(ver),
                "map_version_to": (None if ver_to is None
                                   else int(ver_to)),
                "plan": {int(k): v
                         for k, v in json.loads(plan).items()},
                "preconditions": json.loads(pcs),
                "applied": set(json.loads(applied)),
            })
        return out

    def pending_count(self) -> int:
        with self._lock:
            (n,) = self._db.execute(
                "SELECT COUNT(*) FROM split_writes").fetchone()
        return int(n)

    # -- rebalance transition record -----------------------------------------

    def save_transition(self, doc: dict) -> None:
        """Upsert THE transition record (one live transition at a
        time); called before every slice-state change takes routing
        effect, so a crash recovers to the exact persisted phase."""
        with self._lock:
            self._db.execute(
                "INSERT INTO rebalance_transition (id, updated, doc) "
                "VALUES (0, ?, ?) ON CONFLICT(id) DO UPDATE SET "
                "updated=excluded.updated, doc=excluded.doc",
                (time.time(), json.dumps(doc)))
            self._db.commit()

    def load_transition(self) -> "dict | None":
        with self._lock:
            row = self._db.execute(
                "SELECT doc FROM rebalance_transition WHERE id=0"
            ).fetchone()
        return None if row is None else json.loads(row[0])

    def clear_transition(self) -> None:
        with self._lock:
            self._db.execute("DELETE FROM rebalance_transition")
            self._db.commit()

    # -- coordinated schema-migration record ---------------------------------

    def save_migration(self, doc: dict) -> None:
        """Upsert THE cross-group migration record (one live migration
        at a time): persisted before the planner issues any
        routing-effect change to the groups, so a planner crash
        recovers to the exact coordination phase."""
        with self._lock:
            self._db.execute(
                "INSERT INTO schema_migration (id, updated, doc) "
                "VALUES (0, ?, ?) ON CONFLICT(id) DO UPDATE SET "
                "updated=excluded.updated, doc=excluded.doc",
                (time.time(), json.dumps(doc)))
            self._db.commit()

    def load_migration(self) -> "dict | None":
        with self._lock:
            row = self._db.execute(
                "SELECT doc FROM schema_migration WHERE id=0"
            ).fetchone()
        return None if row is None else json.loads(row[0])

    def clear_migration(self) -> None:
        with self._lock:
            self._db.execute("DELETE FROM schema_migration")
            self._db.commit()

    def close(self) -> None:
        with self._lock:
            self._db.close()
