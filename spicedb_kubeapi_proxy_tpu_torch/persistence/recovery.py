"""Crash recovery: newest valid snapshot + WAL tail replay.

A copy of the JAX package's ``persistence/recovery.py`` (the port imports nothing
of that package).

Durability layer three of three. On boot:

1. Try snapshots newest-first; a snapshot that fails to load (truncated
   file, bad zip, mangled meta) is logged and skipped — the checkpointer
   retains ``keep`` generations and prunes the WAL only up to the OLDEST
   retained one, so falling back a generation always leaves enough log
   to replay forward.
2. Replay WAL records with ``rev`` past the loaded snapshot, with
   torn-tail truncation (wal.py) for the kill-mid-append case.
3. Enforce revision monotonicity: every replayed record must advance the
   revision, and the recovered counter resumes ABOVE every revision ever
   acknowledged — a post-restart write can never mint a revision that
   collides with a pre-restart decision-cache key (engine/decision_cache
   keys are ``(kind, revision, query)``; a reused revision with different
   rows would silently serve the dead lineage's verdicts).
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Optional

from ..utils.metrics import metrics
from . import wal as walmod
from .codec import decode_bulk_cols
from .snapshot import list_snapshots

log = logging.getLogger("sdbkp.torch.persistence.recovery")


class RecoveryError(Exception):
    pass


@dataclass
class RecoveryResult:
    revision: int = 0
    snapshot_revision: int = 0
    snapshot_path: Optional[str] = None
    corrupt_snapshots: list = field(default_factory=list)
    replayed_records: int = 0
    duration_s: float = 0.0


def apply_record(store, meta: dict, blob: Optional[bytes]) -> None:
    """Apply ONE journal record to the store at its recorded revision.
    Shared with nothing else on purpose: the journal kinds are written in
    exactly one place (Store) and replayed in exactly one place (here)."""
    kind = meta.get("kind")
    rev = int(meta["rev"])
    if kind in ("write", "delete", "apply"):
        store.apply_effects(meta["effects"], rev)
    elif kind == "bulk_load":
        if blob is None:
            raise RecoveryError(
                f"bulk_load record at revision {rev} has no column payload")
        store.bulk_load(decode_bulk_cols(blob), _revision=rev)
    elif kind == "load_state":
        if blob is None:
            raise RecoveryError(
                f"load_state record at revision {rev} has no payload")
        store.load_state_bytes(blob)
    else:
        raise RecoveryError(f"unknown journal record kind {kind!r}")


def recover(store, data_dir: str) -> RecoveryResult:
    """Restore ``store`` from ``data_dir`` (layout: manager.py). The
    store must be otherwise idle — recovery runs before the engine
    serves. Returns what happened; raises :class:`RecoveryError` only on
    monotonicity violations (a broken log is worse served by guessing)."""
    import os

    t0 = time.perf_counter()
    res = RecoveryResult()
    snap_dir = os.path.join(data_dir, "snapshots")
    wal_dir = os.path.join(data_dir, "wal")

    for rev, path in reversed(list_snapshots(snap_dir)):
        try:
            store.load(path)
            res.snapshot_revision = rev
            res.snapshot_path = path
            break
        except Exception as e:  # corrupt snapshot: fall back a generation
            log.warning("snapshot %s unreadable (%s: %s); falling back",
                        path, type(e).__name__, e)
            res.corrupt_snapshots.append(path)

    last = store.revision
    try:
        for meta, blob in walmod.replay(wal_dir, from_revision=last):
            rev = int(meta["rev"])
            if rev <= last:
                raise RecoveryError(
                    f"WAL revision went backwards: {rev} after {last}")
            if rev != last + 1:
                # revisions are journaled densely; a hole means lost
                # segments — keep going (later state is still newer than
                # stopping here) but say so loudly
                log.warning("WAL revision gap: %d -> %d (pruned or lost "
                            "segment?)", last, rev)
            apply_record(store, meta, blob)
            last = rev
            res.replayed_records += 1
    except walmod.WalError as e:
        # mid-history corruption (a SEALED segment failed its CRC —
        # distinct from the torn tail, which wal.replay truncates and
        # tolerates): fail CLOSED. Serving here would strand every
        # record journaled after the corrupt segment — including writes
        # the new process would go on to acknowledge — as permanently
        # unreplayable on all future boots, compounding the loss while
        # reporting healthy. The operator must repair or discard the
        # log (the error names the segment).
        raise RecoveryError(
            f"unrecoverable WAL corruption mid-history: {e}; repair or "
            "remove the named segment (acknowledged writes after it "
            "would otherwise be silently lost)") from e

    res.revision = store.revision
    res.duration_s = time.perf_counter() - t0
    if res.replayed_records:
        metrics.counter("recovery_replayed_records_total").inc(
            res.replayed_records)
    metrics.histogram("recovery_duration_seconds").observe(res.duration_s)
    log.info(
        "recovered revision %d (%d rows) from %s + %d WAL records in %.3fs",
        res.revision, len(store), res.snapshot_path or "empty store",
        res.replayed_records, res.duration_s)
    return res
