"""Snapshot checkpoints: background compaction of the WAL into restart
points.

A copy of the JAX package's ``persistence/snapshot.py`` (the port imports nothing
of that package).

Durability layer two of three. A checkpoint atomically serializes the
store's columnar chunks, interner tables, and revision counter (the
existing compacted ``.npz`` format from ``Store.save`` — write-temp +
rename, so a crash mid-checkpoint leaves only the previous snapshots)
into ``<dir>/snapshot-<revision 020d>.npz``, then prunes WAL segments
sealed at or below the OLDEST retained snapshot's revision. Pruning to
the oldest — not the newest — keeps enough log that recovery can fall
back a full snapshot generation on corruption and still replay forward
(recovery.py).

The checkpointer triggers when WAL bytes or records appended since the
last checkpoint cross a threshold; the work runs on a background thread
so the write path never pays snapshot serialization inline.
"""

from __future__ import annotations

import logging
import os
import re
import threading
import time
import uuid
from typing import Optional

from ..utils.metrics import metrics

log = logging.getLogger("sdbkp.torch.persistence.snapshot")

_SNAP_RE = re.compile(r"^snapshot-(\d{20})\.npz$")

DEFAULT_CHECKPOINT_WAL_BYTES = 64 << 20
DEFAULT_CHECKPOINT_WAL_RECORDS = 50_000
DEFAULT_KEEP = 2


def list_snapshots(snap_dir: str) -> list[tuple[int, str]]:
    """(revision, path) ascending; ignores temp and foreign files."""
    out = []
    try:
        names = os.listdir(snap_dir)
    except FileNotFoundError:
        return []
    for name in names:
        m = _SNAP_RE.match(name)
        if m:
            out.append((int(m.group(1)), os.path.join(snap_dir, name)))
    out.sort()
    return out


def write_snapshot(store, snap_dir: str) -> tuple[int, str]:
    """Checkpoint the store into the directory; returns (revision, path).
    Two atomic publishes: ``Store.save`` writes temp-then-rename to a
    scratch name (the saved revision is only known afterwards), then one
    more rename onto the revision-stamped final name."""
    os.makedirs(snap_dir, exist_ok=True)
    scratch = os.path.join(snap_dir, f".inprogress-{uuid.uuid4().hex}.npz")
    try:
        rev = store.save(scratch)
    except BaseException:
        try:
            os.unlink(scratch)
        except OSError:
            pass
        raise
    final = os.path.join(snap_dir, f"snapshot-{rev:020d}.npz")
    os.replace(scratch, final)
    # directory fsync so the rename itself survives power loss
    try:
        dfd = os.open(snap_dir, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:
        pass
    return rev, final


class Checkpointer:
    """Threshold-triggered background checkpoints + retention.

    ``notify(wal)`` is cheap (the WAL calls it per append, under no lock
    here); crossing a threshold wakes the worker thread, which
    checkpoints, drops snapshots beyond ``keep``, and prunes the WAL.
    """

    def __init__(self, store, wal, snap_dir: str,
                 wal_bytes: int = DEFAULT_CHECKPOINT_WAL_BYTES,
                 wal_records: int = DEFAULT_CHECKPOINT_WAL_RECORDS,
                 keep: int = DEFAULT_KEEP):
        self.store = store
        self.wal = wal
        self.snap_dir = snap_dir
        self.wal_bytes = int(wal_bytes)
        self.wal_records = int(wal_records)
        self.keep = max(1, int(keep))
        self._cond = threading.Condition()
        self._pending = False
        self._closed = False
        # appended totals at the last checkpoint (thresholds measure the
        # delta since then, not process lifetime)
        self._base_bytes = 0
        self._base_records = 0
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="store-checkpointer")
        self._thread.start()

    # -- triggers ------------------------------------------------------------

    def notify(self, wal) -> None:
        if (wal.appended_bytes - self._base_bytes < self.wal_bytes and
                wal.appended_records - self._base_records
                < self.wal_records):
            return
        self.request()

    def request(self) -> None:
        """Ask for an async checkpoint (idempotent while one is queued)."""
        with self._cond:
            if self._closed:
                return
            self._pending = True
            self._cond.notify()

    # -- worker --------------------------------------------------------------

    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._pending and not self._closed:
                    self._cond.wait()
                if self._closed and not self._pending:
                    return
                self._pending = False
            try:
                self.checkpoint()
            except Exception:
                log.exception("checkpoint failed (will retry on next "
                              "threshold crossing)")

    def checkpoint(self) -> int:
        """Synchronous checkpoint + retention + WAL prune; returns the
        checkpointed revision. Also the direct entry point for the final
        checkpoint on graceful shutdown."""
        t0 = time.perf_counter()
        # make everything up to the checkpointed revision durable BEFORE
        # the snapshot exists: the snapshot will justify pruning those
        # records, so they must not be sitting in an un-fsynced buffer
        self.wal.sync()
        self._base_bytes = self.wal.appended_bytes
        self._base_records = self.wal.appended_records
        rev, path = write_snapshot(self.store, self.snap_dir)
        dur = time.perf_counter() - t0
        metrics.counter("checkpoints_total").inc()
        metrics.histogram("checkpoint_duration_seconds").observe(dur)
        snaps = list_snapshots(self.snap_dir)
        for old_rev, old_path in snaps[:-self.keep]:
            try:
                os.unlink(old_path)
            except OSError:
                log.exception("failed to drop old snapshot %s", old_path)
        kept = list_snapshots(self.snap_dir)
        if kept:
            self.wal.prune_upto(kept[0][0])
        log.info("checkpointed revision %d in %.3fs (%s)", rev, dur, path)
        return rev

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify()
        self._thread.join(timeout=60.0)
