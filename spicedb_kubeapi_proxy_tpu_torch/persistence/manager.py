"""Persistence manager: the one object an engine owns when ``--data-dir``
is configured.

A copy of the JAX package's ``persistence/manager.py`` (the port imports nothing
of that package).

``Persistence.open(store, data_dir)`` runs crash recovery (recovery.py),
opens the WAL for append (wal.py), installs the store's journal hook so
every subsequent revision-advancing mutation is logged before its
transaction returns, and starts the background checkpointer
(snapshot.py). ``close()`` unhooks, takes a final checkpoint (so the
next boot replays nothing), and fsyncs.

Directory layout::

    <data-dir>/
      wal/        wal-<first-revision>.seg ...
      snapshots/  snapshot-<revision>.npz ...
      dtx.sqlite  (the dual-write workflow DB, wired by proxy options)

Persistence is strictly opt-in: with no data dir configured the store
behaves exactly as before — in-memory, revision counter reset on boot —
which is what every existing test and the embedded engine get.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

from .recovery import RecoveryResult, recover
from .snapshot import (
    Checkpointer,
    DEFAULT_CHECKPOINT_WAL_BYTES,
    DEFAULT_CHECKPOINT_WAL_RECORDS,
    DEFAULT_KEEP,
)
from .wal import DEFAULT_FSYNC, DEFAULT_SEGMENT_BYTES, WriteAheadLog

log = logging.getLogger("sdbkp.torch.persistence")

# replication-term file (leader failover, parallel/failover.py): one
# line of JSON, written atomically + fsynced on every bump so a fencing
# decision survives SIGKILL — a restarted process must never come back
# believing an older term than the one it acted under
TERM_FILE = "term"


def load_term(data_dir: str) -> int:
    """The highest replication term this data dir has adopted (0 when
    never set / no durable state)."""
    import json

    try:
        with open(os.path.join(data_dir, TERM_FILE)) as f:
            return int(json.load(f)["term"])
    except (OSError, ValueError, KeyError, TypeError):
        # TypeError: valid-JSON-but-not-an-object content ("5", "[7]")
        return 0


def store_term(data_dir: str, term: int) -> None:
    """Durably adopt ``term`` (atomic tmp + rename + fsync): after this
    returns, no crash can roll the process back into accepting frames
    from a lineage it already fenced off."""
    import json
    import tempfile

    os.makedirs(data_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=data_dir, prefix=TERM_FILE + ".tmp.")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump({"term": int(term)}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(data_dir, TERM_FILE))
        dfd = os.open(data_dir, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


class Persistence:
    """Owns the WAL + checkpointer for one store. Construct via
    :meth:`open`."""

    def __init__(self, store, data_dir: str, wal: WriteAheadLog,
                 checkpointer: Optional[Checkpointer],
                 recovery: RecoveryResult):
        self.store = store
        self.data_dir = data_dir
        self.wal = wal
        self.checkpointer = checkpointer
        self.recovery = recovery
        self._closed = False
        # construction parameters, kept so a lineage rebase (leader
        # failover: a full-state catch-up superseding local history) can
        # reopen a byte-fresh WAL + checkpointer with identical policy
        self._params: dict = {}

    @classmethod
    def open(cls, store, data_dir: str,
             wal_fsync: str = DEFAULT_FSYNC,
             segment_bytes: int = DEFAULT_SEGMENT_BYTES,
             checkpoint_wal_bytes: int = DEFAULT_CHECKPOINT_WAL_BYTES,
             checkpoint_wal_records: int = DEFAULT_CHECKPOINT_WAL_RECORDS,
             checkpoint_keep: int = DEFAULT_KEEP,
             auto_checkpoint: bool = True) -> "Persistence":
        os.makedirs(data_dir, exist_ok=True)
        wal_dir = os.path.join(data_dir, "wal")
        snap_dir = os.path.join(data_dir, "snapshots")
        res = recover(store, data_dir)
        wal = WriteAheadLog(wal_dir, fsync=wal_fsync,
                            segment_bytes=segment_bytes)
        cp = None
        if auto_checkpoint:
            cp = Checkpointer(store, wal, snap_dir,
                              wal_bytes=checkpoint_wal_bytes,
                              wal_records=checkpoint_wal_records,
                              keep=checkpoint_keep)
            wal.on_append = cp.notify
            if res.replayed_records >= checkpoint_wal_records:
                # a crash left a long un-checkpointed tail; fold it into
                # a snapshot asynchronously so the NEXT boot is fast
                cp.request()
        p = cls(store, data_dir, wal, cp, res)
        p._params = dict(
            wal_fsync=wal_fsync, segment_bytes=segment_bytes,
            checkpoint_wal_bytes=checkpoint_wal_bytes,
            checkpoint_wal_records=checkpoint_wal_records,
            checkpoint_keep=checkpoint_keep,
            auto_checkpoint=auto_checkpoint)
        store.journal = p._journal
        return p

    # -- the store's journal hook (called under the store write lock) --------

    def _journal(self, meta: dict, blob: Optional[bytes] = None) -> None:
        self.wal.append(meta, blob)

    # -- lineage rebase (leader failover) ------------------------------------

    def rebase(self, state_payload: bytes) -> None:
        """Adopt a full-state catch-up transfer as a NEW LINEAGE
        baseline (parallel/multihost.py ``apply_catchup``): a demoted
        leader's (or far-behind follower's) local WAL + snapshots
        describe superseded history whose revision numbers may overlap
        the incoming lineage's — keeping them would make the next boot's
        replay see revisions go backwards and fail closed. Discard them,
        install the transferred state, and restart the log with that
        baseline as its first (journaled, fsynced) record.

        Crash window: a kill between the wipe and the re-journal leaves
        an empty data dir — the follower then rejoins from revision 0
        and re-fetches the same transfer. Nothing of the NEW lineage is
        ever lost, and everything discarded of the old one was fenced
        off by a higher term already."""
        store = self.store
        # bound-method EQUALITY, not identity: each attribute access
        # mints a fresh bound-method object, so `is` never matches
        detached = getattr(store, "journal", None) == self._journal
        if detached:
            store.journal = None  # install must not journal mid-rebase
        if self.checkpointer is not None:
            self.checkpointer.close()
        self.wal.close()
        wal_dir = os.path.join(self.data_dir, "wal")
        snap_dir = os.path.join(self.data_dir, "snapshots")
        removed = 0
        for d in (wal_dir, snap_dir):
            try:
                names = os.listdir(d)
            except FileNotFoundError:
                continue
            for name in names:
                try:
                    os.unlink(os.path.join(d, name))
                    removed += 1
                except OSError:
                    log.exception("rebase: failed to remove %s/%s", d,
                                  name)
        store.load_state_bytes(state_payload)
        self.wal = WriteAheadLog(wal_dir, fsync=self._params["wal_fsync"],
                                 segment_bytes=self._params["segment_bytes"])
        if self._params.get("auto_checkpoint", True):
            self.checkpointer = Checkpointer(
                store, self.wal, snap_dir,
                wal_bytes=self._params["checkpoint_wal_bytes"],
                wal_records=self._params["checkpoint_wal_records"],
                keep=self._params["checkpoint_keep"])
            self.wal.on_append = self.checkpointer.notify
        self._journal({"kind": "load_state", "rev": store.revision},
                      state_payload)
        self.wal.sync()  # the baseline is the lineage: make it durable NOW
        if detached:
            store.journal = self._journal
        log.info("rebased lineage at revision %d (%d old files discarded)",
                 store.revision, removed)

    # -- lifecycle -----------------------------------------------------------

    def checkpoint_now(self) -> int:
        """Synchronous checkpoint (graceful shutdown, tests)."""
        if self.checkpointer is not None:
            return self.checkpointer.checkpoint()
        from .snapshot import write_snapshot

        self.wal.sync()
        rev, _ = write_snapshot(self.store,
                                os.path.join(self.data_dir, "snapshots"))
        return rev

    def close(self, final_checkpoint: bool = True) -> None:
        """Detach from the store and shut the WAL down cleanly. With
        ``final_checkpoint`` the store is snapshotted first so the next
        boot loads one file and replays zero records."""
        if self._closed:
            return
        self._closed = True
        # == not `is`: attribute access mints fresh bound-method objects
        if getattr(self.store, "journal", None) == self._journal:
            self.store.journal = None
        try:
            if final_checkpoint and self.wal.appended_records:
                self.checkpoint_now()
        except Exception:
            log.exception("final checkpoint failed; WAL tail remains "
                          "authoritative")
        if self.checkpointer is not None:
            self.checkpointer.close()
        self.wal.close()
