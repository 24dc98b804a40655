"""Segmented write-ahead log of logical store mutations.

A copy of the JAX package's ``persistence/wal.py`` (the port imports nothing
of that package).

Durability layer one of three (wal.py / snapshot.py / recovery.py): every
revision-advancing store mutation — write, delete-by-filter, bulk load,
catch-up apply — is journaled as one length-prefixed, CRC32-checked frame
BEFORE the caller's transaction returns, so an acknowledged write survives
SIGKILL. This mirrors how production graph stores persist their matrix
representation (RedisGraph serializes its GraphBLAS matrices + a
replication log to disk, PAPERS.md) rather than treating the in-memory
columns as the source of truth.

Layout: ``<dir>/wal-<first-revision 020d>.seg`` files, each starting with
an 8-byte magic. A frame is ``>II`` (payload length, CRC32 of payload)
followed by the payload. A payload is either plain JSON (starts with
``{``) or the binary convention shared with the remote protocol
(engine/remote.py): ``0x00`` + 4-byte meta length + meta JSON + blob —
bulk-load column payloads ride the binary form instead of inflating
through per-cell JSON.

Fsync policy (``--wal-fsync``):

- ``always``       — fsync after every append; an acked write survives
                     power loss, at one fsync of latency per write.
- ``interval:<ms>``— appends flush to the OS; a background syncer fsyncs
                     at most every <ms> (default policy, 100ms): SIGKILL
                     of the process loses nothing (the OS has the bytes),
                     whole-machine power loss can lose the last window.
- ``off``          — no fsync until close/rotate; fastest, bench/tests.

Segments rotate at ``segment_bytes``; sealed segments are immutable and
become prunable once a snapshot checkpoint covers their highest revision
(snapshot.py decides when, :meth:`WriteAheadLog.prune_upto` executes).
"""

from __future__ import annotations

import json
import logging
import os
import re
import struct
import threading
import time
import zlib
from typing import Iterator, Optional

from ..utils.metrics import metrics

log = logging.getLogger("sdbkp.torch.persistence.wal")

MAGIC = b"SDBKWAL1"
_FRAME_HDR = struct.Struct(">II")  # payload length, crc32(payload)
_SEG_RE = re.compile(r"^wal-(\d{20})\.seg$")

FSYNC_ALWAYS = "always"
FSYNC_INTERVAL = "interval"
FSYNC_OFF = "off"

DEFAULT_FSYNC = "interval:100"
DEFAULT_SEGMENT_BYTES = 64 << 20

# an absurdly large frame means a corrupt length header, not a record
MAX_WAL_FRAME = 1 << 31


class WalError(Exception):
    pass


def parse_fsync_policy(spec: str) -> tuple[str, float]:
    """``always`` | ``off`` | ``interval:<ms>`` -> (mode, interval_s).
    The ONE owner of the flag format — proxy options and the engine-host
    CLI both validate through here."""
    s = (spec or "").strip().lower()
    if s == FSYNC_ALWAYS:
        return FSYNC_ALWAYS, 0.0
    if s == FSYNC_OFF:
        return FSYNC_OFF, 0.0
    if s.startswith(FSYNC_INTERVAL + ":"):
        try:
            ms = float(s.split(":", 1)[1])
        except ValueError:
            ms = -1.0
        if ms > 0:
            return FSYNC_INTERVAL, ms / 1000.0
    raise WalError(
        f"invalid wal fsync policy {spec!r} "
        "(expected always | interval:<ms> | off)")


def _pack_payload(meta: dict, blob: Optional[bytes]) -> bytes:
    m = json.dumps(meta, separators=(",", ":")).encode()
    if blob is None:
        return m
    return b"\x00" + struct.pack(">I", len(m)) + m + blob


def _unpack_payload(payload: bytes) -> tuple[dict, Optional[bytes]]:
    if payload[:1] == b"\x00":
        (m,) = struct.unpack(">I", payload[1:5])
        return json.loads(payload[5:5 + m]), payload[5 + m:]
    return json.loads(payload), None


def list_segments(wal_dir: str) -> list[tuple[int, str]]:
    """(first_revision, path) ascending; ignores non-segment files."""
    out = []
    try:
        names = os.listdir(wal_dir)
    except FileNotFoundError:
        return []
    for name in names:
        m = _SEG_RE.match(name)
        if m:
            out.append((int(m.group(1)), os.path.join(wal_dir, name)))
    out.sort()
    return out


def total_bytes(wal_dir: str) -> int:
    return sum(os.path.getsize(p) for _, p in list_segments(wal_dir)
               if os.path.exists(p))


def _replay_segment(path: str, is_last: bool, truncate_torn: bool
                    ) -> Iterator[tuple[dict, Optional[bytes]]]:
    """Yield (meta, blob) frames from one segment. A torn or corrupt tail
    in the LAST segment is truncated back to the previous frame boundary
    (the kill-mid-write case); corruption mid-history raises."""
    with open(path, "rb") as f:
        magic = f.read(len(MAGIC))
        if magic != MAGIC:
            if is_last and len(magic) < len(MAGIC) and truncate_torn:
                # a segment file created but killed before the magic
                # finished landing: nothing recoverable here — remove it
                # so a later append can reuse its revision-stamped name
                log.warning("removing torn segment stub %s", path)
                _remove(path)
                return
            raise WalError(f"{path}: bad segment magic {magic!r}")
        offset = len(MAGIC)
        while True:
            hdr = f.read(_FRAME_HDR.size)
            if not hdr:
                return  # clean end
            torn = len(hdr) < _FRAME_HDR.size
            if not torn:
                n, crc = _FRAME_HDR.unpack(hdr)
                if n > MAX_WAL_FRAME:
                    torn = True  # garbage length header
                else:
                    payload = f.read(n)
                    torn = len(payload) < n or \
                        zlib.crc32(payload) != crc
            if torn:
                if not is_last:
                    raise WalError(
                        f"{path}: corrupt frame at offset {offset} in a "
                        "sealed (non-final) segment")
                if truncate_torn:
                    if offset == len(MAGIC):
                        # the tear took the segment's FIRST frame: a
                        # truncated-but-kept file would collide with the
                        # re-append of the revision it is named after
                        # (_rotate_locked refuses to overwrite segments)
                        log.warning("removing frame-less torn segment %s",
                                    path)
                        _remove(path)
                    else:
                        log.warning(
                            "truncating torn WAL tail of %s at byte %d",
                            path, offset)
                        _truncate(path, offset)
                return
            offset += _FRAME_HDR.size + n
            yield _unpack_payload(payload)


def _truncate(path: str, size: int) -> None:
    with open(path, "r+b") as f:
        f.truncate(size)
        f.flush()
        os.fsync(f.fileno())


def _remove(path: str) -> None:
    try:
        os.unlink(path)
    except OSError:
        log.exception("failed to remove torn segment %s", path)


def replay(wal_dir: str, from_revision: int = 0,
           truncate_torn: bool = True
           ) -> Iterator[tuple[dict, Optional[bytes]]]:
    """Iterate journal records with ``rev > from_revision`` across all
    segments in order, applying torn-tail truncation to the newest one."""
    segs = list_segments(wal_dir)
    for i, (_, path) in enumerate(segs):
        for meta, blob in _replay_segment(path, i == len(segs) - 1,
                                          truncate_torn):
            if int(meta.get("rev", 0)) > from_revision:
                yield meta, blob


class WriteAheadLog:
    """Append end of the log. Opening always begins a FRESH segment on
    the first append (named by that record's revision) — recovery may
    have truncated the previous tail, and appends must never land in a
    file another process half-wrote. Thread-safe; the store calls
    :meth:`append` under its own write lock, so frame order == revision
    order by construction."""

    def __init__(self, wal_dir: str, fsync: str = DEFAULT_FSYNC,
                 segment_bytes: int = DEFAULT_SEGMENT_BYTES,
                 on_append=None):
        self.dir = wal_dir
        self.mode, self.interval = parse_fsync_policy(fsync)
        self.segment_bytes = int(segment_bytes)
        self.on_append = on_append  # checkpointer trigger
        os.makedirs(wal_dir, exist_ok=True)
        self._lock = threading.Lock()
        self._f = None
        self._seg_path: Optional[str] = None
        self._seg_size = 0
        self._dirty = False
        self._closed = False
        # monotonic totals this process, for checkpoint thresholds
        self.appended_bytes = 0
        self.appended_records = 0
        self.last_revision = 0
        # live bytes currently on disk (recovered tail + appends - prunes)
        self._disk_bytes = total_bytes(wal_dir)
        metrics.gauge("wal_bytes").set(self._disk_bytes)
        self._sync_thread: Optional[threading.Thread] = None
        self._sync_stop = threading.Event()
        if self.mode == FSYNC_INTERVAL:
            t = threading.Thread(target=self._sync_loop, daemon=True,
                                 name="wal-fsync")
            self._sync_thread = t
            t.start()

    # -- append path ---------------------------------------------------------

    def append(self, meta: dict, blob: Optional[bytes] = None) -> None:
        rev = int(meta["rev"])
        payload = _pack_payload(meta, blob)
        if len(payload) > MAX_WAL_FRAME:
            # replay classifies length headers past this bound as torn
            # garbage — appending one would be written "successfully" and
            # then silently truncated away at the next recovery
            raise WalError(
                f"journal record of {len(payload)} bytes exceeds the "
                f"{MAX_WAL_FRAME}-byte frame bound")
        frame = _FRAME_HDR.pack(len(payload), zlib.crc32(payload)) + payload
        with self._lock:
            if self._closed:
                raise WalError("write-ahead log is closed")
            if self._f is None or self._seg_size >= self.segment_bytes:
                self._rotate_locked(rev)
            self._f.write(frame)
            self._dirty = True
            self._seg_size += len(frame)
            self.appended_bytes += len(frame)
            self.appended_records += 1
            self._disk_bytes += len(frame)
            self.last_revision = rev
            if self.mode == FSYNC_ALWAYS:
                self._sync_locked()
            else:
                self._f.flush()  # SIGKILL-safe either way; fsync policy
                # only governs power-loss durability
            disk = self._disk_bytes
        metrics.counter("wal_appends_total").inc()
        metrics.gauge("wal_bytes").set(disk)
        if self.on_append is not None:
            self.on_append(self)

    def _rotate_locked(self, first_rev: int) -> None:
        if self._f is not None:
            self._sync_locked()
            self._f.close()
        path = os.path.join(self.dir, f"wal-{first_rev:020d}.seg")
        if os.path.exists(path):
            raise WalError(f"segment {path} already exists "
                           "(another writer on this data dir?)")
        self._f = open(path, "wb")
        self._f.write(MAGIC)
        self._seg_path = path
        self._seg_size = len(MAGIC)
        self.appended_bytes += len(MAGIC)
        self._disk_bytes += len(MAGIC)

    def _sync_locked(self) -> None:
        if self._f is None or not self._dirty:
            return
        t0 = time.perf_counter()
        self._f.flush()
        os.fsync(self._f.fileno())
        self._dirty = False
        metrics.histogram("wal_fsync_seconds").observe(
            time.perf_counter() - t0)

    def sync(self) -> None:
        """Flush + fsync whatever has been appended so far."""
        with self._lock:
            self._sync_locked()

    def _sync_loop(self) -> None:
        while not self._sync_stop.wait(self.interval):
            try:
                self.sync()
            except OSError:
                log.exception("background wal fsync failed")

    # -- maintenance ---------------------------------------------------------

    def prune_upto(self, revision: int) -> int:
        """Delete sealed segments whose every record is at or below
        ``revision`` (provable from the NEXT segment's first-revision
        name — records are revision-ordered). The active segment is never
        pruned. Returns segments removed."""
        removed = 0
        with self._lock:
            segs = list_segments(self.dir)
            for (_, path), (next_first, _) in zip(segs, segs[1:]):
                if path == self._seg_path:
                    break
                if next_first <= revision + 1:
                    try:
                        os.unlink(path)
                        removed += 1
                    except OSError:
                        log.exception("failed to prune %s", path)
                else:
                    break
            self._disk_bytes = total_bytes(self.dir)
            disk = self._disk_bytes
        metrics.gauge("wal_bytes").set(disk)
        return removed

    def close(self) -> None:
        self._sync_stop.set()
        if self._sync_thread is not None:
            self._sync_thread.join(timeout=5.0)
        with self._lock:
            if self._closed:
                return
            self._closed = True
            if self._f is not None:
                try:
                    self._sync_locked()
                finally:
                    self._f.close()
                    self._f = None
