"""Host-cold block arena.

A copy of the JAX package's ``storage/arena.py`` (the port imports nothing
of that package).

Cold blocks are stored as columnar COO payloads (``dst_local`` /
``src_local`` index columns, plus the ``base_*`` columns for closured
blocks) — ~8 bytes per edge, an order of magnitude smaller than the
dense ``int8`` cells they expand into on promotion. Two backings:

* **In-memory (default):** each block is one uncompressed ``.npz`` blob
  built exactly like ``persistence/codec.encode_bulk_cols`` (BytesIO +
  ``np.savez``, decoded with ``allow_pickle=False``). The blob
  duplicates the compiled graph's host COO for the block; that is the
  honest cost of keeping the arena self-contained, and it is what lets
  a future compile drop its host arrays entirely.
* **Spill directory:** each block becomes a ``codec.save`` directory of
  flat ``.npy`` columns, read back with ``codec.load(..., mmap=True)``
  so a stream-in touches pages on demand instead of materializing a
  second host copy (npz/zip members cannot be mmapped — see codec).
"""

from __future__ import annotations

import io
import os
import shutil
import threading
from typing import Dict, Optional

import numpy as np

from ..persistence import codec


class ColdArena:
    """Keyed store of cold block payloads (``{column: ndarray}``)."""

    def __init__(self, spill_dir: Optional[str] = None):
        self._lock = threading.Lock()
        self._blobs: Dict[int, bytes] = {}
        self._nbytes: Dict[int, int] = {}
        self._spill_dir = spill_dir
        if spill_dir is not None:
            os.makedirs(spill_dir, exist_ok=True)

    def _path(self, key: int) -> str:
        return os.path.join(self._spill_dir, "block-%d" % key)

    def put(self, key: int, arrays: Dict[str, np.ndarray]) -> int:
        """Store a block's columns; returns the payload size in bytes
        (host RAM for the in-memory backing, file bytes when spilled)."""
        arrays = {k: np.ascontiguousarray(v) for k, v in arrays.items()}
        if self._spill_dir is not None:
            n = codec.save(self._path(key), arrays)
            with self._lock:
                self._nbytes[key] = n
            return n
        bio = io.BytesIO()
        np.savez(bio, **arrays)
        blob = bio.getvalue()
        with self._lock:
            self._blobs[key] = blob
            self._nbytes[key] = len(blob)
        return len(blob)

    def get(self, key: int) -> Dict[str, np.ndarray]:
        """Decode one block's columns. Spilled blocks come back as
        read-only mmaps; in-memory blobs decode with allow_pickle=False
        (same trust boundary as the WAL codec)."""
        if self._spill_dir is not None:
            return codec.load(self._path(key), mmap=True)
        with self._lock:
            blob = self._blobs[key]
        with np.load(io.BytesIO(blob)) as z:
            return {k: z[k] for k in z.files}

    def has(self, key: int) -> bool:
        with self._lock:
            return key in self._nbytes

    def drop(self, key: int) -> None:
        with self._lock:
            self._blobs.pop(key, None)
            self._nbytes.pop(key, None)
        if self._spill_dir is not None:
            shutil.rmtree(self._path(key), ignore_errors=True)

    @property
    def nbytes(self) -> int:
        with self._lock:
            return sum(self._nbytes.values())

    def block_nbytes(self, key: int) -> int:
        with self._lock:
            return self._nbytes.get(key, 0)
