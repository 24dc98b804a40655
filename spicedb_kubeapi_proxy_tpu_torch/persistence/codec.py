"""Binary codec for columnar relationship payloads.

A copy of the JAX package's ``persistence/codec.py`` (the port imports nothing
of that package).

One encoding, three consumers: WAL ``bulk_load`` frames (wal.py), the
multi-host mirror's bulk-load frames (parallel/multihost.py — replacing
the per-element ``str()`` JSON lists that serialized one Python string
per cell), and the leader->follower full-state catch-up transfer
(engine/remote.py ``mirror_subscribe`` with ``from_revision``).

The container is an uncompressed ``.npz`` written to memory: fixed-width
numpy string columns pass through zero-copy-ish, and ``np.load`` with its
default ``allow_pickle=False`` guarantees no code execution on the decode
side — the encoder never produces object arrays.
"""

from __future__ import annotations

import io
import os
import tempfile

import numpy as np


def _string_column(v) -> np.ndarray:
    """Coerce a column of ids/types to a fixed-width numpy string array.
    ndarray 'S'/'U' columns keep their layout; lists and object arrays
    (the trust-boundary case: elements may be bytes or non-strings) are
    normalized element-wise — the slow path only runs for inputs that
    were never fixed-width to begin with."""
    if isinstance(v, np.ndarray) and v.dtype.kind in "SU":
        return v
    items = v.tolist() if isinstance(v, np.ndarray) else list(v)
    out = [x.decode(errors="surrogateescape")
           if isinstance(x, (bytes, bytearray)) else str(x)
           for x in items]
    return np.asarray(out, dtype=str) if out else \
        np.empty(0, dtype="U1")


def encode_bulk_cols(rels_cols: dict) -> bytes:
    """Columnar bulk-load payload -> npz bytes. ``expiration`` becomes
    float64 with NaN for "never" (the store's bulk_load normalizes NaN
    back to +inf); every other column becomes a fixed-width string
    array."""
    arrays = {}
    for k, v in rels_cols.items():
        if k == "expiration":
            if isinstance(v, np.ndarray):
                arrays[k] = v.astype(np.float64)
            else:
                arrays[k] = np.asarray(
                    [np.nan if x is None else float(x) for x in v],
                    dtype=np.float64)
        else:
            arrays[k] = _string_column(v)
    bio = io.BytesIO()
    np.savez(bio, **arrays)
    return bio.getvalue()


def decode_bulk_cols(blob: bytes) -> dict:
    """npz bytes -> {column: ndarray}, ready for ``Store.bulk_load``.
    allow_pickle stays at its False default: a hostile frame cannot
    smuggle object arrays."""
    with np.load(io.BytesIO(blob)) as z:
        return {k: z[k] for k in z.files}


def save(path: str, arrays: dict) -> int:
    """Persist ``{name: ndarray}`` as a *directory* of one ``.npy`` file
    per column, and return the total bytes written.

    The directory form exists because ``np.load(..., mmap_mode=...)``
    silently ignores the mmap request for ``.npz`` archives (zip members
    can't be mapped); one flat ``.npy`` per column is the only layout
    numpy will genuinely map. Each column is written to a temp file in
    the target directory and atomically renamed, mirroring the store's
    snapshot discipline, so a torn write never leaves a half-length
    column behind.
    """
    os.makedirs(path, exist_ok=True)
    total = 0
    for name, arr in arrays.items():
        a = np.ascontiguousarray(arr)
        fd, tmp = tempfile.mkstemp(dir=path, suffix=".npy.tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                np.save(f, a)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, os.path.join(path, name + ".npy"))
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        total += int(a.nbytes)
    return total


def load(path: str, mmap: bool = False) -> dict:
    """Load a ``save()`` directory back into ``{name: ndarray}``.

    With ``mmap=True`` every column comes back as a read-only memory map
    (``mmap_mode="r"``): snapshot recovery and cold-arena installs touch
    pages on demand instead of transiently holding a second full copy of
    the graph in host RAM. ``allow_pickle`` stays False in both modes —
    same trust boundary as ``decode_bulk_cols``.
    """
    out = {}
    for fn in sorted(os.listdir(path)):
        if not fn.endswith(".npy"):
            continue
        out[fn[:-4]] = np.load(
            os.path.join(path, fn),
            mmap_mode="r" if mmap else None,
            allow_pickle=False,
        )
    return out
