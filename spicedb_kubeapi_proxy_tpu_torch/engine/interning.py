"""String interning: stable string -> int32 ids, vectorized for bulk loads
(a copy of the JAX package's ``engine/interning.py``)."""

from __future__ import annotations

from typing import Iterable, Optional

import numpy as np

from .. import native


def _as_str(s) -> str:
    """Every path interns str keys: bytes columns ('S' dtype, or bytes
    elements in lists) decode identically whether they ride the native
    hash-unique, np.unique, or the small-column dict loop. surrogateescape
    keeps non-UTF8 bytes deterministic instead of raising on one path."""
    return s.decode(errors="surrogateescape") if isinstance(s, bytes) else s


class Interner:
    """Monotone string→int table. Index 0 is reserved for ``reserved[0]``, etc.

    Used for type names, relation names, and per-type object ids. Bulk
    interning goes through :meth:`intern_many` (one dict pass, no per-call
    Python overhead beyond the loop).
    """

    __slots__ = ("_to_id", "_to_str")

    def __init__(self, reserved: Iterable[str] = ()):
        self._to_id: dict[str, int] = {}
        self._to_str: list[str] = []
        for s in reserved:
            self.intern(s)

    def __len__(self) -> int:
        return len(self._to_str)

    def intern(self, s: str) -> int:
        i = self._to_id.get(s)
        if i is None:
            i = len(self._to_str)
            self._to_id[s] = i
            self._to_str.append(s)
        return i

    def lookup(self, s: str) -> Optional[int]:
        return self._to_id.get(s)

    def string(self, i: int) -> str:
        return self._to_str[i]

    def intern_many(self, strings) -> np.ndarray:
        """Intern a sequence of strings, returning int32 ids.

        Vectorized for bulk loads: one ``np.unique`` pass over the column,
        then a Python loop only over the (typically tiny) vocabulary. New
        ids are assigned in sorted-unique order rather than first-occurrence
        order — callers never depend on id assignment order.
        """
        n = len(strings)
        if n == 0:
            return np.empty(0, dtype=np.int32)
        if n > 1024:
            # object dtype keeps elements pointer-sized; a fixed-width
            # unicode array would cost 4*maxlen bytes per element (one long
            # outlier id would blow up a 10M-row column). Columns that are
            # ALREADY fixed-width numpy arrays keep their layout — that is
            # the zero-copy input to the native hash-unique.
            arr = (strings if isinstance(strings, np.ndarray)
                   else np.asarray(strings, dtype=object))
            res = None
            if arr.ndim == 1 and arr.dtype.kind in "SU":
                barr = arr
                if arr.dtype.kind == "U":
                    try:
                        barr = arr.astype("S")
                    except UnicodeEncodeError:
                        barr = None
                if barr is not None and barr.dtype.itemsize:
                    res = native.unique_inverse(barr)
            if res is not None:
                uniq_rows, inv = res
                uniq = arr[uniq_rows]
                ids = np.fromiter(
                    (self.intern(_as_str(s)) for s in uniq.tolist()),
                    dtype=np.int32, count=len(uniq_rows),
                )
                return ids[inv]
            uniq, inv = np.unique(arr, return_inverse=True)
            ids = np.fromiter(
                (self.intern(_as_str(s)) for s in uniq.tolist()),
                dtype=np.int32, count=len(uniq),
            )
            return ids[inv.reshape(-1)]
        to_id = self._to_id
        to_str = self._to_str
        out = np.empty(n, dtype=np.int32)
        for k, s in enumerate(strings):
            s = _as_str(s)
            i = to_id.get(s)
            if i is None:
                i = len(to_str)
                to_id[s] = i
                to_str.append(s)
            out[k] = i
        return out

    def id_map(self) -> dict:
        """The live string→id dict, for hot loops that inline lookups
        (engine check-batch encode). Callers must treat it as read-only."""
        return self._to_id

    def strings(self) -> list[str]:
        return list(self._to_str)
