"""Double-buffered cold-block stream-in.

A copy of the JAX package's ``storage/prefetch.py`` (the port imports nothing
of that package).

A two-worker executor bounds the number of in-flight host→device copies
to two: one block can be decoding/uploading while the previous one is
still landing — the classic double buffer. Callers submit the missing
blocks of a dispatch in **stratification order** (level L before level
L+1), so the block needed earliest is the first to arrive and, on real
accelerators where uploads are async, the copy for level L+1 overlaps
the compute that consumes level L inside the same dispatch.

The pool is shared per ``TierStore`` (per compiled graph), not per
dispatch: concurrent dispatches naturally serialize their stream-ins
through the same bounded window instead of oversubscribing host decode.
"""

from __future__ import annotations

import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Dict, Sequence


class Prefetcher:
    def __init__(self, workers: int = 2):
        self._workers = max(1, int(workers))
        self._lock = threading.Lock()
        self._pool = None

    def _ensure_pool(self) -> ThreadPoolExecutor:
        with self._lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=self._workers,
                    thread_name_prefix="tier-prefetch")
            return self._pool

    def fetch(self, keys: Sequence[int],
              fn: Callable[[int], object]) -> Dict[int, Future]:
        """Submit ``fn(key)`` for every key, preserving the given order
        (earliest-needed first). Returns ``{key: Future}``; the caller
        waits per key and accounts the wall time it actually blocked as
        miss stall."""
        pool = self._ensure_pool()
        return {k: pool.submit(fn, k) for k in keys}

    def shutdown(self) -> None:
        with self._lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=False)
