"""Minimal in-process metrics: counters, gauges and histograms.

A copy of the registry parts of the JAX package's ``utils/metrics.py``
that the engine records into (check/lookup counts and latencies,
fixpoint iterations, push/pull hop counts, compile times, and the caveat
counters ``engine_caveat_denied_missing_context_total``,
``engine_caveat_request_list_overflow_total`` and
``engine_caveat_ipv6_unencodable_total``, and the decision cache's
``engine_decision_cache_*`` counters and gauges). Exposition formats come with
the proxy entry points in a later slice.
"""

from __future__ import annotations

import threading
from typing import Optional


class Counter:
    __slots__ = ("_value", "_lock")

    def __init__(self):
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    __slots__ = ("_value", "_lock")

    def __init__(self):
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value -= amount

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                       0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

    def __init__(self, buckets=None):
        self.buckets = tuple(buckets or self.DEFAULT_BUCKETS)
        self.counts = [0] * (len(self.buckets) + 1)
        self.total = 0.0
        self.n = 0
        self.max = 0.0
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        with self._lock:
            self.n += 1
            self.total += v
            if v > self.max:
                self.max = v
            for i, b in enumerate(self.buckets):
                if v <= b:
                    self.counts[i] += 1
                    return
            self.counts[-1] += 1

    def quantile(self, q: float) -> Optional[float]:
        """Approximate quantile from bucket counts (upper bound); the
        overflow bucket clamps to the largest observed value; ``None``
        for an empty histogram."""
        with self._lock:
            if self.n == 0:
                return None
            target = q * self.n
            acc = 0
            for i, b in enumerate(self.buckets):
                acc += self.counts[i]
                if acc >= target:
                    return b
            return self.max


class Registry:
    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[tuple, Counter] = {}
        self._gauges: dict[tuple, Gauge] = {}
        self._hists: dict[tuple, Histogram] = {}

    def counter(self, name: str, **labels) -> Counter:
        key = (name,) + tuple(sorted(labels.items()))
        with self._lock:
            c = self._counters.get(key)
            if c is None:
                c = self._counters[key] = Counter()
            return c

    def gauge(self, name: str, **labels) -> Gauge:
        key = (name,) + tuple(sorted(labels.items()))
        with self._lock:
            g = self._gauges.get(key)
            if g is None:
                g = self._gauges[key] = Gauge()
            return g

    def histogram(self, name: str, buckets=None, **labels) -> Histogram:
        key = (name,) + tuple(sorted(labels.items()))
        with self._lock:
            h = self._hists.get(key)
            if h is None:
                h = self._hists[key] = Histogram(buckets)
            return h

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()


metrics = Registry()
