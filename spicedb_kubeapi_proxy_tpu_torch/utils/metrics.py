"""Minimal in-process metrics: counters, gauges and histograms, with the
Prometheus text format.

A copy of the JAX package's ``utils/metrics.py``: the same registry, metric
names and exposition, so the engine host's ``load_status`` probe
(``hist_snapshot("engine_check_seconds")``) and a scraper read the port
as they read the reference.
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
    """A value that can go up and down (breaker state, pool occupancy)."""

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
        self.max = 0.0  # largest observation: bounds the overflow bucket
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
        """Approximate quantile from bucket counts (upper bound) — any
        ``q`` including deep tails (p99.9 = ``quantile(0.999)``). A target
        landing in the overflow bucket clamps to the LARGEST OBSERVED
        value, never infinity — bench p99/p99.9 fields must stay finite
        JSON. An EMPTY histogram returns ``None``: a window that saw no
        observations has no percentile, and 0.0 would read as "infinitely
        fast" in a latency curve."""
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

    def snapshot(self) -> dict:
        """A consistent copy of the histogram state, for delta-quantile
        computation across a measurement window (bench.py per-phase stage
        breakdowns)."""
        with self._lock:
            return {"buckets": self.buckets, "counts": list(self.counts),
                    "n": self.n, "total": self.total, "max": self.max}


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

    def hist_snapshot(self, name: str, **labels) -> Optional[dict]:
        """One merged :meth:`Histogram.snapshot` across every label set
        registered under ``name`` (or ``None`` when nothing is). Bench
        stage breakdowns aggregate over labels (e.g. per-dependency
        latency series) — label sets with differing bucket layouts keep
        the first layout and drop the rest, which cannot happen for
        same-name histograms registered through this module's defaults.
        ``labels`` restricts the merge to label sets CONTAINING every
        given pair (how the SLO monitor reads one op class out of a
        shared family, e.g. ``hist_snapshot("loadgen_op_seconds",
        op="check")``)."""
        want = set(labels.items())
        with self._lock:
            hs = [h for key, h in self._hists.items()
                  if key[0] == name and want <= set(key[1:])]
        merged: Optional[dict] = None
        for h in hs:
            s = h.snapshot()
            if merged is None:
                merged = s
            elif s["buckets"] == merged["buckets"]:
                merged["counts"] = [a + b for a, b in
                                    zip(merged["counts"], s["counts"])]
                merged["n"] += s["n"]
                merged["total"] += s["total"]
                merged["max"] = max(merged["max"], s["max"])
        return merged

    def render(self) -> str:
        """Prometheus text exposition. Histograms render the full
        contract — ``# TYPE`` metadata plus cumulative
        ``_bucket{le="..."}`` series ending at ``+Inf`` — so a real
        scraper can compute quantiles; the historical ``_count``/``_sum``
        lines are unchanged."""
        out = []
        typed: set = set()

        def type_line(name: str, kind: str) -> None:
            if name not in typed:
                typed.add(name)
                out.append(f"# TYPE {name} {kind}")

        with self._lock:
            for key, c in sorted(self._counters.items()):
                type_line(key[0], "counter")
                out.append(f"{_fmt(key)} {c.value}")
            for key, g in sorted(self._gauges.items()):
                type_line(key[0], "gauge")
                out.append(f"{_fmt(key)} {g.value}")
            for key, h in sorted(self._hists.items()):
                name = key[0]
                labels = key[1:]
                type_line(name, "histogram")
                s = h.snapshot()
                acc = 0
                for b, c in zip(s["buckets"], s["counts"]):
                    acc += c
                    out.append(_fmt((name + "_bucket",) + labels
                                    + (("le", _fmt_le(b)),)) + f" {acc}")
                out.append(_fmt((name + "_bucket",) + labels
                                + (("le", "+Inf"),)) + f" {s['n']}")
                out.append(f"{_fmt((name + '_count',) + labels)} {s['n']}")
                out.append(
                    f"{_fmt((name + '_sum',) + labels)} {s['total']}")
        return "\n".join(out) + "\n"

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()


def _fmt(key: tuple) -> str:
    name = key[0]
    labels = key[1:]
    if not labels:
        return name
    inner = ",".join(f'{k}="{v}"' for k, v in labels)
    return f"{name}{{{inner}}}"


def _fmt_le(bound) -> str:
    # repr keeps the bound EXACT (shortest round-trip float repr): %g's
    # 6 significant digits would misstate large bounds (2**21 renders as
    # 2.09715e+06 = 2097150) and could collapse nearby bounds into
    # duplicate le labels — an invalid exposition
    return repr(bound)


def snapshot_delta_quantile(before: Optional[dict], after: Optional[dict],
                            q: float) -> Optional[float]:
    """Approximate quantile (upper bucket bound) of the observations that
    landed BETWEEN two :meth:`Histogram.snapshot`/:meth:`Registry.
    hist_snapshot` calls — how bench.py attributes a phase's stage
    latency without resetting shared histograms. ``None`` when the window
    saw no observations; the overflow bucket clamps to the window's
    largest observed value (``after``'s max — an upper bound when earlier
    phases observed larger, never infinity)."""
    if after is None:
        return None
    if before is None:
        before = {"buckets": after["buckets"],
                  "counts": [0] * len(after["counts"]), "n": 0}
    if before["buckets"] != after["buckets"]:
        return None
    d = [a - b for a, b in zip(after["counts"], before["counts"])]
    n = after["n"] - before["n"]
    if n <= 0:
        return None
    target = q * n
    acc = 0
    for i, b in enumerate(after["buckets"]):
        acc += d[i]
        if acc >= target:
            return b
    return after["max"]


metrics = Registry()
