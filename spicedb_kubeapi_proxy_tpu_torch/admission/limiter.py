"""Adaptive concurrency limiter: AIMD on the latency gradient.

A static concurrency cap is wrong twice — too low it idles the chip,
too high it lets queueing build inside the dispatch pool where nothing
can shed it. This limiter moves the admitted-cost ceiling against what
the engine's latency actually says (the Netflix/gradient-limiter shape,
TCP-Vegas flavored):

- **baseline** — a decayed minimum of observed latency: new lows adopt
  immediately; otherwise it drifts upward slowly, so a permanent regime
  change (bigger graph after a bulk load) re-anchors instead of pinning
  the limiter shut forever.
- **short** — an EWMA of recent latency.
- when ``short > baseline * tolerance`` the engine is queueing:
  multiplicative decrease. When latency is healthy AND the limit is
  actually saturated: additive increase (probing unused headroom when
  half the limit is idle would just be noise).

Adjustments are cooled down (one per ``cooldown`` samples) so a single
bulk check's worth of observations moves the limit once, not per item.
Thread-safe; the clock is injectable only for symmetry with the rest of
the resilience stack — the limiter itself is sample-driven, so tests
drive it deterministically with plain ``observe`` calls.
"""

from __future__ import annotations

import threading

from ..utils.metrics import metrics


class AdaptiveLimiter:
    def __init__(self, initial: float = 32.0, min_limit: float = 4.0,
                 max_limit: float = 512.0, tolerance: float = 1.5,
                 decrease: float = 0.85, increase: float = 1.0,
                 warmup: int = 10, cooldown: int = 8,
                 floor: float = 0.001,
                 dependency: str = "admission"):
        if not min_limit <= initial <= max_limit:
            raise ValueError(
                f"need min <= initial <= max, got {min_limit}/{initial}/"
                f"{max_limit}")
        self.limit = float(initial)
        self.min_limit = float(min_limit)
        self.max_limit = float(max_limit)
        self.tolerance = tolerance
        self.decrease = decrease
        self.increase = increase
        self.warmup = warmup
        self.cooldown = cooldown
        # observations clamp UP to this (seconds): at micro-op scale the
        # short EWMA's jitter trivially exceeds tolerance times a
        # microsecond baseline, and the limiter would ratchet down on
        # pure scheduling noise — nothing meaningful queues behind
        # sub-floor operations anyway
        self.floor = floor
        self.dependency = dependency
        self._baseline: float | None = None
        self._short: float | None = None
        self._n = 0
        self._since_adjust = 0
        self._lock = threading.Lock()
        self._gauge().set(self.limit)

    def _gauge(self):
        return metrics.gauge("admission_concurrency_limit",
                             dependency=self.dependency)

    def observe(self, latency: float, inflight_cost: float) -> None:
        """One completed operation: ``latency`` seconds from admission
        grant to release, ``inflight_cost`` the weighted in-flight cost
        AT release — including the released op itself, so a saturated
        system reports ~limit and the grow probe can actually fire for
        heavy-weight classes (utilization signal)."""
        latency = max(latency, self.floor)
        with self._lock:
            self._n += 1
            if self._baseline is None or self._short is None:
                self._baseline = self._short = latency
                return
            self._short += (latency - self._short) * 0.3
            if latency < self._baseline:
                self._baseline = latency
            else:
                self._baseline += (latency - self._baseline) * 0.02
            self._since_adjust += 1
            if self._n < self.warmup or self._since_adjust < self.cooldown:
                return
            if self._short > self._baseline * self.tolerance:
                # latency detached from its floor: the engine is
                # queueing behind us — back off multiplicatively
                self.limit = max(self.min_limit,
                                 self.limit * self.decrease)
            elif inflight_cost >= self.limit - 1.0:
                # healthy and saturated: probe one unit of headroom
                self.limit = min(self.max_limit, self.limit + self.increase)
            else:
                return  # healthy but unsaturated: nothing to learn
            self._since_adjust = 0
            self._gauge().set(self.limit)

    @property
    def baseline_latency(self) -> float:
        """The decayed-minimum per-op latency (seconds); the floor until
        a first observation lands. Used to turn queue depth into a
        drain-time estimate for Retry-After hints."""
        with self._lock:
            return self._baseline if self._baseline is not None \
                else self.floor

    def snapshot(self) -> dict:
        with self._lock:
            return {"limit": self.limit, "baseline": self._baseline,
                    "short": self._short, "samples": self._n}
