"""Dependency resilience: deadlines, retries, circuit breakers.

The proxy fronts two remote dependencies — the upstream kube-apiserver
(proxy/upstream.py) and, in the engine-host deployment shape, a remote
engine host (engine/remote.py tcp://). Either one wedging must degrade
into a bounded, fail-closed error, never an unbounded hang and never a
fail-open authorization. Three cooperating pieces:

- :class:`Deadline` — a per-request wall-clock budget from which
  per-attempt connect/read budgets are derived (``budget(cap)``), so
  retries never extend the caller's total wait.
- :class:`RetryPolicy` — exponential backoff with DECORRELATED jitter
  (each delay drawn from [base, 3*previous], capped), applied by the
  transports ONLY to idempotent operations: upstream GET/watch
  establishment and engine reads. Writes are never retried — once bytes
  are on the wire the server may have applied them (engine/remote.py's
  no-retry-after-send invariant).
- :class:`CircuitBreaker` — per-dependency closed → open → half-open
  state machine. Open fails fast with :class:`BreakerOpen` (carrying a
  Retry-After hint); after ``reset_timeout`` one probe is admitted at a
  time. State is exported as the ``proxy_dependency_breaker_state``
  gauge and surfaced on ``/readyz`` with a per-dependency reason.
- :class:`RetryBudget` — a token-bucket retry allowance SHARED across
  every retrying layer of one dependency stack (transport retries in
  RemoteEngine/HttpUpstream, FailoverEngine re-aim re-issues, planner
  scatter-leg re-issues). Each first attempt deposits ``ratio`` tokens
  (capped at ``burst``); each retry, anywhere in the stack, withdraws
  one — so a browned-out shard sees at most ``burst + ratio × attempts``
  retries TOTAL instead of N_layers × N_retries × attempts (the
  metastable-failure guard: retry amplification is what turns a brief
  brownout into a self-sustaining overload).

Failures that feed the breaker are TRANSPORT failures (connect refused,
reset, timeout, armed failpoint) — an upstream 500 or an engine
precondition error is a healthy dependency saying no.

Everything takes an injectable clock/rng so chaos tests drive the whole
state machine deterministically, without sleeps.
"""

from __future__ import annotations

import math
import random
import threading
import time
from typing import Iterator, Optional

from .metrics import metrics

# breaker states; also the value of the breaker-state gauge
STATE_CLOSED = 0
STATE_HALF_OPEN = 1
STATE_OPEN = 2

_STATE_NAMES = {STATE_CLOSED: "closed", STATE_HALF_OPEN: "half-open",
                STATE_OPEN: "open"}


class DependencyUnavailable(RuntimeError):
    """A dependency is unreachable within policy: the authz middleware
    maps this (and only this) family to a fail-closed kube 503 with a
    ``Retry-After`` header (authz/middleware.py)."""

    def __init__(self, dependency: str, message: str,
                 retry_after: float = 1.0):
        super().__init__(message)
        self.dependency = dependency
        # seconds the caller should wait before trying again (>= 0)
        self.retry_after = retry_after


class BreakerOpen(DependencyUnavailable):
    """Fast failure: the dependency's circuit breaker is open."""


class DeadlineExceeded(DependencyUnavailable):
    """The per-request deadline ran out before the dependency answered."""


class Deadline:
    """A wall-clock budget for ONE request, shared across its attempts.

    ``budget(cap)`` derives a per-attempt timeout: the smaller of the
    attempt cap (e.g. a connect timeout) and the time left, so a retry
    can never push the caller past its total deadline. A ``None`` total
    means unlimited (``budget`` then just returns the cap)."""

    __slots__ = ("_at", "_clock", "total")

    def __init__(self, total: Optional[float], clock=time.monotonic):
        self.total = total
        self._clock = clock
        self._at = None if not total or total <= 0 else clock() + total

    @classmethod
    def after(cls, total: Optional[float],
              clock=time.monotonic) -> "Deadline":
        return cls(total, clock=clock)

    def remaining(self) -> float:
        if self._at is None:
            return math.inf
        return max(0.0, self._at - self._clock())

    @property
    def expired(self) -> bool:
        return self._at is not None and self._clock() >= self._at

    def budget(self, cap: Optional[float] = None) -> Optional[float]:
        """Per-attempt timeout: min(cap, remaining); None = unlimited
        (suitable for ``asyncio.wait_for``/``socket.settimeout``)."""
        rem = self.remaining()
        if rem is math.inf:
            return cap
        return rem if cap is None else min(cap, rem)

    def check(self, dependency: str) -> None:
        if self.expired:
            raise DeadlineExceeded(
                dependency,
                f"deadline of {self.total:.1f}s exhausted waiting for "
                f"{dependency}")


class RetryPolicy:
    """A backoff SCHEDULE (how many attempts a caller makes is the
    caller's ``retries`` knob): exponential with decorrelated jitter,
    each delay drawn uniformly from [base, 3 * previous], capped. A zero
    ``base``/``cap`` gives an all-zero schedule — how chaos tests inject
    a sleepless policy."""

    __slots__ = ("base", "cap", "_rng")

    def __init__(self, base: float = 0.05, cap: float = 2.0,
                 rng: Optional[random.Random] = None):
        self.base = base
        self.cap = cap
        self._rng = rng or random.Random()

    def delays(self) -> Iterator[float]:
        prev = self.base
        while True:
            delay = min(self.cap, self._rng.uniform(self.base,
                                                    max(self.base, prev * 3)))
            prev = max(delay, self.base)
            yield delay


class RetryBudget:
    """Layered-retry amplification guard (see module docstring).

    The bucket starts FULL (``burst`` tokens): a cold stack can absorb a
    transient blip at full retry aggressiveness; only sustained failure
    drains it, after which retries are rationed to ``ratio`` per fresh
    attempt — the steady-state amplification bound. ``allow()`` answers
    whether ONE retry may proceed and counts every refusal in
    ``resilience_retry_budget_exhausted_total{dependency}``; callers that
    get False surface the underlying failure immediately instead of
    retrying. Thread-safe; a ``ratio`` of 0 with a huge ``burst``
    degenerates to the unbudgeted behavior."""

    __slots__ = ("dependency", "ratio", "burst", "_tokens", "_attempts",
                 "_lock")

    def __init__(self, dependency: str = "engine", ratio: float = 0.1,
                 burst: float = 10.0):
        if ratio < 0:
            raise ValueError("retry-budget ratio must be >= 0")
        if burst < 1:
            raise ValueError("retry-budget burst must be >= 1")
        self.dependency = dependency
        self.ratio = ratio
        self.burst = float(burst)
        self._tokens = float(burst)
        # lifetime deposit count: the EXACT denominator of the
        # amplification bound (burst + ratio × attempts) — verifiers
        # snapshot it instead of guessing deposits from logical-op
        # counts (one scatter op deposits once per leg)
        self._attempts = 0
        self._lock = threading.Lock()
        self._gauge().set(self._tokens)

    def _gauge(self):
        return metrics.gauge("resilience_retry_budget_tokens",
                             dependency=self.dependency)

    @property
    def tokens(self) -> float:
        with self._lock:
            return self._tokens

    @property
    def attempts(self) -> int:
        with self._lock:
            return self._attempts

    def on_attempt(self) -> None:
        """Credit one FIRST attempt (not a retry): deposits ``ratio``
        tokens, capped at ``burst``. Every logical call through a
        budgeted client calls this exactly once."""
        with self._lock:
            self._attempts += 1
            self._tokens = min(self.burst, self._tokens + self.ratio)
            t = self._tokens
        self._gauge().set(t)

    def allow(self) -> bool:
        """Withdraw one retry's token; False (counted) when the budget
        is dry — the caller must surface its failure, not retry."""
        with self._lock:
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                t = self._tokens
                ok = True
            else:
                t = self._tokens
                ok = False
        self._gauge().set(t)
        if not ok:
            metrics.counter("resilience_retry_budget_exhausted_total",
                            dependency=self.dependency).inc()
        return ok


class CircuitBreaker:
    """Per-dependency closed → open → half-open breaker.

    ``failure_threshold`` CONSECUTIVE transport failures open the
    circuit; while open, ``allow()`` raises :class:`BreakerOpen`
    immediately (fail fast, never hang). After ``reset_timeout`` the
    next ``allow()`` admits ONE probe (half-open); its success closes
    the circuit, its failure re-opens with a fresh window. Thread-safe —
    the remote-engine client calls it from request-handler worker
    threads, the upstream from the event loop."""

    def __init__(self, dependency: str, failure_threshold: int = 5,
                 reset_timeout: float = 10.0, clock=time.monotonic):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.dependency = dependency
        self.failure_threshold = failure_threshold
        self.reset_timeout = reset_timeout
        self._clock = clock
        self._lock = threading.Lock()
        self._state = STATE_CLOSED
        self._failures = 0  # consecutive
        self._opened_at = 0.0
        self._probe_inflight = False
        self._gauge().set(STATE_CLOSED)

    def _gauge(self):
        return metrics.gauge("proxy_dependency_breaker_state",
                             dependency=self.dependency)

    @property
    def state(self) -> int:
        with self._lock:
            return self._state

    def _set_state(self, state: int) -> None:
        # lock held by caller
        self._state = state
        self._gauge().set(state)

    def allow(self) -> None:
        """Admission check before an attempt; raises BreakerOpen when the
        circuit rejects it. Every admitted attempt MUST be answered with
        record_success() or record_failure()."""
        with self._lock:
            if self._state == STATE_CLOSED:
                return
            elapsed = self._clock() - self._opened_at
            if self._state == STATE_OPEN and elapsed >= self.reset_timeout:
                self._set_state(STATE_HALF_OPEN)
                self._probe_inflight = False
            if self._state == STATE_HALF_OPEN and not self._probe_inflight:
                self._probe_inflight = True
                return
            retry_after = max(0.0, self.reset_timeout - elapsed)
            state = _STATE_NAMES[self._state]
            failures = self._failures
        metrics.counter("proxy_dependency_breaker_rejections_total",
                        dependency=self.dependency).inc()
        raise BreakerOpen(
            self.dependency,
            f"circuit breaker for {self.dependency} is {state} "
            f"({failures} consecutive failures)",
            retry_after=retry_after)

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._probe_inflight = False
            if self._state != STATE_CLOSED:
                self._set_state(STATE_CLOSED)

    def release(self) -> None:
        """Release an admitted attempt WITHOUT a verdict: the attempt
        ended in a non-transport outcome (handler cancelled, protocol
        error, server-side rejection surfaced as an exception before the
        success path ran). Neither state nor the failure streak moves,
        but a half-open probe slot must not leak — otherwise one such
        exception during the probe would wedge the breaker open
        forever."""
        with self._lock:
            self._probe_inflight = False

    def check_open(self) -> None:
        """Raise BreakerOpen iff the circuit is not passing traffic —
        hard-open inside the reset window, or half-open with the probe
        slot taken — WITHOUT admitting an attempt or consuming the probe
        slot. For callers that want to fail fast before committing side
        effects (e.g. durably enqueueing a dual-write) but must not
        interfere with probe accounting. A probe-eligible circuit passes:
        let a real attempt decide."""
        with self._lock:
            if self._state == STATE_CLOSED:
                return
            if self._state == STATE_HALF_OPEN:
                if not self._probe_inflight:
                    return
                # a probe is in flight and may hang up to a full read
                # timeout against a stalled host; everything else fails
                # fast meanwhile rather than queueing behind it
                retry_after = 1.0
                state = "half-open (probe in flight)"
            else:
                elapsed = self._clock() - self._opened_at
                if elapsed >= self.reset_timeout:
                    return
                retry_after = self.reset_timeout - elapsed
                state = "open"
            failures = self._failures
        raise BreakerOpen(
            self.dependency,
            f"circuit breaker for {self.dependency} is {state} "
            f"({failures} consecutive failures)",
            retry_after=retry_after)

    def record_failure(self) -> None:
        with self._lock:
            self._failures += 1
            if self._state == STATE_HALF_OPEN:
                # the probe failed: re-open with a fresh reset window
                self._probe_inflight = False
                self._opened_at = self._clock()
                self._set_state(STATE_OPEN)
            elif (self._state == STATE_CLOSED
                    and self._failures >= self.failure_threshold):
                self._opened_at = self._clock()
                self._set_state(STATE_OPEN)

    def force_open(self) -> None:
        """Trip the breaker as if the threshold had been crossed (ops/
        test hook; also what a chaos failpoint storm converges to)."""
        with self._lock:
            self._failures = max(self._failures, self.failure_threshold)
            self._opened_at = self._clock()
            self._set_state(STATE_OPEN)

    def open_reason(self) -> Optional[str]:
        """Human-readable unreadiness reason, or None when ready.
        Surfaced per-dependency by /readyz (proxy/server.py).

        A PROBE-ELIGIBLE circuit (open with the reset window elapsed, or
        half-open with no probe in flight) reports READY: unreadiness
        pulls the replica out of rotation, and a replica starved of
        traffic would otherwise never reach allow() — the only place the
        open -> half-open probe happens — leaving it unready forever
        after the dependency recovers."""
        with self._lock:
            if self._state == STATE_CLOSED:
                return None
            if self._state == STATE_HALF_OPEN:
                return ("circuit half-open (probing)"
                        if self._probe_inflight else None)
            left = self.reset_timeout - (self._clock() - self._opened_at)
            if left <= 0:
                return None  # probe-eligible: let traffic return
            return (f"circuit open after {self._failures} consecutive "
                    f"failures; next probe in {left:.1f}s")
