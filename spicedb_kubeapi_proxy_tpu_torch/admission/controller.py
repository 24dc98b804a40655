"""The admission controller: fair queueing + adaptive limit + shedding.

One controller guards one dispatch pool (a proxy replica's in-process
engine, or the engine host's worker executor). The flow per request:

1. **classify** (admission/classes.py) — done by the caller, which knows
   the operation.
2. **admit or queue** — if nothing is queued and the weighted in-flight
   cost fits under the adaptive limit, the request is admitted
   immediately. Otherwise it queues behind its tenant's FIFO, bounded
   per-tenant and globally.
3. **fair dequeue** — each release drains the queue by weighted fair
   share: every tenant carries a *debt* of recently-consumed cost units
   that decays at ``tenant_rate`` units/second (the token-bucket refill)
   and is capped at ``tenant_burst`` (so a finished storm is forgiven in
   bounded time); the tenant with the LEAST debt goes next. A tenant
   issuing expensive LookupResources storms accumulates debt 4x faster
   than one issuing checks and is scheduled behind everyone else —
   weighted fairness over device time, not request count.
4. **shed** — when a queue bound is hit, the LOWEST-priority queued
   request makes room for a higher-priority arrival (watch ticks first,
   then lists, then checks; writes last); an arrival that outranks
   nothing is shed itself. Queued requests also shed when their wait
   exceeds ``queue_timeout`` — a queued request NEVER hangs. Every
   rejection raises :class:`AdmissionRejected` (the middleware's
   fail-closed 503 + Retry-After family) and lands in
   ``admission_shed_total{class=...}``.

Thread-safe, loop-friendly: the sync surface (``acquire``) parks on an
event, the async surface (``acquire_async``) on a future resolved via
``call_soon_threadsafe`` — both share one accounting core, so the authz
middleware (event loop) and bench/worker threads see the same queue.
"""

from __future__ import annotations

import asyncio
import threading
import time
from collections import deque
from typing import Optional

from ..utils.metrics import metrics
from ..utils.resilience import DependencyUnavailable
from .classes import CostClass
from .limiter import AdaptiveLimiter


class AdmissionRejected(DependencyUnavailable):
    """Load shed: the request was refused BEFORE any engine dispatch (or
    durable side effect), so retrying is always safe. Subclasses
    :class:`DependencyUnavailable` so the authz middleware maps it to
    the existing fail-closed kube 503 + ``Retry-After`` path, counted
    under its own ``dependency`` label (distinguishable from breaker
    opens and ``NotLeaderError`` in
    ``proxy_dependency_unavailable_total``)."""

    def __init__(self, op_class: str, reason: str,
                 retry_after: float = 1.0, dependency: str = "admission"):
        super().__init__(dependency, f"{op_class}: {reason}",
                         retry_after=retry_after)
        self.op_class = op_class
        self.reason = reason


def validate_config(initial_concurrency: float, min_concurrency: float,
                    max_concurrency: float, tenant_rate: float,
                    tenant_burst: float, tenant_depth: int,
                    global_depth: int, queue_timeout: float) -> None:
    """The ONE owner of admission flag bounds; proxy options and the
    engine-host CLI both call it so their accepted configs can never
    drift. Raises ValueError with an operator-facing message."""
    if not 0 < min_concurrency <= initial_concurrency <= max_concurrency:
        raise ValueError(
            "need 0 < admission-min-concurrency <= "
            "admission-initial-concurrency <= admission-max-concurrency")
    if tenant_rate <= 0 or tenant_burst <= 0:
        raise ValueError("admission-tenant-rate/-burst must be > 0")
    if tenant_depth < 1 or global_depth < 1:
        raise ValueError("admission queue depths must be >= 1")
    if queue_timeout <= 0:
        raise ValueError("admission-queue-timeout must be > 0")


class Ticket:
    """One admitted request's grant; release EXACTLY once (idempotent —
    double releases are ignored, not double-credited)."""

    __slots__ = ("_ctrl", "tenant", "cls", "granted_at", "_released")

    def __init__(self, ctrl: "AdmissionController", tenant: str,
                 cls: CostClass, granted_at: float):
        self._ctrl = ctrl
        self.tenant = tenant
        self.cls = cls
        self.granted_at = granted_at
        self._released = False

    def release(self, observe: bool = True) -> None:
        """Hand the capacity back. ``observe=False`` returns the slot
        WITHOUT feeding the limiter — for operations whose duration is
        dominated by a deliberate non-engine wait (e.g. an engine-host
        write blocking on synchronous replication), which would
        otherwise read as engine congestion and collapse the limit.
        Idempotence is decided under the controller lock (_release), so
        concurrent releases from a worker thread and the event loop can
        never double-credit; this unlocked read is only a fast path."""
        if self._released:
            return
        self._ctrl._release(self, observe=observe)

    def __enter__(self) -> "Ticket":
        return self

    def __exit__(self, *exc) -> None:
        self.release()


# waiter states
_QUEUED, _GRANTED, _SHED = 0, 1, 2


class _Waiter:
    __slots__ = ("tenant", "cls", "deliver", "enqueued_at", "granted_at",
                 "seq", "state")

    def __init__(self, tenant: str, cls: CostClass, deliver,
                 enqueued_at: float, seq: int):
        self.tenant = tenant
        self.cls = cls
        self.deliver = deliver  # deliver(exc_or_None), called OFF-lock
        self.enqueued_at = enqueued_at
        self.granted_at = 0.0
        self.seq = seq
        self.state = _QUEUED


class _Tenant:
    __slots__ = ("name", "debt", "last", "queue")

    def __init__(self, name: str, now: float):
        self.name = name
        self.debt = 0.0  # outstanding cost units; decays at tenant_rate
        self.last = now
        self.queue: deque = deque()  # FIFO of _Waiter


class AdmissionController:
    """See module docstring. ``dependency`` labels this controller's
    metrics and rejections ("admission" on the proxy,
    "engine-admission" on the engine host)."""

    def __init__(self, initial_concurrency: float = 32.0,
                 min_concurrency: float = 4.0,
                 max_concurrency: float = 512.0,
                 tenant_rate: float = 50.0, tenant_burst: float = 100.0,
                 tenant_depth: int = 32, global_depth: int = 256,
                 queue_timeout: float = 1.0,
                 dependency: str = "admission",
                 limiter: Optional[AdaptiveLimiter] = None,
                 clock=time.monotonic):
        # flag-level bounds (including tenant_rate/burst > 0) are owned
        # by validate_config at the options/CLI layer; the constructor
        # deliberately permits tenant_rate=0 — deterministic tests and
        # benches freeze debt decay with it — and only rejects values
        # that would break the controller's own invariants
        if tenant_depth < 1 or global_depth < 1:
            raise ValueError("queue depths must be >= 1")
        if queue_timeout <= 0:
            raise ValueError("queue-timeout must be > 0")
        self.limiter = limiter or AdaptiveLimiter(
            initial_concurrency, min_concurrency, max_concurrency,
            dependency=dependency)
        self.tenant_rate = float(tenant_rate)
        self.tenant_burst = float(tenant_burst)
        self.tenant_depth = tenant_depth
        self.global_depth = global_depth
        self.queue_timeout = queue_timeout
        self.dependency = dependency
        self._clock = clock
        self._lock = threading.Lock()
        self._tenants: dict[str, _Tenant] = {}
        # tenants with a non-empty queue: the ONLY set the drain, the
        # shed-victim scan, and the retry-after estimate iterate — with
        # per-user tenancy the full dict holds every subject ever seen,
        # and an O(all-tenants) sweep per grant inside the global lock
        # would make admission itself the contention point under load
        self._backlogged: set = set()
        self._prune_above = 4096  # amortized idle-tenant sweep threshold
        self._queued = 0
        self._queued_cost = 0.0  # running sum: O(1) Retry-After estimate
        self._inflight = 0
        self._inflight_cost = 0.0
        self._shed_total = 0
        self._seq = 0

    # -- accounting core (everything below the public surface holds
    # -- self._lock; deliver callbacks always run OFF-lock) ------------------

    def _tenant(self, name: str, now: float) -> _Tenant:
        t = self._tenants.get(name)
        if t is None:
            if len(self._tenants) >= self._prune_above:
                # prune decayed-idle tenants so per-user tenancy cannot
                # grow the dict without bound — AMORTIZED: the next
                # sweep waits for substantial growth past what survived,
                # so a high-cardinality steady state (everything still
                # in its decay window) cannot pay this O(tenants) scan
                # on every new-tenant creation
                for k in [k for k, v in self._tenants.items()
                          if not v.queue
                          and v.debt <= (now - v.last) * self.tenant_rate]:
                    del self._tenants[k]
                self._prune_above = max(4096, 2 * len(self._tenants))
            t = self._tenants[name] = _Tenant(name, now)
        return t

    def _decay(self, t: _Tenant, now: float) -> None:
        if now > t.last:
            t.debt = max(0.0, t.debt - (now - t.last) * self.tenant_rate)
            t.last = now

    def _charge(self, t: _Tenant, cls: CostClass) -> None:
        t.debt = min(self.tenant_burst, t.debt + cls.weight)

    def _fits(self, cls: CostClass) -> bool:
        return (self._inflight_cost + cls.weight <= self.limiter.limit
                or self._inflight == 0)  # one op always fits: no wedging

    def _admit_locked(self, t: _Tenant, cls: CostClass) -> None:
        self._inflight += 1
        self._inflight_cost += cls.weight
        self._charge(t, cls)
        metrics.counter("admission_admitted_total",
                        **{"class": cls.name}).inc()
        metrics.gauge("admission_inflight_cost",
                      dependency=self.dependency).set(self._inflight_cost)

    def _drain_locked(self, now: float) -> list[_Waiter]:
        """Grant queued waiters in weighted-fair order while capacity
        lasts; returns them for OFF-lock delivery."""
        granted: list[_Waiter] = []
        while self._queued:
            best: Optional[_Tenant] = None
            best_key = None
            for t in self._backlogged:
                self._decay(t, now)
                key = (t.debt, t.queue[0].seq)
                if best is None or key < best_key:
                    best, best_key = t, key
            if best is None:  # stale count; repaired defensively
                self._queued = 0
                break
            w = best.queue[0]
            if not self._fits(w.cls):
                break
            best.queue.popleft()
            if not best.queue:
                self._backlogged.discard(best)
            self._queued -= 1
            self._queued_cost = max(0.0, self._queued_cost - w.cls.weight)
            w.state = _GRANTED
            w.granted_at = now
            self._admit_locked(best, w.cls)
            metrics.histogram("admission_queue_seconds",
                              dependency=self.dependency).observe(
                max(0.0, now - w.enqueued_at))
            granted.append(w)
        metrics.gauge("admission_queue_depth",
                      dependency=self.dependency).set(self._queued)
        return granted

    def _lowest_priority_locked(self, pool) -> Optional[_Waiter]:
        """The shed candidate: lowest priority, newest arrival among it
        (LIFO within a class preserves the oldest waiters' progress)."""
        victim: Optional[_Waiter] = None
        for w in pool:
            if victim is None or (w.cls.priority, -w.seq) < \
                    (victim.cls.priority, -victim.seq):
                victim = w
        return victim

    def _count_shed(self, cls: CostClass) -> None:
        self._shed_total += 1
        metrics.counter("admission_shed_total",
                        **{"class": cls.name}).inc()

    def _retry_after_locked(self) -> float:
        # estimated queue DRAIN TIME: (queued cost / concurrency limit)
        # is how many limit-fulls are ahead, and each turns over in
        # roughly one baseline op latency — a depth alone would be a
        # unitless ratio misread as seconds, telling polite clients to
        # back off ~1000x too long on sub-ms workloads. The running
        # counter keeps the shed path O(1): walking every queued waiter
        # under the global lock would make each rejection pay O(depth)
        # exactly when rejections are the common case
        drain = (self._queued_cost / max(self.limiter.limit, 1.0)) \
            * self.limiter.baseline_latency
        return max(1.0, min(10.0, drain))

    def _submit(self, tenant: str, cls: CostClass, deliver):
        """Admit now (returns None), queue (returns the waiter), or shed
        (raises). May also evict a lower-priority queued waiter — its
        rejection is delivered off-lock before returning."""
        evicted: Optional[_Waiter] = None
        granted: list[_Waiter] = []
        try:
            with self._lock:
                now = self._clock()
                t = self._tenant(tenant, now)
                self._decay(t, now)
                if self._queued == 0 and self._fits(cls):
                    self._admit_locked(t, cls)
                    # zero-wait admits observe too: the queue-wait
                    # distribution must cover EVERY admitted request or
                    # its p50 reads as "everyone queued" the moment one
                    # request does (bench per-stage admission-wait)
                    metrics.histogram(
                        "admission_queue_seconds",
                        dependency=self.dependency).observe(0.0)
                    return None
                if len(t.queue) >= self.tenant_depth \
                        or self._queued >= self.global_depth:
                    # per-tenant overflow sheds within the tenant (the
                    # bound exists to contain exactly that tenant);
                    # global overflow sheds across everyone
                    pool = (t.queue if len(t.queue) >= self.tenant_depth
                            else (w for tt in self._backlogged
                                  for w in tt.queue))
                    victim = self._lowest_priority_locked(pool)
                    if victim is not None \
                            and victim.cls.priority < cls.priority:
                        vt = self._tenants[victim.tenant]
                        vt.queue.remove(victim)
                        if not vt.queue:
                            self._backlogged.discard(vt)
                        victim.state = _SHED
                        self._queued -= 1
                        self._queued_cost = max(
                            0.0, self._queued_cost - victim.cls.weight)
                        self._count_shed(victim.cls)
                        evicted = victim
                    else:
                        self._count_shed(cls)
                        raise AdmissionRejected(
                            cls.name,
                            f"queue full ({self._queued} queued, "
                            f"limit {self.limiter.limit:.0f})",
                            retry_after=self._retry_after_locked(),
                            dependency=self.dependency)
                self._seq += 1
                w = _Waiter(tenant, cls, deliver, now, self._seq)
                t.queue.append(w)
                self._backlogged.add(t)
                self._queued += 1
                self._queued_cost += cls.weight
                metrics.gauge("admission_queue_depth",
                              dependency=self.dependency).set(self._queued)
                if evicted is not None:
                    # the eviction may have replaced a too-heavy queue
                    # head: anything that now fits goes immediately
                    granted = self._drain_locked(now)
                return w
        finally:
            if evicted is not None:
                evicted.deliver(AdmissionRejected(
                    evicted.cls.name,
                    "shed for a higher-priority request",
                    retry_after=1.0, dependency=self.dependency))
            for g in granted:
                g.deliver(None)

    def _cancel(self, w: _Waiter, count_shed: bool = True) -> bool:
        """Timeout/cancellation path: True iff the waiter was still
        queued (and is now removed); False means a grant/shed already
        won the race — its terminal state is visible in ``w.state``.
        ``count_shed=False`` for caller-abandoned waits (a cancelled
        handler is not an overload rejection)."""
        granted: list[_Waiter] = []
        try:
            with self._lock:
                if w.state != _QUEUED:
                    return False
                t = self._tenants[w.tenant]
                t.queue.remove(w)
                if not t.queue:
                    self._backlogged.discard(t)
                w.state = _SHED
                self._queued -= 1
                self._queued_cost = max(
                    0.0, self._queued_cost - w.cls.weight)
                if count_shed:
                    self._count_shed(w.cls)
                metrics.gauge("admission_queue_depth",
                              dependency=self.dependency).set(self._queued)
                # the removed waiter may have been the heavy HEAD that
                # blocked lighter requests behind it: drain NOW — a
                # fitting waiter must not sit until an unrelated release
                # (or shed spuriously at its own timeout meanwhile)
                granted = self._drain_locked(self._clock())
                return True
        finally:
            for g in granted:
                g.deliver(None)

    def _retry_after(self) -> float:
        with self._lock:
            return self._retry_after_locked()

    def _release(self, ticket: Ticket, observe: bool = True) -> None:
        now = self._clock()
        with self._lock:
            if ticket._released:  # definitive idempotence check
                return
            ticket._released = True
            # utilization is sampled BEFORE handing the weight back: the
            # released op was part of the in-flight set whose latency it
            # reports, and a post-decrement sample could never reach the
            # limiter's saturation threshold for heavy-weight classes
            # (releasing a weight-4 lookup always leaves <= limit - 4)
            cost_at_release = self._inflight_cost
            self._inflight -= 1
            self._inflight_cost = max(
                0.0, self._inflight_cost - ticket.cls.weight)
            if observe:
                self.limiter.observe(max(0.0, now - ticket.granted_at),
                                     cost_at_release)
            metrics.gauge("admission_inflight_cost",
                          dependency=self.dependency).set(
                self._inflight_cost)
            granted = self._drain_locked(now)
        for w in granted:
            w.deliver(None)

    # -- public surface ------------------------------------------------------

    def acquire(self, tenant: str, cls: CostClass) -> Ticket:
        """Blocking admission from a worker thread. Returns a
        :class:`Ticket` or raises :class:`AdmissionRejected` — never
        later than ``queue_timeout`` (plus delivery jitter)."""
        ev = threading.Event()
        box: dict = {}

        def deliver(exc):
            box["exc"] = exc
            ev.set()

        w = self._submit(tenant, cls, deliver)
        if w is None:
            return Ticket(self, tenant, cls, self._clock())
        if not ev.wait(self.queue_timeout):
            if self._cancel(w):
                raise AdmissionRejected(
                    cls.name,
                    f"queued longer than {self.queue_timeout:.2f}s",
                    retry_after=self._retry_after(),
                    dependency=self.dependency)
            ev.wait()  # outcome landed concurrently with the timeout
        exc = box.get("exc")
        if exc is not None:
            raise exc
        return Ticket(self, tenant, cls, w.granted_at)

    async def acquire_async(self, tenant: str, cls: CostClass) -> Ticket:
        """Event-loop admission: queued waits park a future, not a
        thread (the engine host may hold hundreds of queued ops)."""
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()

        def deliver(exc):
            def _set():
                if fut.done():
                    return
                if exc is None:
                    fut.set_result(None)
                else:
                    fut.set_exception(exc)

            loop.call_soon_threadsafe(_set)

        w = self._submit(tenant, cls, deliver)
        if w is None:
            return Ticket(self, tenant, cls, self._clock())

        def on_timeout():
            if self._cancel(w):
                deliver(AdmissionRejected(
                    cls.name,
                    f"queued longer than {self.queue_timeout:.2f}s",
                    retry_after=self._retry_after(),
                    dependency=self.dependency))

        handle = loop.call_later(self.queue_timeout, on_timeout)
        try:
            await fut
        except asyncio.CancelledError:
            # the awaiting handler died (client disconnect, task
            # teardown): hand back the queue slot — or, if a grant
            # already raced in, the admitted CAPACITY — so an abandoned
            # waiter can never leak inflight cost and wedge the
            # controller shut. _cancel's terminal states make this
            # race-free: False + _GRANTED means the cost was charged and
            # nobody will ever release it but us.
            if not self._cancel(w, count_shed=False) \
                    and w.state == _GRANTED:
                # observe=False: the op never dispatched, so the
                # grant-to-cancel span (~0, floor-clamped) is a phantom
                # sample that would pin the limiter baseline at the
                # floor exactly when disconnect churn peaks
                Ticket(self, tenant, cls, w.granted_at).release(
                    observe=False)
            raise
        finally:
            handle.cancel()
        return Ticket(self, tenant, cls, w.granted_at)

    def status(self) -> dict:
        """Shed/queue state for /readyz and tests."""
        with self._lock:
            return {
                "limit": round(self.limiter.limit, 1),
                "inflight": self._inflight,
                "inflight_cost": round(self._inflight_cost, 1),
                "queued": self._queued,
                "tenants": sum(1 for t in self._tenants.values()
                               if t.queue or t.debt > 0),
                "shed_total": self._shed_total,
            }
