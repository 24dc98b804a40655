"""Admission control: cost-classed, per-tenant fair queueing with
adaptive concurrency and priority load shedding.

The traffic-handling half of the overload story (utils/resilience.py is
the failure-handling half): every engine-bound request passes through an
:class:`AdmissionController` before it may occupy the dispatch pool.

- ``classes.py`` — the cost classifier: each operation maps to one of
  five classes (check / bulk-check / lookup-prefilter / watch-recompute
  / write-dtx) carrying a concurrency **weight** (how much of the device
  budget one admitted op occupies) and a shed **priority** (watch ticks
  shed first, then lists, then checks; writes last).
- ``limiter.py`` — the adaptive concurrency limiter: AIMD on the
  gradient of observed engine latency against a decayed-minimum
  baseline, so the admitted-cost ceiling tracks what the device can
  actually absorb instead of a static guess.
- ``controller.py`` — the per-tenant weighted fair queue (token-bucket
  debt decay, bounded per-tenant and global depth), priority load
  shedding, and the sync/async acquire surface. Rejections raise
  :class:`AdmissionRejected`, a
  :class:`~..utils.resilience.DependencyUnavailable` subclass — the
  authz middleware's existing fail-closed path turns it into a bounded
  kube 503 with a ``Retry-After`` header, and
  ``admission_shed_total{class=...}`` accounts for every one.

Wired in two places: the authz middleware (per authenticated user — no
subject can monopolize a proxy replica's engine time) and the engine
host server (per proxy-replica peer — a shared ``tcp://`` engine is
protected from the aggregate of many replicas).
"""

from .classes import (  # noqa: F401
    BULK_CHECK,
    CHECK,
    CLASSES,
    LOOKUP_PREFILTER,
    REBALANCE,
    WATCH_RECOMPUTE,
    WRITE_DTX,
    CostClass,
    classify_op,
    classify_request,
)
from .controller import (  # noqa: F401
    AdmissionController,
    AdmissionRejected,
    Ticket,
    validate_config,
)
from .limiter import AdaptiveLimiter  # noqa: F401
