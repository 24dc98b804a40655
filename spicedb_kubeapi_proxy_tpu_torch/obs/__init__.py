"""Observability: request tracing, the decision audit log, SLO monitoring.

Copies of the JAX package's ``obs/``: W3C ``traceparent`` context and
cheap in-process spans with tail sampling (:mod:`.trace`; the engine host
adopts the context a proxy forwards on the wire, so its spans stitch into
the proxy's trace), one JSON line per authorization decision
(:mod:`.audit`, ``--audit-log``) and the live burn-rate monitor
(:mod:`.slo`). The compile-event hooks come with a later slice.
"""

from .audit import AuditLog
from .trace import (
    Tracer,
    format_traceparent,
    parse_traceparent,
    tracer,
)

__all__ = [
    "AuditLog",
    "Tracer",
    "format_traceparent",
    "parse_traceparent",
    "tracer",
]
