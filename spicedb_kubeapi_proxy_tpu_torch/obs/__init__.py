"""Observability: request tracing.

A copy of the trace half of the JAX package's ``obs/``: W3C
``traceparent`` context and cheap in-process spans with tail sampling
(:mod:`.trace`). The engine host adopts the context a proxy forwards on
the wire, so its spans (queue wait, device dispatch) stitch into the
proxy's trace. The decision audit log and the compile-event hooks come
with the proxy slice.
"""

from .trace import (
    Tracer,
    format_traceparent,
    parse_traceparent,
    tracer,
)

__all__ = [
    "Tracer",
    "format_traceparent",
    "parse_traceparent",
    "tracer",
]
