"""Per-request authorization: middleware orchestration + response filtering.

Mirrors the reference's pkg/authz: WithAuthorization per-request flow
(checks, update dispatch, prefilter/postfilter/watch paths), LookupResources
prefiltering, list/table/object response filtering, bulk postfilter checks,
and the dual-write front door.

A copy of the JAX package's ``authz/`` (it holds no JAX), kept here so the
port imports nothing of that package; "the reference" above is the Go
proxy. It runs in front of the port's engine.
"""

from .middleware import AuthzDeps, authorize  # noqa: F401
from .lookups import AllowedSet, run_prefilter  # noqa: F401
