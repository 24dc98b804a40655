"""Durable dual-write: deterministic workflow engine + the two lock-mode
workflows (reference pkg/authz/distributedtx).

The reference uses github.com/cschleiden/go-workflows with a SQLite
event-sourced backend run in-process ("monoprocess",
the Go proxy's pkg/authz/distributedtx/client.go:18-62). Here the same
durability contract is provided by runner.py: workflows are Python
generator functions whose activity calls are event-sourced to SQLite and
deterministically replayed after a crash.

A copy of the JAX package's ``dtx/`` (it holds no JAX), kept here so the
port imports nothing of that package; "the reference" above is the Go
proxy. It runs in front of the port's engine.
"""

from .runner import (  # noqa: F401
    ActivityError,
    WorkflowCrash,
    WorkflowEngine,
    WorkflowTimeout,
)
from .workflow import (  # noqa: F401
    KubeResp,
    LOCK_MODE_OPTIMISTIC,
    LOCK_MODE_PESSIMISTIC,
    WorkflowInput,
    register_workflows,
)
from .activity import ActivityHandler  # noqa: F401
