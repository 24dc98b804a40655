"""The two lock-mode dual-write workflows.

Mirrors the Go proxy's pkg/authz/distributedtx/workflow.go:

- Pessimistic (workflow.go:134-250): acquire a SpiceDB lock tuple
  ``lock:{hash(path/name/verb)}#workflow@workflow:{instanceID}`` with a
  must-not-exist precondition, write the relationships, then write to kube
  with bounded backoff honoring Retry-After; roll back relationships (ops
  inverted, retried until success) on failure; always release the lock.
- Optimistic (workflow.go:280-352): write relationships, write kube; on an
  ambiguous kube failure probe resource existence and roll back the
  relationship write iff the kube write did not land.

Workflow code is deterministic (no clocks/randomness — the backoff schedule
is fixed) so the event-sourced replay in runner.py is exact.
"""

from __future__ import annotations

import base64
import hashlib
import json
from dataclasses import dataclass, field
from typing import Optional

from .runner import ActivityError, WorkflowContext

LOCK_MODE_PESSIMISTIC = "Pessimistic"
LOCK_MODE_OPTIMISTIC = "Optimistic"

LOCK_RESOURCE_TYPE = "lock"
LOCK_RELATION = "workflow"
WORKFLOW_TYPE = "workflow"

MAX_KUBE_ATTEMPTS = 5
# 100ms base, x2 backoff (reference KubeBackoff, workflow.go:34-39; jitter
# dropped: workflow code must be deterministic for replay)
KUBE_BACKOFF_BASE = 0.1
KUBE_BACKOFF_FACTOR = 2.0


@dataclass
class WorkflowInput:
    """JSON-serializable input (reference WriteObjInput, workflow.go:41-54)."""

    verb: str
    path: str  # request path (lock key component)
    uri: str  # full request URI for raw replay
    headers: dict
    user_name: str
    object_name: str  # object meta name, falls back to request name
    namespace: str
    api_group: str
    resource: str
    body_b64: str = ""
    preconditions: list = field(default_factory=list)
    creates: list = field(default_factory=list)  # rel strings
    touches: list = field(default_factory=list)
    deletes: list = field(default_factory=list)
    delete_by_filter: list = field(default_factory=list)  # filter dicts

    def to_dict(self) -> dict:
        return self.__dict__.copy()

    @staticmethod
    def from_dict(d: dict) -> "WorkflowInput":
        return WorkflowInput(**d)


@dataclass
class KubeResp:
    status: int
    headers: dict
    body: bytes

    @staticmethod
    def from_activity(out: dict) -> "KubeResp":
        return KubeResp(
            status=out["status"],
            headers=out.get("headers") or {},
            body=base64.b64decode(out.get("body_b64", "")),
        )


def resource_lock_rel(input: WorkflowInput, workflow_id: str) -> str:
    """lock:{hash(path/name/verb)}#workflow@workflow:{id}
    (reference ResourceLockRel, workflow.go:393-419)."""
    lock_key = f"{input.path}/{input.object_name}/{input.verb}"
    lock_hash = hashlib.blake2s(lock_key.encode()).hexdigest()[:16]
    return (f"{LOCK_RESOURCE_TYPE}:{lock_hash}#{LOCK_RELATION}"
            f"@{WORKFLOW_TYPE}:{workflow_id}")


def lock_does_not_exist_precondition(lock_rel: str) -> dict:
    lock_id = lock_rel.split(":", 1)[1].split("#", 1)[0]
    return {
        "must_exist": False,
        "filter": {
            "resource_type": LOCK_RESOURCE_TYPE,
            "resource_id": lock_id,
            "relation": LOCK_RELATION,
            "subject_type": WORKFLOW_TYPE,
        },
    }


def kube_conflict_resp(err: str, input: WorkflowInput) -> dict:
    """SpiceDB failures surface as kube 409 Conflict so clients retry
    (reference KubeConflict, workflow.go:421-457)."""
    status = {
        "kind": "Status",
        "apiVersion": "v1",
        "metadata": {},
        "status": "Failure",
        "message": (
            f'Operation cannot be fulfilled on {input.resource} '
            f'"{input.object_name}": {err}'
        ),
        "reason": "Conflict",
        "details": {"group": input.api_group, "kind": input.resource,
                    "name": input.object_name},
        "code": 409,
    }
    return {
        "status": 409,
        "headers": {"Content-Type": "application/json"},
        "body_b64": base64.b64encode(json.dumps(status).encode()).decode(),
        "retry_after": 0,
    }


def _base_updates(input: WorkflowInput) -> list[dict]:
    return (
        [{"op": "create", "rel": r} for r in input.creates]
        + [{"op": "touch", "rel": r} for r in input.touches]
        + [{"op": "delete", "rel": r} for r in input.deletes]
    )


def _invert(updates: list[dict]) -> list[dict]:
    """CREATE/TOUCH -> DELETE, DELETE -> TOUCH (workflow.go:86-99)."""
    out = []
    for u in updates:
        op = "delete" if u["op"] in ("create", "touch") else "touch"
        out.append({"op": op, "rel": u["rel"]})
    return out


def _cleanup(ctx: WorkflowContext, workflow_id: str, updates: list[dict]):
    """Invert and retry until success (reference Cleanup,
    workflow.go:86-129). Generator: delegate with `yield from`."""
    inverted = _invert(updates)
    attempt = 0
    while True:
        try:
            yield ctx.call("write_to_spicedb", updates=inverted,
                           preconditions=[], workflow_id=workflow_id)
            return
        except ActivityError as e:
            if "invalid" in str(e).lower() or "SchemaViolation" in str(e):
                return  # unrecoverable (workflow.go:116-121)
            attempt += 1
            yield ctx.sleep(min(0.05 * attempt, 1.0))


def _expand_delete_filters(ctx, input: WorkflowInput, updates: list[dict]):
    """Read matching relationships and append concrete deletes so retries
    delete a stable set (reference appendDeletesFromFilters,
    workflow.go:354-389)."""
    for f in input.delete_by_filter:
        rels = yield ctx.call("read_relationships", filter=f)
        for r in rels:
            updates.append({"op": "delete", "rel": r})


def _kube_req(input: WorkflowInput) -> dict:
    return {
        "verb": input.verb,
        "uri": input.uri,
        "headers": input.headers,
        "body_b64": input.body_b64,
    }


def _is_successful(verb: str, status: int) -> bool:
    """Verb-aware success semantics (workflow.go:252-275): a delete of an
    already-gone object (404) and a create of an already-present object
    (409) both count as applied. Any other verb is unsupported for
    dual-writes (workflow.go:264-266 errors rather than guessing) —
    raising here rolls everything back and surfaces the error."""
    if verb == "delete":
        return status in (404, 200)
    if verb in ("create", "update", "patch"):
        return status in (409, 201, 200)
    raise ActivityError(f"unsupported kube verb for dual-write: {verb}")


SUPPORTED_VERBS = ("create", "update", "patch", "delete")


def _validate_verb(verb: str) -> None:
    """Reject unsupported verbs BEFORE any side effect: past this point a
    deterministic verb error would either burn the kube retry budget
    (pessimistic — the activity's error is indistinguishable from a
    transient one) or, worse, pass the optimistic path's existence
    arbitration (a collection GET answers 200) and fabricate success
    over committed relationship writes."""
    if verb not in SUPPORTED_VERBS:
        raise ActivityError(
            f"unsupported kube verb for dual-write: {verb!r} "
            f"(supported: {', '.join(SUPPORTED_VERBS)})")


def pessimistic_write(ctx: WorkflowContext, input_dict: dict):
    input = WorkflowInput.from_dict(input_dict)
    _validate_verb(input.verb)
    lock_rel = resource_lock_rel(input, ctx.instance_id)
    lock_update = {"op": "create", "rel": lock_rel}

    updates = _base_updates(input)
    yield from _expand_delete_filters(ctx, input, updates)

    preconditions = [lock_does_not_exist_precondition(lock_rel)] \
        + list(input.preconditions)

    try:
        yield ctx.call(
            "write_to_spicedb",
            updates=updates + [lock_update],
            preconditions=preconditions,
            workflow_id=ctx.instance_id,
        )
    except ActivityError as e:
        # any SpiceDB failure (incl. lock conflict) -> rollback + kube 409
        # (workflow.go:189-202)
        yield from _cleanup(ctx, ctx.instance_id, updates + [lock_update])
        return kube_conflict_resp(str(e), input)

    backoff = KUBE_BACKOFF_BASE
    for _ in range(MAX_KUBE_ATTEMPTS + 1):
        try:
            out = yield ctx.call("write_to_kube", req=_kube_req(input))
        except ActivityError:
            yield ctx.sleep(backoff)
            backoff *= KUBE_BACKOFF_FACTOR
            continue
        if out.get("retry_after", 0) > 0:
            yield ctx.sleep(out["retry_after"])
            continue
        try:
            ok = _is_successful(input.verb, out["status"])
        except ActivityError:
            # unsupported verb: roll back BEFORE surfacing the error
            # (workflow.go:264-266 — cleanup precedes the error return)
            yield from _cleanup(ctx, ctx.instance_id,
                                updates + [lock_update])
            raise
        if ok:
            yield from _cleanup(ctx, ctx.instance_id, [lock_update])
            return out
        # kube rejected the operation: roll back everything
        yield from _cleanup(ctx, ctx.instance_id, updates + [lock_update])
        return out
    yield from _cleanup(ctx, ctx.instance_id, updates + [lock_update])
    raise ActivityError(
        f"failed to communicate with kubernetes after {MAX_KUBE_ATTEMPTS} attempts")


def optimistic_write(ctx: WorkflowContext, input_dict: dict):
    input = WorkflowInput.from_dict(input_dict)
    _validate_verb(input.verb)
    updates = _base_updates(input)
    yield from _expand_delete_filters(ctx, input, updates)

    try:
        yield ctx.call(
            "write_to_spicedb",
            updates=updates,
            preconditions=list(input.preconditions),
            workflow_id=ctx.instance_id,
        )
    except ActivityError as e:
        yield from _cleanup(ctx, ctx.instance_id, updates)
        return kube_conflict_resp(str(e), input)

    try:
        out = yield ctx.call("write_to_kube", req=_kube_req(input))
    except ActivityError as e:
        # ambiguous failure: did the kube write land? (workflow.go:335-348)
        exists = yield ctx.call("check_kube_resource",
                                path=_resource_path(input))
        if not exists:
            yield from _cleanup(ctx, ctx.instance_id, updates)
            raise ActivityError(f"kube write failed: {e}")
        out = {"status": 200, "headers": {},
               "body_b64": "", "retry_after": 0}
    return out


def _resource_path(input: WorkflowInput) -> str:
    path = input.path
    if input.verb == "create":
        # POST path has no name segment; the existence probe needs it
        name = input.object_name
        if name:
            path = path.rstrip("/") + "/" + name
    return path


def register_workflows(runner) -> None:
    runner.register_workflow(LOCK_MODE_PESSIMISTIC, pessimistic_write)
    runner.register_workflow(LOCK_MODE_OPTIMISTIC, optimistic_write)
