"""Workflow activities: the side-effect edges of the dual-write.

Mirrors the Go proxy's pkg/authz/distributedtx/activity.go:41-250:
WriteToSpiceDB (with idempotency-key relationships so at-least-once
execution yields exactly-once effects), ReadRelationships, WriteToKube (raw
URI replay against the upstream with admin credentials), and
CheckKubeResource. Every side-effect edge carries failpoint hooks
(activity.go:48,61,153,155,176,213) which simulate process death.
"""

from __future__ import annotations

import base64
import hashlib
import json
import time
from typing import Optional

from ..engine import Engine, Precondition, RelationshipFilter, WriteOp
from ..engine.store import PreconditionFailed, StoreError
from ..models.tuples import Relationship, parse_relationship
from ..proxy.types import ProxyRequest, ProxyResponse, Upstream
from ..utils.failpoints import failpoints

IDEMPOTENCY_KEY_RELATION = "idempotency_key"
WORKFLOW_TYPE = "workflow"
ACTIVITY_TYPE = "activity"
IDEMPOTENCY_KEY_TTL = 24 * 3600.0  # 24h expiration (activity.go:80-102)

_VERB_METHODS = {
    "create": "POST",
    "update": "PUT",
    "patch": "PATCH",
    "delete": "DELETE",
}


def filter_from_dict(d: dict) -> RelationshipFilter:
    return RelationshipFilter(
        resource_type=d.get("resource_type") or None,
        resource_id=d.get("resource_id") or None,
        relation=d.get("relation") or None,
        subject_type=d.get("subject_type") or None,
        subject_id=d.get("subject_id") or None,
        subject_relation=d.get("subject_relation") or None,
    )


class ActivityHandler:
    """Bound to the engine and the admin-credentialed upstream
    (reference ActivityHandler, activity.go:41-46)."""

    def __init__(self, engine: Engine, upstream: Upstream):
        self.engine = engine
        self.upstream = upstream

    def register(self, runner) -> None:
        runner.register_activity("write_to_spicedb", self.write_to_spicedb)
        runner.register_activity("read_relationships", self.read_relationships)
        runner.register_activity("write_to_kube", self.write_to_kube)
        runner.register_activity("check_kube_resource", self.check_kube_resource)

    # -- spicedb side --------------------------------------------------------

    def _idempotency_key(self, workflow_id: str, payload: str) -> Relationship:
        digest = hashlib.blake2s(payload.encode()).hexdigest()[:16]
        return Relationship(
            WORKFLOW_TYPE, workflow_id, IDEMPOTENCY_KEY_RELATION,
            ACTIVITY_TYPE, digest, expiration=time.time() + IDEMPOTENCY_KEY_TTL,
        )

    def write_to_spicedb(self, ctx, updates: list, preconditions: list,
                         workflow_id: str):
        """updates: [{"op": create|touch|delete, "rel": <rel string>}];
        preconditions: [{"must_exist": bool, "filter": {...}}]."""
        failpoints.hit("panicWriteSpiceDB")
        payload = json.dumps([updates, preconditions], sort_keys=True)
        key_rel = self._idempotency_key(workflow_id, payload)
        ops = [WriteOp(u["op"], parse_relationship(u["rel"])) for u in updates]
        ops.append(WriteOp("touch", key_rel))
        pcs = [
            Precondition(filter_from_dict(p["filter"]), bool(p["must_exist"]))
            for p in preconditions
        ]
        try:
            self.engine.write_relationships(ops, pcs)
        except (PreconditionFailed, StoreError) as e:
            # The write may have already been applied by a previous attempt
            # that crashed after the side effect: the idempotency key tells
            # us (activity.go:63-74).
            if self.engine.store.exists(RelationshipFilter(
                resource_type=WORKFLOW_TYPE,
                resource_id=workflow_id,
                relation=IDEMPOTENCY_KEY_RELATION,
                subject_type=ACTIVITY_TYPE,
                subject_id=key_rel.subject_id,
            )):
                failpoints.hit("panicSpiceDBReadResp")
                return {"applied": True, "deduped": True}
            raise
        failpoints.hit("panicSpiceDBReadResp")
        return {"applied": True, "revision": self.engine.revision}

    def read_relationships(self, ctx, filter: dict) -> list:
        failpoints.hit("panicReadSpiceDB")
        rels = [str(r.without_expiration())
                for r in self.engine.read_relationships(filter_from_dict(filter))]
        failpoints.hit("panicSpiceDBReadRelResp")
        return rels

    # -- kube side -----------------------------------------------------------

    async def write_to_kube(self, ctx, req: dict) -> dict:
        """Raw request replay against the upstream with the original
        headers/body (activity.go:175-231)."""
        failpoints.hit("panicKubeWrite")
        method = _VERB_METHODS.get(req["verb"])
        if method is None:
            raise ValueError(f"unsupported kube verb {req['verb']!r}")
        body = base64.b64decode(req.get("body_b64", "")) if req.get("body_b64") \
            else b""
        path, query = _split_uri(req["uri"])
        resp: ProxyResponse = await self.upstream(ProxyRequest(
            method=method, path=path, query=query,
            headers=dict(req.get("headers") or {}), body=body,
        ))
        failpoints.hit("panicKubeReadResp")
        retry_after = 0
        ra = resp.headers.get("Retry-After")
        if ra:
            try:
                retry_after = int(ra)
            except ValueError:
                retry_after = 0
        return {
            "status": resp.status,
            "headers": dict(resp.headers),
            "body_b64": base64.b64encode(resp.body).decode(),
            "retry_after": retry_after,
        }

    async def check_kube_resource(self, ctx, path: str) -> bool:
        """Existence probe after ambiguous kube failures
        (activity.go:233-247)."""
        failpoints.hit("panicCheckKube")
        resp: ProxyResponse = await self.upstream(
            ProxyRequest(method="GET", path=path))
        return resp.status == 200


def _split_uri(uri: str) -> tuple[str, dict]:
    from urllib.parse import parse_qs, unquote, urlsplit

    u = urlsplit(uri)
    return unquote(u.path), parse_qs(u.query, keep_blank_values=True)
