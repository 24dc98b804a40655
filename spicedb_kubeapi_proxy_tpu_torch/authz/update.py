"""Update path: resolve a rule's update set and launch the dual-write.

Mirrors the Go proxy's pkg/authz/update.go:53-271: creates/touches/deletes
(including tupleSet expansion), preconditions and deleteByFilter templates
with the ``$``-dollar wildcard convention ($resourceType/$resourceID/
$resourceRelation/$subjectType/$subjectID/$subjectRelation mean "any"),
resolved against the request input, then handed to the workflow engine;
the caller waits up to 30s for the result.
"""

from __future__ import annotations

import base64
from typing import Optional

from ..dtx.workflow import WorkflowInput
from ..rules.compile import RelationshipExpr, ResolvedRel, RunnableRule, UpdateSet
from ..rules.input import ResolveInput

DOLLAR_FIELDS = {
    "$resourceType", "$resourceID", "$resourceRelation",
    "$subjectType", "$subjectID", "$subjectRelation",
}


class UpdateError(Exception):
    pass


def single_update_rule(rules: list[RunnableRule]) -> Optional[RunnableRule]:
    """At most one rule with updates may match (reference singleUpdateRule,
    pkg/authz/rules.go:21-35)."""
    found = [r for r in rules if not r.update.empty()]
    if not found:
        return None
    if len(found) > 1:
        raise UpdateError(
            f"multiple update rules match the request "
            f"({[r.name for r in found]}); only one is allowed")
    return found[0]


def _rels(exprs: list[RelationshipExpr], input: ResolveInput) -> list[str]:
    out: list[str] = []
    for e in exprs:
        for rel in e.generate(input):
            out.append(str(rel))
    return out


def _filter_from_rel(rel: ResolvedRel, where: str) -> dict:
    """Template fields equal to a ``$``-dollar value (or bare ``$``) mean
    "match any" (reference filterFromRel, update.go:207-271)."""

    def f(value: str, dollar: str) -> Optional[str]:
        if value in ("", "$", dollar):
            return None
        return value

    out = {
        "resource_type": f(rel.resource_type, "$resourceType"),
        "resource_id": f(rel.resource_id, "$resourceID"),
        "relation": f(rel.resource_relation, "$resourceRelation"),
        "subject_type": f(rel.subject_type, "$subjectType"),
        "subject_id": f(rel.subject_id, "$subjectID"),
        "subject_relation": f(rel.subject_relation, "$subjectRelation"),
    }
    if out["resource_type"] is None:
        raise UpdateError(f"{where}: resource type may not be a wildcard")
    return out


def _precondition_dicts(update: UpdateSet, input: ResolveInput) -> list[dict]:
    out = []
    for must_exist, exprs in ((True, update.preconditions_exist),
                              (False, update.preconditions_do_not_exist)):
        for e in exprs:
            for rel in e.generate(input):
                out.append({
                    "must_exist": must_exist,
                    "filter": _filter_from_rel(rel, "precondition"),
                })
    return out


def build_workflow_input(rule: RunnableRule, input: ResolveInput,
                         uri: str, headers: dict) -> WorkflowInput:
    u = rule.update
    return WorkflowInput(
        verb=input.request.verb,
        path=input.request.path,
        uri=uri,
        headers={k: v for k, v in headers.items()
                 if not k.lower().startswith("x-remote-")},
        user_name=input.user.name,
        object_name=input.name,
        namespace=input.namespace,
        api_group=input.request.api_group,
        resource=input.request.resource,
        body_b64=base64.b64encode(input.body).decode() if input.body else "",
        preconditions=_precondition_dicts(u, input),
        creates=_rels(u.creates, input),
        touches=_rels(u.touches, input),
        deletes=_rels(u.deletes, input),
        delete_by_filter=[
            _filter_from_rel(rel, "deleteByFilter")
            for e in u.delete_by_filter
            for rel in e.generate(input)
        ],
    )
