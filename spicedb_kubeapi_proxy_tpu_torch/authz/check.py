"""Check execution: rule templates -> one bulk permission query.

Mirrors the Go proxy's pkg/authz/check.go:17-114: every matching rule's
check (or postcheck) templates generate relationships; ALL of them must
come back permitted. The reference fans out goroutines that each issue a
CheckBulkPermissions RPC; here the entire set is one engine.check_bulk
call — a single batched fixpoint on device.
"""

from __future__ import annotations

from typing import Optional

from ..engine import CheckItem, Engine
from ..rules.compile import RelationshipExpr, RunnableRule
from ..rules.input import ResolveInput


def collect_check_items(exprs: list[RelationshipExpr],
                        input: ResolveInput) -> list[CheckItem]:
    items: list[CheckItem] = []
    for e in exprs:
        for rel in e.generate(input):
            items.append(CheckItem(
                rel.resource_type, rel.resource_id, rel.resource_relation,
                rel.subject_type, rel.subject_id,
                rel.subject_relation or None,
            ))
    return items


def collect_all_items(rules: list[RunnableRule], input: ResolveInput,
                      post: bool = False) -> list[CheckItem]:
    items: list[CheckItem] = []
    for r in rules:
        items.extend(collect_check_items(
            r.post_checks if post else r.checks, input))
    return items


def run_checks(engine: Engine, rules: list[RunnableRule],
               input: ResolveInput, post: bool = False,
               items: Optional[list[CheckItem]] = None,
               context: Optional[dict] = None) -> bool:
    """True iff every generated check passes (fully consistent).
    ``items`` skips re-generating the check relationships when the caller
    already collected them (the cached-probe fast path). ``context`` is
    the request's caveat context (client IP, caller attributes) gating
    conditional grants — missing context fails closed at the engine."""
    if items is None:
        items = collect_all_items(rules, input, post)
    if not items:
        return True
    if context:
        return all(engine.check_bulk(items, context=context))
    return all(engine.check_bulk(items))


def cached_verdict(engine: Engine, rules: list[RunnableRule],
                   input: ResolveInput, post: bool = False,
                   context: Optional[dict] = None
                   ) -> tuple[list[CheckItem], Optional[bool]]:
    """Non-blocking decision-cache probe: ``(items, verdict)`` where
    ``verdict`` is the combined answer when EVERY generated check hit the
    engine's decision cache, else ``None`` (caller falls back to
    :func:`run_checks` off-loop — the probe never dispatches or blocks,
    so the middleware can run it on the event loop and skip the
    ``asyncio.to_thread`` hop entirely on a full hit). Contexted
    requests probe under their context digest — a conditional verdict
    can never be served across contexts."""
    items = collect_all_items(rules, input, post)
    if not items:
        return items, True
    probe = getattr(engine, "try_cached_check", None)
    if probe is None:  # remote engines have no local cache to probe
        return items, None
    got = probe(items, context=context) if context else probe(items)
    if got is None:
        return items, None
    return items, all(got)


def has_checks(rules: list[RunnableRule]) -> bool:
    return any(r.checks for r in rules)
