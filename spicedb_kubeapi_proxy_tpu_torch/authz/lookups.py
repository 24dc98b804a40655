"""PreFilter execution: LookupResources -> allowed (namespace, name) set.

Mirrors the Go proxy's pkg/authz/lookups.go:43-136: the prefilter rule's
relationship template must resolve its resource ID to ``$`` (the
match-everything marker); the engine's reverse-reachability query returns
every object id the subject can reach, and the rule's
``fromObjectIDNameExpr`` / ``fromObjectIDNamespaceExpr`` expressions map
each id to an allowed NamespacedName.

The device twist (BASELINE.json north star): instead of streaming ids over
gRPC and mapping one-by-one, the engine hands back a boolean mask over the
type's whole interned object space from a single device pass; when the
mapping expressions are the identity/split forms (the common case, e.g.
deploy/rules.yaml), names are materialized lazily only for allowed ids.
"""

from __future__ import annotations

import asyncio
import logging
from dataclasses import dataclass, field
from typing import Optional

log = logging.getLogger(__name__)

from ..engine import Engine
from ..rules.compile import PreFilter, RunnableRule
from ..rules.expr import ExprError
from ..rules.input import ResolveInput
from ..rules.proxyrule import MATCHING_ID_FIELD_VALUE


class PreFilterError(Exception):
    pass


@dataclass
class AllowedSet:
    """Allowed (namespace, name) pairs; namespace '' for cluster-scoped."""

    pairs: set = field(default_factory=set)
    # lazy utf-8 view for the native wire filter (authz/filterer.py):
    # comparing raw JSON string bytes against encoded pairs skips a
    # per-item decode on the hot loop
    _pairs_bytes: Optional[set] = field(default=None, repr=False,
                                        compare=False)

    def add(self, namespace: str, name: str) -> None:
        self.pairs.add((namespace or "", name))
        self._pairs_bytes = None

    def allows(self, namespace: str, name: str) -> bool:
        return (namespace or "", name) in self.pairs

    def pairs_records(self) -> set:
        """Packed ``b"0" + ns + 0x1f + name`` records, the native wire
        filter's per-item key format — a kept item is ONE set lookup on
        the already-materialized record bytes, no per-item slicing."""
        if self._pairs_bytes is None:
            out = set()
            for ns, n in self.pairs:
                try:
                    out.add(b"0%s\x1f%s" % (ns.encode("utf-8"),
                                            n.encode("utf-8")))
                except UnicodeEncodeError:
                    # lone surrogates cannot appear in an UNESCAPED
                    # record (the scanner validates utf-8); items naming
                    # them arrive escape-flagged and compare via the
                    # decoded-str path against .pairs
                    pass
            self._pairs_bytes = out
        return self._pairs_bytes

    def __len__(self) -> int:
        return len(self.pairs)


def single_prefilter(rules: list[RunnableRule]) -> Optional[tuple[RunnableRule, PreFilter]]:
    """At most one prefilter may apply to a request (reference
    singlePreFilterRule, pkg/authz/rules.go:49-61)."""
    found: list[tuple[RunnableRule, PreFilter]] = []
    for r in rules:
        for p in r.pre_filters:
            found.append((r, p))
    if not found:
        return None
    if len(found) > 1:
        raise PreFilterError(
            f"multiple prefilter rules match the request "
            f"({[r.name for r, _ in found]}); only one is allowed")
    return found[0]


def run_prefilter_sync(engine: Engine, pf: PreFilter,
                       input: ResolveInput,
                       strict: bool = True, lookup=None,
                       context: Optional[dict] = None) -> AllowedSet:
    """``strict=False`` skips ids whose name/namespace mapping expression
    fails instead of raising — for MID-STREAM recomputes, where one
    unmappable id must not freeze the allowed set (a frozen set fails
    OPEN for revocations). The initial, pre-headers run stays strict so
    misconfigured mappings surface as a 500.

    ``lookup`` overrides the engine call with ``lookup(rel) -> [ids]`` —
    the watch hub routes group recomputes through a shared
    :class:`~..engine.batcher.LookupBatcher` this way, so N groups
    triggered by one write batch fuse into ~N/8 device fixpoints
    instead of N (authz/watchhub.py). Results are unconditional by
    construction (caveated tuples never enter the store —
    models/bootstrap.py / engine._validate — so there are no
    CONDITIONAL results to skip; the reference's lookups.go:83-90 skip
    happens here at ingest instead)."""
    rel = pf.rel.generate(input)[0]
    if rel.resource_id != MATCHING_ID_FIELD_VALUE:
        raise PreFilterError(
            f"prefilter resource ID must be {MATCHING_ID_FIELD_VALUE!r}, "
            f"got {rel.resource_id!r} (reference lookups.go:49-56)")
    if lookup is not None:
        # shared-batcher recomputes (watch hub) carry no request context:
        # conditional grants resolve from tuple context alone, missing
        # request-only parameters fail closed — the safe direction for a
        # mid-stream allowed-set refresh
        ids = lookup(rel)
    elif context:
        ids = engine.lookup_resources(
            rel.resource_type, rel.resource_relation,
            rel.subject_type, rel.subject_id, rel.subject_relation or None,
            context=context,
        )
    else:
        ids = engine.lookup_resources(
            rel.resource_type, rel.resource_relation,
            rel.subject_type, rel.subject_id, rel.subject_relation or None,
        )
    allowed = AllowedSet()
    pairs = allowed.pairs
    # Vectorized fast paths for the dominant mapping forms, classified
    # ONCE at rule compile time (rules/compile.py _mapping_kind — the
    # deploy/rules.yaml shapes): at 100k allowed ids the general loop's
    # per-id expression evaluation is the proxy-side cost of a big list
    # filter, and these forms compute the same pairs with plain string
    # ops. Split semantics match expr.py's split_name/split_namespace
    # exactly (first '/' splits; no '/' => cluster-scoped).
    kind = getattr(pf, "mapping_kind", "general")
    if kind == "identity":
        pairs.update(("", obj_id) for obj_id in ids)
        allowed._pairs_bytes = None  # direct .pairs mutation: keep the
        return allowed               # record cache coherent
    if kind == "split":
        for obj_id in ids:
            ns, sep, nm = obj_id.partition("/")
            pairs.add((ns, nm) if sep else ("", obj_id))
        allowed._pairs_bytes = None
        return allowed
    base = input.template_data()
    # one mutable data map, not a copy per id: the exprs only read it,
    # and only resourceId changes between iterations
    data = dict(base)
    name_eval = pf.name_expr.evaluate_str
    ns_eval = pf.namespace_expr.evaluate_str if pf.namespace_expr else None
    skipped = 0
    for obj_id in ids:
        data["resourceId"] = obj_id
        try:
            name = name_eval(data)
            ns = ns_eval(data) if ns_eval else ""
        except ExprError as e:
            if strict:
                raise PreFilterError(
                    f"mapping looked-up id {obj_id!r}: {e}") from None
            # fail-closed skip, but never silently: without a log line a
            # mapping bug surfacing mid-stream would just make objects
            # vanish from watches with nothing to debug from
            skipped += 1
            if skipped == 1:
                log.warning("prefilter id mapping failed for %r "
                            "(skipping; fails closed): %s", obj_id, e)
            continue
        pairs.add((ns or "", name))
    allowed._pairs_bytes = None  # direct .pairs mutation (see fast paths)
    if skipped > 1:
        log.warning("prefilter id mapping skipped %d more ids", skipped - 1)
    return allowed


async def run_prefilter(engine: Engine, pf: PreFilter,
                        input: ResolveInput,
                        strict: bool = True, lookup=None,
                        context: Optional[dict] = None) -> AllowedSet:
    """Async wrapper so the device query overlaps the upstream kube request
    (the reference overlaps via goroutine+channel,
    responsefilterer.go:165-183)."""
    return await asyncio.to_thread(run_prefilter_sync, engine, pf, input,
                                   strict, lookup, context)
