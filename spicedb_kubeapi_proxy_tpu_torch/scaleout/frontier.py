"""Cross-shard frontier exchange: iterative joins over shard boundaries.

The scale-out contract keeps every query closure shard-local by
REPLICATING reference data: any type a cross-namespace walk passes
through (groups, namespaces) had to be cluster-scoped — present on
every group — or checks anchored on one shard could not see membership
tuples living on another. That caps the "millions of users" story at
whatever replicates everywhere.

This module (a copy of the JAX package's ``scaleout/frontier.py``)
lifts the restriction the TrieJax way: multi-hop graph closure
decomposes into a SEQUENCE of bounded relational joins where only
BOUNDARY tuples ride the wire — a halo exchange between engine groups.
The planner runs a membership-expansion fixpoint:

1. the frontier starts as the query's subject descriptor
   ``(type, id, relation?)``;
2. each round, every group expands the frontier against its LOCAL
   tuples — for every schema *reference pair* ``(type, relation)``
   whose relation admits userset subjects, one
   ``lookup_resources(type, relation, ...)`` per frontier descriptor,
   so multi-hop paths WITHIN the group fold into one local fixpoint
   (each leg is just another ``semiring.propagate`` dispatch: the
   engine hot path needs no new kernel);
3. the planner gathers the groups' newly-resolved userset descriptors
   (the boundary tuples — nothing else moves), dedupes against the
   visited set, and scatters the residue as the next round's seeds;
4. fixpoint when a round resolves nothing new; the round budget is
   HARD — an exhausted budget stops expanding and the caller proceeds
   with the partial closure, which can only UNDER-approximate
   (frontier checks may deny and lookups may under-list, never
   over-grant: fail closed), with the exhaustion counted.

The planner then re-checks denied items on the resource's owner with
each closure descriptor as the subject — the owner holds the
``resource -> userset`` tuple, the closure proved ``subject ∈
userset``, and the engine's userset-subject seeding does the rest.

**Supported schema class.** The decomposition is exact for MONOTONE
(union/arrow/nil) permission graphs: adding membership facts can only
add grants, so per-descriptor re-checks compose by union. Intersection
and exclusion break that composition (a subject can satisfy ``A & B``
through two DIFFERENT membership paths no single descriptor re-check
sees), so :func:`reference_pairs` REFUSES such schemas at enable time
— fail closed, loudly, instead of silently wrong answers.

Wire accounting: :func:`encode_frontier` is the canonical byte form
both the wire op ships and the ``scaleout_frontier_wire_bytes_total``
counter measures — the counter is definitionally the boundary mass,
which is what the bench pins to prove no bulk replication happened.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Optional

from ..models.schema import Exclude, Intersect, Schema, Union
from .shardmap import ShardMapError


class FrontierError(ShardMapError):
    """A schema or configuration the frontier exchange must refuse."""


@dataclass(frozen=True)
class FrontierConfig:
    """Planner-side enablement: ``pairs`` is the reference-pair set
    (``None`` = discover from group 0's schema on first use);
    ``max_rounds`` bounds the exchange — exhaustion fails closed."""

    pairs: Optional[tuple] = None
    max_rounds: int = 8


def _non_monotone(expr) -> bool:
    if isinstance(expr, (Intersect, Exclude)):
        return True
    if isinstance(expr, Union):
        return any(_non_monotone(op) for op in expr.operands)
    return False


def reference_pairs(schema: Schema) -> tuple:
    """The schema's *reference pairs*: every ``(type, relation)``
    REFERENCED as a userset subject somewhere (``team#member`` in
    ``relation owner: team#member`` yields ``("team", "member")``).
    Those usersets are the only subjects tuples can name beyond plain
    objects, so they are exactly the memberships a closure must prove
    — and so the only relations the frontier exchange expands.

    Raises :class:`FrontierError` when the schema pairs usersets with
    intersection or exclusion anywhere: per-descriptor re-checks only
    compose by union (module docstring), so a non-monotone schema must
    keep the cluster-scoped replication contract instead of getting
    silently wrong cross-shard answers."""
    pairs = set()
    for d in schema.definitions.values():
        for rel in d.relations.values():
            for a in rel.allowed:
                if a.relation:
                    pairs.add((a.type, a.relation))
    if not pairs:
        return ()
    for d in schema.definitions.values():
        for p in d.permissions.values():
            if _non_monotone(p.expr):
                raise FrontierError(
                    f"frontier exchange requires a monotone schema, but "
                    f"{d.name}#{p.name} uses intersection/exclusion: a "
                    "per-descriptor re-check cannot see that a subject "
                    "satisfies the branches through different membership "
                    "paths — keep this schema's reference types "
                    "cluster-scoped (replicated) instead")
    return tuple(sorted(pairs))


def encode_frontier(descs) -> bytes:
    """Canonical wire payload of one frontier batch: sorted JSON of
    ``[type, id, relation]`` descriptors. The SAME bytes the wire op
    ships and the wire-bytes counter counts — so the counter provably
    measures boundary mass, not an estimate of it."""
    return json.dumps(
        sorted(([d[0], d[1], d[2]] for d in descs),
               key=lambda d: (d[0], d[1], d[2] or "")),
        separators=(",", ":")).encode("utf-8")


def decode_frontier(raw) -> set:
    """Inverse of :func:`encode_frontier` (also accepts the already-
    parsed list form the JSON wire hands handlers)."""
    if isinstance(raw, (bytes, str)):
        raw = json.loads(raw)
    return {(str(t), str(i), None if r is None else str(r))
            for t, i, r in raw}


def expand_local(engine, descs, pairs, now=None, context=None) -> set:
    """One group's expansion leg, computed against its LOCAL tuples
    (the in-process fallback the ``frontier_expand`` wire op runs
    server-side — one owner for the semantics): for every reference
    pair and frontier descriptor, the userset objects the descriptor
    reaches on this engine. Multi-hop paths through locally-held
    tuples fold into each ``lookup_resources`` fixpoint; paths that
    leave the group surface here as boundary descriptors for the next
    round."""
    out = set()
    for t, rel in pairs:
        for st, sid, srel in descs:
            ids = engine.lookup_resources(
                t, rel, st, sid, subject_relation=srel,
                now=now, context=context)
            out.update((t, str(i), rel) for i in ids)
    return out


__all__ = [
    "FrontierConfig", "FrontierError", "decode_frontier",
    "encode_frontier", "expand_local", "reference_pairs",
]
