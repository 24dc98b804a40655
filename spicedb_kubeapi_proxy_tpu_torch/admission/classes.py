"""The cost classifier: operation -> cost class.

Per-dispatch cost on the compiled graph is predictable enough to budget
against (the TpuGraphs premise, PAPERS.md): a single check reads one
slot, a bulk check shares one fixpoint across its items, a list
prefilter reads a whole type's slot range, and a watch-hub recompute is
a prefilter re-run triggered by write traffic rather than a waiting
client. Each class carries:

- ``weight`` — concurrency units one admitted op occupies against the
  adaptive limit (a lookup occupies 4x what a check does, so 8 admitted
  lists and 32 admitted checks exert the same device pressure);
- ``priority`` — shed order under saturation, LOWEST first: watch
  recomputes (an overloaded hub degrades to staler allowed-sets, not
  dropped requests), then list prefilters, then checks; writes last
  (dual-writes are the requests users retry by hand).
"""

from __future__ import annotations

from dataclasses import dataclass

# the verbs that mutate (the JAX package's rules/proxyrule.py WRITE_VERBS;
# the port keeps its own copy until the rules slice lands)
WRITE_VERBS = ("create", "update", "patch", "delete")


@dataclass(frozen=True)
class CostClass:
    name: str
    weight: float  # concurrency units occupied while admitted
    priority: int  # shed order: lower sheds first

    def __str__(self) -> str:
        return self.name

    def scaled(self, units: int) -> "CostClass":
        """This class charged ``units`` times — the scale-out rule: a
        scatter op is charged once per touched shard (a 4-group
        LookupResources occupies 4x one group's lookup budget), while
        the NAME (and so the shed/metric label) stays the class's own.
        ``units <= 1`` returns self unchanged."""
        if units <= 1:
            return self
        return CostClass(self.name, self.weight * units, self.priority)


CHECK = CostClass("check", 1.0, 2)
BULK_CHECK = CostClass("bulk-check", 2.0, 2)
LOOKUP_PREFILTER = CostClass("lookup-prefilter", 4.0, 1)
WATCH_RECOMPUTE = CostClass("watch-recompute", 4.0, 0)
WRITE_DTX = CostClass("write-dtx", 2.0, 3)
# shard-rebalance mover traffic (scaleout/rebalance.py slice ops):
# cost-accounted like any tenant's bulk work, and the FIRST class shed
# under saturation — a live migration yields to serving traffic by
# design (the mover backs off by the shed's Retry-After and resumes)
REBALANCE = CostClass("rebalance", 2.0, -1)

CLASSES = {c.name: c for c in (CHECK, BULK_CHECK, LOOKUP_PREFILTER,
                               WATCH_RECOMPUTE, WRITE_DTX, REBALANCE)}

# engine-host wire ops that pass through admission (engine/remote.py
# EngineServer._dispatch); everything else — auth, failover_state,
# revision, watch/mirror subscriptions, id-table syncs — is either
# control-plane or too cheap to queue
_OP_CLASSES = {
    "check_bulk": CHECK,  # promoted to BULK_CHECK by item count
    "lookup_resources": LOOKUP_PREFILTER,
    "lookup_mask": LOOKUP_PREFILTER,
    "lookup_subjects": LOOKUP_PREFILTER,  # chunked bulk checks inside
    # one frontier-exchange leg is a batch of lookup_resources against
    # the group's local tuples — same cost shape, same shed class (the
    # planner's scatter fails closed if any leg sheds); frontier_pairs
    # is a pure schema walk and stays ungated control-plane
    "frontier_expand": LOOKUP_PREFILTER,
    "read_relationships": CHECK,
    "watch_since": WATCH_RECOMPUTE,
    "write_relationships": WRITE_DTX,
    "delete_relationships": WRITE_DTX,
    # the live tuple mover's data plane: slice export, idempotent
    # import, catch-up replay, and GC — all sheddable migration traffic
    "slice_read": REBALANCE,
    "slice_load": REBALANCE,
    "slice_apply": REBALANCE,
    "slice_drop": REBALANCE,
    "slice_watch": REBALANCE,
    # live schema migration control plane (migration/migrator.py):
    # operator-driven bulk work, cost-accounted and sheddable beneath
    # tenant traffic exactly like the tuple mover's slice ops
    "migrate_begin": REBALANCE,
    "migrate_status": REBALANCE,
    "migrate_cut": REBALANCE,
    "migrate_abort": REBALANCE,
}


def classify_op(op: str, n_items: int = 1) -> "CostClass | None":
    """Cost class for an engine-host wire op, or None for ungated ops."""
    cls = _OP_CLASSES.get(op)
    if cls is CHECK and op == "check_bulk" and n_items > 1:
        return BULK_CHECK
    return cls


def classify_request(verb: str, rules) -> CostClass:
    """Cost class for one proxy request, from its verb and the matched
    rule set — the class of the request's most expensive engine-bound
    phase. Exception-free by construction (multi-prefilter/multi-update
    misconfigurations surface later on their own paths)."""
    if verb in WRITE_VERBS:
        return WRITE_DTX
    has_prefilter = any(r.pre_filters for r in rules)
    if verb == "watch":
        # a prefiltered watch drives hub recomputes for its lifetime; a
        # plain watch only pays its admission checks
        return WATCH_RECOMPUTE if has_prefilter else CHECK
    if has_prefilter or (verb == "list"
                         and any(r.post_filters for r in rules)):
        return LOOKUP_PREFILTER
    n_checks = sum(len(r.checks) for r in rules)
    return BULK_CHECK if n_checks > 1 else CHECK
