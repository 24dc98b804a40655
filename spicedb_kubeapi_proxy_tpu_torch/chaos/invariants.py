"""System-wide safety invariants checked against live campaign evidence.

Each checker consumes the campaign's op records (what the client tier
actually observed: verdicts, acks, sheds, errors, Retry-After hints) and
the post-episode system state (read-backs, journal, counters), and
returns :class:`InvariantViolation` records — an empty list is the only
acceptable outcome. The four invariants are the ones the README's
dual-write semantics, the durability chain, the failover fencing and the
split journal each promise on their own; here they are judged TOGETHER,
under combined faults. A copy of the JAX package's checkers, pure host
code:

- **never-fail-open** — an injected fault may cost availability, never
  authority: a probe for a permission the oracle denies must answer
  deny/error/shed, NEVER allow. Shed outcomes must carry a bounded
  Retry-After.
- **zero-acked-write-loss** — every write the client tier saw
  acknowledged is present after every crash/failover/split-replay in
  the episode (the loss tables' "acked ⇒ durable" row, and the
  split-journal replay-to-completion rule).
- **no-stale-verdict** — once a revocation is acknowledged and a deny
  has been observed for the revoked grant, no later probe may flip back
  to allow (a cached decision served from a fenced lineage or a dead
  vector would do exactly that).
- **split-journal-completion** — after recovery, no cross-shard write is
  left half-applied: the journal has no pending entries and every acked
  split write is visible on every shard it touched (covered jointly by
  this checker and zero-acked-write-loss's per-shard read-back).

Plus one LIVENESS bound that guards the guards: **retry amplification**
— under a browned-out shard, total retries observed against it stay
within the configured RetryBudget bound (burst + ratio × attempts),
counter-verified. Without it, the transport, failover and scatter retry
layers would multiply a brownout into N_layers × N_retries load (the
metastable-failure shape the budget exists to prevent).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

# op-record kinds the campaign emits
KIND_CHECK = "check"
KIND_WRITE = "write"
KIND_DELETE = "delete"
KIND_LOOKUP = "lookup"
# steady-state probes issued through a live schema migration window:
# the campaign mutates NOTHING these probes depend on, so their
# verdicts carry a flap obligation the ordinary check records (whose
# tuples the campaign churns) cannot
KIND_MIGRATION_PROBE = "migration_probe"

OUTCOME_OK = "ok"
OUTCOME_SHED = "shed"
OUTCOME_ERROR = "error"

# a Retry-After outside (0, this] is unbounded for practical clients —
# the same cap the proxy stamps on its fail-closed 503s
RETRY_AFTER_BOUND_S = 60.0


@dataclass
class OpRecord:
    """One operation's observed fate, as the client tier saw it."""

    kind: str
    outcome: str  # ok | shed | error
    seq: int = 0  # campaign-global issue order (stale-verdict ordering)
    # checks/lookups
    key: str = ""  # the probe's identity (resource#perm@subject)
    verdict: Optional[bool] = None
    expected: Optional[bool] = None  # oracle expectation; None = unknown
    # writes
    rel: str = ""  # unique relationship key; acked iff outcome == ok
    shards: tuple = ()  # shard groups this write touched
    # sheds
    retry_after: Optional[float] = None
    error: str = ""


@dataclass(frozen=True)
class InvariantViolation:
    invariant: str
    detail: str

    def __str__(self) -> str:  # campaign logs read naturally
        return f"[{self.invariant}] {self.detail}"


@dataclass
class EpisodeEvidence:
    """Everything one episode hands the checkers."""

    name: str
    records: list = field(default_factory=list)  # [OpRecord]
    # rel-key -> True/False presence at read-back time (post-recovery)
    readback: dict = field(default_factory=dict)
    pending_splits: Optional[int] = None
    # retry-budget accounting for the faulted dependency (brownout)
    retries_observed: Optional[float] = None
    budget_ratio: Optional[float] = None
    budget_burst: Optional[float] = None
    attempts: Optional[int] = None
    # the journal's persisted rebalance-transition record AFTER the
    # episode's recovery completed (None when cleared — or when the
    # episode ran no rebalance and the field carries no obligation)
    rebalance_transition: Optional[dict] = None
    # live schema migration window (migration/migrator.py): the probe
    # keys the migration's diff marked AFFECTED (these may legitimately
    # change verdict across the cut; every other migration_probe key
    # must not), and the engine's migration status after the episode's
    # recovery completed (None = no migration ran)
    migration_affected: frozenset = frozenset()
    migration_status: Optional[dict] = None


def check_never_fail_open(records: list) -> list[InvariantViolation]:
    """No oracle-denied probe may be answered allow; shed outcomes must
    carry a bounded Retry-After (a shed without one strands polite
    clients in open-loop hammering — availability chaos of its own)."""
    out: list[InvariantViolation] = []
    for r in records:
        if r.kind in (KIND_CHECK, KIND_LOOKUP) and r.outcome == OUTCOME_OK \
                and r.expected is False and r.verdict is True:
            out.append(InvariantViolation(
                "never-fail-open",
                f"probe {r.key!r} (seq {r.seq}) answered ALLOW for a "
                "subject the oracle denies"))
        if r.outcome == OUTCOME_SHED:
            ra = r.retry_after
            if ra is None or not (0 < ra <= RETRY_AFTER_BOUND_S):
                out.append(InvariantViolation(
                    "never-fail-open",
                    f"shed of {r.kind} (seq {r.seq}) carried an "
                    f"unbounded Retry-After ({ra!r})"))
    return out


def check_zero_acked_write_loss(records: list, readback: dict
                                ) -> list[InvariantViolation]:
    """Every acked write's relationship is present at read-back. The
    read-back runs AFTER every crash/failover/replay of the episode, so
    a loss here is a durability-chain break, not a timing artifact.
    Unacked writes (errors, sheds, ambiguous transport deaths) carry no
    obligation either way — at-least-once is the contract."""
    out: list[InvariantViolation] = []
    for r in records:
        if r.kind != KIND_WRITE or r.outcome != OUTCOME_OK:
            continue
        present = readback.get(r.rel)
        if present is None:
            out.append(InvariantViolation(
                "zero-acked-write-loss",
                f"acked write {r.rel!r} (seq {r.seq}) was never "
                "read back — campaign bug, treated as a violation"))
        elif not present:
            out.append(InvariantViolation(
                "zero-acked-write-loss",
                f"acked write {r.rel!r} (seq {r.seq}) is MISSING after "
                "recovery"))
    return out


def check_no_stale_verdict(records: list) -> list[InvariantViolation]:
    """Per probe key, once (a) its revocation was acked and (b) a deny
    was observed after that ack, any LATER allow is a stale verdict —
    some cache tier served a decision from before the revocation."""
    out: list[InvariantViolation] = []
    by_key: dict[str, list] = {}
    revoked_at: dict[str, int] = {}
    for r in sorted(records, key=lambda r: r.seq):
        if r.kind == KIND_DELETE and r.outcome == OUTCOME_OK and r.key:
            revoked_at.setdefault(r.key, r.seq)
        if r.kind == KIND_CHECK and r.outcome == OUTCOME_OK and r.key:
            by_key.setdefault(r.key, []).append(r)
    for key, probes in by_key.items():
        rev = revoked_at.get(key)
        if rev is None:
            continue
        denied_seq = None
        for r in probes:
            if r.seq <= rev:
                continue
            if r.verdict is False and denied_seq is None:
                denied_seq = r.seq
            elif r.verdict is True and denied_seq is not None:
                out.append(InvariantViolation(
                    "no-stale-verdict",
                    f"probe {key!r} flipped back to ALLOW at seq "
                    f"{r.seq} after the revocation (seq {rev}) was "
                    f"already visible as a deny at seq {denied_seq}"))
                break
    return out


def check_split_journal_complete(pending_splits: Optional[int]
                                 ) -> list[InvariantViolation]:
    if pending_splits is None:
        return []
    if pending_splits > 0:
        return [InvariantViolation(
            "split-journal-completion",
            f"{pending_splits} cross-shard write(s) still pending after "
            "recovery — a half-applied split may be visible")]
    return []


def check_rebalance_converged(transition_doc: Optional[dict]
                              ) -> list[InvariantViolation]:
    """A crash-interrupted rebalance must land COMPLETED (every slice
    cut, map committed — recorded as the durable phase-"done" marker a
    stale-flag restart boots the committed map from) or CLEANLY
    ABORTED (record cleared with routing never having left V). Any
    other record still persisted after the episode's recovery finished
    means the placement is parked half-routed — cut slices served from
    the new map, uncut ones from the old, with nobody driving it
    forward."""
    if transition_doc is None or transition_doc.get("phase") == "done":
        return []
    slices = transition_doc.get("slices", [])
    cut = sum(1 for s in slices if s.get("state") == "cut")
    return [InvariantViolation(
        "rebalance-converged",
        f"rebalance transition (phase "
        f"{transition_doc.get('phase')!r}, {cut}/{len(slices)} slices "
        "cut) still persisted after recovery — neither completed nor "
        "cleanly aborted")]


def check_no_verdict_flap(records: list,
                          affected: frozenset = frozenset()
                          ) -> list[InvariantViolation]:
    """Through a live schema migration, a probe for a permission the
    migration's diff did NOT mark affected must answer the SAME verdict
    before, during, and after the cut — any flip means the cutover
    leaked schema-change effects outside the affected closure (a stale
    decision-cache entry surviving retire_affected, or the new graph
    disagreeing with the old on untouched reachability). Probes for
    AFFECTED keys are exempt: changing their verdict is the migration's
    entire point. Error/shed outcomes carry no obligation — a fault may
    cost availability, never verdict stability."""
    out: list[InvariantViolation] = []
    first: dict[str, "tuple[int, bool]"] = {}
    for r in sorted(records, key=lambda r: r.seq):
        if r.kind != KIND_MIGRATION_PROBE or r.outcome != OUTCOME_OK \
                or r.verdict is None or not r.key:
            continue
        if r.key in affected:
            continue
        seen = first.get(r.key)
        if seen is None:
            first[r.key] = (r.seq, r.verdict)
        elif r.verdict != seen[1]:
            out.append(InvariantViolation(
                "no-verdict-flap",
                f"unaffected probe {r.key!r} flipped "
                f"{seen[1]}->{r.verdict} at seq {r.seq} (first seen at "
                f"seq {seen[0]}) across the migration window"))
    return out


def check_migration_converged(status: Optional[dict]
                              ) -> list[InvariantViolation]:
    """A crash-interrupted schema migration must land DONE (cut
    persisted and finished) or CLEANLY ABORTED — the same all-or-
    nothing obligation the rebalance transition carries. A status still
    parked in a working phase after the episode's recovery finished
    means the engine serves with a half-applied schema change."""
    if status is None:
        return []
    phase = status.get("phase")
    if phase in ("done", "aborted"):
        return []
    return [InvariantViolation(
        "migration-converged",
        f"schema migration still in phase {phase!r} after recovery — "
        "neither completed nor cleanly aborted"
        + (f" (error: {status.get('error')})" if status.get("error")
           else ""))]


def retry_amplification_bound(ratio: float, burst: float,
                              attempts: int, slack: float = 2.0) -> float:
    """The budget's worst-case total-retry bound for ``attempts``
    logical calls: the full burst plus the per-attempt refill, with a
    small additive ``slack`` for in-flight races (a token deposited and
    withdrawn around the measurement edges)."""
    return burst + ratio * attempts + slack


def check_retry_amplification(retries_observed: Optional[float],
                              ratio: Optional[float],
                              burst: Optional[float],
                              attempts: Optional[int]
                              ) -> list[InvariantViolation]:
    if retries_observed is None or ratio is None or burst is None \
            or attempts is None:
        return []
    bound = retry_amplification_bound(ratio, burst, attempts)
    if retries_observed > bound:
        return [InvariantViolation(
            "retry-amplification",
            f"{retries_observed:.0f} retries observed at the faulted "
            f"dependency exceed the RetryBudget bound {bound:.0f} "
            f"(burst {burst:g} + {ratio:g} × {attempts} attempts)")]
    return []


def check_all(ev: EpisodeEvidence) -> list[InvariantViolation]:
    """Every checker over one episode's evidence (the campaign's
    per-episode gate)."""
    out: list[InvariantViolation] = []
    out += check_never_fail_open(ev.records)
    out += check_zero_acked_write_loss(ev.records, ev.readback)
    out += check_no_stale_verdict(ev.records)
    out += check_split_journal_complete(ev.pending_splits)
    out += check_retry_amplification(ev.retries_observed, ev.budget_ratio,
                                     ev.budget_burst, ev.attempts)
    out += check_rebalance_converged(ev.rebalance_transition)
    out += check_no_verdict_flap(ev.records, ev.migration_affected)
    out += check_migration_converged(ev.migration_status)
    return out


__all__ = [
    "EpisodeEvidence", "InvariantViolation", "OpRecord",
    "KIND_CHECK", "KIND_DELETE", "KIND_LOOKUP",
    "KIND_MIGRATION_PROBE", "KIND_WRITE",
    "OUTCOME_ERROR", "OUTCOME_OK", "OUTCOME_SHED",
    "check_all", "check_migration_converged", "check_never_fail_open",
    "check_no_stale_verdict", "check_no_verdict_flap",
    "check_rebalance_converged", "check_retry_amplification",
    "check_split_journal_complete", "check_zero_acked_write_loss",
    "retry_amplification_bound",
]
