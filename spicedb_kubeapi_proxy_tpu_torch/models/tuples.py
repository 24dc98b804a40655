"""Relationship tuples and their string form (a copy of the JAX package's
``models/tuples.py``; the port imports nothing of that package).

A relationship is ``resource_type:resource_id#relation@subject_type:subject_id``
optionally followed by ``#subject_relation`` (userset subject) and/or an
``[expiration:RFC3339]`` trait: SpiceDB's tuple string format as used in
bootstrap ``relationships`` blocks.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass, replace
from datetime import datetime, timezone
from typing import Optional


class TupleError(ValueError):
    pass


def canonical_context(ctx) -> Optional[str]:
    """Canonical JSON for a caveat context: sorted keys, no whitespace —
    ONE string form per logical context, so (caveat, context) pairs
    intern/deduplicate by string equality and ``parse ∘ format`` is the
    identity on formatted strings. ``None``/empty -> ``None``."""
    if ctx is None:
        return None
    if isinstance(ctx, str):
        t = ctx.strip()
        if not t:
            return None
        try:
            ctx = json.loads(t)
        except ValueError as e:
            raise TupleError(f"invalid caveat context {ctx!r}: {e}") \
                from None
    if not isinstance(ctx, dict):
        raise TupleError(
            f"caveat context must be a JSON object, got {ctx!r}")
    if not ctx:
        return None
    try:
        return json.dumps(ctx, sort_keys=True, separators=(",", ":"))
    except (TypeError, ValueError) as e:
        raise TupleError(f"unserializable caveat context: {e}") from None


# Template splitting (lenient): segments may contain '/', '.', '-', '{{ }}'
# templates, '$' wildcards etc.; only ':', '#', '@' are structural. Same
# shape as the upstream proxy's relRegex.
_TPL_RE = re.compile(
    r"^(?P<resource_type>.*?):(?P<resource_id>.*?)#(?P<relation>.*?)"
    r"@(?P<subject_type>.*?):(?P<subject_id>.*?)(?:#(?P<subject_relation>.*?))?$"
)

# Concrete relationship strings (strict): types/relations are identifiers,
# ids allow the kube-ish charset (slashes for namespacedName, dots, dashes)
# plus '*' for wildcard subjects; an optional [expiration:...] trait must be
# a well-formed suffix — trailing garbage is rejected, not absorbed.
_IDENT = r"[A-Za-z_][A-Za-z0-9_/]*"
# ids additionally allow '@' (email-shaped subjects like user:alice@example.com)
# — unambiguous because the structural '@' separator is always preceded by
# '#relation', and relations cannot contain '@'.
_ID = r"[A-Za-z0-9_.=+/@-]+|\*"
_REL_CORE = (
    rf"(?P<resource_type>{_IDENT}):(?P<resource_id>{_ID})#(?P<relation>{_IDENT})"
    rf"@(?P<subject_type>{_IDENT}):(?P<subject_id>{_ID})"
    rf"(?:#(?P<subject_relation>{_IDENT}|\.\.\.))?"
)
_REL_RE = re.compile(
    "^" + _REL_CORE +
    # optional caveat trait (SpiceDB `[caveat_name]` /
    # `[caveat_name:{...context...}]`) BEFORE the expiration trait; the
    # lookahead keeps `[expiration:...]` out of the caveat group. Parsed
    # tolerantly — enforcement is warn-and-skip at load time
    rf"(?:\[(?!expiration[:\]])(?P<caveat>[A-Za-z_][A-Za-z0-9_/]*)"
    rf"(?::(?P<caveat_ctx>[^\]]*))?\])?"
    rf"(?:\[expiration:(?P<expiration>[^\]]+)\])?$"
)
# a caveat CONTEXT may carry JSON with nested ']' (e.g.
# `[ip_allowlist:{"ips":["10.0.0.0/8"]}]`), which the strict bracket
# grammar above cannot span: this fallback's non-greedy DOTALL context
# backtracks to the real closing bracket; canonical_context then
# validates the JSON, so malformed contexts fail loudly at parse time
_REL_CAVEAT_LENIENT_RE = re.compile(
    "^" + _REL_CORE +
    rf"\[(?!expiration[:\]])(?P<caveat>[A-Za-z_][A-Za-z0-9_/]*)"
    rf":(?P<caveat_ctx>.*?)\]"
    rf"(?:\[expiration:(?P<expiration>[^\]]+)\])?$",
    re.DOTALL,
)

ELLIPSIS = "..."


@dataclass(frozen=True)
class Relationship:
    resource_type: str
    resource_id: str
    relation: str
    subject_type: str
    subject_id: str
    subject_relation: Optional[str] = None  # userset subject, e.g. group#member
    expiration: Optional[float] = None  # unix seconds; None = never expires
    # caveat NAME when the grant is conditional (`[caveat_name]` /
    # `[caveat_name:{...}]`): the tuple participates in checks only when
    # the caveat's expression holds under tuple ∪ request context,
    # evaluated on-device by the caveat VM (caveats/)
    caveat: Optional[str] = None
    # the tuple's stored context as CANONICAL JSON (canonical_context:
    # sorted keys, compact separators) — a string, not a dict, so the
    # frozen dataclass stays hashable and parse↔format is lossless
    caveat_context: Optional[str] = None

    def key(self) -> tuple:
        """Identity key — expiration is an attribute, not identity (TOUCH
        overwrites the expiration of an existing tuple)."""
        return (
            self.resource_type,
            self.resource_id,
            self.relation,
            self.subject_type,
            self.subject_id,
            self.subject_relation or "",
        )

    def without_expiration(self) -> "Relationship":
        return replace(self, expiration=None)

    def context_dict(self) -> Optional[dict]:
        """The stored caveat context as a dict (None when uncaveated or
        context-free)."""
        if not self.caveat_context:
            return None
        return json.loads(self.caveat_context)

    def __str__(self) -> str:
        s = (
            f"{self.resource_type}:{self.resource_id}#{self.relation}"
            f"@{self.subject_type}:{self.subject_id}"
        )
        if self.subject_relation:
            s += f"#{self.subject_relation}"
        if self.caveat:
            # context serializes back losslessly: canonical JSON inside
            # the bracket, exactly what parse_relationship re-reads
            s += (f"[{self.caveat}:{self.caveat_context}]"
                  if self.caveat_context else f"[{self.caveat}]")
        if self.expiration is not None:
            ts = datetime.fromtimestamp(self.expiration, tz=timezone.utc)
            s += f"[expiration:{ts.strftime('%Y-%m-%dT%H:%M:%SZ')}]"
        return s


def parse_expiration(text: str) -> float:
    """RFC3339 → unix seconds."""
    t = text.strip()
    if t.endswith("Z"):
        t = t[:-1] + "+00:00"
    try:
        dt = datetime.fromisoformat(t)
    except ValueError as e:
        raise TupleError(f"invalid expiration {text!r}: {e}") from None
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=timezone.utc)
    return dt.timestamp()


def parse_relationship(text: str) -> Relationship:
    """Parse a concrete relationship string (no templates)."""
    t = text.strip()
    m = _REL_RE.match(t) or _REL_CAVEAT_LENIENT_RE.match(t)
    if not m:
        raise TupleError(f"invalid relationship: {text!r}")
    g = m.groupdict()
    sub_rel = g["subject_relation"] or None
    if sub_rel == ELLIPSIS:
        sub_rel = None
    exp = parse_expiration(g["expiration"]) if g["expiration"] else None
    caveat = g.get("caveat") or None
    # context canonicalizes at parse time (sorted keys, compact), so
    # parse -> format round-trips losslessly and identical logical
    # contexts intern to one store instance
    try:
        ctx = canonical_context(g.get("caveat_ctx")) if caveat else None
    except TupleError as e:
        # a bracket trait with a non-JSON payload is either a malformed
        # context or — more likely — an unknown trait misspelling a
        # structured one (`[expiry:2030-...]` for `[expiration:...]`)
        raise TupleError(
            f"unknown trait or malformed caveat context "
            f"[{caveat}:...] in {text.strip()!r}: {e}") from None
    return Relationship(
        g["resource_type"],
        g["resource_id"],
        g["relation"],
        g["subject_type"],
        g["subject_id"],
        sub_rel,
        exp,
        caveat,
        ctx,
    )


# Permissive charsets for literal template fields: the goal is rejecting
# STRUCTURAL leaks (a stray '#' splitting a subject relation, '@' inside a
# field), not constraining identifiers — kube subjects legitimately carry
# ':' (system:serviceaccount:ns:name) and label-derived relations '/'
# (app.kubernetes.io/name).
_TPL_IDENT_RE = re.compile(r"^[A-Za-z_][A-Za-z0-9_./-]*$")
_TPL_ID_RE = re.compile(r"^(?:[A-Za-z0-9_.=+/:@-]+|\*)$")


def parse_rel_fields(text: str) -> dict:
    """Split a (possibly templated) relationship string into its six fields
    (the upstream proxy's ParseRelSring). Fields containing a
    ``{{ }}`` expression are left for the rules engine to compile; purely
    literal fields are validated against the concrete charset so malformed
    strings (`...@user:alice#a#b`) fail at parse time, not at request
    time."""
    m = _TPL_RE.match(text.strip())
    if not m:
        raise TupleError(f"invalid relationship template: {text!r}")
    g = m.groupdict()
    out = {
        "resource_type": g["resource_type"],
        "resource_id": g["resource_id"],
        "relation": g["relation"],
        "subject_type": g["subject_type"],
        "subject_id": g["subject_id"],
        "subject_relation": g["subject_relation"] or None,
    }
    for k, v in out.items():
        if not v or "{{" in v:
            continue
        rx = _TPL_ID_RE if k in ("resource_id", "subject_id") \
            else _TPL_IDENT_RE
        if not rx.match(v) and v != "$":  # `$` = prefilter/filter wildcard
            raise TupleError(
                f"invalid relationship template field {k}={v!r} in {text!r}")
    return out
