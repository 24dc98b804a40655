"""ProxyRule config schema: YAML/JSON multi-doc parsing + validation.

Mirrors the Go proxy's pkg/config/proxyrule/rule.go: ``authzed.com/v1alpha1
ProxyRule`` documents with match (GVR + verbs), optional CEL-style ``if``
conditions, check/postcheck templates, prefilter (LookupResources mapping),
postfilter (per-object check), and update (creates/touches/deletes/
deleteByFilter + preconditions) with Optimistic/Pessimistic lock modes.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import yaml

API_VERSION = "authzed.com/v1alpha1"
KIND = "ProxyRule"

# LookupResources requests use `$` as the resource ID to signal "match the
# object being processed" (reference rule.go:22-24)
MATCHING_ID_FIELD_VALUE = "$"

LOCK_PESSIMISTIC = "Pessimistic"
LOCK_OPTIMISTIC = "Optimistic"

VALID_VERBS = ("get", "list", "watch", "create", "update", "patch", "delete")
WRITE_VERBS = ("create", "update", "patch", "delete")


class RuleValidationError(ValueError):
    pass


@dataclass
class Match:
    group_version: str  # apiVersion, e.g. "v1" or "apps/v1"
    resource: str
    verbs: list[str]


@dataclass
class StringOrTemplate:
    """Exactly one of: template string, tupleSet expression, or structured
    relationship template (reference rule.go:167-172,242-272)."""

    template: str = ""
    tuple_set: str = ""
    rel_template: Optional[dict] = None  # {resource:{type,id,relation}, subject:{...}}


@dataclass
class PreFilterSpec:
    from_object_id_name_expr: str = ""
    from_object_id_namespace_expr: str = ""
    lookup_matching_resources: Optional[StringOrTemplate] = None


@dataclass
class PostFilterSpec:
    check_permission_template: Optional[StringOrTemplate] = None


@dataclass
class UpdateSpec:
    precondition_exists: list[StringOrTemplate] = field(default_factory=list)
    precondition_does_not_exist: list[StringOrTemplate] = field(default_factory=list)
    creates: list[StringOrTemplate] = field(default_factory=list)
    touches: list[StringOrTemplate] = field(default_factory=list)
    deletes: list[StringOrTemplate] = field(default_factory=list)
    delete_by_filter: list[StringOrTemplate] = field(default_factory=list)

    def empty(self) -> bool:
        return not (self.creates or self.touches or self.deletes
                    or self.delete_by_filter)


@dataclass
class RuleSpec:
    locking: str = ""  # "", Optimistic, Pessimistic
    matches: list[Match] = field(default_factory=list)
    ifs: list[str] = field(default_factory=list)
    checks: list[StringOrTemplate] = field(default_factory=list)
    post_checks: list[StringOrTemplate] = field(default_factory=list)
    pre_filters: list[PreFilterSpec] = field(default_factory=list)
    post_filters: list[PostFilterSpec] = field(default_factory=list)
    update: UpdateSpec = field(default_factory=UpdateSpec)


@dataclass
class RuleConfig:
    name: str
    spec: RuleSpec


def _as_string_or_template(v, where: str) -> StringOrTemplate:
    if not isinstance(v, dict):
        raise RuleValidationError(f"{where}: expected a mapping, got {type(v).__name__}")
    tpl = v.get("tpl", "") or ""
    ts = v.get("tupleSet", "") or ""
    has_rel = "resource" in v or "subject" in v
    count = sum([bool(tpl), bool(ts), has_rel])
    if count == 0:
        raise RuleValidationError(
            f"{where}: one of tpl, tupleSet, or resource/subject is required")
    if count > 1:
        raise RuleValidationError(
            f"{where}: tpl, tupleSet, and resource/subject are mutually exclusive")
    rel = None
    if has_rel:
        for part in ("resource", "subject"):
            if not isinstance(v.get(part), dict):
                raise RuleValidationError(f"{where}: {part} must be a mapping")
        rel = {"resource": v["resource"], "subject": v["subject"]}
    return StringOrTemplate(template=str(tpl), tuple_set=str(ts), rel_template=rel)


def _as_sot_list(v, where: str) -> list[StringOrTemplate]:
    if v is None:
        return []
    if not isinstance(v, list):
        raise RuleValidationError(f"{where}: expected a list")
    return [_as_string_or_template(x, f"{where}[{i}]") for i, x in enumerate(v)]


def parse_rule_configs(text: str) -> list[RuleConfig]:
    """Parse multi-document YAML/JSON rule config (reference Parse,
    rule.go:215-239)."""
    rules: list[RuleConfig] = []
    for di, doc in enumerate(yaml.safe_load_all(text)):
        if doc is None:
            continue
        if not isinstance(doc, dict):
            raise RuleValidationError(f"document {di}: expected a mapping")
        where = f"rule {di}"
        api_version = doc.get("apiVersion", "")
        kind = doc.get("kind", "")
        if api_version and api_version != API_VERSION:
            raise RuleValidationError(
                f"{where}: unsupported apiVersion {api_version!r}")
        if kind and kind != KIND:
            raise RuleValidationError(f"{where}: unsupported kind {kind!r}")
        meta = doc.get("metadata") or {}
        name = str(meta.get("name", f"rule-{di}"))
        where = f"rule {name!r}"

        lock = doc.get("lock", "") or ""
        if lock not in ("", LOCK_OPTIMISTIC, LOCK_PESSIMISTIC):
            raise RuleValidationError(f"{where}: invalid lock mode {lock!r}")

        raw_matches = doc.get("match")
        if not isinstance(raw_matches, list) or not raw_matches:
            raise RuleValidationError(f"{where}: match is required and non-empty")
        matches = []
        for mi, m in enumerate(raw_matches):
            if not isinstance(m, dict):
                raise RuleValidationError(f"{where}: match[{mi}] must be a mapping")
            gv = m.get("apiVersion")
            res = m.get("resource")
            verbs = m.get("verbs")
            if not gv or not res:
                raise RuleValidationError(
                    f"{where}: match[{mi}] needs apiVersion and resource")
            if not isinstance(verbs, list) or not verbs:
                raise RuleValidationError(f"{where}: match[{mi}] needs verbs")
            for v in verbs:
                if v not in VALID_VERBS:
                    raise RuleValidationError(
                        f"{where}: match[{mi}] invalid verb {v!r}")
            matches.append(Match(str(gv), str(res), [str(v) for v in verbs]))

        ifs = doc.get("if") or []
        if not isinstance(ifs, list):
            raise RuleValidationError(f"{where}: if must be a list of expressions")

        pre_filters = []
        for pi, p in enumerate(doc.get("prefilter") or []):
            if not isinstance(p, dict):
                raise RuleValidationError(f"{where}: prefilter[{pi}] must be a mapping")
            lmr = p.get("lookupMatchingResources")
            pf = PreFilterSpec(
                from_object_id_name_expr=str(p.get("fromObjectIDNameExpr", "") or ""),
                from_object_id_namespace_expr=str(
                    p.get("fromObjectIDNamespaceExpr", "") or ""),
                lookup_matching_resources=(
                    _as_string_or_template(
                        lmr, f"{where}: prefilter[{pi}].lookupMatchingResources")
                    if lmr is not None else None
                ),
            )
            if pf.lookup_matching_resources is None:
                raise RuleValidationError(
                    f"{where}: prefilter[{pi}] needs lookupMatchingResources")
            if not pf.from_object_id_name_expr:
                raise RuleValidationError(
                    f"{where}: prefilter[{pi}] needs fromObjectIDNameExpr")
            pre_filters.append(pf)

        post_filters = []
        for pi, p in enumerate(doc.get("postfilter") or []):
            if not isinstance(p, dict) or "checkPermissionTemplate" not in p:
                raise RuleValidationError(
                    f"{where}: postfilter[{pi}] needs checkPermissionTemplate")
            post_filters.append(PostFilterSpec(_as_string_or_template(
                p["checkPermissionTemplate"],
                f"{where}: postfilter[{pi}].checkPermissionTemplate")))

        upd = doc.get("update") or {}
        if not isinstance(upd, dict):
            raise RuleValidationError(f"{where}: update must be a mapping")
        update = UpdateSpec(
            precondition_exists=_as_sot_list(
                upd.get("preconditionExists"), f"{where}: preconditionExists"),
            precondition_does_not_exist=_as_sot_list(
                upd.get("preconditionDoesNotExist"),
                f"{where}: preconditionDoesNotExist"),
            creates=_as_sot_list(upd.get("creates"), f"{where}: creates"),
            touches=_as_sot_list(upd.get("touches"), f"{where}: touches"),
            deletes=_as_sot_list(upd.get("deletes"), f"{where}: deletes"),
            delete_by_filter=_as_sot_list(
                upd.get("deleteByFilter"), f"{where}: deleteByFilter"),
        )

        post_checks = _as_sot_list(doc.get("postcheck"), f"{where}: postcheck")
        if post_checks:
            # PostChecks only apply to read single-object operations
            # (reference validatePostCheckVerbs, rules.go:1076-1093)
            for m in matches:
                bad = [v for v in m.verbs
                       if v in WRITE_VERBS or v in ("list", "watch")]
                if bad:
                    raise RuleValidationError(
                        f"{where}: postcheck is incompatible with verbs {bad}")

        spec = RuleSpec(
            locking=lock,
            matches=matches,
            ifs=[str(x) for x in ifs],
            checks=_as_sot_list(doc.get("check"), f"{where}: check"),
            post_checks=post_checks,
            pre_filters=pre_filters,
            post_filters=post_filters,
            update=update,
        )
        rules.append(RuleConfig(name=name, spec=spec))
    return rules
