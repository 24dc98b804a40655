"""Rule compilation: specs -> runnable rules with precompiled expressions.

Mirrors the Go proxy's pkg/rules/rules.go Compile (rules.go:716-897): every
template field becomes a compiled expression at boot (literals wrapped as
literal expressions), tupleSets compile to expressions producing lists of
relationship strings, and `if` conditions compile to boolean programs.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..models.tuples import TupleError, parse_rel_fields
from .expr import CompiledExpr, ExprError, compile_expr, compile_template
from .input import ResolveInput
from .proxyrule import (
    PreFilterSpec,
    PostFilterSpec,
    RuleConfig,
    StringOrTemplate,
    UpdateSpec,
)


class CompileError(ValueError):
    pass


@dataclass(frozen=True)
class ResolvedRel:
    resource_type: str
    resource_id: str
    resource_relation: str
    subject_type: str
    subject_id: str
    subject_relation: str = ""

    def __str__(self) -> str:
        s = (f"{self.resource_type}:{self.resource_id}"
             f"#{self.resource_relation}"
             f"@{self.subject_type}:{self.subject_id}")
        if self.subject_relation:
            s += f"#{self.subject_relation}"
        return s


class RelationshipExpr:
    """A compiled expression producing relationships from a ResolveInput
    (reference RelationshipExpr interface, rules.go:148-152)."""

    def generate(self, input: ResolveInput) -> list[ResolvedRel]:
        raise NotImplementedError


@dataclass
class RelExpr(RelationshipExpr):
    """Six compiled field expressions -> exactly one relationship
    (reference RelExpr, rules.go:204-210)."""

    resource_type: CompiledExpr
    resource_id: CompiledExpr
    resource_relation: CompiledExpr
    subject_type: CompiledExpr
    subject_id: CompiledExpr
    subject_relation: Optional[CompiledExpr] = None

    def generate(self, input: ResolveInput) -> list[ResolvedRel]:
        data = input.template_data()
        try:
            rel = ResolvedRel(
                self.resource_type.evaluate_str(data),
                self.resource_id.evaluate_str(data),
                self.resource_relation.evaluate_str(data),
                self.subject_type.evaluate_str(data),
                self.subject_id.evaluate_str(data),
                (self.subject_relation.evaluate_str(data)
                 if self.subject_relation else ""),
            )
        except ExprError as e:
            raise ExprError(f"resolving relationship: {e}") from None
        for f_ in ("resource_type", "resource_id", "resource_relation",
                   "subject_type", "subject_id"):
            if not getattr(rel, f_):
                raise ExprError(f"relationship field {f_} resolved empty")
        return [rel]


@dataclass
class TupleSetExpr(RelationshipExpr):
    """One compiled expression -> a list of relationship strings, each
    parsed into a relationship (reference TupleSetExpr, rules.go:154-201)."""

    expr: CompiledExpr

    def generate(self, input: ResolveInput) -> list[ResolvedRel]:
        data = input.template_data()
        v = self.expr.evaluate(data)
        if not isinstance(v, list):
            raise ExprError(
                f"tupleSet expression must evaluate to a list of relationship "
                f"strings, got {type(v).__name__}")
        out: list[ResolvedRel] = []
        for i, item in enumerate(v):
            if not isinstance(item, str):
                raise ExprError(f"tupleSet item {i} is not a string")
            try:
                f_ = parse_rel_fields(item)
            except TupleError as e:
                raise ExprError(f"tupleSet item {i}: {e}") from None
            out.append(ResolvedRel(
                f_["resource_type"], f_["resource_id"], f_["relation"],
                f_["subject_type"], f_["subject_id"],
                f_["subject_relation"] or "",
            ))
        return out


@dataclass
class PreFilter:
    """LookupResources-based pre-filter (reference rules.go:686-699): the
    rel's resource_id must resolve to `$`; name/namespace expressions map
    each looked-up object id to an allowed (namespace, name)."""

    name_expr: CompiledExpr
    namespace_expr: Optional[CompiledExpr]
    rel: RelExpr

    @property
    def mapping_kind(self) -> str:
        """Classification of the id->(ns, name) mapping so the hot
        prefilter loop can vectorize the dominant forms: "identity"
        ({{resourceId}} name, no namespace expr), "split"
        (split_name/split_namespace pair), or "general" (anything else,
        incl. braceless literals — those have empty refs and mean a
        CONSTANT name, never the id). A property derived from the exprs
        (not stored state) so tests substituting duck-typed expr fakes
        can never leave a stale classification; whitespace inside the
        expression is insignificant ('{{ split_name( resourceId ) }}'
        still vectorizes)."""
        def norm(e) -> Optional[str]:
            if e is None or "resourceId" not in getattr(e, "refs", ()):
                return None
            return "".join(getattr(e, "source", "").split())

        name_src = norm(self.name_expr)
        if name_src == "resourceId" and self.namespace_expr is None:
            return "identity"
        if name_src == "split_name(resourceId)" and \
                norm(self.namespace_expr) == "split_namespace(resourceId)":
            return "split"
        return "general"

    def mapping_shareable(self) -> bool:
        """True when the id→(namespace, name) mapping depends on nothing
        but the looked-up resourceId — then two watchers resolving the
        SAME relationship produce identical allowed sets, and the watch
        hub may compute once and fan out (exprs referencing user/headers/
        request fields disable sharing; over-collected refs only cost the
        optimization, never correctness)."""
        refs = set(self.name_expr.refs)
        if self.namespace_expr is not None:
            refs |= self.namespace_expr.refs
        return refs <= {"resourceId"}


@dataclass
class PostFilter:
    rel: RelationshipExpr


@dataclass
class UpdateSet:
    preconditions_exist: list[RelationshipExpr] = field(default_factory=list)
    preconditions_do_not_exist: list[RelationshipExpr] = field(default_factory=list)
    creates: list[RelationshipExpr] = field(default_factory=list)
    touches: list[RelationshipExpr] = field(default_factory=list)
    deletes: list[RelationshipExpr] = field(default_factory=list)
    delete_by_filter: list[RelationshipExpr] = field(default_factory=list)

    def empty(self) -> bool:
        return not (self.creates or self.touches or self.deletes
                    or self.delete_by_filter)


@dataclass
class RunnableRule:
    """A precompiled rule (reference RunnableRule, rules.go:657-666)."""

    name: str
    locking: str = ""
    ifs: list[CompiledExpr] = field(default_factory=list)
    checks: list[RelationshipExpr] = field(default_factory=list)
    post_checks: list[RelationshipExpr] = field(default_factory=list)
    pre_filters: list[PreFilter] = field(default_factory=list)
    post_filters: list[PostFilter] = field(default_factory=list)
    update: UpdateSet = field(default_factory=UpdateSet)

    def conditions_pass(self, input: ResolveInput) -> bool:
        """All `if` expressions must evaluate true (reference
        EvaluateCELConditions, rules.go:417-464)."""
        if not self.ifs:
            return True
        data = input.condition_data()
        return all(c.evaluate_bool(data) for c in self.ifs)


def _compile_rel_string(tpl: str) -> RelExpr:
    try:
        f_ = parse_rel_fields(tpl)
    except TupleError as e:
        raise CompileError(str(e)) from None
    return RelExpr(
        compile_template(f_["resource_type"]),
        compile_template(f_["resource_id"]),
        compile_template(f_["relation"]),
        compile_template(f_["subject_type"]),
        compile_template(f_["subject_id"]),
        compile_template(f_["subject_relation"]) if f_["subject_relation"] else None,
    )


def _compile_sot(sot: StringOrTemplate) -> RelationshipExpr:
    try:
        if sot.template:
            return _compile_rel_string(sot.template)
        if sot.tuple_set:
            return TupleSetExpr(compile_expr(sot.tuple_set))
        rt = sot.rel_template
        if rt:
            res, sub = rt["resource"], rt["subject"]
            return RelExpr(
                compile_template(str(res.get("type", ""))),
                compile_template(str(res.get("id", ""))),
                compile_template(str(res.get("relation", ""))),
                compile_template(str(sub.get("type", ""))),
                compile_template(str(sub.get("id", ""))),
                (compile_template(str(sub["relation"]))
                 if sub.get("relation") else None),
            )
    except ExprError as e:
        raise CompileError(str(e)) from None
    raise CompileError("empty StringOrTemplate")


def _compile_sot_rel(sot: StringOrTemplate, where: str) -> RelExpr:
    e = _compile_sot(sot)
    if not isinstance(e, RelExpr):
        raise CompileError(f"{where}: tupleSet is not allowed here")
    return e


def _compile_prefilter(p: PreFilterSpec, where: str) -> PreFilter:
    try:
        name_expr = compile_template(p.from_object_id_name_expr)
        ns_expr = (compile_template(p.from_object_id_namespace_expr)
                   if p.from_object_id_namespace_expr else None)
    except ExprError as e:
        raise CompileError(f"{where}: {e}") from None
    rel = _compile_sot_rel(p.lookup_matching_resources, where)
    return PreFilter(name_expr, ns_expr, rel)


def compile_rule(cfg: RuleConfig) -> RunnableRule:
    """Compile one rule config (reference Compile, rules.go:716-897)."""
    s = cfg.spec
    where = f"rule {cfg.name!r}"
    try:
        ifs = [compile_expr(c) for c in s.ifs]
    except ExprError as e:
        raise CompileError(f"{where}: if: {e}") from None
    upd: UpdateSpec = s.update
    return RunnableRule(
        name=cfg.name,
        locking=s.locking,
        ifs=ifs,
        checks=[_compile_sot(c) for c in s.checks],
        post_checks=[_compile_sot(c) for c in s.post_checks],
        pre_filters=[
            _compile_prefilter(p, f"{where}: prefilter") for p in s.pre_filters
        ],
        post_filters=[
            PostFilter(_compile_sot(p.check_permission_template))
            for p in s.post_filters
        ],
        update=UpdateSet(
            preconditions_exist=[
                _compile_sot_rel(x, f"{where}: preconditionExists")
                for x in upd.precondition_exists
            ],
            preconditions_do_not_exist=[
                _compile_sot_rel(x, f"{where}: preconditionDoesNotExist")
                for x in upd.precondition_does_not_exist
            ],
            creates=[_compile_sot(x) for x in upd.creates],
            touches=[_compile_sot(x) for x in upd.touches],
            deletes=[_compile_sot(x) for x in upd.deletes],
            delete_by_filter=[
                _compile_sot_rel(x, f"{where}: deleteByFilter")
                for x in upd.delete_by_filter
            ],
        ),
    )
