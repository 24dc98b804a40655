"""Parser + IR for the Zanzibar-style schema DSL.

A copy of the JAX package's ``models/schema.py`` parser, IR and schema
diff classifier (the port imports nothing of that package). It produces
the typed IR the port's graph compiler (ops/reachability.py) consumes,
caveat definitions (``caveat name(param type, ...) { expr }``, typed and
checked at parse time) and ``with <caveat>`` grants included, and
classifies an S -> S' change for a live migration (:func:`diff_schemas`,
:func:`ir_digest`; migration/).

Supported surface:

    use expiration

    definition ns/name {
        relation viewer: user | group#member | user:* | user with expiration
        permission view = viewer + editor
        permission edit = (a & b) - c
        permission via = parent->view
        permission none = nil
    }

Operator precedence follows SpiceDB: ``-`` and ``&`` and ``+`` are
left-associative at the same precedence level; parenthesize to mix safely.
Arrows bind tighter than binary operators.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Iterator, Optional


class SchemaError(ValueError):
    """Raised on schema parse or validation failure."""


# ---------------------------------------------------------------------------
# IR
# ---------------------------------------------------------------------------


class Expr:
    """Base class for permission userset-rewrite expressions."""

    __slots__ = ()


@dataclass(frozen=True)
class RelationRef(Expr):
    """A reference to a relation or permission on the same definition
    (SpiceDB _this / computed_userset)."""

    name: str

    def __str__(self) -> str:
        return self.name


@dataclass(frozen=True)
class Arrow(Expr):
    """Tupleset-to-userset: ``tupleset->target`` — walk the ``tupleset``
    relation, then evaluate ``target`` on each subject found."""

    tupleset: str
    target: str

    def __str__(self) -> str:
        return f"{self.tupleset}->{self.target}"


@dataclass(frozen=True)
class Union(Expr):
    operands: tuple[Expr, ...]

    def __str__(self) -> str:
        return "(" + " + ".join(map(str, self.operands)) + ")"


@dataclass(frozen=True)
class Intersect(Expr):
    operands: tuple[Expr, ...]

    def __str__(self) -> str:
        return "(" + " & ".join(map(str, self.operands)) + ")"


@dataclass(frozen=True)
class Exclude(Expr):
    """``base - subtract``"""

    base: Expr
    subtract: Expr

    def __str__(self) -> str:
        return f"({self.base} - {self.subtract})"


@dataclass(frozen=True)
class Nil(Expr):
    """``nil`` — the empty userset (bootstrap.yaml's ``no_one_at_all``)."""

    def __str__(self) -> str:
        return "nil"


@dataclass(frozen=True)
class AllowedSubject:
    """One member of a relation's subject-type union.

    ``relation viewer: user | group#member | user:* | activity with expiration``
    """

    type: str
    relation: Optional[str] = None  # userset subjects: group#member
    wildcard: bool = False  # user:*
    expiration: bool = False  # `with expiration` trait
    caveat: Optional[str] = None  # `with <caveat>` trait (validated as
    #                               declared; enforced by caveats/)

    def __str__(self) -> str:
        s = self.type
        if self.wildcard:
            s += ":*"
        if self.relation:
            s += f"#{self.relation}"
        if self.expiration:
            s += " with expiration"
        return s


@dataclass
class Relation:
    name: str
    allowed: list[AllowedSubject]


@dataclass
class Permission:
    name: str
    expr: Expr


@dataclass
class Definition:
    name: str
    relations: dict[str, Relation] = field(default_factory=dict)
    permissions: dict[str, Permission] = field(default_factory=dict)

    def relation_or_permission(self, name: str):
        return self.relations.get(name) or self.permissions.get(name)


@dataclass
class Schema:
    definitions: dict[str, Definition] = field(default_factory=dict)
    use_expiration: bool = False
    # DECLARED caveat names (parse_caveat): distinguishes tuple traits
    # from typos — an UNDECLARED bracket trait (e.g. a misspelled
    # expiration) fails loudly instead of silently dropping the grant
    caveats: set = field(default_factory=set)
    # name -> caveats.ast.CaveatDef: the typed parameter list + body AST
    # the caveat compiler lowers into the VM's tape (caveats/compile.py)
    caveat_defs: dict = field(default_factory=dict)

    def definition(self, name: str) -> Definition:
        try:
            return self.definitions[name]
        except KeyError:
            raise SchemaError(f"unknown definition {name!r}") from None


# ---------------------------------------------------------------------------
# Tokenizer
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+|//[^\n]*|/\*.*?\*/)
  | (?P<str>"(?:[^"\\]|\\.)*"|'(?:[^'\\]|\\.)*')
  | (?P<num>\d+(?:\.\d+)?)
  | (?P<ident>[A-Za-z_][A-Za-z0-9_]*(?:/[A-Za-z_][A-Za-z0-9_]*)*)
  | (?P<op>->|[=!<>]=|&&|\|\||[{}():|+&#*,=<>!./\[\]-])
    """,
    re.VERBOSE | re.DOTALL,
)

KEYWORDS = {"definition", "relation", "permission", "use", "nil", "with", "caveat"}


@dataclass
class _Tok:
    kind: str  # 'ident' | 'op' | 'eof'
    value: str
    pos: int
    line: int


def _tokenize(text: str) -> Iterator[_Tok]:
    pos = 0
    line = 1
    n = len(text)
    while pos < n:
        m = _TOKEN_RE.match(text, pos)
        if not m:
            raise SchemaError(f"schema: unexpected character {text[pos]!r} at line {line}")
        pos = m.end()
        if m.lastgroup == "ws":
            line += m.group().count("\n")
            continue
        yield _Tok(m.lastgroup, m.group(), m.start(), line)
    yield _Tok("eof", "", pos, line)


class _Parser:
    def __init__(self, text: str):
        self.text = text
        self.toks = list(_tokenize(text))
        self.i = 0
        # enclosing-scope breadcrumbs for error messages: operators
        # editing a 500-line schema need "in definition 'pod', relation
        # 'viewer'", not a bare line number
        self._ctx_def: Optional[str] = None
        self._ctx_member: Optional[str] = None

    @property
    def cur(self) -> _Tok:
        return self.toks[self.i]

    def _where(self) -> str:
        if self._ctx_def is None:
            return ""
        if self._ctx_member is None:
            return f" (in definition {self._ctx_def!r})"
        return (f" (in definition {self._ctx_def!r}, "
                f"{self._ctx_member})")

    def fail(self, line: int, msg: str) -> "SchemaError":
        return SchemaError(f"schema line {line}{self._where()}: {msg}")

    def advance(self) -> _Tok:
        t = self.cur
        if t.kind != "eof":
            self.i += 1
        return t

    def expect(self, value: str) -> _Tok:
        t = self.cur
        if t.value != value:
            raise self.fail(
                t.line, f"expected {value!r}, got {t.value or 'EOF'!r}")
        return self.advance()

    def expect_ident(self) -> str:
        t = self.cur
        if t.kind != "ident":
            raise self.fail(
                t.line, f"expected identifier, got {t.value!r}")
        if t.value in KEYWORDS:
            # Keywords are reserved: a relation named `nil` would otherwise
            # silently parse as the empty userset in permission expressions.
            raise self.fail(t.line, f"{t.value!r} is a reserved keyword")
        self.advance()
        return t.value

    # -- grammar -----------------------------------------------------------

    def parse(self) -> Schema:
        schema = Schema()
        while self.cur.kind != "eof":
            if self.cur.value == "use":
                self.advance()
                feature = self.expect_ident()
                if feature == "expiration":
                    schema.use_expiration = True
                # unknown `use` features are tolerated (forward compat)
            elif self.cur.value == "definition":
                d = self.parse_definition()
                if d.name in schema.definitions:
                    raise SchemaError(f"duplicate definition {d.name!r}")
                schema.definitions[d.name] = d
            elif self.cur.value == "caveat":
                defn = self.parse_caveat()
                if defn.name in schema.caveat_defs:
                    raise SchemaError(f"duplicate caveat {defn.name!r}")
                schema.caveats.add(defn.name)
                schema.caveat_defs[defn.name] = defn
            else:
                raise SchemaError(
                    f"schema line {self.cur.line}: expected 'definition', got {self.cur.value!r}"
                )
        _validate(schema)
        return schema

    def parse_caveat(self):
        """``caveat name(param type, ...) { expr }`` -> a typed
        :class:`~...caveats.ast.CaveatDef`. The parameter list follows
        SpiceDB (``day string``; a ``day: string`` colon is tolerated);
        the body is handed to the caveat expression parser
        (caveats/ast.py) and type-checked by compiling it against a
        scratch interner, so a malformed caveat fails the SCHEMA parse
        instead of the first query that touches it."""
        from ..caveats.ast import (
            CaveatDef,
            CaveatError,
            CaveatParam,
            CaveatType,
            SCALAR_TYPES,
            parse_caveat_body,
        )
        from ..caveats.compile import typecheck

        self.expect("caveat")
        name = self.expect_ident()
        self.expect("(")
        params: list = []

        def parse_type() -> CaveatType:
            t = self.cur
            if t.kind != "ident":
                raise SchemaError(
                    f"schema line {t.line}: expected a caveat parameter "
                    f"type, got {t.value!r}")
            self.advance()
            if t.value == "list":
                self.expect("<")
                elem = self.cur
                if elem.kind != "ident" or elem.value not in SCALAR_TYPES:
                    raise SchemaError(
                        f"schema line {elem.line}: unsupported list "
                        f"element type {elem.value!r}")
                self.advance()
                self.expect(">")
                return CaveatType("list", elem.value)
            if t.value not in SCALAR_TYPES:
                raise SchemaError(
                    f"schema line {t.line}: unsupported caveat "
                    f"parameter type {t.value!r}")
            return CaveatType(t.value)

        if self.cur.value != ")":
            while True:
                pname = self.expect_ident()
                if self.cur.value == ":":  # tolerated `name: type` form
                    self.advance()
                params.append(CaveatParam(pname, parse_type()))
                if self.cur.value != ",":
                    break
                self.advance()
        self.expect(")")
        open_tok = self.expect("{")
        depth = 1
        while True:
            t = self.advance()
            if t.kind == "eof":
                raise SchemaError("unterminated caveat block")
            if t.value == "{":
                depth += 1
            elif t.value == "}":
                depth -= 1
                if depth == 0:
                    close_tok = t
                    break
        body = self.text[open_tok.pos + 1:close_tok.pos]
        try:
            defn = CaveatDef(name, tuple(params), parse_caveat_body(body))
            typecheck(defn)
        except CaveatError as e:
            raise SchemaError(f"caveat {name!r}: {e}") from None
        return defn

    def parse_definition(self) -> Definition:
        self.expect("definition")
        name = self.expect_ident()
        d = Definition(name)
        self._ctx_def = name
        self.expect("{")
        while self.cur.value != "}":
            if self.cur.value == "relation":
                r = self.parse_relation()
                if r.name in d.relations or r.name in d.permissions:
                    raise SchemaError(
                        f"definition {name!r}: duplicate "
                        f"relation/permission {r.name!r}")
                d.relations[r.name] = r
            elif self.cur.value == "permission":
                p = self.parse_permission()
                if p.name in d.relations or p.name in d.permissions:
                    raise SchemaError(
                        f"definition {name!r}: duplicate "
                        f"relation/permission {p.name!r}")
                d.permissions[p.name] = p
            else:
                raise self.fail(
                    self.cur.line,
                    f"expected relation/permission, got {self.cur.value!r}")
        self.expect("}")
        self._ctx_def = None
        return d

    def parse_relation(self) -> Relation:
        self.expect("relation")
        name = self.expect_ident()
        self._ctx_member = f"relation {name!r}"
        self.expect(":")
        allowed = [self.parse_allowed_subject()]
        while self.cur.value == "|":
            self.advance()
            allowed.append(self.parse_allowed_subject())
        self._ctx_member = None
        return Relation(name, allowed)

    def parse_allowed_subject(self) -> AllowedSubject:
        typ = self.expect_ident()
        wildcard = False
        relation = None
        expiration = False
        if self.cur.value == ":":
            self.advance()
            self.expect("*")
            wildcard = True
        if self.cur.value == "#":
            self.advance()
            relation = self.expect_ident()
        caveat = None
        while self.cur.value == "with":
            self.advance()
            while True:
                trait = self.expect_ident()
                if trait == "expiration":
                    expiration = True
                else:
                    # a caveated subject type (`user with ip_allowlist`):
                    # tuples carrying the caveat are conditional grants,
                    # enforced on the device by the caveat VM (caveats/).
                    # _validate still requires the name to be DECLARED,
                    # so a misspelled `expiration` cannot slip through
                    # as a phantom caveat.
                    caveat = trait
                # SpiceDB chains traits with `and`:
                # `user with some_caveat and expiration`
                if self.cur.value != "and":
                    break
                self.advance()
        return AllowedSubject(typ, relation, wildcard, expiration, caveat)

    def parse_permission(self) -> Permission:
        self.expect("permission")
        name = self.expect_ident()
        self._ctx_member = f"permission {name!r}"
        self.expect("=")
        expr = self.parse_expr()
        self._ctx_member = None
        return Permission(name, expr)

    def parse_expr(self) -> Expr:
        left = self.parse_term()
        first_op = None
        while self.cur.value in ("+", "&", "-"):
            op = self.advance().value
            # SpiceDB rejects unparenthesized mixing of different operators;
            # silently picking an associativity would change grants
            if first_op is None:
                first_op = op
            elif op != first_op:
                raise self.fail(
                    self.cur.line,
                    f"mixing {first_op!r} and {op!r} requires parentheses")
            right = self.parse_term()
            if op == "+":
                if isinstance(left, Union):
                    left = Union(left.operands + (right,))
                else:
                    left = Union((left, right))
            elif op == "&":
                if isinstance(left, Intersect):
                    left = Intersect(left.operands + (right,))
                else:
                    left = Intersect((left, right))
            else:
                left = Exclude(left, right)
        return left

    def parse_term(self) -> Expr:
        if self.cur.value == "(":
            self.advance()
            e = self.parse_expr()
            self.expect(")")
            return e
        if self.cur.value == "nil":
            self.advance()
            return Nil()
        name = self.expect_ident()
        if self.cur.value == "->":
            self.advance()
            target = self.expect_ident()
            return Arrow(name, target)
        return RelationRef(name)


def _walk(expr: Expr) -> Iterator[Expr]:
    yield expr
    if isinstance(expr, (Union, Intersect)):
        for op in expr.operands:
            yield from _walk(op)
    elif isinstance(expr, Exclude):
        yield from _walk(expr.base)
        yield from _walk(expr.subtract)


def _validate(schema: Schema) -> None:
    for d in schema.definitions.values():
        for r in d.relations.values():
            for a in r.allowed:
                if a.type not in schema.definitions:
                    raise SchemaError(
                        f"{d.name}#{r.name}: unknown subject type {a.type!r}"
                    )
                if a.caveat is not None and a.caveat not in schema.caveats:
                    # tolerate only DECLARED caveats: `with expirations`
                    # (a typo) must fail the parse loudly, not become a
                    # phantom caveat that silently drops grants
                    raise SchemaError(
                        f"{d.name}#{r.name}: unknown trait {a.caveat!r} "
                        "(not 'expiration' and no such caveat declared)"
                    )
                if a.relation is not None:
                    sub = schema.definitions[a.type]
                    if sub.relation_or_permission(a.relation) is None:
                        raise SchemaError(
                            f"{d.name}#{r.name}: unknown subject relation "
                            f"{a.type}#{a.relation}"
                        )
        for p in d.permissions.values():
            for node in _walk(p.expr):
                if isinstance(node, RelationRef):
                    if d.relation_or_permission(node.name) is None:
                        raise SchemaError(
                            f"{d.name}#{p.name}: unknown relation {node.name!r}"
                        )
                elif isinstance(node, Arrow):
                    rel = d.relations.get(node.tupleset)
                    if rel is None:
                        raise SchemaError(
                            f"{d.name}#{p.name}: arrow tupleset {node.tupleset!r} "
                            "must be a relation on the same definition"
                        )
                    # SpiceDB rejects arrows over wildcard-able tuplesets —
                    # a wildcard subject cannot be walked.
                    if any(a.wildcard for a in rel.allowed):
                        raise SchemaError(
                            f"{d.name}#{p.name}: arrow tupleset {node.tupleset!r} "
                            "allows wildcard subjects and cannot be walked"
                        )
                    # target must exist on at least one allowed subject type
                    ok = any(
                        schema.definitions[a.type].relation_or_permission(node.target)
                        for a in rel.allowed
                        if not a.relation  # arrows walk concrete subjects
                    )
                    if not ok:
                        raise SchemaError(
                            f"{d.name}#{p.name}: arrow target {node.target!r} not "
                            f"found on any subject type of {node.tupleset!r}"
                        )


def watch_relevance(schema: Schema, resource_type: str,
                    name: str) -> "tuple[frozenset, bool]":
    """(relevant resource types, reachable expiration) for the permission
    (or relation) ``resource_type#name``. Tuples are keyed by their
    resource type, so a write to a type outside the set provably cannot
    change the permission — watch streams use that to skip allowed-set
    recomputes on unrelated write traffic. The expiration flag is true only
    when some RELATION REACHABLE from the watched permission allows
    ``with expiration`` — a schema carrying expiration on an unrelated
    subtree must not make every idle watcher tick. Both are
    conservative at TYPE granularity; cycles (recursive groups) terminate
    via the seen set."""
    seen: set = set()
    types: set = set()
    expires = False

    def visit(t: str, r: str) -> None:
        nonlocal expires
        if (t, r) in seen:
            return
        seen.add((t, r))
        d = schema.definitions.get(t)
        if d is None:
            return
        types.add(t)
        if r in d.permissions:
            walk(t, d.permissions[r].expr, d)
        elif r in d.relations:
            for a in d.relations[r].allowed:
                if a.expiration:
                    expires = True
                if a.relation:
                    visit(a.type, a.relation)

    def walk(t: str, expr: Expr, d: Definition) -> None:
        if isinstance(expr, RelationRef):
            visit(t, expr.name)
        elif isinstance(expr, Arrow):
            visit(t, expr.tupleset)
            rel = d.relations.get(expr.tupleset)
            for a in (rel.allowed if rel else ()):
                visit(a.type, expr.target)
        elif isinstance(expr, (Union, Intersect)):
            for o in expr.operands:
                walk(t, o, d)
        elif isinstance(expr, Exclude):
            walk(t, expr.base, d)
            walk(t, expr.subtract, d)

    visit(resource_type, name)
    return frozenset(types), expires


def relevant_resource_types(schema: Schema, resource_type: str,
                            name: str) -> frozenset:
    """Resource types whose relationship writes can affect
    ``resource_type#name`` (see :func:`watch_relevance`)."""
    return watch_relevance(schema, resource_type, name)[0]


def parse_schema(text: str) -> Schema:
    """Parse schema DSL text into a validated :class:`Schema`."""
    return _Parser(text).parse()


# ---------------------------------------------------------------------------
# Schema diff classifier (live schema migration, migration/)
# ---------------------------------------------------------------------------

# transition classes, ordered by how much work the migrator must do
ADDITIVE = "additive"  # no tuple rewrites: swap graphs at a revision
REWRITING = "rewriting"  # affected tuples re-validated + journaled backfill
INCOMPATIBLE = "incompatible"  # refused before any state changes


class IncompatibleSchemaChange(SchemaError):
    """Typed refusal: the S -> S' transition cannot be performed online
    (or at all) without operator intervention. Raised BEFORE any engine
    state changes; ``reasons`` carries one line per blocking change."""

    def __init__(self, reasons: "tuple[str, ...]"):
        self.reasons = tuple(reasons)
        super().__init__(
            "incompatible schema change: " + "; ".join(self.reasons))


@dataclass(frozen=True)
class SchemaDiff:
    """The classified S -> S' transition.

    ``changed`` is the core set of ``(definition, member)`` pairs whose
    own declaration differs between the schemas (member = relation or
    permission name; a changed caveat body contributes every relation
    that allows it). ``affected`` is the reachability closure over S':
    every ``(definition, member)`` whose verdict CAN change — i.e. whose
    walk (the same conservative walk `watch_relevance` uses) touches a
    changed element. Everything outside ``affected`` must keep its
    cached decisions and never flap mid-migration; the chaos invariant
    machine-checks that. All members are frozensets, so the diff is
    order-independent by construction: permuting S' definitions yields
    an equal SchemaDiff."""

    classification: str  # ADDITIVE | REWRITING | INCOMPATIBLE
    changed: frozenset  # core {(def, member)} that differ
    affected: frozenset  # closure {(def, member)} whose verdicts may move
    # relations whose TUPLES need re-validation/backfill: the subset of
    # `changed` where the allowed-subject set itself moved
    rewrite_relations: frozenset  # {(def, relation)}
    reasons: tuple = ()  # human-readable, one per contributing change

    def is_affected(self, definition: str, member: str) -> bool:
        return (definition, member) in self.affected


def _allowed_key(a: AllowedSubject) -> tuple:
    return (a.type, a.relation, a.wildcard, a.expiration, a.caveat)


def _member_reach(schema: Schema, dname: str, member: str) -> frozenset:
    """All (definition, relation-or-permission) pairs reachable from
    ``dname#member`` — the same conservative walk as watch_relevance,
    but at MEMBER granularity so the affected closure can spare
    unrelated relations on a shared definition."""
    seen: set = set()

    def visit(t: str, r: str) -> None:
        if (t, r) in seen:
            return
        seen.add((t, r))
        d = schema.definitions.get(t)
        if d is None:
            return
        if r in d.permissions:
            walk(t, d.permissions[r].expr, d)
        elif r in d.relations:
            for a in d.relations[r].allowed:
                if a.relation:
                    visit(a.type, a.relation)

    def walk(t: str, expr: Expr, d: Definition) -> None:
        if isinstance(expr, RelationRef):
            visit(t, expr.name)
        elif isinstance(expr, Arrow):
            visit(t, expr.tupleset)
            rel = d.relations.get(expr.tupleset)
            for a in (rel.allowed if rel else ()):
                visit(a.type, expr.target)
        elif isinstance(expr, (Union, Intersect)):
            for o in expr.operands:
                walk(t, o, d)
        elif isinstance(expr, Exclude):
            walk(t, expr.base, d)
            walk(t, expr.subtract, d)

    visit(dname, member)
    return frozenset(seen)


def diff_schemas(old: Schema, new: Schema) -> SchemaDiff:
    """Classify the ``old`` -> ``new`` transition for live migration.

    - **additive**: new definitions/relations/permissions/caveats, or a
      permission expression change — nothing stored needs rewriting, the
      new graph swaps in at a revision.
    - **rewriting**: an existing relation's allowed-subject set changed
      compatibly (entries gained, or traits attached — e.g. a caveat on
      a live relation) or a declared caveat's definition changed: every
      stored tuple on those relations is re-validated and backfilled
      through the journaled write path before the cut.
    - **incompatible**: removals or kind flips (definition dropped,
      relation/permission dropped, relation<->permission flip, an
      allowed-subject entry dropped, a referenced caveat dropped) —
      stored tuples could be stranded, so the transition is refused
      with :class:`IncompatibleSchemaChange` before any state changes.

    Comparison is purely name-keyed + frozenset-based, so definition
    order in either schema text never changes the result.
    """
    changed: set = set()
    rewrite_relations: set = set()
    reasons: list = []
    fatal: list = []

    # --- caveat declarations -------------------------------------------
    changed_caveats: set = set()
    for cname, cdef in old.caveat_defs.items():
        if cname not in new.caveat_defs:
            # dropping a caveat still allowed by some OLD relation means
            # live conditional tuples lose their evaluator
            used = [f"{d.name}#{r.name}"
                    for d in old.definitions.values()
                    for r in d.relations.values()
                    if any(a.caveat == cname for a in r.allowed)]
            if used:
                fatal.append(
                    f"caveat {cname!r} removed while still allowed by "
                    + ", ".join(sorted(used)))
            else:
                changed_caveats.add(cname)
                reasons.append(f"caveat {cname!r} removed (unused)")
        elif new.caveat_defs[cname] != cdef:
            changed_caveats.add(cname)
            reasons.append(f"caveat {cname!r} definition changed")
    for cname in new.caveat_defs:
        if cname not in old.caveat_defs:
            reasons.append(f"caveat {cname!r} added")

    # --- definitions and members ---------------------------------------
    for dname, od in old.definitions.items():
        nd = new.definitions.get(dname)
        if nd is None:
            fatal.append(f"definition {dname!r} removed")
            continue
        for rname, orel in od.relations.items():
            if rname in nd.permissions:
                fatal.append(
                    f"{dname}#{rname} changed kind relation->permission")
                continue
            nrel = nd.relations.get(rname)
            if nrel is None:
                fatal.append(f"relation {dname}#{rname} removed")
                continue
            old_allowed = frozenset(map(_allowed_key, orel.allowed))
            new_allowed = frozenset(map(_allowed_key, nrel.allowed))
            lost = old_allowed - new_allowed
            gained = new_allowed - old_allowed
            # trait attach/detach shows up as lost+gained on the same
            # (type, relation, wildcard) base; losing the BASE subject
            # entirely strands its tuples -> incompatible
            base = lambda k: k[:3]  # noqa: E731 - local key projection
            lost_bases = {base(k) for k in lost}
            kept_bases = {base(k) for k in new_allowed}
            stranded = lost_bases - kept_bases
            if stranded:
                fatal.append(
                    f"relation {dname}#{rname} dropped subject type(s) "
                    + ", ".join(sorted(str(b[0]) for b in stranded)))
                continue
            if lost or gained:
                changed.add((dname, rname))
                rewrite_relations.add((dname, rname))
                reasons.append(
                    f"relation {dname}#{rname} allowed-subject set "
                    "changed (tuples re-validated)")
            elif any(a.caveat in changed_caveats for a in orel.allowed):
                changed.add((dname, rname))
                rewrite_relations.add((dname, rname))
                reasons.append(
                    f"relation {dname}#{rname} rides a changed caveat")
        for pname, operm in od.permissions.items():
            if pname in nd.relations:
                fatal.append(
                    f"{dname}#{pname} changed kind permission->relation")
                continue
            nperm = nd.permissions.get(pname)
            if nperm is None:
                fatal.append(f"permission {dname}#{pname} removed")
                continue
            if nperm.expr != operm.expr:
                changed.add((dname, pname))
                reasons.append(
                    f"permission {dname}#{pname} expression changed")
    for dname, nd in new.definitions.items():
        od = old.definitions.get(dname)
        if od is None:
            reasons.append(f"definition {dname!r} added")
            for m in list(nd.relations) + list(nd.permissions):
                changed.add((dname, m))
            continue
        for rname in nd.relations:
            if rname not in od.relations and rname not in od.permissions:
                changed.add((dname, rname))
                reasons.append(f"relation {dname}#{rname} added")
        for pname in nd.permissions:
            if pname not in od.permissions and pname not in od.relations:
                changed.add((dname, pname))
                reasons.append(f"permission {dname}#{pname} added")

    if fatal:
        return SchemaDiff(INCOMPATIBLE, frozenset(changed),
                          frozenset(changed), frozenset(),
                          tuple(sorted(fatal)))

    # --- affected closure over S' --------------------------------------
    changed_f = frozenset(changed)
    affected: set = set(changed_f)
    if changed_f:
        for dname, nd in new.definitions.items():
            for m in list(nd.relations) + list(nd.permissions):
                if (dname, m) in affected:
                    continue
                if _member_reach(new, dname, m) & changed_f:
                    affected.add((dname, m))

    cls = REWRITING if rewrite_relations else ADDITIVE
    return SchemaDiff(cls, changed_f, frozenset(affected),
                      frozenset(rewrite_relations), tuple(sorted(reasons)))


def ir_digest(schema: Schema) -> str:
    """Order-independent structural digest of a schema's IR — the
    migration layer's identity test ("did this boot's bootstrap already
    catch up to S'?"). Two schema texts that parse to the same
    definitions/caveats digest identically regardless of declaration
    order or formatting."""
    import hashlib

    parts = []
    for dname in sorted(schema.definitions):
        d = schema.definitions[dname]
        for rname in sorted(d.relations):
            allowed = sorted(map(_allowed_key, d.relations[rname].allowed),
                             key=repr)
            parts.append(f"R {dname}#{rname}:{allowed!r}")
        for pname in sorted(d.permissions):
            parts.append(f"P {dname}#{pname}={d.permissions[pname].expr}")
    for cname in sorted(schema.caveat_defs):
        parts.append(f"C {cname}:{schema.caveat_defs[cname]!r}")
    parts.append(f"use_expiration={schema.use_expiration}")
    return hashlib.sha256("\n".join(parts).encode()).hexdigest()[:16]


def require_compatible(old: Schema, new: Schema) -> SchemaDiff:
    """diff_schemas, but raise :class:`IncompatibleSchemaChange` (with
    every blocking reason) instead of returning an incompatible diff —
    the migrator's front door."""
    diff = diff_schemas(old, new)
    if diff.classification == INCOMPATIBLE:
        raise IncompatibleSchemaChange(diff.reasons)
    return diff
