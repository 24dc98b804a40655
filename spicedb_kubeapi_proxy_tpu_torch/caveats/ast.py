"""Caveat expression AST, parser, and tri-state oracle interpreter.

The grammar is the subset of CEL that SpiceDB's stock caveats actually
use, spelled with infix operators (the schema DSL is ours, so ``x in
list`` stands in for CEL's ``list.contains(x)``):

    expr     := or
    or       := and ( '||' and )*
    and      := unary ( '&&' unary )*
    unary    := '!' unary | cmp
    cmp      := sum ( ('=='|'!='|'<'|'<='|'>'|'>=') sum )?
             |  sum 'in' sum
    sum      := prod ( ('+'|'-') prod )*
    prod     := atom ( ('*'|'/') atom )*
    atom     := literal | ident | '(' expr ')' | '[' expr, ... ']'

Every value carries one of the declared parameter types (``int``,
``uint``, ``double``, ``bool``, ``string``, ``timestamp``, ``duration``,
``ipaddress``, ``list<T>``). Scalars lower to float64 — int32/uint32,
unix seconds, interned string ids, and IPv4 addresses are all exact in
f64 — and list membership lowers to per-element [lo, hi] range checks,
which makes CIDR allowlists (``10.0.0.0/8``) ordinary comparisons.

Evaluation is three-valued (SpiceDB's partial-evaluation semantics): a
subexpression over missing context is UNKNOWN; ``&&``/``||`` are Kleene
(false short-circuits unknown, true absorbs it); a top-level UNKNOWN is
the missing-context verdict, which the engine fails closed. The
:func:`interpret` here is the differential oracle the vectorized VM
(:mod:`.vm`) is tested against.

A copy of the JAX package's ``caveats/ast.py`` (the port imports nothing of
that package).
"""

from __future__ import annotations

import ipaddress
import re
from dataclasses import dataclass
from datetime import datetime, timezone
from typing import Optional


class CaveatError(ValueError):
    """Raised on caveat parse/type/encoding failure."""


# ---------------------------------------------------------------------------
# Types
# ---------------------------------------------------------------------------

SCALAR_TYPES = ("int", "uint", "double", "bool", "string", "timestamp",
                "duration", "ipaddress")


@dataclass(frozen=True)
class CaveatType:
    """A declared parameter type: a scalar, or ``list<scalar>``."""

    name: str  # one of SCALAR_TYPES, or "list"
    elem: Optional[str] = None  # list element scalar type

    @property
    def is_list(self) -> bool:
        return self.name == "list"

    def __str__(self) -> str:
        return f"list<{self.elem}>" if self.is_list else self.name


@dataclass(frozen=True)
class CaveatParam:
    name: str
    type: CaveatType


@dataclass(frozen=True)
class CaveatDef:
    """One ``caveat name(params) { expr }`` declaration."""

    name: str
    params: tuple  # tuple[CaveatParam, ...]
    expr: "CavExpr"

    def param(self, name: str) -> Optional[CaveatParam]:
        for p in self.params:
            if p.name == name:
                return p
        return None


# ---------------------------------------------------------------------------
# AST
# ---------------------------------------------------------------------------


class CavExpr:
    __slots__ = ()


@dataclass(frozen=True)
class Lit(CavExpr):
    """A literal, already coerced: bool / float scalar, str, or a tuple
    of scalars (list literal). ``type`` is the inferred scalar kind
    ('bool' | 'double' | 'string' | 'list')."""

    value: object
    type: str

    def __str__(self) -> str:
        if self.type == "string":
            return repr(self.value)
        if self.type == "list":
            return "[" + ", ".join(map(str, self.value)) + "]"
        if self.type == "bool":
            return "true" if self.value else "false"
        return repr(self.value)


@dataclass(frozen=True)
class Var(CavExpr):
    name: str

    def __str__(self) -> str:
        return self.name


@dataclass(frozen=True)
class Un(CavExpr):
    op: str  # '!'
    operand: CavExpr

    def __str__(self) -> str:
        return f"!({self.operand})"


@dataclass(frozen=True)
class Bin(CavExpr):
    op: str  # '&&' '||' '==' '!=' '<' '<=' '>' '>=' '+' '-' '*' '/' 'in'
    left: CavExpr
    right: CavExpr

    def __str__(self) -> str:
        return f"({self.left} {self.op} {self.right})"


BOOL_OPS = ("&&", "||")
CMP_OPS = ("==", "!=", "<", "<=", ">", ">=")
ARITH_OPS = ("+", "-", "*", "/")


# ---------------------------------------------------------------------------
# Tokenizer / parser (shares the schema DSL's token shapes)
# ---------------------------------------------------------------------------

_TOK_RE = re.compile(
    r"""
    (?P<ws>\s+|//[^\n]*|/\*.*?\*/)
  | (?P<str>"(?:[^"\\]|\\.)*"|'(?:[^'\\]|\\.)*')
  | (?P<num>\d+(?:\.\d+)?)
  | (?P<ident>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<op><=|>=|==|!=|&&|\|\||[-+*/!<>()\[\],])
    """,
    re.VERBOSE | re.DOTALL,
)


def _tokens(text: str) -> list[tuple[str, str]]:
    out: list[tuple[str, str]] = []
    pos = 0
    n = len(text)
    while pos < n:
        m = _TOK_RE.match(text, pos)
        if not m:
            raise CaveatError(
                f"caveat expression: unexpected character {text[pos]!r}")
        pos = m.end()
        if m.lastgroup == "ws":
            continue
        out.append((m.lastgroup, m.group()))
    out.append(("eof", ""))
    return out


class _P:
    def __init__(self, text: str):
        self.toks = _tokens(text)
        self.i = 0

    @property
    def cur(self):
        return self.toks[self.i]

    def eat(self, value: Optional[str] = None) -> str:
        kind, v = self.toks[self.i]
        if value is not None and v != value:
            raise CaveatError(
                f"caveat expression: expected {value!r}, got {v or 'EOF'!r}")
        if kind != "eof":
            self.i += 1
        return v

    def parse(self) -> CavExpr:
        e = self.expr()
        if self.cur[0] != "eof":
            raise CaveatError(
                f"caveat expression: trailing {self.cur[1]!r}")
        return e

    def expr(self) -> CavExpr:
        left = self.and_()
        while self.cur[1] == "||":
            self.eat()
            left = Bin("||", left, self.and_())
        return left

    def and_(self) -> CavExpr:
        left = self.unary()
        while self.cur[1] == "&&":
            self.eat()
            left = Bin("&&", left, self.unary())
        return left

    def unary(self) -> CavExpr:
        if self.cur[1] == "!":
            self.eat()
            return Un("!", self.unary())
        return self.cmp()

    def cmp(self) -> CavExpr:
        left = self.sum()
        v = self.cur[1]
        if v in CMP_OPS:
            self.eat()
            return Bin(v, left, self.sum())
        if v == "in":
            self.eat()
            return Bin("in", left, self.sum())
        return left

    def sum(self) -> CavExpr:
        left = self.prod()
        while self.cur[1] in ("+", "-"):
            op = self.eat()
            left = Bin(op, left, self.prod())
        return left

    def prod(self) -> CavExpr:
        left = self.atom()
        while self.cur[1] in ("*", "/"):
            op = self.eat()
            left = Bin(op, left, self.atom())
        return left

    def atom(self) -> CavExpr:
        kind, v = self.cur
        if v == "(":
            self.eat()
            e = self.expr()
            self.eat(")")
            return e
        if v == "[":
            self.eat()
            items: list = []
            if self.cur[1] != "]":
                while True:
                    it = self.atom()
                    if not isinstance(it, Lit) or it.type == "list":
                        raise CaveatError(
                            "caveat list literals may hold scalars only")
                    items.append(it.value)
                    if self.cur[1] != ",":
                        break
                    self.eat(",")
            self.eat("]")
            return Lit(tuple(items), "list")
        if kind == "num":
            self.eat()
            return Lit(float(v), "double")
        if kind == "str":
            self.eat()
            body = v[1:-1]
            body = re.sub(r"\\(.)", r"\1", body)
            return Lit(body, "string")
        if kind == "ident":
            self.eat()
            if v == "true":
                return Lit(True, "bool")
            if v == "false":
                return Lit(False, "bool")
            return Var(v)
        if v == "-":  # unary minus on a numeric literal
            self.eat()
            inner = self.atom()
            if isinstance(inner, Lit) and inner.type == "double":
                return Lit(-float(inner.value), "double")
            raise CaveatError("unary '-' applies to numeric literals only")
        raise CaveatError(f"caveat expression: unexpected {v or 'EOF'!r}")


def parse_caveat_body(text: str) -> CavExpr:
    """Parse one caveat body (the text between the braces)."""
    return _P(text).parse()


def walk(expr: CavExpr):
    yield expr
    if isinstance(expr, Un):
        yield from walk(expr.operand)
    elif isinstance(expr, Bin):
        yield from walk(expr.left)
        yield from walk(expr.right)


# ---------------------------------------------------------------------------
# Value coercion (shared by the oracle interpreter and the VM encoders)
# ---------------------------------------------------------------------------


def parse_timestamp(v) -> float:
    """RFC3339 (or unix-seconds number) -> unix seconds."""
    if isinstance(v, (int, float)) and not isinstance(v, bool):
        return float(v)
    t = str(v).strip()
    if t.endswith("Z"):
        t = t[:-1] + "+00:00"
    try:
        dt = datetime.fromisoformat(t)
    except ValueError as e:
        raise CaveatError(f"invalid timestamp {v!r}: {e}") from None
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=timezone.utc)
    return dt.timestamp()


_DUR_RE = re.compile(r"(\d+(?:\.\d+)?)(h|ms|m|s)")
_DUR_UNITS = {"h": 3600.0, "m": 60.0, "s": 1.0, "ms": 1e-3}


def parse_duration(v) -> float:
    """Go-style duration string ("1h30m", "250ms") or number -> seconds."""
    if isinstance(v, (int, float)) and not isinstance(v, bool):
        return float(v)
    t = str(v).strip()
    pos = 0
    total = 0.0
    for m in _DUR_RE.finditer(t):
        if m.start() != pos:
            break
        total += float(m.group(1)) * _DUR_UNITS[m.group(2)]
        pos = m.end()
    if pos != len(t) or pos == 0:
        raise CaveatError(f"invalid duration {v!r}")
    return total


def parse_ip(v) -> float:
    """Dotted-quad IPv4 -> uint32 as float (exact in f64)."""
    try:
        return float(int(ipaddress.IPv4Address(str(v).strip())))
    except (ipaddress.AddressValueError, ValueError) as e:
        raise CaveatError(f"invalid IPv4 address {v!r}: {e}") from None


def parse_cidr_range(v) -> tuple[float, float]:
    """IPv4 address or CIDR -> inclusive [lo, hi] uint32 range."""
    t = str(v).strip()
    try:
        if "/" in t:
            net = ipaddress.IPv4Network(t, strict=False)
            return (float(int(net.network_address)),
                    float(int(net.broadcast_address)))
        a = float(int(ipaddress.IPv4Address(t)))
        return a, a
    except (ipaddress.AddressValueError, ipaddress.NetmaskValueError,
            ValueError) as e:
        raise CaveatError(f"invalid IPv4/CIDR {v!r}: {e}") from None


# -- the 128-bit mapped address space (IPv6 support, ROADMAP PR-9
# -- follow-on): every address — both families — lives in ONE ordered
# -- integer space, the IPv6 space with IPv4 mapped at ::ffff:a.b.c.d.
# -- The VM cannot hold 2^128 on its split planes, so a mapped value is
# -- carried as FOUR 32-bit words (each exact on the planes) and
# -- comparisons lower to word-wise lexicographic checks (compile.py).

_V4_MAPPED_BASE = 0xFFFF00000000  # ::ffff:0:0 as an integer


def parse_ip_mapped(v) -> int:
    """Any IP address (either family) -> its 128-bit mapped integer.
    IPv4 addresses land in the ``::ffff:a.b.c.d`` block so the two
    families order consistently and a bare IPv4 equals its mapped form.
    """
    t = str(v).strip()
    try:
        a = ipaddress.ip_address(t)
    except ValueError as e:
        raise CaveatError(f"invalid IP address {v!r}: {e}") from None
    if isinstance(a, ipaddress.IPv4Address):
        return _V4_MAPPED_BASE + int(a)
    return int(a)


def parse_cidr_range_mapped(v) -> tuple[int, int]:
    """Any address or CIDR (either family) -> inclusive [lo, hi] in the
    128-bit mapped space. An IPv4 CIDR covers exactly its mapped block,
    so a v6 request address can never fall inside a v4 allowlist."""
    t = str(v).strip()
    try:
        if "/" in t:
            net = ipaddress.ip_network(t, strict=False)
            lo, hi = (int(net.network_address),
                      int(net.broadcast_address))
            if isinstance(net, ipaddress.IPv4Network):
                lo, hi = _V4_MAPPED_BASE + lo, _V4_MAPPED_BASE + hi
            return lo, hi
        x = parse_ip_mapped(t)
        return x, x
    except CaveatError:
        raise
    except ValueError as e:
        raise CaveatError(f"invalid IP/CIDR {v!r}: {e}") from None


def ip_words(x: int) -> tuple[int, int, int, int]:
    """A mapped 128-bit address as four big-endian 32-bit words — each
    word exact on the VM's two f32 planes, lexicographic word order ==
    numeric order of the whole address."""
    return ((x >> 96) & 0xFFFFFFFF, (x >> 64) & 0xFFFFFFFF,
            (x >> 32) & 0xFFFFFFFF, x & 0xFFFFFFFF)


def is_v4_mapped(x: int) -> bool:
    return _V4_MAPPED_BASE <= x < _V4_MAPPED_BASE + (1 << 32)


class StringInterner:
    """Host-side string<->code table for caveat string values. Request
    strings never seen in any tuple context or literal get DISTINCT
    negative codes from a per-call :meth:`scratch` view — KNOWN values
    equal to nothing stored (not missing context), and crucially not
    equal to EACH OTHER (one shared sentinel would make any two unseen
    strings compare equal — a fail-open grant)."""

    def __init__(self):
        self._map: dict[str, int] = {}

    def intern(self, s: str) -> int:
        i = self._map.get(s)
        if i is None:
            i = len(self._map)
            self._map[s] = i
        return i

    def lookup(self, s: str) -> int:
        return self._map.get(s, -1)

    def scratch(self) -> "ScratchInterner":
        """A per-evaluation view: known strings resolve to their stored
        codes; unseen strings get fresh distinct negative codes scoped
        to THIS scratch (bounded by the request, never accumulated on
        the shared table)."""
        return ScratchInterner(self)

    def __len__(self) -> int:
        return len(self._map)


class ScratchInterner:
    """Request-scoped code view over a :class:`StringInterner` (see
    :meth:`StringInterner.scratch`). Duck-types the interner surface
    the encoders use."""

    __slots__ = ("_base", "_neg")

    def __init__(self, base: StringInterner):
        self._base = base
        self._neg: dict[str, int] = {}

    def intern(self, s: str) -> int:
        return self._base.intern(s)

    def lookup(self, s: str) -> int:
        i = self._base.lookup(s)
        if i >= 0:
            return i
        got = self._neg.get(s)
        if got is None:
            got = -1 - len(self._neg)
            self._neg[s] = got
        return got

    def __len__(self) -> int:
        return len(self._base)


def encode_scalar(value, typ: str, interner: StringInterner,
                  strict: bool = True) -> float:
    """One context value -> its f64 encoding under a declared scalar
    type. ``strict=False`` (request context) interns nothing new: unknown
    strings become the match-nothing code -1."""
    if typ == "bool":
        if isinstance(value, bool):
            return 1.0 if value else 0.0
        if value in (0, 1):
            return float(value)
        raise CaveatError(f"expected bool, got {value!r}")
    if typ in ("int", "uint", "double"):
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            raise CaveatError(f"expected {typ}, got {value!r}")
        return float(value)
    if typ == "string":
        if not isinstance(value, str):
            raise CaveatError(f"expected string, got {value!r}")
        return float(interner.intern(value) if strict
                     else interner.lookup(value))
    if typ == "timestamp":
        return parse_timestamp(value)
    if typ == "duration":
        return parse_duration(value)
    if typ == "ipaddress":
        # the 128-bit MAPPED integer (both families; exact — Python
        # int, compared exactly against int/float by the oracle). The
        # VM never takes this path: ipaddress scalars lower to four
        # 32-bit word columns there (vm.py).
        return parse_ip_mapped(value)
    raise CaveatError(f"unsupported scalar type {typ!r}")


class UnencodableListError(CaveatError):
    """A WELL-TYPED list context the VM's per-instance range tables
    cannot hold (an IPv6 element in ``list<ipaddress>`` — the split
    planes cap at 2^40). The whole list resolves UNKNOWN — missing
    context, fail closed under BOTH polarities. Dropping the element
    instead would narrow the list to a KNOWN answer, which a negated
    membership (``!(ip in blocked)``) would flip into a grant."""


def encode_list(value, elem: str, interner: StringInterner,
                strict: bool = True) -> list[tuple[float, float]]:
    """A context list -> per-element inclusive [lo, hi] ranges (CIDR
    elements span a range; every other element is a point).

    ``ipaddress`` elements encode in the LEGACY uint32 space — the form
    the VM's per-instance list tables hold (the split planes are exact
    to 2^40; a 128-bit mapped value is not). A list containing any
    IPv6 element is therefore UNENCODABLE: it raises
    :class:`UnencodableListError` (counted,
    ``engine_caveat_ipv6_unencodable_total``) and the parameter stays
    UNKNOWN — fail closed whichever way the expression uses it. Scalar
    IPv6 values and LITERAL IPv6 CIDR lists stay exact via the 4-word
    lowering (compile.py)."""
    if not isinstance(value, (list, tuple)):
        raise CaveatError(f"expected list, got {value!r}")
    out: list[tuple[float, float]] = []
    for item in value:
        if elem == "ipaddress":
            try:
                out.append(parse_cidr_range(item))
            except CaveatError:
                # valid IPv6? -> the whole list is unencodable (see
                # class docstring). Anything else is malformed: keep
                # the original strict/lenient behavior.
                parse_cidr_range_mapped(item)  # raises if malformed
                from ..utils.metrics import metrics

                metrics.counter(
                    "engine_caveat_ipv6_unencodable_total").inc()
                raise UnencodableListError(
                    f"IPv6 element {item!r} in a list<ipaddress> "
                    "context (use literal lists for IPv6 CIDRs)"
                ) from None
        else:
            x = encode_scalar(item, elem, interner, strict)
            out.append((x, x))
    return out


# ---------------------------------------------------------------------------
# Tri-state oracle interpreter
# ---------------------------------------------------------------------------

#: the UNKNOWN truth value (missing context)
UNKNOWN = None


def interpret(expr: CavExpr, ctx: dict, params: dict,
              interner: StringInterner) -> Optional[bool]:
    """Evaluate an expression tri-state against raw context values.

    ``ctx`` maps param name -> RAW value (str/number/bool/list); missing
    names are missing context. ``params`` maps name -> CaveatType.
    Returns True / False / None (UNKNOWN). This is the differential
    oracle for the vectorized VM — deliberately scalar and simple.
    """
    if isinstance(interner, StringInterner):
        # per-call scratch: unseen strings get DISTINCT negative codes
        # (mirrors encode_request — never a shared match-all sentinel)
        interner = interner.scratch()

    def enc(name: str):
        if name not in ctx:
            return UNKNOWN
        t = params.get(name)
        if t is None:
            raise CaveatError(f"unknown caveat parameter {name!r}")
        if t.is_list:
            try:
                return encode_list(ctx[name], t.elem, interner,
                                   strict=False)
            except UnencodableListError:
                return UNKNOWN  # mirrors the VM's unknown list column
        return encode_scalar(ctx[name], t.name, interner, strict=False)

    def ev(e: CavExpr):
        if isinstance(e, Lit):
            if e.type == "string":
                return float(interner.lookup(e.value))
            if e.type == "list":
                # element kind is resolved by the compiler; the oracle
                # re-infers: strings intern, numbers are points
                out = []
                for item in e.value:
                    if isinstance(item, str):
                        x = float(interner.lookup(item))
                        out.append((x, x))
                    else:
                        out.append((float(item), float(item)))
                return out
            if e.type == "bool":
                return bool(e.value)
            return float(e.value)
        if isinstance(e, Var):
            return enc(e.name)
        if isinstance(e, Un):
            v = ev(e.operand)
            if v is UNKNOWN:
                return UNKNOWN
            return not _truthy(v)
        assert isinstance(e, Bin)
        if e.op == "&&":
            left, right = ev(e.left), ev(e.right)
            lt = UNKNOWN if left is UNKNOWN else _truthy(left)
            rt = UNKNOWN if right is UNKNOWN else _truthy(right)
            if lt is False or rt is False:
                return False
            if lt is True and rt is True:
                return True
            return UNKNOWN
        if e.op == "||":
            left, right = ev(e.left), ev(e.right)
            lt = UNKNOWN if left is UNKNOWN else _truthy(left)
            rt = UNKNOWN if right is UNKNOWN else _truthy(right)
            if lt is True or rt is True:
                return True
            if lt is False and rt is False:
                return False
            return UNKNOWN
        if e.op == "in":
            # a literal list's elements encode under the LEFT operand's
            # type — exactly like the compiler's list_of: CIDR strings
            # in an ipaddress membership are ranges, not interned codes
            def scalar_type(node):
                if isinstance(node, Var):
                    t = params.get(node.name)
                    return None if t is None or t.is_list else t.name
                if isinstance(node, Lit):
                    return node.type
                return "double"

            left = ev(e.left)
            lt = scalar_type(e.left)
            literal_list = isinstance(e.right, Lit) \
                and e.right.type == "list"
            if literal_list:
                right = []
                for item in e.right.value:
                    if isinstance(item, str):
                        if lt == "ipaddress":
                            # full mapped 128-bit range: literal CIDR
                            # allowlists stay exact for BOTH families
                            right.append(parse_cidr_range_mapped(item))
                        else:
                            x = float(interner.lookup(item))
                            right.append((x, x))
                    else:
                        right.append((float(item), float(item)))
            else:
                right = ev(e.right)
            if left is UNKNOWN or right is UNKNOWN:
                # an UNKNOWN list stays unknown even for a v6 operand:
                # the encoded tables provably hold no v6 elements, but
                # an unencodable (v6-bearing) list might have — a
                # known miss here would fail OPEN under negation
                return UNKNOWN
            if not isinstance(right, list):
                raise CaveatError("'in' needs a list right-hand side")
            if lt == "ipaddress" and not literal_list:
                # param lists hold the legacy uint32 (v4) ranges: a
                # KNOWN list misses any non-v4-mapped operand (it
                # cannot contain v6 elements), a v4-mapped one compares
                # in the uint32 space — the VM's sentinel lowering
                if not is_v4_mapped(int(_num(left))):
                    return False
                x = int(_num(left)) - _V4_MAPPED_BASE
                return any(lo <= x <= hi for lo, hi in right)
            x = _num(left)
            return any(lo <= x <= hi for lo, hi in right)
        left, right = ev(e.left), ev(e.right)
        if left is UNKNOWN or right is UNKNOWN:
            return UNKNOWN
        a, b = _num(left), _num(right)
        if e.op == "==":
            return a == b
        if e.op == "!=":
            return a != b
        if e.op == "<":
            return a < b
        if e.op == "<=":
            return a <= b
        if e.op == ">":
            return a > b
        if e.op == ">=":
            return a >= b
        if e.op == "+":
            return a + b
        if e.op == "-":
            return a - b
        if e.op == "*":
            return a * b
        if e.op == "/":
            if b == 0:
                return UNKNOWN  # division by zero: no verdict, fail closed
            return a / b
        raise CaveatError(f"unknown operator {e.op!r}")

    out = ev(expr)
    if out is UNKNOWN:
        return None
    return _truthy(out)


def _truthy(v) -> bool:
    if isinstance(v, bool):
        return v
    if isinstance(v, list):
        raise CaveatError("a list is not a boolean caveat result")
    return v != 0.0


def _num(v):
    if isinstance(v, bool):
        return 1.0 if v else 0.0
    if isinstance(v, list):
        raise CaveatError("a list may only appear on the right of 'in'")
    if isinstance(v, int):
        # mapped 128-bit addresses: Python ints compare exactly against
        # ints AND floats — float() would truncate past 2^53
        return v
    return float(v)
