"""The host expression language for rule templates, tupleSets and conditions.

The reference embeds two expression runtimes: Bloblang for relationship
templates / tupleSets (with custom ``split_name`` / ``split_namespace``
functions, the Go proxy's pkg/rules/env.go:13-58) and CEL for ``if``
conditions (rules.go:45-51,417-464). SURVEY.md §7 calls for ONE host
language keeping the ``{{ }}``/literal duality (rules.go:1005-1026); this
module implements it: a small expression language whose surface covers both
uses —

- field access & indexing:      ``user.name``, ``object.metadata.labels["x"]``
- root reference:               ``this`` (the whole input document)
- lambdas / iteration:          ``items.map_each(this.name)``, ``.filter(...)``
- context capture:              ``expr.(nsName -> body)``
- let bindings (multi-line):    ``let ns = this.namespace`` then ``$ns``/``ns``
- fallback on error/null:       ``expr | default``
- conditionals:                 ``if c { a } else { b }`` and CEL ``c ? a : b``
- operators:  ``== != < <= > >= && || ! in + - * / %``
- methods: ``string() number() length() split(s) join(s) trim() uppercase()
  lowercase() contains(x) startsWith(x) endsWith(x) matches(re) or(d)
  keys() values() exists(k)``
- functions: ``split_name(s)``, ``split_namespace(s)`` (the custom Bloblang
  env), ``has(x)``, ``size(x)``, ``string(x)``, ``int(x)``

Compilation happens once at rule-load (boot), evaluation per request.
"""

from __future__ import annotations

import json
import re as _re
from dataclasses import dataclass
from typing import Any, Callable, Optional


class ExprError(ValueError):
    pass


class _Missing:
    """Null-ish result of accessing an absent field; attribute access chains
    silently, most other uses raise (recoverable via the `|` operator)."""

    _instance: "_Missing" = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self):
        return "<missing>"


MISSING = _Missing()


# ---------------------------------------------------------------------------
# Tokenizer
# ---------------------------------------------------------------------------

_TOKEN_RE = _re.compile(
    r"""
    (?P<ws>\s+)
  | (?P<num>\d+(?:\.\d+)?)
  | (?P<str>"(?:[^"\\]|\\.)*"|'(?:[^'\\]|\\.)*')
  | (?P<ident>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<dollar>\$[A-Za-z_][A-Za-z0-9_]*)
  | (?P<op>->|\|\||&&|[=!<>]=|[.()\[\]{},:?|<>!+*/%$=-])
    """,
    _re.VERBOSE,
)

@dataclass
class _Tok:
    kind: str
    value: str


def _tokenize(text: str) -> list[_Tok]:
    out: list[_Tok] = []
    pos = 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if not m:
            raise ExprError(f"unexpected character {text[pos]!r} in expression")
        pos = m.end()
        kind = m.lastgroup
        if kind == "ws":
            continue
        out.append(_Tok(kind, m.group()))
    out.append(_Tok("eof", ""))
    return out


# ---------------------------------------------------------------------------
# AST (closures — each node compiles to a Python callable of (env))
# ---------------------------------------------------------------------------


class _Env:
    __slots__ = ("data", "vars", "this")

    def __init__(self, data, vars_=None, this=None):
        self.data = data
        self.vars = vars_ or {}
        self.this = data if this is None else this


_Node = Callable[[_Env], Any]


def _truthy(v) -> bool:
    if v is MISSING or v is None:
        return False
    if isinstance(v, bool):
        return v
    raise ExprError(f"expected boolean, got {type(v).__name__}: {v!r}")


def _tostr(v) -> str:
    if isinstance(v, str):
        return v
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        if isinstance(v, float) and v.is_integer():
            return str(int(v))
        return str(v)
    if v is None or v is MISSING:
        raise ExprError("cannot convert null to string")
    return json.dumps(v)


class _Parser:
    def __init__(self, text: str):
        self.toks = _tokenize(text)
        self.i = 0
        # root identifiers the compiled program may read from the DATA map
        # (over-collection is fine — let-bound names land here too; callers
        # use this to prove an expr depends on nothing but, say,
        # resourceId, so extra names only disable an optimization)
        self.refs: set = set()

    @property
    def cur(self) -> _Tok:
        return self.toks[self.i]

    def advance(self) -> _Tok:
        t = self.toks[self.i]
        if t.kind != "eof":
            self.i += 1
        return t

    def accept(self, value: str) -> bool:
        if self.cur.value == value and self.cur.kind in ("op", "ident"):
            self.advance()
            return True
        return False

    def expect(self, value: str):
        if not self.accept(value):
            raise ExprError(f"expected {value!r}, got {self.cur.value!r}")

    # program := (let IDENT = expr)* expr
    def parse_program(self) -> _Node:
        lets: list[tuple[str, _Node]] = []
        while self.cur.kind == "ident" and self.cur.value == "let":
            self.advance()
            if self.cur.kind != "ident":
                raise ExprError("expected identifier after let")
            name = self.advance().value
            self.expect("=")
            lets.append((name, self.parse_expr()))
        body = self.parse_expr()
        if self.cur.kind != "eof":
            raise ExprError(f"unexpected trailing input: {self.cur.value!r}")
        if not lets:
            return body

        def run(env: _Env):
            env2 = _Env(env.data, dict(env.vars), env.this)
            for name, node in lets:
                env2.vars[name] = node(env2)
            return body(env2)

        return run

    def parse_expr(self) -> _Node:
        return self.parse_ternary()

    def parse_ternary(self) -> _Node:
        cond = self.parse_or()
        if self.accept("?"):
            a = self.parse_expr()
            self.expect(":")
            b = self.parse_expr()
            return lambda env: a(env) if _truthy(cond(env)) else b(env)
        return cond

    def parse_or(self) -> _Node:
        left = self.parse_and()
        while self.accept("||"):
            right = self.parse_and()
            left = (lambda l, r: lambda env: _truthy(l(env)) or _truthy(r(env)))(
                left, right)
        return left

    def parse_and(self) -> _Node:
        left = self.parse_not()
        while self.accept("&&"):
            right = self.parse_not()
            left = (lambda l, r: lambda env: _truthy(l(env)) and _truthy(r(env)))(
                left, right)
        return left

    def parse_not(self) -> _Node:
        if self.accept("!"):
            inner = self.parse_not()
            return lambda env: not _truthy(inner(env))
        return self.parse_cmp()

    def parse_cmp(self) -> _Node:
        left = self.parse_add()
        op = self.cur.value
        if self.cur.kind == "op" and op in ("==", "!=", "<", "<=", ">", ">="):
            self.advance()
            right = self.parse_add()

            def cmp(env, l=left, r=right, op=op):
                a, b = l(env), r(env)
                if a is MISSING:
                    a = None
                if b is MISSING:
                    b = None
                if op == "==":
                    return a == b
                if op == "!=":
                    return a != b
                if a is None or b is None:
                    raise ExprError(f"cannot order null ({op})")
                try:
                    if op == "<":
                        return a < b
                    if op == "<=":
                        return a <= b
                    if op == ">":
                        return a > b
                    return a >= b
                except TypeError:
                    raise ExprError(
                        f"cannot compare {type(a).__name__} {op} {type(b).__name__}"
                    ) from None

            return cmp
        if self.cur.kind == "ident" and op == "in":
            self.advance()
            right = self.parse_add()

            def contains(env, l=left, r=right):
                a, b = l(env), r(env)
                if isinstance(b, dict):
                    return a in b
                if isinstance(b, (list, tuple, str)):
                    return a in b
                raise ExprError(f"'in' needs list/map/string, got {type(b).__name__}")

            return contains
        return left

    def parse_add(self) -> _Node:
        left = self.parse_mul()
        while self.cur.kind == "op" and self.cur.value in ("+", "-"):
            op = self.advance().value
            right = self.parse_mul()

            def arith(env, l=left, r=right, op=op):
                a, b = l(env), r(env)
                if op == "+":
                    if isinstance(a, str) and isinstance(b, str):
                        return a + b
                    if isinstance(a, list) and isinstance(b, list):
                        return a + b
                    if isinstance(a, (int, float)) and isinstance(b, (int, float)) \
                       and not isinstance(a, bool) and not isinstance(b, bool):
                        return a + b
                    raise ExprError(
                        f"cannot add {type(a).__name__} + {type(b).__name__} "
                        "(use .string() to concatenate)"
                    )
                if isinstance(a, (int, float)) and isinstance(b, (int, float)):
                    return a - b
                raise ExprError(f"cannot subtract {type(a).__name__}")

            left = arith
        return left

    def parse_mul(self) -> _Node:
        left = self.parse_unary()
        while self.cur.kind == "op" and self.cur.value in ("*", "/", "%"):
            op = self.advance().value
            right = self.parse_unary()

            def arith(env, l=left, r=right, op=op):
                a, b = l(env), r(env)
                if not isinstance(a, (int, float)) or not isinstance(b, (int, float)):
                    raise ExprError(f"arithmetic on {type(a).__name__}")
                if op == "*":
                    return a * b
                if op == "/":
                    if b == 0:
                        raise ExprError("division by zero")
                    return a / b
                if b == 0:
                    raise ExprError("modulo by zero")
                return a % b

            left = arith
        return left

    def parse_unary(self) -> _Node:
        if self.cur.kind == "op" and self.cur.value == "-":
            self.advance()
            inner = self.parse_unary()

            def neg(env):
                v = inner(env)
                if not isinstance(v, (int, float)) or isinstance(v, bool):
                    raise ExprError("cannot negate non-number")
                return -v

            return neg
        return self.parse_pipe()

    def parse_pipe(self) -> _Node:
        left = self.parse_postfix()
        while self.cur.kind == "op" and self.cur.value == "|":
            self.advance()
            right = self.parse_postfix()

            def fallback(env, l=left, r=right):
                try:
                    v = l(env)
                except ExprError:
                    return r(env)
                if v is MISSING or v is None:
                    return r(env)
                return v

            left = fallback
        return left

    def parse_postfix(self) -> _Node:
        node = self.parse_primary()
        while True:
            if self.cur.kind == "op" and self.cur.value == ".":
                self.advance()
                # context capture: .(name -> body)
                if self.cur.kind == "op" and self.cur.value == "(":
                    self.advance()
                    if self.cur.kind != "ident":
                        raise ExprError("expected identifier in capture")
                    name = self.advance().value
                    self.expect("->")
                    body = self.parse_expr()
                    self.expect(")")

                    def capture(env, recv=node, name=name, body=body):
                        v = recv(env)
                        env2 = _Env(env.data, dict(env.vars), env.this)
                        env2.vars[name] = v
                        return body(env2)

                    node = capture
                    continue
                if self.cur.kind != "ident":
                    raise ExprError(f"expected field name after '.', got "
                                    f"{self.cur.value!r}")
                name = self.advance().value
                if self.cur.kind == "op" and self.cur.value == "(":
                    node = self.parse_method(node, name)
                else:
                    node = (lambda recv, name: lambda env: _get_field(
                        recv(env), name))(node, name)
                continue
            if self.cur.kind == "op" and self.cur.value == "[":
                self.advance()
                key = self.parse_expr()
                self.expect("]")

                def index(env, recv=node, key=key):
                    v, k = recv(env), key(env)
                    if isinstance(v, dict):
                        return v.get(k, MISSING)
                    if isinstance(v, (list, tuple, str)):
                        if not isinstance(k, int) or isinstance(k, bool):
                            raise ExprError("list index must be an integer")
                        if -len(v) <= k < len(v):
                            return v[k]
                        return MISSING
                    if v is MISSING or v is None:
                        return MISSING
                    raise ExprError(f"cannot index {type(v).__name__}")

                node = index
                continue
            return node

    def parse_method(self, recv: _Node, name: str) -> _Node:
        """Method call — lambda-taking methods get `this` rebound."""
        self.expect("(")
        if name in ("map_each", "filter"):
            body = self.parse_expr()
            self.expect(")")

            def run(env, recv=recv, name=name, body=body):
                v = recv(env)
                if v is MISSING or v is None:
                    raise ExprError(f".{name}() on null")
                if not isinstance(v, (list, tuple)):
                    raise ExprError(f".{name}() needs a list, got {type(v).__name__}")
                out = []
                for item in v:
                    env2 = _Env(env.data, env.vars, item)
                    if name == "map_each":
                        out.append(body(env2))
                    elif _truthy(body(env2)):
                        out.append(item)
                return out

            return run
        args: list[_Node] = []
        if not (self.cur.kind == "op" and self.cur.value == ")"):
            args.append(self.parse_expr())
            while self.accept(","):
                args.append(self.parse_expr())
        self.expect(")")

        def run(env, recv=recv, name=name, args=args):
            return _call_method(recv(env), name, [a(env) for a in args])

        return run

    def parse_primary(self) -> _Node:
        t = self.cur
        if t.kind == "num":
            self.advance()
            v = float(t.value) if "." in t.value else int(t.value)
            return lambda env: v
        if t.kind == "str":
            self.advance()
            raw = t.value[1:-1]
            s = _unescape(raw)
            return lambda env: s
        if t.kind == "dollar":
            self.advance()
            name = t.value[1:]

            def var(env):
                if name not in env.vars:
                    raise ExprError(f"unknown variable ${name}")
                return env.vars[name]

            return var
        if t.kind == "op" and t.value == "(":
            self.advance()
            inner = self.parse_expr()
            self.expect(")")
            return inner
        if t.kind == "op" and t.value == "[":
            self.advance()
            items: list[_Node] = []
            if not (self.cur.kind == "op" and self.cur.value == "]"):
                items.append(self.parse_expr())
                while self.accept(","):
                    items.append(self.parse_expr())
            self.expect("]")
            return lambda env: [i(env) for i in items]
        if t.kind == "ident":
            if t.value == "true":
                self.advance()
                return lambda env: True
            if t.value == "false":
                self.advance()
                return lambda env: False
            if t.value == "null":
                self.advance()
                return lambda env: None
            if t.value == "if":
                return self.parse_if()
            if t.value == "this":
                self.advance()
                return lambda env: env.this
            name = self.advance().value
            if self.cur.kind == "op" and self.cur.value == "(":
                return self.parse_function(name)
            self.refs.add(name)

            def ident(env):
                if name in env.vars:
                    return env.vars[name]
                if isinstance(env.data, dict) and name in env.data:
                    return env.data[name]
                return MISSING

            return ident
        raise ExprError(f"unexpected token {t.value!r}")

    def parse_if(self) -> _Node:
        self.expect("if")
        cond = self.parse_expr()
        self.expect("{")
        a = self.parse_expr()
        self.expect("}")
        b: _Node = lambda env: None
        if self.accept("else"):
            self.expect("{")
            b = self.parse_expr()
            self.expect("}")
        return lambda env: a(env) if _truthy(cond(env)) else b(env)

    def parse_function(self, name: str) -> _Node:
        self.expect("(")
        args: list[_Node] = []
        if not (self.cur.kind == "op" and self.cur.value == ")"):
            args.append(self.parse_expr())
            while self.accept(","):
                args.append(self.parse_expr())
        self.expect(")")
        raw_fn = _FUNCTIONS.get(name)
        if raw_fn is None:
            raise ExprError(f"unknown function {name!r}")

        def fn(vals, _raw=raw_fn, _name=name):
            try:
                return _raw(vals)
            except ExprError:
                raise
            except (TypeError, ValueError, AttributeError, KeyError,
                    IndexError) as e:
                raise ExprError(f"{_name}(): {e}") from None

        if name == "has":
            # CEL has(): never throws on missing paths
            arg = args[0]

            def has(env):
                try:
                    v = arg(env)
                except ExprError:
                    return False
                return v is not MISSING and v is not None

            return has
        return lambda env: fn([a(env) for a in args])


def _unescape(raw: str) -> str:
    return (
        raw.replace("\\\\", "\x00")
        .replace('\\"', '"')
        .replace("\\'", "'")
        .replace("\\n", "\n")
        .replace("\\t", "\t")
        .replace("\x00", "\\")
    )


def _get_field(v, name: str):
    if isinstance(v, dict):
        return v.get(name, MISSING)
    if v is MISSING or v is None:
        return MISSING  # silent chaining; pipe/has recover
    raise ExprError(f"cannot access field {name!r} on {type(v).__name__}")


def _call_method(v, name: str, args: list):
    if name == "or":
        # .or(default) exists precisely to absorb missing/null receivers
        if v is MISSING or v is None:
            return args[0]
        return v
    if v is MISSING or v is None:
        raise ExprError(f".{name}() on null")
    try:
        m = _METHODS[name]
    except KeyError:
        raise ExprError(f"unknown method .{name}()") from None
    try:
        return m(v, args)
    except ExprError:
        raise
    except (TypeError, ValueError, AttributeError, KeyError, IndexError) as e:
        # runtime type mismatches surface as recoverable expression errors
        # (so the `|` fallback and rule-level handlers catch them)
        raise ExprError(f".{name}(): {e}") from None


def _m_split(v, args):
    if not isinstance(v, str):
        raise ExprError(".split() on non-string")
    return v.split(args[0])


_METHODS: dict[str, Callable] = {
    "string": lambda v, a: _tostr(v),
    "number": lambda v, a: float(v) if isinstance(v, str) else v + 0,
    "length": lambda v, a: len(v),
    "size": lambda v, a: len(v),
    "split": _m_split,
    "join": lambda v, a: a[0].join(_tostr(x) for x in v),
    "trim": lambda v, a: v.strip(),
    "uppercase": lambda v, a: v.upper(),
    "lowercase": lambda v, a: v.lower(),
    "contains": lambda v, a: a[0] in v,
    "startsWith": lambda v, a: v.startswith(a[0]),
    "starts_with": lambda v, a: v.startswith(a[0]),
    "endsWith": lambda v, a: v.endswith(a[0]),
    "ends_with": lambda v, a: v.endswith(a[0]),
    "matches": lambda v, a: bool(_re.search(a[0], v)),
    "keys": lambda v, a: sorted(v.keys()),
    "values": lambda v, a: [v[k] for k in sorted(v.keys())],
    "exists": lambda v, a: a[0] in v,
}


def _split_name(args):
    (s,) = args
    if not isinstance(s, str):
        raise ExprError("split_name() needs a string")
    return s.split("/", 1)[1] if "/" in s else s


def _split_namespace(args):
    (s,) = args
    if not isinstance(s, str):
        raise ExprError("split_namespace() needs a string")
    return s.split("/", 1)[0] if "/" in s else ""


_FUNCTIONS: dict[str, Callable] = {
    # the custom Bloblang env functions (reference pkg/rules/env.go:13-58):
    # ids shaped `namespace/name` split into parts; no '/' => cluster-scoped
    "split_name": _split_name,
    "split_namespace": _split_namespace,
    "has": lambda args: args[0] is not MISSING and args[0] is not None,
    "size": lambda args: len(args[0]),
    "string": lambda args: _tostr(args[0]),
    "int": lambda args: int(args[0]),
}


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


@dataclass
class CompiledExpr:
    source: str
    _node: _Node
    # root data-map identifiers the program may read (conservative
    # over-approximation; literals have none). The watch hub uses this to
    # share allowed-set recomputes across watchers when the id-mapping
    # exprs provably depend only on resourceId.
    refs: frozenset = frozenset()

    def evaluate(self, data: dict, this=None) -> Any:
        v = self._node(_Env(data, this=this))
        return None if v is MISSING else v

    def evaluate_str(self, data: dict) -> str:
        v = self.evaluate(data)
        if v is None:
            raise ExprError(f"expression {self.source!r} evaluated to null")
        return _tostr(v)

    def evaluate_bool(self, data: dict) -> bool:
        v = self.evaluate(data)
        if not isinstance(v, bool):
            raise ExprError(
                f"condition {self.source!r} must evaluate to a boolean, "
                f"got {type(v).__name__}"
            )
        return v


def compile_expr(text: str) -> CompiledExpr:
    """Compile a bare expression (tupleSets, `if` conditions)."""
    p = _Parser(text)
    try:
        node = p.parse_program()
    except ExprError as e:
        raise ExprError(f"in expression {text!r}: {e}") from None
    return CompiledExpr(text, node, frozenset(p.refs))


def compile_template(text: str) -> CompiledExpr:
    """Compile a template field with the reference's ``{{ }}``/literal
    duality (rules.go:1005-1026): a field that starts with ``{{`` and ends
    with ``}}`` is an expression; anything else is a literal string."""
    t = text.strip()
    if t.startswith("{{") and t.endswith("}}"):
        inner = t[2:-2].strip()
        if not inner:
            return CompiledExpr(text, lambda env: "")
        return compile_expr(inner)
    return CompiledExpr(text, lambda env, v=text: v)
