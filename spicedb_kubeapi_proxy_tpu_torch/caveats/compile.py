"""Caveat compiler: typed AST -> constant-folded flat op tape.

The tape is the unit the vectorized VM executes (:mod:`.vm`): a register
machine with one instruction stream ``(op, dst, a, b)`` int32 plus an
f64 immediate per instruction, evaluated for every caveated-tuple
instance in parallel. Registers hold (value f64[N], known bool[N]) pairs
— the ``known`` plane carries three-valued logic, so missing context
flows structurally instead of via NaN tricks.

Lists never enter registers: every membership test lowers to ``IN`` over
a list id whose per-element inclusive [lo, hi] ranges live in the
instance tables (CIDR allowlist elements span a range; equality elements
are points). A literal list is a constant list id; a ``list<T>`` param
is a per-instance one.

Constant folding runs before lowering (literal arithmetic, comparisons,
boolean identities), so ``1 + 2 < x`` costs one comparison at runtime.

A copy of the JAX package's ``caveats/compile.py`` (the port imports nothing of
that package).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from .ast import (
    ARITH_OPS,
    Bin,
    CaveatDef,
    CaveatError,
    CavExpr,
    Lit,
    StringInterner,
    Un,
    Var,
    ip_words,
    parse_cidr_range,
    parse_cidr_range_mapped,
)

# -- opcodes (shared with vm.py; order is the lax.switch branch table) ------
OP_CONST = 0  # dst <- imm (known everywhere)
OP_LOAD = 1  # dst <- ctx column a
OP_AND = 2
OP_OR = 3
OP_NOT = 4  # dst <- !a
OP_EQ = 5
OP_NE = 6
OP_LT = 7
OP_LE = 8
OP_GT = 9
OP_GE = 10
OP_ADD = 11
OP_SUB = 12
OP_MUL = 13
OP_DIV = 14
OP_IN = 15  # dst <- (a in list b)

N_OPCODES = 16

_CMP_OPS = {"==": OP_EQ, "!=": OP_NE, "<": OP_LT, "<=": OP_LE,
            ">": OP_GT, ">=": OP_GE}
_ARITH = {"+": OP_ADD, "-": OP_SUB, "*": OP_MUL, "/": OP_DIV}

_NUMERIC = {"int", "uint", "double", "timestamp", "duration", "ipaddress",
            "bool"}


@dataclass(frozen=True)
class ListSpec:
    """One list id: a compile-time constant (``ranges`` set) or a
    ``list<elem>`` parameter column (``param`` set)."""

    ranges: Optional[tuple] = None  # tuple[(lo, hi), ...] for constants
    param: Optional[int] = None  # param index for per-instance lists
    elem: str = "double"


@dataclass
class CaveatProgram:
    """One compiled caveat: the tape plus everything the instance tables
    and request encoder need to lay out context columns."""

    name: str
    params: tuple  # CaveatParam tuple; scalar params get ctx columns
    ops: np.ndarray  # int32 [T, 4] (op, dst, a, b)
    imm: np.ndarray  # float64 [T]
    n_regs: int
    out_reg: int
    lists: tuple  # tuple[ListSpec, ...]
    # scalar-param name -> BASE ctx column; list-param name -> list id
    scalar_col: dict = field(default_factory=dict)
    list_id: dict = field(default_factory=dict)
    # scalar-param name -> how many consecutive columns it occupies:
    # 1 for everything except ipaddress, which rides FOUR 32-bit word
    # columns (the 128-bit mapped space cannot live on the 2^40-exact
    # split planes; word-wise lexicographic checks can — IPv6 support)
    scalar_width: dict = field(default_factory=dict)
    uses_now: bool = False  # references the auto-injected `now` param
    time_arith: bool = False  # arithmetic over timestamps: verdict flip
    #                           times are not enumerable from contexts

    @property
    def n_scalars(self) -> int:
        return sum(self.scalar_width.get(n, 1) for n in self.scalar_col)

    def signature(self) -> tuple:
        """Static shape key: everything the traced VM bakes in."""
        return (len(self.ops), self.n_regs, self.out_reg,
                self.n_scalars, len(self.lists),
                tuple(s.param if s.param is not None else -1
                      for s in self.lists))


def _typeof(e: CavExpr, defn: CaveatDef) -> str:
    """Resolve a node's type name ('list' for lists)."""
    if isinstance(e, Lit):
        return e.type
    if isinstance(e, Var):
        p = defn.param(e.name)
        if p is None:
            raise CaveatError(
                f"caveat {defn.name!r}: unknown parameter {e.name!r}")
        return "list" if p.type.is_list else p.type.name
    if isinstance(e, Un):
        return "bool"
    assert isinstance(e, Bin)
    if e.op in ("&&", "||", "in") or e.op in _CMP_OPS:
        return "bool"
    return "double"  # arithmetic


def _fold(e: CavExpr, defn: CaveatDef) -> CavExpr:
    """Constant-fold literal subtrees (numeric arithmetic, comparisons,
    boolean identities). Division by literal zero is NOT folded — it
    stays a runtime no-verdict (missing context, fail closed)."""
    if isinstance(e, (Lit, Var)):
        return e
    if isinstance(e, Un):
        inner = _fold(e.operand, defn)
        if isinstance(inner, Lit) and inner.type == "bool":
            return Lit(not inner.value, "bool")
        return Un(e.op, inner)
    assert isinstance(e, Bin)
    left = _fold(e.left, defn)
    right = _fold(e.right, defn)
    if isinstance(left, Lit) and isinstance(right, Lit):
        if e.op in _ARITH and left.type == "double" \
                and right.type == "double":
            a, b = float(left.value), float(right.value)
            if e.op == "+":
                return Lit(a + b, "double")
            if e.op == "-":
                return Lit(a - b, "double")
            if e.op == "*":
                return Lit(a * b, "double")
            if b != 0:
                return Lit(a / b, "double")
        elif e.op in _CMP_OPS and left.type == right.type \
                and left.type in ("double", "bool"):
            a = float(left.value) if left.type == "double" \
                else float(bool(left.value))
            b = float(right.value) if right.type == "double" \
                else float(bool(right.value))
            val = {"==": a == b, "!=": a != b, "<": a < b,
                   "<=": a <= b, ">": a > b, ">=": a >= b}[e.op]
            return Lit(val, "bool")
    # boolean identities: true && x -> x, false || x -> x, etc.
    if e.op == "&&":
        for lit, other in ((left, right), (right, left)):
            if isinstance(lit, Lit) and lit.type == "bool":
                return other if lit.value else Lit(False, "bool")
    if e.op == "||":
        for lit, other in ((left, right), (right, left)):
            if isinstance(lit, Lit) and lit.type == "bool":
                return Lit(True, "bool") if lit.value else other
    return Bin(e.op, left, right)


def typecheck(defn: CaveatDef) -> None:
    """Validate a declaration compiles (schema-parse-time gate); raises
    :class:`CaveatError` on type or reference errors."""
    compile_caveat(defn, StringInterner())


def compile_caveat(defn: CaveatDef,
                   interner: StringInterner) -> CaveatProgram:
    """Lower one caveat declaration to its op tape. String literals (and
    constant-list string elements) are interned into ``interner`` so
    tuple/request context values interned against the same table compare
    by code."""
    expr = _fold(defn.expr, defn)

    scalar_col: dict = {}
    scalar_width: dict = {}
    list_ids: dict = {}
    lists: list[ListSpec] = []
    next_col = 0
    for p in defn.params:
        if p.type.is_list:
            continue
        scalar_col[p.name] = next_col
        w = 4 if p.type.name == "ipaddress" else 1
        scalar_width[p.name] = w
        next_col += w
    param_index = {p.name: i for i, p in enumerate(defn.params)}

    ops: list[tuple[int, int, int, int]] = []
    imm: list[float] = []
    n_regs = 0
    uses_now = False
    time_arith = False

    def emit(op: int, a: int = 0, b: int = 0, im: float = 0.0) -> int:
        nonlocal n_regs
        dst = n_regs
        n_regs += 1
        ops.append((op, dst, a, b))
        imm.append(im)
        return dst

    def list_of(e: CavExpr, left_type: str) -> int:
        """Resolve a membership right-hand side to a list id."""
        if isinstance(e, Lit) and e.type == "list":
            key = ("const", e.value, left_type)
            got = list_ids.get(key)
            if got is not None:
                return got
            ranges = []
            for item in e.value:
                if isinstance(item, str):
                    if left_type == "ipaddress":
                        ranges.append(parse_cidr_range(item))
                    else:
                        x = float(interner.intern(item))
                        ranges.append((x, x))
                elif isinstance(item, bool):
                    ranges.append((float(item), float(item)))
                else:
                    ranges.append((float(item), float(item)))
            lid = len(lists)
            lists.append(ListSpec(ranges=tuple(ranges), elem=left_type))
            list_ids[key] = lid
            return lid
        if isinstance(e, Var):
            p = defn.param(e.name)
            if p is None or not p.type.is_list:
                raise CaveatError(
                    f"caveat {defn.name!r}: 'in' right-hand side "
                    f"{e.name!r} is not a list parameter")
            key = ("param", e.name)
            got = list_ids.get(key)
            if got is not None:
                return got
            lid = len(lists)
            lists.append(ListSpec(param=param_index[e.name],
                                  elem=p.type.elem))
            list_ids[key] = lid
            return lid
        raise CaveatError(
            f"caveat {defn.name!r}: 'in' needs a list literal or a "
            "list parameter on the right")

    def check_comparable(a: str, b: str, op: str) -> None:
        if "list" in (a, b):
            raise CaveatError(
                f"caveat {defn.name!r}: a list may only appear on the "
                "right of 'in'")
        if a == "string" or b == "string":
            if a != b:
                raise CaveatError(
                    f"caveat {defn.name!r}: {op!r} between string and "
                    f"{b if a == 'string' else a}")
            if op not in ("==", "!="):
                raise CaveatError(
                    f"caveat {defn.name!r}: strings support only "
                    "==/!= (interned codes are unordered)")
        if ("ipaddress" in (a, b)) and a != b:
            # wide (4-word) values order only against each other; a
            # cross-type compare against a plain number would compare
            # one word against the whole address — reject loudly
            raise CaveatError(
                f"caveat {defn.name!r}: {op!r} between ipaddress and "
                f"{b if a == 'ipaddress' else a}")

    # -- wide (4-word) ipaddress lowering: a mapped 128-bit address is
    # -- four 32-bit word registers; compares expand lexicographically
    # -- over existing opcodes (Kleene unknowns flow through AND/OR)

    def lower_ip(e: CavExpr) -> tuple:
        if isinstance(e, Var):
            p = defn.param(e.name)
            if p is not None and not p.type.is_list \
                    and p.type.name == "ipaddress":
                base = scalar_col[e.name]
                return tuple(emit(OP_LOAD, a=base + k)
                             for k in range(4))
        raise CaveatError(
            f"caveat {defn.name!r}: expected an ipaddress parameter")

    def const_words(x: int) -> tuple:
        return tuple(emit(OP_CONST, im=float(w)) for w in ip_words(x))

    def wide_and(regs: list) -> int:
        acc = regs[0]
        for r in regs[1:]:
            acc = emit(OP_AND, a=acc, b=r)
        return acc

    def wide_cmp(aw: tuple, bw: tuple, op: str) -> int:
        eqs = [emit(OP_EQ, a=aw[k], b=bw[k]) for k in range(4)]
        if op == "==":
            return wide_and(eqs)
        if op == "!=":
            return emit(OP_NOT, a=wide_and(eqs))
        strict = OP_LT if op in ("<", "<=") else OP_GT
        acc = emit(_CMP_OPS[op], a=aw[3], b=bw[3])
        for k in (2, 1, 0):
            s = emit(strict, a=aw[k], b=bw[k])
            acc = emit(OP_OR, a=s, b=emit(OP_AND, a=eqs[k], b=acc))
        return acc

    def wide_range_hit(aw: tuple, lo: int, hi: int) -> int:
        ge = wide_cmp(aw, const_words(lo), ">=")
        le = wide_cmp(aw, const_words(hi), "<=")
        return emit(OP_AND, a=ge, b=le)

    def lower(e: CavExpr) -> int:
        nonlocal uses_now, time_arith
        if isinstance(e, Lit):
            if e.type == "string":
                return emit(OP_CONST, im=float(interner.intern(e.value)))
            if e.type == "bool":
                return emit(OP_CONST, im=1.0 if e.value else 0.0)
            if e.type == "list":
                raise CaveatError(
                    f"caveat {defn.name!r}: a list may only appear on "
                    "the right of 'in'")
            return emit(OP_CONST, im=float(e.value))
        if isinstance(e, Var):
            p = defn.param(e.name)
            if p is None:
                raise CaveatError(
                    f"caveat {defn.name!r}: unknown parameter {e.name!r}")
            if p.type.is_list:
                raise CaveatError(
                    f"caveat {defn.name!r}: list parameter {e.name!r} "
                    "may only appear on the right of 'in'")
            if p.type.name == "ipaddress":
                # wide values have no single-register form: they exist
                # only inside compares and 'in' (handled above by the
                # Bin branches) — a bare/boolean use is meaningless
                raise CaveatError(
                    f"caveat {defn.name!r}: ipaddress parameter "
                    f"{e.name!r} may only be compared or tested "
                    "with 'in'")
            if e.name == "now" and p.type.name == "timestamp":
                uses_now = True
            return emit(OP_LOAD, a=scalar_col[e.name])
        if isinstance(e, Un):
            return emit(OP_NOT, a=lower(e.operand))
        assert isinstance(e, Bin)
        if e.op == "&&":
            return emit(OP_AND, a=lower(e.left), b=lower(e.right))
        if e.op == "||":
            return emit(OP_OR, a=lower(e.left), b=lower(e.right))
        if e.op == "in":
            lt = _typeof(e.left, defn)
            if lt == "list":
                raise CaveatError(
                    f"caveat {defn.name!r}: the left of 'in' must be "
                    "a scalar")
            if lt == "ipaddress":
                aw = lower_ip(e.left)
                if isinstance(e.right, Lit) and e.right.type == "list":
                    # literal CIDR allowlist: inline word-wise range
                    # checks in the full mapped space — exact for BOTH
                    # families (never the uint32 list table)
                    hits = []
                    for item in e.right.value:
                        if not isinstance(item, str):
                            raise CaveatError(
                                f"caveat {defn.name!r}: ipaddress list "
                                f"elements must be address/CIDR "
                                f"strings, got {item!r}")
                        lo, hi = parse_cidr_range_mapped(item)
                        hits.append(wide_range_hit(aw, lo, hi))
                    if not hits:
                        return emit(OP_CONST, im=0.0)
                    acc = hits[0]
                    for h in hits[1:]:
                        acc = emit(OP_OR, a=acc, b=h)
                    return acc
                lid = list_of(e.right, lt)
                spec = lists[lid]
                if spec.elem != "ipaddress":
                    raise CaveatError(
                        f"caveat {defn.name!r}: ipaddress 'in' "
                        f"list<{spec.elem}> mismatch")
                # per-instance lists hold the legacy uint32 (v4) ranges
                # (the split planes cap at 2^40; a list with any v6
                # element stays UNKNOWN — encode_list). A non-v4-mapped
                # operand selects an OUT-OF-RANGE sentinel (2^33 +
                # low word, above every uint32 range) instead of its
                # low word, so OP_IN itself answers: a KNOWN list
                # yields a genuine miss (it provably holds no v6
                # elements), an UNKNOWN list stays UNKNOWN — an outer
                # `is4 && hit` would Kleene-collapse that to a KNOWN
                # False, which `!(ip in blocked)` flips into a grant
                z = emit(OP_CONST, im=0.0)
                ff = emit(OP_CONST, im=65535.0)
                is4 = wide_and([
                    emit(OP_EQ, a=aw[0], b=z),
                    emit(OP_EQ, a=aw[1], b=z),
                    emit(OP_EQ, a=aw[2], b=ff)])
                not4 = emit(OP_NOT, a=is4)
                big = emit(OP_CONST, im=float(1 << 33))
                off = emit(OP_MUL, a=not4, b=big)  # 0 or 2^33: exact
                sel = emit(OP_ADD, a=aw[3], b=off)
                return emit(OP_IN, a=sel, b=lid)
            lid = list_of(e.right, lt)
            spec = lists[lid]
            if spec.elem == "ipaddress":
                raise CaveatError(
                    f"caveat {defn.name!r}: {lt} 'in' "
                    "list<ipaddress> mismatch")
            if spec.elem != lt and not (
                    spec.elem in _NUMERIC and lt in _NUMERIC):
                raise CaveatError(
                    f"caveat {defn.name!r}: {lt} 'in' "
                    f"list<{spec.elem}> mismatch")
            return emit(OP_IN, a=lower(e.left), b=lid)
        lt, rt = _typeof(e.left, defn), _typeof(e.right, defn)
        if e.op in _CMP_OPS:
            check_comparable(lt, rt, e.op)
            if lt == rt == "ipaddress":
                return wide_cmp(lower_ip(e.left), lower_ip(e.right),
                                e.op)
            return emit(_CMP_OPS[e.op], a=lower(e.left),
                        b=lower(e.right))
        if e.op in ARITH_OPS:
            check_comparable(lt, rt, e.op)
            if lt == "string" or rt == "string":
                raise CaveatError(
                    f"caveat {defn.name!r}: arithmetic over strings")
            if "ipaddress" in (lt, rt):
                raise CaveatError(
                    f"caveat {defn.name!r}: arithmetic over IP "
                    "addresses is meaningless (wide values only "
                    "compare)")
            if "timestamp" in (lt, rt):
                # verdict flip instants are no longer enumerable from
                # the stored contexts; the engine must not cache
                time_arith = True
            return emit(_ARITH[e.op], a=lower(e.left), b=lower(e.right))
        raise CaveatError(f"unknown operator {e.op!r}")

    if isinstance(expr, Lit) and expr.type == "bool":
        out = emit(OP_CONST, im=1.0 if expr.value else 0.0)
    else:
        if _typeof(expr, defn) != "bool":
            raise CaveatError(
                f"caveat {defn.name!r}: body must be boolean, got "
                f"{_typeof(expr, defn)}")
        out = lower(expr)

    return CaveatProgram(
        name=defn.name,
        params=defn.params,
        ops=np.asarray(ops, dtype=np.int32).reshape(-1, 4),
        imm=np.asarray(imm, dtype=np.float64),
        n_regs=n_regs,
        out_reg=out,
        lists=tuple(lists),
        scalar_col=scalar_col,
        scalar_width=scalar_width,
        list_id={k[1]: v for k, v in list_ids.items()
                 if k[0] == "param"},
        uses_now=uses_now,
        time_arith=time_arith,
    )
