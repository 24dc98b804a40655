"""Pure-Python oracle evaluator: the plain host reference for the port.

A copy of the JAX package's ``engine/evaluator.py``, caveats included (a
conditional edge counts only where the caveat interpreter of
caveats/ast.py holds under tuple ∪ request context). Implements Zanzibar check / lookup-resources semantics by
direct recursive expansion over a store snapshot, depth-limited to 50 like
an embedded SpiceDB. Slow and host-only by design: the tests and
``chip_smoke.py`` hold the device fixpoint against it.
"""

from __future__ import annotations

import json
import time
from typing import Optional

import numpy as np

from ..caveats.ast import CaveatError, Lit, StringInterner, interpret, walk
from ..caveats.vm import NOW_PARAM
from ..models.schema import (
    Arrow,
    Exclude,
    Intersect,
    Nil,
    RelationRef,
    Schema,
    Union,
)
from .store import Snapshot

MAX_DEPTH = 50

WILDCARD_ID = "*"


class DepthExceeded(Exception):
    pass


class OracleEvaluator:
    def __init__(self, schema: Schema, snapshot: Snapshot,
                 now: Optional[float] = None,
                 context: Optional[dict] = None):
        self.schema = schema
        self.now = time.time() if now is None else now
        # the request's caveat context; merged UNDER each tuple's stored
        # context (tuple wins), with the evaluation clock auto-injected
        # as the `now` parameter — mirroring the VM's semantics
        self.context = dict(context or {})
        # (rtype, rid, relation) -> list[(stype, sid, srel|None, cav id)]
        self.adj: dict[tuple, list[tuple]] = {}
        # type -> live object ids
        self.objects: dict[str, set] = {}
        self._cav_table = getattr(snapshot, "caveat_instances",
                                  None) or [("", "")]
        self._cav_memo: dict[int, Optional[bool]] = {0: True}
        c = snapshot.cols
        types, rels, objs = snapshot.types, snapshot.relations, snapshot.objects
        # expired tuples are invisible at read time
        live = np.flatnonzero(c.exp > self.now)
        # column-at-a-time string materialization (10M-row stores): the
        # per-row loop below then only touches dicts
        rt_s = [types.string(t) for t in c.rt[live].tolist()]
        rl_s = [rels.string(r) for r in c.rl[live].tolist()]
        st_s = [types.string(t) for t in c.st[live].tolist()]
        srl_s = [rels.string(r) or None for r in c.srl[live].tolist()]
        rid_s = [objs[t].string(i) for t, i in
                 zip(c.rt[live].tolist(), c.rid[live].tolist())]
        sid_s = [objs[t].string(i) for t, i in
                 zip(c.st[live].tolist(), c.sid[live].tolist())]
        cav_i = c.cav[live].tolist()
        adj = self.adj
        for rt, rid, rl, st, sid, srl, cav in zip(rt_s, rid_s, rl_s, st_s,
                                                  sid_s, srl_s, cav_i):
            k = (rt, rid, rl)
            lst = adj.get(k)
            if lst is None:
                adj[k] = lst = []
                self.objects.setdefault(rt, set()).add(rid)
            lst.append((st, sid, srl, cav))

    def _cav_ok(self, cav: int) -> bool:
        """Tri-state caveat verdict for an instance id, collapsed to the
        edge's activation (missing context == False: fail closed).
        Memoized: instances are few and the context is fixed per oracle."""
        got = self._cav_memo.get(cav)
        if got is None and cav not in self._cav_memo:
            got = self._eval_caveat(cav)
            self._cav_memo[cav] = got
        return bool(got)

    def _eval_caveat(self, cav: int) -> Optional[bool]:
        name, ctx_json = self._cav_table[cav]
        defn = (getattr(self.schema, "caveat_defs", None) or {}).get(name)
        if defn is None:
            return False  # undeclared: never grant
        params = {p.name: p.type for p in defn.params}
        merged = dict(self.context)
        if NOW_PARAM in params and NOW_PARAM not in merged:
            merged[NOW_PARAM] = self.now
        if ctx_json:
            try:
                merged.update(json.loads(ctx_json))
            except ValueError:
                return None  # unreadable stored context: no verdict
        # one shared interner is enough for the oracle: strings compare
        # by code, and interning everything visible keeps codes aligned
        interner = StringInterner()
        for v in merged.values():
            if isinstance(v, str):
                interner.intern(v)
            elif isinstance(v, list):
                for x in v:
                    if isinstance(x, str):
                        interner.intern(x)
        for node in walk(defn.expr):
            if isinstance(node, Lit):
                if node.type == "string":
                    interner.intern(node.value)
                elif node.type == "list":
                    for x in node.value:
                        if isinstance(x, str):
                            interner.intern(x)
        try:
            return interpret(defn.expr, merged, params, interner)
        except CaveatError:
            return None  # unencodable context: no verdict, fail closed

    # -- public ------------------------------------------------------------

    def check(
        self,
        resource_type: str,
        resource_id: str,
        permission: str,
        subject_type: str,
        subject_id: str,
        subject_relation: Optional[str] = None,
    ) -> bool:
        subject = (subject_type, subject_id, subject_relation)
        memo: dict[tuple, bool] = {}
        return self._eval(resource_type, resource_id, permission, subject,
                          memo, frozenset(), 0)

    def lookup_resources(
        self,
        resource_type: str,
        permission: str,
        subject_type: str,
        subject_id: str,
        subject_relation: Optional[str] = None,
    ) -> set:
        subject = (subject_type, subject_id, subject_relation)
        memo: dict[tuple, bool] = {}
        out = set()
        for rid in self.objects.get(resource_type, ()):  # only ids in the graph
            if self._eval(resource_type, rid, permission, subject, memo,
                          frozenset(), 0):
                out.add(rid)
        return out

    # -- internals ----------------------------------------------------------

    def _eval(self, rtype, rid, relname, subject, memo, path, depth) -> bool:
        if depth > MAX_DEPTH:
            raise DepthExceeded(f"{rtype}:{rid}#{relname}")
        # Zanzibar identity: a userset is a member of itself
        if subject[2] is not None and (rtype, rid, relname) == subject:
            return True
        key = (rtype, rid, relname)
        if key in memo:
            return memo[key]
        if key in path:
            return False  # cycle: contributes nothing new (least fixpoint)
        d = self.schema.definitions.get(rtype)
        if d is None:
            return False
        path = path | {key}
        if relname in d.relations:
            res = self._eval_relation(rtype, rid, relname, subject, memo, path, depth)
        elif relname in d.permissions:
            res = self._eval_expr(d.permissions[relname].expr, rtype, rid,
                                  subject, memo, path, depth)
        else:
            res = False
        # Only completed True results are safe to memoize: a False may be an
        # artifact of a cycle cut on this particular path.
        if res:
            memo[key] = res
        return res

    def _eval_relation(self, rtype, rid, relname, subject, memo, path, depth) -> bool:
        stype_q, sid_q, srel_q = subject
        for st, sid, srl, cav in self.adj.get((rtype, rid, relname), ()):
            if not self._cav_ok(cav):
                continue  # conditional grant not satisfied: edge is off
            if srl is None:
                if st == stype_q and srel_q is None and (
                    sid == sid_q or sid == WILDCARD_ID
                ):
                    return True
                # a userset subject query matches nothing concrete
            else:
                # exact userset match (subject itself is that userset)
                if (st, sid, srl) == (stype_q, sid_q, srel_q):
                    return True
                if self._eval(st, sid, srl, subject, memo, path, depth + 1):
                    return True
        return False

    def _eval_expr(self, expr, rtype, rid, subject, memo, path, depth) -> bool:
        if isinstance(expr, Nil):
            return False
        if isinstance(expr, RelationRef):
            return self._eval(rtype, rid, expr.name, subject, memo, path, depth + 1)
        if isinstance(expr, Union):
            return any(self._eval_expr(e, rtype, rid, subject, memo, path, depth)
                       for e in expr.operands)
        if isinstance(expr, Intersect):
            return all(self._eval_expr(e, rtype, rid, subject, memo, path, depth)
                       for e in expr.operands)
        if isinstance(expr, Exclude):
            return self._eval_expr(expr.base, rtype, rid, subject, memo, path, depth) \
                and not self._eval_expr(expr.subtract, rtype, rid, subject, memo,
                                        path, depth)
        if isinstance(expr, Arrow):
            for st, sid, srl, cav in self.adj.get(
                    (rtype, rid, expr.tupleset), ()):
                if srl is not None or sid == WILDCARD_ID:
                    continue  # arrows walk concrete subjects only
                if not self._cav_ok(cav):
                    continue  # conditional tupleset edge not satisfied
                sub_def = self.schema.definitions.get(st)
                if sub_def and sub_def.relation_or_permission(expr.target):
                    if self._eval(st, sid, expr.target, subject, memo, path,
                                  depth + 1):
                        return True
            return False
        raise TypeError(f"unknown expr node {expr!r}")
