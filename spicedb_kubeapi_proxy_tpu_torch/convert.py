"""Carry a compiled graph across from plain arrays.

:func:`from_reference_arrays` builds the port's
:class:`~.ops.reachability.CompiledGraph` from numpy arrays and plain
Python metadata only, so a graph compiled elsewhere (the JAX package's
``compile_graph``, flattened by the caller) runs through the port's
fixpoint unchanged. Permission expressions arrive as nested tuples:

    ("nil",)  ("rel", name)  ("arrow", tupleset, target)
    ("or", e, ...)  ("and", e, ...)  ("sub", base, subtract)

Input keys: ``M``, ``slot_offset``, ``type_sizes``, ``base_time``; the
residual — either the padded per-level views ``res_src``/``res_dst``/
``res_exp``, or the full dst-sorted ``src``/``dst``/``exp_rel`` with
``res_idx`` — and ``res_level_bounds``, ``range_offs``, ``range_levels``,
``n_levels``; ``blocks`` (dicts of ``dst_off``, ``n_dst``, ``src_off``,
``n_src``, ``dst_local``, ``src_local``, ``level``, ``closured``, and
for a closured block its base edges ``base_dst_local``/``base_src_local``);
``programs`` (dicts of ``dst_off``, ``size``, ``expr``, ``leaf_off`` as
(leaf tuple, offset) pairs, ``level``); optional delta overlay
``delta_src``/``delta_dst``/``delta_exp``/``delta_cav``/``n_delta`` and
``dead_pairs``.

A graph carried with its writer state as well can take incremental
updates in the port: ``delta_cap``, the dead ledger ``dead_buf`` with
``n_dead``, and the lookup tables ``self_off``, ``rel_off``,
``relperm_off`` and ``arrow_maps`` (tuples of resource type id, tupleset
relation id, term slot offset and the per-subject-type target offsets).
The overlay's slot index and the ledger's pair set are rebuilt from
them.

A graph with conditional grants also carries ``res_cav`` (each residual
edge's caveat instance row; ``delta_cav`` is the overlay's) and
``caveats``, its caveat table in plain form (:func:`caveats_from_arrays`),
so the port evaluates the same VM rows as the reference.
"""

from __future__ import annotations

import threading

import numpy as np

from .caveats.ast import CaveatParam, CaveatType, StringInterner
from .caveats.compile import CaveatProgram, ListSpec
from .caveats.vm import CavMeta, CompiledCaveats, _CavHost
from .device import resolve_device
from .models.schema import (
    Arrow,
    Exclude,
    Expr,
    Intersect,
    Nil,
    RelationRef,
    Union,
)
from .ops.reachability import (
    CompiledGraph,
    _BlockMeta,
    _next_bucket,
    _PermProgram,
)


def expr_from_tuple(t) -> Expr:
    """Nested-tuple expression -> the port's :class:`Expr` tree."""
    tag = t[0]
    if tag == "nil":
        return Nil()
    if tag == "rel":
        return RelationRef(t[1])
    if tag == "arrow":
        return Arrow(t[1], t[2])
    if tag == "or":
        return Union(tuple(expr_from_tuple(o) for o in t[1:]))
    if tag == "and":
        return Intersect(tuple(expr_from_tuple(o) for o in t[1:]))
    if tag == "sub":
        return Exclude(expr_from_tuple(t[1]), expr_from_tuple(t[2]))
    raise ValueError(f"unknown expression tag {tag!r}")


def caveats_from_arrays(c: dict) -> CompiledCaveats:
    """A :class:`CompiledCaveats` from plain data: ``metas`` (dicts of the
    CavMeta fields), ``hosts`` (dicts of the host arrays ``ctx_e``,
    ``ctx_v``, ``ctx_k``, ``lo_e``, ``lo_v``, ``hi_e``, ``hi_v``,
    ``list_k``, ``real`` and a ``program``: ``name``, ``params`` as
    (name, type, list element type) triples, ``ops``, ``imm``,
    ``n_regs``, ``out_reg``, ``lists`` as (ranges, param, element type)
    triples, ``scalar_col``, ``list_id``, ``scalar_width``, ``uses_now``,
    ``time_arith``), the string ``interner`` as a string -> code dict,
    ``n_rows``, ``inst_row``, ``key_row`` as ((name, context), row) pairs,
    ``n_inst``, ``time_bounds``, ``time_exact`` and ``any_now``. Arrays
    are copied: instance appends write the host tables in place."""
    interner = StringInterner()
    interner._map = dict(c["interner"])
    hosts = []
    for h in c["hosts"]:
        p = h["program"]
        prog = CaveatProgram(
            name=p["name"],
            params=tuple(CaveatParam(n, CaveatType(t, el))
                         for n, t, el in p["params"]),
            ops=np.array(p["ops"], dtype=np.int32).reshape(-1, 4),
            imm=np.array(p["imm"], dtype=np.float64),
            n_regs=int(p["n_regs"]), out_reg=int(p["out_reg"]),
            lists=tuple(ListSpec(None if r is None
                                 else tuple(tuple(x) for x in r), pi, el)
                        for r, pi, el in p["lists"]),
            scalar_col=dict(p["scalar_col"]), list_id=dict(p["list_id"]),
            scalar_width=dict(p["scalar_width"]),
            uses_now=bool(p["uses_now"]), time_arith=bool(p["time_arith"]))
        hosts.append(_CavHost(prog, **{
            k: np.array(h[k], dtype=bool if k in ("ctx_k", "list_k", "real")
                        else np.float32)
            for k in ("ctx_e", "ctx_v", "ctx_k", "lo_e", "lo_v", "hi_e",
                      "hi_v", "list_k", "real")}))
    return CompiledCaveats(
        metas=tuple(CavMeta(**m) for m in c["metas"]), hosts=hosts,
        interner=interner, n_rows=int(c["n_rows"]),
        inst_row=np.array(c["inst_row"], dtype=np.int64),
        key_row={tuple(k): int(r) for k, r in c["key_row"]},
        n_inst=int(c["n_inst"]),
        time_bounds=np.array(c["time_bounds"], dtype=np.float64),
        time_exact=bool(c["time_exact"]), any_now=bool(c["any_now"]))


def _residual(d: dict, M: int) -> tuple:
    if d.get("res_src") is not None:
        return (np.array(d["res_src"], dtype=np.int32),
                np.array(d["res_dst"], dtype=np.int32),
                np.array(d["res_exp"], dtype=np.float32))
    res_idx = np.asarray(d["res_idx"], dtype=np.int64)
    E_pad = _next_bucket(max(len(res_idx), 1))
    src = np.full(E_pad, M, dtype=np.int32)
    dst = np.full(E_pad, M, dtype=np.int32)
    exp = np.full(E_pad, -np.inf, dtype=np.float32)
    src[:len(res_idx)] = np.asarray(d["src"])[res_idx]
    dst[:len(res_idx)] = np.asarray(d["dst"])[res_idx]
    exp[:len(res_idx)] = np.asarray(d["exp_rel"])[res_idx]
    return src, dst, exp


def from_reference_arrays(d: dict, device=None) -> CompiledGraph:
    """Build a :class:`CompiledGraph` on ``device`` (``cuda`` unless the
    caller passes ``"cpu"``) from the plain-array form described above."""
    M = int(d["M"])
    res_src, res_dst, res_exp = _residual(d, M)
    bounds = d.get("res_level_bounds")

    def opt(key, dtype, src=d):
        # a copy: the port mutates its overlay and residual in place, and
        # must not write into the caller's arrays
        v = src.get(key)
        return None if v is None else np.array(v, dtype=dtype)

    blocks = [
        _BlockMeta(int(b["dst_off"]), int(b["n_dst"]), int(b["src_off"]),
                   int(b["n_src"]),
                   np.asarray(b["dst_local"], dtype=np.int32),
                   np.asarray(b["src_local"], dtype=np.int32),
                   int(b.get("level", 0)), bool(b.get("closured", False)),
                   opt("base_dst_local", np.int32, b),
                   opt("base_src_local", np.int32, b))
        for b in d.get("blocks", ())]
    programs = []
    for p in d["programs"]:
        leaf_off = {expr_from_tuple(leaf): int(off)
                    for leaf, off in p["leaf_off"]}
        programs.append(_PermProgram(int(p["dst_off"]), int(p["size"]),
                                     expr_from_tuple(p["expr"]), leaf_off,
                                     int(p.get("level", 0))))

    dead = opt("dead_pairs", np.int64)
    writer = {}
    if d.get("dead_buf") is not None and d.get("self_off") is not None:
        n_delta, n_dead = int(d.get("n_delta", 0)), int(d.get("n_dead", 0))
        dsrc, ddst = opt("delta_src", np.int32), opt("delta_dst", np.int32)
        dead_buf = np.array(d["dead_buf"], dtype=np.int64).reshape(-1, 2)
        writer = dict(
            delta_cap=int(d.get("delta_cap", len(dsrc))),
            delta_pos={(int(s), int(t)): i for i, (s, t) in enumerate(
                zip(dsrc[:n_delta].tolist(), ddst[:n_delta].tolist()))},
            dead_buf=dead_buf,
            dead_set={(int(s), int(t))
                      for s, t in dead_buf[:n_dead].tolist()},
            n_dead=n_dead,
            host_lock=threading.Lock(),
            block_codes={},
            block_index={(b.dst_off, b.src_off): i
                         for i, b in enumerate(blocks)},
            self_off=opt("self_off", np.int64),
            rel_off=opt("rel_off", np.int64),
            relperm_off=opt("relperm_off", np.int64),
            arrow_maps=[(int(a), int(r), int(o),
                         np.asarray(t, dtype=np.int64))
                        for a, r, o, t in d.get("arrow_maps", ())])
        if dead is None:
            dead = dead_buf[:n_dead]
    return CompiledGraph(
        schema=None,
        revision=int(d.get("revision", 0)),
        base_time=float(d["base_time"]),
        M=M,
        slot_offset=dict(d.get("slot_offset", {})),
        type_sizes=dict(d.get("type_sizes", {})),
        programs=programs,
        blocks=blocks,
        res_src=res_src,
        res_dst=res_dst,
        res_exp=res_exp,
        res_cav=opt("res_cav", np.int32),
        res_level_bounds=None if bounds is None
        else tuple(int(x) for x in bounds),
        n_levels=int(d.get("n_levels", 0)),
        range_levels=opt("range_levels", np.int32),
        range_offs=opt("range_offs", np.int64),
        src=opt("src", np.int32),
        dst=opt("dst", np.int32),
        exp_rel=opt("exp_rel", np.float32),
        n_edges=int(d.get("n_edges", 0)),
        res_idx=opt("res_idx", np.int64),
        delta_src=opt("delta_src", np.int32),
        delta_dst=opt("delta_dst", np.int32),
        delta_exp=opt("delta_exp", np.float32),
        delta_cav=opt("delta_cav", np.int32),
        n_delta=int(d.get("n_delta", 0)),
        dead_pairs=None if dead is None else dead.reshape(-1, 2),
        caveats=None if d.get("caveats") is None
        else caveats_from_arrays(d["caveats"]),
        device=resolve_device(device),
        **writer,
    )
