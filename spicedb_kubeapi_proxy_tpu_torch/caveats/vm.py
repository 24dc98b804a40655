"""The caveat VM and its host-side instance tables.

Counterpart of the JAX package's ``caveats/vm.py``. The host half (the
instance tables, the request-context encoder, the verdict-flip bounds and
the incremental instance appends) is a copy of the reference's numpy
code; the device half evaluates the tapes with PyTorch.

Execution model
---------------
One caveat = one op tape (:mod:`.compile`); one *instance* = one distinct
``(caveat, context)`` pair carried by at least one live tuple. The VM
evaluates every instance of every caveat once per fixpoint dispatch, and
the fixpoint consumes the result as a per-instance validity row: edge
activation becomes ``(exp > now) & cav_ok[edge_row]``
(ops/semiring.edge_activation). The reference scans the tape with
``lax.scan`` and picks each opcode's branch with ``lax.switch``; here the
tape is a host array, so :func:`eval_caveats` walks it in Python and
issues one torch expression per opcode, reading only the operand
registers that opcode reads, with no device sync.

Value representation
--------------------
Every scalar rides TWO f32 planes, as in the reference::

    ext = floor(v / 2**16)        val = v - ext * 2**16

a monotone split that is exact for all integers |v| < 2^40 (both planes
stay under 2^24): comparisons are lexicographic on (ext, val), equality
is plane-wise, and ``in`` is a lexicographic [lo, hi] range check per
list element, which makes CIDR allowlists ordinary interval tests.
Additions renormalize the carry; mul/div recombine into one f32.
Exactness rests on ``floor(v / 65536)`` and ``e * 65536 + v`` being
separately rounded f32 operations; eager torch issues each as its own
kernel, so nothing is contracted into a fused multiply-add (a fused
kernel must keep them apart: ``__fmul_rn`` / ``__fadd_rn`` or
``--fmad=false``).

Three-valued logic rides an explicit ``known`` plane: missing context
flows structurally, ``&&``/``||`` are Kleene, and the top-level UNKNOWN
is the missing-context verdict the engine fails closed and counts.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .ast import (
    CaveatError,
    StringInterner,
    UnencodableListError,
    encode_list,
    encode_scalar,
    ip_words,
    parse_ip_mapped,
)
from .compile import (
    CaveatProgram,
    OP_ADD,
    OP_AND,
    OP_CONST,
    OP_DIV,
    OP_EQ,
    OP_GE,
    OP_GT,
    OP_IN,
    OP_LE,
    OP_LOAD,
    OP_LT,
    OP_MUL,
    OP_NE,
    OP_NOT,
    OP_OR,
    OP_SUB,
    compile_caveat,
)

SPLIT = 65536.0  # the plane radix (2^16)

#: the auto-injected request-context key: a ``now timestamp`` parameter
#: is filled with the dispatch clock unless the caller supplied it
NOW_PARAM = "now"


def split_planes(v) -> tuple[np.ndarray, np.ndarray]:
    """f64 value(s) -> (ext, val) f32 planes (monotone, integer-exact
    to 2^40)."""
    v = np.asarray(v, dtype=np.float64)
    ext = np.floor(v / SPLIT)
    return ext.astype(np.float32), (v - ext * SPLIT).astype(np.float32)


def _bucket(n: int, minimum: int = 8) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


@dataclass(frozen=True)
class CavMeta:
    """Static shape of one caveat's VM invocation (RunMeta.caveats),
    shared across revisions. ``P``/``L`` are the ALLOCATED context/list
    rows (>= 1, as the reference allocates them)."""

    name: str
    T: int  # tape length
    n_regs: int
    out_reg: int
    P: int  # scalar context columns (allocated)
    L: int  # list ids (allocated)
    K: int  # list capacity (elements per list)
    n_pad: int  # instance rows (padded)
    n_real: int  # real instances at compile time
    row_off: int  # global cav_ok row of this caveat's instance 0


@dataclass
class _CavHost:
    """One caveat's host-side arrays (shared across incremental
    descendants; mutated only under the graph's host lock)."""

    program: CaveatProgram
    ctx_e: np.ndarray  # f32 [P, n_pad]
    ctx_v: np.ndarray
    ctx_k: np.ndarray  # bool [P, n_pad]
    lo_e: np.ndarray  # f32 [L, K, n_pad]
    lo_v: np.ndarray
    hi_e: np.ndarray
    hi_v: np.ndarray
    list_k: np.ndarray  # bool [L, n_pad]
    real: np.ndarray  # bool [n_pad] — 1 = a live instance row


def _dict_timestamps(prog: CaveatProgram, ctx: dict) -> list[float]:
    """Timestamp values a context dict supplies for a program's declared
    timestamp parameters (scalars and list elements) — the verdict-flip
    instants a `now` comparison can cross."""
    from .ast import parse_timestamp

    out: list[float] = []
    for p in prog.params:
        if p.name == NOW_PARAM or p.name not in ctx:
            continue
        try:
            if p.type.is_list and p.type.elem == "timestamp":
                vals = ctx[p.name]
                if isinstance(vals, list):
                    out.extend(parse_timestamp(v) for v in vals)
            elif not p.type.is_list and p.type.name == "timestamp":
                out.append(parse_timestamp(ctx[p.name]))
        except CaveatError:
            continue
    return out


def _ctx_timestamps(prog: CaveatProgram, ctx_json: str) -> list[float]:
    try:
        ctx = json.loads(ctx_json) if ctx_json else {}
    except ValueError:
        return []
    return _dict_timestamps(prog, ctx) if isinstance(ctx, dict) else []


def _encode_instance_cols(meta: CavMeta, prog: CaveatProgram,
                          interner: StringInterner, ctx_json: str):
    """Encode one stored context JSON into one instance row's columns
    (strict: tuple contexts intern new strings)."""
    ctx = json.loads(ctx_json) if ctx_json else {}
    if not isinstance(ctx, dict):
        raise CaveatError(f"caveat context must be an object: {ctx_json!r}")
    sce = np.zeros(meta.P, dtype=np.float32)
    scv = np.zeros(meta.P, dtype=np.float32)
    sck = np.zeros(meta.P, dtype=bool)
    lle = np.zeros((meta.L, meta.K), dtype=np.float32)
    llv = np.zeros((meta.L, meta.K), dtype=np.float32)
    lhe = np.full((meta.L, meta.K), -1.0, dtype=np.float32)
    lhv = np.zeros((meta.L, meta.K), dtype=np.float32)
    lk = np.zeros(meta.L, dtype=bool)
    # constant lists are "known" with their literal ranges on every row
    for lid, spec in enumerate(prog.lists):
        if spec.ranges is None:
            continue
        if len(spec.ranges) > meta.K:
            raise CaveatError(
                f"caveat {meta.name!r}: constant list exceeds capacity")
        for j, (lo, hi) in enumerate(spec.ranges):
            lle[lid, j], llv[lid, j] = split_planes(lo)
            lhe[lid, j], lhv[lid, j] = split_planes(hi)
        lk[lid] = True
    for p in prog.params:
        if p.name not in ctx:
            continue
        if p.type.is_list:
            lid = prog.list_id.get(p.name)
            if lid is None:
                continue  # declared but unused in the expression
            try:
                ranges = encode_list(ctx[p.name], p.type.elem, interner,
                                     strict=True)
            except UnencodableListError:
                continue  # list stays UNKNOWN: fail closed either way
            if len(ranges) > meta.K:
                raise CaveatError(
                    f"caveat {meta.name!r}: list {p.name!r} exceeds "
                    f"row capacity {meta.K}")
            for j, (lo, hi) in enumerate(ranges):
                lle[lid, j], llv[lid, j] = split_planes(lo)
                lhe[lid, j], lhv[lid, j] = split_planes(hi)
            lk[lid] = True
        else:
            col = prog.scalar_col.get(p.name)
            if col is None:
                continue
            if p.type.name == "ipaddress":
                # wide value: four 32-bit words across consecutive
                # columns — exact for BOTH families (IPv6 support)
                for k, w in enumerate(
                        ip_words(parse_ip_mapped(ctx[p.name]))):
                    sce[col + k], scv[col + k] = split_planes(float(w))
                    sck[col + k] = True
                continue
            x = encode_scalar(ctx[p.name], p.type.name, interner,
                              strict=True)
            sce[col], scv[col] = split_planes(x)
            sck[col] = True
    return sce, scv, sck, lle, llv, lhe, lhv, lk


@dataclass
class CompiledCaveats:
    """Every caveat instance in one compiled graph, device-ready.

    Shared (like the delta overlay) by every incremental descendant of
    one compiled base: instance appends mutate the host arrays in place
    under the graph's host lock, and the device tables with them, in the
    same queued device patch as the overlay slots that use the rows
    (:meth:`patch_rows`).
    """

    metas: tuple  # tuple[CavMeta, ...]
    hosts: list  # list[_CavHost] aligned with metas
    interner: StringInterner
    n_rows: int  # 1 + sum(n_pad): row 0 = uncaveated/always-valid
    inst_row: np.ndarray  # store caveat-instance id -> global row (0=none)
    key_row: dict  # (name, ctx_json) -> global row
    n_inst: int  # live instance rows (incl. appended)
    time_bounds: np.ndarray  # sorted unique unix seconds (verdict flips)
    time_exact: bool  # False: flips not enumerable (timestamp arith)
    any_now: bool  # some program reads the auto-injected clock

    @property
    def n_instances(self) -> int:
        return self.n_inst

    def param_names(self) -> frozenset:
        """Every parameter name any compiled caveat declares — the ONLY
        request-context keys that can influence a verdict."""
        got = getattr(self, "_param_names", None)
        if got is None:
            got = frozenset(
                p.name for h in self.hosts for p in h.program.params)
            self._param_names = got
        return got

    def relevant_context(self, context: Optional[dict]
                         ) -> Optional[dict]:
        """The subset of a request context the compiled caveats can
        actually read. Decision-cache digests hash ONLY this — fields
        no caveat declares (the middleware's name/verb/resource/...)
        would otherwise fragment the cache per request while provably
        unable to change any verdict."""
        if not context:
            return None
        names = self.param_names()
        out = {k: v for k, v in context.items() if k in names}
        return out or None

    def request_ts(self, context: Optional[dict]) -> list:
        """Request-supplied verdict-flip timestamps (cache-deadline
        input) — a cheap scan, not a full array encode."""
        if not context or not self.any_now:
            return []
        out: list = []
        for h in self.hosts:
            if h.program.uses_now:
                out.extend(_dict_timestamps(h.program, context))
        return out

    def signature(self) -> tuple:
        return tuple(
            (m.name, m.T, m.n_regs, m.out_reg, m.P, m.L, m.K, m.n_pad,
             m.n_real, m.row_off) for m in self.metas)

    # -- request-context encoding -------------------------------------------

    def encode_request(self, context: Optional[dict], now: float
                       ) -> tuple[tuple, list]:
        """(per-caveat request arrays pytree, request timestamp values).

        Unknown context keys are ignored (SpiceDB passes extra context
        through); malformed values for a declared parameter leave the
        parameter UNKNOWN — missing context, which fails closed — rather
        than erroring the whole dispatch."""
        context = context or {}
        out = []
        req_ts: list[float] = []
        # ONE scratch per call: unseen request strings get distinct
        # negative codes (consistent across this call's caveats; a
        # shared -1 sentinel would make any two unseen strings compare
        # equal — fail open), and nothing accumulates on the shared
        # table under adversarial request values
        scratch = self.interner.scratch()
        for m, h in zip(self.metas, self.hosts):
            prog = h.program
            rce = np.zeros(m.P, dtype=np.float32)
            rcv = np.zeros(m.P, dtype=np.float32)
            rck = np.zeros(m.P, dtype=bool)
            rloe = np.zeros((m.L, m.K), dtype=np.float32)
            rlov = np.zeros((m.L, m.K), dtype=np.float32)
            rhie = np.full((m.L, m.K), -1.0, dtype=np.float32)
            rhiv = np.zeros((m.L, m.K), dtype=np.float32)
            rlk = np.zeros(m.L, dtype=bool)
            for p in prog.params:
                if p.type.is_list:
                    lid = prog.list_id.get(p.name)
                    if lid is None or p.name not in context:
                        continue
                    try:
                        ranges = encode_list(context[p.name], p.type.elem,
                                             scratch, strict=False)
                    except CaveatError:
                        continue
                    if len(ranges) > m.K:
                        # oversized request list: the parameter stays
                        # UNKNOWN (fails closed) — counted so operators
                        # can tell capacity overflow from genuinely
                        # absent context and raise the tuple-side lists
                        # (K sizes from them) or trim the request's
                        from ..utils.metrics import metrics

                        metrics.counter(
                            "engine_caveat_request_list_overflow_total"
                        ).inc()
                        continue
                    for j, (lo, hi) in enumerate(ranges):
                        rloe[lid, j], rlov[lid, j] = split_planes(lo)
                        rhie[lid, j], rhiv[lid, j] = split_planes(hi)
                        if p.type.elem == "timestamp":
                            req_ts.extend((lo, hi))
                    rlk[lid] = True
                    continue
                col = prog.scalar_col.get(p.name)
                if col is None:
                    continue
                if p.type.name == "ipaddress":
                    if p.name not in context:
                        continue
                    try:
                        words = ip_words(
                            parse_ip_mapped(context[p.name]))
                    except CaveatError:
                        continue  # malformed -> UNKNOWN (fails closed)
                    for k, w in enumerate(words):
                        rce[col + k], rcv[col + k] = split_planes(
                            float(w))
                        rck[col + k] = True
                    continue
                if p.name in context:
                    try:
                        x = encode_scalar(context[p.name], p.type.name,
                                          scratch, strict=False)
                    except CaveatError:
                        continue
                elif p.name == NOW_PARAM and p.type.name == "timestamp":
                    x = float(now)
                else:
                    continue
                rce[col], rcv[col] = split_planes(x)
                rck[col] = True
                if p.type.name == "timestamp" and p.name != NOW_PARAM:
                    req_ts.append(x)
            out.append({"ce": rce, "cv": rcv, "ck": rck,
                        "loe": rloe, "lov": rlov, "hie": rhie,
                        "hiv": rhiv, "lk": rlk})
        return tuple(out), req_ts

    def next_time_bound(self, now: float, extra_ts=()) -> float:
        """Earliest verdict-flip instant strictly after ``now`` — the
        caveat analog of the store's expiration watermark, joined into
        decision-cache deadlines. ``now`` itself when flips are not
        enumerable (timestamp arithmetic): entries are born dead, i.e.
        contexted queries effectively uncached."""
        if not self.metas or not self.any_now:
            return float("inf")
        if not self.time_exact:
            return now
        bounds = self.time_bounds
        if extra_ts:
            bounds = np.union1d(bounds, np.asarray(list(extra_ts),
                                                   dtype=np.float64))
        i = int(np.searchsorted(bounds, now, side="right"))
        return float(bounds[i]) if i < len(bounds) else float("inf")

    # -- device upload -------------------------------------------------------

    def device_static(self, device) -> tuple:
        """Per-caveat tables on ``device`` (called under the graph's host
        lock; the result lives in the graph's device state, where an
        incremental instance append patches it in place). Copies, also on
        the CPU: host commits write the host arrays while queries run.
        Each entry also carries its tape as a host list (the VM branches
        on opcodes on the host) and the one-element constants it reads."""

        def put(a):
            return torch.as_tensor(np.ascontiguousarray(a)).to(
                device=device, copy=True)

        out = []
        for h in self.hosts:
            ime, imv = split_planes(h.program.imm)
            out.append({
                "tape": [tuple(r) for r in h.program.ops.tolist()],
                "ime": put(ime), "imv": put(imv),
                "ce": put(h.ctx_e), "cv": put(h.ctx_v),
                "ck": put(h.ctx_k),
                "loe": put(h.lo_e), "lov": put(h.lo_v),
                "hie": put(h.hi_e), "hiv": put(h.hi_v),
                "lk": put(h.list_k),
                "real": put(h.real),
                "one": torch.ones(1, dtype=torch.bool, device=device),
                "no": torch.zeros(1, dtype=torch.bool, device=device),
                "zero": torch.zeros(1, dtype=torch.float32, device=device),
            })
        return tuple(out)

    @staticmethod
    def patch_rows(statics: tuple, appended: list) -> None:
        """Write instance rows appended on the host (``apply_appends``'s
        ``[(c_idx, local_row, cols), ...]``) into the device tables, in
        place. The caller holds the exclusive side of the graph's device
        lock, so no dispatch sees a row half written."""
        for ci, local, cols in appended:
            ent = statics[ci]
            dev = ent["ce"].device
            for key, col in zip(("ce", "cv", "ck", "loe", "lov", "hie",
                                 "hiv", "lk"), cols):
                ent[key][..., local] = torch.as_tensor(col).to(dev)
            ent["real"][local] = True

    def applied_rows(self) -> tuple:
        """Per-caveat live instance-row counts — the append watermark a
        mesh view syncs its replicated tables against (spare rows are
        taken append-only per caveat, so ``[old, new)`` names exactly
        the columns to patch). Caller holds the graph host guard."""
        return tuple(int(h.real.sum()) for h in self.hosts)

    # -- incremental instance appends ---------------------------------------

    def lookup_row(self, name: str, ctx_json: str) -> Optional[int]:
        return self.key_row.get((name, ctx_json))

    def plan_append(self, name: str, ctx_json: str,
                    planned: dict) -> Optional[int]:
        """Reserve (in ``planned``, not yet applied) a free instance row
        for a new (caveat, context) pair; None when the caveat has no
        compiled tape, its row bucket is full, or the context cannot be
        encoded against the frozen layout — the caller falls back to a
        full recompile."""
        got = planned.get((name, ctx_json))
        if got is not None:
            return got[0]
        for ci, (m, h) in enumerate(zip(self.metas, self.hosts)):
            if m.name != name:
                continue
            used = int(h.real.sum()) + sum(
                1 for (n2, _), (_, ci2, _) in planned.items()
                if n2 == name and ci2 == ci)
            if used >= m.n_pad:
                return None
            try:
                cols = _encode_instance_cols(m, h.program, self.interner,
                                             ctx_json)
            except (CaveatError, ValueError):
                return None
            row = m.row_off + used
            planned[(name, ctx_json)] = (row, ci, (used, cols))
            return row
        return None  # caveat had no instances at compile: no tape

    def apply_appends(self, planned: dict) -> list:
        """Write planned instance rows into the shared host arrays
        (caller holds the graph host lock) and return
        ``[(c_idx, local_row, cols), ...]`` for the device tables
        (:meth:`patch_rows`)."""
        out = []
        new_ts: list[float] = []
        for (name, ctx_json), (row, ci, (local, cols)) in planned.items():
            h = self.hosts[ci]
            sce, scv, sck, lle, llv, lhe, lhv, lk = cols
            h.ctx_e[:, local] = sce
            h.ctx_v[:, local] = scv
            h.ctx_k[:, local] = sck
            h.lo_e[:, :, local] = lle
            h.lo_v[:, :, local] = llv
            h.hi_e[:, :, local] = lhe
            h.hi_v[:, :, local] = lhv
            h.list_k[:, local] = lk
            h.real[local] = True
            self.key_row[(name, ctx_json)] = row
            self.n_inst += 1
            out.append((ci, local, cols))
            # verdict-flip watermark: a `now`-reading caveat's NEW
            # instance brings new flip instants — without extending the
            # bounds, a cached ALLOW filled before this append could
            # outlive the new tuple's window (stale grant past
            # revocation, exactly what the watermark exists to prevent)
            if h.program.uses_now:
                new_ts.extend(_ctx_timestamps(h.program, ctx_json))
        if new_ts:
            # replace, never mutate: readers (next_time_bound on cache
            # fills, off the engine lock) see either array atomically
            self.time_bounds = np.union1d(
                self.time_bounds,
                np.asarray([t for t in new_ts if np.isfinite(t)],
                           dtype=np.float64))
        return out


# ---------------------------------------------------------------------------
# Table construction (compile_graph time)
# ---------------------------------------------------------------------------


def build_caveat_table(caveat_defs: dict, inst_table: list,
                       used_ids) -> CompiledCaveats:
    """Compile every caveat with live instances and lay out the instance
    tables. ``inst_table`` is the store's append-only
    ``(name, ctx_json)`` list (index 0 reserved); ``used_ids`` the
    distinct nonzero instance ids among live tuples."""
    interner = StringInterner()
    by_name: dict[str, list[int]] = {}
    for iid in sorted(int(x) for x in used_ids):
        name = inst_table[iid][0]
        by_name.setdefault(name, []).append(iid)

    metas: list[CavMeta] = []
    hosts: list[_CavHost] = []
    inst_row = np.zeros(max(len(inst_table), 1), dtype=np.int64)
    key_row: dict = {}
    ts_bounds: list[float] = []
    time_exact = True
    any_now = False
    row_off = 1  # row 0 = uncaveated / always valid
    for name in sorted(by_name):
        defn = caveat_defs.get(name)
        if defn is None:
            raise CaveatError(
                f"tuples reference undeclared caveat {name!r}")
        prog = compile_caveat(defn, interner)
        ids = by_name[name]
        n_real = len(ids)
        n_pad = _bucket(n_real, 8)
        # list capacity: the longest tuple-context or constant list,
        # with bucket headroom so appended instances rarely force a
        # recompile. Floor 16: request-supplied lists (e.g. the
        # middleware's `groups`) have no tuple-side sizing signal, and
        # a floor of 4 would silently drop any 5-group caller to
        # missing context
        k_need = 1
        for spec in prog.lists:
            if spec.ranges is not None:
                k_need = max(k_need, len(spec.ranges))
        for iid in ids:
            try:
                ctx = json.loads(inst_table[iid][1] or "{}")
            except ValueError:
                ctx = {}
            if isinstance(ctx, dict):
                for p in prog.params:
                    if p.type.is_list \
                            and isinstance(ctx.get(p.name), list):
                        k_need = max(k_need, len(ctx[p.name]))
        meta = CavMeta(
            name=name, T=len(prog.ops), n_regs=prog.n_regs,
            out_reg=prog.out_reg, P=max(prog.n_scalars, 1),
            L=max(len(prog.lists), 1), K=_bucket(k_need, 16),
            n_pad=n_pad, n_real=n_real, row_off=row_off)
        host = _CavHost(
            program=prog,
            ctx_e=np.zeros((meta.P, n_pad), dtype=np.float32),
            ctx_v=np.zeros((meta.P, n_pad), dtype=np.float32),
            ctx_k=np.zeros((meta.P, n_pad), dtype=bool),
            lo_e=np.zeros((meta.L, meta.K, n_pad), dtype=np.float32),
            lo_v=np.zeros((meta.L, meta.K, n_pad), dtype=np.float32),
            hi_e=np.full((meta.L, meta.K, n_pad), -1.0, dtype=np.float32),
            hi_v=np.zeros((meta.L, meta.K, n_pad), dtype=np.float32),
            list_k=np.zeros((meta.L, n_pad), dtype=bool),
            real=np.zeros(n_pad, dtype=bool),
        )
        for local, iid in enumerate(ids):
            name_i, ctx_json = inst_table[iid]
            cols = _encode_instance_cols(meta, prog, interner, ctx_json)
            sce, scv, sck, lle, llv, lhe, lhv, lk = cols
            host.ctx_e[:, local] = sce
            host.ctx_v[:, local] = scv
            host.ctx_k[:, local] = sck
            host.lo_e[:, :, local] = lle
            host.lo_v[:, :, local] = llv
            host.hi_e[:, :, local] = lhe
            host.hi_v[:, :, local] = lhv
            host.list_k[:, local] = lk
            host.real[local] = True
            inst_row[iid] = row_off + local
            key_row[(name_i, ctx_json)] = row_off + local
        metas.append(meta)
        hosts.append(host)
        if prog.time_arith:
            time_exact = False
        if prog.uses_now:
            any_now = True
            # verdict-flip instants: every timestamp the stored contexts
            # (and constant tape immediates) can compare now against
            ts_bounds.extend(float(x) for x in prog.imm[
                prog.ops[:, 0] == OP_CONST].tolist())
            for iid in ids:
                ts_bounds.extend(
                    _ctx_timestamps(prog, inst_table[iid][1]))
        row_off += n_pad

    bounds = np.unique(np.asarray(
        [t for t in ts_bounds if np.isfinite(t)], dtype=np.float64)) \
        if ts_bounds else np.empty(0, dtype=np.float64)
    return CompiledCaveats(
        metas=tuple(metas), hosts=hosts, interner=interner,
        n_rows=row_off, inst_row=inst_row, key_row=key_row,
        n_inst=sum(m.n_real for m in metas),
        time_bounds=bounds, time_exact=time_exact, any_now=any_now)


# ---------------------------------------------------------------------------
# Evaluation (torch, once per fixpoint dispatch)
# ---------------------------------------------------------------------------

_REQ_PLANES = ("ce", "cv", "loe", "lov", "hie", "hiv")
_REQ_FLAGS = ("ck", "lk")


def request_tensors(reqs: tuple, device) -> tuple:
    """One dispatch's request arrays (:meth:`CompiledCaveats.encode_request`)
    on ``device``: every caveat's planes in one float32 copy and its known
    flags in one more, each from a pinned buffer on a GPU (asynchronous,
    so no device sync), handed out as per-caveat views."""
    planes = np.concatenate([np.ravel(r[k]) for r in reqs
                             for k in _REQ_PLANES]).astype(np.float32)
    flags = np.concatenate([np.ravel(r[k]) for r in reqs
                            for k in _REQ_FLAGS]).astype(np.uint8)
    pin = device.type == "cuda"
    dev_bufs = []
    for buf in (planes, flags):
        t = torch.from_numpy(buf)
        if pin:
            t = t.pin_memory()
        dev_bufs.append(t.to(device, non_blocking=pin))
    f_dev, b_dev = dev_bufs[0], dev_bufs[1].view(torch.bool)
    out = []
    fo = bo = 0
    for r in reqs:
        ent = {}
        for k in _REQ_PLANES:
            n = r[k].size
            ent[k] = f_dev[fo:fo + n].view(r[k].shape)
            fo += n
        for k in _REQ_FLAGS:
            n = r[k].size
            ent[k] = b_dev[bo:bo + n].view(r[k].shape)
            bo += n
        out.append(ent)
    return tuple(out)


def _renorm(e, v):
    carry = torch.floor(v / SPLIT)
    return e + carry, v - carry * SPLIT


def _combine(e, v):
    return e * SPLIT + v


def _vm_eval(meta: CavMeta, stat: dict, req: dict):
    """Evaluate one caveat's tape over its padded instance rows. Returns
    (allow bool [n_pad], missing bool [n_pad]): allow is the known-true
    arm of the tri-state, missing is UNKNOWN.

    A register holds planes ``(ext, val, known)`` or, when a boolean op
    wrote it, ``(truth, known)``: the reference's ``(0, float(truth))``
    planes, whose truthiness is ``truth`` itself. Tuple context overrides
    request context (SpiceDB precedence), merged per column as a LOAD or
    an IN reads it. Tensors are [n_pad] (or [K, n_pad] list ranges); a
    constant or a request value is a one-element tensor that broadcasts."""
    N = meta.n_pad
    one, no, zero = stat["one"], stat["no"], stat["zero"]
    regs: list = [None] * max(meta.n_regs, 1)

    def planes(r):
        if r is None:  # never written: the reference's zero registers
            return zero, zero, no
        if len(r) == 2:
            return zero, r[0].to(torch.float32), r[1]
        return r

    def truth(r):
        if r is None:
            return no, no
        if len(r) == 2:
            return r
        e, v, k = r
        return (e != 0) | (v != 0), k

    for t, (op, dst, a, b) in enumerate(stat["tape"]):
        if op == OP_CONST:
            r = (stat["ime"][t:t + 1], stat["imv"][t:t + 1], one)
        elif op == OP_LOAD:
            sk = stat["ck"][a]
            r = (torch.where(sk, stat["ce"][a], req["ce"][a:a + 1]),
                 torch.where(sk, stat["cv"][a], req["cv"][a:a + 1]),
                 sk | req["ck"][a:a + 1])
        elif op in (OP_AND, OP_OR, OP_NOT):
            ta, ka = truth(regs[a])
            af = ka & ~ta
            if op == OP_NOT:
                r = (af, ka)
            else:
                tb, kb = truth(regs[b])
                at, bt, bf = ka & ta, kb & tb, kb & ~tb
                if op == OP_AND:
                    val = at & bt
                    r = (val, (af | bf) | val)
                else:
                    val = at | bt
                    r = (val, val | (af & bf))
        elif op == OP_IN:
            ae, av, ak = planes(regs[a])
            pick = stat["lk"][b]  # [N]: the tuple supplies this list

            def rng(key):
                return torch.where(pick, stat[key][b], req[key][b][:, None])

            le, lv, he, hv = rng("loe"), rng("lov"), rng("hie"), rng("hiv")
            ge = (ae > le) | ((ae == le) & (av >= lv))
            lte = (ae < he) | ((ae == he) & (av <= hv))
            r = ((ge & lte).any(dim=0), ak & (pick | req["lk"][b:b + 1]))
        else:
            ae, av, ak = planes(regs[a])
            be, bv, bk = planes(regs[b])
            kab = ak & bk
            if op == OP_EQ:
                r = ((ae == be) & (av == bv), kab)
            elif op == OP_NE:
                r = ((ae != be) | (av != bv), kab)
            elif op == OP_LT:
                r = ((ae < be) | ((ae == be) & (av < bv)), kab)
            elif op == OP_LE:
                r = ((ae < be) | ((ae == be) & (av <= bv)), kab)
            elif op == OP_GT:
                r = ((ae > be) | ((ae == be) & (av > bv)), kab)
            elif op == OP_GE:
                r = ((ae > be) | ((ae == be) & (av >= bv)), kab)
            elif op == OP_ADD:
                r = _renorm(ae + be, av + bv) + (kab,)
            elif op == OP_SUB:
                r = _renorm(ae - be, av - bv) + (kab,)
            elif op == OP_MUL:
                prod = _combine(ae, av) * _combine(be, bv)
                e = torch.floor(prod / SPLIT)
                r = (e, prod - e * SPLIT, kab)
            elif op == OP_DIV:
                denom = _combine(be, bv)
                quot = _combine(ae, av) / torch.where(denom == 0, 1.0, denom)
                e = torch.floor(quot / SPLIT)
                # division by zero: no verdict (missing context, fail closed)
                r = (e, quot - e * SPLIT, kab & (denom != 0))
            else:
                raise CaveatError(f"caveat {meta.name!r}: unknown opcode {op}")
        regs[dst] = r
    ok_t, ok = truth(regs[meta.out_reg])
    return (ok & ok_t).expand(N), (~ok).expand(N)


def eval_caveats(metas: tuple, statics: tuple, reqs: tuple,
                 n_rows: int):
    """All caveats' tri-states for one dispatch; ``reqs`` is the host
    output of :meth:`CompiledCaveats.encode_request`, uploaded here.

    Returns ``(cav_ok uint8 [n_rows], missing_total int32 [])`` on the
    tables' device: row 0 is the always-valid uncaveated row;
    missing-context instances read 0 (fail closed) and count toward the
    total only on live rows."""
    dev = statics[0]["one"].device
    req_dev = request_tensors(reqs, dev)
    parts = [statics[0]["one"]]
    missing = None
    for meta, stat, req in zip(metas, statics, req_dev):
        allow, miss = _vm_eval(meta, stat, req)
        parts.append(allow)
        m = (miss & stat["real"]).sum(dtype=torch.int32)
        missing = m if missing is None else missing + m
    return torch.cat(parts).view(torch.uint8), missing
