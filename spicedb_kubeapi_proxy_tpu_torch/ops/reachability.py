"""Slot-space reachability: the fixpoint behind checks and list filters.

Counterpart of the JAX package's ``ops/reachability.py``. Every
``(definition, relation-or-permission, object)`` triple is interned into
one flat slot index; the evaluation state is a uint8 tensor ``V[B, Mp]``
(B subjects, Mp = M real slots + one LANE-wide trash row). Direct
tuples, userset tuples and arrow terms all become ``dst <- src`` edges;
one hop is the masked-semiring product of ops/semiring.py, followed by
the permission programs (union, intersection, exclusion, nil) over
row-aligned slot ranges. Only the cyclic core iterates; each acyclic
level is applied once (see :func:`_stratify`).

The host half (:func:`compile_graph` and the encoders) is a copy of the
reference's numpy code; the device half replaces ``jit`` and
``lax.while_loop`` with eager PyTorch and a Python loop that syncs once
per iteration (see :func:`_run`). Tiering and incremental updates come
with later slices: a write recompiles.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from . import bitprop, semiring
from .. import native
from ..device import resolve_device
from ..models.schema import (
    Arrow,
    Exclude,
    Expr,
    Intersect,
    Nil,
    RelationRef,
    Schema,
    Union,
)

SELF_REL = "__self"
VOID_IDX = 0  # reserved per-type object index for unknown ids
WILDCARD_IDX = 1  # reserved per-type object index for '*'

DEFAULT_MAX_ITERS = 128
# capacity of the (empty, in this slice) fixed-size delta overlay the
# hop still runs, exactly as the reference does
DELTA_CAPACITY = 4096

# every slot range is padded to a multiple of LANE (row-aligned ranges)
LANE = 128

# dense-block eligibility, the reference's values (measured on a TPU; a
# later change re-measures them on the card before changing them)
DENSE_MIN_EDGES = 1024
DENSE_MIN_CELLS = 1 << 24
DENSE_MIN_DENSITY = 5e-4
DENSE_MAX_CELLS = 3 << 30

# self-pair closures larger than this stay plain iterated-core blocks
CLOSURE_MAX_PAIRS = 1 << 24


class ConvergenceError(RuntimeError):
    """The fixpoint hit its iteration budget before converging. Raised
    instead of silently denying."""


def _next_bucket(n: int, minimum: int = 8) -> int:
    """Pad sizes to power-of-two buckets (the reference's shapes)."""
    b = minimum
    while b < n:
        b *= 2
    return b


@dataclass
class _BlockMeta:
    """One dense relation block between a (src range, dst range) pair:
    ``A[n_dst, n_src]`` int8 on the device (plus its bit-packed dual when
    :func:`bitprop.eligible`). ``closured`` blocks hold the
    reflexive-transitive closure of a self-pair, so one application
    yields every multi-hop value."""

    dst_off: int
    n_dst: int
    src_off: int
    n_src: int
    dst_local: Optional[np.ndarray]
    src_local: Optional[np.ndarray]
    level: int = 0
    closured: bool = False

    def slim(self) -> "_BlockMeta":
        return _BlockMeta(self.dst_off, self.n_dst, self.src_off,
                          self.n_src, None, None, self.level, self.closured)


@dataclass
class _PermProgram:
    """One permission's elementwise recompute: (dst_offset, size, expr),
    with expression leaves resolved to slot offsets."""

    dst_off: int
    size: int
    expr: Expr
    leaf_off: dict  # RelationRef / Arrow leaf -> slot offset
    level: int = 0


def _range_id(offs: np.ndarray, slot) -> int:
    """Range id owning a slot: offs is ascending range offsets."""
    return int(np.searchsorted(offs, slot, side="right")) - 1


def _closure_pairs(dst_local: np.ndarray, src_local: np.ndarray,
                   n: int) -> Optional[tuple[np.ndarray, np.ndarray]]:
    """Reflexive-transitive closure of an n-node COO self-block. Returns
    (dst_local, src_local) int32 INCLUDING the diagonal, or None when it
    exceeds CLOSURE_MAX_PAIRS. Handles instance cycles."""
    base_order = np.argsort(src_local, kind="stable")
    b_src = src_local[base_order].astype(np.int64)
    b_dst = dst_local[base_order].astype(np.int64)
    cur = np.unique(src_local.astype(np.int64) * n + dst_local)
    while True:
        cs, cd = cur // n, cur % n
        # compose: (s -> d) with (d -> d2) gives (s -> d2)
        lo = np.searchsorted(b_src, cd, side="left")
        hi = np.searchsorted(b_src, cd, side="right")
        counts = hi - lo
        total = int(counts.sum())
        if total:
            starts = np.repeat(lo, counts)
            offsets = np.arange(total) - np.repeat(
                np.cumsum(counts) - counts, counts)
            new_pairs = (np.repeat(cs, counts) * n
                         + b_dst[starts + offsets])
            merged = np.unique(np.concatenate([cur, new_pairs]))
        else:
            merged = cur
        if len(merged) > CLOSURE_MAX_PAIRS:
            return None
        if len(merged) == len(cur):
            break
        cur = merged
    diag = np.arange(n, dtype=np.int64)
    cur = np.unique(np.concatenate([cur, diag * n + diag]))
    return (cur % n).astype(np.int32), (cur // n).astype(np.int32)


def _stratify(offs: np.ndarray, src_rid: np.ndarray, dst_rid: np.ndarray,
              programs: list, ignore_self: frozenset = frozenset(),
              ) -> tuple[dict, int]:
    """Range-level stratification: peel ranges nothing still depends on;
    what cannot be peeled (cycles and their ancestors) is the core, level
    0. Peeled ranges get levels 1..L in reverse peel order. Returns
    ({range_id: level}, n_levels). ``ignore_self``: ranges whose self
    edges a closured block satisfies."""
    n_ranges = len(offs)
    consumers: list[set] = [set() for _ in range(n_ranges)]
    if len(src_rid):
        pairs = np.unique(src_rid.astype(np.int64) * n_ranges + dst_rid)
        for p in pairs.tolist():
            s, d = divmod(p, n_ranges)
            if s == d and s in ignore_self:
                continue
            consumers[s].add(d)
    for p in programs:
        p_rid = _range_id(offs, p.dst_off)
        for off in set(p.leaf_off.values()):
            consumers[_range_id(offs, off)].add(p_rid)
    remaining = set(range(n_ranges))
    peel: list[list[int]] = []
    while True:
        removable = [r for r in remaining if not (consumers[r] & remaining)]
        if not removable:
            break
        peel.append(removable)
        remaining -= set(removable)
    n_levels = len(peel)
    level = {r: 0 for r in remaining}
    for i, grp in enumerate(peel):  # peeled first -> evaluated last
        for r in grp:
            level[r] = n_levels - i
    return level, n_levels


@dataclass(frozen=True)
class RunMeta:
    """What the fixpoint reads from the graph besides device tensors."""

    M: int
    programs: tuple
    blocks: tuple
    res_level_bounds: tuple  # len n_levels+2: slice bounds into residual
    n_levels: int
    level_ranges: tuple  # per level 1..L: ((offset, size), ...) merged
    spmm_mode: str = "auto"


@dataclass
class CompiledGraph:
    """A compilation of (schema, snapshot): host arrays plus, built on
    first query, the device tensors on ``device``."""

    schema: Optional[Schema]
    revision: int
    base_time: float
    M: int  # real slots (M is also the trash slot index)
    slot_offset: dict  # (type_name, rel_name) -> offset
    type_sizes: dict  # type_name -> padded object count
    programs: list  # topo-ordered _PermProgram list
    blocks: list = field(default_factory=list)
    # host residual views, ordered by (level, dst), trash-padded per level
    res_src: Optional[np.ndarray] = None
    res_dst: Optional[np.ndarray] = None
    res_exp: Optional[np.ndarray] = None  # float32 rel to base_time
    res_level_bounds: Optional[tuple] = None
    n_levels: int = 0
    range_levels: Optional[np.ndarray] = None
    range_offs: Optional[np.ndarray] = None
    # the full dst-sorted edge set (padded) and the residual's indices
    src: Optional[np.ndarray] = None
    dst: Optional[np.ndarray] = None
    exp_rel: Optional[np.ndarray] = None
    n_edges: int = 0
    res_idx: Optional[np.ndarray] = None
    # fixed-capacity delta overlay (trash-padded; empty in this slice) and
    # the ledger of base (src, dst) pairs it killed
    delta_src: Optional[np.ndarray] = None
    delta_dst: Optional[np.ndarray] = None
    delta_exp: Optional[np.ndarray] = None
    n_delta: int = 0
    dead_pairs: Optional[np.ndarray] = None
    # push while the per-hop occupancy is <= this (engine EWMA feedback)
    spmm_crossover: float = 1.0
    device: torch.device = field(
        default_factory=lambda: resolve_device(None))
    _device: dict = field(default_factory=dict)

    # -- host-side encoding ------------------------------------------------

    def offset_of(self, type_name: str, rel_name: str) -> Optional[int]:
        return self.slot_offset.get((type_name, rel_name))

    def encode_subject(self, type_name: str, obj_id: str,
                       subject_relation: Optional[str] = None,
                       objects=None) -> tuple[int, int]:
        """-> (subject_seed_slot, wildcard_seed_slot); the trash slot when
        unknown, so unknown subjects seed nothing."""
        trash = self.M
        if subject_relation:
            off = self.offset_of(type_name, subject_relation)
            # userset subjects never match a `type:*` tuple
            wc_off = None
        else:
            off = self.offset_of(type_name, SELF_REL)
            wc_off = off
        if off is None:
            return trash, trash
        idx = self._obj_index(type_name, obj_id, objects)
        seed = off + idx if idx is not None else trash
        wc = wc_off + WILDCARD_IDX if wc_off is not None else trash
        return seed, wc

    def encode_target(self, type_name: str, permission: str, obj_id: str,
                      objects=None) -> int:
        """Slot to read a check from; the trash slot (always 0) when the
        type/permission is unknown."""
        off = self.offset_of(type_name, permission)
        if off is None:
            return self.M
        idx = self._obj_index(type_name, obj_id, objects)
        return off + idx if idx is not None else off + VOID_IDX

    def _obj_index(self, type_name: str, obj_id: str, objects
                   ) -> Optional[int]:
        if objects is None:
            return None
        it = objects.get(type_name)
        if it is None:
            return None
        i = it.lookup(obj_id)
        # ids interned after this snapshot compiled have no edges: void
        if i is None or i >= self.type_sizes.get(type_name, 0):
            return VOID_IDX
        return i

    def run_meta(self) -> RunMeta:
        bounds = self.res_level_bounds
        if bounds is None:
            bounds = (0, len(self.res_src))  # unstratified: all core
        level_ranges = []
        if self.n_levels and self.range_levels is not None:
            offs = self.range_offs
            ends = np.append(offs[1:], self.M)
            for k in range(1, self.n_levels + 1):
                wins = [(int(offs[r]), int(ends[r]) - int(offs[r]))
                        for r in np.flatnonzero(
                            self.range_levels == k).tolist()]
                # even phases merge exactly the closured blocks' ranges
                wins += [(b.dst_off, b.n_dst) for b in self.blocks
                         if b.closured and b.level == k]
                level_ranges.append(tuple(wins))
        return RunMeta(
            M=self.M,
            programs=tuple(self.programs),
            blocks=tuple(b.slim() for b in self.blocks),
            res_level_bounds=tuple(bounds),
            n_levels=self.n_levels,
            level_ranges=tuple(level_ranges),
            spmm_mode=semiring.resolved_mode(),
        )

    # -- device state ------------------------------------------------------

    def _dev(self) -> dict:
        if not self._device:
            self._device = self._dev_build()
        return self._device

    def _dev_build(self) -> dict:
        dev = self.device

        def up(a, dtype):
            return torch.as_tensor(np.ascontiguousarray(a)).to(
                device=dev, dtype=dtype)

        d = {"src": up(self.res_src, torch.int64),
             "dst": up(self.res_dst, torch.int64),
             "exp": up(self.res_exp, torch.float32)}
        dsrc, ddst, dexp = self._delta_host()
        d["dsrc"] = up(dsrc, torch.int64)
        d["ddst"] = up(ddst, torch.int64)
        d["dexp"] = up(dexp, torch.float32)
        blocks, bits = [], []
        for b in self.blocks:
            dl, sl = self._live_cells(b)
            dl_t, sl_t = up(dl, torch.int64), up(sl, torch.int64)
            A = torch.zeros((b.n_dst, b.n_src), dtype=torch.int8, device=dev)
            A.index_put_((dl_t, sl_t),
                         torch.ones(1, dtype=torch.int8, device=dev))
            blocks.append(A)
            # bit-packed dual for the small-batch push path
            bits.append(bitprop.pack_block(dl_t, sl_t, b.n_dst, b.n_src)
                        if bitprop.eligible(b.n_dst, b.n_src) else None)
            del dl_t, sl_t
        d["blocks"] = tuple(blocks)
        d["blocks_bits"] = tuple(bits)
        return d

    def _live_cells(self, bm: _BlockMeta) -> tuple[np.ndarray, np.ndarray]:
        """The block's local (dst, src) cells minus :meth:`_dead_cells` —
        the reference sets every cell and then clears the dead ones."""
        dl = np.asarray(bm.dst_local, dtype=np.int64)
        sl = np.asarray(bm.src_local, dtype=np.int64)
        dd, ds = self._dead_cells(bm)
        if len(dd):
            keep = ~np.isin(dl * bm.n_src + sl, dd * bm.n_src + ds)
            dl, sl = dl[keep], sl[keep]
        return dl, sl

    def _dead_cells(self, bm: _BlockMeta) -> tuple[np.ndarray, np.ndarray]:
        """Local (dst, src) coordinates of dead_pairs inside a block."""
        if self.dead_pairs is None or not len(self.dead_pairs):
            z = np.empty(0, dtype=np.int64)
            return z, z
        s, t = self.dead_pairs[:, 0], self.dead_pairs[:, 1]
        m = ((t >= bm.dst_off) & (t < bm.dst_off + bm.n_dst)
             & (s >= bm.src_off) & (s < bm.src_off + bm.n_src))
        return t[m] - bm.dst_off, s[m] - bm.src_off

    def _delta_host(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        if self.delta_src is not None:
            return self.delta_src, self.delta_dst, self.delta_exp
        return (np.full(DELTA_CAPACITY, self.M, dtype=np.int32),
                np.full(DELTA_CAPACITY, self.M, dtype=np.int32),
                np.full(DELTA_CAPACITY, -np.inf, dtype=np.float32))

    def device_bytes(self) -> int:
        """Bytes of device tensors this graph holds (after first query)."""
        n = 0
        for v in self._dev().values():
            for t in (v if isinstance(v, tuple) else (v,)):
                if isinstance(t, torch.Tensor):
                    n += t.numel() * t.element_size()
        return n

    # -- queries -----------------------------------------------------------

    def query_async(
        self,
        seed_slots: np.ndarray,  # int32 [B, 2] (subject slot, wildcard slot)
        q_slots: np.ndarray,  # int32 [Q]
        q_batch: np.ndarray,  # int32 [Q] batch row per query
        now: Optional[float] = None,
        max_iters: int = DEFAULT_MAX_ITERS,
        q_cache_key: Optional[tuple] = None,
        q_contiguous: Optional[bool] = None,
    ) -> "QueryFuture":
        """Run the fixpoint and return a future holding its device result.

        The fixpoint's loop syncs with the host once per iteration, so by
        the time this returns the device work is enqueued up to its last
        hop; only the final readback (a synchronous ``.cpu()`` in
        :meth:`QueryFuture.result`) is deferred. Overlapping readbacks on
        a side stream is left to a later change."""
        d = self._dev()
        dev = self.device
        B = seed_slots.shape[0]
        Q = len(q_slots)
        # the reference's batch bucket: padded rows seed the trash slot
        # and change the occupancy mean, so the padding is kept exactly
        B_pad = _next_bucket(B, 1)
        seeds = np.full((B_pad, 2), self.M, dtype=np.int64)
        seeds[:B] = seed_slots
        Mp_state = (self.M // LANE + 1) * LANE
        contig = q_contiguous
        if contig is None and Q >= 1024:
            contig = (int(q_slots[-1]) - int(q_slots[0]) == Q - 1
                      and not np.any(q_batch != q_batch[0])
                      and np.array_equal(
                          q_slots, q_slots[0] + np.arange(Q, dtype=np.int64)))
        contig_len = 0
        if contig and Q and int(q_slots[0]) + Q <= Mp_state:
            qs, qb, contig_len = int(q_slots[0]), int(q_batch[0]), Q
        else:
            cached = d.get(("q", q_cache_key)) if q_cache_key else None
            if cached is not None:
                qs, qb = cached
            else:
                qs = torch.as_tensor(np.asarray(q_slots, dtype=np.int64)
                                     ).to(dev)
                qb = torch.as_tensor(np.asarray(q_batch, dtype=np.int64)
                                     ).to(dev)
                if q_cache_key:
                    q_keys = [k for k in d if isinstance(k, tuple)
                              and k and k[0] == "q"]
                    if len(q_keys) >= 32:
                        d.pop(q_keys[0], None)
                    d[("q", q_cache_key)] = (qs, qb)
        now_abs = time.time() if now is None else now
        now_rel = np.float32(now_abs - self.base_time)
        out, converged, iters, n_push = _run(
            self.run_meta(), d, torch.as_tensor(seeds).to(dev), qs, qb,
            now_rel, np.float32(self.spmm_crossover), max_iters=max_iters,
            q_contig_len=contig_len)
        return QueryFuture(out, converged, iters, Q, max_iters, n_push)

    def query(self, seed_slots: np.ndarray, q_slots: np.ndarray,
              q_batch: np.ndarray, now: Optional[float] = None,
              max_iters: int = DEFAULT_MAX_ITERS) -> np.ndarray:
        """Run the fixpoint synchronously; returns bool [Q]."""
        return self.query_async(seed_slots, q_slots, q_batch, now=now,
                                max_iters=max_iters).result()

    def hop_bytes(self, batch: int = 1) -> dict:
        """Estimated device-memory traffic (bytes) per fixpoint iteration
        of the cyclic core (``total``) and once for the acyclic levels
        (``tail_once``), with the core's dense-block bytes per semiring
        mode (``modes``), counted as the reference counts them."""
        rows = self.M // LANE + 1
        Mp = rows * LANE

        def res_bytes(n):  # src+dst int32 + valid uint8 + B gathered
            return n * (4 + 4 + 1 + batch) + batch * Mp

        def bits_bytes(b):
            return b.n_dst * bitprop._k_pad(b.n_src) * 4

        def push_bytes(b):
            if batch <= bitprop.BIT_B_MAX and bitprop.eligible(
                    b.n_dst, b.n_src):
                return bits_bytes(b)
            return b.n_dst * b.n_src

        def pull_bytes(b):
            return b.n_dst * b.n_src

        def pallas_bytes(b):
            if not bitprop.dense_eligible(b.n_dst, b.n_src, batch):
                return pull_bytes(b)
            b32 = -(-batch // bitprop.SUBLANE) * bitprop.SUBLANE
            return b.n_dst * b.n_src \
                + b32 * b.n_src * (b.n_dst // bitprop.MXU_TILE)

        bounds = self.res_level_bounds
        if bounds is None:
            n_core, tail_res = len(self.res_src), 0
        else:
            n_core = bounds[1] - bounds[0]
            tail_res = bounds[-1] - bounds[1]
        delta = len(self._delta_host()[0]) * (4 + 4 + 1 + batch)
        core_res = res_bytes(n_core) + delta
        core_blk = [b for b in self.blocks if b.level == 0]
        core_blocks = sum(push_bytes(b) for b in core_blk)
        core_prog = sum(2 * p.size * batch for p in self.programs
                        if p.level == 0)
        tail = (res_bytes(tail_res) if tail_res else 0) \
            + sum(push_bytes(b) for b in self.blocks if b.level > 0) \
            + sum(2 * p.size * batch for p in self.programs if p.level > 0) \
            + self.n_levels * (delta + 2 * batch * Mp)
        return {"residual": core_res, "blocks": core_blocks,
                "programs": core_prog, "tail_once": tail,
                "total": core_res + core_blocks + core_prog,
                "modes": {
                    "push": sum(push_bytes(b) for b in core_blk),
                    "pull": sum(pull_bytes(b) for b in core_blk),
                    "pallas": sum(pallas_bytes(b) for b in core_blk),
                }}


@dataclass
class QueryFuture:
    """A dispatched query. ``result()`` validates convergence and reads
    the answer back; ``iterations()`` is how many core hops ran and
    ``push_steps()`` how many hops (acyclic levels included) took push."""

    _out: torch.Tensor
    _converged: bool
    _iters: int
    _q: int
    _max_iters: int
    _push: int = 0

    def result(self) -> np.ndarray:
        if not self._converged:
            raise ConvergenceError(
                f"reachability did not converge within {self._max_iters} "
                "iterations (graph deeper than the dispatch budget)")
        return self._out.cpu().numpy()[: self._q]

    def iterations(self) -> int:
        return int(self._iters)

    def push_steps(self) -> int:
        return int(self._push)


def _apply_program(V: torch.Tensor, programs) -> torch.Tensor:
    """Recompute permission slot ranges from their expressions, in place
    (later programs read earlier ones, as the reference's chained
    functional updates do). V is [B, Mp]; ranges are row-aligned."""

    def ev(expr: Expr, p: _PermProgram) -> torch.Tensor:
        if isinstance(expr, Nil):
            return torch.zeros((V.shape[0], p.size), dtype=V.dtype,
                               device=V.device)
        if isinstance(expr, (RelationRef, Arrow)):
            off = p.leaf_off[expr]
            return V[:, off:off + p.size]
        if isinstance(expr, Union):
            out = ev(expr.operands[0], p)
            for e in expr.operands[1:]:
                out = out | ev(e, p)
            return out
        if isinstance(expr, Intersect):
            out = ev(expr.operands[0], p)
            for e in expr.operands[1:]:
                out = out & ev(e, p)
            return out
        if isinstance(expr, Exclude):
            return ev(expr.base, p) & (ev(expr.subtract, p) ^ 1)
        raise TypeError(f"unknown expr {expr!r}")

    for p in programs:
        V[:, p.dst_off:p.dst_off + p.size] = ev(p.expr, p)
    return V


def _seed_base(meta: RunMeta, seeds: torch.Tensor) -> torch.Tensor:
    """[B, Mp] state seeded from (subject, wildcard) slot pairs, with the
    permission programs applied once. Seeds may point at the trash slot
    M; the trash row is cleared after seeding."""
    B = seeds.shape[0]
    Mp = (meta.M // LANE + 1) * LANE
    base = torch.zeros((B, Mp), dtype=torch.uint8, device=seeds.device)
    rows = torch.arange(B, device=seeds.device)
    one = torch.ones(1, dtype=torch.uint8, device=seeds.device)
    base.index_put_((rows, seeds[:, 0]), one)
    base.index_put_((rows, seeds[:, 1]), one)
    base[:, meta.M:] = 0
    return _apply_program(base, meta.programs)


def _run(meta: RunMeta, d: dict, seeds: torch.Tensor, q_slots, q_batch,
         now_rel, crossover, *, max_iters: int, q_contig_len: int = 0):
    """The stratified fixpoint: ``(out bool [Q], converged, iterations,
    push_steps)``. Only the core (level 0) iterates; each acyclic level
    is applied once after it.

    The reference's ``lax.while_loop`` and per-hop ``lax.cond`` become a
    Python loop: each iteration ends in ONE device-to-host copy carrying
    the ``changed`` flag and the new state's set count (its occupancy,
    which decides the next hop's push/pull branch in auto mode). An
    acyclic level whose branch depends on occupancy reads the count once
    before its hop."""
    B, Mp = seeds.shape[0], (meta.M // LANE + 1) * LANE
    numel = B * Mp
    mode = meta.spmm_mode
    act = semiring.edge_activation(d["exp"], now_rel)
    dact = semiring.edge_activation(d["dexp"], now_rel)
    base = _seed_base(meta, seeds)
    bounds = meta.res_level_bounds
    blocks = list(zip(meta.blocks, d["blocks"], d["blocks_bits"]))

    def needs_occ(k: int) -> bool:
        return mode == "auto" and semiring.push_differs(blocks, B, level=k)

    def push_at(count: int) -> bool:
        return semiring.frontier_occupancy(count, numel) <= crossover

    def prop_level(V, k, use_push):
        lo, hi = bounds[k], bounds[k + 1]
        return semiring.propagate(
            meta.blocks, d["blocks"], d["blocks_bits"],
            d["src"][lo:hi], d["dst"][lo:hi], act[lo:hi],
            d["dsrc"], d["ddst"], dact, V, use_push,
            level=k, mode=mode)

    core_progs = [p for p in meta.programs if p.level == 0]
    V = base
    count = int(base.sum(dtype=torch.int64)) if needs_occ(0) else 0
    changed, iters, n_push = True, 0, 0
    while changed and iters < max_iters:
        prop, is_push = prop_level(V, 0, push_at(count))
        V2 = _apply_program(prop | base, core_progs)
        flags = torch.stack([(V2 != V).any().to(torch.int64),
                             V2.sum(dtype=torch.int64)]).tolist()
        changed, count = bool(flags[0]), int(flags[1])
        V = V2
        iters += 1
        n_push += is_push
    if V is base:
        V = base.clone()  # max_iters == 0: the levels must not write base
    for k in range(1, meta.n_levels + 1):
        progs_k = [p for p in meta.programs if p.level == k]
        count = int(V.sum(dtype=torch.int64)) if needs_occ(k) else 0
        prop, is_push = prop_level(V, k, push_at(count))
        n_push += is_push
        propb = prop | base
        for off, size in meta.level_ranges[k - 1]:
            V[:, off:off + size] = propb[:, off:off + size]
        V = _apply_program(V, progs_k)
    if q_contig_len:
        out = V[q_batch, q_slots:q_slots + q_contig_len]
    else:
        out = V[q_batch, q_slots]
    return out.to(torch.bool), not changed, iters, n_push


# ---------------------------------------------------------------------------
# Compilation: (schema, snapshot) -> CompiledGraph (host numpy, a copy of
# the reference's compile_graph without caveat instances)
# ---------------------------------------------------------------------------


def _topo_permissions(defn) -> list[str]:
    """Order a definition's permissions by their intra-type RelationRef
    dependencies."""
    deps: dict[str, set] = {}
    for name, perm in defn.permissions.items():
        refs = set()

        def walk(e):
            if isinstance(e, RelationRef) and e.name in defn.permissions:
                refs.add(e.name)
            elif isinstance(e, (Union, Intersect)):
                for o in e.operands:
                    walk(o)
            elif isinstance(e, Exclude):
                walk(e.base)
                walk(e.subtract)

        walk(perm.expr)
        deps[name] = refs
    out: list[str] = []
    seen: set = set()

    def visit(n, path):
        if n in seen or n in path:
            return
        for d in sorted(deps[n]):
            visit(d, path | {n})
        seen.add(n)
        out.append(n)

    for n in sorted(deps):
        visit(n, set())
    return out


def _collect_arrows(e, out: list) -> list:
    if isinstance(e, Arrow):
        out.append(e)
    elif isinstance(e, (Union, Intersect)):
        for o in e.operands:
            _collect_arrows(o, out)
    elif isinstance(e, Exclude):
        _collect_arrows(e.base, out)
        _collect_arrows(e.subtract, out)
    return out


def compile_graph(schema: Schema, snapshot, device=None) -> CompiledGraph:
    """Compile a store snapshot into slot-space form: vectorized numpy
    over the snapshot's columns, as the reference does. ``device``: where
    the graph's tensors live (``cuda`` by default)."""
    device = resolve_device(device)
    types_in = snapshot.types
    rels_in = snapshot.relations
    cols = snapshot.cols
    if len(cols) and np.any(cols.cav != 0):
        raise ValueError("caveats are not ported yet")

    # ---- slot layout ----
    slot_offset: dict[tuple, int] = {}
    type_sizes: dict[str, int] = {}
    arrow_terms: dict[tuple, list[Arrow]] = {}
    off = 0
    for tname in sorted(schema.definitions):
        d = schema.definitions[tname]
        tid = types_in.lookup(tname)
        n = len(snapshot.objects[tid]) \
            if tid is not None and tid in snapshot.objects else 2
        n = _next_bucket(max(n, 2), LANE)
        type_sizes[tname] = n
        slot_offset[(tname, SELF_REL)] = off
        off += n
        for rname in sorted(d.relations):
            slot_offset[(tname, rname)] = off
            off += n
        for pname in sorted(d.permissions):
            arrows = _collect_arrows(d.permissions[pname].expr, [])
            arrow_terms[(tname, pname)] = arrows
            for k in range(len(arrows)):
                slot_offset[(tname, f"__arrow_{pname}_{k}")] = off
                off += n
        for pname in sorted(d.permissions):
            slot_offset[(tname, pname)] = off
            off += n
    M = off

    # ---- store-id -> offset lookup tables ----
    n_st = len(types_in)
    n_sr = len(rels_in)
    self_off = np.full(n_st + 1, -1, dtype=np.int64)
    rel_off = np.full((n_st + 1, n_sr + 1), -1, dtype=np.int64)
    relperm_off = np.full((n_st + 1, n_sr + 1), -1, dtype=np.int64)
    for tname, d in schema.definitions.items():
        tid = types_in.lookup(tname)
        if tid is None:
            continue
        self_off[tid] = slot_offset[(tname, SELF_REL)]
        for rname in d.relations:
            rid = rels_in.lookup(rname)
            if rid is not None:
                rel_off[tid, rid] = slot_offset[(tname, rname)]
                relperm_off[tid, rid] = slot_offset[(tname, rname)]
        for pname in d.permissions:
            rid = rels_in.lookup(pname)
            if rid is not None:
                relperm_off[tid, rid] = slot_offset[(tname, pname)]

    # ---- edges ----
    srcs: list[np.ndarray] = []
    dsts: list[np.ndarray] = []
    exps: list[np.ndarray] = []
    base_time = time.time()
    exp_rel_all = (cols.exp - base_time).astype(np.float32)
    rt = cols.rt.astype(np.int64)
    st = cols.st.astype(np.int64)
    rl = cols.rl.astype(np.int64)
    srl = cols.srl.astype(np.int64)
    dst_all = rel_off[rt, rl] + cols.rid
    dst_valid = rel_off[rt, rl] >= 0

    # direct tuples (includes wildcard subjects: wildcard object index 1)
    m = (srl == 0) & dst_valid & (self_off[st] >= 0)
    srcs.append(self_off[st[m]] + cols.sid[m])
    dsts.append(dst_all[m])
    exps.append(exp_rel_all[m])

    # userset tuples: src is the subject's (type, relation|permission) slot
    us_off = relperm_off[st, srl]
    m = (srl != 0) & dst_valid & (us_off >= 0) & (cols.sid != WILDCARD_IDX)
    srcs.append(us_off[m] + cols.sid[m])
    dsts.append(dst_all[m])
    exps.append(exp_rel_all[m])

    # arrow term edges
    for (tname, pname), arrows in arrow_terms.items():
        if not arrows:
            continue
        tid = types_in.lookup(tname)
        if tid is None:
            continue
        for k, a in enumerate(arrows):
            ts_id = rels_in.lookup(a.tupleset)
            if ts_id is None:
                continue
            term_off = slot_offset[(tname, f"__arrow_{pname}_{k}")]
            tgt_off = np.full(n_st + 1, -1, dtype=np.int64)
            d = schema.definitions[tname]
            for asub in d.relations[a.tupleset].allowed:
                if asub.relation:
                    continue  # arrows walk concrete subjects only
                sub_tid = types_in.lookup(asub.type)
                if sub_tid is None:
                    continue
                if schema.definitions[asub.type].relation_or_permission(
                        a.target):
                    tgt_off[sub_tid] = slot_offset[(asub.type, a.target)]
            m = ((rt == tid) & (rl == ts_id) & (srl == 0)
                 & (tgt_off[st] >= 0) & (cols.sid != WILDCARD_IDX))
            srcs.append(tgt_off[st[m]] + cols.sid[m])
            dsts.append(term_off + cols.rid[m])
            exps.append(exp_rel_all[m])

    src = np.concatenate(srcs)
    dst = np.concatenate(dsts)
    exp = np.concatenate(exps)
    order = native.sort_perm(dst)
    if order is None:
        order = np.argsort(dst, kind="stable")
    src, dst, exp = src[order], dst[order], exp[order]

    n_edges = len(src)
    E_pad = _next_bucket(max(n_edges, 1))
    src_p = np.full(E_pad, M, dtype=np.int32)
    dst_p = np.full(E_pad, M, dtype=np.int32)
    exp_p = np.full(E_pad, -np.inf, dtype=np.float32)
    src_p[:n_edges] = src
    dst_p[:n_edges] = dst
    exp_p[:n_edges] = exp

    # ---- elementwise programs ----
    programs: list[_PermProgram] = []
    for tname in sorted(schema.definitions):
        d = schema.definitions[tname]
        n = type_sizes[tname]
        for pname in _topo_permissions(d):
            leaf_off: dict = {}
            arrow_seen = 0

            def resolve(e, tname=tname, pname=pname):
                nonlocal arrow_seen
                if isinstance(e, RelationRef):
                    leaf_off[e] = slot_offset[(tname, e.name)]
                elif isinstance(e, Arrow):
                    # nth arrow occurrence maps to its own term range
                    leaf_off[e] = slot_offset[
                        (tname, f"__arrow_{pname}_{arrow_seen}")]
                    arrow_seen += 1
                elif isinstance(e, (Union, Intersect)):
                    for o in e.operands:
                        resolve(o)
                elif isinstance(e, Exclude):
                    resolve(e.base)
                    resolve(e.subtract)

            expr = d.permissions[pname].expr
            resolve(expr)
            programs.append(
                _PermProgram(slot_offset[(tname, pname)], n, expr, leaf_off))

    # ---- stratification + dense/residual split ----
    range_items = sorted(slot_offset.items(), key=lambda kv: kv[1])
    offs = np.asarray([o for _, o in range_items], dtype=np.int64)
    sizes = np.asarray([type_sizes[t] for (t, _), _ in range_items],
                       dtype=np.int64)
    if n_edges:
        dst_rid = np.searchsorted(offs, dst, side="right") - 1
        src_rid = np.searchsorted(offs, src, side="right") - 1
    else:
        dst_rid = src_rid = np.empty(0, dtype=np.int64)

    # dense-pair decisions come BEFORE stratification: a dense never-
    # expiring self-pair is replaced by its closure, so _stratify may
    # peel the range instead of iterating it with the core
    dense_sel: dict[int, np.ndarray] = {}
    res_parts: list[np.ndarray] = []
    closure_rids: set[int] = set()
    closure_coo: dict[int, tuple] = {}
    if n_edges:
        special = exp != np.inf
        key = dst_rid * len(offs) + src_rid
        key = np.where(~special, key, -1)
        uniq, inv, counts = np.unique(key, return_inverse=True,
                                      return_counts=True)
        expiring_pairs = (set(np.unique(
            dst_rid[special] * len(offs) + src_rid[special]).tolist())
            if special.any() else set())
        for ui, (k, cnt) in enumerate(zip(uniq.tolist(), counts.tolist())):
            sel = np.flatnonzero(inv == ui)
            if k < 0:
                res_parts.append(sel)
                continue
            d_rid, s_rid = divmod(k, len(offs))
            n_dst, n_src = int(sizes[d_rid]), int(sizes[s_rid])
            cells = n_dst * n_src
            if (cnt < DENSE_MIN_EDGES or cells > DENSE_MAX_CELLS
                    or (cells > DENSE_MIN_CELLS
                        and cnt / cells < DENSE_MIN_DENSITY)):
                res_parts.append(sel)
                continue
            dense_sel[k] = sel
            if d_rid == s_rid and k not in expiring_pairs:
                coo = _closure_pairs(
                    (dst[sel] - offs[d_rid]).astype(np.int32),
                    (src[sel] - offs[s_rid]).astype(np.int32), n_dst)
                if coo is not None:
                    closure_rids.add(d_rid)
                    closure_coo[d_rid] = coo

    level_map, n_levels = _stratify(offs, src_rid, dst_rid, programs,
                                    ignore_self=frozenset(closure_rids))
    if closure_rids:
        # levels are doubled: odd phase 2k-1 applies a closured range's
        # in-edges and merges; even phase 2k applies its closure block
        range_levels = np.asarray(
            [0 if level_map[r] == 0 else 2 * level_map[r] - 1
             for r in range(len(offs))], dtype=np.int32)
        n_levels *= 2
    else:
        range_levels = np.asarray(
            [level_map[r] for r in range(len(offs))], dtype=np.int32)
    for p in programs:
        p.level = int(range_levels[_range_id(offs, p.dst_off)])

    blocks: list[_BlockMeta] = []
    if n_edges:
        edge_level = range_levels[dst_rid]
        for k, sel in dense_sel.items():
            d_rid, s_rid = divmod(k, len(offs))
            lvl = int(range_levels[d_rid])
            if d_rid == s_rid and d_rid in closure_rids:
                dl, sl = closure_coo[d_rid]
                blocks.append(_BlockMeta(
                    dst_off=int(offs[d_rid]), n_dst=int(sizes[d_rid]),
                    src_off=int(offs[s_rid]), n_src=int(sizes[s_rid]),
                    dst_local=dl, src_local=sl,
                    level=lvl + 1 if lvl else 0, closured=True))
            else:
                blocks.append(_BlockMeta(
                    dst_off=int(offs[d_rid]), n_dst=int(sizes[d_rid]),
                    src_off=int(offs[s_rid]), n_src=int(sizes[s_rid]),
                    dst_local=(dst[sel] - offs[d_rid]).astype(np.int32),
                    src_local=(src[sel] - offs[s_rid]).astype(np.int32),
                    level=lvl))
    res_idx = (np.sort(np.concatenate(res_parts)) if res_parts
               else np.empty(0, dtype=np.int64))

    # padded residual views ordered by (level, dst), one power-of-two
    # bucket per level
    n_res = len(res_idx)
    if n_res:
        res_lvl = edge_level[res_idx]
        order = np.lexsort((dst[res_idx], res_lvl))
        res_idx = res_idx[order]
        counts_per_level = np.bincount(res_lvl[order],
                                       minlength=n_levels + 1)
    else:
        counts_per_level = np.zeros(n_levels + 1, dtype=np.int64)
    pads = [_next_bucket(max(int(c), 1)) for c in counts_per_level]
    res_level_bounds = tuple(int(x) for x in np.concatenate(
        [[0], np.cumsum(pads)]))
    res_src = np.full(res_level_bounds[-1], M, dtype=np.int32)
    res_dst = np.full(res_level_bounds[-1], M, dtype=np.int32)
    res_exp = np.full(res_level_bounds[-1], -np.inf, dtype=np.float32)
    pos = 0
    for k in range(n_levels + 1):
        n_k = int(counts_per_level[k])
        lo = res_level_bounds[k]
        sel = res_idx[pos:pos + n_k]
        res_src[lo:lo + n_k] = src_p[sel]
        res_dst[lo:lo + n_k] = dst_p[sel]
        res_exp[lo:lo + n_k] = exp_p[sel]
        pos += n_k

    return CompiledGraph(
        schema=schema,
        revision=snapshot.revision,
        base_time=base_time,
        M=M,
        slot_offset=slot_offset,
        type_sizes=type_sizes,
        programs=programs,
        blocks=blocks,
        res_src=res_src,
        res_dst=res_dst,
        res_exp=res_exp,
        res_level_bounds=res_level_bounds,
        n_levels=n_levels,
        range_levels=range_levels,
        range_offs=offs,
        src=src_p,
        dst=dst_p,
        exp_rel=exp_p,
        n_edges=n_edges,
        res_idx=res_idx,
        delta_src=np.full(DELTA_CAPACITY, M, dtype=np.int32),
        delta_dst=np.full(DELTA_CAPACITY, M, dtype=np.int32),
        delta_exp=np.full(DELTA_CAPACITY, -np.inf, dtype=np.float32),
        device=device,
    )
