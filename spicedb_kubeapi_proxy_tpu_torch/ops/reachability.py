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

The host half (:func:`compile_graph`, the encoders and the planning half
of :func:`incremental_update`) is a copy of the reference's numpy code;
the device half replaces ``jit`` and ``lax.while_loop`` with eager
PyTorch and a Python loop that syncs once per iteration (see
:func:`_run`).

Writes are folded in O(write) by :func:`incremental_update`: new edges
take slots of a fixed-capacity delta overlay, killed base edges are
cleared where they live (residual expiration, dense-block cell, bit-dual
word) and a closured block that loses a base edge is re-closed. The
reference publishes every revision as new immutable device arrays; the
port patches ONE device state per compiled base in place instead (cloning
a multi-GiB block per write is not O(write)), shared by every incremental
descendant and guarded by a reader/writer lock (:class:`_Resident`): a
query holds the shared side while its fixpoint enqueues, a patch the
exclusive side, so a query sees one revision's state whole — the newest,
which the fully-consistent read contract allows ("at least as fresh").

Conditional grants (caveats/) ride the residual: every edge carries the
row of its (caveat, context) instance (0 = unconditional), and each
dispatch evaluates the caveat VM once and gates the edges with its
verdicts (:func:`_run`).

Tiered block residency (storage/, :meth:`CompiledGraph.enable_tiering`)
keeps the dense blocks of a graph larger than its device budget in a
host-cold arena: a dispatch demand-sets the blocks its seeds and queried
ranges can reach (:meth:`CompiledGraph._demand_blocks`), streams the cold
ones in on prefetch workers, each building its block on a CUDA stream of
its own from a pinned staging buffer (:func:`_materialize_block`), and
runs the fixpoint over that active subset only; streamed blocks stay hot
while the budget allows. A block is built against the device state's own
watermarks (its block metadata and dead-ledger rows), so a query never
mixes a block newer than the overlay it runs with.
"""

from __future__ import annotations

import threading
import time
import weakref
from collections import deque
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field, replace
from functools import partial
from typing import Optional

import numpy as np
import torch

from . import bitprop, semiring
from .. import native
from ..caveats.vm import build_caveat_table, eval_caveats
from ..device import resolve_device
from ..utils.metrics import metrics
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
# the fixed-capacity delta overlay: writes append edges into it instead of
# recompiling; a full overlay is a counted fallback (or, with a compactor,
# write back-pressure: engine/compaction.py), never a growth event
DELTA_CAPACITY = 4096
MAX_DELTA_RECORDS = 8192

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


def _fallback(reason: str) -> None:
    """Count one declined incremental update (the caller recompiles or
    leaves it to the compactor). Reasons, as the reference names them:
    ``overflow`` (overlay/dead-ledger capacity or the per-batch record
    cap), ``stratification-inversion`` (a first-ever dependency
    direction), ``closured-expiry`` (an expiration attached to a closured
    block pair), ``closured-caveat`` (a conditional grant attached to a
    closured block pair), ``caveat`` (a caveat/context pair the frozen
    instance tables cannot express: first-ever caveat, full row bucket,
    or an unencodable context), ``history-trimmed`` /
    ``unlogged`` (store side, engine.py), ``layout`` (a tuple the frozen
    slot layout cannot express) and ``unstratified`` (a hand-built graph
    without overlay state)."""
    metrics.counter("engine_graph_incremental_fallback_total",
                    reason=reason).inc()


class StateReleased(RuntimeError):
    """A dispatch reached a graph whose device state a store restore
    freed (:func:`release_resident`): the query belongs to the replaced
    lineage, and the caller reads ``compiled()`` again."""


class _RWLock:
    """Reader/writer lock with a bounded writer wait. While a writer
    waits, a new reader still enters as long as a reader that entered
    before any writer waited is inside (a query that overlaps a write not
    yet acknowledged may read the state before it); once those have all
    left, new readers queue behind the writer. So the list filters that
    arrive while a write waits out a long bulk check run beside that
    check, and the write waits at most for the readers it found plus the
    ones that entered beside them. The shared side is re-entrant per
    thread (a bulk check holds it across its chunks, each of which takes
    it again); a thread holding it must not ask for the exclusive side."""

    def __init__(self):
        self._cond = threading.Condition(threading.Lock())
        self._readers = 0
        self._early = 0  # readers inside that entered with no writer waiting
        self._writer = False
        self._waiting = 0
        self._held = threading.local()

    @contextmanager
    def shared(self):
        depth = getattr(self._held, "depth", 0)
        early = False
        if not depth:
            with self._cond:
                while self._writer or (self._waiting and not self._early):
                    self._cond.wait()
                self._readers += 1
                early = not self._waiting
                self._early += early
        self._held.depth = depth + 1
        try:
            yield
        finally:
            self._held.depth = depth
            if not depth:
                with self._cond:
                    self._readers -= 1
                    self._early -= early
                    if not self._readers:
                        self._cond.notify_all()

    @contextmanager
    def exclusive(self):
        with self._cond:
            self._waiting += 1
            while self._writer or self._readers:
                self._cond.wait()
            self._waiting -= 1
            self._writer = True
        try:
            yield
        finally:
            with self._cond:
                self._writer = False
                self._cond.notify_all()


class _Resident:
    """The device state of one compiled base, shared by every incremental
    descendant of it: ``tensors`` (built on the first query, then patched
    in place), ``blocks`` (the newest host block metadata, which a
    re-close replaces), ``lock``, and the device patches of host commits
    not yet applied (``pending``, in commit order; ``applied`` is the
    number of the last one applied). Queries run under ``lock.shared()``;
    builds and patches under ``lock.exclusive()``. Queries and patches
    enqueue on the device's current stream, so a patch also runs after
    every hop enqueued before it.

    ``tier`` is the base's TierStore (storage/tiers.py) when its blocks are
    tiered (:meth:`CompiledGraph.enable_tiering`), shared like the tensors;
    ``tier_coo`` maps each block index to the block metadata whose COO the
    cold arena holds. ``released``: a restore freed this state
    (:func:`release_resident`)."""

    __slots__ = ("tensors", "blocks", "lock", "pending", "committed",
                 "applied", "_plock", "tier", "tier_coo", "released",
                 "__weakref__")

    def __init__(self, blocks: list):
        self.tensors: dict = {}
        self.blocks = blocks
        self.lock = _RWLock()
        self.pending: list = []
        self.committed = 0
        self.applied = 0
        self._plock = threading.Lock()
        self.tier = None
        self.tier_coo: dict = {}
        self.released = False

    def queue(self, patch) -> int:
        """Queue one commit's device patch (a callable on the tensors);
        returns its commit number. Called under the graph's host_lock, so
        commit order is queue order."""
        with self._plock:
            self.committed += 1
            self.pending.append((self.committed, patch))
            return self.committed

    def flush(self, upto: int) -> None:
        """Apply every queued patch, in commit order, unless commit
        ``upto`` is on the device already. Patches reapplied on tensors
        built after their commit are harmless: the whole queue runs in
        order under one exclusive hold, so it ends at the newest commit
        and no query sees the states between. Without tensors the queue is
        dropped: the first query builds from the newest host state."""
        if self.applied >= upto:
            return
        with self.lock.exclusive():
            with self._plock:
                batch, self.pending = self.pending, []
            for seq, patch in batch:
                if self.tensors:
                    t0 = time.perf_counter()
                    patch(self.tensors)
                    # host time to enqueue the patch (its copies to the
                    # device are synchronous)
                    metrics.histogram("engine_overlay_patch_seconds"
                                      ).observe(time.perf_counter() - t0)
                self.applied = seq


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
    # a closured block's BASE edges: an incremental delete re-closes the
    # block from them (:meth:`reclosed`), since closure cells are derived
    # and cannot be cleared one by one
    base_dst_local: Optional[np.ndarray] = None
    base_src_local: Optional[np.ndarray] = None

    def slim(self) -> "_BlockMeta":
        return _BlockMeta(self.dst_off, self.n_dst, self.src_off,
                          self.n_src, None, None, self.level, self.closured)

    def reclosed(self, remove: set) -> Optional["_BlockMeta"]:
        """A new closured block with ``remove`` (local (dst, src) pairs)
        deleted from the base edges and the closure recomputed, O(block);
        None when the closure overflows (the caller recompiles)."""
        keep = np.fromiter(
            ((int(d), int(s)) not in remove
             for d, s in zip(self.base_dst_local.tolist(),
                             self.base_src_local.tolist())),
            dtype=bool, count=len(self.base_dst_local))
        nb_dst = self.base_dst_local[keep]
        nb_src = self.base_src_local[keep]
        coo = _closure_pairs(nb_dst, nb_src, self.n_dst)
        if coo is None:
            return None
        dl, sl = coo
        return _BlockMeta(self.dst_off, self.n_dst, self.src_off,
                          self.n_src, dl, sl, self.level, True,
                          nb_dst, nb_src)


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
    # caveat VM shapes (caveats/vm.py CavMeta per caveat) and the
    # validity-row count (1 = no caveats: the VM is skipped)
    caveats: tuple = ()
    cav_rows: int = 1
    spmm_mode: str = "auto"


@dataclass
class CompiledGraph:
    """A compilation of (schema, snapshot): host arrays plus, built on
    first query, the device tensors on ``device`` (held by ``resident``,
    which every incremental descendant shares)."""

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
    # per-residual-edge caveat instance row (0 = unconditional), read
    # through the dispatch's cav_ok vector (caveats/vm.py)
    res_cav: Optional[np.ndarray] = None
    res_level_bounds: Optional[tuple] = None
    n_levels: int = 0
    range_levels: Optional[np.ndarray] = None
    range_offs: Optional[np.ndarray] = None
    # range-granularity adjacency ((src range, dst range) pairs of the full
    # edge set plus each program's leaf -> permission pairs), retained for
    # the tiered dispatch's demand closure; None on hand-built graphs
    range_adj: Optional[tuple] = None
    # the full dst-sorted edge set (padded) and the residual's indices
    src: Optional[np.ndarray] = None
    dst: Optional[np.ndarray] = None
    exp_rel: Optional[np.ndarray] = None
    n_edges: int = 0
    res_idx: Optional[np.ndarray] = None
    # fixed-capacity delta overlay (trash-padded, append order) and the
    # ledger of base (src, dst) pairs killed since the compile. The host
    # arrays are SHARED by every incremental descendant of one compiled
    # base and mutated in place under ``host_lock``; per-revision views
    # differ in their watermarks (n_delta / n_dead) only
    delta_src: Optional[np.ndarray] = None
    delta_dst: Optional[np.ndarray] = None
    delta_exp: Optional[np.ndarray] = None
    delta_cav: Optional[np.ndarray] = None  # caveat row per slot (0=none)
    n_delta: int = 0
    dead_pairs: Optional[np.ndarray] = None  # int64 [n_dead, 2] view
    n_dead: int = 0
    delta_cap: int = 0  # static overlay capacity (0 = hand-built)
    # shared writer state, read and written only under the engine's lock
    # (plan) and host_lock (commit)
    delta_pos: Optional[dict] = None  # (src, dst) -> overlay slot
    dead_set: Optional[set] = None  # (src, dst) pairs killed in the base
    dead_buf: Optional[np.ndarray] = None  # int64 [cap, 2] append buffer
    host_lock: Optional[object] = None
    block_codes: Optional[dict] = None  # block idx -> (id(meta), codes)
    # compile-time lookup tables the incremental path reads
    block_index: dict = field(default_factory=dict)  # (dst_off, src_off)->i
    self_off: Optional[np.ndarray] = None  # [n_types+1]
    rel_off: Optional[np.ndarray] = None  # [n_types+1, n_rels+1]
    relperm_off: Optional[np.ndarray] = None
    # (resource tid, tupleset rel id, term slot offset, tgt_off[n_types+1])
    arrow_maps: list = field(default_factory=list)
    # compiled caveat table (caveats/vm.py CompiledCaveats): instance
    # tables shared by every incremental descendant, like the overlay
    caveats: Optional[object] = None
    # push while the per-hop occupancy is <= this (engine EWMA feedback)
    spmm_crossover: float = 1.0
    device: torch.device = field(
        default_factory=lambda: resolve_device(None))
    resident: Optional[_Resident] = None
    # the resident commit this view's device patch is queued as (0: none)
    patch_seq: int = 0

    def __post_init__(self):
        if self.resident is None:
            self.resident = _Resident(self.blocks)

    @property
    def tier(self):
        """The TierStore of this graph's base, or None (all resident)."""
        return self.resident.tier

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

    def run_meta(self, active: Optional[tuple] = None) -> RunMeta:
        """What the fixpoint reads besides device tensors. ``active``
        (tiered dispatch) keeps only those block indices, in that order,
        matching the block tensors the dispatch passes; the per-level merge
        windows stay unfiltered: an excluded closured block's range merges
        plain propagation values, which is safe because the demand closure
        guarantees an excluded range cannot reach a queried slot."""
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
        cav = self.caveats
        kept = (self.blocks if active is None
                else [self.blocks[i] for i in active])
        return RunMeta(
            M=self.M,
            programs=tuple(self.programs),
            blocks=tuple(b.slim() for b in kept),
            res_level_bounds=tuple(bounds),
            n_levels=self.n_levels,
            level_ranges=tuple(level_ranges),
            caveats=cav.metas if cav is not None else (),
            cav_rows=cav.n_rows if cav is not None else 1,
            spmm_mode=semiring.resolved_mode(),
        )

    # -- device state ------------------------------------------------------

    def _dev(self) -> dict:
        """The shared device tensors, built on first use from the newest
        host state (under the exclusive side of the resident lock)."""
        res = self.resident
        if not res.tensors:
            with res.lock.exclusive():
                if res.released:
                    raise StateReleased(
                        "this graph's device state was released by a store "
                        "restore; read the engine's compiled() again")
                if not res.tensors:
                    d = self._dev_build()
                    if res.tier is not None:
                        _tier_sync_arena(res, d["mark"]["blocks"])
                    res.tensors = d
        return res.tensors

    @contextmanager
    def shared_state(self):
        """The shared side of the resident lock, yielding the device state
        that holds under it. :meth:`_dev` builds the state before the
        shared side is taken, so a re-tiering (:meth:`enable_tiering`) or
        a restore (:func:`release_resident`) can drop it in between: the
        first builds it again, the second raises :meth:`_dev`'s restore
        error."""
        res = self.resident
        while True:
            self._dev()
            with res.lock.shared():
                if res.tensors:
                    yield res.tensors
                    return

    def _dev_build(self) -> dict:
        """A fresh device state from the newest host state: residual,
        overlay, caveat instance tables, and every block minus the dead
        ledger's cells (on a tiered graph, placeholders: blocks stream in
        on demand). Also what a patched state must equal (tests).
        ``mark`` holds the host watermarks the state reflects (block
        metadata, dead-ledger rows, overlay slots), which every patch
        advances: a tiered dispatch builds its blocks against them."""
        dev = self.device

        def up(a, dtype):
            # a copy also on the CPU: host commits write the host arrays
            # while queries run, and must not reach the device state
            return torch.as_tensor(np.ascontiguousarray(a)).to(
                device=dev, dtype=dtype, copy=True)

        with self.host_lock or nullcontext():
            res_cav = self.res_cav
            if res_cav is None or len(res_cav) != len(self.res_src):
                res_cav = np.zeros(len(self.res_src), dtype=np.int32)
            d = {"src": up(self.res_src, torch.int64),
                 "dst": up(self.res_dst, torch.int64),
                 "exp": up(self.res_exp, torch.float32),
                 "cav": up(res_cav, torch.int64)}
            dsrc, ddst, dexp, dcav = self._delta_host()
            d["dsrc"] = up(dsrc, torch.int64)
            d["ddst"] = up(ddst, torch.int64)
            d["dexp"] = up(dexp, torch.float32)
            d["dcav"] = up(dcav, torch.int64)
            # caveat VM instance tables; () when the graph holds none
            cav = self.caveats
            d["cav_static"] = (cav.device_static(dev)
                               if cav is not None and cav.metas else ())
            d["mark"] = {"seq": self.resident.committed,
                         "blocks": list(self.resident.blocks),
                         "n_dead": (len(self.dead_set)
                                    if self.dead_set is not None
                                    else self.n_dead),
                         "n_delta": (len(self.delta_pos)
                                     if self.delta_pos is not None
                                     else self.n_delta)}
            if self.tier is not None:
                # nothing is resident up front: every block starts cold,
                # so a definition no traffic reaches costs no device bytes
                blocks = bits = [None] * len(self.resident.blocks)
            else:
                blocks, bits = [], []
                for bm in self.resident.blocks:
                    A, Ab = self._block_tensors(bm)
                    blocks.append(A)
                    bits.append(Ab)
        d["blocks"] = tuple(blocks)
        d["blocks_bits"] = tuple(bits)
        return d

    def _block_tensors(self, bm: _BlockMeta):
        """(int8 block, bit-packed dual or None) of one block's live
        cells on the device."""
        dev = self.device
        dl, sl = self._live_cells(bm)
        return _build_block(bm, torch.as_tensor(dl).to(dev),
                            torch.as_tensor(sl).to(dev))

    def _live_cells(self, bm: _BlockMeta, ledger=None
                    ) -> tuple[np.ndarray, np.ndarray]:
        """The block's local (dst, src) cells minus :meth:`_dead_cells` —
        the reference sets every cell and then clears the dead ones.
        ``ledger``: the dead pairs to cut (default: the newest)."""
        dl, sl = _dst_sorted(np.asarray(bm.dst_local, dtype=np.int64),
                             np.asarray(bm.src_local, dtype=np.int64))
        return _drop_cells(dl, sl, *self._dead_cells(bm, ledger))

    def _ledger(self) -> Optional[np.ndarray]:
        """Killed base (src, dst) pairs the device state reflects: the
        shared ledger's rows up to its newest commit (one device state
        serves every descendant), else this view's ``dead_pairs``."""
        if self.dead_buf is not None and self.dead_set is not None:
            return self.dead_buf[:len(self.dead_set)]
        return self.dead_pairs

    def _dead_cells(self, bm: _BlockMeta, ledger=None
                    ) -> tuple[np.ndarray, np.ndarray]:
        """Local (dst, src) coordinates of ledger pairs inside a block."""
        dead = self._ledger() if ledger is None else ledger
        if dead is None or not len(dead):
            z = np.empty(0, dtype=np.int64)
            return z, z
        s, t = dead[:, 0], dead[:, 1]
        m = ((t >= bm.dst_off) & (t < bm.dst_off + bm.n_dst)
             & (s >= bm.src_off) & (s < bm.src_off + bm.n_src))
        return t[m] - bm.dst_off, s[m] - bm.src_off

    def _delta_host(self) -> tuple:
        """(src, dst, exp, cav) of the overlay; an empty one when the
        graph has none."""
        if self.delta_src is not None:
            cav = self.delta_cav if self.delta_cav is not None \
                else np.zeros(len(self.delta_src), dtype=np.int32)
            return self.delta_src, self.delta_dst, self.delta_exp, cav
        return (np.full(DELTA_CAPACITY, self.M, dtype=np.int32),
                np.full(DELTA_CAPACITY, self.M, dtype=np.int32),
                np.full(DELTA_CAPACITY, -np.inf, dtype=np.float32),
                np.zeros(DELTA_CAPACITY, dtype=np.int32))

    def device_bytes(self) -> int:
        """Bytes of device tensors this graph holds (after first query)."""
        n = 0
        for v in self._dev().values():
            for t in (v if isinstance(v, tuple) else (v,)):
                for x in (t.values() if isinstance(t, dict) else (t,)):
                    if isinstance(x, torch.Tensor):
                        n += x.numel() * x.element_size()
        return n

    # -- tiered storage ----------------------------------------------------

    def enable_tiering(self, budget_bytes: int,
                       spill_dir: Optional[str] = None):
        """Track this base's dense blocks in tiers under a device byte
        budget (storage/): every block's COO goes into a host-cold arena,
        nothing is uploaded until a dispatch demands it, and streamed
        blocks stay hot while the budget allows. Every view of the base
        shares the TierStore (it lives on the resident state). Each block
        registers with the bytes of the port's own tensors for it: the
        int8 block and, where :func:`bitprop.eligible`, its int32 bit dual.
        Any device state built before is dropped. Returns the TierStore."""
        from ..storage import ColdArena, TierStore

        res = self.resident
        with res.lock.exclusive():
            if res.tier is not None:
                # a budget change: retire the old store's prefetch workers
                res.tier.close()
            arena = ColdArena(spill_dir)
            tier = TierStore(budget_bytes, arena)
            blocks = res.blocks
            for i, b in enumerate(blocks):
                tier.register(i, block_nbytes(b), b.level)
            res.tier = tier
            res.tier_coo = {}
            _tier_sync_arena(res, blocks)
            res.tensors = {}
        tier.publish_gauges()
        return tier

    def _demand_blocks(self, seed_slots: np.ndarray, q_slots: np.ndarray,
                       n_delta: int) -> Optional[tuple]:
        """Block indices this dispatch can possibly exercise: a block is
        demanded iff its src range is forward-reachable from the seed
        ranges AND its dst range backward-reachable from the queried
        ranges, over the compile-retained range adjacency plus the
        overlay's first ``n_delta`` slots (the device state's watermark).
        Anything outside provably cannot reach a queried slot. None = no
        adjacency (a hand-built graph): stream everything. Cached per
        (seed ranges, query ranges, overlay watermark)."""
        offs = self.range_offs
        if offs is None or self.range_adj is None or not len(self.blocks):
            return None
        trash = self.M

        def ranges_of(slots) -> frozenset:
            x = np.asarray(slots).ravel()
            x = x[(x >= 0) & (x < trash)]
            if not len(x):
                return frozenset()
            rid = np.searchsorted(offs, x, side="right") - 1
            return frozenset(np.unique(rid).tolist())

        seed_r = ranges_of(seed_slots)
        q_r = ranges_of(q_slots)
        key = (seed_r, q_r, n_delta)
        cached = self.tier.demand_cache_get(key)
        if cached is not None:
            return cached
        n_ranges = len(offs)
        fwd: list = [set() for _ in range(n_ranges)]
        back: list = [set() for _ in range(n_ranges)]
        for a, t in self.range_adj:
            fwd[a].add(t)
            back[t].add(a)
        if n_delta and self.delta_src is not None:
            # slots below the watermark never change their pair
            ds = self.delta_src[:n_delta].astype(np.int64)
            dt = self.delta_dst[:n_delta].astype(np.int64)
            keep = (ds >= 0) & (ds < trash) & (dt >= 0) & (dt < trash)
            if np.any(keep):
                srid = np.searchsorted(offs, ds[keep], side="right") - 1
                drid = np.searchsorted(offs, dt[keep], side="right") - 1
                for a, t in zip(srid.tolist(), drid.tolist()):
                    fwd[a].add(t)
                    back[t].add(a)

        def close_over(starts, edges) -> set:
            seen = set(starts)
            frontier = list(starts)
            while frontier:
                nxt = []
                for r in frontier:
                    for t in edges[r]:
                        if t not in seen:
                            seen.add(t)
                            nxt.append(t)
                frontier = nxt
            return seen

        reach_f = close_over(seed_r, fwd)
        reach_b = close_over(q_r, back)
        active = tuple(
            i for i, b in enumerate(self.blocks)
            if _range_id(offs, b.src_off) in reach_f
            and _range_id(offs, b.dst_off) in reach_b)
        self.tier.demand_cache_put(key, active)
        return active

    def _stream_blocks(self, active: tuple, d: dict) -> tuple:
        """The dispatch's block tensors for ``active``: hot payloads from
        the tier, cold ones built by the prefetch workers in level order
        and admitted if they fit (the wall time the dispatch blocks on
        them is the miss stall, ``engine_tier_miss_stall_seconds``). The
        caller holds the shared side of the resident lock, so no patch
        runs between a block's build against ``d``'s watermarks and its
        admission. On the card the dispatch stream waits on each block's
        build event, and every block tensor is marked as used on it
        (``record_stream``): one evicted meanwhile is not reused under
        the fixpoint. A block that fails to build raises: nothing falls
        back to uploading the whole graph."""
        tier = self.tier
        hot, missing = tier.lookup(active)
        if missing:
            t0 = time.perf_counter()
            futs = tier.prefetcher.fetch(
                missing, partial(_materialize_block, self, d))
            for i in missing:
                payload = futs[i].result()
                hot[i] = payload
                tier.admit(i, payload)
            tier.observe_stall(time.perf_counter() - t0)
        payloads = [hot[i] for i in active]
        if self.device.type == "cuda":
            cur = torch.cuda.current_stream(self.device)
            for A, Ab, ready in payloads:
                if ready is not None:
                    cur.wait_event(ready)
                A.record_stream(cur)
                if Ab is not None:
                    Ab.record_stream(cur)
        return (tuple(p[0] for p in payloads),
                tuple(p[1] for p in payloads))

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
        q_contig_grid: Optional[tuple] = None,  # (lo, L, R): R rows x
        # one shared [lo, lo+L) window (the fused-batch shape)
        context: Optional[dict] = None,  # request caveat context
        cav_req: Optional[tuple] = None,  # pre-encoded request arrays
        # (CompiledCaveats.encode_request): chunked bulk callers encode
        # ONCE for the whole logical call instead of per chunk
    ) -> "QueryFuture":
        """Run the fixpoint and return a future holding its device result.

        The fixpoint's loop syncs with the host once per iteration, so by
        the time this returns the device work is enqueued up to its last
        hop; only the final readback (a synchronous ``.cpu()`` in
        :meth:`QueryFuture.result`) is deferred. Overlapping readbacks on
        a side stream is left to a later change. The fixpoint runs under
        the shared side of the resident lock, against the newest device
        state of this graph's base (at least as fresh as this view).

        Contiguous-window queries (the list-filter shape: one type's full
        permission range) are read out as one strided slice of the state
        instead of a gather through uploaded index tensors. Two forms:
        ``q_contiguous=True`` (one window of one row; None auto-detects
        windows of 1,024 slots and more) and ``q_contig_grid=(lo, L, R)``,
        the lookup batcher's promise that the query is R rows (0..R-1)
        each reading the same window ``[lo, lo + L)``, in row-major order.
        A promise whose shape does not fit the state falls back to the
        cached gather.

        ``context`` is the request's caveat context, encoded against the
        graph's caveat tables with the absolute clock (a ``now`` caveat
        parameter), while expirations compare against the clock relative
        to the graph's base time."""
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
        if contig is None and q_contig_grid is None and Q >= 1024:
            contig = (int(q_slots[-1]) - int(q_slots[0]) == Q - 1
                      and not np.any(q_batch != q_batch[0])
                      and np.array_equal(
                          q_slots, q_slots[0] + np.arange(Q, dtype=np.int64)))
        # the readout window as (first slot, first row, length, rows)
        window = None
        if q_contig_grid is not None:
            lo, L, R = (int(x) for x in q_contig_grid)
            if Q == L * R and 0 < L and 0 < R <= B_pad \
                    and lo + L <= Mp_state:
                window = (lo, 0, L, R)
        elif contig and Q and int(q_slots[0]) + Q <= Mp_state:
            window = (int(q_slots[0]), int(q_batch[0]), Q, 1)
        now_abs = time.time() if now is None else now
        now_rel = np.float32(now_abs - self.base_time)
        cav = self.caveats
        if cav is not None and cav.metas:
            if cav_req is None:
                cav_req, _ = cav.encode_request(context, now_abs)
        else:
            cav_req = ()
        with self.shared_state() as d:
            if window is not None:
                qs, qb, q_len, q_rows = window
            else:
                qs, qb = self._q_tensors(d, q_slots, q_batch, q_cache_key)
                q_len, q_rows = 0, 1
            meta, run_d = self.run_meta(), d
            if self.tier is not None:
                # tiered dispatch: demand-set the blocks, stream the cold
                # ones in, and run the fixpoint over that subset only
                active = self._demand_blocks(seed_slots, q_slots,
                                             d["mark"]["n_delta"])
                if active is None:
                    active = tuple(range(len(self.blocks)))
                blocks, bits = self._stream_blocks(active, d)
                meta = self.run_meta(active)
                run_d = dict(d, blocks=blocks, blocks_bits=bits)
            out, converged, iters, n_push = _run(
                meta, run_d, torch.as_tensor(seeds).to(dev), qs, qb,
                now_rel, np.float32(self.spmm_crossover), cav_req,
                max_iters=max_iters, q_contig_len=q_len,
                q_contig_rows=q_rows)
        return QueryFuture(out, converged, iters, Q, max_iters, n_push)

    def _q_tensors(self, d: dict, q_slots, q_batch, q_cache_key):
        """Device index tensors of a gathered readout (cached per
        ``q_cache_key`` in the device state)."""
        cached = d.get(("q", q_cache_key)) if q_cache_key else None
        if cached is not None:
            return cached
        dev = self.device
        qs = torch.as_tensor(np.asarray(q_slots, dtype=np.int64)).to(dev)
        qb = torch.as_tensor(np.asarray(q_batch, dtype=np.int64)).to(dev)
        if q_cache_key:
            q_keys = [k for k in list(d) if isinstance(k, tuple)
                      and k and k[0] == "q"]
            if len(q_keys) >= 32:
                d.pop(q_keys[0], None)
            d[("q", q_cache_key)] = (qs, qb)
        return qs, qb

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
    ``push_steps()`` how many hops (acyclic levels included) took push;
    ``caveats_missing()`` how many caveat instances resolved to missing
    context this dispatch (denied fail-closed). ``_out`` is the uint8
    answer, followed on a caveated graph by the missing count's four
    int32 bytes: ONE device-to-host copy reads both."""

    _out: torch.Tensor
    _converged: bool
    _iters: int
    _q: int
    _max_iters: int
    _push: int = 0
    _host: Optional[np.ndarray] = None

    def _read(self) -> np.ndarray:
        if self._host is None:
            self._host = self._out.cpu().numpy()
        return self._host

    def result(self) -> np.ndarray:
        if not self._converged:
            raise ConvergenceError(
                f"reachability did not converge within {self._max_iters} "
                "iterations (graph deeper than the dispatch budget)")
        return self._read()[: self._q].view(np.bool_)

    def iterations(self) -> int:
        return int(self._iters)

    def push_steps(self) -> int:
        return int(self._push)

    def caveats_missing(self) -> int:
        tail = self._read()[self._q:]
        return int(tail.view(np.int32)[0]) if len(tail) else 0


def block_nbytes(bm: _BlockMeta) -> int:
    """Device bytes of one block as the port holds it: the int8 block,
    plus its int32 bit dual (``K_pad`` words a row) where eligible."""
    n = bm.n_dst * bm.n_src
    if bitprop.eligible(bm.n_dst, bm.n_src):
        n += bm.n_dst * bitprop._k_pad(bm.n_src) * 4
    return n


def _build_block(bm: _BlockMeta, dl_t: torch.Tensor, sl_t: torch.Tensor):
    """(int8 block, bit-packed dual or None) with cells (dl, sl) set, on
    the device of the index tensors and its current stream."""
    dev = dl_t.device
    A = torch.zeros((bm.n_dst, bm.n_src), dtype=torch.int8, device=dev)
    A.index_put_((dl_t, sl_t), torch.ones(1, dtype=torch.int8, device=dev))
    # bit-packed dual for the small-batch push path
    Ab = (bitprop.pack_block(dl_t, sl_t, bm.n_dst, bm.n_src)
          if bitprop.eligible(bm.n_dst, bm.n_src) else None)
    return A, Ab


def _block_coo(bm: _BlockMeta) -> dict:
    """A block's cold-arena payload: its COO in ascending dst order (the
    compile's order already; a closure's is re-sorted), and a closured
    block's base edges."""
    dl, sl = _dst_sorted(np.asarray(bm.dst_local, dtype=np.int32),
                         np.asarray(bm.src_local, dtype=np.int32))
    cols = {"dst_local": dl, "src_local": sl}
    if bm.closured:
        cols["base_dst_local"] = np.asarray(bm.base_dst_local,
                                            dtype=np.int32)
        cols["base_src_local"] = np.asarray(bm.base_src_local,
                                            dtype=np.int32)
    return cols


def _tier_sync_arena(res: _Resident, blocks: list) -> None:
    """Bring the cold arena up to ``blocks`` (the metadata a device state
    reflects): re-encode every block whose arena COO came from other
    metadata (a re-close). Caller holds the exclusive side."""
    for i, bm in enumerate(blocks):
        if res.tier_coo.get(i) is not bm:
            res.tier.arena.put(i, _block_coo(bm))
            res.tier_coo[i] = bm


def _dst_sorted(dl: np.ndarray, sl: np.ndarray
                ) -> tuple[np.ndarray, np.ndarray]:
    """Cells ``(dl, sl)`` in ascending dst order: the compile's own order
    (its edges are dst-sorted); a closure's is re-sorted."""
    if len(dl) > 1 and np.any(dl[1:] < dl[:-1]):
        order = np.argsort(dl, kind="stable")
        return dl[order], sl[order]
    return dl, sl


def _drop_cells(dl: np.ndarray, sl: np.ndarray, dd: np.ndarray,
                ds: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """``(dl, sl)`` minus the cells ``(dd, ds)``, for ``dl`` ascending:
    each dead cell's dst run is binary-searched, so the cost is
    O(dead x log cells) plus one pass when a cell is found, not a
    membership test over every cell of a multi-million-cell block."""
    if not len(dd):
        return dl, sl
    lo = np.searchsorted(dl, dd, side="left")
    cnt = np.searchsorted(dl, dd, side="right") - lo
    if not cnt.any():
        return dl, sl
    first = np.repeat(np.cumsum(cnt) - cnt, cnt)
    idx = np.repeat(lo, cnt) + np.arange(int(cnt.sum())) - first
    hit = idx[sl[idx] == np.repeat(ds, cnt)]
    if not len(hit):
        return dl, sl
    keep = np.ones(len(dl), dtype=bool)
    keep[hit] = False
    return dl[keep], sl[keep]


_STAGING = threading.local()

# device-side timing events of recent stream-ins on the card, (copy start,
# copy end, build end) each, read once they have completed
_STREAM_EVENTS: deque = deque(maxlen=1024)
_STREAM_LOCK = threading.Lock()


def _staged_upload(dev: torch.device, dl: np.ndarray, sl: np.ndarray):
    """(dst, src) int64 index tensors on ``dev`` for a block build, the
    stream to build on, and the copy's (start, end) timing events. On the
    card: the prefetch worker's own CUDA stream, fed by a non-blocking
    copy out of the worker's pinned staging buffer (grown on demand,
    reused once its last copy has landed)."""
    n = len(dl)
    if dev.type != "cuda":
        # copies: an arena spilled to disk hands back read-only maps
        return (torch.tensor(dl).to(dev), torch.tensor(sl).to(dev), None,
                None)
    st = _STAGING
    if getattr(st, "stream", None) is None or st.device != dev:
        st.stream = torch.cuda.Stream(device=dev)
        st.device = dev
        st.buf = None
        st.ready = None
    if st.ready is not None:
        st.ready.synchronize()  # the buffer's previous copy has landed
    if st.buf is None or st.buf.numel() < 2 * n:
        st.buf = torch.empty(max(2 * n, 1 << 16), dtype=torch.int32,
                             pin_memory=True)
    host = st.buf.numpy()
    host[:n] = dl
    host[n:2 * n] = sl
    copy = (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))
    with torch.cuda.stream(st.stream):
        copy[0].record(st.stream)
        idx = st.buf[:2 * n].to(dev, non_blocking=True)
        copy[1].record(st.stream)
        idx = idx.to(torch.int64)
    return idx[:n], idx[n:], st.stream, copy


def _observe_stream_events(wait: bool) -> None:
    """Move the device times of finished stream-ins into their histograms
    (``engine_tier_stream_copy_seconds``: the host -> device copy;
    ``engine_tier_stream_build_seconds``: the int64 widening, zero-fill,
    scatter and bit pack), oldest first, up to the first one still running;
    ``wait`` waits for every one instead."""
    with _STREAM_LOCK:
        while _STREAM_EVENTS:
            c0, c1, done = _STREAM_EVENTS[0]
            if not wait and not done.query():
                return
            done.synchronize()
            _STREAM_EVENTS.popleft()
            metrics.histogram("engine_tier_stream_copy_seconds").observe(
                c0.elapsed_time(c1) / 1e3)
            metrics.histogram("engine_tier_stream_build_seconds").observe(
                c1.elapsed_time(done) / 1e3)


def tier_stream_timings() -> None:
    """Wait for every stream-in enqueued so far and record its device
    times (see :func:`_observe_stream_events`); a stream-in records its
    host steps itself. For measurement, off the serving path."""
    _observe_stream_events(wait=True)


def _materialize_block(cg: CompiledGraph, d: dict, i: int) -> tuple:
    """Build one tiered block's device tensors, ``(A, bits or None,
    ready event or None)``, from its cold-arena COO minus the dead
    ledger's cells, both at the watermarks of the device state ``d`` (its
    block metadata and ledger rows): the block matches the residual and
    overlay the dispatch runs with. Runs on prefetch worker threads while
    the dispatching thread holds the shared side of the resident lock;
    reads only the arena, append-only ledger rows and ``d``. Each host
    step's time goes into a histogram (``engine_tier_stream_decode_,
    cut_, stage_seconds``); the device steps' are read later from timing
    events (:func:`tier_stream_timings`)."""
    _observe_stream_events(wait=False)
    mark = d["mark"]
    bm = mark["blocks"][i]
    t0 = time.perf_counter()
    coo = cg.tier.arena.get(i)
    t1 = time.perf_counter()
    ledger = (cg.dead_buf[:mark["n_dead"]] if cg.dead_buf is not None
              else cg.dead_pairs)
    dd, ds = cg._dead_cells(bm, ledger)
    dl, sl = _drop_cells(np.asarray(coo["dst_local"]),
                         np.asarray(coo["src_local"]), dd, ds)
    t2 = time.perf_counter()
    dl_t, sl_t, stream, copy = _staged_upload(cg.device, dl, sl)
    t3 = time.perf_counter()
    metrics.histogram("engine_tier_stream_decode_seconds").observe(t1 - t0)
    metrics.histogram("engine_tier_stream_cut_seconds").observe(t2 - t1)
    metrics.histogram("engine_tier_stream_stage_seconds").observe(t3 - t2)
    metrics.counter("engine_tier_streamed_bytes_total").inc(
        dl.nbytes + sl.nbytes)
    if stream is None:
        A, Ab = _build_block(bm, dl_t, sl_t)
        return A, Ab, None
    with torch.cuda.stream(stream):
        A, Ab = _build_block(bm, dl_t, sl_t)
        ready = torch.cuda.Event(enable_timing=True)
        ready.record(stream)
    _STAGING.ready = ready
    _STREAM_EVENTS.append((copy[0], copy[1], ready))
    return A, Ab, ready


def _tier_apply_update(cg: CompiledGraph, d: dict, blocks_host: list,
                       reclose: dict, block_cells: dict) -> None:
    """A committed delta's block edits on a tiered graph (the tiered
    branch of :func:`_patch_device`, under the exclusive side of the
    resident lock). A re-closed block re-encodes its arena COO and, when
    hot, is rebuilt whole; killed cells are cleared in place in a hot
    payload (a cold block needs nothing: its next build reads the arena
    and the ledger at the advanced watermarks). Every touched block is
    pinned hot until the next compaction fold, whose fresh base gets a
    fresh TierStore. (A state built after the commit passes no re-closes:
    its arena already holds the newer closure.)"""
    tier = cg.tier
    res = cg.resident
    dev = cg.device
    mark = d["mark"]
    ledger = (cg.dead_buf[:mark["n_dead"]] if cg.dead_buf is not None
              else cg.dead_pairs)
    for b in reclose:
        bm = blocks_host[b]
        tier.arena.put(b, _block_coo(bm))
        res.tier_coo[b] = bm
        if tier.peek(b) is not None:
            dl, sl = cg._live_cells(bm, ledger=ledger)
            A, Ab = _build_block(bm, torch.as_tensor(dl).to(dev),
                                 torch.as_tensor(sl).to(dev))
            tier.replace(b, (A, Ab, None))
        tier.pin(b)
    for b, cells in block_cells.items():
        payload = tier.peek(b)
        if payload is not None:
            A, Ab, ready = payload
            if ready is not None:
                # built on a worker's stream: order the edit after the
                # build, and keep the memory from reuse until it has run
                cur = torch.cuda.current_stream(dev)
                cur.wait_event(ready)
                A.record_stream(cur)
                if Ab is not None:
                    Ab.record_stream(cur)
            dl = np.fromiter((c[0] for c in cells), dtype=np.int64,
                             count=len(cells))
            sl = np.fromiter((c[1] for c in cells), dtype=np.int64,
                             count=len(cells))

            def up(a, dtype):
                return torch.as_tensor(np.asarray(a)).to(device=dev,
                                                         dtype=dtype)

            A.index_put_((up(dl, torch.int64), up(sl, torch.int64)),
                         torch.zeros(1, dtype=torch.int8, device=dev))
            if Ab is not None:
                _clear_bits(Ab, dl, sl, up)
        tier.pin(b)


def tier_maintain(cg: Optional[CompiledGraph]) -> None:
    """Placement sweep, off the serving path (the compactor's worker):
    decay access recency, demote blocks that went cold while the store is
    over headroom, and build pinned-but-cold blocks so a write never pays
    a stream-in for its own overlay's cells; then publish the gauges.
    Builds run under the shared side of the resident lock, as a
    dispatch's do."""
    tier = cg.tier if cg is not None else None
    if tier is None:
        return
    want = tier.place()
    if want:
        with cg.shared_state() as d:
            if cg.tier is not tier:
                return  # re-tiered meanwhile: the new store starts clean
            for i in want:
                tier.admit(i, _materialize_block(cg, d, i), pinned=True)
    tier.publish_gauges()


def release_resident(cg: CompiledGraph) -> None:
    """Free a base's device state (a store restore replaced the contents
    it was built from): tensors, queued patches and tiered payloads. A
    query still holding a view of it raises on its next dispatch."""
    res = cg.resident
    with res.lock.exclusive():
        res.released = True
        res.tensors = {}
        with res._plock:
            res.pending = []
        if res.tier is not None:
            res.tier.close()
            res.tier = None


def retire_base(cg: CompiledGraph) -> None:
    """The engine stopped serving this base (a schema cut replaced it).
    Unlike a restore (:func:`release_resident`), nothing is freed now: a
    query still dispatching on one of its views finishes on it. Its device
    state goes when its last view does, as a base a compaction fold
    replaced does, and its TierStore's prefetch workers are shut down
    then."""
    res = cg.resident
    if res.tier is not None:
        weakref.finalize(res, res.tier.close)


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
         now_rel, crossover, cav_req: tuple = (), *, max_iters: int,
         q_contig_len: int = 0, q_contig_rows: int = 1):
    """The stratified fixpoint: ``(out uint8 [Q] (+ 4 bytes), converged,
    iterations, push_steps)``. Only the core (level 0) iterates; each
    acyclic level is applied once after it.

    A graph with caveat instances (``cav_rows > 1``) first evaluates the
    caveat VM once (caveats/vm.eval_caveats on the host-encoded request
    ``cav_req``) and gates every residual and overlay edge with its
    verdict row in the activation masks of both; the missing-context
    count is appended to ``out`` as four int32 bytes, so the result's one
    readback carries it.

    The reference's ``lax.while_loop`` and per-hop ``lax.cond`` become a
    Python loop: each iteration ends in ONE device-to-host copy carrying
    the ``changed`` flag and the new state's set count (its occupancy,
    which decides the next hop's push/pull branch in auto mode). An
    acyclic level whose branch depends on occupancy reads the count once
    before its hop."""
    B, Mp = seeds.shape[0], (meta.M // LANE + 1) * LANE
    numel = B * Mp
    mode = meta.spmm_mode
    cav_ok = missing = None
    if meta.cav_rows > 1:
        with torch.profiler.record_function("caveat_vm"):
            cav_ok, missing = eval_caveats(meta.caveats, d["cav_static"],
                                           cav_req, meta.cav_rows)
    act = semiring.edge_activation(d["exp"], now_rel, d["cav"], cav_ok)
    dact = semiring.edge_activation(d["dexp"], now_rel, d["dcav"], cav_ok)
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
        # a window read: q_slots / q_batch are the first slot and row, and
        # the [rows, len] block flattens row-major, the query's own order
        out = V[q_batch:q_batch + q_contig_rows,
                q_slots:q_slots + q_contig_len].reshape(
                    q_contig_rows * q_contig_len)
    else:
        out = V[q_batch, q_slots]
    if missing is not None:
        out = torch.cat([out, missing.reshape(1).view(torch.uint8)])
    return out.contiguous(), not changed, iters, n_push


# ---------------------------------------------------------------------------
# Compilation: (schema, snapshot) -> CompiledGraph (host numpy, a copy of
# the reference's compile_graph)
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


def compile_graph(schema: Schema, snapshot, device=None,
                  delta_capacity: int = DELTA_CAPACITY) -> CompiledGraph:
    """Compile a store snapshot into slot-space form: vectorized numpy
    over the snapshot's columns, as the reference does. ``device``: where
    the graph's tensors live (``cuda`` by default); ``delta_capacity``:
    the delta overlay's fixed slot count (at least 64)."""
    device = resolve_device(device)
    types_in = snapshot.types
    rels_in = snapshot.relations
    cols = snapshot.cols

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
    cavs: list[np.ndarray] = []
    base_time = time.time()
    exp_rel_all = (cols.exp - base_time).astype(np.float32)

    # caveat instance table: one VM row per distinct (caveat, context)
    # pair among live tuples; every edge derived from a caveated tuple
    # (direct / userset / arrow alike) carries its instance row, so the
    # fixpoint can gate it on the dispatch's tri-state
    cav_ids = cols.cav.astype(np.int64)
    caveat_table = build_caveat_table(
        getattr(schema, "caveat_defs", None) or {},
        getattr(snapshot, "caveat_instances", None) or [("", "")],
        np.unique(cav_ids[cav_ids > 0]))
    cav_row_all = caveat_table.inst_row[cav_ids]

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
    cavs.append(cav_row_all[m])

    # userset tuples: src is the subject's (type, relation|permission) slot
    us_off = relperm_off[st, srl]
    m = (srl != 0) & dst_valid & (us_off >= 0) & (cols.sid != WILDCARD_IDX)
    srcs.append(us_off[m] + cols.sid[m])
    dsts.append(dst_all[m])
    exps.append(exp_rel_all[m])
    cavs.append(cav_row_all[m])

    # arrow term edges
    arrow_maps: list = []
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
            arrow_maps.append((int(tid), int(ts_id), term_off, tgt_off))
            m = ((rt == tid) & (rl == ts_id) & (srl == 0)
                 & (tgt_off[st] >= 0) & (cols.sid != WILDCARD_IDX))
            srcs.append(tgt_off[st[m]] + cols.sid[m])
            dsts.append(term_off + cols.rid[m])
            exps.append(exp_rel_all[m])
            cavs.append(cav_row_all[m])

    src = np.concatenate(srcs)
    dst = np.concatenate(dsts)
    exp = np.concatenate(exps)
    cav = np.concatenate(cavs)
    order = native.sort_perm(dst)
    if order is None:
        order = np.argsort(dst, kind="stable")
    src, dst, exp, cav = src[order], dst[order], exp[order], cav[order]

    n_edges = len(src)
    E_pad = _next_bucket(max(n_edges, 1))
    src_p = np.full(E_pad, M, dtype=np.int32)
    dst_p = np.full(E_pad, M, dtype=np.int32)
    exp_p = np.full(E_pad, -np.inf, dtype=np.float32)
    cav_p = np.zeros(E_pad, dtype=np.int32)
    src_p[:n_edges] = src
    dst_p[:n_edges] = dst
    exp_p[:n_edges] = exp
    cav_p[:n_edges] = cav

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
        # caveated edges ride the residual like expiring ones: their
        # activation is a per-dispatch condition, which a dense (let alone
        # closured) block cell cannot carry
        special = (exp != np.inf) | (cav != 0)
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

    # the range-granularity adjacency the tiered demand closure walks:
    # every (src range, dst range) pair the full edge set crosses (block
    # edges included: the rids predate the dense split) plus each
    # program's leaf -> permission pairs; self pairs stay in
    adj_pairs: set = set()
    if n_edges:
        for p in np.unique(
                src_rid.astype(np.int64) * len(offs) + dst_rid).tolist():
            adj_pairs.add(divmod(p, len(offs)))
    for p in programs:
        p_rid = _range_id(offs, p.dst_off)
        for off_ in set(p.leaf_off.values()):
            adj_pairs.add((_range_id(offs, off_), p_rid))
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
                    level=lvl + 1 if lvl else 0, closured=True,
                    base_dst_local=(dst[sel] - offs[d_rid]).astype(np.int32),
                    base_src_local=(src[sel] - offs[s_rid]).astype(np.int32)))
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
    res_cav = np.zeros(res_level_bounds[-1], dtype=np.int32)
    pos = 0
    for k in range(n_levels + 1):
        n_k = int(counts_per_level[k])
        lo = res_level_bounds[k]
        sel = res_idx[pos:pos + n_k]
        res_src[lo:lo + n_k] = src_p[sel]
        res_dst[lo:lo + n_k] = dst_p[sel]
        res_exp[lo:lo + n_k] = exp_p[sel]
        res_cav[lo:lo + n_k] = cav_p[sel]
        pos += n_k

    cap = max(int(delta_capacity), 64)
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
        res_cav=res_cav,
        res_level_bounds=res_level_bounds,
        n_levels=n_levels,
        range_levels=range_levels,
        range_offs=offs,
        range_adj=tuple(sorted(adj_pairs)),
        src=src_p,
        dst=dst_p,
        exp_rel=exp_p,
        n_edges=n_edges,
        res_idx=res_idx,
        delta_src=np.full(cap, M, dtype=np.int32),
        delta_dst=np.full(cap, M, dtype=np.int32),
        delta_exp=np.full(cap, -np.inf, dtype=np.float32),
        delta_cav=np.zeros(cap, dtype=np.int32),
        delta_cap=cap,
        delta_pos={},
        dead_set=set(),
        dead_buf=np.zeros((cap, 2), dtype=np.int64),
        host_lock=threading.Lock(),
        block_codes={},
        block_index={(b.dst_off, b.src_off): i for i, b in enumerate(blocks)},
        self_off=self_off,
        rel_off=rel_off,
        relperm_off=relperm_off,
        arrow_maps=arrow_maps,
        caveats=caveat_table,
        device=device,
    )


# ---------------------------------------------------------------------------
# Incremental updates: (CompiledGraph, write delta) -> CompiledGraph
# ---------------------------------------------------------------------------


def _edges_for_tuple(cg: CompiledGraph, store, rel):
    """Slot-space (src, dst) edges for one relationship, mirroring the
    vectorized extraction in compile_graph (direct / userset / arrow).
    None when the tuple cannot be mapped onto the frozen slot layout (a
    type or relation interned after the compile, or an object past its
    type's padded bucket): the caller falls back to a recompile."""
    tid = store.types.lookup(rel.resource_type)
    stid = store.types.lookup(rel.subject_type)
    rl = store.relations.lookup(rel.relation)
    srl = store.relations.lookup(rel.subject_relation or "")
    if None in (tid, stid, rl, srl):
        return None
    # the lookup tables carry a +1 slack row, so the covered id range is
    # [0, len-1): an id interned after the compile lands on the slack
    # row's -1 and must force a recompile, not read as "no edge"
    n_types = len(cg.self_off) - 1
    n_rels = cg.rel_off.shape[1] - 1
    if tid >= n_types or stid >= n_types or rl >= n_rels or srl >= n_rels:
        return None
    r_objs = store.objects.get(tid)
    s_objs = store.objects.get(stid)
    rid = r_objs.lookup(rel.resource_id) if r_objs else None
    sid = s_objs.lookup(rel.subject_id) if s_objs else None
    if rid is None or sid is None:
        return None
    if rid >= cg.type_sizes.get(rel.resource_type, 0) \
            or sid >= cg.type_sizes.get(rel.subject_type, 0):
        return None  # object bucket overflow: the slot layout must grow
    dst_off = int(cg.rel_off[tid, rl])
    if dst_off < 0:
        return []  # not a writable relation slot (compile drops these too)
    dst = dst_off + rid
    edges: list[tuple[int, int]] = []
    if srl == 0:
        so = int(cg.self_off[stid])
        if so >= 0:  # wildcard subjects included (index 1)
            edges.append((so + sid, dst))
    elif sid != WILDCARD_IDX:
        uo = int(cg.relperm_off[stid, srl])
        if uo >= 0:
            edges.append((uo + sid, dst))
    if srl == 0 and sid != WILDCARD_IDX:
        for a_tid, ts_id, term_off, tgt_off in cg.arrow_maps:
            if a_tid == tid and ts_id == rl and int(tgt_off[stid]) >= 0:
                edges.append((int(tgt_off[stid]) + sid, term_off + rid))
    return edges


def _level_order_ok(cg: CompiledGraph, src: int, dst: int) -> bool:
    """A delta edge fits the frozen stratification iff its source
    finalizes before (or iterates with) its destination: both in the
    core, or level(src) < level(dst). A violation is a first-ever
    dependency direction and needs a re-stratifying recompile."""
    if cg.range_levels is None:
        return True  # unstratified graph: one full fixpoint
    offs = cg.range_offs
    ls = int(cg.range_levels[_range_id(offs, src)])
    ld = int(cg.range_levels[_range_id(offs, dst)])
    return (ls == 0 and ld == 0) or ls < ld


def _pair_block(cg: CompiledGraph, src: int, dst: int) -> Optional[int]:
    """Dense-block index covering a (src, dst) slot pair, or None."""
    if not cg.block_index:
        return None
    offs = cg.range_offs
    d_rid = int(np.searchsorted(offs, dst, side="right")) - 1
    s_rid = int(np.searchsorted(offs, src, side="right")) - 1
    return cg.block_index.get((int(offs[d_rid]), int(offs[s_rid])))


def _res_positions(cg: CompiledGraph, src: int, dst: int) -> list[int]:
    """Base-residual positions holding the (src, dst) edge: each level
    slice is dst-sorted, so it is binary-searched and its per-dst run
    scanned for the src."""
    bounds = cg.res_level_bounds or (0, len(cg.res_dst))
    # a key of the array's own dtype: a Python int would make numpy cast
    # the whole level slice to int64 first (O(residual) a search, 6.7 ms
    # on a 4M-edge level)
    key = cg.res_dst.dtype.type(dst)
    out: list[int] = []
    for k in range(len(bounds) - 1):
        b0, b1 = bounds[k], bounds[k + 1]
        if b0 == b1:
            continue
        lo = b0 + int(np.searchsorted(cg.res_dst[b0:b1], key, side="left"))
        hi = b0 + int(np.searchsorted(cg.res_dst[b0:b1], key, side="right"))
        if lo < hi:
            out.extend(
                (lo + np.flatnonzero(cg.res_src[lo:hi] == src)).tolist())
    return out


def _block_base_codes(cg: CompiledGraph, b: int) -> np.ndarray:
    """Sorted ``dst_local * n_src + src_local`` codes of a closured
    block's base edges, cached on the shared ``block_codes`` dict (keyed
    by block index, checked against the block object's identity so a
    re-close invalidates the entry)."""
    bm = cg.blocks[b]
    cache = cg.block_codes
    if cache is not None:
        ent = cache.get(b)
        if ent is not None and ent[0] == id(bm):
            return ent[1]
    codes = np.sort(bm.base_dst_local.astype(np.int64) * bm.n_src
                    + bm.base_src_local)
    if cache is not None:
        cache[b] = (id(bm), codes)
    return codes


def incremental_update(cg: CompiledGraph, records, new_revision: int,
                       store, sync_device: bool = True
                       ) -> Optional[CompiledGraph]:
    """Fold a write delta into a compiled graph without recompiling.
    ``records`` is an ordered list of ``(is_delete, Relationship)`` from
    the store's watch log since ``cg.revision``.

    - A new edge takes the next free slot of the fixed-capacity overlay;
      a re-touch or delete of an overlay edge rewrites its slot's
      expiration (slots are reused, so churn on the same pairs never
      grows occupancy).
    - A touched or deleted BASE edge is killed where it lives (residual
      expiration forced to -inf, dense-block cell and bit-dual bit
      cleared) and recorded once in the append-only dead ledger.
    - A deleted base edge of a closured block re-closes the block from
      its remaining base edges (closure cells are derived reachability:
      clearing one cell would over- and under-allow).
    - A conditional grant's slot carries its (caveat, context) instance
      row: an existing row, or a spare row of the caveat's padded bucket
      reserved at plan time and written at commit.

    The plan mutates nothing, so a decline leaves the shared overlay as
    it was. The commit writes the host arrays and queues the device patch
    on the shared device state; ``sync_device`` applies it before
    returning, else the caller does with ``resident.flush(patch_seq)``
    (the engine, outside its lock). Returns the new revision's view
    (sharing the overlay and the device state), or None when the delta
    cannot be expressed against the frozen layout; every decline is
    counted in ``engine_graph_incremental_fallback_total{reason}``."""
    if cg.res_src is None or cg.self_off is None or cg.delta_pos is None \
            or cg.delta_src is None or cg.dead_buf is None \
            or cg.delta_cav is None:
        _fallback("unstratified")
        return None
    if len(records) > MAX_DELTA_RECORDS:
        _fallback("overflow")
        return None

    delta_pos = cg.delta_pos
    dead_set = cg.dead_set

    # ---- plan (no mutation) ----
    appends: dict = {}  # pair -> (exp, cav row) of a new overlay slot
    updates: dict = {}  # overlay slot -> (new exp, cav row | None = keep)
    res_kill: list[int] = []
    block_cells: dict[int, set] = {}  # block idx -> local (dst, src) kills
    new_dead: list[tuple[int, int]] = []
    dead_seen: set = set()
    reclose: dict[int, set] = {}  # closured block idx -> local pairs
    # new (caveat, context) instance rows reserved this batch, written to
    # the shared tables only at commit (caveats/vm.py plan_append)
    planned_inst: dict = {}

    for is_delete, relationship in records:
        edges = _edges_for_tuple(cg, store, relationship)
        if edges is None:
            _fallback("layout")
            return None
        cav_row = 0
        if not is_delete and relationship.caveat:
            # a conditional grant: an existing instance row, or a spare
            # row of the caveat's padded bucket; none (the caveat's first
            # tuple since the compile, a full bucket, an unencodable
            # context) means the tables must re-shape: a recompile
            table = cg.caveats
            ctx = relationship.caveat_context or ""
            row = (table.lookup_row(relationship.caveat, ctx)
                   if table is not None else None)
            if row is None and table is not None:
                row = table.plan_append(relationship.caveat, ctx,
                                        planned_inst)
            if row is None:
                _fallback("caveat")
                return None
            cav_row = row
        if not is_delete:
            for src, dst in edges:
                if relationship.expiration is not None \
                        or relationship.caveat:
                    b_ = _pair_block(cg, src, dst)
                    if b_ is not None and cg.blocks[b_].closured:
                        # an expiring or conditional edge cannot live in a
                        # closure (a derived cell would serve it past its
                        # expiry or without its condition); classified
                        # before the level check, which a closured
                        # range's own level would trip first
                        _fallback("closured-expiry"
                                  if relationship.expiration is not None
                                  else "closured-caveat")
                        return None
                if not _level_order_ok(cg, src, dst):
                    _fallback("stratification-inversion")
                    return None
        for src, dst in edges:
            pair = (src, dst)
            b = _pair_block(cg, src, dst)
            bm = cg.blocks[b] if b is not None else None
            if bm is not None and bm.closured and is_delete:
                # re-close from the base edges minus this pair; the pair
                # stays out of the dead ledger (the new closure is the
                # whole truth), and an overlay copy of it is killed
                dl_ = int(dst - bm.dst_off)
                sl_ = int(src - bm.src_off)
                codes = _block_base_codes(cg, b)
                code = dl_ * bm.n_src + sl_
                p_ = int(np.searchsorted(codes, code))
                if p_ < len(codes) and codes[p_] == code:
                    reclose.setdefault(b, set()).add((dl_, sl_))
                slot = delta_pos.get(pair)
                if slot is not None:
                    updates[slot] = (float("-inf"), None)
                appends.pop(pair, None)
                continue
            # kill the base edge wherever it may live, once per pair over
            # the base's incremental lifetime
            if pair not in dead_set and pair not in dead_seen:
                dead_seen.add(pair)
                new_dead.append(pair)
                if bm is not None:
                    block_cells.setdefault(b, set()).add(
                        (dst - bm.dst_off, src - bm.src_off))
                res_kill.extend(_res_positions(cg, src, dst))
            slot = delta_pos.get(pair)
            if is_delete:
                if slot is not None:
                    updates[slot] = (float("-inf"), None)
                appends.pop(pair, None)
                continue
            # adds (re-touches of block-covered pairs too) always land in
            # the overlay; base copies are only ever cleared. The caveat
            # row rides the slot with the expiration: a touch may attach,
            # replace or strip the condition
            exp_rel = (np.inf if relationship.expiration is None
                       else relationship.expiration - cg.base_time)
            if slot is not None:
                updates[slot] = (float(exp_rel), cav_row)
            else:
                appends[pair] = (float(exp_rel), cav_row)

    if cg.n_delta + len(appends) > cg.delta_cap \
            or cg.n_dead + len(new_dead) > len(cg.dead_buf):
        _fallback("overflow")
        return None

    blocks_host = cg.blocks
    if reclose:
        blocks_host = list(cg.blocks)
        for b, pairs in reclose.items():
            nb = blocks_host[b].reclosed(pairs)
            if nb is None:  # closure overflow: re-stratify instead
                _fallback("overflow")
                return None
            blocks_host[b] = nb

    # ---- commit: host arrays in place and the device patch queued, under
    # host_lock; the patch runs under the exclusive side of the resident
    # lock (no query is mid-fixpoint) ----
    app_items = list(appends.items())
    n0, nd0 = cg.n_delta, cg.n_dead
    res = cg.resident
    with cg.host_lock:
        for i, ((s, t), (ex, cv)) in enumerate(app_items):
            cg.delta_src[n0 + i] = s
            cg.delta_dst[n0 + i] = t
            cg.delta_exp[n0 + i] = ex
            cg.delta_cav[n0 + i] = cv
            delta_pos[(s, t)] = n0 + i
        for slot, (ex, cv) in updates.items():
            cg.delta_exp[slot] = ex
            if cv is not None:
                cg.delta_cav[slot] = cv
        if res_kill:
            cg.res_exp[np.asarray(res_kill, dtype=np.int64)] = -np.inf
        for j, (s, t) in enumerate(new_dead):
            cg.dead_buf[nd0 + j] = (s, t)
        dead_set.update(new_dead)
        # reserved caveat-instance rows land in the shared host tables
        # (the same commit discipline as the overlay slots); the device
        # tables get them in the same queued patch as the slots that use
        # them, so no dispatch sees a slot pointing at an unwritten row
        inst_dev = (cg.caveats.apply_appends(planned_inst)
                    if planned_inst else [])
        if reclose:
            for b in reclose:
                cg.block_codes.pop(b, None)
            res.blocks = blocks_host
        n_delta2 = n0 + len(app_items)
        n_dead2 = nd0 + len(new_dead)
        # commits queue only under host_lock: this one's number is next
        marks = (res.committed + 1, n_delta2, n_dead2)
        seq = res.queue(lambda d: _patch_device(
            cg, d, n0, app_items, updates, res_kill, block_cells, reclose,
            blocks_host, inst_dev, marks))
    if sync_device:
        res.flush(seq)
    metrics.gauge("engine_delta_occupancy").set(n_delta2)
    return replace(cg, revision=new_revision, n_delta=n_delta2,
                   n_dead=n_dead2, dead_pairs=cg.dead_buf[:n_dead2],
                   blocks=blocks_host, patch_seq=seq)


def _patch_device(cg: CompiledGraph, d: dict, n0: int, app_items: list,
                  updates: dict, res_kill: list, block_cells: dict,
                  reclose: dict, blocks_host: list,
                  inst_dev: list = (), marks: tuple = (0, 0, 0)) -> None:
    """Apply one committed delta to the shared device state in place:
    O(write) scatters, the new caveat instance rows (``inst_dev``, from
    ``CompiledCaveats.apply_appends``), plus O(block) for each re-closed
    block (a new tensor; queries already past their hops keep the old one
    alive through their own references), and advance the state's
    watermarks to this commit's (``marks``: commit number, overlay slots,
    ledger rows; a state built after the commit keeps its own).
    On a tiered graph the block edits go through the tier
    (:func:`_tier_apply_update`). Caller holds the exclusive resident
    lock."""
    dev = cg.device
    mark = d["mark"]
    fresh = marks[0] > mark["seq"]
    if fresh:
        mark["seq"], mark["n_delta"], mark["n_dead"] = marks
        mark["blocks"] = list(blocks_host)

    def up(a, dtype):
        return torch.as_tensor(np.asarray(a)).to(device=dev, dtype=dtype)

    if app_items:
        ai = up(np.arange(n0, n0 + len(app_items)), torch.int64)
        d["dsrc"].index_copy_(0, ai, up([p[0] for p, _ in app_items],
                                        torch.int64))
        d["ddst"].index_copy_(0, ai, up([p[1] for p, _ in app_items],
                                        torch.int64))
    if app_items or updates:
        # appended slots and updated slots are disjoint, each unique
        ui = up([n0 + i for i in range(len(app_items))] + list(updates),
                torch.int64)
        uv = up([ex for _, (ex, _) in app_items]
                + [ex for ex, _ in updates.values()], torch.float32)
        d["dexp"].index_copy_(0, ui, uv)
    # caveat rows: appended slots start at 0 (unconditional), so only
    # their nonzero rows are written; an update may strip a row to 0
    cav_w = [(n0 + i, cv) for i, (_, (_, cv)) in enumerate(app_items) if cv]
    cav_w += [(slot, cv) for slot, (_, cv) in updates.items()
              if cv is not None]
    if cav_w:
        d["dcav"].index_copy_(0, up([w[0] for w in cav_w], torch.int64),
                              up([w[1] for w in cav_w], torch.int64))
    if inst_dev and d.get("cav_static"):
        cg.caveats.patch_rows(d["cav_static"], inst_dev)
    if res_kill:
        d["exp"].index_fill_(0, up(res_kill, torch.int64), float("-inf"))
    if not (block_cells or reclose):
        return
    if cg.tier is not None:
        _tier_apply_update(cg, d, blocks_host,
                           reclose if fresh else {}, block_cells)
        return
    blocks = list(d["blocks"])
    bits = list(d["blocks_bits"])
    with cg.host_lock:  # the ledger a rebuilt block is cut by
        for b in reclose:
            blocks[b], bits[b] = cg._block_tensors(blocks_host[b])
    for b, cells in block_cells.items():
        dl = np.fromiter((c[0] for c in cells), dtype=np.int64,
                         count=len(cells))
        sl = np.fromiter((c[1] for c in cells), dtype=np.int64,
                         count=len(cells))
        blocks[b].index_put_((up(dl, torch.int64), up(sl, torch.int64)),
                             torch.zeros(1, dtype=torch.int8, device=dev))
        if bits[b] is not None:
            _clear_bits(bits[b], dl, sl, up)
    d["blocks"] = tuple(blocks)
    d["blocks_bits"] = tuple(bits)


def _clear_bits(bits: torch.Tensor, dl: np.ndarray, sl: np.ndarray,
                up) -> None:
    """Clear cells (dl, sl) in an int32 bit-packed dual. Cells that share
    a packed (row, word) are merged into one mask on the host first: a
    gather-modify-scatter with duplicate indices would keep only one of
    their updates. The uint32 mask is reinterpreted as int32, not cast,
    so bit 31 is cleared like any other."""
    words = sl // 32
    key = dl * bits.shape[1] + words
    uniq, inv = np.unique(key, return_inverse=True)
    masks = np.zeros(len(uniq), dtype=np.uint32)
    np.bitwise_or.at(masks, inv, np.uint32(1) << (sl % 32).astype(np.uint32))
    rows_t = up(uniq // bits.shape[1], torch.int64)
    cols_t = up(uniq % bits.shape[1], torch.int64)
    keep = up((~masks).view(np.int32), torch.int32)
    bits.index_put_((rows_t, cols_t), bits[rows_t, cols_t] & keep)
