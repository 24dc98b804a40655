"""Sharded slot-space reachability: the multi-device execution path.

Counterpart of the JAX package's ``parallel/sharded.py``. Wraps a
:class:`~..ops.reachability.CompiledGraph` and runs the same stratified
fixpoint over a ``("data", "graph")`` mesh of cells (parallel/mesh.py),
with the reference's layout:

- each stratification level's (dst-sorted) residual edges, plus the
  edges of blocks the graph axis cannot split, are cut into contiguous
  chunks along ``graph``, padded to the axis (trash slot ``M``,
  expiration ``-inf``, caveat row 0); every cell gathers and scatters
  over its chunk;
- a dense block is kept when ``n_src % ng == 0``: cell ``g`` holds the
  contiguous src-axis shard ``A[:, g*w:(g+1)*w]`` (``w = n_src // ng``)
  and contracts the state's matching columns through the
  ``dense_or_matmul`` kernel (ops/bitprop.py). Mesh blocks carry no bit
  duals, as in the reference, so every block hop is a pull;
- the delta overlay is padded to the axis and cut the same way; the
  caveat instance tables and VM tapes are replicated on every device of
  the mesh, each dispatch evaluating the VM once a device;
- the query batch is split along ``data``: each data row of the mesh
  answers its own rows of the batch.

Where the reference traces one ``shard_map`` program, the port runs a
host-driven SPMD loop over this process's cells. A step computes each
cell's partial product (``semiring.propagate(..., shard=(g, ng))``),
joins the partials of one data row by MAX (elementwise over the local
cells, then ``all_reduce(MAX)`` over the row's process group when its
cells span processes) and applies the core permission programs. The
join stays outside any push/pull choice. Convergence is fused over K
steps (:func:`~..ops.reachability.convergence_fuse_steps`): the K
per-step change flags are joined as one ``[K]`` vector over both axes
and read on the host once a window, so ``iterations()`` reports the true
converged-at step and ``conv_checks()`` the windows paid. The output
rows are then gathered over ``data`` so every process can read them.

The device state of one compiled base on one mesh is shared by every
view :meth:`ShardedGraph.updated` returns and patched in place in
O(write), like the single-device state (ops/reachability ``_Resident``):
a query holds the shared side of its reader/writer lock, a sync the
exclusive side, so a query sees one revision's state whole — the newest
host commit at its last sync (at least as fresh as its view). A sync
replays the dead ledger's new rows on the level chunks and block shards,
re-cuts re-closed blocks, patches the overlay slots that changed and
appends new caveat instance rows to the replicated tables.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Optional

import numpy as np
import torch

from ..caveats.vm import eval_caveats
from ..ops import semiring
from ..ops.reachability import (
    DEFAULT_MAX_ITERS,
    CompiledGraph,
    ConvergenceError,
    StateReleased,
    _apply_program,
    _next_bucket,
    _RWLock,
    _seed_base,
    convergence_fuse_steps,
    host_sync,
)
from .mesh import Mesh


def _pair_keys(pairs: Optional[np.ndarray]) -> np.ndarray:
    if pairs is None or not len(pairs):
        return np.empty(0, dtype=np.int64)
    pairs = np.asarray(pairs, dtype=np.int64)
    return pairs[:, 0] * (1 << 32) + pairs[:, 1]


def _all_reduce_max(t: torch.Tensor, group) -> None:
    import torch.distributed as dist

    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)


def _dev_key(dev: torch.device) -> str:
    return str(dev)


class ShardedQueryFuture:
    """A dispatched sharded query (grid or flat form). ``result()``
    validates convergence and reads the gathered rows back (one copy,
    the missing-context count riding its last four bytes); the counters
    match the reference's future: ``iterations()`` the converged-at step
    (plus the confirming no-op step of a converged run, as the
    single-device fixpoint counts it), ``conv_checks()`` the K-step
    windows paid, ``push_steps()`` (always 0: mesh blocks have no bit
    dual) and ``caveats_missing()``."""

    __slots__ = ("_out", "_shape", "_converged", "_iters", "_sel",
                 "_max_iters", "_k_steps", "_checks", "_push", "_cav",
                 "_host")

    def __init__(self, out, shape, converged, iters, sel, max_iters,
                 k_steps=1, checks=None, push=0, cav=False):
        self._out = out
        self._shape = shape
        self._converged = converged
        self._iters = iters
        self._sel = sel  # None (grid) | (rows, cols) | ("contig_grid", L, R)
        self._max_iters = max_iters
        self._k_steps = max(int(k_steps), 1)
        self._checks = checks
        self._push = push
        self._cav = cav
        self._host = None

    def _read(self) -> np.ndarray:
        if self._host is None:
            with host_sync("readback"):
                self._host = self._out.cpu().numpy()
        return self._host

    def result(self) -> np.ndarray:
        if not self._converged:
            raise ConvergenceError(
                f"sharded reachability did not converge within "
                f"{self._max_iters} iterations")
        B, Q = self._shape
        out = self._read()[:B * Q].view(np.bool_).reshape(B, Q)
        if self._sel is None:
            return out
        if isinstance(self._sel[0], str):  # ("contig_grid", L, R)
            _, L, R = self._sel
            return out[:R, :L].reshape(-1)
        rows, cols = self._sel
        return out[rows, cols]

    def iterations(self) -> int:
        return int(self._iters)

    def conv_checks(self) -> int:
        if self._checks is not None:
            return int(self._checks)
        return -(-int(self._iters) // self._k_steps)

    def push_steps(self) -> int:
        return int(self._push)

    def caveats_missing(self) -> int:
        if not self._cav:
            return 0
        B, Q = self._shape
        return int(self._read()[B * Q:].view(np.int32)[0])


class _MeshState:
    """The device state of one compiled base on one mesh, shared by every
    view of it. ``shards[(g, device)]`` holds graph index ``g``'s level
    chunks, block shards and overlay chunk on one device (cells of
    different data rows on one device share them); ``cav_static[device]``
    the replicated caveat tables. The watermarks say which host commit
    the tensors reflect: ``blocks`` (block metadata), ``n_dead`` (ledger
    rows), ``n_delta`` and the overlay mirrors ``h_dexp``/``h_dcav``,
    ``inst`` (caveat rows). ``lock``: queries hold the shared side,
    syncs the exclusive side; ``released`` once a restore freed it."""

    __slots__ = ("lock", "shards", "cav_static", "h_levels", "chunk",
                 "dchunk", "blocks", "kept", "n_dead", "n_delta", "h_dexp",
                 "h_dcav", "inst", "qgrid", "released")

    def __init__(self):
        self.lock = _RWLock()
        self.shards: dict = {}
        self.cav_static: dict = {}
        self.qgrid: dict = {}
        self.released = False


class ShardedGraph:
    """A CompiledGraph pinned across a mesh of cells.

    Level chunks and block shards are placed once and stay resident
    across queries; only seeds, the query grid, the request's caveat
    context and, after writes, the O(write) patches move host -> device.

    Tiered storage: the mesh keeps every block resident (per-dispatch
    demand streaming is a single-device feature). A tiered graph within
    its budget builds here and accounts its blocks hot
    (``TierStore.mark_sharded``); one beyond it never reaches this class:
    ``Engine._backend`` routes it to the single-device streaming path and
    counts ``engine_tier_mesh_fallback_total``."""

    def __init__(self, cg: CompiledGraph, mesh: Mesh,
                 max_iters: int = DEFAULT_MAX_ITERS,
                 k_steps: Optional[int] = None):
        reason = self.unsupported_reason(cg)
        if reason is not None:
            # serving such a graph here would FAIL OPEN (conditional
            # edges with no per-edge rows to mask)
            raise ValueError(f"ShardedGraph cannot serve this graph: "
                             f"{reason}")
        self.cg = cg
        self.mesh = mesh
        self.max_iters = max_iters
        self.nd = mesh.shape["data"]
        self.ng = mesh.shape["graph"]
        self._meta = cg.run_meta()
        # the raw override (None = derive per graph) survives rebuilds
        self._k_override = k_steps
        self.k_steps = (max(int(k_steps), 1) if k_steps
                        else convergence_fuse_steps(self._meta))
        self._cells = mesh.local_cells()
        self._rows: dict = {}  # data row -> [(g, device), ...] local cells
        for r, g, dev in self._cells:
            self._rows.setdefault(r, []).append((g, dev))
        self._state = st = _MeshState()
        with cg._host_guard():
            # the shared host state (overlay, res_exp, ledger, block
            # metadata, caveat tables) is written in place by commits:
            # snapshot it whole under the guard
            blocks = list(cg.resident.blocks)
            ledger = cg._ledger()
            ledger = np.array(ledger if ledger is not None
                              else np.empty((0, 2)), dtype=np.int64)
            level_arrays, kept = self._host_level_edges(blocks, ledger)
            d_src, d_dst, d_exp, d_cav = (np.array(a) for a in
                                          cg._delta_host())
            n_delta = (len(cg.delta_pos) if cg.delta_pos is not None
                       else cg.n_delta)
            # the caveat tables, replicated on every device of the mesh
            cavt = cg.caveats
            inst = ()
            if cavt is not None and cavt.metas:
                inst = cavt.applied_rows()
                for _, _, dev in self._cells:
                    k = _dev_key(dev)
                    if k not in st.cav_static:
                        st.cav_static[k] = cavt.device_static(dev)
        st.h_levels = level_arrays
        kept_ids = {id(bm) for bm in kept}
        st.kept = [i for i, bm in enumerate(blocks) if id(bm) in kept_ids]
        st.blocks = blocks
        st.n_dead = len(ledger)
        st.n_delta = n_delta
        self._block_meta = tuple(bm.slim() for bm in kept)
        if self._meta.n_levels + 1 != len(level_arrays):
            raise AssertionError(
                "level edge arrays out of step with stratification")
        d_src, d_dst, d_exp, d_cav = self._pad_delta(d_src, d_dst, d_exp,
                                                     d_cav)
        st.h_dexp, st.h_dcav = d_exp, d_cav
        st.chunk = [len(a[0]) // self.ng for a in level_arrays]
        st.dchunk = len(d_src) // self.ng
        for g, dev in {(g, dev) for _, g, dev in self._cells}:
            key = (g, _dev_key(dev))
            if key in st.shards:
                continue
            st.shards[key] = self._build_shard(
                g, dev, level_arrays, kept, ledger, (d_src, d_dst, d_exp,
                                                     d_cav))
        st.inst = inst
        if cg.tier is not None:
            # mesh placement: every block is resident for the life of
            # this build — account it hot (the tier store has its own
            # lock, taken outside the host guard)
            idxs = [cg.block_index.get((bm.dst_off, bm.src_off))
                    for bm in kept]
            cg.tier.mark_sharded([i for i in idxs if i is not None])
            cg.tier.publish_gauges()

    @staticmethod
    def unsupported_reason(cg: CompiledGraph) -> Optional[str]:
        """Why this graph cannot run on the mesh, or ``None`` (the common
        case: caveated graphs are served). The one unsupported shape: a
        caveated graph without complete stratified per-edge caveat rows
        (a hand-built layout), whose level arrays would carry no rows to
        mask, so conditional edges would serve unconditionally (fail
        open). ``Engine._backend`` counts these in
        ``engine_caveat_mesh_fallback_total`` and keeps them on the
        single-device path."""
        cavt = getattr(cg, "caveats", None)
        if cavt is not None and getattr(cavt, "metas", ()):
            if cg.res_idx is None or cg.res_src is None \
                    or cg.res_cav is None \
                    or len(cg.res_cav) != len(cg.res_src):
                return ("caveated graph without per-edge caveat rows "
                        "(unstratified/hand-built layout)")
        return None

    # -- host-side construction ---------------------------------------------

    def _pad_level(self, src, dst, exp, cav):
        """Pad one level's edges with trash rows so the graph axis
        divides evenly (at least ng rows so every cell has a chunk)."""
        M = self.cg.M
        n = max(len(src), 1)
        n_pad = ((n + self.ng - 1) // self.ng) * self.ng
        s = np.full(n_pad, M, dtype=np.int64)
        d = np.full(n_pad, M, dtype=np.int64)
        e = np.full(n_pad, -np.inf, dtype=np.float32)
        c = np.zeros(n_pad, dtype=np.int64)  # pad rows: uncaveated
        s[: len(src)] = src
        d[: len(dst)] = dst
        e[: len(exp)] = exp
        c[: len(cav)] = cav
        return s, d, e, c

    def _pad_delta(self, d_src, d_dst, d_exp, d_cav):
        pad = len(d_src)
        pad2 = max(((pad + self.ng - 1) // self.ng) * self.ng, self.ng)
        M = self.cg.M

        def ext(a, fill, dtype):
            out = np.full(pad2, fill, dtype=dtype)
            out[:pad] = a
            return out

        return (ext(d_src, M, np.int64), ext(d_dst, M, np.int64),
                ext(d_exp, -np.inf, np.float32), ext(d_cav, 0, np.int64))

    def _host_level_edges(self, blocks: list, ledger: np.ndarray):
        """(level_arrays, kept_blocks): per stratification level 0..L, the
        (src, dst, exp, cav) edges this mesh gathers over (the level's
        residual slice plus the edges of that level's blocks the graph
        axis cannot split, dst-sorted and padded to the axis), and the
        blocks kept whole as src-axis shards. Folded block edges are
        never caveated (caveated edges stay out of dense blocks), so
        they carry row 0. ``ledger``: the dead pairs to cut."""
        cg = self.cg
        dead = _pair_keys(ledger)
        if cg.res_idx is None or cg.res_src is None:
            # no dense split: the whole edge set as one core level, dead
            # pairs killed in place (unsupported_reason refuses caveated
            # graphs in this shape, so the caveat rows are all 0)
            b_src = np.asarray(cg.src[: cg.n_edges], dtype=np.int64)
            b_dst = np.asarray(cg.dst[: cg.n_edges], dtype=np.int64)
            b_exp = np.array(cg.exp_rel[: cg.n_edges], dtype=np.float32)
            b_cav = np.zeros(cg.n_edges, dtype=np.int64)
            if len(dead):
                b_exp[np.isin(b_src * (1 << 32) + b_dst, dead)] = -np.inf
            return [self._pad_level(b_src, b_dst, b_exp, b_cav)], []
        kept, folded = [], []
        for bm in blocks:
            (kept if bm.n_src % self.ng == 0 else folded).append(bm)
        bounds = cg.res_level_bounds or (0, len(cg.res_src))
        res_cav = cg.res_cav
        if res_cav is None or len(res_cav) != len(cg.res_src):
            res_cav = np.zeros(len(cg.res_src), dtype=np.int64)
        out = []
        for k in range(cg.n_levels + 1):
            # the level's residual slice: dst-sorted, carrying the
            # commits' kills (res_exp -> -inf); its bucket padding is
            # harmless trash
            lo, hi = bounds[k], bounds[k + 1]
            parts = [(cg.res_src[lo:hi], cg.res_dst[lo:hi],
                      cg.res_exp[lo:hi], res_cav[lo:hi])]
            for bm in folded:
                if bm.level != k:
                    continue
                e_src = bm.src_off + np.asarray(bm.src_local, np.int64)
                e_dst = bm.dst_off + np.asarray(bm.dst_local, np.int64)
                keep = ~np.isin(e_src * (1 << 32) + e_dst, dead)
                n_keep = int(keep.sum())
                parts.append((e_src[keep], e_dst[keep],
                              np.full(n_keep, np.inf, dtype=np.float32),
                              np.zeros(n_keep, dtype=np.int64)))
            src = np.concatenate([np.asarray(p[0], np.int64) for p in parts])
            dst = np.concatenate([np.asarray(p[1], np.int64) for p in parts])
            exp = np.concatenate([np.asarray(p[2], np.float32)
                                  for p in parts])
            cav = np.concatenate([np.asarray(p[3], np.int64) for p in parts])
            if len(parts) > 1:  # merged folded edges: restore dst order
                order = np.argsort(dst, kind="stable")
                src, dst, exp, cav = (src[order], dst[order], exp[order],
                                      cav[order])
            out.append(self._pad_level(src, dst, exp, cav))
        return out, kept

    def _block_shard(self, bm, g: int, ledger: np.ndarray,
                     dev: torch.device) -> torch.Tensor:
        """Cell ``g``'s contiguous shard ``A[:, g*w:(g+1)*w]`` of a kept
        block on ``dev``: the block's cells minus the ledger's dead ones
        (``CompiledGraph._live_cells``), cut to the shard's columns."""
        w = bm.n_src // self.ng
        dl, sl = self.cg._live_cells(bm, ledger=ledger)
        m = (sl >= g * w) & (sl < (g + 1) * w)
        A = torch.zeros((bm.n_dst, w), dtype=torch.int8, device=dev)
        if m.any():
            A.index_put_(
                (torch.as_tensor(dl[m]).to(dev),
                 torch.as_tensor(sl[m] - g * w).to(dev)),
                torch.ones(1, dtype=torch.int8, device=dev))
        return A

    def _build_shard(self, g: int, dev: torch.device, level_arrays: list,
                     kept: list, ledger: np.ndarray, delta: tuple) -> dict:
        st = self._state

        def up(a, lo, hi):
            # a copy also on the CPU: the host mirrors stay the state's own
            return torch.as_tensor(np.ascontiguousarray(a[lo:hi])).to(
                device=dev, copy=True)

        levels = []
        for k, quad in enumerate(level_arrays):
            c = st.chunk[k]
            levels.append(tuple(up(a, g * c, (g + 1) * c) for a in quad))
        c = st.dchunk
        return {"levels": levels,
                "blocks": [self._block_shard(bm, g, ledger, dev)
                           for bm in kept],
                "delta": [up(a, g * c, (g + 1) * c) for a in delta]}

    # -- incremental updates -------------------------------------------------

    def updated(self, cg: CompiledGraph) -> "ShardedGraph":
        """A view for another revision of the same compiled base, sharing
        this one's device state, synced in place to the newest host
        commit; a full rebuild when the layout changed (a recompile, even
        one with an equal signature, a block that changed beyond a
        re-close)."""
        old = self.cg
        if cg is old:
            return self

        def rebuild() -> "ShardedGraph":
            return ShardedGraph(cg, self.mesh, self.max_iters,
                                self._k_override)

        if cg.signature() != old.signature():
            return rebuild()
        # signature equality proves only an equal layout: incremental
        # descendants share their base arrays BY OBJECT, while a full
        # recompile (whose padding may keep the signature) folds the
        # delta into new ones the resident chunks would miss
        if not (cg.resident is old.resident and cg.res_src is old.res_src
                and cg.res_dst is old.res_dst and cg.src is old.src
                and cg.dst is old.dst):
            return rebuild()
        if not self._sync(cg):
            return rebuild()
        new = object.__new__(ShardedGraph)
        new.__dict__.update(self.__dict__)
        new.cg = cg
        return new

    def _sync(self, cg: CompiledGraph) -> bool:
        """Bring the shared state to the newest host commit of ``cg``'s
        base, O(write); False when that needs a rebuild (a folded block
        re-closed, a block changed shape). The host state is snapshotted
        under the graph's host guard, then patched under the exclusive
        side of the state lock; the engine serializes syncs."""
        st = self._state
        with cg._host_guard():
            blocks = list(cg.resident.blocks)
            ledger = cg._ledger()
            fresh = np.array(ledger[st.n_dead:] if ledger is not None
                             else np.empty((0, 2)), dtype=np.int64)
            n_dead = st.n_dead + len(fresh)
            d_src, d_dst, d_exp, d_cav = (np.array(a) for a in
                                          cg._delta_host())
            n_delta = (len(cg.delta_pos) if cg.delta_pos is not None
                       else cg.n_delta)
            cavt = cg.caveats
            inst_new = (cavt.applied_rows()
                        if cavt is not None and cavt.metas else ())
            cav_cols = []
            for ci, (lo, hi) in enumerate(zip(st.inst, inst_new)):
                if hi > lo:
                    h = cavt.hosts[ci]
                    cav_cols.append((ci, lo, hi, {
                        k: np.array(v[..., lo:hi]) for k, v in (
                            ("ce", h.ctx_e), ("cv", h.ctx_v),
                            ("ck", h.ctx_k), ("loe", h.lo_e),
                            ("lov", h.lo_v), ("hie", h.hi_e),
                            ("hiv", h.hi_v), ("lk", h.list_k),
                            ("real", h.real))}))
        reclosed = []
        if len(blocks) != len(st.blocks):
            return False
        for i, (nb, ob) in enumerate(zip(blocks, st.blocks)):
            if nb is ob:
                continue
            same_shape = (nb.dst_off == ob.dst_off and nb.n_dst == ob.n_dst
                          and nb.src_off == ob.src_off
                          and nb.n_src == ob.n_src and nb.level == ob.level
                          and nb.closured and ob.closured)
            if not same_shape or nb.n_src % self.ng:
                return False
            reclosed.append(i)
        # the newest ledger's new rows: positions in each level's host
        # arrays (each level dst-sorted) and cells of kept blocks
        kill: dict = {}
        cells: dict = {}
        kept_pos = {i: p for p, i in enumerate(st.kept)}
        for s, t in fresh:
            for k, (h_src, h_dst, _, _) in enumerate(st.h_levels):
                lo = int(np.searchsorted(h_dst, t, side="left"))
                hi = int(np.searchsorted(h_dst, t, side="right"))
                if lo < hi:
                    hit = lo + np.flatnonzero(h_src[lo:hi] == s)
                    if len(hit):
                        kill.setdefault(k, []).append(hit)
            for i, p in kept_pos.items():
                bm = blocks[i]
                if (bm.dst_off <= t < bm.dst_off + bm.n_dst
                        and bm.src_off <= s < bm.src_off + bm.n_src):
                    cells.setdefault(p, []).append(
                        (t - bm.dst_off, s - bm.src_off))
        d_src, d_dst, d_exp, d_cav = self._pad_delta(d_src, d_dst, d_exp,
                                                     d_cav)
        n = len(d_exp)
        app = np.arange(st.n_delta, min(n_delta, n), dtype=np.int64)
        changed = np.union1d(np.flatnonzero(st.h_dexp != d_exp), app)
        changed_c = np.union1d(np.flatnonzero(st.h_dcav != d_cav), app)
        full_ledger = np.array(ledger if ledger is not None
                               else np.empty((0, 2)), dtype=np.int64)
        w_of = {p: blocks[i].n_src // self.ng for p, i in kept_pos.items()}
        with st.lock.exclusive():
            if st.released:
                return True  # a restore freed it: the view raises on use
            for (g, _), sh in st.shards.items():
                dev = sh["delta"][0].device
                for k, hits in kill.items():
                    pos = np.concatenate(hits)
                    c = st.chunk[k]
                    mine = pos[(pos >= g * c) & (pos < (g + 1) * c)] - g * c
                    if len(mine):
                        sh["levels"][k][2].index_fill_(
                            0, torch.as_tensor(mine).to(dev), float("-inf"))
                for i in reclosed:
                    p = kept_pos[i]
                    sh["blocks"][p] = self._block_shard(blocks[i], g,
                                                        full_ledger, dev)
                for p, cl in cells.items():
                    if st.kept[p] in reclosed:
                        continue  # re-cut whole above
                    w = w_of[p]
                    dl = np.asarray([c_[0] for c_ in cl], dtype=np.int64)
                    sl = np.asarray([c_[1] for c_ in cl], dtype=np.int64)
                    m = (sl >= g * w) & (sl < (g + 1) * w)
                    if m.any():
                        sh["blocks"][p].index_put_(
                            (torch.as_tensor(dl[m]).to(dev),
                             torch.as_tensor(sl[m] - g * w).to(dev)),
                            torch.zeros(1, dtype=torch.int8, device=dev))
                c = st.dchunk
                for idx, arrs in ((app, (0, 1)), (changed, (2,)),
                                  (changed_c, (3,))):
                    mine = idx[(idx >= g * c) & (idx < (g + 1) * c)]
                    if not len(mine):
                        continue
                    at = torch.as_tensor(mine - g * c).to(dev)
                    for j in arrs:
                        src_arr = (d_src, d_dst, d_exp, d_cav)[j]
                        t_ = sh["delta"][j]
                        t_.index_copy_(0, at, torch.as_tensor(
                            src_arr[mine]).to(device=dev, dtype=t_.dtype))
            for ci, lo, hi, cols in cav_cols:
                for statics in st.cav_static.values():
                    ent = statics[ci]
                    for name, arr in cols.items():
                        ent[name][..., lo:hi] = torch.as_tensor(arr).to(
                            ent[name].device)
            st.blocks = blocks
            st.n_dead = n_dead
            st.n_delta = n_delta
            st.h_dexp = d_exp
            st.h_dcav = d_cav
            if cav_cols:
                st.inst = inst_new
        return True

    def release(self) -> None:
        """Free the shared device state (a store restore replaced what it
        was built from); a view still dispatching on it raises
        :class:`~..ops.reachability.StateReleased`."""
        st = self._state
        with st.lock.exclusive():
            st.released = True
            st.shards = {}
            st.cav_static = {}
            st.qgrid = {}

    def device_bytes(self) -> int:
        """Bytes of device tensors this mesh state holds on this process."""
        n = 0
        st = self._state
        for sh in st.shards.values():
            ts = [t for quad in sh["levels"] for t in quad]
            ts += list(sh["blocks"]) + list(sh["delta"])
            n += sum(t.numel() * t.element_size() for t in ts)
        for statics in st.cav_static.values():
            for ent in statics:
                n += sum(v.numel() * v.element_size() for v in ent.values()
                         if isinstance(v, torch.Tensor))
        return n

    def block_shards(self) -> list:
        """``[(block metadata, g, shard tensor), ...]`` of this process's
        kept block shards (what the card kernel contracts)."""
        st = self._state
        out = []
        for (g, _), sh in sorted(st.shards.items()):
            for bm, A in zip(self._block_meta, sh["blocks"]):
                out.append((bm, g, A))
        return out

    # -- dispatch -----------------------------------------------------------

    @contextmanager
    def shared_state(self):
        """The shared side of the state lock, for a caller that runs
        several dispatches against one state (a chunked bulk check)."""
        with self._state.lock.shared():
            yield self._state

    def _dispatch(self, seeds_pad: np.ndarray, grid: dict, q_pad: int,
                  now_abs: float, cav_req: tuple):
        """The host-driven SPMD fixpoint over this process's cells.
        Returns ``(out uint8 [B_pad * Q_pad] (+ 4 bytes), converged,
        iterations, windows, push steps)``."""
        meta = self._meta
        mesh = self.mesh
        st = self._state
        B_pad = seeds_pad.shape[0]
        b_row = B_pad // self.nd
        now_rel = np.float32(now_abs - self.cg.base_time)
        rows = sorted(self._rows)
        main = self._rows[rows[0]][0][1]
        mode = meta.spmm_mode
        with st.lock.shared():
            if st.released:
                raise StateReleased(
                    "this graph's mesh state was released by a store "
                    "restore; read the engine's compiled() again")
            # one caveat VM pass a device a dispatch (replicated tables)
            cav_ok, missing = {}, None
            if meta.cav_rows > 1:
                for dk, statics in st.cav_static.items():
                    ok, miss = eval_caveats(meta.caveats, statics, cav_req,
                                            meta.cav_rows)
                    cav_ok[dk] = ok
                    if missing is None:
                        missing = miss
            # edge activation once a dispatch, per shard
            acts = {}
            for key, sh in st.shards.items():
                ok = cav_ok.get(key[1])
                acts[key] = (
                    [semiring.edge_activation(e, now_rel, c, ok)
                     for _, _, e, c in sh["levels"]],
                    semiring.edge_activation(sh["delta"][2], now_rel,
                                             sh["delta"][3], ok))
            no_bits = (None,) * len(self._block_meta)
            base, V = {}, {}
            for r in rows:
                dev_r = self._rows[r][0][1]
                seeds = torch.as_tensor(
                    seeds_pad[r * b_row:(r + 1) * b_row]).to(dev_r)
                base[r] = V[r] = _seed_base(meta, seeds)

            def prop_level(r, Vr, k):
                dev_r = Vr.device
                acc, n_push = None, 0
                for g, dev in self._rows[r]:
                    key = (g, _dev_key(dev))
                    sh = st.shards[key]
                    act, dact = acts[key]
                    src, dst = sh["levels"][k][0], sh["levels"][k][1]
                    Vc = Vr if dev == dev_r else Vr.to(dev)
                    prop, is_push = semiring.propagate(
                        self._block_meta, sh["blocks"], no_bits, src, dst,
                        act[k], sh["delta"][0], sh["delta"][1], dact, Vc,
                        False, level=k, mode=mode, shard=(g, self.ng))
                    n_push += is_push
                    prop = prop if dev == dev_r else prop.to(dev_r)
                    acc = prop if acc is None else torch.maximum(acc, prop)
                if mesh.row_is_split(r):
                    # the graph join across processes, outside any
                    # push/pull choice
                    _all_reduce_max(acc, mesh.row_groups[r])
                return acc, n_push

            core_progs = [p for p in meta.programs if p.level == 0]
            K = self.k_steps
            prev_changed, it, checks, n_push = 1, 0, 0, 0
            while prev_changed and it < self.max_iters:
                flags = []
                for _ in range(K):
                    for r in rows:
                        prop, p = prop_level(r, V[r], 0)
                        n_push += p
                        V2 = _apply_program(prop | base[r], core_progs)
                        flags.append((V2 != V[r]).any().to(
                            device=main, dtype=torch.int32))
                        V[r] = V2
                # step-major: [K, local rows] -> one [K] vector, joined
                # over both axes, one host read a window
                fl = torch.stack(flags).reshape(K, len(rows)).amax(dim=1)
                if mesh.multi:
                    _all_reduce_max(fl, mesh.mesh_group)
                with host_sync("iter"):
                    fl = fl.tolist()
                prev_changed = fl[-1]
                it += sum(fl)
                checks += 1
            for r in rows:
                if V[r] is base[r]:
                    V[r] = base[r].clone()  # the levels must not write base
            for k in range(1, meta.n_levels + 1):
                progs_k = [p for p in meta.programs if p.level == k]
                for r in rows:
                    prop, p = prop_level(r, V[r], k)
                    n_push += p
                    propb = prop | base[r]
                    Vr = V[r]
                    for off, size in meta.level_ranges[k - 1]:
                        Vr[:, off:off + size] = propb[:, off:off + size]
                    V[r] = _apply_program(Vr, progs_k)
            out = torch.zeros((B_pad, q_pad), dtype=torch.uint8, device=main)
            for r in rows:
                q = grid[r]
                brange = torch.arange(b_row, device=q.device)[:, None]
                out[r * b_row:(r + 1) * b_row] = V[r][brange, q].to(main)
            if mesh.gather_rows:
                # rows of data shards held elsewhere are zero here: a MAX
                # join is the all-gather over the data axis
                _all_reduce_max(out, mesh.mesh_group)
            flat = out.reshape(-1)
            if missing is not None:
                flat = torch.cat([flat, missing.to(main).reshape(1).view(
                    torch.uint8)])
        converged = prev_changed == 0
        # the window flags count CHANGING steps; the single-device loop
        # also pays and counts one confirming no-op step: count it here
        iters = it + int(converged)
        return flat, converged, iters, checks, n_push, missing is not None

    def _request_arrays(self, context: Optional[dict],
                        cav_req: Optional[tuple], now_abs: float) -> tuple:
        """The request-context arrays of this dispatch (replicated); a
        pre-encoded ``cav_req`` (chunked bulk callers) wins."""
        cavt = self.cg.caveats
        if cavt is None or not cavt.metas:
            return ()
        if cav_req is not None:
            return cav_req
        req, _ = cavt.encode_request(context, now_abs)
        return req

    def _pad_rows(self, B: int) -> int:
        B_pad = max(_next_bucket(B, 1), self.nd)
        if B_pad % self.nd:
            B_pad = ((B_pad + self.nd - 1) // self.nd) * self.nd
        return B_pad

    def _grid_rows(self, grid_np: np.ndarray) -> dict:
        """The query grid's rows of each local data row, on its device."""
        b_row = grid_np.shape[0] // self.nd
        return {r: torch.as_tensor(grid_np[r * b_row:(r + 1) * b_row]).to(
                    device=self._rows[r][0][1], dtype=torch.int64)
                for r in self._rows}

    def query_grid(
        self,
        seed_slots: np.ndarray,  # int32 [B, 2] (subject slot, wildcard slot)
        q_slots: np.ndarray,  # int32 [B, Q] result slots per subject
        now: Optional[float] = None,
        context: Optional[dict] = None,
    ) -> np.ndarray:
        """Run the sharded fixpoint; returns bool [B, Q]."""
        cg = self.cg
        B, Q = q_slots.shape
        B_pad = self._pad_rows(B)
        Q_pad = _next_bucket(Q, 8)
        seeds = np.full((B_pad, 2), cg.M, dtype=np.int64)
        seeds[:B] = seed_slots
        qs = np.full((B_pad, Q_pad), cg.M, dtype=np.int64)
        qs[:B, :Q] = q_slots
        now_abs = time.time() if now is None else now
        flat, conv, iters, checks, n_push, cav = self._dispatch(
            seeds, self._grid_rows(qs), Q_pad, now_abs,
            self._request_arrays(context, None, now_abs))
        fut = ShardedQueryFuture(flat, (B_pad, Q_pad), conv, iters, None,
                                 self.max_iters, self.k_steps, checks,
                                 n_push, cav)
        return fut.result()[:B, :Q]

    def query_async(
        self,
        seed_slots: np.ndarray,  # int32 [B, 2]
        q_slots: np.ndarray,  # int32 [Q] flat result slots
        q_batch: np.ndarray,  # int32 [Q] batch row per query
        now: Optional[float] = None,
        q_cache_key: Optional[tuple] = None,
        q_contiguous: Optional[bool] = None,
        q_contig_grid: Optional[tuple] = None,  # (lo, L, R): R rows x
        # one shared [lo, lo+L) window (the fused-batch shape)
        context: Optional[dict] = None,
        cav_req: Optional[tuple] = None,
    ) -> ShardedQueryFuture:
        """The engine's flat form (``CompiledGraph.query_async``'s
        surface): the flat ``(q_slots, q_batch)`` queries are packed into
        a ``[B, Qmax]`` grid (each query's rank within its row), the
        fixpoint runs, and the future maps the grid back to flat order.
        A one-window query (``q_contiguous`` of one row, or the batcher's
        ``q_contig_grid`` promise) skips the rank computation: its grid
        rows are the window and the row-major grid slice is the flat
        order; a promise that does not fit falls back to the ranks."""
        cg = self.cg
        B = seed_slots.shape[0]
        q_slots = np.asarray(q_slots, dtype=np.int64)
        q_batch = np.asarray(q_batch, dtype=np.int64)
        Q = len(q_slots)
        if (q_contig_grid is None and q_contiguous and Q and B == 1
                and not q_batch[0]):
            q_contig_grid = (int(q_slots[0]), Q, 1)
        contig = None
        if q_contig_grid is not None:
            lo, L, R = q_contig_grid
            if Q == L * R and 0 < L and 0 < R <= B and lo + L <= cg.M:
                contig = (lo, L, R)
        if contig is not None:
            lo, L, R = contig
            cols = None
            Qmax = L
        elif Q:
            # rank of each query within its batch row (stable)
            order = np.argsort(q_batch, kind="stable")
            sorted_qb = q_batch[order]
            starts = np.flatnonzero(np.r_[True, np.diff(sorted_qb) != 0])
            run_len = np.diff(np.r_[starts, Q])
            grp_start = np.repeat(starts, run_len)
            rank_sorted = np.arange(Q) - grp_start
            cols = np.empty(Q, dtype=np.int64)
            cols[order] = rank_sorted
            Qmax = int(rank_sorted.max()) + 1
        else:
            cols = np.empty(0, dtype=np.int64)
            Qmax = 1
        B_pad = self._pad_rows(B)
        Q_pad = _next_bucket(Qmax, 8)
        seeds = np.full((B_pad, 2), cg.M, dtype=np.int64)
        seeds[:B] = seed_slots
        qkey = (q_cache_key, B_pad) if q_cache_key else None
        grid = self._state.qgrid.get(qkey) if qkey else None
        if grid is None:
            grid_np = np.full((B_pad, Q_pad), cg.M, dtype=np.int64)
            if contig is not None:
                grid_np[:R, :L] = lo + np.arange(L, dtype=np.int64)
            else:
                grid_np[q_batch, cols] = q_slots
            grid = self._grid_rows(grid_np)
            if qkey:
                qgrid = self._state.qgrid
                # bounded: grids pin device memory per distinct key
                if len(qgrid) >= 32:
                    qgrid.pop(next(iter(qgrid), None), None)
                qgrid[qkey] = grid
        now_abs = time.time() if now is None else now
        flat, conv, iters, checks, n_push, cav = self._dispatch(
            seeds, grid, Q_pad, now_abs,
            self._request_arrays(context, cav_req, now_abs))
        sel = (("contig_grid", L, R) if contig is not None
               else (q_batch, cols))
        return ShardedQueryFuture(flat, (B_pad, Q_pad), conv, iters, sel,
                                  self.max_iters, self.k_steps, checks,
                                  n_push, cav)
