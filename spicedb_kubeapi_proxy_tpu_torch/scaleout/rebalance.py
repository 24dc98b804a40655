"""Online shard rebalancing: the live tuple mover.

A copy of the JAX package's ``scaleout/rebalance.py``. The shard map is
an explicit versioned artifact; changing it without a mover would mean
"drain writes + dump/reload the moved slices" — a full stop for the
affected namespaces. This module takes the fleet from map V to
map V+1 **without draining**, the standard shared-nothing
copy/catch-up/cutover protocol (the blocked-matrix repartitioning story
in RedisGraph/GraphBLAS: move blocks, not the world):

1. **plan** — diff the two maps' ring assignments into the *moving
   slice set*: contiguous hash ranges of the partition-key space whose
   owner changes, each ``src -> dst``. Global (cluster-scoped) tuples
   never move — they replicate everywhere by construction; a transition
   that ADDS groups seeds them a replica first.
2. **copy** — export each slice from its source group and import it
   into the destination (``slice_read``/``slice_load`` wire ops riding
   the npz codec of persistence/codec.py; idempotent — loads are
   TOUCHes). Migration traffic is admission-classed (``rebalance``,
   lowest shed priority) so it is cost-accounted and sheddable like any
   tenant; sheds back the mover off by the host's Retry-After.
3. **catch-up** — replay the source group's watch history for the
   slice above the copy revision onto the destination (last-per-key
   within a batch; deletes replay too) until the lag is small.
4. **dual-write window** — the planner keeps ROUTING READS at V while
   MIRRORING the slice's writes to both owners through the existing
   split journal, so a mid-window crash of planner or group replays to
   completion rather than forking the copies.
5. **cutover** — per-slice atomic flip: briefly freeze the slice's
   writes (non-moving slices never wait), drain the final catch-up to
   lag zero, record the (src, dst) cut revisions, persist CUT, thaw.
   Reads and writes for the slice now route at V+1.
6. **GC** — once every slice is cut and the planner committed map
   V+1, the source groups drop their moved rows (ordinary journaled
   deletes; the merged watch streams suppress them — see below).

**Watch continuity.** Merged watch streams stay gap-and-duplicate-free
across the flip: for a moving slice, events are delivered from the
slice's *current read owner only* — source events up to its cut
revision, destination events strictly after its cut revision (which
silences the copy/catch-up touches, the dual-write mirrors, and the GC
deletes). Resumption tokens carry the map version they were minted
under (``RevisionVector.encode(map_version=)``); a token from map V
resumed at V+1 is *translated* through the recorded transition (new
groups' components start at zero) instead of misindexed.

**Crash matrix**: the transition state is persisted in
the split journal's sqlite next to every slice-state change. A crash
before any slice cut → the transition ABORTS cleanly (routing still V;
the destination's partial copies are dropped). A crash after ≥1 slice
cut → the transition is past the point of no return and RESUMES to
completion at the next boot (cut slices' routing is restored before
the first request). Either way: no acked write lost, never fail-open.
"""

from __future__ import annotations

import threading
import time
from bisect import bisect_right
from dataclasses import dataclass, field
from typing import Optional

from ..admission import AdmissionRejected
from ..engine.store import OP_DELETE, WriteOp
from ..utils.metrics import metrics
from .shardmap import (
    HASH_SPACE,
    ShardMap,
    ShardMapError,
    hash_key,
    map_from_doc,
    map_to_doc,
    split_resource,
)

import logging

log = logging.getLogger("sdbkp.torch.rebalance")

# slice lifecycle (monotone; persisted on every change)
PLANNED = "planned"
COPYING = "copying"
CATCHUP = "catchup"
DUAL = "dual"
CUT = "cut"

_STATE_ORDER = (PLANNED, COPYING, CATCHUP, DUAL, CUT)


class RebalanceError(ShardMapError):
    pass


@dataclass
class MovingSlice:
    """One contiguous hash-range move ``src -> dst`` under a map
    transition. ``ranges`` are half-open ``[lo, hi)`` intervals over
    the 32-bit partition-key space (a slice that wraps the ring is two
    intervals)."""

    sid: int
    src: int
    dst: int
    ranges: tuple  # ((lo, hi), ...)
    state: str = PLANNED
    copy_rev: int = 0       # src revision at the copy cut
    replayed: int = 0       # src revision caught up through
    src_head: int = 0       # src revision last observed (lag basis)
    src_cut: Optional[int] = None  # src revision at the flip
    dst_cut: Optional[int] = None  # dst revision at the flip
    gate: "_SliceGate" = field(default_factory=lambda: _SliceGate(),
                               repr=False, compare=False)

    def contains(self, h: int) -> bool:
        return any(lo <= h < hi for lo, hi in self.ranges)

    def to_doc(self) -> dict:
        return {"sid": self.sid, "src": self.src, "dst": self.dst,
                "ranges": [list(r) for r in self.ranges],
                "state": self.state, "copy_rev": self.copy_rev,
                "replayed": self.replayed,
                "src_head": self.src_head,
                "src_cut": self.src_cut,
                "dst_cut": self.dst_cut}

    @classmethod
    def from_doc(cls, d: dict) -> "MovingSlice":
        return cls(sid=int(d["sid"]), src=int(d["src"]),
                   dst=int(d["dst"]),
                   ranges=tuple((int(lo), int(hi))
                                for lo, hi in d["ranges"]),
                   state=str(d["state"]), copy_rev=int(d["copy_rev"]),
                   replayed=int(d["replayed"]),
                   src_head=int(d.get("src_head", 0)),
                   src_cut=(None if d.get("src_cut") is None
                            else int(d["src_cut"])),
                   dst_cut=(None if d.get("dst_cut") is None
                            else int(d["dst_cut"])))


class _SliceGate:
    """A tiny writer/freezer gate: writes to a moving slice ``enter``
    (shared — unbounded concurrency), the cutover ``freeze``s (waits
    out in-flight writers, blocks new ones) for the atomic flip, then
    ``thaw``s. Writes to NON-moving slices never touch a gate, so the
    freeze costs only the moving slice's traffic."""

    def __init__(self):
        self._cv = threading.Condition()
        self._writers = 0
        self._frozen = False

    def enter(self) -> None:
        with self._cv:
            while self._frozen:
                self._cv.wait()
            self._writers += 1

    def exit(self) -> None:
        with self._cv:
            self._writers -= 1
            self._cv.notify_all()

    def freeze(self) -> None:
        with self._cv:
            self._frozen = True
            while self._writers:
                self._cv.wait()

    def thaw(self) -> None:
        with self._cv:
            self._frozen = False
            self._cv.notify_all()


def shrink_map(old_map: ShardMap, retire: Optional[int] = None,
               version: Optional[int] = None) -> ShardMap:
    """The one-group-smaller target map of a SHRINK transition:
    ``old_map`` minus the retiring group (default: the LAST one — the
    only index whose removal leaves every survivor's ring points, and
    so every survivor's data placement, untouched)."""
    if old_map.n_groups < 2:
        raise RebalanceError("cannot shrink a single-group map")
    if retire is None:
        retire = old_map.n_groups - 1
    if not 0 <= retire < old_map.n_groups:
        raise RebalanceError(
            f"retire index {retire} out of range for a "
            f"{old_map.n_groups}-group map")
    groups = old_map.groups[:retire] + old_map.groups[retire + 1:]
    return ShardMap(
        version=old_map.version + 1 if version is None else int(version),
        groups=groups, virtual_nodes=old_map.virtual_nodes)


def plan_moves(old_map: ShardMap, new_map: ShardMap,
               retire: Optional[int] = None) -> list:
    """Diff two maps' ring assignments into the moving slice set:
    merge both rings' boundary points, sample each segment's owner
    under both maps, and coalesce adjacent segments with the same
    ``(src, dst)``. Group INDEX is identity across the transition —
    group *i* of the new map is the same logical group as group *i*
    of the old (new maps may append groups; surviving indices keep
    their data except for the diffed slices).

    A SHRINK diff names the ``retire``-d group: the new map has one
    fewer group and its indices renumber past the gap, so new-map
    owners translate back into the OLD index space (``ni`` -> ``ni``
    below the gap, ``ni + 1`` at or above it) — the emitted slices'
    ``src``/``dst`` always address the planner's CURRENT clients, and
    every slice the retiring group owned moves off it."""
    bounds = sorted(set(old_map.ring_points())
                    | set(new_map.ring_points()))
    if not bounds:
        return []

    def _dst(h: int) -> int:
        ni = new_map.owner_of_hash(h)
        if retire is not None and ni >= retire:
            return ni + 1
        return ni

    segs = []  # (lo, hi, src, dst) half-open over [0, HASH_SPACE)
    # segment starting at each boundary, up to the next one; the ring
    # wraps, so the last boundary's segment splits into [last, 2^32)
    # and [0, first)
    for i, lo in enumerate(bounds):
        hi = bounds[i + 1] if i + 1 < len(bounds) else HASH_SPACE
        src = old_map.owner_of_hash(lo)
        dst = _dst(lo)
        if src != dst:
            segs.append((lo, hi, src, dst))
    lo0 = bounds[0]
    if lo0 > 0:
        src = old_map.owner_of_hash(0)
        dst = _dst(0)
        if src != dst:
            segs.append((0, lo0, src, dst))
    segs.sort()
    # coalesce adjacent segments moving the same way into one slice,
    # then group every (src, dst) pair's ranges into ONE slice so the
    # protocol runs once per directed move, not once per ring fragment
    merged: dict[tuple, list] = {}
    for lo, hi, src, dst in segs:
        rs = merged.setdefault((src, dst), [])
        if rs and rs[-1][1] == lo:
            rs[-1] = (rs[-1][0], hi)
        else:
            rs.append((lo, hi))
    out = []
    for sid, ((src, dst), rs) in enumerate(sorted(merged.items())):
        out.append(MovingSlice(sid=sid, src=src, dst=dst,
                               ranges=tuple(rs)))
    return out


class MapTransition:
    """The versioned-transition state the planner routes through while
    a rebalance is live: which slices are moving, how far each has
    progressed, and the event-delivery filter that keeps merged watch
    streams exact across the flip. Thread-safe; every state change is
    persisted by the coordinator before it takes routing effect."""

    def __init__(self, old_map: ShardMap, new_map: ShardMap,
                 slices: list, retire: Optional[int] = None):
        if new_map.version <= old_map.version:
            raise RebalanceError(
                f"rebalance target map version {new_map.version} must "
                f"exceed the current version {old_map.version}")
        if retire is None and new_map.n_groups < old_map.n_groups:
            raise RebalanceError(
                "a transition to a smaller map must name the retiring "
                "group (plan it through begin_rebalance / shrink_map)")
        if retire is not None:
            if new_map.n_groups != old_map.n_groups - 1:
                raise RebalanceError(
                    "a shrink transition retires exactly ONE group per "
                    f"map version (old {old_map.n_groups} groups, new "
                    f"{new_map.n_groups})")
            if not 0 <= retire < old_map.n_groups:
                raise RebalanceError(
                    f"retire index {retire} out of range for a "
                    f"{old_map.n_groups}-group map")
        self.old_map = old_map
        self.new_map = new_map
        # SHRINK: the OLD-space index of the group this transition
        # empties and removes (None for grow/steady transitions). The
        # slices' src/dst stay in old index space throughout — the
        # planner renumbers only at commit.
        self.retire = retire
        # set at commit: the retiring group's final delivered revision
        # (max src-side cut over its outgoing slices) — the watermark
        # resumption-token translation checks before dropping the
        # component (a token below it missed src-era events that no
        # surviving group will ever re-deliver)
        self.retire_cut: Optional[int] = None
        self.slices = list(slices)
        self._lock = threading.Lock()
        # bumped on every slice-state change (the planner's read-routing
        # epoch, ShardedEngine._route_epoch)
        self.generation = 0
        # range index for slice_for: sorted (lo, hi, slice)
        ivals = []
        for sl in self.slices:
            for lo, hi in sl.ranges:
                ivals.append((lo, hi, sl))
        ivals.sort(key=lambda t: t[0])
        self._los = [t[0] for t in ivals]
        self._ivals = ivals
        # groups the NEW map adds (their stores start empty; the
        # coordinator seeds the replicated global tuples first)
        self.new_groups = tuple(range(old_map.n_groups,
                                      new_map.n_groups))
        # gi -> the group's revision after its global seed landed:
        # global-tuple events on an added group at or below this are
        # seed echoes of tuples every watcher already saw replicated
        # on the old groups — suppressed from merged streams
        self.seed_cuts: dict = {}
        self.globals_seeded = threading.Event()
        if not self.new_groups:
            self.globals_seeded.set()
        # True once the post-cutover GC finished: no source group holds
        # a moved copy anymore, so the planner's scatter-merge owner
        # filters have nothing left to guard against for this
        # transition (the watch-delivery era walk stays — history
        # replays still span the cutover)
        self.gc_complete = False

    def retire_watermark(self) -> Optional[int]:
        """The retiring group's final delivered revision: the max
        src-side cut over its outgoing slices (0 when it owned no
        moving slice). A resumption token whose retiring component is
        at or past this has consumed every event the group's eras will
        ever deliver — everything later lives in the destinations'
        histories past their dst cuts."""
        if self.retire is None:
            return None
        return max((int(sl.src_cut or 0) for sl in self.slices
                    if sl.src == self.retire), default=0)

    # -- membership ----------------------------------------------------------

    def slice_for(self, resource_type: str,
                  resource_id: str) -> Optional[MovingSlice]:
        ns, namespaced = split_resource(resource_id)
        if not namespaced:
            return None
        return self.slice_for_key(ns, resource_type)

    def slice_for_key(self, namespace: str,
                      resource_type: str) -> Optional[MovingSlice]:
        h = hash_key(namespace, resource_type)
        i = bisect_right(self._los, h) - 1
        if i >= 0:
            lo, hi, sl = self._ivals[i]
            if lo <= h < hi:
                return sl
        return None

    # -- slice state (locked) ------------------------------------------------

    def set_state(self, sl: MovingSlice, state: str, **fields) -> None:
        with self._lock:
            if state != sl.state:
                # a read owner or write owner may change with the state:
                # the planner re-runs a gather that straddled it
                self.generation += 1
            sl.state = state
            for k, v in fields.items():
                setattr(sl, k, v)

    def state_of(self, sl: MovingSlice) -> str:
        with self._lock:
            return sl.state

    def all_cut(self) -> bool:
        with self._lock:
            return all(sl.state == CUT for sl in self.slices)

    def any_cut(self) -> bool:
        with self._lock:
            return any(sl.state == CUT for sl in self.slices)

    def progress(self) -> dict:
        """The /readyz ``rebalance:`` line's numbers."""
        with self._lock:
            moving = len(self.slices)
            copied = sum(1 for sl in self.slices
                         if _STATE_ORDER.index(sl.state)
                         >= _STATE_ORDER.index(CATCHUP))
            cut = sum(1 for sl in self.slices if sl.state == CUT)
            # catch-up distance of the in-flight slices: the source
            # head last observed minus the replay watermark (copy_rev
            # is a floor the watermark starts AT, never ahead of)
            lag = max((sl.src_head - sl.replayed
                       for sl in self.slices
                       if sl.state in (COPYING, CATCHUP, DUAL)),
                      default=0)
        return {"to_version": self.new_map.version, "moving": moving,
                "copied": copied, "cut": cut, "lag": max(0, lag)}

    # -- routing -------------------------------------------------------------

    def read_owner(self, sl: MovingSlice) -> int:
        """Reads route at V until the slice's atomic flip, at V+1
        after."""
        with self._lock:
            return sl.dst if sl.state == CUT else sl.src

    def write_owners(self, sl: MovingSlice) -> tuple:
        """Writes route at V before the dual-write window opens,
        mirror to BOTH owners during it, and route at V+1 after the
        flip."""
        with self._lock:
            if sl.state == CUT:
                return (sl.dst,)
            if sl.state == DUAL:
                return (sl.src, sl.dst)
            return (sl.src,)

    # -- watch-event delivery filter -----------------------------------------
    # The read-owner-only delivery rule is evaluated by the PLANNER as
    # an era walk over the whole transition sequence (a slice can move
    # A->B in one transition and B->A in a later one — a single
    # transition's view would suppress the later era's legitimate
    # events). Each transition contributes its cut table via
    # ``cut_info`` and the group-local global-seed guard below.

    def cut_info(self, sl: MovingSlice) -> tuple:
        """(state, src_cut, dst_cut) snapshot for the era walk."""
        with self._lock:
            return sl.state, sl.src_cut, sl.dst_cut

    def deliver_global(self, gi: int, revision: int) -> bool:
        """A GLOBAL tuple's event on a transition-added group: the seed
        copy (and anything before it completed) is an echo of tuples
        every watcher already saw replicated on the old groups; genuine
        post-seed global writes replicate there like everywhere."""
        if gi not in self.new_groups:
            return True
        with self._lock:
            cut = self.seed_cuts.get(gi)
        return cut is not None and revision > cut

    # -- persistence ---------------------------------------------------------

    def to_doc(self, phase: str = "running") -> dict:
        with self._lock:
            seed_cuts = {str(k): v for k, v in self.seed_cuts.items()}
        return {"phase": phase,
                "old_version": self.old_map.version,
                "new_map": map_to_doc(self.new_map),
                "seed_cuts": seed_cuts,
                "retire": self.retire,
                "retire_cut": self.retire_cut,
                # shrink runs GC BEFORE commit (old indices must still
                # name the mover's clients), so the crash matrix needs
                # the GC watermark durably, not implied by the phase
                "gc_complete": bool(self.gc_complete),
                "slices": [sl.to_doc() for sl in self.slices]}

    @classmethod
    def from_doc(cls, doc: dict, old_map: ShardMap) -> "MapTransition":
        if int(doc["old_version"]) != old_map.version:
            raise RebalanceError(
                f"persisted transition left map version "
                f"{doc['old_version']}, but the planner booted with "
                f"version {old_map.version}; refusing to guess which "
                "placement is authoritative")
        new_map = map_from_doc(doc["new_map"])
        t = cls(old_map, new_map,
                [MovingSlice.from_doc(d) for d in doc["slices"]],
                retire=(None if doc.get("retire") is None
                        else int(doc["retire"])))
        t.retire_cut = (None if doc.get("retire_cut") is None
                        else int(doc["retire_cut"]))
        t.gc_complete = bool(doc.get("gc_complete", False))
        t.seed_cuts = {int(k): int(v)
                       for k, v in (doc.get("seed_cuts") or {}).items()}
        # a restart loses the in-memory seeded latch (the coordinator
        # re-seeds idempotently on resume anyway)
        if t.seed_cuts:
            t.globals_seeded.set()
        return t


class RebalanceCoordinator:
    """Drives one map transition end to end on a background thread.
    All data movement is idempotent (touch loads, last-per-key catch-up
    replays, delete GC), so every phase is safe to re-run after a crash
    of the coordinator or a failover inside either group."""

    def __init__(self, planner, transition: MapTransition, *,
                 batch_rows: int = 2048, pace_seconds: float = 0.0,
                 cut_lag: int = 8, poll_seconds: float = 0.05):
        self.planner = planner
        self.t = transition
        self.batch_rows = max(1, int(batch_rows))
        # optional pacing between copy/catch-up batches: stretches the
        # move so migration bandwidth stays a bounded fraction of the
        # hosts' capacity even before admission pushes back
        self.pace_seconds = max(0.0, float(pace_seconds))
        # catch-up converges to this lag (in src revisions) before the
        # freeze; the frozen drain then takes lag -> 0
        self.cut_lag = max(0, int(cut_lag))
        self.poll_seconds = max(0.005, float(poll_seconds))
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._pause = threading.Event()
        self._in_cutover = False
        self._done = threading.Event()
        self.error: Optional[BaseException] = None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "RebalanceCoordinator":
        self._thread = threading.Thread(target=self._run,
                                        name="shard-rebalance",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        """Ask the mover to park (the persisted state stays; a later
        coordinator — or the next boot — resumes or aborts by the
        crash matrix)."""
        self._stop.set()

    def pause(self) -> None:
        """Suspend data movement in place (operator lever: quiesce a
        migration during an incident without losing its progress).
        Routing keeps whatever state each slice already reached; the
        one non-pausable stretch is a cutover's frozen drain — it
        completes first, because pausing it would leave the slice's
        writers parked on the gate."""
        self._pause.set()

    def resume(self) -> None:
        self._pause.clear()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)

    def _run(self) -> None:
        try:
            self.run_to_completion()
        except BaseException as e:  # noqa: BLE001 - surfaced via .error
            # the mover is a background maintenance loop: its failure
            # must park the transition VISIBLY (state persisted, routing
            # unchanged, /readyz still reporting the window) rather
            # than unwind the serving path. The crash matrix takes it
            # from here: resume-or-abort at the next coordinator/boot.
            self.error = e
            metrics.counter("scaleout_rebalance_transitions_total",
                            outcome="failed").inc()
            log.exception("rebalance to map v%d parked: %s",
                          self.t.new_map.version, e)
        finally:
            self._done.set()

    # -- helpers -------------------------------------------------------------

    def _client(self, gi: int):
        return self.planner.groups[gi]

    def _persist(self, phase: str = "running") -> None:
        j = self.planner.journal
        if j is not None:
            j.save_transition(self.t.to_doc(phase))

    def _backoff(self, e: AdmissionRejected) -> None:
        metrics.counter("scaleout_rebalance_shed_backoff_total").inc()
        self._sleep(min(5.0, max(0.05, float(e.retry_after or 0.25))))

    def _sleep(self, s: float) -> None:
        if s > 0:
            self._stop.wait(s)

    def _check_stop(self) -> None:
        if self._stop.is_set():
            raise RebalanceError("rebalance coordinator stopped")
        while self._pause.is_set() and not self._in_cutover:
            if self._stop.is_set():
                raise RebalanceError("rebalance coordinator stopped")
            time.sleep(0.02)

    def _call_shed_aware(self, fn):
        """Run one mover op; admission sheds back the mover off and
        retry — migration traffic yields to tenant traffic by design,
        it never fails the transition."""
        while True:
            self._check_stop()
            try:
                return fn()
            except AdmissionRejected as e:
                self._backoff(e)
                continue

    # -- slice data plane (native wire ops, or the in-process fallback) ------

    def _slice_read(self, gi: int, ranges, want_globals=False):
        """(src_revision, [Relationship...]) for the slice."""
        c = self._client(gi)
        if hasattr(c, "slice_read"):
            return self._call_shed_aware(
                lambda: c.slice_read(ranges, want_globals=want_globals))
        return _local_slice_read(c, ranges, want_globals=want_globals)

    def _slice_load(self, gi: int, rels) -> int:
        """Idempotent TOUCH import, chunked; returns rows loaded."""
        c = self._client(gi)
        n = 0
        for i in range(0, len(rels), self.batch_rows):
            chunk = rels[i:i + self.batch_rows]
            self._check_stop()
            if hasattr(c, "slice_load"):
                self._call_shed_aware(lambda _c=chunk: c.slice_load(_c))
            else:
                self._call_shed_aware(
                    lambda _c=chunk: _apply_po2_local(
                        c, [WriteOp("touch", r) for r in _c]))
            n += len(chunk)
            metrics.counter(
                "scaleout_rebalance_copied_rows_total").inc(len(chunk))
            self._sleep(self.pace_seconds)
        return n

    def _slice_drop(self, gi: int, ranges) -> int:
        """GC: delete the moved rows from the source through its
        ordinary journaled/replicated write path (the merged watch
        streams suppress these deletes past the slice's cut)."""
        c = self._client(gi)
        if hasattr(c, "slice_drop"):
            n = self._call_shed_aware(lambda: c.slice_drop(ranges))
        else:
            _, rows = _local_slice_read(c, ranges)
            n = 0
            for i in range(0, len(rows), self.batch_rows):
                chunk = rows[i:i + self.batch_rows]
                self._call_shed_aware(
                    lambda _c=chunk: _apply_po2_local(
                        c, [WriteOp("delete", r) for r in _c]))
                n += len(chunk)
        metrics.counter("scaleout_rebalance_gc_rows_total").inc(n)
        return n

    def _src_revision(self, gi: int) -> int:
        rev = self._call_shed_aware(
            lambda: self._client(gi).revision)
        return int(rev)

    _REPLAY_CHUNK = 2048

    def _catch_up_once(self, sl: MovingSlice,
                       frozen: bool = False) -> int:
        """Replay one round of src watch history above ``replayed``
        onto dst (slice-filtered, last-per-key); returns the remaining
        lag in src revisions. ``frozen`` marks the cutover drain (the
        slice's writers are parked on the gate until it ends)."""
        src = self._client(sl.src)
        if hasattr(src, "slice_watch_since"):
            events = self._call_shed_aware(
                lambda: src.slice_watch_since(int(sl.replayed)))
        else:
            events = self._call_shed_aware(
                lambda: src.watch_since(int(sl.replayed)))
        last = sl.replayed
        final: dict[tuple, tuple] = {}
        for e in events:
            rev = int(e.revision)
            last = max(last, rev)
            rel = e.relationship
            if not sl.contains(hash_key(
                    split_resource(rel.resource_id)[0],
                    rel.resource_type)):
                continue
            # the Engine surface (and the wire) stamp events with the
            # STRING op; the store's raw records carry the int code —
            # accept both, and treat only a positive delete as one (a
            # replayed delete mis-read as touch would resurrect the
            # revoked grant on the new owner)
            op = "delete" if e.operation in ("delete", OP_DELETE) \
                else "touch"
            final[rel.key()] = (op, rel)
        if final:
            # ONE write op per round when the backlog fits: the
            # destination pays per-OP cost (incremental device update),
            # so batching the round's backlog is strictly cheaper than
            # trickling it — the round CADENCE (poll_seconds) is the
            # politeness knob here, while replay bandwidth is inherently
            # 1:1 with the slice's own write rate, never a bulk copy
            ops = [WriteOp(op, rel) for op, rel in final.values()]
            dst = self._client(sl.dst)
            for i in range(0, len(ops), self._REPLAY_CHUNK):
                chunk = ops[i:i + self._REPLAY_CHUNK]
                if hasattr(dst, "slice_apply"):
                    self._call_shed_aware(
                        lambda _c=chunk: dst.slice_apply(_c))
                else:
                    self._call_shed_aware(
                        lambda _c=chunk: _apply_po2_local(dst, _c))
            metrics.counter(
                "scaleout_rebalance_replayed_events_total").inc(
                    len(ops))
        head = self._src_revision(sl.src)
        self.t.set_state(sl, sl.state, replayed=last,
                         src_head=int(head))
        lag = max(0, head - last)
        metrics.gauge("scaleout_rebalance_lag_revisions").set(lag)
        return lag

    # -- the protocol --------------------------------------------------------

    def run_to_completion(self) -> None:
        t0 = time.monotonic()
        metrics.gauge("scaleout_rebalance_active").set(1)
        metrics.gauge("scaleout_rebalance_slices_moving").set(
            len(self.t.slices))
        try:
            self._persist()
            self._seed_globals()
            for sl in self.t.slices:
                if self.t.state_of(sl) != CUT:
                    self._move_slice(sl)
            if self.t.retire is not None:
                # SHRINK: GC runs BEFORE commit — the slices' src/dst
                # are OLD-space indices, and commit removes the retiring
                # group from the planner's client list, so post-commit
                # the mover could no longer address the sources. Safe
                # ordering: every slice is cut (reads/writes route to
                # dst), the active transition keeps the scatter-merge
                # owner filter up, and the era filter suppresses the GC
                # deletes — exactly the grow-GC guarantees, one phase
                # earlier. A crash in here resumes via any/all-cut with
                # the persisted gc_complete deciding whether GC re-runs
                # (idempotent deletes either way).
                if not self.t.gc_complete:
                    self._gc()
                    self.t.gc_complete = True
                    self._persist()
                self.planner.commit_rebalance(self.t)
            else:
                self.planner.commit_rebalance(self.t)
                self._persist("committed")
                self._gc()
                self.t.gc_complete = True
            # the record flips to phase "done" instead of clearing:
            # a restart whose CLI flags still say --shard-map V
            # --rebalance-to V+1 must find durable proof that V+1 is
            # already authoritative — re-running the move against the
            # GC'd source would route the moved slices to empty groups
            # (an authorization outage). The record clears only when a
            # boot sees --shard-map naming the new version itself.
            self._persist("done")
            metrics.counter("scaleout_rebalance_transitions_total",
                            outcome="completed").inc()
            log.info("rebalance to map v%d complete in %.2fs",
                     self.t.new_map.version, time.monotonic() - t0)
        finally:
            metrics.gauge("scaleout_rebalance_active").set(0)
            metrics.gauge("scaleout_rebalance_lag_revisions").set(0)

    def _seed_globals(self) -> None:
        """A transition that ADDS groups first gives each new group the
        replicated global slice (idempotent TOUCH copy from group 0;
        concurrent global writes already mirror to new groups from the
        moment the transition installed)."""
        if not self.t.new_groups:
            return
        _, rows = self._slice_read(0, (), want_globals=True)
        for gi in self.t.new_groups:
            self._slice_load(gi, rows)
            # the seed cut: the group's revision once its global
            # replica is complete — merged streams suppress the seed's
            # echo events at or below it
            cut = self._src_revision(gi)
            with self.t._lock:
                self.t.seed_cuts[gi] = cut
        self.t.globals_seeded.set()
        self._persist()

    def _move_slice(self, sl: MovingSlice) -> None:
        t0 = time.monotonic()
        # resuming a crash-interrupted slice: the persisted ``replayed``
        # watermark is where delete coverage on the destination ENDS. A
        # re-copy reflects deletions only by absence — it never removes
        # the destination's stale copy of a tuple deleted between the
        # old watermark and the new copy cut — so catch-up must restart
        # from the OLD watermark, not the fresh copy revision (replay
        # is last-per-key idempotent; a trimmed watch history there
        # fails loud instead of resuming with a fail-open hole)
        resume_from = int(sl.replayed) if sl.copy_rev else None
        # copy = REPLACE: drop whatever the destination already holds
        # in the slice's ranges first. Stale leftovers (an earlier
        # transition aborted with the destination unreachable, a
        # crash-window mirror) are indistinguishable from live rows to
        # the load's touches — without the drop, a tuple REVOKED on the
        # source between that leftover and this copy would survive on
        # the new owner (the copy reflects deletions only by absence).
        self.t.set_state(sl, COPYING)
        self._persist()
        self._slice_drop(sl.dst, sl.ranges)
        # copy: revision FIRST, rows second — anything that lands
        # between the two shows up in the catch-up replay (touches are
        # idempotent, at-least-once)
        copy_rev, rows = self._slice_read(sl.src, sl.ranges)
        self._slice_load(sl.dst, rows)
        start = int(copy_rev) if resume_from is None \
            else min(resume_from, int(copy_rev))
        self.t.set_state(sl, CATCHUP, copy_rev=int(copy_rev),
                         replayed=start)
        self._persist()
        # catch-up until the replay is close to the src head
        while self._catch_up_once(sl) > self.cut_lag:
            self._sleep(self.poll_seconds)
        # dual-write window: new writes mirror to both owners from here
        # (through the split journal — a crash replays to completion);
        # one more catch-up pass covers the gap between the last replay
        # and the window opening
        self.t.set_state(sl, DUAL)
        self._persist()
        while self._catch_up_once(sl) > self.cut_lag:
            self._sleep(self.poll_seconds)
        # cutover: freeze the slice's writes, drain to lag zero, record
        # the cut revisions, persist CUT (the point of no return for
        # this slice), flip routing, thaw
        sl.gate.freeze()
        self._in_cutover = True
        try:
            while self._catch_up_once(sl, frozen=True) > 0:
                # the slice's writers are parked on the gate, so the
                # head stops advancing almost immediately; the tiny
                # sleep keeps this drain from spinning wire ops at the
                # source while it waits for that instant
                time.sleep(0.01)
            src_cut = self._src_revision(sl.src)
            dst_cut = self._src_revision(sl.dst)
            # persist CUT BEFORE it takes routing effect (the class
            # contract): the gate is frozen, so no writer can observe
            # the in-between — but a persist failure here must park the
            # coordinator with routing STILL at DUAL, never serve a
            # flip the durable record doesn't know about (a later boot
            # would route reads back to a source that missed dst-only
            # acked writes)
            doc = self.t.to_doc()
            for d in doc["slices"]:
                if d["sid"] == sl.sid:
                    d.update(state=CUT, src_cut=src_cut,
                             dst_cut=dst_cut)
            j = self.planner.journal
            if j is not None:
                j.save_transition(doc)
            self.t.set_state(sl, CUT, src_cut=src_cut, dst_cut=dst_cut)
            metrics.counter("scaleout_rebalance_cutovers_total").inc()
        finally:
            self._in_cutover = False
            sl.gate.thaw()
        metrics.gauge("scaleout_rebalance_slices_cut").set(
            sum(1 for s in self.t.slices if s.state == CUT))
        metrics.histogram("scaleout_rebalance_slice_seconds").observe(
            time.monotonic() - t0)

    def _gc(self) -> None:
        for sl in self.t.slices:
            self._slice_drop(sl.src, sl.ranges)
            # GC is pure cleanup — pace it like the copy so the
            # post-cutover deletes don't burst the source host
            self._sleep(self.pace_seconds)


# -- in-process fallbacks ------------------------------------------------------
# The coordinator drives remote groups through the slice_* wire ops
# (engine/remote.py); raw in-process Engines (tests, single-box
# deployments) get the same semantics computed client-side.


def _apply_po2_local(engine, ops):
    """In-process fallback apply — the SAME po2-chunked helper the
    slice wire ops run server-side (one owner: engine/remote.py)."""
    from ..engine.remote import _apply_po2

    _apply_po2(engine, ops, None)


def _local_slice_read(engine, ranges, want_globals: bool = False):
    """In-process fallback export — the SAME row filter the slice_read
    wire op runs server-side (one owner: engine/remote.py), with the
    revision read BEFORE the scan."""
    from ..engine.remote import _slice_rows

    rev = int(engine.revision)
    return rev, _slice_rows(engine, ranges, want_globals)


def abort_transition(planner, transition: MapTransition) -> None:
    """Cleanly abort a transition no slice of which has cut: drop the
    destination groups' partial copies (idempotent deletes) and clear
    the persisted record. Routing never left map V, so the abort is
    invisible to correctness — only the copy work is discarded."""
    if transition.any_cut():
        raise RebalanceError(
            "transition has cut slices — past the point of no return; "
            "it must be resumed to completion, not aborted")
    for sl in transition.slices:
        dst = None
        close_dst = False
        if sl.dst < len(planner.groups):
            dst = planner.groups[sl.dst]
        elif planner.client_factory is not None:
            # a transition-ADDED group the aborting planner never
            # installed: build a throwaway client from the target map's
            # endpoints — its partial copies would otherwise outlive
            # the abort (inert until a later move makes it an owner)
            try:
                dst = planner.client_factory(
                    transition.new_map.groups[sl.dst])
                close_dst = True
            except Exception as e:  # noqa: BLE001 - abort best-effort
                log.warning("abort: no client for added group %d: %s",
                            sl.dst, e)
        if dst is None:
            log.warning(
                "abort: slice %d copies on group %d unreachable; they "
                "stay inert until the next move's copy-replace drops "
                "them", sl.sid, sl.dst)
            continue
        try:
            if hasattr(dst, "slice_drop"):
                dst.slice_drop(sl.ranges)
            else:
                _, rows = _local_slice_read(dst, sl.ranges)
                if rows:
                    _apply_po2_local(
                        dst, [WriteOp("delete", r) for r in rows])
        except Exception as e:  # noqa: BLE001 - abort is best-effort
            # an unreachable dst keeps its (inert) copies; the next
            # transition's copy-replace drops them before any load
            log.warning("abort: could not drop slice %d copies on "
                        "group %d: %s", sl.sid, sl.dst, e)
        finally:
            if close_dst:
                try:
                    dst.close()
                except Exception:  # noqa: BLE001 - teardown best effort
                    pass
    if planner.journal is not None:
        planner.journal.clear_transition()
    metrics.counter("scaleout_rebalance_transitions_total",
                    outcome="aborted").inc()


__all__ = [
    "CATCHUP", "COPYING", "CUT", "DUAL", "PLANNED",
    "MapTransition", "MovingSlice", "RebalanceCoordinator",
    "RebalanceError", "abort_transition", "plan_moves", "shrink_map",
]
