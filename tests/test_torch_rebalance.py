"""PyTorch port, online rebalancing (scaleout/rebalance.py): the live
tuple mover, held against the JAX package.

Every case of test_rebalance.py runs here on BOTH packages through one
body (``both``): ring-diff planning, map-versioned revision vectors, live
moves in process and over loopback engine hosts, the dual-write window
and its journal tags, the crash matrix, admission classing and /readyz's
``rebalance:`` line. The same ``plan_moves`` / ``shrink_map`` output
feeds both sides; a live 2 -> 3 grow and a 3 -> 2 shrink run under a
writer, and the final per-group contents, the journal's phases and the
merged watch streams must be identical across the packages. A mid-move
crash is recovered by a fresh planner over the journal.

The JAX case's goodput ratio (non-moving slices during the move against
paused windows) is a timing claim, measured on the card by chip_smoke's
phase X.d instead; the live moves here wait on events, never on sleeps,
and give every wire call a timeout.
"""

from __future__ import annotations

import asyncio
import threading
import time

import pytest

from torch_parity import counter, package

JAX, PORT = package("jax"), package("torch")

SCHEMA_YAML = """\
schema: |-
  use expiration

  definition user {}

  definition group {
    relation member: user
  }

  definition namespace {
    relation creator: user
    relation viewer: user | group#member
    permission admin = creator
    permission view = viewer + creator
  }

  definition pod {
    relation namespace: namespace
    relation creator: user
    relation viewer: user
    permission edit = creator
    permission view = viewer + creator + namespace->view
  }
relationships: ""
"""


def both(fn, *args, **kw):
    got = {P.name: fn(P, *args, **kw) for P in (JAX, PORT)}
    assert got["torch"] == got["jax"]
    return got["torch"]


def _map(P, n: int, version: int = 1, vnodes: int = 64):
    return P.ShardMap(version=version,
                      groups=tuple((("127.0.0.1", 0),) for _ in range(n)),
                      virtual_nodes=vnodes)


def rel(P, rt, rid, rl, st, sid, srl=None):
    return P.Relationship(rt, rid, rl, st, sid, srl)


def _seed_writes(P, n_ns: int, users: int = 4) -> list:
    out = []
    for i in range(n_ns):
        out.append(P.WriteOp("create", rel(
            P, "namespace", f"ns{i}", "viewer", "user", f"u{i % users}")))
        out.append(P.WriteOp("create", rel(
            P, "pod", f"ns{i}/p0", "namespace", "namespace", f"ns{i}")))
        out.append(P.WriteOp("create", rel(
            P, "pod", f"ns{i}/p0", "viewer", "user", f"u{i % users}")))
    return out


def _moving_split(t, n_ns: int):
    moving, staying = [], []
    for i in range(n_ns):
        (moving if t.slice_for_key(f"ns{i}", "pod") is not None
         else staying).append(f"ns{i}")
    return moving, staying


def _stores(P, engines) -> list:
    return [sorted(r.key() for r in e.read_relationships(
        P.RelationshipFilter())) for e in engines]


def _slices(t) -> list:
    return [(s.sid, s.src, s.dst, s.ranges) for s in t.slices]


def _converged(doc) -> bool:
    """The crash-matrix invariant: a transition record after recovery is
    absent (a clean abort) or the durable ``done`` marker."""
    return doc is None or doc.get("phase") == "done"


# -- planning ----------------------------------------------------------------


def test_plan_moves_version_bump_moves_nothing_and_covers_changed_keys():
    def run(P):
        assert P.plan_moves(_map(P, 2, 1), _map(P, 2, 2)) == []
        old, new = _map(P, 2, 1, vnodes=64), _map(P, 2, 2, vnodes=96)
        moves = P.plan_moves(old, new)
        assert moves
        t = P.MapTransition(old, new, moves)
        for i in range(400):
            ns = f"ns{i}"
            sl = t.slice_for_key(ns, "pod")
            src, dst = old.shard_for(ns, "pod"), new.shard_for(ns, "pod")
            if src == dst:
                assert sl is None
            else:
                assert sl is not None and (sl.src, sl.dst) == (src, dst)
        grow = P.plan_moves(_map(P, 2, 1), _map(P, 3, 2))
        assert all(sl.dst == 2 and sl.src in (0, 1) for sl in grow)
        m3 = _map(P, 3, 1)
        shrink = P.plan_moves(m3, P.shrink_map(m3), retire=2)
        assert all(sl.src == 2 for sl in shrink)
        return (_slices(t), [(s.sid, s.src, s.dst, s.ranges) for s in grow],
                [(s.sid, s.src, s.dst, s.ranges) for s in shrink],
                P.map_to_doc(P.shrink_map(m3)))

    both(run)


def test_revision_vector_encode_parse_carry_map_version():
    def run(P):
        RV = P.RevisionVector
        v = RV((3, 5))
        tagged = v.encode(map_version=2)
        assert (v.encode(), tagged) == ("v3.5", "v3.5@m2")
        assert RV.parse(tagged) == (3, 5)
        assert RV.parse(tagged, map_version=2) == (3, 5)
        assert RV.parse_versioned(tagged) == ((3, 5), 2)
        assert RV.parse_versioned("v3.5") == ((3, 5), None)
        msgs = []
        for args in ((tagged, 3), ("v3.5@mX", None)):
            with pytest.raises(P.ShardMapError) as ei:
                RV.parse(args[0], map_version=args[1])
            msgs.append(str(ei.value))
        assert "minted under" in msgs[0]
        assert RV((1, 2)).extend(4) == (1, 2, 0, 0)
        return msgs

    both(run)


def test_planner_rejects_wrong_size_or_unknown_version_tokens():
    def run(P):
        p = P.ShardedEngine(_map(P, 3), [P.engine(SCHEMA_YAML)
                                         for _ in range(3)])
        msgs = []
        for tok in (P.RevisionVector((1, 2)), "v1.2.3@m99"):
            with pytest.raises(P.ShardMapError) as ei:
                p.watch_since(tok)
            msgs.append(str(ei.value))
        assert "no transition" in msgs[1]
        assert p.watch_since("v0.0.0@m1") == []
        p.close()
        return msgs

    both(run)


# -- live moves, in process ---------------------------------------------------


def test_inproc_rebalance_end_to_end(tmp_path):
    def run(P):
        n_ns = 24
        old, new = _map(P, 2, 1), _map(P, 2, 2, vnodes=96)
        engines = [P.engine(SCHEMA_YAML), P.engine(SCHEMA_YAML)]
        journal = P.SplitJournal(str(tmp_path / P.name / "sj.sqlite"))
        p = P.ShardedEngine(old, engines, journal=journal)
        p.write_relationships(_seed_writes(P, n_ns))
        users = [f"u{i}" for i in range(4)]
        before = {u: sorted(p.lookup_resources("pod", "view", "user", u))
                  for u in users}
        coord = p.begin_rebalance(new)
        assert coord.wait(90) and coord.error is None, coord.error
        assert p.map.version == 2
        after = {u: sorted(p.lookup_resources("pod", "view", "user", u))
                 for u in users}
        assert before == after
        for i in range(n_ns):
            assert p.check(P.CheckItem("pod", f"ns{i}/p0", "view", "user",
                                       f"u{i % 4}"))
            assert not p.check(P.CheckItem("pod", f"ns{i}/p0", "view",
                                           "user", "intruder"))
            f = P.RelationshipFilter(resource_type="pod",
                                     resource_id=f"ns{i}/p0")
            holders = [gi for gi, e in enumerate(engines)
                       if e.store.exists(f)]
            assert holders == [new.shard_for(f"ns{i}", "pod")]
        doc = journal.load_transition()
        assert doc["phase"] == "done" and _converged(doc)
        assert journal.pending_count() == 0
        out = (after, _stores(P, engines), doc["slices"],
               counter(P, "scaleout_rebalance_copied_rows_total"),
               counter(P, "scaleout_rebalance_gc_rows_total"))
        p.close()
        return out

    both(run)


def test_a_move_into_small_compacting_overlays_finishes(tmp_path):
    """Port only: groups whose compactor sheds against a 64-slot overlay
    (16 records a write at most) take a move whose slices hold far more
    rows than that. The mover's writes are cut to half of that (none
    refused, none larger than 8 records), the transition commits, and
    every list is exact. The JAX host would shed a larger chunk on every
    retry."""
    P, n_ns = PORT, 48
    old, new = _map(P, 2, 1), _map(P, 2, 2, vnodes=96)
    engines = [P.engine(SCHEMA_YAML, delta_capacity=64) for _ in range(2)]
    journal = P.SplitJournal(str(tmp_path / "sj.sqlite"))
    p = P.ShardedEngine(old, engines, journal=journal)
    p.write_relationships(_seed_writes(P, n_ns))
    sizes = []
    for e in engines:
        e.compiled()
        e.enable_compaction(1.0)
        real = e.write_relationships

        def spy(ops, *a, _real=real, **kw):
            sizes.append(len(ops))
            return _real(ops, *a, **kw)

        e.write_relationships = spy
    users = [f"u{i}" for i in range(4)]
    before = {u: sorted(p.lookup_resources("pod", "view", "user", u))
              for u in users}
    coord = p.begin_rebalance(new)
    assert coord.wait(90) and coord.error is None, coord.error
    assert p.map.version == 2
    assert sum(sizes) > 16 and max(sizes) <= 8, sizes
    assert {u: sorted(p.lookup_resources("pod", "view", "user", u))
            for u in users} == before
    p.close()
    for e in engines:
        e.close_compaction()


def test_a_split_write_caught_by_a_shrink_commit_replays_whole(tmp_path):
    """A global split write whose last leg runs after a shrink's commit
    took that group out of the planner's groups raises IndexError, stays
    pending in the journal, and its replay on the new map leaves it on
    every remaining group (chip_smoke's X.d accepts only this error from
    its writer during the shrink, and holds it all-or-none)."""
    def run(P):
        old = _map(P, 3, 1)
        engines = [P.engine(SCHEMA_YAML) for _ in range(3)]
        journal = P.SplitJournal(str(tmp_path / P.name / "sj.sqlite"))
        p = P.ShardedEngine(old, engines, journal=journal)
        real = engines[1].write_relationships

        def commit_then_write(ops, *a, **kw):
            rev = real(ops, *a, **kw)
            with p._vec_lock:  # commit_rebalance's retire step
                p.map = P.shrink_map(old)
                p._retired_clients.append(p.groups.pop(2))
                p._vector = p._vector.drop_component(2)
            return rev

        engines[1].write_relationships = commit_then_write
        grant = rel(P, "namespace", "ns0", "viewer", "user", "u9")
        with pytest.raises(IndexError):
            p.write_relationships([P.WriteOp("touch", grant)])
        engines[1].write_relationships = real
        assert journal.pending_count() == 1
        assert p.recover_splits() == 1 and journal.pending_count() == 0
        f = P.RelationshipFilter(resource_type="namespace",
                                 resource_id="ns0", subject_id="u9")
        held = [bool(e.read_relationships(f)) for e in engines]
        p.close()
        return held

    assert both(run)[:2] == [True, True]


def test_rebalance_grow_one_to_two_groups_translates_tokens():
    def run(P):
        n_ns = 16
        old, new = _map(P, 1, 1), _map(P, 2, 2)
        engines, extra = [P.engine(SCHEMA_YAML)], P.engine(SCHEMA_YAML)
        p = P.ShardedEngine(old, engines)
        p.write_relationships(_seed_writes(P, n_ns))
        token = p.revision_vector().encode(map_version=1)
        coord = p.begin_rebalance(new, new_clients={1: extra})
        assert coord.wait(90) and coord.error is None, coord.error
        assert p.map.version == 2 and len(p.groups) == 2
        moved = [f"ns{i}" for i in range(n_ns)
                 if new.shard_for(f"ns{i}", "pod") == 1]
        assert moved
        for ns in moved:
            for rt, rid in (("pod", f"{ns}/p0"), ("namespace", ns)):
                assert extra.store.exists(P.RelationshipFilter(
                    resource_type=rt, resource_id=rid))
        assert p.watch_since(token) == []
        for u in (f"u{i}" for i in range(4)):
            got = sorted(p.lookup_resources("pod", "view", "user", u))
            assert got == sorted(f"ns{i}/p0" for i in range(n_ns)
                                 if f"u{i % 4}" == u)
        out = (moved, _stores(P, engines + [extra]),
               tuple(p.revision_vector()))
        p.close()
        return out

    both(run)


def _live_move(P, tmp_path, old_n: int, target, n_ns: int = 16,
               n_writes: int = 40, tag: str = ""):
    """A live move from an ``old_n``-group map to ``target(old_map)``
    under a writer thread (``n_writes`` touches, moving and staying
    slices alternately, unique subjects) and an open merged watch
    stream; the writer's first write and the mover's start are released
    together. Returns what a reader of the fleet can see afterwards."""
    engines = [P.engine(SCHEMA_YAML) for _ in range(max(old_n, 3))]
    old = _map(P, old_n, 1)
    new = target(P, old)
    journal = P.SplitJournal(str(tmp_path / P.name / f"{tag}sj.sqlite"))
    p = P.ShardedEngine(old, engines[:old_n], journal=journal)
    p.write_relationships(_seed_writes(P, n_ns))
    retire = old_n - 1 if new.n_groups < old_n else None
    t = P.MapTransition(old, new, P.plan_moves(old, new, retire=retire),
                        retire=retire)
    moving, staying = _moving_split(t, n_ns)
    assert moving and staying
    stream = p.watch_push_stream(p.revision_vector())
    acked: list = []
    go = threading.Event()

    def writer():
        go.wait(30)
        for i in range(n_writes):
            ns = (moving if i % 2 else staying)[i % min(len(moving),
                                                        len(staying))]
            p.write_relationships([P.WriteOp("touch", rel(
                P, "pod", f"{ns}/p0", "viewer", "user", f"w{i}"))])
            acked.append((ns, f"w{i}"))
            time.sleep(0.002)

    wt = threading.Thread(target=writer, daemon=True)
    wt.start()
    new_clients = {gi: engines[gi] for gi in range(old_n, new.n_groups)}
    coord = p.begin_rebalance(new, new_clients=new_clients,
                              batch_rows=8, pace_seconds=0.001)
    go.set()
    assert coord.wait(120) and coord.error is None, coord.error
    wt.join(60)
    assert not wt.is_alive()
    assert p.map.version == 2 and len(p.groups) == new.n_groups
    for ns, name in acked:
        assert p.exists(P.RelationshipFilter(
            resource_type="pod", resource_id=f"{ns}/p0",
            relation="viewer", subject_id=name)), (ns, name)
    want = {name for _, name in acked}
    seen: list = []
    relist = None
    deadline = time.monotonic() + 30
    while not want <= set(seen) and time.monotonic() < deadline:
        try:
            batch = stream.next_batch()
        except P.StoreError as e:
            # a shrink renumbers the group space under an open stream:
            # it fails closed with re-list semantics
            relist = str(e)
            break
        seen += [e.relationship.subject_id for e in batch
                 if e.relationship.subject_id.startswith("w")]
    stream.close()
    assert len(seen) == len(set(seen)), "a write delivered twice"
    if retire is None:
        assert set(seen) == want, sorted(want - set(seen))[:5]
    else:
        assert relist is not None and set(seen) <= want
        seen = ["re-list"]
    deadline = time.monotonic() + 30
    while not all(x.gc_complete for x in p._archived_transitions) \
            and time.monotonic() < deadline:
        time.sleep(0.01)
    doc = journal.load_transition()
    out = {"slices": _slices(t), "phase": doc["phase"],
           "stores": _stores(P, engines[:max(old_n, new.n_groups)]),
           "stream": sorted(seen), "relist": relist,
           "map": P.map_to_doc(p.map),
           "lists": {u: sorted(p.lookup_resources("pod", "view", "user",
                                                  u))
                     for u in ("u0", "u1", "u2", "u3")}}
    for i in range(n_ns):
        f = P.RelationshipFilter(resource_type="pod",
                                 resource_id=f"ns{i}/p0")
        holders = [gi for gi, e in enumerate(p.groups)
                   if e.store.exists(f)]
        assert holders == [p.map.shard_for(f"ns{i}", "pod")], (i, holders)
    p.close()
    return out


def test_live_grow_two_to_three_under_a_writer(tmp_path):
    def grow(P, old):
        return P.ShardMap(version=2,
                          groups=old.groups + ((("127.0.0.1", 0),),),
                          virtual_nodes=64)

    out = both(_live_move, tmp_path, 2, grow)
    assert out["phase"] == "done" and len(out["stores"]) == 3


def test_live_shrink_three_to_two_under_a_writer(tmp_path):
    def shrink(P, old):
        return P.shrink_map(old)

    out = both(_live_move, tmp_path, 3, shrink, tag="s")
    assert out["phase"] == "done"
    # the retiree drained: only the replicated globals stay on it
    assert all(k[0] == "namespace" for k in out["stores"][2])


def test_watch_stream_gap_and_duplicate_free_across_cutover():
    def run(P):
        n_ns = 16
        old, new = _map(P, 2, 1), _map(P, 2, 2, vnodes=96)
        p = P.ShardedEngine(old, [P.engine(SCHEMA_YAML)
                                  for _ in range(2)])
        p.write_relationships(_seed_writes(P, n_ns))
        t = P.MapTransition(old, new, P.plan_moves(old, new))
        moving, staying = _moving_split(t, n_ns)
        stream = p.watch_push_stream(p.revision_vector())
        acked, stop = [], threading.Event()

        def writer():
            i = 0
            while not stop.is_set():
                ns = (moving + staying)[i % n_ns]
                p.write_relationships([P.WriteOp("touch", rel(
                    P, "pod", f"{ns}/p0", "viewer", "user", f"w{i}"))])
                acked.append(f"w{i}")
                i += 1
                time.sleep(0.005)

        wt = threading.Thread(target=writer, daemon=True)
        wt.start()
        try:
            coord = p.begin_rebalance(new, pace_seconds=0.002,
                                      batch_rows=16)
            assert coord.wait(120) and coord.error is None, coord.error
        finally:
            stop.set()
            wt.join(10)
        want, seen = set(acked), []
        deadline = time.monotonic() + 30
        while not want <= set(seen) and time.monotonic() < deadline:
            seen += [e.relationship.subject_id for e in stream.next_batch()
                     if e.relationship.subject_id.startswith("w")]
        stream.close()
        assert not want - set(seen), "gap across cutover"
        assert len(seen) == len(set(seen)), "duplicates across cutover"
        p.close()
        return _slices(t)

    both(run)


# -- the dual-write window ---------------------------------------------------


def test_dual_write_window_mirrors_and_tags_journal(tmp_path):
    def run(P):
        n_ns = 12
        old, new = _map(P, 2, 1), _map(P, 2, 2, vnodes=96)
        engines = [P.engine(SCHEMA_YAML), P.engine(SCHEMA_YAML)]
        journal = P.SplitJournal(str(tmp_path / P.name / "sj.sqlite"))
        p = P.ShardedEngine(old, engines, journal=journal)
        p.write_relationships(_seed_writes(P, n_ns))
        t = P.MapTransition(old, new, P.plan_moves(old, new))
        moving, _ = _moving_split(t, n_ns)
        ns = moving[0]
        sl = t.slice_for_key(ns, "pod")
        p._install_transition(t)
        coord = P.RebalanceCoordinator(p, t)
        copy_rev, rows = coord._slice_read(sl.src, sl.ranges)
        coord._slice_load(sl.dst, rows)
        t.set_state(sl, "catchup", copy_rev=copy_rev, replayed=copy_rev)
        while coord._catch_up_once(sl) > 0:
            pass
        t.set_state(sl, P.rebalance.DUAL)
        before = counter(P, "scaleout_rebalance_dual_writes_total")
        p.write_relationships([P.WriteOp("touch", rel(
            P, "pod", f"{ns}/p0", "viewer", "user", "mirrored"))])
        assert counter(P, "scaleout_rebalance_dual_writes_total") > before
        f = P.RelationshipFilter(resource_type="pod",
                                 resource_id=f"{ns}/p0",
                                 subject_id="mirrored")
        assert engines[sl.src].store.exists(f)
        assert engines[sl.dst].store.exists(f)
        assert journal.pending_count() == 0
        s0 = counter(P, "scaleout_ops_total", group=str(sl.src),
                     op="check_bulk", mode="single")
        assert p.check(P.CheckItem("pod", f"{ns}/p0", "view", "user",
                                   "mirrored"))
        assert counter(P, "scaleout_ops_total", group=str(sl.src),
                       op="check_bulk", mode="single") == s0 + 1
        p.close(close_journal=False)

        engines2 = [P.engine(SCHEMA_YAML), P.engine(SCHEMA_YAML)]
        p2 = P.ShardedEngine(old, engines2, journal=journal, recover=False)
        p2._install_transition(P.MapTransition.from_doc(t.to_doc(), old))
        sl2 = p2._active_transition.slices[sl.sid]
        p2._active_transition.set_state(sl2, P.rebalance.DUAL)

        class Dying:
            def __init__(self, inner):
                self._inner = inner

            def __getattr__(self, name):
                return getattr(self._inner, name)

            def write_relationships(self, ops, preconditions=()):
                self._inner.write_relationships(ops, preconditions)
                raise ConnectionResetError("crash after first owner")

        hi = max(sl.src, sl.dst)
        p2.groups[hi] = Dying(p2.groups[hi])
        with pytest.raises(ConnectionResetError):
            p2.write_relationships([P.WriteOp("touch", rel(
                P, "pod", f"{ns}/p0", "viewer", "user", "window-crash"))])
        ent = journal.pending()[0]
        assert (ent["map_version"], ent["map_version_to"]) == (1, 2)
        tags = (ent["map_version"], ent["map_version_to"],
                sorted(ent["plan"]), sorted(ent["applied"]))
        p2.close(close_journal=False)
        p3 = P.ShardedEngine(old, engines2, journal=journal)
        assert journal.pending_count() == 0
        assert journal.load_transition() is None
        wc = P.RelationshipFilter(resource_type="pod",
                                  resource_id=f"{ns}/p0",
                                  subject_id="window-crash")
        assert engines2[sl.src].store.exists(wc)
        assert not engines2[sl.dst].store.exists(wc)
        assert p3.exists(wc)
        p3.close()
        return ns, tags, _stores(P, engines), _stores(P, engines2)

    both(run)


# -- the crash matrix --------------------------------------------------------


def _persisted_transition(P, root, n_ns=12, cut_first=False):
    old, new = _map(P, 2, 1), _map(P, 2, 2, vnodes=96)
    engines = [P.engine(SCHEMA_YAML), P.engine(SCHEMA_YAML)]
    journal = P.SplitJournal(str(root / P.name / "sj.sqlite"))
    p = P.ShardedEngine(old, engines, journal=journal)
    p.write_relationships(_seed_writes(P, n_ns))
    t = P.MapTransition(old, new, P.plan_moves(old, new))
    p._install_transition(t)
    coord = P.RebalanceCoordinator(p, t)
    for i, sl in enumerate(t.slices):
        copy_rev, rows = coord._slice_read(sl.src, sl.ranges)
        coord._slice_load(sl.dst, rows)
        t.set_state(sl, "catchup", copy_rev=copy_rev, replayed=copy_rev)
        while coord._catch_up_once(sl) > 0:
            pass
        if cut_first and i == 0:
            t.set_state(sl, P.rebalance.CUT,
                        src_cut=coord._src_revision(sl.src),
                        dst_cut=coord._src_revision(sl.dst))
    coord._persist()
    p.close(close_journal=False)  # the "SIGKILL": the record stays
    return old, new, engines, journal, t


def test_crash_before_any_cut_aborts_cleanly(tmp_path):
    def run(P):
        old, new, engines, journal, t = _persisted_transition(P, tmp_path)
        doc = journal.load_transition()
        assert not _converged(doc)
        p2 = P.ShardedEngine(old, engines, journal=journal)
        assert journal.load_transition() is None
        assert p2.map.version == 1
        for i in range(12):
            f = P.RelationshipFilter(resource_type="pod",
                                     resource_id=f"ns{i}/p0")
            holders = [gi for gi, e in enumerate(engines)
                       if e.store.exists(f)]
            assert holders == [old.shard_for(f"ns{i}", "pod")]
            assert p2.check(P.CheckItem("pod", f"ns{i}/p0", "view",
                                        "user", f"u{i % 4}"))
        p2.close()
        return doc["slices"], _stores(P, engines)

    both(run)


def test_crash_after_first_cut_resumes_to_completion(tmp_path):
    def run(P):
        old, new, engines, journal, t = _persisted_transition(
            P, tmp_path, cut_first=True)
        p2 = P.ShardedEngine(old, engines, journal=journal)
        assert p2._coordinator is not None
        assert p2._coordinator.wait(90)
        assert p2._coordinator.error is None, p2._coordinator.error
        assert p2.map.version == 2
        doc = journal.load_transition()
        assert doc["phase"] == "done"
        for i in range(12):
            assert p2.check(P.CheckItem("pod", f"ns{i}/p0", "view", "user",
                                        f"u{i % 4}"))
            f = P.RelationshipFilter(resource_type="pod",
                                     resource_id=f"ns{i}/p0")
            holders = [gi for gi, e in enumerate(engines)
                       if e.store.exists(f)]
            assert holders == [new.shard_for(f"ns{i}", "pod")]
        p2.close()
        return [s["state"] for s in doc["slices"]], _stores(P, engines)

    both(run)


def test_fresh_planner_recovers_a_grow_killed_mid_move(tmp_path):
    """A 2 -> 3 grow killed after its first slice cut: a fresh planner
    over the same journal and engines (the added group's client from its
    ``client_factory``) resumes it to completion; nothing acked is lost."""

    def run(P):
        n_ns = 16
        engines = [P.engine(SCHEMA_YAML) for _ in range(3)]
        old = _map(P, 2, 1)
        new = P.ShardMap(version=2, groups=old.groups + ((("g2", 1),),))
        journal = P.SplitJournal(str(tmp_path / P.name / "sj.sqlite"))
        p = P.ShardedEngine(old, engines[:2], journal=journal)
        p.write_relationships(_seed_writes(P, n_ns))
        t = P.MapTransition(old, new, P.plan_moves(old, new))
        p._install_transition(t, {2: engines[2]})
        coord = P.RebalanceCoordinator(p, t)
        coord._seed_globals()
        sl = t.slices[0]
        copy_rev, rows = coord._slice_read(sl.src, sl.ranges)
        coord._slice_load(sl.dst, rows)
        t.set_state(sl, "catchup", copy_rev=copy_rev, replayed=copy_rev)
        while coord._catch_up_once(sl) > 0:
            pass
        t.set_state(sl, P.rebalance.CUT,
                    src_cut=coord._src_revision(sl.src),
                    dst_cut=coord._src_revision(sl.dst))
        coord._persist()
        p.close(close_journal=False)
        p2 = P.ShardedEngine(
            old, engines[:2], journal=journal,
            client_factory=lambda eps: engines[2])
        assert p2._coordinator is not None and p2._coordinator.wait(90)
        assert p2._coordinator.error is None, p2._coordinator.error
        assert p2.map.version == 2 and len(p2.groups) == 3
        for i in range(n_ns):
            assert p2.check(P.CheckItem("pod", f"ns{i}/p0", "view", "user",
                                        f"u{i % 4}"))
        doc = journal.load_transition()
        assert doc["phase"] == "done"
        p2.close()
        return _slices(t), _stores(P, engines)

    both(run)


def test_committed_but_uncleared_record_finishes_at_boot(tmp_path):
    def run(P):
        old, new = _map(P, 2, 1), _map(P, 2, 2, vnodes=96)
        engines = [P.engine(SCHEMA_YAML), P.engine(SCHEMA_YAML)]
        journal = P.SplitJournal(str(tmp_path / P.name / "sj.sqlite"))
        p = P.ShardedEngine(old, engines, journal=journal)
        p.write_relationships(_seed_writes(P, 8))
        coord = p.begin_rebalance(new)
        assert coord.wait(90) and coord.error is None
        t = p._archived_transitions[0]
        journal.save_transition(t.to_doc("committed"))
        p.close(close_journal=False)
        p2 = P.ShardedEngine(old, engines, journal=journal)
        assert p2.map.version == 2
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            doc = journal.load_transition()
            if doc is not None and doc.get("phase") == "done":
                break
            time.sleep(0.02)
        assert journal.load_transition()["phase"] == "done"
        p2.close()
        return _stores(P, engines)

    both(run)


def test_abort_requires_no_cut_slice():
    def run(P):
        old, new = _map(P, 2, 1), _map(P, 2, 2, vnodes=96)
        t = P.MapTransition(old, new, P.plan_moves(old, new))
        t.set_state(t.slices[0], P.rebalance.CUT, src_cut=1, dst_cut=1)
        p = P.ShardedEngine(old, [P.engine(SCHEMA_YAML)
                                  for _ in range(2)])
        with pytest.raises(P.RebalanceError) as ei:
            P.abort_transition(p, t)
        p.close()
        assert "point of no return" in str(ei.value)
        return str(ei.value)

    both(run)


def test_resume_replays_deletes_from_the_crash_window(tmp_path):
    def run(P):
        old, new, engines, journal, t = _persisted_transition(
            P, tmp_path, cut_first=True)
        sl = next(s for s in t.slices if s.state != P.rebalance.CUT)
        idx = next(i for i in range(12)
                   if t.slice_for_key(f"ns{i}", "pod") is sl)
        ns = f"ns{idx}"
        victim = rel(P, "pod", f"{ns}/p0", "viewer", "user", "vic")
        engines[sl.dst].write_relationships([P.WriteOp("touch", victim)])
        engines[sl.src].write_relationships([P.WriteOp("touch", victim)])
        engines[sl.src].write_relationships([P.WriteOp("delete", victim)])
        vic = P.RelationshipFilter(resource_type="pod",
                                   resource_id=f"{ns}/p0",
                                   subject_id="vic")
        assert engines[sl.dst].store.exists(vic)
        p2 = P.ShardedEngine(old, engines, journal=journal)
        coord = p2._coordinator
        assert coord is not None and coord.wait(90)
        assert coord.error is None, coord.error
        assert p2.map.version == 2
        assert not engines[sl.dst].store.exists(vic)
        assert not p2.check(P.CheckItem("pod", f"{ns}/p0", "view", "user",
                                        "vic"))
        p2.close()
        return ns, _stores(P, engines)

    both(run)


def test_stale_flags_restart_boots_the_completed_map(tmp_path):
    def run(P):
        old, new = _map(P, 2, 1), _map(P, 2, 2, vnodes=96)
        engines = [P.engine(SCHEMA_YAML), P.engine(SCHEMA_YAML)]
        journal = P.SplitJournal(str(tmp_path / P.name / "sj.sqlite"))
        p = P.ShardedEngine(old, engines, journal=journal)
        p.write_relationships(_seed_writes(P, 12))
        coord = p.begin_rebalance(new)
        assert coord.wait(90) and coord.error is None, coord.error
        p.close(close_journal=False)
        p2 = P.ShardedEngine(old, engines, journal=journal)
        assert p2.map.version == 2
        for i in range(12):
            assert p2.check(P.CheckItem("pod", f"ns{i}/p0", "view", "user",
                                        f"u{i % 4}"))
        assert journal.load_transition()["phase"] == "done"
        p2.close(close_journal=False)
        p3 = P.ShardedEngine(new, engines, journal=journal)
        assert p3.map.version == 2
        assert journal.load_transition() is None
        assert p3.check(P.CheckItem("pod", "ns0/p0", "view", "user", "u0"))
        p3.close()
        return _stores(P, engines)

    both(run)


# -- admission classing, /readyz, options -------------------------------------


def test_slice_ops_are_rebalance_classed_and_mover_backs_off():
    def run(P):
        for op in ("slice_read", "slice_load", "slice_apply",
                   "slice_drop", "slice_watch"):
            assert P.classify_op(op) is P.REBALANCE
        assert all(P.REBALANCE.priority < c.priority
                   for n, c in P.CLASSES.items() if n != "rebalance")
        old, new = _map(P, 2, 1), _map(P, 2, 2, vnodes=96)
        t = P.MapTransition(old, new, P.plan_moves(old, new))
        p = P.ShardedEngine(old, [P.engine(SCHEMA_YAML)
                                  for _ in range(2)])
        coord = P.RebalanceCoordinator(p, t)
        calls = {"n": 0}

        def flaky():
            calls["n"] += 1
            if calls["n"] < 3:
                raise P.AdmissionRejected("rebalance", "host full",
                                          retry_after=0.01,
                                          dependency="engine-admission")
            return "ok"

        b0 = counter(P, "scaleout_rebalance_shed_backoff_total")
        assert coord._call_shed_aware(flaky) == "ok"
        backoffs = counter(P, "scaleout_rebalance_shed_backoff_total") - b0
        assert backoffs == 2
        p.close()
        return backoffs

    both(run)


def test_sharding_status_and_readyz_report_rebalance(tmp_path):
    RULES = open(__file__.rsplit("/tests/", 1)[0]
                 + "/deploy/rules.yaml").read()

    def run(P):
        async def go():
            srvs = [P.EngineServer(P.engine(SCHEMA_YAML))
                    for _ in range(2)]
            ports = [await s.start() for s in srvs]
            smap = ('{"version": 1, "groups": [["127.0.0.1:%d"], '
                    '["127.0.0.1:%d"]]}' % tuple(ports))
            cfg = P.Options(
                shard_map=smap,
                shard_journal_path=str(tmp_path / P.name / "sj.sqlite"),
                engine_insecure=True, rule_content=RULES,
                upstream=P.FakeKube(),
                workflow_database_path=str(tmp_path / P.name
                                           / "dtx.sqlite"),
            ).complete()
            await cfg.workflow.resume_pending()
            old = cfg.engine.map
            new = P.ShardMap(version=2, groups=old.groups,
                             virtual_nodes=96)
            t = P.MapTransition(old, new, P.plan_moves(old, new))
            cfg.engine._install_transition(t)
            st = cfg.engine.sharding_status()
            assert st["rebalance"] == {
                "to_version": 2, "moving": len(t.slices),
                "copied": 0, "cut": 0, "lag": 0}
            alice = P.InMemoryClient(cfg.server.handle, user="alice")
            resp = await alice.get("/readyz")
            assert resp.status == 200, resp.body
            lines = [ln for ln in resp.body.decode().splitlines()
                     if "rebalance:" in ln]
            assert lines and "[+]rebalance: to_version=2 moving=" in \
                lines[0] and "cut=0 lag=0" in lines[0]
            cfg.engine._active_transition = None
            cfg.engine.journal.clear_transition()
            await cfg.workflow.shutdown()
            cfg.engine.close()
            for s in srvs:
                await s.stop()
            return lines

        return asyncio.run(go())

    both(run)


def test_options_validation_rebalance_to():
    good = '{"version": 1, "groups": [["127.0.0.1:1"], ["127.0.0.1:2"]]}'
    good3 = ('{"version": 1, "groups": [["127.0.0.1:1"], '
             '["127.0.0.1:2"], ["127.0.0.1:3"]]}')

    def run(P):
        msgs = []
        for kw in ({"rebalance_to": good},
                   {"shard_map": good, "rebalance_to": good},
                   {"shard_map": good3, "rebalance_to":
                    '{"version": 2, "groups": [["127.0.0.1:1"]]}'},
                   {"shard_map": good, "rebalance_to":
                    '{"version": 2, "groups": [["127.0.0.1:2"]]}'},
                   {"shard_map": good, "rebalance_to": "{bad"}):
            with pytest.raises(P.OptionsError) as ei:
                P.Options(rule_content="x", upstream=object(),
                          **kw).validate()
            msgs.append(str(ei.value))
        for target in ('{"version": 2, "groups": [["127.0.0.1:1"], '
                       '["127.0.0.1:2"]], "virtual_nodes": 96}',
                       '{"version": 2, "groups": [["127.0.0.1:1"]]}'):
            P.Options(shard_map=good, rebalance_to=target,
                      rule_content="x", upstream=object()).validate()
        return msgs

    msgs = both(run)
    for m, want in zip(msgs, ("requires --shard-map", "must exceed",
                              "at most ONE group", "LAST group",
                              "rebalance-to:")):
        assert want in m


def test_live_move_over_loopback_hosts_of_both_packages(tmp_path):
    """A 3 -> 4 grow over loopback engine hosts (the JAX case's
    acceptance topology) under a writer on moving slices and a checker
    on staying ones: zero acked writes lost, never fail-open, the stream
    gap- and duplicate-free; run by the port's planner over port hosts
    and by the JAX planner over JAX hosts, with the same end state."""

    def run(P):
        from torch_parity import serving

        n_ns = 24
        old, new = _map(P, 3, 1), _map(P, 4, 2)
        engines = [P.engine(SCHEMA_YAML) for _ in range(4)]
        ctxs = [serving(P.EngineServer, e) for e in engines]
        servers = [c.__enter__() for c in ctxs]
        clients = [P.RemoteEngine("127.0.0.1", s.port, timeout=30)
                   for s in servers]
        try:
            journal = P.SplitJournal(str(tmp_path / P.name / "sj.sqlite"))
            p = P.ShardedEngine(old, clients[:3], journal=journal)
            p.write_relationships(_seed_writes(P, n_ns))
            t = P.MapTransition(old, new, P.plan_moves(old, new))
            moving, staying = _moving_split(t, n_ns)
            stream = p.watch_push_stream(p.revision_vector())
            acked, fail_open = [], []
            go, stop = threading.Event(), threading.Event()

            def checker():
                go.wait(30)
                j = 0
                while not stop.is_set():
                    ns = staying[j % len(staying)]
                    if p.check(P.CheckItem("pod", f"{ns}/p0", "view",
                                           "user", "intruder")):
                        fail_open.append(ns)
                    j += 1

            def writer():
                go.wait(30)
                for i in range(30):
                    ns = moving[i % len(moving)]
                    p.write_relationships([P.WriteOp("touch", rel(
                        P, "pod", f"{ns}/p0", "viewer", "user",
                        f"mv{i}"))])
                    acked.append((ns, f"mv{i}"))

            threads = [threading.Thread(target=checker, daemon=True),
                       threading.Thread(target=writer, daemon=True)]
            for th in threads:
                th.start()
            coord = p.begin_rebalance(new, new_clients={3: clients[3]},
                                      batch_rows=8)
            go.set()
            assert coord.wait(120) and coord.error is None, coord.error
            threads[1].join(60)
            stop.set()
            threads[0].join(60)
            assert not fail_open and p.map.version == 2
            for ns, name in acked:
                assert p.exists(P.RelationshipFilter(
                    resource_type="pod", resource_id=f"{ns}/p0",
                    relation="viewer", subject_id=name)), (ns, name)
            want, seen = {n for _, n in acked}, []
            deadline = time.monotonic() + 30
            while not want <= set(seen) and time.monotonic() < deadline:
                seen += [e.relationship.subject_id
                         for e in stream.next_batch()
                         if e.relationship.subject_id.startswith("mv")]
            stream.close()
            assert set(seen) == want and len(seen) == len(want)
            deadline = time.monotonic() + 30
            while not all(x.gc_complete for x in p._archived_transitions) \
                    and time.monotonic() < deadline:
                time.sleep(0.01)
            out = (_slices(t), _stores(P, engines), sorted(seen),
                   journal.load_transition()["phase"])
            p.close()
            return out
        finally:
            for c in clients:
                c.close()
            for c in ctxs:
                c.__exit__(None, None, None)

    both(run)


class _Gate:
    """A group whose next lookup answers from the state it sees on entry
    but returns only once ``release`` is set: a leg that ran before a
    slice's cut and merges after it."""

    def __init__(self, inner):
        self._inner = inner
        self.entered, self.release = threading.Event(), threading.Event()
        self.armed = False

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def lookup_resources(self, *a, **kw):
        out = self._inner.lookup_resources(*a, **kw)
        if self.armed:
            self.armed = False
            self.entered.set()
            assert self.release.wait(30)
        return out


def test_a_gather_straddling_a_cut_is_exact_in_the_port():
    """Deliberate difference from the JAX package: a list whose legs ran
    before a slice's cut and whose merge ran after it drops the slice
    from both sides there (the source's rows are no longer the read
    owner's, the destination answered before its copy); the port re-runs
    the gather when the routing epoch moved under it."""

    def run(P):
        n_ns = 24
        engines = [P.engine(SCHEMA_YAML) for _ in range(3)]
        gate = _Gate(engines[2])
        old = _map(P, 2, 1)
        new = P.ShardMap(version=2, groups=old.groups + ((("h", 9),),))
        p = P.ShardedEngine(old, engines[:2])
        p.write_relationships(_seed_writes(P, n_ns))
        t = P.MapTransition(old, new, P.plan_moves(old, new))
        p._install_transition(t, {2: gate})
        sl = t.slices[0]
        u = next(f"u{i % 4}" for i in range(n_ns)
                 if t.slice_for_key(f"ns{i}", "pod") is sl)
        want = sorted(p.lookup_resources("pod", "view", "user", u))
        gate.armed = True
        box = {}
        th = threading.Thread(target=lambda: box.update(
            got=p.lookup_resources("pod", "view", "user", u)))
        th.start()
        assert gate.entered.wait(30)
        coord = P.RebalanceCoordinator(p, t)
        copy_rev, rows = coord._slice_read(sl.src, sl.ranges)
        coord._slice_load(sl.dst, rows)
        t.set_state(sl, "catchup", copy_rev=copy_rev, replayed=copy_rev)
        while coord._catch_up_once(sl) > 0:
            pass
        t.set_state(sl, P.rebalance.CUT,
                    src_cut=coord._src_revision(sl.src),
                    dst_cut=coord._src_revision(sl.dst))
        gate.release.set()
        th.join(60)
        got = sorted(box["got"])
        after = sorted(p.lookup_resources("pod", "view", "user", u))
        p.close()
        return want, got, after

    jwant, jgot, jafter = run(JAX)
    want, got, after = run(PORT)
    assert (want, after) == (jwant, jafter) and got == want == after
    assert set(jgot) < set(jwant), "the JAX planner's straddling gather"
