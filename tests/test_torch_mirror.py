"""PyTorch port, the engine mirror (parallel/multihost.py) and the engine
host's mirror stream, held against the JAX package.

- test_persistence.py's seven mirror cases (the bulk-load frame, the
  catch-up forms, the join barrier, the diverged follower, catch-up over
  TCP, follower persistence across a state transfer), each run three
  ways: a port leader with a port follower, a port leader with a JAX
  follower, and a JAX leader with a port follower. Frames, catch-up
  payloads and state transfers cross packages unchanged; the stores end
  equal row for row, and where a case compares answers, the masks are
  byte-equal.
- test_engine_tls.py's mirror stream over TLS and test_scaleout.py's
  two-group run (group 0 a ``--peers`` set of port host CLIs whose leader
  is SIGKILLed) on the port (``port_cases``).
- The port's own risks: an effects catch-up on a follower whose graph
  is already compiled, a full-state transfer onto a follower with a
  compiled graph and a warm decision cache (the restore path), the
  state transfer's ``Persistence.rebase`` against the JAX one, an
  oversized write refused on the leader and never published, a follower
  over a smaller overlay than its leader's, the ops a mirrored leader
  passes through unmirrored (as the JAX package does), the single-host
  answer to ``mirror_subscribe``, a ``--peers`` host without
  ``--device`` (cuda, never the CPU), the demo and the kernel-build
  counters.
"""

from __future__ import annotations

import asyncio
import importlib
import json
import os
import struct
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from torch_parity import package, port_cases, serving

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCHEMA_TEXT = """
use expiration

definition user {}
definition group { relation member: user }
definition ns {
  relation viewer: user | group#member | user with expiration
  relation banned: user
  permission view = viewer - banned
}
"""


def pkg(name: str):
    """``torch_parity.package(name)`` with the mirror (``mh``), the
    persistence package and ``engine(**kw)`` over SCHEMA_TEXT (on the
    CPU for the port)."""
    P = package(name)
    P.mh = importlib.import_module(f"{P.base}.parallel.multihost")
    P.persistence = importlib.import_module(f"{P.base}.persistence")
    P.parse_schema = importlib.import_module(f"{P.base}.models").parse_schema
    base_engine = P.engine
    P.engine = lambda **kw: base_engine(
        schema=P.parse_schema(SCHEMA_TEXT), **kw)
    return P


JAX, PORT = pkg("jax"), pkg("torch")
PAIRS = [(PORT, PORT), (PORT, JAX), (JAX, PORT)]
PAIR_IDS = ["torch-torch", "torch-jax", "jax-torch"]


def rel(P, i, u="u0", exp=None):
    return P.Relationship("ns", f"n{i}", "viewer", "user", u, None, exp)


def all_reads(P, store):
    return sorted(str(r) for r in store.read(P.RelationshipFilter()))


def _frame_from_wire(wire):
    (n,) = struct.unpack(">I", wire[:4])
    body = wire[4:4 + n]
    if body[:1] == b"\x00":
        (m,) = struct.unpack(">I", body[1:5])
        return json.loads(body[5:5 + m]), body[5 + m:]
    return json.loads(body), None


USERS = ("u0", "u1", "u2", "u9", "late", "after", "ghost", "leader-only")


def _answers(P, e):
    """(ids, packed mask bytes) per user of ``ns#view``, and the same
    users' check verdicts on every ns id the store holds."""
    out = {}
    ids = sorted({r.resource_id for r in e.store.read(
        P.RelationshipFilter(resource_type="ns"))})
    for u in USERS:
        mask, interner = e.lookup_resources_mask("ns", "view", "user", u)
        m = np.asarray(mask, dtype=bool)
        got = sorted(interner.string(int(i)) for i in np.flatnonzero(m))
        out[u] = (got, np.packbits(m).tobytes())
    items = [P.CheckItem("ns", i, "view", "user", u)
             for i in ids for u in USERS]
    out["checks"] = list(e.check_bulk(items)) if items else []
    return out


def _same(Pl, leader_engine, Pf, follower, answers=False):
    assert follower.revision == leader_engine.revision
    assert all_reads(Pf, follower.store) \
        == all_reads(Pl, leader_engine.store)
    if answers:
        assert _answers(Pf, follower) == _answers(Pl, leader_engine)


# -- test_persistence.py's mirror cases, across packages ---------------------


@pytest.mark.parametrize("Pl,Pf", PAIRS, ids=PAIR_IDS)
def test_mirror_bulk_load_rides_binary_frame(Pl, Pf):
    leader = Pl.mh.MirroredEngine(Pl.engine())
    q = leader.subscribe()
    n = 500
    leader.bulk_load({
        "resource_type": ["ns"] * n,
        "resource_id": np.asarray([f"n{i}" for i in range(n)]),
        "relation": ["viewer"] * n,
        "subject_type": ["user"] * n,
        "subject_id": [f"u{i % 13}" for i in range(n)],
    })
    msg, blob = _frame_from_wire(q.get_nowait())
    assert blob is not None, "bulk_load frame should carry a binary blob"
    assert "cols" not in msg["frame"], "per-cell JSON lists are retired"
    follower = Pf.engine()
    Pf.mh.apply_mirror_frame(follower, msg["frame"], blob)
    assert len(follower.store) == len(leader.engine.store)
    _same(Pl, leader.engine, Pf, follower)


@pytest.mark.parametrize("Pl,Pf", PAIRS, ids=PAIR_IDS)
def test_subscribe_with_catchup_atomic_cut(Pl, Pf):
    leader = Pl.mh.MirroredEngine(Pl.engine())
    for i in range(6):
        leader.write_relationships([Pl.WriteOp("touch", rel(Pl, i))])
    leader.delete_relationships(Pl.RelationshipFilter(resource_id="n2"))
    follower = Pf.engine()
    q, meta, payload = leader.subscribe_with_catchup(follower.revision)
    assert payload is None and meta["effects"]
    Pf.mh.apply_catchup(follower, meta, payload)
    _same(Pl, leader.engine, Pf, follower)
    # live frames continue exactly where the catch-up landed
    leader.write_relationships([Pl.WriteOp("touch", rel(Pl, 50, "late"))])
    msg, blob = _frame_from_wire(q.get_nowait())
    Pf.mh.apply_mirror_frame(follower, msg["frame"], blob)
    _same(Pl, leader.engine, Pf, follower, answers=True)


@pytest.mark.parametrize("Pl,Pf", PAIRS, ids=PAIR_IDS)
def test_subscribe_with_catchup_full_state_after_bulk_load(Pl, Pf):
    leader = Pl.mh.MirroredEngine(Pl.engine())
    leader.bulk_load({
        "resource_type": ["ns"] * 4,
        "resource_id": ["a", "b", "c", "d"],
        "relation": ["viewer"] * 4,
        "subject_type": ["user"] * 4,
        "subject_id": ["u1"] * 4,
    })
    leader.write_relationships([Pl.WriteOp("touch", rel(Pl, 9, "u9"))])
    follower = Pf.engine()
    # the bulk load predates the follower's revision horizon -> a state
    # transfer, not an effects replay
    q, meta, payload = leader.subscribe_with_catchup(0)
    assert payload is not None and meta.get("state")
    Pf.mh.apply_catchup(follower, meta, payload)
    _same(Pl, leader.engine, Pf, follower, answers=True)


@pytest.mark.parametrize("Pl,Pf", PAIRS, ids=PAIR_IDS)
def test_catchup_subscribe_satisfies_join_barrier(Pl, Pf):
    leader = Pl.mh.MirroredEngine(Pl.engine(), min_subscribers=1,
                                  join_timeout=30.0)
    done = threading.Event()

    def first_write():
        leader.write_relationships([Pl.WriteOp("touch", rel(Pl, 0))])
        done.set()

    t = threading.Thread(target=first_write, daemon=True)
    t.start()
    time.sleep(0.2)  # the writer is parked on the join barrier
    assert not done.is_set()
    follower = Pf.engine()
    q, meta, payload = leader.subscribe_with_catchup(follower.revision)
    assert done.wait(10), "catch-up subscribe did not satisfy the barrier"
    t.join(10)
    Pf.mh.apply_catchup(follower, meta, payload)
    skip_upto = meta["seq"]
    leader.write_relationships([Pl.WriteOp("touch", rel(Pl, 1))])
    while not q.empty():
        msg, blob = _frame_from_wire(q.get_nowait())
        frame = msg["frame"]
        if frame["seq"] <= skip_upto:
            continue
        Pf.mh.apply_mirror_frame(follower, frame, blob)
    _same(Pl, leader.engine, Pf, follower)


@pytest.mark.parametrize("Pl,Pf", PAIRS, ids=PAIR_IDS)
def test_catchup_diverged_follower_gets_full_state(Pl, Pf):
    leader = Pl.mh.MirroredEngine(Pl.engine())
    leader.write_relationships(
        [Pl.WriteOp("touch", rel(Pl, 0, "leader-only"))])
    follower = Pf.engine()
    for i in range(5):  # divergent history the leader never saw
        follower.write_relationships(
            [Pf.WriteOp("touch", rel(Pf, i, "ghost"))])
    assert follower.revision > leader.engine.revision
    q, meta, payload = leader.subscribe_with_catchup(follower.revision)
    assert payload is not None and meta.get("state")
    Pf.mh.apply_catchup(follower, meta, payload)
    _same(Pl, leader.engine, Pf, follower)


@pytest.mark.parametrize("Pl,Pf", PAIRS, ids=PAIR_IDS)
def test_follower_catchup_over_tcp_converges_without_bulk_load(
        Pl, Pf, tmp_path):
    leader = Pl.mh.MirroredEngine(Pl.engine())
    for i in range(8):
        leader.write_relationships(
            [Pl.WriteOp("touch", rel(Pl, i, f"u{i % 2}"))])
    leader.delete_relationships(Pl.RelationshipFilter(resource_id="n5"))
    follower = Pf.engine()
    follower.enable_persistence(str(tmp_path / "fdata"), wal_fsync="off",
                                auto_checkpoint=False)
    for i in range(3):
        follower.write_relationships(
            [Pf.WriteOp("touch", rel(Pf, i, f"u{i % 2}"))])
    assert all_reads(Pf, follower.store) \
        != all_reads(Pl, leader.engine.store)

    def converged():
        return follower.revision == leader.engine.revision and \
            all_reads(Pf, follower.store) \
            == all_reads(Pl, leader.engine.store)

    try:
        with serving(Pl.remote.EngineServer, leader, token="t") as srv:
            ft = threading.Thread(
                target=Pf.mh.follower_loop, daemon=True,
                args=(follower, "127.0.0.1", srv.port, "t", None, None,
                      follower.revision))
            ft.start()
            deadline = time.monotonic() + 30
            while not converged() and time.monotonic() < deadline:
                time.sleep(0.05)
            assert converged()
            leader.write_relationships(
                [Pl.WriteOp("touch", rel(Pl, 77, "after"))])
            deadline = time.monotonic() + 30
            while not converged() and time.monotonic() < deadline:
                time.sleep(0.05)
            _same(Pl, leader.engine, Pf, follower, answers=True)
        ft.join(30)  # leader gone -> follower_loop returns
        assert not ft.is_alive()
    finally:
        follower.close_persistence(final_checkpoint=False)


@pytest.mark.parametrize("Pl,Pf", PAIRS, ids=PAIR_IDS)
def test_follower_persistence_survives_catchup_restart(Pl, Pf, tmp_path):
    leader = Pl.mh.MirroredEngine(Pl.engine())
    leader.bulk_load({
        "resource_type": ["ns"] * 3, "resource_id": ["a", "b", "c"],
        "relation": ["viewer"] * 3, "subject_type": ["user"] * 3,
        "subject_id": ["u1", "u2", "u3"],
    })
    d = str(tmp_path / "fdata")
    follower = Pf.engine()
    p = follower.enable_persistence(d, wal_fsync="off",
                                    auto_checkpoint=False)
    q, meta, payload = leader.subscribe_with_catchup(0)
    Pf.mh.apply_catchup(follower, meta, payload)
    p.wal.sync()
    follower.close_persistence(final_checkpoint=False)

    reborn = Pf.engine()
    p2 = reborn.enable_persistence(d, wal_fsync="off",
                                   auto_checkpoint=False)
    _same(Pl, leader.engine, Pf, reborn)
    reborn.close_persistence(final_checkpoint=False)
    assert p2.recovery.replayed_records >= 1


# -- test_engine_tls.py and test_scaleout.py, on the port ---------------------

_TLS = port_cases("test_engine_tls.py", names=["test_mirror_stream_over_tls"],
                  replacements=(("Engine()", 'Engine(device="cpu")'),))
globals().update(_TLS)
pki = _TLS["test_mirror_stream_over_tls"].__globals__["pki"]

_SCALEOUT = port_cases(
    "test_scaleout.py",
    names=["test_e2e_two_tcp_groups_failover_and_split_replay"],
    replacements=(
        ("return Engine(bootstrap=SCHEMA_YAML)",
         'return Engine(bootstrap=SCHEMA_YAML, device="cpu")'),
        ('os.environ["JAX_PLATFORMS"] = "cpu"\nsys.path.insert(0, repo)\n'
         'import jax\njax.config.update("jax_platforms", "cpu")\n',
         "sys.path.insert(0, repo)\n"),
        ('"--token", "sh-tok", "--engine-insecure",',
         '"--token", "sh-tok", "--engine-insecure", "--device", "cpu",'),
    ))
globals().update(_SCALEOUT)


def test_the_ported_cases_run_on_the_port():
    from spicedb_kubeapi_proxy_tpu_torch.parallel import multihost

    g = _TLS["test_mirror_stream_over_tls"].__globals__
    assert g["EngineServer"] is PORT.remote.EngineServer
    assert "multihost" in multihost.__name__
    g = _SCALEOUT[
        "test_e2e_two_tcp_groups_failover_and_split_replay"].__globals__
    assert g["ShardedEngine"].__module__.startswith(
        "spicedb_kubeapi_proxy_tpu_torch.")
    assert "torch.engine.remote import main" in g["_HOST_WORKER"]


# -- the port's own risks -------------------------------------------------------


def _leader_and_follower(**kw):
    leader = PORT.mh.MirroredEngine(PORT.engine(**kw))
    return leader, leader.subscribe()


def _replay(q, follower):
    while not q.empty():
        msg, blob = _frame_from_wire(q.get_nowait())
        PORT.mh.apply_mirror_frame(follower, msg["frame"], blob)


def test_effects_catchup_on_a_compiled_follower_answers_the_leaders_masks(
        monkeypatch):
    """The effects catch-up writes the follower's store directly; its next
    read must bring the compiled graph current (an overlay update or a
    counted recompile), never answer from the stale resident graph."""
    from spicedb_kubeapi_proxy_tpu_torch.ops import reachability

    monkeypatch.setattr(reachability, "DENSE_MIN_EDGES", 2)
    leader = PORT.mh.MirroredEngine(PORT.engine())
    follower = PORT.engine()
    for e, P in ((leader, PORT), (follower, PORT)):
        e.write_relationships([P.WriteOp("touch", rel(P, i, f"u{i % 3}"))
                               for i in range(6)])
    before = _answers(PORT, follower)  # compiles the follower's graph
    assert follower.compiled().revision == follower.revision
    for i in range(6, 12):
        leader.write_relationships(
            [PORT.WriteOp("touch", rel(PORT, i, f"u{i % 3}"))])
    leader.write_relationships([PORT.WriteOp("touch", PORT.Relationship(
        "ns", "n1", "banned", "user", "u1"))])
    leader.delete_relationships(PORT.RelationshipFilter(resource_id="n0"))
    m = PORT.metrics
    inc0 = m.counter("engine_graph_incremental_updates_total").value
    comp0 = m.counter("engine_graph_compiles_total").value
    q, meta, payload = leader.subscribe_with_catchup(follower.revision)
    assert payload is None and len(meta["effects"]) == 8
    PORT.mh.apply_catchup(follower, meta, payload)
    after = _answers(PORT, follower)
    assert after == _answers(PORT, leader.engine)
    assert after != before
    assert m.counter("engine_graph_incremental_updates_total").value \
        + m.counter("engine_graph_compiles_total").value > inc0 + comp0
    assert follower.compiled().revision == leader.engine.revision


def test_full_state_transfer_goes_through_the_restore_path():
    """A diverged lineage at the SAME revision number: the transfer must
    drop the follower's compiled views, free their device state and
    replace its decision cache (a cached verdict keyed on the colliding
    revision would answer from the old lineage)."""
    inner = PORT.engine()
    leader = PORT.mh.MirroredEngine(inner, term=2)
    for i in range(3):
        leader.write_relationships(
            [PORT.WriteOp("touch", rel(PORT, i, "u1"))])
    follower = PORT.engine()
    follower.enable_decision_cache(max_entries=64)
    for i in range(3):
        follower.write_relationships(
            [PORT.WriteOp("touch", rel(PORT, i, "ghost"))])
    assert follower.revision == leader.engine.revision
    stale = _answers(PORT, follower)  # fills the cache at revision 3
    cache0, lineage0 = follower._decision_cache, follower._lineage
    old = follower._head
    q, meta, payload = leader.subscribe_with_catchup(
        follower.revision, subscriber_term=1)
    assert payload is not None and meta.get("state")
    PORT.mh.apply_catchup(follower, meta, payload)
    assert follower._lineage == lineage0 + 1
    assert follower._decision_cache is not cache0
    assert follower._head is None and follower._compiled is None
    assert old.resident.released
    fresh = _answers(PORT, follower)
    assert fresh == _answers(PORT, leader.engine)
    assert fresh != stale


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_state_transfer_rebase_matches_the_jax_package(writer, tmp_path):
    """``Persistence.rebase`` (the follower's full-state catch-up with a
    data dir): the old lineage's WAL and snapshots go, the transferred
    baseline is the new log's first record, and both packages' rebased
    dirs recover to the leader's rows, in either package."""
    W = {"torch": PORT, "jax": JAX}[writer]
    leader = W.mh.MirroredEngine(W.engine())
    leader.bulk_load({
        "resource_type": ["ns"] * 5,
        "resource_id": [f"b{i}" for i in range(5)],
        "relation": ["viewer"] * 5, "subject_type": ["user"] * 5,
        "subject_id": [f"u{i}" for i in range(5)]})
    leader.write_relationships([W.WriteOp("touch", rel(W, 7, "u7"))])
    q, meta, payload = leader.subscribe_with_catchup(0)
    want = all_reads(W, leader.engine.store)
    dirs = {}
    for P in (PORT, JAX):
        d = str(tmp_path / f"{P.name}-follower")
        f = P.engine()
        p = f.enable_persistence(d, wal_fsync="always",
                                 auto_checkpoint=False)
        for i in range(4):  # an old lineage, journaled and checkpointed
            f.write_relationships([P.WriteOp("touch", rel(P, i, "old"))])
        p.checkpoint_now()
        f.write_relationships([P.WriteOp("touch", rel(P, 9, "old"))])
        P.mh.apply_catchup(f, meta, payload)
        assert all_reads(P, f.store) == want
        f.write_relationships([P.WriteOp("touch", rel(P, 11, "new"))])
        f.close_persistence(final_checkpoint=False)
        assert P.persistence.list_snapshots(
            os.path.join(d, "snapshots")) == []
        dirs[P.name] = d
    got = {}
    for name, d in dirs.items():
        for P in (PORT, JAX):
            r = P.engine()
            r.enable_persistence(d, wal_fsync="off", auto_checkpoint=False)
            got[(name, P.name)] = (r.revision, all_reads(P, r.store))
            r.close_persistence(final_checkpoint=False)
    assert len(set(map(repr, got.values()))) == 1, got
    assert got[("torch", "torch")][1] == sorted(
        want + [str(rel(PORT, 11, "new"))])


def test_oversized_write_is_refused_on_the_leader_and_never_published():
    """With the compactor on, a write larger than the whole overlay is
    refused by the leader's headroom check, before the frame is
    published: the follower never sees it, and nothing applied. The JAX
    package sheds it there too (with back-pressure), also unpublished."""
    from spicedb_kubeapi_proxy_tpu_torch.engine.compaction import (
        WriteTooLarge,
    )

    seen = {}
    for P, cap in ((PORT, 64), (JAX, 64)):
        inner = P.engine(delta_capacity=cap)
        inner.write_relationships([P.WriteOp("touch", rel(P, 0))])
        inner.check_bulk([P.CheckItem("ns", "n0", "view", "user", "u0")])
        inner.enable_compaction(0.75)
        try:
            leader = P.mh.MirroredEngine(inner, term=1,
                                         mirror_queries=False,
                                         sync_replication=True)
            q = leader.subscribe()
            rev = inner.revision
            big = [P.WriteOp("touch", rel(P, 100 + i)) for i in range(64)]
            with pytest.raises(Exception) as ex:
                leader.write_relationships(big)
            assert q.empty(), "a refused write must never be published"
            assert inner.revision == rev
            seen[P.name] = type(ex.value).__name__
        finally:
            inner.close_compaction()
    # the port refuses it for good; the JAX package sheds it (and would
    # shed it after every fold, ROADMAP C): either way before publishing
    assert seen == {"torch": WriteTooLarge.__name__,
                    "jax": "OverlayBackpressure"}


def test_follower_over_a_smaller_overlay_applies_every_frame():
    """The leader's overlay absorbs a write that is larger than the
    follower's whole overlay. The follower applies mirror frames with the
    headroom check off, so it applies the write (an overflow recompile)
    instead of refusing it, which ``apply_mirror_frame`` would swallow as
    "failed identically" and fork the lineage."""
    leader = PORT.mh.MirroredEngine(PORT.engine(delta_capacity=4096))
    q = leader.subscribe()
    follower = PORT.engine(delta_capacity=64)
    leader.write_relationships([PORT.WriteOp("touch", rel(PORT, 0))])
    _replay(q, follower)
    follower.check_bulk([PORT.CheckItem("ns", "n0", "view", "user", "u0")])
    leader.engine.check_bulk(
        [PORT.CheckItem("ns", "n0", "view", "user", "u0")])
    follower.enable_compaction(0.75)
    try:
        limit = follower.max_write_records()
        assert limit is not None and limit < 64
        big = [PORT.WriteOp("touch", rel(PORT, 100 + i, f"u{i % 3}"))
               for i in range(64)]
        leader.write_relationships(big)
        _replay(q, follower)
        _same(PORT, leader.engine, PORT, follower, answers=True)
    finally:
        follower.close_compaction()


def _published_methods(P, tmp_path):
    """Drive the scale-out and migration ops over the wire against a
    mirrored leader of package ``P``; return the mirror frames' methods
    each op published (and what it answered)."""
    inner = P.engine()
    leader = P.mh.MirroredEngine(inner, term=1, mirror_queries=False,
                                 sync_replication=False)
    q = leader.subscribe()
    out = []

    def drain():
        got = []
        while not q.empty():
            msg, _ = _frame_from_wire(q.get_nowait())
            got.append(msg["frame"]["method"])
        return got

    with serving(P.remote.EngineServer, leader) as srv:
        c = P.remote.RemoteEngine("127.0.0.1", srv.port)
        try:
            rels = [P.Relationship("ns", f"team/s{i}", "viewer", "user",
                                   "u1") for i in range(5)]
            c.slice_load(rels)
            out.append(("slice_load", drain()))
            c.slice_apply([P.WriteOp("delete", rels[0])])
            out.append(("slice_apply", drain()))
            out.append(("slice_read", len(c.slice_read(
                [(0, 1 << 64)], want_globals=True)[1]), drain()))
            c.slice_drop([(0, 1 << 64)])
            out.append(("slice_drop", drain()))
            try:  # the exclusion schema is not monotone: refused
                pairs = c.frontier_pairs()
            except Exception as e:  # noqa: BLE001 - compared below
                pairs = type(e).__name__
            out.append(("frontier_pairs", pairs, drain()))
            target = SCHEMA_TEXT.replace(
                "  relation banned: user\n",
                "  relation banned: user\n  relation extra: user\n")
            c.migrate_begin(target)
            deadline = time.monotonic() + 30
            while (c.migrate_status() or {}).get("phase") not in (
                    "done", None) and time.monotonic() < deadline:
                time.sleep(0.05)
            out.append(("migrate", (c.migrate_status() or {}).get("phase"),
                        drain()))
            c.write_relationships([P.WriteOp("touch", rel(P, 1))])
            out.append(("write", drain()))
        finally:
            c.close()
    return out


def test_unmirrored_ops_pass_through_as_in_the_jax_package(tmp_path):
    """``MirroredEngine.__getattr__`` passes what it does not define to
    the inner engine in both packages: the mover's slice writes reach the
    mirror as write frames (they go through ``write_relationships``), the
    slice and frontier reads publish nothing, and a schema migration
    runs on the leader alone (no frame: a follower keeps the old schema).
    The port's leader publishes exactly what the JAX leader publishes."""
    got = {P.name: _published_methods(P, tmp_path) for P in (JAX, PORT)}
    assert got["torch"] == got["jax"]
    by_op = {row[0]: row[-1] for row in got["torch"]}
    # five rows land as power-of-two chunks: two mirrored writes
    assert by_op["slice_load"] == ["write_relationships"] * 2
    assert by_op["slice_apply"] == ["write_relationships"]
    assert by_op["slice_drop"] == ["write_relationships"]  # four rows
    assert by_op["slice_read"] == [] and by_op["frontier_pairs"] == []
    assert by_op["migrate"] == []
    assert by_op["write"] == ["write_relationships"]


def test_mirror_subscribe_on_a_single_host_answers_as_the_jax_host():
    import socket

    frames = {}
    for P in (JAX, PORT):
        with serving(P.remote.EngineServer, P.engine()) as srv:
            s = socket.create_connection(("127.0.0.1", srv.port), timeout=10)
            try:
                s.sendall(P.remote._pack({"op": "mirror_subscribe",
                                          "from_revision": 0}))
                frames[P.name] = P.remote._read_frame_sync(s)
            finally:
                s.close()
    assert frames["torch"] == frames["jax"]
    assert frames["torch"]["kind"] == "store"
    assert "not a multi-host leader" in frames["torch"]["error"]


def test_a_peers_host_without_device_runs_on_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: no --device means cuda there")
    proc = subprocess.run(
        [sys.executable, "-m", "spicedb_kubeapi_proxy_tpu_torch.engine.remote",
         "--engine-insecure", "--peers", "127.0.0.1:1,127.0.0.1:2",
         "--peer-id", "1", "--data-dir", str(tmp_path / "d")],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2
    assert "CUDA device requested but torch.cuda.is_available() is " \
        "False" in proc.stderr


_HOST_FLAGS = (
    ("--peers", ["127.0.0.1:1,127.0.0.1:2"]),
    ("--peer-id", ["1"]),
    ("--mirror-heartbeat-seconds", ["0.5"]),
    ("--mirror-heartbeat-timeout", ["3"]),
    ("--replication-timeout", ["5"]),
    ("--min-sync-replicas", ["1"]),
    ("--failover-boot-grace", ["5"]),
    ("--mirror-ca-file", ["/nonexistent/ca.pem"]),
    ("--mirror-skip-verify-ca", []),
)


@pytest.mark.parametrize("flag,args", _HOST_FLAGS,
                         ids=[f for f, _ in _HOST_FLAGS])
def test_engine_host_cli_accepts_failover_flags(capsys, flag, args):
    """Each flag the host refused until the mirror landed now parses and
    reaches the validation the JAX host gives it: an out-of-range peer id
    and a missing CA file are the JAX host's own errors."""
    from spicedb_kubeapi_proxy_tpu_torch.engine import remote

    argv = ["--device", "meta", flag, *args]
    if flag == "--peer-id":
        argv += ["--peers", "127.0.0.1:1"]
    elif flag not in ("--peers", "--mirror-ca-file",
                      "--mirror-skip-verify-ca"):
        argv += ["--peers", "127.0.0.1:1,127.0.0.1:2"]
    if flag not in ("--mirror-ca-file", "--mirror-skip-verify-ca"):
        argv.append("--engine-insecure")
    else:
        argv += ["--tls-cert-file", "/nonexistent/c.pem",
                 "--tls-key-file", "/nonexistent/k.pem"]
    with pytest.raises(SystemExit) as ex:
        remote.main(argv)
    assert ex.value.code == 2
    err = capsys.readouterr().err
    assert "not supported" not in err and "ROADMAP" not in err
    if flag == "--peer-id":
        assert "--peer-id 1 out of range for 1 peers" in err
    elif flag in ("--mirror-ca-file", "--mirror-skip-verify-ca"):
        assert "nonexistent" in err
    else:
        # every failover check passed: the run stops at the device
        assert "meta" in err


# -- the demo and the build counters --------------------------------------------


def test_demo_serves_both_users_on_the_cpu():
    from spicedb_kubeapi_proxy_tpu_torch.proxy import demo
    from spicedb_kubeapi_proxy_tpu_torch.proxy.inmemory import InMemoryClient

    cfg = demo.build(port=0, device="cpu")
    assert str(cfg.engine.device) == "cpu"

    async def go():
        await cfg.workflow.resume_pending()
        seen = {}
        for user in ("alice", "carol"):
            r = await InMemoryClient(cfg.server.handle, user=user).get(
                "/api/v1/namespaces")
            assert r.status == 200
            seen[user] = [i["metadata"]["name"]
                          for i in json.loads(r.body)["items"]]
        r = await InMemoryClient(cfg.server.handle, user="alice").post(
            "/api/v1/namespaces", {"metadata": {"name": "mine"}})
        assert r.status == 201, r.body
        r = await InMemoryClient(cfg.server.handle, user="alice").get(
            "/api/v1/namespaces")
        seen["alice-after"] = sorted(
            i["metadata"]["name"] for i in json.loads(r.body)["items"])
        await cfg.workflow.shutdown()
        return seen

    try:
        seen = asyncio.run(go())
    finally:
        cfg.engine.close_compaction()
    assert seen == {"alice": ["dev"], "carol": ["prod"],
                    "alice-after": ["dev", "mine"]}


def test_demo_without_device_asks_for_cuda():
    from spicedb_kubeapi_proxy_tpu_torch.proxy import demo
    from spicedb_kubeapi_proxy_tpu_torch.proxy.options import OptionsError

    if torch.cuda.is_available():
        pytest.skip("a card is present: the demo runs on it")
    with pytest.raises(OptionsError, match="CUDA device requested"):
        demo.build(port=0)


def test_kernel_and_native_builds_are_counted(monkeypatch, tmp_path):
    """obs/profile's hook (installed by every engine) counts each build
    the process runs, by source, and nothing for a build found on disk."""
    from spicedb_kubeapi_proxy_tpu_torch import native
    from spicedb_kubeapi_proxy_tpu_torch.obs import profile
    from spicedb_kubeapi_proxy_tpu_torch.ops import kernels

    PORT.engine()
    assert profile.install_kernel_build_hook()
    assert kernels.build_listeners.count(profile._on_build) == 1
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\nwhile [ \"$1\" != -o ]; do shift; done\n"
                    "touch \"$2\"\n")
    fake.chmod(0o755)
    monkeypatch.setenv("NVCC", str(fake))
    monkeypatch.setattr(kernels, "KERNEL_DIR", str(tmp_path / "k"))
    monkeypatch.setattr(kernels, "library_path", lambda name: str(
        tmp_path / "k" / f"lib{name}.so"))
    m = PORT.metrics
    c = m.counter("engine_kernel_builds_total", source="bitprop.cu")
    n0 = c.value
    kernels.build("bitprop")
    kernels.build("bitprop")  # on disk now: no second build
    assert c.value == n0 + 1
    assert sum(m.histogram("engine_kernel_build_seconds",
                           source="bitprop.cu").counts) >= 1
    if os.path.exists("/usr/bin/g++"):
        monkeypatch.setattr(native, "_LIB", str(tmp_path / "libgc.so"))
        g = m.counter("engine_kernel_builds_total", source="graphcore.cpp")
        g0 = g.value
        assert native._build()
        assert g.value == g0 + 1


@pytest.mark.parametrize("leader_pkg", ["torch", "jax"])
def test_a_slow_state_transfer_keeps_its_follower(leader_pkg, monkeypatch):
    """A full state's cut and encode can outlast the follower's heartbeat
    window (~16 s at 10M rows against 2.5 s). The port's leader
    heartbeats the stream meanwhile and the follower catches up; the JAX
    leader sends nothing until the transfer, so its follower drops the
    stream as a dead leader (the reference's fault, ROADMAP C)."""
    L = {"torch": PORT, "jax": JAX}[leader_pkg]
    leader = L.mh.MirroredEngine(L.engine(), term=1)
    leader.bulk_load({
        "resource_type": ["ns"] * 6, "resource_id": [f"b{i}" for i in
                                                     range(6)],
        "relation": ["viewer"] * 6, "subject_type": ["user"] * 6,
        "subject_id": [f"u{i}" for i in range(6)]})
    store = leader.engine.store
    real = store.encode_state

    def slow(*a, **kw):
        time.sleep(1.5)
        return real(*a, **kw)

    monkeypatch.setattr(store, "encode_state", slow)
    follower = PORT.engine()
    with serving(L.remote.EngineServer, leader, token="t") as srv:
        srv.mirror_heartbeat = 0.2
        out = {}

        def follow():
            try:
                PORT.mh.follower_loop(
                    follower, "127.0.0.1", srv.port, "t", from_revision=0,
                    current_term=1, heartbeat_timeout=0.6,
                    fail_on_loss=True)
            except Exception as e:  # noqa: BLE001 - what the test reads
                out["error"] = e

        ft = threading.Thread(target=follow, daemon=True)
        ft.start()
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline and "error" not in out and \
                follower.revision != leader.engine.revision:
            time.sleep(0.05)
        caught_up = follower.revision == leader.engine.revision
        err = out.get("error")  # before the leader stops
    ft.join(20)
    if leader_pkg == "torch":
        assert caught_up and err is None, err
        _same(PORT, leader.engine, PORT, follower)
    else:
        assert not caught_up
        assert isinstance(err, PORT.mh.LeaderLost), err
