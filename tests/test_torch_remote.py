"""PyTorch port, the engine host (engine/remote.py) on the wire, held
against the JAX package on the CPU.

(a) Both wire directions: the JAX package's ``RemoteEngine`` against a
port ``EngineServer``, and the port's ``RemoteEngine`` against a JAX
``EngineServer``, on the repo's bootstrap and on bench.py's caveated
mesh graph under three request contexts. Every answer equals the JAX
engine's in process (verdicts, ids, masks, subjects, reads, ``exists``,
watch events, watch gates), and the two hosts' frames for the same
request are equal: JSON results, and the packed ``lookup_mask`` payload
byte for byte with its ``n``/``gen`` (the epoch is each store's own).
(b) The JAX package's test_remote_engine.py on the port (port client,
port host): round trips, the chunked bulk check, the mask frame and its
size, the incremental id sync across a restore, error kinds, token auth,
the pre-auth frame cap, the push watch with zero steady polls, fusion
across connections. (c) The JAX package's proxy, unchanged, serving
from a port host over ``tcp://``. (d) A full overlay on a port host
sheds as ``kind: "admission"`` (the JAX client raises its
``AdmissionRejected``, breaker closed), and test_admission.py's
engine-host shed on the port. (e) Every op whose engine half is not
ported answers ``kind: "store"`` naming its ROADMAP item. (f) A restore
during wire lookups never resolves a mask against another epoch's ids.

The JAX side runs its Pallas kernels in interpreter mode in (a); both
sides lower ``DENSE_MIN_EDGES`` there so dense blocks and bit duals
form. Every server runs on a loop thread of its own
(``torch_parity.serving``); every threaded wait is bounded.
"""

import dataclasses
import errno
import json
import os
import socket
import struct
import sys
import tempfile
import threading
import time

import numpy as np
import pytest

from bench import MESH_SCHEMA
from chip_smoke import build_rows
from spicedb_kubeapi_proxy_tpu.admission import \
    AdmissionRejected as JAdmissionRejected
from spicedb_kubeapi_proxy_tpu.engine import CheckItem as JCheckItem
from spicedb_kubeapi_proxy_tpu.engine import Engine as JEngine
from spicedb_kubeapi_proxy_tpu.engine import WriteOp as JWriteOp
from spicedb_kubeapi_proxy_tpu.engine import remote as jremote
from spicedb_kubeapi_proxy_tpu.engine.store import \
    RelationshipFilter as JRelationshipFilter
from spicedb_kubeapi_proxy_tpu.engine.store import StoreError as JStoreError
from spicedb_kubeapi_proxy_tpu.models import parse_schema as jparse_schema
from spicedb_kubeapi_proxy_tpu.models.tuples import \
    parse_relationship as jparse_rel
from spicedb_kubeapi_proxy_tpu.ops import reachability as jreach
from spicedb_kubeapi_proxy_tpu.utils.resilience import \
    STATE_CLOSED as JSTATE_CLOSED
from spicedb_kubeapi_proxy_tpu_torch import admission
from spicedb_kubeapi_proxy_tpu_torch.engine import (
    CheckItem,
    Engine,
    RelationshipFilter,
    WriteOp,
)
from spicedb_kubeapi_proxy_tpu_torch.engine import remote
from spicedb_kubeapi_proxy_tpu_torch.engine.compaction import (
    MAX_RETRY_AFTER,
    MIN_RETRY_AFTER,
    OverlayBackpressure,
)
from spicedb_kubeapi_proxy_tpu_torch.engine.engine import SchemaViolation
from spicedb_kubeapi_proxy_tpu_torch.engine.store import (
    Precondition,
    PreconditionFailed,
)
from spicedb_kubeapi_proxy_tpu_torch.models import parse_schema
from spicedb_kubeapi_proxy_tpu_torch.models.tuples import parse_relationship
from spicedb_kubeapi_proxy_tpu_torch.ops import reachability as treach
from spicedb_kubeapi_proxy_tpu_torch.utils.metrics import metrics
from spicedb_kubeapi_proxy_tpu_torch.utils.resilience import \
    DependencyUnavailable, STATE_CLOSED

from torch_parity import random_rels, serving

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NOW = time.time()
CONTEXTS = (None, {"ip": "10.1.2.3"}, {"ip": "192.168.1.1"})

with open(os.path.join(REPO, "deploy", "bootstrap.yaml")) as fh:
    BOOTSTRAP = fh.read()


def _within(fn, seconds: float = 60.0):
    """``fn()`` on a daemon thread, failing the test if it has not
    returned within ``seconds``."""
    box: dict = {}

    def run():
        try:
            box["value"] = fn()
        except BaseException as ex:  # noqa: BLE001 - re-raised below
            box["error"] = ex

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(seconds)
    assert not t.is_alive(), f"did not return within {seconds} s"
    if "error" in box:
        raise box["error"]
    return box["value"]


def _rel_tuple(r) -> tuple:
    return dataclasses.astuple(r)


def _events(evs) -> list:
    return [(e.revision, e.operation, _rel_tuple(e.relationship))
            for e in evs]


# ---------------------------------------------------------------------------
# (a) both wire directions against the JAX engine in process
# ---------------------------------------------------------------------------

# writes after each graph's load, the same on both engines, so both
# stores hold the same revisions and watch history
AFTER = {
    "bootstrap": [
        [("touch", "pod:p3#viewer@user:u7"),
         ("touch", "namespace:ns2#viewer@user:u4")],
        [("delete", "pod:p3#viewer@user:u7"),
         ("touch", "pod:p13#namespace@namespace:ns0")],
    ],
    "caveated": [
        [("touch", 'pod:ns/p1#viewer@user:u5[ip_allowlist:{"allowed":'
                   '["10.0.0.0/8"]}]'),
         ("touch", "pod:ns/p2#viewer@user:u6")],
        [("delete", "pod:ns/p2#viewer@user:u6")],
    ],
}


def _graph(kind: str):
    """(JAX engine, port engine, queries) holding the same store."""
    if kind == "bootstrap":
        rels = random_rels(np.random.default_rng(11), nested=False,
                           expiring="wildcard", now=NOW)
        je, te = JEngine(BOOTSTRAP), Engine(BOOTSTRAP, device="cpu")
        je.write_relationships([JWriteOp("touch", jparse_rel(r))
                                for r in rels])
        te.write_relationships([WriteOp("touch", parse_relationship(r))
                                for r in rels])
        q = {"perms": [("pod", "view"), ("namespace", "view")],
             "users": [f"u{i}" for i in range(9)] + ["nobody"],
             "contexts": (None,)}
    else:
        rows = build_rows(48, 16, 4, 8, 700, 2, cav_share=0.3)
        je = JEngine(schema=jparse_schema(MESH_SCHEMA))
        te = Engine(schema=parse_schema(MESH_SCHEMA), device="cpu")
        je.bulk_load(rows)
        te.bulk_load(rows)
        q = {"perms": [("pod", "view")],
             "users": [f"u{i}" for i in range(8)] + ["nobody"],
             "contexts": CONTEXTS}
    q["rev0"] = je.revision
    for batch in AFTER[kind]:
        je.write_relationships([JWriteOp(op, jparse_rel(r))
                                for op, r in batch])
        te.write_relationships([WriteOp(op, parse_relationship(r))
                                for op, r in batch])
    assert te.revision == je.revision
    q["resources"] = {
        rt: sorted({r.resource_id for r in je.read_relationships(
            JRelationshipFilter(resource_type=rt))})[:6] + ["ghost"]
        for rt, _ in q["perms"]}
    return je, te, q


def _same_frames(a, b, op: str, **args) -> None:
    """The two hosts' answers to one request: equal JSON results, or
    equal binary payloads with equal meta apart from the store epoch."""
    ra, rb = a._call_any(op, **args), b._call_any(op, **args)
    assert type(ra) is type(rb), (op, args)
    if isinstance(ra, tuple):
        (ma, pa), (mb, pb) = ra, rb
        assert set(ma) == set(mb) == {"found", "n", "gen", "epoch"}
        assert {k: v for k, v in ma.items() if k != "epoch"} == \
            {k: v for k, v in mb.items() if k != "epoch"}, (op, args)
        assert pa == pb, (op, args)
    elif isinstance(ra, dict) and "epoch" in ra:
        ra, rb = dict(ra), dict(rb)
        ra.pop("epoch")
        rb.pop("epoch")
        assert ra == rb, (op, args)
    else:
        assert ra == rb, (op, args)


def _client_parity(c, je, q, CI, RF) -> None:
    """One client's typed surface against the JAX engine in process
    (``CI``/``RF``: the client package's CheckItem / RelationshipFilter)."""
    users, perms = q["users"], q["perms"]
    for ctx in q["contexts"]:
        for rt, perm in perms:
            for u in users:
                jm, jit = je.lookup_resources_mask(rt, perm, "user", u,
                                                   now=NOW, context=ctx)
                m, it = c.lookup_resources_mask(rt, perm, "user", u,
                                                now=NOW, context=ctx)
                np.testing.assert_array_equal(m, jm,
                                              err_msg=f"{rt}#{perm}@{u}")
                assert len(it) == len(jit)
                assert sorted(c.lookup_resources(
                    rt, perm, "user", u, now=NOW, context=ctx)) == \
                    sorted(je.lookup_resources(rt, perm, "user", u,
                                               now=NOW, context=ctx))
            for rid in q["resources"][rt]:
                assert c.lookup_subjects(rt, rid, perm, "user", now=NOW,
                                         context=ctx) == \
                    je.lookup_subjects(rt, rid, perm, "user", now=NOW,
                                       context=ctx)
        items = [(rt, rid, perm, "user", u)
                 for rt, perm in perms for rid in q["resources"][rt]
                 for u in users]
        want = je.check_bulk([JCheckItem(*it) for it in items], now=NOW,
                             context=ctx)
        assert c.check_bulk([CI(*it) for it in items], now=NOW,
                            context=ctx) == want
        assert any(want) and not all(want)
    for rt, perm in perms:
        f = dict(resource_type=rt)
        assert sorted(map(_rel_tuple, c.read_relationships(RF(**f)))) == \
            sorted(map(_rel_tuple,
                       je.read_relationships(JRelationshipFilter(**f))))
        assert c.watch_gate(rt, perm) == \
            tuple((frozenset(t) if i == 0 else t)
                  for i, t in enumerate(je.watch_gate(rt, perm)))
    for f in (dict(resource_type="pod", subject_id="u5"),
              dict(resource_type="pod", resource_id="ghost"),
              dict(subject_type="user")):
        assert c.store.exists(RF(**f)) == \
            je.store.exists(JRelationshipFilter(**f))
    assert _events(c.watch_since(q["rev0"])) == \
        _events(je.watch_since(q["rev0"]))
    assert c.revision == je.revision


@pytest.mark.parametrize("kind", ["bootstrap", "caveated"])
def test_wire_parity_both_directions(monkeypatch, kind):
    monkeypatch.setenv("SDBKP_BITPROP", "interpret")
    monkeypatch.setenv("SDBKP_SEMIRING", "interpret")
    monkeypatch.setattr(jreach, "DENSE_MIN_EDGES", 2)
    monkeypatch.setattr(treach, "DENSE_MIN_EDGES", 2)
    je, te, q = _graph(kind)
    assert any(b.n_dst for b in te.compiled().blocks)
    with serving(remote.EngineServer, te) as th, \
            serving(jremote.EngineServer, je) as jh:
        j_to_port = jremote.RemoteEngine("127.0.0.1", th.port)
        j_to_jax = jremote.RemoteEngine("127.0.0.1", jh.port)
        port_to_jax = remote.RemoteEngine("127.0.0.1", jh.port)
        try:
            # the JAX client on a port host; the port client on a JAX host
            _client_parity(j_to_port, je, q, JCheckItem,
                           JRelationshipFilter)
            _client_parity(port_to_jax, je, q, CheckItem,
                           RelationshipFilter)
            # the hosts' own frames, request for request
            for ctx in q["contexts"]:
                for rt, perm in q["perms"]:
                    for u in q["users"]:
                        args = dict(resource_type=rt, permission=perm,
                                    subject_type="user", subject_id=u,
                                    subject_relation=None, now=NOW,
                                    ctx=ctx)
                        _same_frames(j_to_port, j_to_jax, "lookup_mask",
                                     **args)
                        meta, payload = j_to_port._call_any(
                            "lookup_mask", **args)
                        jm, jit = je.lookup_resources_mask(
                            rt, perm, "user", u, now=NOW, context=ctx)
                        assert payload == np.packbits(jm).tobytes()
                        assert meta == {"found": True, "n": int(jm.size),
                                        "gen": len(jit),
                                        "epoch": te.store.epoch}
                    items = [[rt, rid, perm, "user", u, None]
                             for rid in q["resources"][rt]
                             for u in q["users"]]
                    _same_frames(j_to_port, j_to_jax, "check_bulk",
                                 items=items, now=NOW, ctx=ctx)
                    _same_frames(j_to_port, j_to_jax, "lookup_resources",
                                 resource_type=rt, permission=perm,
                                 subject_type="user", subject_id="u1",
                                 now=NOW, ctx=ctx)
            _same_frames(j_to_port, j_to_jax, "lookup_mask",
                         resource_type="ghost", permission="view",
                         subject_type="user", subject_id="u1")
            for rt, _ in q["perms"]:
                _same_frames(j_to_port, j_to_jax, "object_ids", type=rt,
                             **{"from": 0})
                _same_frames(j_to_port, j_to_jax, "object_ids", type=rt,
                             **{"from": 3})
            _same_frames(j_to_port, j_to_jax, "watch_since",
                         revision=q["rev0"])
            _same_frames(j_to_port, j_to_jax, "read_relationships",
                         filter=dataclasses.asdict(RelationshipFilter()))
            _same_frames(j_to_port, j_to_jax, "revision")
        finally:
            for c in (j_to_port, j_to_jax, port_to_jax):
                c.close()


# ---------------------------------------------------------------------------
# (b) test_remote_engine.py on the port
# ---------------------------------------------------------------------------


def _client(server, **kw):
    return remote.RemoteEngine("127.0.0.1", server.port, **kw)


def test_remote_round_trips():
    e = Engine(device="cpu")
    rels = ["namespace:dev#creator@user:alice",
            "pod:dev/api#namespace@namespace:dev"]
    e.write_relationships(
        [WriteOp("touch", parse_relationship(r)) for r in rels])
    with serving(remote.EngineServer, e) as s:
        c = _client(s)
        try:
            rev0 = c.revision
            assert rev0 == e.revision
            assert c.check_bulk([
                CheckItem("namespace", "dev", "view", "user", "alice"),
                CheckItem("namespace", "dev", "view", "user", "bob"),
            ]) == [True, False]
            assert c.lookup_resources("namespace", "view", "user",
                                      "alice") == ["dev"]
            rel = parse_relationship("namespace:dev#viewer@user:bob")
            rev = c.write_relationships([WriteOp("touch", rel)])
            assert rev > rev0
            assert c.check_bulk([CheckItem("namespace", "dev", "view",
                                           "user", "bob")]) == [True]
            assert [str(ev.relationship) for ev in c.watch_since(rev0)] \
                == [str(rel)]
            out = c.read_relationships(
                RelationshipFilter(resource_type="namespace"))
            assert str(rel) in {str(r) for r in out}
            assert c.store.exists(RelationshipFilter(subject_id="bob"))
            c.delete_relationships(RelationshipFilter(subject_id="bob"))
            assert not c.store.exists(RelationshipFilter(subject_id="bob"))
            assert c.failover_state() == {
                "role": "leader", "term": 0, "revision": e.revision,
                "peer_id": None, "lag": 0}
            st = c.load_status()
            assert st["occupancy"] == 0.0 and st["check_ms"] > 0
        finally:
            c.close()


def test_remote_large_chunked_check_bulk():
    """A 40k-item bulk check over tcp://: the chunked pipeline on the
    host (16,384 items a chunk), the big frame on the client, and exact
    result order across chunk bounds."""
    rng = np.random.default_rng(5)
    e = Engine(device="cpu")
    n_ns, n_users = 40, 25
    grants = set()
    ops = []
    for i in range(n_ns):
        u = int(rng.integers(n_users))
        ops.append(WriteOp("touch", parse_relationship(
            f"namespace:n{i}#creator@user:u{u}")))
        grants.add((i, u))
    e.write_relationships(ops)
    items, want = [], []
    for _ in range(40_000):
        i, u = int(rng.integers(n_ns)), int(rng.integers(n_users))
        items.append(CheckItem("namespace", f"n{i}", "view", "user",
                               f"u{u}"))
        want.append((i, u) in grants)
    with serving(remote.EngineServer, e) as s:
        c = _client(s)
        try:
            assert c.check_bulk(items) == want
        finally:
            c.close()


class _Spy:
    """Records every ``_call_any`` of a client (op, args)."""

    def __init__(self, client):
        self.calls = []
        orig = type(client)._call_any

        def spy(this, op, **args):
            self.calls.append((op, dict(args)))
            return orig(this, op, **args)

        client._call_any = spy.__get__(client)


def test_remote_mask_wire_round_trip_and_incremental_sync():
    """Lookups ride a packed bitmask and an incrementally synced id
    table; a restore on the host (a new interner epoch) resyncs the
    client's table from 0 instead of aliasing ids."""
    e = Engine(device="cpu")
    e.write_relationships([WriteOp("touch", parse_relationship(
        f"namespace:n{i}#creator@user:alice")) for i in range(50)]
        + [WriteOp("touch", parse_relationship(
            "namespace:other#creator@user:bob"))])
    with serving(remote.EngineServer, e) as s:
        c = _client(s)
        spy = _Spy(c)
        try:
            want = sorted(e.lookup_resources("namespace", "view", "user",
                                             "alice"))
            got = c.lookup_resources("namespace", "view", "user", "alice")
            assert sorted(got) == want and len(want) == 50
            assert [op for op, _ in spy.calls] == ["lookup_mask",
                                                   "object_ids"]
            assert spy.calls[1][1]["from"] == 0
            mask, interner = c.lookup_resources_mask(
                "namespace", "view", "user", "alice")
            m2, _ = e.lookup_resources_mask("namespace", "view", "user",
                                            "alice")
            np.testing.assert_array_equal(mask, m2)
            assert len(spy.calls) == 3, "warm id table: no refetch"
            e.write_relationships([WriteOp("touch", parse_relationship(
                "namespace:brand-new#creator@user:alice"))])
            before = len(interner)
            got = c.lookup_resources("namespace", "view", "user", "alice")
            assert "brand-new" in got and len(got) == 51
            sync = [a for op, a in spy.calls if op == "object_ids"]
            assert sync[-1]["from"] == before, "must sync only the delta"
            with tempfile.TemporaryDirectory() as d:
                path = os.path.join(d, "s.npz")
                e.save_snapshot(path)
                e.load_snapshot(path)
            got = c.lookup_resources("namespace", "view", "user", "alice")
            assert sorted(got) == sorted(want + ["brand-new"])
            assert [op for op, _ in spy.calls[-2:]] == ["lookup_mask",
                                                        "object_ids"]
            assert spy.calls[-1][1]["from"] == 0, "new epoch resyncs"
            assert c.lookup_resources("ghost", "view", "user",
                                      "alice") == []
        finally:
            c.close()


def test_remote_mask_wire_frame_size():
    """A packed mask over the headline's 131,072-slot pod space is a
    16,384-byte payload; at 100k objects the whole frame stays under
    13,000 bytes, against a multi-MB JSON id list."""
    mask = np.ones(100_000, dtype=bool)
    frame = remote._pack_binary(remote.BinaryResult(
        {"found": True, "n": 100_000, "gen": 100_000, "epoch": "e" * 32},
        np.packbits(mask).tobytes()))
    assert len(frame) < 13_000
    assert len(np.packbits(np.zeros(131_072, dtype=bool)).tobytes()) \
        == 16_384
    json_list = json.dumps([f"pod-{i:06d}" for i in range(100_000)])
    assert len(json_list.encode()) > 1_000_000
    # the port's frame decodes with the JAX client's reader and back
    a, b = socket.socketpair()
    try:
        a.sendall(frame)
        meta, payload = jremote._read_frame_sync(b)
    finally:
        a.close()
        b.close()
    assert meta["n"] == 100_000
    assert np.unpackbits(np.frombuffer(payload, np.uint8),
                         count=100_000).all()


def test_remote_watch_gate():
    e = Engine(device="cpu")  # DEFAULT_BOOTSTRAP: expiring idempotency keys
    with serving(remote.EngineServer, e) as s:
        c = _client(s)
        try:
            assert c.watch_gate("namespace", "view") == (
                frozenset({"namespace"}), False)
            assert c.watch_gate("pod", "view")[0] == frozenset({"pod"})
            assert c.watch_gate("workflow", "idempotency_key")[1] is True
        finally:
            c.close()


def test_remote_error_kinds_round_trip():
    e = Engine(device="cpu")
    with serving(remote.EngineServer, e) as s:
        c = _client(s)
        jc = jremote.RemoteEngine("127.0.0.1", s.port)
        try:
            with pytest.raises(PreconditionFailed):
                c.write_relationships(
                    [WriteOp("touch", parse_relationship(
                        "namespace:x#creator@user:y"))],
                    [Precondition(RelationshipFilter(
                        resource_type="namespace", resource_id="x"),
                        must_exist=True)])
            with pytest.raises(SchemaViolation):
                c.write_relationships([WriteOp("touch", parse_relationship(
                    "nope:x#y@user:z"))])
            # the JAX client maps the port host's kinds to its own types
            from spicedb_kubeapi_proxy_tpu.engine.engine import \
                SchemaViolation as JSchemaViolation

            with pytest.raises(JSchemaViolation):
                jc.write_relationships([JWriteOp("touch", jparse_rel(
                    "nope:x#y@user:z"))])
            with pytest.raises(remote.RemoteEngineError,
                               match="unknown op"):
                c._call("no_such_op")
        finally:
            c.close()
            jc.close()


def test_remote_token_auth():
    e = Engine(device="cpu")
    with serving(remote.EngineServer, e, token="sekrit") as s:
        c = _client(s, token="sekrit")
        bad = _client(s, token="wrong")
        try:
            assert c.check_bulk([CheckItem("namespace", "x", "view",
                                           "user", "y")]) == [False]
            with pytest.raises(remote.RemoteEngineError,
                               match="invalid token"):
                bad.check_bulk([CheckItem("namespace", "x", "view",
                                          "user", "y")])
        finally:
            c.close()
            bad.close()


def test_preauth_frame_cap():
    """An unauthenticated connection announcing a frame over
    MAX_FRAME_PREAUTH is dropped unread; after auth the same size is
    served, and a fresh client pings to authenticate first."""
    e = Engine(device="cpu")
    with serving(remote.EngineServer, e, token="sekrit") as s:
        c = _client(s, token="sekrit")
        try:
            big = remote.MAX_FRAME_PREAUTH + 1
            raw = socket.create_connection(("127.0.0.1", s.port), timeout=5)
            try:
                raw.sendall(struct.pack(">I", big))
                assert raw.recv(4) == b""  # closed without a response
            finally:
                raw.close()
            pad = "p" * big
            assert isinstance(c._call("revision", _pad=pad), int)
            fresh = _client(s, token="sekrit")
            try:
                assert isinstance(fresh._call("revision", _pad=pad), int)
            finally:
                fresh.close()
        finally:
            c.close()


def _watch_fixture():
    """(prefilter, ResolveInput) for a namespaces watch as alice (the JAX
    package's test_remote_engine.py fixture)."""
    from spicedb_kubeapi_proxy_tpu.rules.input import (
        RequestInfo,
        ResolveInput,
        UserInfo,
    )
    from spicedb_kubeapi_proxy_tpu.rules.matcher import (
        MapMatcher,
        RequestMeta,
    )

    rules = MapMatcher.from_yaml("""
apiVersion: authzed.com/v1alpha1
kind: ProxyRule
lock: Pessimistic
match:
- apiVersion: v1
  resource: namespaces
  verbs: ["watch"]
prefilter:
- fromObjectIDNameExpr: "{{resourceId}}"
  lookupMatchingResources:
    tpl: "namespace:$#view@user:{{user.name}}"
""")
    rule = rules.match(RequestMeta(verb="watch", api_group="",
                                   api_version="v1",
                                   resource="namespaces"))[0]
    inp = ResolveInput.create(
        RequestInfo(verb="watch", api_version="v1", resource="namespaces",
                    path="/api/v1/namespaces"),
        UserInfo(name="alice"))
    return rule.pre_filters[0], inp


def test_remote_watch_push_zero_steady_state_polls():
    """A watch hub (the JAX package's, as its proxy runs it) on a port
    host rides one server-push subscription: no requests while idle, and
    a grant arrives by push, its recompute over the mask wire."""
    import asyncio

    from spicedb_kubeapi_proxy_tpu.authz.watchhub import WatchHub

    e = Engine(device="cpu")
    e.write_relationships([WriteOp("touch", parse_relationship(
        "namespace:seen#creator@user:alice"))])
    pf, inp = _watch_fixture()

    async def go():
        # the host on the hub's own loop, as the JAX test runs it: its
        # stop() ends the push stream the hub's reader thread waits on
        server = remote.EngineServer(e)
        await server.start()
        c = remote.RemoteEngine("127.0.0.1", server.port)
        spy = _Spy(c)
        try:
            await asyncio.to_thread(c.lookup_resources, "namespace",
                                    "view", "user", "alice")
            hub = WatchHub(c)
            handle = await hub.register(pf, inp)
            await asyncio.sleep(1.0)
            n = len(spy.calls)
            await asyncio.sleep(1.5)
            assert spy.calls[n:] == [], \
                f"steady-state watcher issued requests: {spy.calls[n:]}"
            t0 = time.perf_counter()
            await asyncio.to_thread(e.write_relationships, [WriteOp(
                "touch", parse_relationship(
                    "namespace:pushed#viewer@user:alice"))])
            while True:
                kind, *rest = await asyncio.wait_for(handle.queue.get(),
                                                     timeout=10)
                if kind == "allowed" and ("", "pushed") in rest[0].pairs:
                    break
            assert time.perf_counter() - t0 < 2.0
            assert "watch_since" not in [op for op, _ in spy.calls]
            await hub.unregister(handle)
        finally:
            c.close()
            await server.stop()

    _within(lambda: asyncio.run(go()))


def test_push_watch_stream_delivers_every_write():
    """The port client's push stream on a port host: each write's events
    arrive in revision order; a heartbeat is an empty batch."""
    e = Engine(device="cpu")
    with serving(remote.EngineServer, e) as s:
        c = _client(s)
        try:
            stream = c.watch_push_stream(c.revision)
            try:
                revs = []
                for i in range(5):
                    revs.append(e.write_relationships([WriteOp(
                        "touch", parse_relationship(
                            f"namespace:w{i}#viewer@user:u{i}"))]))
                got = []
                while len(got) < 5:
                    got += _within(stream.next_batch, 10)
                assert [ev.revision for ev in got] == revs
                assert [ev.relationship.resource_id for ev in got] == \
                    [f"w{i}" for i in range(5)]
            finally:
                stream.close()
        finally:
            c.close()


def test_remote_lookups_fuse_across_connections():
    """A host with lookup batching on: concurrent lookup_mask requests
    from separate connections fuse into shared dispatches, each result
    its own."""
    e = Engine(device="cpu")
    users = [f"u{i}" for i in range(6)]
    e.write_relationships([WriteOp("touch", parse_relationship(
        f"namespace:ns{i}#creator@user:{u}")) for i, u in enumerate(users)])
    e.lookup_resources_mask("namespace", "view", "user", users[0])  # warm
    e.enable_lookup_batching(window=0.02)
    with serving(remote.EngineServer, e) as s:
        clients = [_client(s) for _ in users]
        try:
            for _ in range(5):  # a burst can straggle under load
                b0 = metrics.counter("engine_lookup_batches_total").value
                l0 = metrics.counter("engine_lookups_total").value
                results = {}
                threads = [threading.Thread(
                    target=lambda c=c, u=u: results.__setitem__(
                        u, set(c.lookup_resources("namespace", "view",
                                                  "user", u))),
                    daemon=True) for c, u in zip(clients, users)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(30)
                assert not any(t.is_alive() for t in threads)
                fused = metrics.counter(
                    "engine_lookup_batches_total").value - b0
                issued = metrics.counter("engine_lookups_total").value - l0
                if 0 < fused < issued:
                    break
            else:
                raise AssertionError("no cross-connection fusion observed")
            for i, u in enumerate(users):
                assert results[u] == {f"ns{i}"}, u
        finally:
            for c in clients:
                c.close()
            e.disable_lookup_batching()


def test_failover_engine_follows_a_port_host():
    """FailoverEngine over [dead endpoint, port host]: a host with no
    coordinator answers "leader of itself", so the client re-aims at it
    and serves reads and writes; the JAX FailoverEngine does the same."""
    e = Engine(device="cpu")
    e.write_relationships([WriteOp("touch", parse_relationship(
        "namespace:dev#creator@user:alice"))])
    dead = socket.socket()
    dead.bind(("127.0.0.1", 0))
    dead_port = dead.getsockname()[1]
    dead.close()  # nothing listens there
    with serving(remote.EngineServer, e) as s:
        eps = [("127.0.0.1", dead_port), ("127.0.0.1", s.port)]
        fe = remote.FailoverEngine(eps, retries=0, connect_timeout=1.0,
                                   probe_timeout=1.0)
        jfe = jremote.FailoverEngine(eps, retries=0, connect_timeout=1.0,
                                     probe_timeout=1.0)
        try:
            assert fe.check(CheckItem("namespace", "dev", "view", "user",
                                      "alice")) is True
            assert fe.replication_status()["role"] == "leader"
            fe.write_relationships([WriteOp("touch", parse_relationship(
                "namespace:dev#viewer@user:bob"))])
            assert fe.lookup_resources("namespace", "view", "user",
                                       "bob") == ["dev"]
            assert fe.store.exists(RelationshipFilter(subject_id="bob"))
            assert jfe.check(JCheckItem("namespace", "dev", "view", "user",
                                        "bob")) is True
        finally:
            fe.close()
            jfe.close()


# ---------------------------------------------------------------------------
# (c) the JAX package's proxy over tcp:// to a port host
# ---------------------------------------------------------------------------


def test_proxy_against_remote_engine(tmp_path):
    """test_remote_engine.py's single-device proxy flow (rules,
    dual-write, list filtering) with the engine on a port host."""
    import asyncio

    from spicedb_kubeapi_proxy_tpu.proxy.inmemory import InMemoryClient
    from spicedb_kubeapi_proxy_tpu.proxy.options import Options
    from fake_kube import FakeKube

    with open(os.path.join(REPO, "deploy", "rules.yaml")) as fh:
        rules = fh.read()
    engine = Engine(device="cpu")
    with serving(remote.EngineServer, engine) as s:

        async def go():
            cfg = Options(
                engine_endpoint=f"tcp://127.0.0.1:{s.port}",
                engine_insecure=True,
                rule_content=rules,
                upstream=FakeKube(),
                workflow_database_path=str(tmp_path / "dtx.sqlite"),
            ).complete()
            assert isinstance(cfg.engine, jremote.RemoteEngine)
            await cfg.workflow.resume_pending()
            alice = InMemoryClient(cfg.server.handle, user="alice")
            bob = InMemoryClient(cfg.server.handle, user="bob")
            resp = await alice.post("/api/v1/namespaces", {
                "apiVersion": "v1", "kind": "Namespace",
                "metadata": {"name": "remote-ns"}})
            assert resp.status == 201, resp.body
            # the dual write landed in the port's engine
            assert engine.check(CheckItem("namespace", "remote-ns", "view",
                                          "user", "alice"))
            resp = await alice.get("/api/v1/namespaces")
            assert [o["metadata"]["name"] for o in
                    json.loads(resp.body)["items"]] == ["remote-ns"]
            resp = await bob.get("/api/v1/namespaces")
            assert json.loads(resp.body)["items"] == []
            await cfg.workflow.shutdown()
            cfg.engine.close()

        _within(lambda: asyncio.run(go()), 120)


# ---------------------------------------------------------------------------
# (d) admission: overlay back-pressure and the host's shed
# ---------------------------------------------------------------------------


def test_overlay_backpressure_is_an_admission_rejection():
    assert issubclass(OverlayBackpressure, admission.AdmissionRejected)
    ex = OverlayBackpressure(0.25, 64, 64)
    assert isinstance(ex, DependencyUnavailable)
    assert (ex.op_class, ex.retry_after, ex.dependency) == (
        "write", 0.25, "engine-compaction")
    assert str(ex).startswith("write: delta overlay slots full (64/64)")


def test_full_overlay_sheds_as_admission_over_the_wire():
    """A full overlay on a port host answers kind "admission" with its
    Retry-After: the JAX client raises its AdmissionRejected
    (dependency "engine-admission"), its breaker stays closed, and the
    shed write left no trace."""
    e = Engine(device="cpu", delta_capacity=64)
    e.write_relationships([WriteOp("touch", parse_relationship(
        f"namespace:ns{i}#{rel}@user:u{i}")) for i in range(12)
        for rel in ("creator", "viewer")])
    e.compiled()
    comp = e.enable_compaction(1.0)
    real, comp.compact = comp.compact, lambda: False  # freeze the fold
    with serving(remote.EngineServer, e) as s:
        jc = jremote.RemoteEngine("127.0.0.1", s.port)
        try:
            shed = None
            for i in range(200):
                try:
                    jc.write_relationships([JWriteOp("touch", jparse_rel(
                        f"namespace:ns{i % 12}#viewer@user:"
                        f"u{(i * 5 + i // 12) % 12}"))])
                except JAdmissionRejected as ex:
                    shed = ex
                    break
            assert shed is not None, "overlay never filled"
            assert shed.dependency == "engine-admission"
            assert shed.op_class == "write"
            assert MIN_RETRY_AFTER <= shed.retry_after <= MAX_RETRY_AFTER
            assert "overlay slots full" in str(shed)
            assert jc.breaker.state == JSTATE_CLOSED
            rev = e.revision
            raw = socket.create_connection(("127.0.0.1", s.port), timeout=5)
            try:
                raw.sendall(jremote._pack({
                    "op": "write_relationships",
                    "ops": [{"op": "touch", "rel": dataclasses.asdict(
                        parse_relationship("namespace:ns0#viewer@user:u11"))}],
                    "preconditions": []}))
                frame = jremote._read_frame_sync(raw)
            finally:
                raw.close()
            assert frame["ok"] is False and frame["kind"] == "admission"
            assert frame["class"] == "write" and frame["retry_after"] > 0
            assert e.revision == rev
            comp.compact = real
            assert comp.compact() is True
            jc.write_relationships([JWriteOp("touch", jparse_rel(
                "namespace:ns0#viewer@user:u11"))])
            assert e.revision == rev + 1
        finally:
            jc.close()
            e.close_compaction()


def test_engine_server_sheds_and_breaker_stays_closed():
    """test_admission.py's engine-host shed on the port: a saturated
    admission controller sheds at the host, the client breaker stays
    closed, control-plane ops still answer, and freed capacity admits."""
    e = Engine(device="cpu")
    c = admission.AdmissionController(
        initial_concurrency=1, min_concurrency=1, max_concurrency=1,
        tenant_rate=0.0, tenant_burst=1e9, queue_timeout=0.05,
        dependency="engine-admission")
    hold = c.acquire("hog", admission.CHECK)
    shed = metrics.counter("admission_shed_total", **{"class": "check"})
    with serving(remote.EngineServer, e, admission=c) as s:
        r = _client(s)
        try:
            before = shed.value
            with pytest.raises(admission.AdmissionRejected) as ei:
                r.check_bulk([CheckItem("namespace", "dev", "view", "user",
                                        "alice")])
            assert ei.value.retry_after > 0
            assert ei.value.dependency == "engine-admission"
            assert r.breaker.state == STATE_CLOSED
            assert shed.value - before >= 1
            assert r.failover_state() is not None
            hold.release()
            assert r.check_bulk([CheckItem("namespace", "dev", "view",
                                           "user", "alice")]) == [False]
        finally:
            r.close()


def test_role_gate_wins_over_admission_so_shed_writes_never_apply():
    """test_admission.py's failover interplay on a port host: on a
    non-leader the not_leader rejection wins over a saturated admission
    controller (it re-aims the client), and on a saturated leader a shed
    write leaves the store untouched."""
    e = Engine(device="cpu")
    c = admission.AdmissionController(
        initial_concurrency=1, min_concurrency=1, max_concurrency=1,
        tenant_rate=0.0, tenant_burst=1e9, queue_timeout=0.05,
        dependency="engine-admission")
    hold = c.acquire("hog", admission.CHECK)
    role = {"role": "follower", "term": 3, "revision": 0, "peer_id": 1,
            "lag": 0}
    rel = parse_relationship("namespace:dev#creator@user:alice")
    with serving(remote.EngineServer, e, admission=c,
                 failover_status=lambda: dict(role)) as s:
        r = _client(s)
        try:
            rev0 = e.revision
            with pytest.raises(remote.NotLeaderError):
                r.write_relationships([WriteOp("touch", rel)])
            assert r.failover_state()["role"] == "follower"  # ungated
            role["role"] = "leader"
            with pytest.raises(admission.AdmissionRejected):
                r.write_relationships([WriteOp("touch", rel)])
            assert e.revision == rev0  # nothing applied, nothing acked
            hold.release()
            assert r.write_relationships([WriteOp("touch", rel)]) > rev0
        finally:
            r.close()


def test_metrics_exposition_and_snapshots_match_the_reference():
    """The completed utils/metrics.py copy: the same observations give
    the same Prometheus text, merged histogram snapshots and window
    quantiles in both packages (load_status reads hist_snapshot)."""
    from spicedb_kubeapi_proxy_tpu.utils import metrics as jm
    from spicedb_kubeapi_proxy_tpu_torch.utils import metrics as tm

    regs = (jm.Registry(), tm.Registry())
    snaps = []
    for r in regs:
        r.counter("engine_checks_total").inc(3)
        r.gauge("engine_graph_edges").set(12)
        for kind, v in (("a", 0.002), ("b", 0.04), ("a", 0.3)):
            r.histogram("engine_check_seconds", kind=kind).observe(v)
        before = r.hist_snapshot("engine_check_seconds")
        r.histogram("engine_check_seconds", kind="b").observe(7.0)
        snaps.append((before, r.hist_snapshot("engine_check_seconds"),
                      r.hist_snapshot("engine_check_seconds", kind="a")))
    assert regs[0].render() == regs[1].render()
    assert "# TYPE engine_check_seconds histogram" in regs[1].render()
    assert snaps[0] == snaps[1] and snaps[1][1]["n"] == 4
    for q in (0.5, 0.99):
        assert tm.snapshot_delta_quantile(*snaps[1][:2], q) == \
            jm.snapshot_delta_quantile(*snaps[0][:2], q) == 10.0  # 7's bucket
    assert tm.snapshot_delta_quantile(None, snaps[1][2], 0.5) == \
        jm.snapshot_delta_quantile(None, snaps[0][2], 0.5)


# ---------------------------------------------------------------------------
# (e) the flag-gated chaos ops on a host without the flag, and the
# scale-out ops
# ---------------------------------------------------------------------------

# served behind --enable-chaos-ops (test_torch_chaos.py); a host without
# the flag refuses them as a JAX host without it does
REFUSED = ("chaos_arm", "chaos_reset", "chaos_status")

_ROW = {"resource_type": "pod", "resource_id": "b/q", "relation": "viewer",
        "subject_type": "user", "subject_id": "v", "subject_relation": None,
        "expiration": None, "caveat": None, "caveat_context": None}
SERVED = {
    "slice_read": {"ranges": [[0, 1 << 32]]},
    "slice_load": {"rows": [_ROW]},
    "slice_apply": {"ops": [{"op": "touch", "rel": _ROW},
                            {"op": "delete", "rel": dict(
                                _ROW, resource_id="a/p", subject_id="u")}]},
    "slice_drop": {"ranges": [[0, 1 << 32]]},
    "slice_watch": {"revision": 0},
    "frontier_pairs": {},
    "frontier_expand": {"descs": [["user", "u", None]],
                        "pairs": [["namespace", "viewer"]]},
}


@pytest.mark.parametrize("op", sorted(SERVED))
def test_scaleout_op_answers_as_a_jax_host(op):
    """The rebalance mover's ``slice_*`` ops and the frontier exchange's
    ops, sent raw to a port host and to a JAX host holding the same rows:
    the same frame (a ``slice_read`` frame's rows decoded), and the same
    rows left behind."""
    rows = ["pod:a/p#viewer@user:u", "namespace:a#viewer@user:u",
            "pod:a/p#namespace@namespace:a"]

    def ask(server_cls, engine, wop, parse, codec):
        engine.write_relationships([wop("touch", parse(r)) for r in rows])
        req = dict(SERVED[op], op=op)
        if op == "slice_load":
            rels = [parse("pod:b/q#viewer@user:v")]
            req = {"op": op, "payload_b64": __import__("base64").b64encode(
                codec.encode_bulk_cols(remote._rels_to_cols(rels))).decode()}
        with serving(server_cls, engine) as h:
            raw = socket.create_connection(("127.0.0.1", h.port),
                                           timeout=10)
            try:
                raw.sendall(remote._pack(req))
                frame = remote._read_frame_sync(raw)
            finally:
                raw.close()
        if isinstance(frame, tuple):
            meta, payload = frame
            frame = (meta, remote._cols_to_rels(codec.decode_bulk_cols(
                payload)))
        return frame, sorted(str(r) for r in engine.read_relationships(
            RelationshipFilter()))

    from spicedb_kubeapi_proxy_tpu.models.tuples import \
        parse_relationship as jparse
    from spicedb_kubeapi_proxy_tpu.persistence import codec as jcodec
    from spicedb_kubeapi_proxy_tpu_torch.persistence import codec

    got = ask(remote.EngineServer, Engine(device="cpu"), WriteOp,
              parse_relationship, codec)
    want = ask(jremote.EngineServer, JEngine(), JWriteOp, jparse, jcodec)
    assert str(got) == str(want)
    if isinstance(got[0], dict):
        assert got[0]["ok"] is True, got


@pytest.fixture(scope="module")
def refusing_host():
    with serving(remote.EngineServer, Engine(device="cpu")) as s:
        yield s


@pytest.fixture(scope="module")
def refusing_jax_host():
    with serving(jremote.EngineServer, JEngine()) as s:
        yield s


@pytest.mark.parametrize("op", REFUSED)
def test_unported_op_answers_store_kind(refusing_host, refusing_jax_host,
                                        op):
    """A port host booted without --enable-chaos-ops answers each chaos op
    with the JAX host's frame: the same kind and the same text."""
    def raw_frame(port):
        raw = socket.create_connection(("127.0.0.1", port), timeout=10)
        try:
            raw.sendall(remote._pack({"op": op, "schedule": {
                "seed": 0, "faults": []}}))
            return remote._read_frame_sync(raw)
        finally:
            raw.close()

    frame = raw_frame(refusing_host.port)
    want = raw_frame(refusing_jax_host.port)
    assert frame["ok"] is False and frame["kind"] == "store", frame
    assert "--enable-chaos-ops" in frame["error"]
    assert {k: frame[k] for k in ("ok", "kind", "error")} == \
        {k: want[k] for k in ("ok", "kind", "error")}
    # and a JAX client raises its StoreError for it
    jc = jremote.RemoteEngine("127.0.0.1", refusing_host.port)
    try:
        with pytest.raises(JStoreError, match="chaos ops are disabled"):
            getattr(jc, op)(*([{"seed": 0, "faults": []}]
                              if op == "chaos_arm" else []))
    finally:
        jc.close()


# ---------------------------------------------------------------------------
# (f) a restore during wire lookups
# ---------------------------------------------------------------------------


def _save_lineage(path: str, names: list, alice) -> None:
    """A port store interning ``names`` in order (``alice(i)``: whether
    alice creates the i-th, else bob), saved as a snapshot."""
    e = Engine(device="cpu")
    e.write_relationships([WriteOp("touch", parse_relationship(
        f"namespace:{n}#creator@user:{'alice' if alice(i) else 'bob'}"))
        for i, n in enumerate(names)])
    e.save_snapshot(path)


def test_restore_during_wire_lookups_never_aliases_ids(tmp_path):
    """Two snapshot lineages whose id tables differ everywhere (a* names
    in one, b* in the other, interleaved owners): while the host
    restores them in turn, every wire lookup from both packages' clients
    answers exactly one lineage's ids — a mask resolved against the
    other epoch's table would name the wrong objects."""
    paths = {k: str(tmp_path / f"{k}.npz") for k in "AB"}
    a_names = [f"a{i}" for i in range(30)]
    b_names = [f"b{i}" for i in range(29, -1, -1)]
    _save_lineage(paths["A"], a_names, lambda i: i % 3 == 0)
    _save_lineage(paths["B"], b_names, lambda i: i % 2 == 1)
    want = {"A": sorted(a_names[::3]), "B": sorted(b_names[1::2])}
    e = Engine(device="cpu")
    e.load_snapshot(paths["A"])
    e.enable_decision_cache()
    stop = threading.Event()
    seen, bad, refused = {"A": 0, "B": 0}, [], []

    def reader(client):
        while not stop.is_set():
            try:
                got = sorted(client.lookup_resources("namespace", "view",
                                                     "user", "alice"))
            except (remote.RemoteEngineError, jremote.RemoteEngineError,
                    remote.StoreError, JStoreError) as ex:
                # the host's "epoch kept changing" (kind store) or the
                # client's: an answer withheld is never a wrong one
                refused.append(ex)
                continue
            hit = [k for k, v in want.items() if v == got]
            if hit:
                seen[hit[0]] += 1
            else:
                bad.append(got)

    swi = sys.getswitchinterval()
    sys.setswitchinterval(0.0005)  # more thread interleavings per restore
    with serving(remote.EngineServer, e) as s:
        clients = [_client(s), _client(s),
                   jremote.RemoteEngine("127.0.0.1", s.port)]
        threads = [threading.Thread(target=reader, args=(c,), daemon=True)
                   for c in clients]
        try:
            for t in threads:
                t.start()
            # at least 30 restores, and on until 60 answers came back
            # (a loaded box answers fewer a second); 60 s at most
            k, deadline = 0, time.monotonic() + 60
            while k < 30 or (sum(seen.values()) < 60
                             and time.monotonic() < deadline):
                e.load_snapshot(paths["B" if k % 2 == 0 else "A"])
                k += 1
                time.sleep(0.01)
            if k % 2:  # end on lineage A
                e.load_snapshot(paths["A"])
        finally:
            stop.set()
            for t in threads:
                t.join(30)
            for c in clients:
                c.close()
            sys.setswitchinterval(swi)
        assert not any(t.is_alive() for t in threads)
    assert bad == [], bad[:3]
    assert sum(seen.values()) >= 60, (seen, len(refused))
    assert sorted(e.lookup_resources("namespace", "view", "user",
                                     "alice")) == want["A"]


# -- a host restarted on its fixed port ---------------------------------------


def _start_and_stop(srv) -> int:
    import asyncio

    async def go():
        got = await srv.start()
        await srv.stop()
        return got

    return asyncio.run(go())


def test_a_host_on_a_held_fixed_port_binds_once_the_port_frees():
    """A restarted host's fixed port can be held for a moment (a client
    that kept dialing the dead port handed it as its own source port):
    the bind waits for it instead of the host exiting."""
    holder = socket.socket()
    holder.bind(("127.0.0.1", 0))
    port = holder.getsockname()[1]
    threading.Timer(0.6, holder.close).start()
    srv = remote.EngineServer(Engine(device="cpu"), port=port)
    t0 = time.monotonic()
    assert _start_and_stop(srv) == port
    assert time.monotonic() - t0 >= 0.5


def test_a_port_held_past_the_bind_window_still_fails(monkeypatch):
    monkeypatch.setattr(remote.EngineServer, "BIND_RETRY_SECONDS", 0.5)
    holder = socket.socket()
    holder.bind(("127.0.0.1", 0))
    try:
        srv = remote.EngineServer(Engine(device="cpu"),
                                  port=holder.getsockname()[1])
        t0 = time.monotonic()
        with pytest.raises(OSError) as exc:
            _start_and_stop(srv)
        assert exc.value.errno == errno.EADDRINUSE
        assert 0.5 <= time.monotonic() - t0 < 5.0
    finally:
        holder.close()
