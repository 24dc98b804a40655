"""PyTorch port, the write path: ops/reachability.incremental_update (host
plan and commit, in-place device patch), the store's watch log and
engine/compaction.py, held against the JAX package byte for byte.

(a) unit parity of incremental_update on one compiled base (the JAX graph
carried across with convert.from_reference_arrays): host overlay, residual
and dead ledger, re-closed blocks, every decline and its reason, and the
patched device state against a fresh build from the same host state;
(b) the randomized churn differential of tests/test_overlay.py on both
engines under push, pull and auto, with zero recompiles; (c) ports of its
remaining overlay cases; (d) readers racing a writer that patches a
shared block, and a compaction swap under concurrent dispatch; (e) a
bit-dual patch where two killed cells share a packed word, one of them
bit 31. The JAX side runs its Pallas kernels in interpreter mode and both
sides lower DENSE_MIN_EDGES so dense blocks and bit duals form.
"""

import sys
import threading
import time

import numpy as np
import pytest
import torch

from spicedb_kubeapi_proxy_tpu.engine import CheckItem as JCheckItem
from spicedb_kubeapi_proxy_tpu.engine import Engine as JEngine
from spicedb_kubeapi_proxy_tpu.engine.store import WriteOp as JWriteOp
from spicedb_kubeapi_proxy_tpu.models import parse_schema as jparse_schema
from spicedb_kubeapi_proxy_tpu.models.tuples import \
    Relationship as JRelationship
from spicedb_kubeapi_proxy_tpu.ops import reachability as jreach
from spicedb_kubeapi_proxy_tpu.ops import semiring as jsemi
from spicedb_kubeapi_proxy_tpu.utils.metrics import metrics as jmetrics
from spicedb_kubeapi_proxy_tpu_torch.convert import from_reference_arrays
from spicedb_kubeapi_proxy_tpu_torch.admission import AdmissionRejected
from spicedb_kubeapi_proxy_tpu_torch.engine import CheckItem, Engine
from spicedb_kubeapi_proxy_tpu_torch.engine.compaction import (
    MAX_RETRY_AFTER,
    MIN_RETRY_AFTER,
    OverlayBackpressure,
    WriteTooLarge,
    validate_overlay_config,
)
from spicedb_kubeapi_proxy_tpu_torch.engine.evaluator import OracleEvaluator
from spicedb_kubeapi_proxy_tpu_torch.engine.store import (
    RelationshipFilter,
    Store,
    WriteOp,
)
from spicedb_kubeapi_proxy_tpu_torch.models import parse_schema
from spicedb_kubeapi_proxy_tpu_torch.models.tuples import Relationship
from spicedb_kubeapi_proxy_tpu_torch.ops import bitprop as tbit
from spicedb_kubeapi_proxy_tpu_torch.ops import reachability as treach
from spicedb_kubeapi_proxy_tpu_torch.ops import semiring as tsemi
from spicedb_kubeapi_proxy_tpu_torch.utils.metrics import metrics

from torch_parity import flatten_graph

NOW = time.time()

SCHEMA = """
use expiration

definition user {}
definition group { relation member: user | group#member with expiration }
definition namespace {
  relation viewer: group#member | user | user with expiration
  permission view = viewer
}
definition folder { relation viewer: user }
"""


@pytest.fixture
def kernels_interpreted(monkeypatch):
    """JAX Pallas kernels in interpreter mode; blocks from 2 edges up on
    both sides, so small graphs form dense blocks and bit duals."""
    monkeypatch.setenv("SDBKP_BITPROP", "interpret")
    monkeypatch.setenv("SDBKP_SEMIRING", "interpret")
    monkeypatch.setattr(jreach, "DENSE_MIN_EDGES", 2)
    monkeypatch.setattr(treach, "DENSE_MIN_EDGES", 2)


def _rel(s: str, expiration=None) -> Relationship:
    """'type:id#rel@stype:sid[#srel]' -> the port's Relationship."""
    res, sub = s.split("@")
    rt, rest = res.split(":")
    rid, rl = rest.split("#")
    st, srest = sub.split(":")
    sid, _, srl = srest.partition("#")
    return Relationship(rt, rid, rl, st, sid, srl or None, expiration)


def _jrel(r: Relationship) -> JRelationship:
    return JRelationship(r.resource_type, r.resource_id, r.relation,
                         r.subject_type, r.subject_id, r.subject_relation,
                         r.expiration, r.caveat, r.caveat_context)


def _base_rels(n_users=6, n_ns=6, n_groups=5, chain=True):
    rels = [_rel(f"group:g{i % n_groups}#member@user:u{i}")
            for i in range(n_users)]
    for i in range(n_ns):
        rels.append(_rel(f"namespace:ns{i}#viewer@user:u{i % n_users}"))
        rels.append(_rel(f"namespace:ns{i}#viewer@group:g{i % n_groups}"
                         "#member"))
    if chain:  # g0 <- g1 <- g2: a closured group#member self-block
        rels += [_rel("group:g0#member@group:g1#member"),
                 _rel("group:g1#member@group:g2#member")]
    # an expiring grant rides the residual
    rels.append(_rel("namespace:ns0#viewer@user:u5", NOW + 3600))
    return rels


def _fallbacks(reg) -> dict:
    reasons = ("layout", "overflow", "stratification-inversion",
               "closured-expiry", "closured-caveat", "caveat", "unlogged",
               "history-trimmed", "unstratified")
    return {r: reg.counter("engine_graph_incremental_fallback_total",
                           reason=r).value for r in reasons}


def _fell_back(before: tuple, reason: str) -> None:
    """Exactly ``reason`` counted once more on both packages."""
    for reg, b in zip((metrics, jmetrics), before):
        got = _fallbacks(reg)
        diff = {k: got[k] - b[k] for k in got if got[k] != b[k]}
        assert diff == {reason: 1.0}, (reg, diff)


def _host_state(cg) -> dict:
    closured = {i: tuple(np.array(a) for a in (
        b.dst_local, b.src_local, b.base_dst_local, b.base_src_local))
        for i, b in enumerate(cg.blocks) if b.closured}
    return {"delta_src": np.array(cg.delta_src),
            "delta_dst": np.array(cg.delta_dst),
            "delta_exp": np.array(cg.delta_exp),
            "delta_cav": np.array(cg.delta_cav),
            "n_delta": cg.n_delta, "n_dead": cg.n_dead,
            "res_exp": np.array(cg.res_exp),
            "dead": np.array(cg.dead_buf[:cg.n_dead]),
            "closured": closured}


def _assert_host_equal(got: dict, want: dict) -> None:
    for k in ("delta_src", "delta_dst", "delta_exp", "delta_cav",
              "res_exp", "dead"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert (got["n_delta"], got["n_dead"]) == (want["n_delta"],
                                              want["n_dead"])
    assert got["closured"].keys() == want["closured"].keys()
    for i, arrs in got["closured"].items():
        for a, b in zip(arrs, want["closured"][i]):
            np.testing.assert_array_equal(a, b, err_msg=f"block {i}")


def _assert_device_matches_fresh_build(cg) -> None:
    """The in-place patched device state equals a fresh build from the
    same (newest) host state, tensor for tensor."""
    got, want = cg._dev(), cg._dev_build()
    for k in ("src", "dst", "exp", "dsrc", "ddst", "dexp"):
        assert torch.equal(got[k], want[k]), k
    for kind in ("blocks", "blocks_bits"):
        for i, (a, b) in enumerate(zip(got[kind], want[kind])):
            assert (a is None) == (b is None)
            assert a is None or torch.equal(a, b), (kind, i)


class _Pair:
    """One compiled base on both packages: the JAX graph and its port
    copy (convert.from_reference_arrays, writer state included), over two
    stores holding the same writes in the same order."""

    def __init__(self, rels, cap=256):
        self.jstore = JEngine(schema=jparse_schema(SCHEMA)).store
        self.tstore = Store()
        self.write(rels)
        self.jcg = jreach.compile_graph(jparse_schema(SCHEMA),
                                        self.jstore.snapshot(),
                                        delta_capacity=cap)
        self.tcg = from_reference_arrays(flatten_graph(self.jcg),
                                         device="cpu")
        self.tcg._dev()  # built first, so every batch patches it

    def write(self, rels, op="touch"):
        self.jstore.write([JWriteOp(op, _jrel(r)) for r in rels])
        self.tstore.write([WriteOp(op, r) for r in rels])

    def step(self, rels, op="touch"):
        """Write a batch to both stores and fold its watch records into
        both graphs; returns the two results."""
        rev0 = self.tcg.revision
        self.write(rels, op)
        jrec = [(r.op == 3, r.rel) for r in self.jstore.watch_since(rev0)]
        trec = [(r.op == 3, r.rel) for r in self.tstore.watch_since(rev0)]
        return self.apply(jrec, trec, self.tstore.revision)

    def apply(self, jrec, trec, rev):
        j = jreach.incremental_update(self.jcg, jrec, rev, self.jstore)
        t = treach.incremental_update(self.tcg, trec, rev, self.tstore)
        assert (j is None) == (t is None)
        if t is not None:
            self.jcg, self.tcg = j, t
        return j, t

    def check(self):
        _assert_host_equal(_host_state(self.tcg), _host_state(self.jcg))
        _assert_device_matches_fresh_build(self.tcg)
        # both graphs answer alike: every user's namespace#view window
        off = self.tcg.offset_of("namespace", "view")
        n = self.tcg.type_sizes["namespace"]
        objs = {self.tstore.types.string(t): it
                for t, it in self.tstore.objects.items()}
        q = off + np.arange(n, dtype=np.int32)
        for u in ("u0", "u1", "u2", "u3", "u5"):
            seed = np.asarray([self.tcg.encode_subject("user", u, None,
                                                       objs)], np.int32)
            z = np.zeros(n, dtype=np.int32)
            np.testing.assert_array_equal(
                self.tcg.query(seed, q, z, now=NOW),
                np.asarray(self.jcg.query(seed, q, z, now=NOW)), err_msg=u)


def test_incremental_update_unit_parity(kernels_interpreted):
    """(a) Same store, same compiled base, same records: host state,
    re-closed blocks and device state after every batch, and every decline
    with its reason, byte for byte against the JAX package."""
    p = _Pair(_base_rels())
    assert any(b.closured for b in p.tcg.blocks)
    assert any(not b.closured for b in p.tcg.blocks)
    assert any(b is not None for b in p.tcg._dev()["blocks_bits"])
    p.check()
    batches = [
        # a new pair inside a plain block: one overlay slot
        ([_rel("namespace:ns1#viewer@user:u3")], "touch"),
        # an expiration attached to a base block edge: cell + bit killed,
        # overlay slot added
        ([_rel("namespace:ns0#viewer@user:u0", NOW + 600)], "touch"),
        # a base block edge deleted
        ([_rel("namespace:ns2#viewer@user:u2")], "delete"),
        # the expiring residual edge deleted: residual expiration killed
        ([_rel("namespace:ns0#viewer@user:u5")], "delete"),
        # a closured base edge deleted: the block re-closes
        ([_rel("group:g0#member@group:g1#member")], "delete"),
        # several records: a new pair, an overlay slot killed, a base
        # re-touch with expiration
        ([_rel("namespace:ns3#viewer@user:u1")], "touch"),
        ([_rel("namespace:ns1#viewer@user:u3")], "delete"),
        ([_rel("namespace:ns4#viewer@user:u4", NOW + 900),
          _rel("group:g3#member@user:u0")], "touch"),
        # a killed overlay slot re-used
        ([_rel("namespace:ns1#viewer@user:u3")], "touch"),
        # an idempotent re-delete of a dead base pair
        ([_rel("namespace:ns2#viewer@user:u2")], "delete"),
    ]
    for rels, op in batches:
        j, t = p.step(rels, op)
        assert t is not None, (rels, op)
        p.check()
    assert p.tcg.n_delta > 0 and p.tcg.n_dead > 0

    # declines: None, the same reason on both, nothing of the shared
    # overlay touched
    def decline(jrec, trec, reason):
        before = (_fallbacks(metrics), _fallbacks(jmetrics))
        host = _host_state(p.tcg)
        dev = {k: v.clone() for k, v in p.tcg._dev().items()
               if isinstance(v, torch.Tensor)}
        j, t = p.apply(jrec, trec, p.tstore.revision + 1)
        assert j is None and t is None
        _fell_back(before, reason)
        _assert_host_equal(_host_state(p.tcg), host)
        for k, v in dev.items():
            assert torch.equal(p.tcg._dev()[k], v), k

    def recs(rels, deletes=False):
        return ([(deletes, _jrel(r)) for r in rels],
                [(deletes, r) for r in rels])

    folder = _rel("folder:f0#viewer@user:u0")
    p.write([folder])  # a type first interned after the compile
    decline(*recs([folder]), "layout")
    decline(*recs([_rel("group:g1#member@group:g2#member", NOW + 500)]),
            "closured-expiry")
    decline(*recs([_rel("group:g3#member@group:g0#member")]),
            "stratification-inversion")
    cav = Relationship("namespace", "ns0", "viewer", "user", "u1",
                       caveat="c", caveat_context="{}")
    decline([(False, _jrel(cav))], [(False, cav)], "caveat")
    many = [_rel(f"namespace:ns{i % 6}#viewer@user:u{i % 6}")
            for i in range(treach.MAX_DELTA_RECORDS + 1)]
    decline(*recs(many), "overflow")
    # past the capacity: a 64-slot base, 70 new pairs in one batch
    q = _Pair(_base_rels(n_users=12, n_ns=12), cap=64)
    q.check()
    new = [_rel(f"namespace:ns{i}#viewer@user:u{k}") for i in range(12)
           for k in range(12) if k != i][:70]
    q.write(new)
    before = (_fallbacks(metrics), _fallbacks(jmetrics))
    j, t = q.apply(*recs(new), q.tstore.revision)
    assert j is None and t is None
    _fell_back(before, "overflow")
    # a hand-built graph without overlay state
    bare = from_reference_arrays(
        {k: v for k, v in flatten_graph(p.jcg).items() if k != "dead_buf"},
        device="cpu")
    before = (_fallbacks(metrics), _fallbacks(jmetrics))
    assert treach.incremental_update(bare, [], 0, p.tstore) is None
    from dataclasses import replace
    assert jreach.incremental_update(replace(p.jcg, delta_pos=None), [], 0,
                                     p.jstore) is None
    _fell_back(before, "unstratified")


@pytest.mark.parametrize("order", ["compile-then-load", "load-then-compile"])
def test_store_side_declines_match(kernels_interpreted, order):
    """``unlogged`` fires only when the compiled graph predates a bulk load
    (the first write after load-then-compile is incremental on both), and
    ``history-trimmed`` when the watch log no longer reaches back."""
    cols = {"resource_type": np.array(["namespace"] * 3),
            "resource_id": np.array(["ns0", "ns1", "ns2"]),
            "relation": np.array(["viewer"] * 3),
            "subject_type": np.array(["user"] * 3),
            "subject_id": np.array(["u0", "u1", "u2"])}
    je = JEngine(schema=jparse_schema(SCHEMA))
    te = Engine(schema=parse_schema(SCHEMA), device="cpu")
    for e, mk in ((je, lambda r: JWriteOp("touch", _jrel(r))),
                  (te, lambda r: WriteOp("touch", r))):
        if order == "compile-then-load":
            e.write_relationships([mk(_rel("namespace:ns9#viewer@user:u9"))])
            e.compiled()
            e.bulk_load(cols)
        else:
            e.bulk_load(cols)
            e.compiled()
    before = (_fallbacks(metrics), _fallbacks(jmetrics))
    c0 = (metrics.counter("engine_graph_compiles_total").value,
          jmetrics.counter("engine_graph_compiles_total").value)
    te.write_relationships([WriteOp("touch", _rel(
        "namespace:ns1#viewer@user:u0"))])
    je.write_relationships([JWriteOp("touch", _jrel(_rel(
        "namespace:ns1#viewer@user:u0")))])
    assert te.lookup_resources("namespace", "view", "user", "u0") == \
        sorted(je.lookup_resources("namespace", "view", "user", "u0")) \
        == ["ns0", "ns1"]
    compiles = (metrics.counter("engine_graph_compiles_total").value - c0[0],
                jmetrics.counter("engine_graph_compiles_total").value
                - c0[1])
    if order == "compile-then-load":
        _fell_back(before, "unlogged")
        assert compiles == (1, 1)
    else:
        assert _fallbacks(metrics) == before[0]
        assert compiles == (0, 0)
    # the watch log trimmed past the compiled revision
    for e in (te, je):
        e.store.watch_retention = 2
    before = (_fallbacks(metrics), _fallbacks(jmetrics))
    with te._lock, je._lock:  # keep both graphs behind while writing
        for i in range(4):
            r = _rel(f"namespace:ns2#viewer@user:u{i + 3}")
            te.store.write([WriteOp("touch", r)])
            je.store.write([JWriteOp("touch", _jrel(r))])
    te.compiled()
    je.compiled()
    _fell_back(before, "history-trimmed")
    assert te.lookup_resources("namespace", "view", "user", "u4") == \
        sorted(je.lookup_resources("namespace", "view", "user", "u4")) \
        == ["ns2"]


# ---------------------------------------------------------------------------
# (b) the randomized churn differential on both engines
# ---------------------------------------------------------------------------


def _build_pair(cap=256, n_users=6, n_ns=6, n_groups=5):
    """Both engines over the same writes, every object pre-seeded into
    the slot layout, compiled and warm."""
    te = Engine(schema=parse_schema(SCHEMA), device="cpu", delta_capacity=cap)
    je = JEngine(schema=jparse_schema(SCHEMA), delta_capacity=cap)
    rels = _base_rels(n_users, n_ns, n_groups, chain=False)
    te.write_relationships([WriteOp("touch", r) for r in rels])
    je.write_relationships([JWriteOp("touch", _jrel(r)) for r in rels])
    for e in (te, je):
        e.compiled()
    return te, je


def _grid(n_users=6, n_ns=6):
    return [("namespace", f"ns{i}", "view", "user", f"u{u}")
            for i in range(n_ns) for u in range(n_users)]


def _assert_three_way(te, je, now, n_users=6, n_ns=6):
    """Verdicts and masks: port == JAX == oracle at ``now``."""
    oracle = te.oracle(now=now)
    items = _grid(n_users, n_ns)
    got = te.check_bulk([CheckItem(*it) for it in items], now=now)
    assert got == je.check_bulk([JCheckItem(*it) for it in items], now=now)
    assert got == [oracle.check(*it) for it in items]
    for u in range(0, n_users, 2):
        tm, interner = te.lookup_resources_mask("namespace", "view", "user",
                                                f"u{u}", now=now)
        jm, _ = je.lookup_resources_mask("namespace", "view", "user",
                                         f"u{u}", now=now)
        np.testing.assert_array_equal(tm, jm)
        assert {interner.string(i) for i in np.flatnonzero(tm)} == \
            oracle.lookup_resources("namespace", "view", "user", f"u{u}")


@pytest.mark.parametrize("mode", ["auto", "push", "pull"])
def test_overlay_churn_differential(kernels_interpreted, mode):
    """(b) Randomized write/delete/expiry churn, masks and verdicts held
    JAX vs port vs oracle after every mutation, with zero recompiles on
    either engine: every mutation between pre-seeded objects rides the
    overlay. Expiring grants lapse at fixed query clocks, not by sleep."""
    te, je = _build_pair()
    rng = np.random.default_rng(7)
    c0 = (metrics.counter("engine_graph_compiles_total").value,
          jmetrics.counter("engine_graph_compiles_total").value)
    i0 = (metrics.counter("engine_graph_incremental_updates_total").value,
          jmetrics.counter("engine_graph_incremental_updates_total").value)
    live: list = []
    steps = 24
    with tsemi.force_mode(mode), jsemi.force_mode(mode):
        for step in range(steps):
            now = NOW + 0.25 * step
            r = rng.random()
            if r < 0.35 or not live:
                rl = _rel(f"namespace:ns{rng.integers(6)}#viewer"
                          f"@user:u{rng.integers(6)}")
                op = "touch"
                live.append(rl)
            elif r < 0.50:
                # an expiring grant that lapses within the run
                rl = _rel(f"namespace:ns{rng.integers(6)}#viewer"
                          f"@user:u{rng.integers(6)}",
                          NOW + float(rng.uniform(0.5, 4.0)))
                op = "touch"
                live.append(rl)
            elif r < 0.70:
                rl = live.pop(int(rng.integers(len(live))))
                op = "delete"
            elif r < 0.85:
                rl = _rel(f"group:g{rng.integers(5)}#member"
                          f"@user:u{rng.integers(6)}")
                op = "touch"
                live.append(rl)
            else:  # re-touch: an overlay slot update, not a second slot
                rl = live[int(rng.integers(len(live)))]
                op = "touch"
            te.write_relationships([WriteOp(op, rl)])
            je.write_relationships([JWriteOp(op, _jrel(rl))])
            _assert_three_way(te, je, now)
        _assert_three_way(te, je, NOW + 10.0)  # every expiring grant gone
    assert (metrics.counter("engine_graph_compiles_total").value - c0[0],
            jmetrics.counter("engine_graph_compiles_total").value - c0[1]) \
        == (0, 0), "steady-state churn must not recompile"
    assert (metrics.counter("engine_graph_incremental_updates_total").value
            - i0[0]) == steps
    assert (jmetrics.counter("engine_graph_incremental_updates_total").value
            - i0[1]) == steps
    assert te.compiled().n_delta == je.compiled().n_delta > 0


# ---------------------------------------------------------------------------
# (c) the reference's remaining overlay cases
# ---------------------------------------------------------------------------


def _port_engine(cap=256, n_users=6, n_ns=6, chain=False) -> Engine:
    e = Engine(schema=parse_schema(SCHEMA), device="cpu", delta_capacity=cap)
    e.write_relationships([WriteOp("touch", r) for r in _base_rels(
        n_users, n_ns, 5, chain=chain)])
    e.compiled()
    e.check_bulk([CheckItem("namespace", "ns0", "view", "user", "u0")])
    return e


def _assert_oracle(e: Engine, n_users=6, n_ns=6, now=None):
    now = time.time() if now is None else now
    o = e.oracle(now=now)
    items = _grid(n_users, n_ns)
    assert e.check_bulk([CheckItem(*it) for it in items], now=now) == \
        [o.check(*it) for it in items]
    u = f"u{n_users // 2}"
    assert set(e.lookup_resources("namespace", "view", "user", u,
                                  now=now)) == \
        o.lookup_resources("namespace", "view", "user", u)


def _compiles() -> float:
    return metrics.counter("engine_graph_compiles_total").value


def test_overlay_filter_delete_and_idempotent_redelete():
    e = _port_engine()
    c0 = _compiles()
    e.write_relationships([WriteOp("touch", _rel(
        "namespace:ns1#viewer@user:u4"))])
    n = e.delete_relationships(RelationshipFilter(
        resource_type="namespace", resource_id="ns1"))
    assert n >= 1
    assert e.watch_since(e.revision - 1)[0].operation == "delete"
    _assert_oracle(e)
    cg1 = e.compiled()
    e.write_relationships([WriteOp("delete", _rel(
        "namespace:ns2#viewer@user:u2"))])
    cg2 = e.compiled()
    e.write_relationships([WriteOp("delete", _rel(
        "namespace:ns2#viewer@user:u2"))])
    cg3 = e.compiled()
    assert cg3.n_dead == cg2.n_dead >= cg1.n_dead
    _assert_oracle(e)
    assert _compiles() == c0


def test_closured_block_delete_recloses_and_expiry_attach_falls_back(
        monkeypatch):
    monkeypatch.setattr(treach, "DENSE_MIN_EDGES", 1)
    e = Engine(schema=parse_schema(SCHEMA), device="cpu", delta_capacity=256)
    ops = [WriteOp("touch", _rel(f"group:g{i}#member@user:u{i}"))
           for i in range(4)]
    ops += [WriteOp("touch", _rel("group:g0#member@group:g1#member")),
            WriteOp("touch", _rel("group:g1#member@group:g2#member")),
            WriteOp("touch", _rel("namespace:ns0#viewer@group:g0#member"))]
    e.write_relationships(ops)
    cg = e.compiled()
    assert any(b.closured for b in cg.blocks)

    def view(u):
        return e.check_bulk([CheckItem("namespace", "ns0", "view", "user",
                                       u)])[0]

    assert view("u2")  # via g2 -> g1 -> g0
    c0 = _compiles()
    # the DERIVED g2 -> g0 reachability dies with the middle edge
    e.write_relationships([WriteOp("delete", _rel(
        "group:g0#member@group:g1#member"))])
    assert not view("u2") and not view("u1") and view("u0")
    assert _compiles() == c0, "a closured delete re-closes, not recompiles"
    fb0 = _fallbacks(metrics)
    e.write_relationships([WriteOp("touch", Relationship(
        "group", "g1", "member", "group", "g2",
        subject_relation="member", expiration=time.time() + 500))])
    assert view("u1") is False
    assert _fallbacks(metrics)["closured-expiry"] == \
        fb0["closured-expiry"] + 1
    assert _compiles() == c0 + 1
    si0 = _fallbacks(metrics)["stratification-inversion"]
    e.write_relationships([WriteOp("touch", _rel(
        "group:g3#member@group:g0#member"))])
    assert e.check_bulk([CheckItem("group", "g3", "member", "user",
                                   "u0")])[0]
    assert _fallbacks(metrics)["stratification-inversion"] >= si0
    _assert_oracle(e, n_users=4, n_ns=1)


def test_overlay_overflow_counted_fallback_without_compactor():
    e = _port_engine(cap=64, n_users=12, n_ns=12)
    fb0 = _fallbacks(metrics)["overflow"]
    c0 = _compiles()
    for i in range(100):  # more distinct pairs than the 64 slots
        e.write_relationships([WriteOp("touch", Relationship(
            "namespace", f"ns{i % 12}", "viewer", "user",
            f"u{(i * 5 + i // 12) % 12}"))])
    _assert_oracle(e, n_users=12, n_ns=12)
    assert _fallbacks(metrics)["overflow"] > fb0
    assert _compiles() > c0
    assert e.compiled().revision == e.store.revision


def test_a_write_larger_than_the_overlay_is_never_shed_forever():
    """A write whose records need more slots than the whole overlay
    (4 a record) would not fit after any fold: the port refuses it for
    good (WriteTooLarge, a store error naming the largest write that
    fits, nothing applied), where the JAX package sheds it with a
    Retry-After on every attempt, folds or no, so its writer retries
    forever. A write of the limit's size lands."""
    rows = [Relationship("namespace", f"ns{i % 12}", "viewer", "user",
                         f"u{(i * 5 + i // 12) % 12}") for i in range(24)]
    e = _port_engine(cap=64, n_users=12, n_ns=12)
    c = e.enable_compaction(1.0)
    assert e.max_write_records() == 16
    rev = e.store.revision
    for _ in range(3):
        with pytest.raises(WriteTooLarge) as ex:
            e.write_relationships([WriteOp("touch", r) for r in rows])
        assert not isinstance(ex.value, AdmissionRejected)
        assert (ex.value.n_records, ex.value.limit) == (24, 16)
        assert e.store.revision == rev  # nothing applied
        c.compact()
    e.write_relationships([WriteOp("touch", r) for r in rows[:16]])
    assert e.store.revision == rev + 1
    _assert_oracle(e, n_users=12, n_ns=12)
    e.close_compaction()
    assert e.max_write_records() is None

    je = JEngine(schema=jparse_schema(SCHEMA), delta_capacity=64)
    import dataclasses

    def jrel(r):
        return JRelationship(**dataclasses.asdict(r))

    je.write_relationships([JWriteOp("touch", jrel(r))
                            for r in _base_rels(12, 12, 5, chain=False)])
    je.compiled()
    jc = je.enable_compaction(1.0)
    big = [JWriteOp("touch", jrel(r)) for r in rows]
    from spicedb_kubeapi_proxy_tpu.engine.compaction import \
        OverlayBackpressure as JOverlayBackpressure
    for _ in range(3):
        with pytest.raises(JOverlayBackpressure):
            je.write_relationships(big)
        jc.compact()
    je.close_compaction()


def test_mover_chunks_fit_the_overlay():
    """The slice ops' apply helper cuts its power-of-two chunks to half
    of what the engine's overlay absorbs: 24 records into a 64-slot
    overlay (16 records at most) land as three writes of 8, never one
    the compactor refuses."""
    from spicedb_kubeapi_proxy_tpu_torch.engine.remote import _apply_po2

    rows = [Relationship("namespace", f"ns{i % 12}", "viewer", "user",
                         f"u{(i * 5 + i // 12) % 12}") for i in range(24)]
    e = _port_engine(cap=64, n_users=12, n_ns=12)
    e.enable_compaction(1.0)
    sizes = []
    real = e.write_relationships

    def spy(ops, *a, **kw):
        sizes.append(len(ops))
        return real(ops, *a, **kw)

    e.write_relationships = spy
    rev = e.store.revision
    assert _apply_po2(e, rows, "touch") == rev + 3
    assert sizes == [8, 8, 8]
    _assert_oracle(e, n_users=12, n_ns=12)
    e.close_compaction()


def test_overlay_full_sheds_bounded_retry_after_nothing_applied():
    e = _port_engine(cap=64, n_users=12, n_ns=12)
    c = e.enable_compaction(1.0)
    real_compact, c.compact = c.compact, lambda: False  # freeze the fold
    shed = rev_before = None
    for i in range(200):
        try:
            e.write_relationships([WriteOp("touch", Relationship(
                "namespace", f"ns{i % 12}", "viewer", "user",
                f"u{(i * 5 + i // 12) % 12}"))])
        except OverlayBackpressure as ex:
            rev_before, shed = e.store.revision, ex
            break
    assert shed is not None, "overlay never filled"
    assert MIN_RETRY_AFTER <= shed.retry_after <= MAX_RETRY_AFTER
    assert shed.capacity == 64 and shed.occupancy <= 64
    assert shed.dependency == "engine-compaction"
    with pytest.raises(OverlayBackpressure):
        e.write_relationships([WriteOp("touch", Relationship(
            "namespace", "ns0", "viewer", "user", "u11"))])
    assert e.store.revision == rev_before  # a shed write left no trace
    assert metrics.counter("engine_overlay_backpressure_total").value > 0
    _assert_oracle(e, n_users=12, n_ns=12)
    c.compact = real_compact
    assert c.compact() is True
    assert e.compiled().n_delta == 0
    e.write_relationships([WriteOp("touch", Relationship(
        "namespace", "ns0", "viewer", "user", "u11"))])
    assert e.store.revision == rev_before + 1
    e.close_compaction()
    _assert_oracle(e, n_users=12, n_ns=12)


def test_validate_overlay_config_bounds():
    validate_overlay_config(64, 0.0)
    validate_overlay_config(4096, 1.0)
    for cap, thr in ((63, 0.5), (1024, 1.5), (1024, -0.1)):
        with pytest.raises(ValueError):
            validate_overlay_config(cap, thr)
    # the engine's constructor refuses an overlay under the floor
    with pytest.raises(ValueError, match="delta-capacity"):
        Engine(schema=parse_schema(SCHEMA), device="cpu", delta_capacity=63)


def test_wait_events_wakes_on_write():
    e = _port_engine()
    rev = e.revision
    got = []
    t = threading.Thread(target=lambda: got.extend(e.wait_events(rev, 10)))
    t.start()
    e.write_relationships([WriteOp("touch", _rel(
        "namespace:ns5#viewer@user:u0"))])
    t.join(timeout=10)
    assert not t.is_alive()
    assert [(ev.revision, ev.operation) for ev in got] == [(rev + 1,
                                                            "touch")]
    assert e.wait_events(e.revision, 0.01) == []


def test_feature_gate_and_waiter_release():
    """The IncrementalGraphUpdates gate (off: a write recompiles, as the
    reference's gate does), the gate registry refusing unknown names, and
    wake_waiters releasing a parked watcher with no events."""
    from spicedb_kubeapi_proxy_tpu_torch.utils.features import (
        FeatureGateError,
        FeatureGates,
        features,
    )

    g = FeatureGates()
    g.register("A", True)
    for bad in (g.enabled, lambda n: g.set(n, False)):
        with pytest.raises(FeatureGateError):
            bad("B")
    g.set("A", False)
    assert not g.enabled("A")
    g.reset()
    assert g.enabled("A")
    e = _port_engine()
    c0 = _compiles()
    features.set("IncrementalGraphUpdates", False)
    try:
        e.write_relationships([WriteOp("touch", _rel(
            "namespace:ns5#viewer@user:u1"))])
        assert "ns5" in e.lookup_resources("namespace", "view", "user", "u1")
    finally:
        features.reset()
    assert _compiles() == c0 + 1
    got = [None]
    t = threading.Thread(target=lambda: got.__setitem__(
        0, e.store.wait_since(e.revision, 30)))
    t.start()
    deadline = time.time() + 10  # far inside the 30 s wait: a wake-up
    while t.is_alive() and time.time() < deadline:
        e.store.wake_waiters()
        t.join(timeout=0.05)
    assert not t.is_alive() and got[0] == []


# ---------------------------------------------------------------------------
# (d) races
# ---------------------------------------------------------------------------

RACE_SCHEMA = """
definition user {}
definition group { relation member: user | group#member }
definition namespace {
  relation viewer: user | group#member
  permission view = viewer
}
"""


def test_readers_never_see_a_mixed_revision(monkeypatch):
    """(d) Reader threads dispatch continuously while a writer folds
    writes into a shared dense block and its bit dual (kills with an
    overlay re-add, deletes, new pairs). Every read equals the oracle at a
    revision between the last acknowledged write before its dispatch and
    the store's revision after its result (a write that has not returned
    may or may not be seen): never a mix of two. The group cycle stays on
    the residual
    (4 edges, under the block minimum of 5), so it is an iterated core
    and a read spans several hops."""
    monkeypatch.setattr(treach, "DENSE_MIN_EDGES", 5)
    schema = parse_schema(RACE_SCHEMA)
    e = Engine(schema=schema, device="cpu")
    e.CHECK_PIPELINE_CHUNK = 16  # a bulk check of 4 chunks, one revision
    base = [_rel(f"namespace:ns{i}#viewer@user:u{(i * 3) % 8}")
            for i in range(8)]
    base += [_rel(f"namespace:ns{i}#viewer@group:g{i % 4}#member")
             for i in range(8)]
    base += [_rel(f"group:g{g}#member@user:u{g}") for g in range(4)]
    base += [_rel(f"group:g{g}#member@group:g{(g + 1) % 4}#member")
             for g in range(4)]
    e.write_relationships([WriteOp("touch", r) for r in base])
    cg = e.compiled()
    assert any(b is not None for b in cg._dev()["blocks_bits"])
    assert not any(b.closured for b in cg.blocks)
    assert e.check_bulk_async([CheckItem("namespace", "ns0", "view", "user",
                                         "u1")]).iterations() > 2
    rng = np.random.default_rng(3)
    writes = []
    for k in range(24):
        rl = base[int(rng.integers(len(base)))] if k % 3 else _rel(
            f"namespace:ns{rng.integers(8)}#viewer@user:u{rng.integers(8)}")
        writes.append(("delete" if k % 3 == 1 else "touch", rl))
    # the expected answers at every revision, from a shadow store
    shadow = Store()
    shadow.write([WriteOp("touch", r) for r in base])
    items = _grid(8, 8)
    users = [f"u{u}" for u in range(8)]
    want = {}

    def expect(rev):
        o = OracleEvaluator(schema, shadow.snapshot())
        want[rev] = [o.check(*it) for it in items]

    rev = e.revision
    expect(rev)
    for op, rl in writes:
        shadow.write([WriteOp(op, rl)])
        rev += 1
        expect(rev)
    stop = threading.Event()
    errors, reads, acked = [], [0], [e.revision]

    def reader(k):
        while not stop.is_set():
            try:
                if k % 2:  # 8 subjects x 8 namespaces, in 4 chunks
                    r0 = acked[0]
                    got = e.check_bulk([CheckItem(*it) for it in items])
                    r1 = e.revision
                    ok = any(got == want[r] for r in range(r0, r1 + 1))
                else:  # one list filter a subject, each held alone
                    ok = True
                    for j, u in enumerate(users):
                        r0 = acked[0]
                        m, it = e.lookup_resources_mask(
                            "namespace", "view", "user", u)
                        r1 = e.revision
                        vis = {it.string(i) for i in np.flatnonzero(m)}
                        got = [f"ns{i}" in vis for i in range(8)]
                        ok &= any(got == want[r][j::8]
                                  for r in range(r0, r1 + 1))
                if not ok:
                    errors.append(("mixed", k, r0, r1))
                    return
                reads[0] += 1
            except Exception as ex:  # noqa: BLE001 - reported below
                errors.append(ex)
                return

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    threads = [threading.Thread(target=reader, args=(k,)) for k in range(4)]
    try:
        for t in threads:
            t.start()
        c0 = _compiles()
        for op, rl in writes:
            acked[0] = e.write_relationships([WriteOp(op, rl)])
            time.sleep(0.002)
        assert _compiles() == c0
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:3]
    assert reads[0] > 0
    assert e.compiled().resident is cg.resident


def _wait_for(cond, what: str) -> None:
    deadline = time.time() + 10
    while not cond():
        assert time.time() < deadline, what
        time.sleep(0.001)


def test_rwlock_bounds_a_waiting_writer():
    """While a writer waits for a reader that entered before it, a new
    reader still enters; once every such reader has left, a new reader
    queues behind the writer."""
    lock = treach._RWLock()
    order = []
    gates = {k: threading.Event() for k in ("early", "late")}
    inside = {k: threading.Event() for k in ("early", "late")}

    def reader(k):
        with lock.shared():
            inside[k].set()
            gates[k].wait(10)

    def writer():
        with lock.exclusive():
            order.append("write")

    def new_reader():
        with lock.shared():
            order.append("new read")

    t_early = threading.Thread(target=reader, args=("early",))
    t_early.start()
    inside["early"].wait(10)
    t_w = threading.Thread(target=writer)
    t_w.start()
    _wait_for(lambda: lock._waiting == 1, "the writer never waited")
    t_late = threading.Thread(target=reader, args=("late",))
    t_late.start()
    assert inside["late"].wait(10), "a reader queued behind the writer " \
        "while an earlier reader was inside"
    gates["early"].set()
    t_early.join(10)
    t_new = threading.Thread(target=new_reader)
    t_new.start()
    _wait_for(lambda: lock._early == 0, "the early reader never left")
    time.sleep(0.05)
    assert order == [], "the writer or the new reader ran beside a reader"
    gates["late"].set()
    for t in (t_late, t_w, t_new):
        t.join(10)
    assert order == ["write", "new read"]


def test_write_waiting_on_a_bulk_check_does_not_stall_lists():
    """A write whose device patch waits for a bulk check's shared hold
    leaves the engine lock free: a list filter meanwhile answers at once
    from the published revision (the write has not returned), and the
    list after the write returns sees it, with no recompile."""
    e = _port_engine()
    cg = e.compiled()
    c0 = _compiles()
    rel = _rel("namespace:ns5#viewer@user:u2")
    assert "ns5" not in e.lookup_resources("namespace", "view", "user", "u2")
    held, release = threading.Event(), threading.Event()

    def bulk_check():  # the shared side, held as a chunked bulk check does
        with cg.resident.lock.shared():
            held.set()
            release.wait(10)

    done = []
    t_bulk = threading.Thread(target=bulk_check)
    t_bulk.start()
    held.wait(10)
    t_w = threading.Thread(target=lambda: done.append(
        e.write_relationships([WriteOp("touch", rel)])))
    t_w.start()
    _wait_for(lambda: cg.resident.lock._waiting == 1,
              "the write never waited for the exclusive side")
    t0 = time.perf_counter()
    assert "ns5" not in e.lookup_resources("namespace", "view", "user",
                                           "u2")
    assert time.perf_counter() - t0 < 5 and not done
    release.set()
    t_bulk.join(10)
    t_w.join(10)
    assert done and "ns5" in e.lookup_resources("namespace", "view", "user",
                                                "u2")
    assert _compiles() == c0
    assert e.compiled().resident is cg.resident


def test_compaction_swap_under_concurrent_dispatch():
    """Folds swapping the compiled base while reader threads dispatch:
    no errors, the swap preserves the revision, parity at the end."""
    e = _port_engine(cap=512)
    c = e.enable_compaction(1.0)  # manual folds only
    stop = threading.Event()
    errors: list = []

    def reader(k: int):
        i = 0
        while not stop.is_set():
            try:
                got = e.check_bulk([CheckItem(
                    "namespace", f"ns{(i + k) % 6}", "view", "user",
                    f"u{i % 6}")])
                assert isinstance(got[0], bool)
                e.lookup_resources_mask("namespace", "view", "user",
                                        f"u{(i + k) % 6}")
                i += 1
            except Exception as ex:  # noqa: BLE001 - reported below
                errors.append(ex)
                return

    threads = [threading.Thread(target=reader, args=(k,)) for k in range(3)]
    for t in threads:
        t.start()
    folds0 = metrics.counter("engine_compactions_total").value
    try:
        for i in range(30):
            e.write_relationships([WriteOp("touch", Relationship(
                "namespace", f"ns{i % 6}", "viewer", "user",
                f"u{(i * 5) % 6}"))])
            if i % 5 == 4:
                rev = e.store.revision
                assert c.compact() is True
                assert e.compiled().revision == rev
                assert e.compiled().n_delta == 0
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
        e.close_compaction()
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:3]
    assert metrics.counter("engine_compactions_total").value - folds0 >= 6
    _assert_oracle(e)


# ---------------------------------------------------------------------------
# (e) bit-dual words shared by killed cells
# ---------------------------------------------------------------------------


def test_bit_dual_patch_shared_word_and_bit31(monkeypatch):
    """(e) Two killed cells of one row share packed word 0, one at bit 31
    (src object index 31): one write kills both. The patched dual equals a
    fresh pack of the live cells; bits of the word's other cells
    survive."""
    monkeypatch.setattr(treach, "DENSE_MIN_EDGES", 2)
    e = Engine(schema=parse_schema(SCHEMA), device="cpu")
    # user object indices start at 2 (0 void, 1 wildcard): u29 -> 31
    users = [f"u{i}" for i in range(40)]
    rels = [_rel(f"namespace:ns0#viewer@user:{u}") for u in users]
    rels += [_rel(f"namespace:ns1#viewer@user:{u}") for u in users[::3]]
    e.write_relationships([WriteOp("touch", r) for r in rels])
    cg = e.compiled()
    d = cg._dev()
    b = cg.block_index[(cg.offset_of("namespace", "viewer"),
                        cg.offset_of("user", "__self"))]
    assert d["blocks_bits"][b] is not None
    objs = e._objects_by_name()
    assert objs["user"].lookup("u29") == 31 and objs["user"].lookup("u3") == 5
    row = objs["namespace"].lookup("ns0")
    assert int(d["blocks_bits"][b][row, 0]) < 0  # bit 31 set: negative
    e.write_relationships([WriteOp("delete", _rel(
        "namespace:ns0#viewer@user:u29")), WriteOp("delete", _rel(
            "namespace:ns0#viewer@user:u3"))])
    cg2 = e.compiled()
    assert cg2.resident is cg.resident
    bits = cg2._dev()["blocks_bits"][b]
    word = int(bits[row, 0]) & 0xFFFFFFFF
    assert not word >> 31 & 1 and not word >> 5 & 1
    assert word >> 4 & 1 and word >> 30 & 1  # u2 and u28 survive
    _assert_device_matches_fresh_build(cg2)
    bm = cg2.blocks[b]
    dl, sl = cg2._live_cells(bm)
    fresh = tbit.pack_block_host(dl, sl, bm.n_dst, bm.n_src).view(np.int32)
    np.testing.assert_array_equal(bits.numpy(), fresh)
    assert e.check_bulk([CheckItem("namespace", "ns0", "view", "user",
                                   "u29")]) == [False]
    # the same shared-word kill on the function itself, duplicates merged
    dual = torch.from_numpy(tbit.pack_block_host(
        np.array([0, 0, 0, 1]), np.array([5, 31, 4, 31]), 32, 64
    ).view(np.int32).copy())
    treach._clear_bits(dual, np.array([0, 0, 0, 1]), np.array([31, 5, 31,
                                                               63]),
                       lambda a, dt: torch.as_tensor(np.asarray(a)).to(dt))
    want = tbit.pack_block_host(np.array([0, 1]), np.array([4, 31]), 32, 64)
    np.testing.assert_array_equal(dual.numpy(), want.view(np.int32))
