"""The port's device mesh (parallel/mesh.py, parallel/sharded.py) held
against the JAX package's.

Every case of tests/test_parallel.py runs on both packages over the same
store: the JAX side on conftest.py's 8 virtual CPU devices (its kernels
as its own tests run them), the port on an in-process mesh of 8 CPU cells
(``[cpu] * 8``). Grids and masks are compared byte for byte, and the
futures' ``iterations`` / ``conv_checks`` / ``push_steps`` /
``caveats_missing`` must equal the JAX future's. The proxy and watch
cases serve the repo's deploy/rules.yaml. Added: the card kernel's
layout preconditions on every kept block shard at graph 2, 4 and 8,
readers of a mesh engine never seeing a mixed revision under writes, and
a CUDA mesh without a card raising instead of falling back.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import os
import threading
import time
import types

import jax
import numpy as np
import pytest
import torch

import spicedb_kubeapi_proxy_tpu.engine as j_engine
import spicedb_kubeapi_proxy_tpu.models as j_models
import spicedb_kubeapi_proxy_tpu.models.tuples as j_tuples
import spicedb_kubeapi_proxy_tpu.ops.reachability as j_reach
import spicedb_kubeapi_proxy_tpu.ops.semiring as j_semiring
import spicedb_kubeapi_proxy_tpu.parallel as j_parallel
import spicedb_kubeapi_proxy_tpu.utils.metrics as j_metrics
import spicedb_kubeapi_proxy_tpu_torch.engine as t_engine
import spicedb_kubeapi_proxy_tpu_torch.models as t_models
import spicedb_kubeapi_proxy_tpu_torch.models.tuples as t_tuples
import spicedb_kubeapi_proxy_tpu_torch.ops.reachability as t_reach
import spicedb_kubeapi_proxy_tpu_torch.ops.semiring as t_semiring
import spicedb_kubeapi_proxy_tpu_torch.parallel as t_parallel
import spicedb_kubeapi_proxy_tpu_torch.utils.metrics as t_metrics
from spicedb_kubeapi_proxy_tpu_torch.parallel.mesh import (
    MeshSpecError,
    mesh_topology,
)
from torch_parity import fake_kube_class

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RULES = os.path.join(REPO, "deploy", "rules.yaml")
BOOTSTRAP = os.path.join(REPO, "deploy", "bootstrap.yaml")
CPU8 = [torch.device("cpu")] * 8


def _side(name, eng, models, tuples, reach, semi, par, met, pkg):
    return types.SimpleNamespace(
        name=name, Engine=eng.Engine, CheckItem=eng.CheckItem,
        WriteOp=eng.WriteOp, RelationshipFilter=eng.RelationshipFilter,
        parse_schema=models.parse_schema, rel=tuples.parse_relationship,
        Relationship=tuples.Relationship, reach=reach, semiring=semi,
        ShardedGraph=par.ShardedGraph, make_mesh=par.make_mesh,
        metrics=met.metrics, pkg=pkg)


J = _side("jax", j_engine, j_models, j_tuples, j_reach, j_semiring,
          j_parallel, j_metrics, "spicedb_kubeapi_proxy_tpu")
T = _side("torch", t_engine, t_models, t_tuples, t_reach, t_semiring,
          t_parallel, t_metrics, "spicedb_kubeapi_proxy_tpu_torch")
SIDES = (J, T)


def mesh(s, n=8, **kw):
    """An n-device (JAX) or n-cell (port) mesh."""
    if s is J:
        return J.make_mesh(n, devices=jax.devices()[:n], **kw)
    return T.make_mesh(n, devices=CPU8[:n], **kw)


def engine(s, bootstrap=None, schema=None, mesh=None):
    kw = {"device": "cpu"} if s is T else {}
    return s.Engine(bootstrap=bootstrap, schema=schema, mesh=mesh, **kw)


def counter(s, name):
    return s.metrics.counter(name).value


def same_future(fj, ft, what=""):
    """The port's future equals the JAX one: answer bytes and counters."""
    gj, gt = np.asarray(fj.result()), np.asarray(ft.result())
    assert gj.dtype == gt.dtype == np.bool_, what
    assert gj.shape == gt.shape and np.array_equal(gj, gt), what
    for c in ("iterations", "conv_checks", "push_steps", "caveats_missing"):
        assert getattr(fj, c)() == getattr(ft, c)(), (what, c)
    return gt


SCHEMA = """
definition user {}
definition group {
  relation member: user | group#member
}
definition org {
  relation admin: user
  relation parent: org
  permission admin_rec = admin + parent->admin_rec
}
definition doc {
  relation org: org
  relation owner: user
  relation reader: user | group#member
  relation banned: user
  permission read = (reader + owner + org->admin_rec) - banned
}
"""


def store_rels(seed=7, n_users=8, n_groups=5, n_docs=12, n_orgs=3):
    """test_parallel.build_engine's tuples, in one fixed order."""
    rng = np.random.default_rng(seed)
    ops = set()
    for g in range(n_groups):
        for u in rng.choice(n_users, size=3, replace=False):
            ops.add(f"group:g{g}#member@user:u{u}")
        g2 = rng.integers(n_groups)
        if g2 != g:
            ops.add(f"group:g{g}#member@group:g{g2}#member")
    for o in range(n_orgs):
        ops.add(f"org:o{o}#admin@user:u{rng.integers(n_users)}")
        o2 = rng.integers(n_orgs)
        if o2 != o:
            ops.add(f"org:o{o}#parent@org:o{o2}")
    for d in range(n_docs):
        for u in rng.choice(n_users, size=2, replace=False):
            ops.add(f"doc:d{d}#reader@user:u{u}")
        if rng.random() < 0.5:
            ops.add(f"doc:d{d}#owner@user:u{rng.integers(n_users)}")
        if rng.random() < 0.5:
            ops.add(f"doc:d{d}#banned@user:u{rng.integers(n_users)}")
        if rng.random() < 0.6:
            ops.add(f"doc:d{d}#reader@group:g{rng.integers(n_groups)}#member")
        if rng.random() < 0.7:
            ops.add(f"doc:d{d}#org@org:o{rng.integers(n_orgs)}")
    return sorted(ops), [f"u{i}" for i in range(n_users)]


def touch(s, rels):
    return [s.WriteOp("touch", s.rel(r)) for r in rels]


def build_engine(s, seed=7, mesh=None, **kw):
    rels, users = store_rels(seed, **kw)
    e = engine(s, schema=s.parse_schema(SCHEMA), mesh=mesh)
    e.write_relationships(touch(s, rels))
    return e, users


def lookup_grid(cg, objs, subjects, resource_type, permission):
    off = cg.offset_of(resource_type, permission)
    n = cg.type_sizes[resource_type]
    seeds = np.asarray([cg.encode_subject(t, i, None, objs)
                        for (t, i) in subjects], dtype=np.int32)
    q = np.tile(off + np.arange(n, dtype=np.int32), (len(subjects), 1))
    return seeds, q, n


def flat_of(q):
    B, Q = q.shape
    return (q.reshape(-1), np.repeat(np.arange(B, dtype=np.int32), Q))


def both_grids(data, graph, seed=7, resource=("doc", "read")):
    """Both packages' ShardedGraph over one store, the lookup grid of
    every user and one unknown subject, and each package's engine."""
    out = {}
    for s in SIDES:
        e, users = build_engine(s, seed)
        cg = e.compiled()
        objs = e._objects_by_name()
        sg = s.ShardedGraph(cg, mesh(s, data=data, graph=graph))
        subjects = [("user", u) for u in users] + [("user", "nobody")]
        seeds, q, n = lookup_grid(cg, objs, subjects, *resource)
        out[s.name] = (e, sg, seeds, q, n, objs, users)
    j, t = out["jax"], out["torch"]
    assert np.array_equal(j[2], t[2]) and np.array_equal(j[3], t[3]), \
        "both packages must lay the store out alike"
    return j, t


# -- the cases of tests/test_parallel.py ---------------------------------


@pytest.mark.parametrize("data,graph", [(2, 4), (1, 8), (8, 1), (4, 2)])
def test_sharded_matches_unsharded(data, graph):
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    j, t = both_grids(data, graph)
    gj = j[1].query_grid(j[2], j[3])
    gt = t[1].query_grid(t[2], t[3])
    assert gt.dtype == np.bool_ and np.array_equal(gj, gt)
    e, _, seeds, q, _, objs, users = t
    interner = objs["doc"]
    for b, u in enumerate(users):
        want = set(e.lookup_resources("doc", "read", "user", u))
        got = {interner.string(i) for i in np.flatnonzero(gt[b]).tolist()
               if 2 <= i < len(interner)}
        assert got == want, u
    assert not gt[-1].any()
    # the flat form's counters equal the JAX future's
    qs, qb = flat_of(q)
    same_future(j[1].query_async(seeds, qs, qb),
                t[1].query_async(seeds, qs, qb), (data, graph))


def test_sharded_contig_grid_promise_matches_flat():
    out = {}
    for s in SIDES:
        e, users = build_engine(s)
        cg = e.compiled()
        objs = e._objects_by_name()
        sg = s.ShardedGraph(cg, mesh(s, data=2, graph=4))
        off = cg.offset_of("doc", "read")
        n = cg.type_sizes["doc"]
        subs = [("user", users[0]), ("user", users[3]), ("user", "nobody")]
        seeds = np.asarray([cg.encode_subject(t_, i, None, objs)
                            for (t_, i) in subs], dtype=np.int32)
        qs = np.tile(off + np.arange(n, dtype=np.int32), len(subs))
        qb = np.repeat(np.arange(len(subs), dtype=np.int32), n)
        out[s.name] = (sg.query_async(seeds, qs, qb),
                       sg.query_async(seeds, qs, qb,
                                      q_contig_grid=(off, n, len(subs))),
                       sg.query_async(seeds, qs, qb,
                                      q_contig_grid=(off, n, 2)), n)
    flat = None
    for fj, ft in zip(out["jax"][:3], out["torch"][:3]):
        got = same_future(fj, ft)
        flat = got if flat is None else flat
        assert np.array_equal(got, flat)
    n = out["torch"][3]
    assert flat[:n].any() and not flat[2 * n:].any()


def test_sharded_check_grid_odd_shapes():
    got = {}
    for s in SIDES:
        e, users = build_engine(s, seed=11)
        cg = e.compiled()
        objs = e._objects_by_name()
        sg = s.ShardedGraph(cg, mesh(s, data=2, graph=4))
        subjects = [("user", "u0"), ("user", "u3"), ("group", "g1")]
        checks = [("doc", f"d{i}", "read") for i in range(5)]
        seeds = np.asarray(
            [cg.encode_subject(t_, i, "member" if t_ == "group" else None,
                               objs) for (t_, i) in subjects],
            dtype=np.int32)
        q = np.asarray([[cg.encode_target(rt, perm, rid, objs)
                         for (rt, rid, perm) in checks] for _ in subjects],
                       dtype=np.int32)
        got[s.name] = (sg.query_grid(seeds, q), sg.query_async(
            seeds, *flat_of(q)))
        if s is T:
            for b, (t_, i) in enumerate(subjects):
                srel = "member" if t_ == "group" else None
                for qi, (rt, rid, perm) in enumerate(checks):
                    want = e.check(s.CheckItem(rt, rid, perm, t_, i, srel))
                    assert bool(got[s.name][0][b, qi]) == want
    assert np.array_equal(got["jax"][0], got["torch"][0])
    assert got["torch"][0].shape == (3, 5)
    same_future(got["jax"][1], got["torch"][1])


def test_sharded_expiration_mask():
    now = time.time()
    futs = {}
    for s in SIDES:
        e = engine(s, schema=s.parse_schema("""
            definition user {}
            definition doc {
              relation reader: user with expiration
              permission read = reader
            }
            """))
        e.write_relationships([
            s.WriteOp("touch", s.Relationship("doc", "live", "reader",
                                              "user", "u",
                                              expiration=now + 3600)),
            s.WriteOp("touch", s.Relationship("doc", "dead", "reader",
                                              "user", "u",
                                              expiration=now - 5))])
        cg = e.compiled()
        objs = e._objects_by_name()
        sg = s.ShardedGraph(cg, mesh(s))
        seeds = np.asarray([cg.encode_subject("user", "u", None, objs)],
                           dtype=np.int32)
        q = np.asarray([[cg.encode_target("doc", "read", "live", objs),
                         cg.encode_target("doc", "read", "dead", objs)]],
                       dtype=np.int32)
        assert sg.query_grid(seeds, q, now=now).tolist() == [[True, False]]
        futs[s.name] = sg.query_async(seeds, *flat_of(q), now=now)
    same_future(futs["jax"], futs["torch"])


def test_sharded_sees_incremental_updates():
    grids = {}
    for s in SIDES:
        e, users = build_engine(s, seed=23)
        e.compiled()
        c0 = counter(s, "engine_graph_compiles_total")
        existing = sorted(e.read_relationships(s.RelationshipFilter(
            resource_type="doc", relation="reader", subject_type="user")),
            key=str)[0]
        e.write_relationships([
            s.WriteOp("delete", existing),
            s.WriteOp("touch", s.rel("doc:d1#reader@user:u7")),
            s.WriteOp("touch", s.rel("group:g0#member@user:u6"))])
        cg = e.compiled()
        assert counter(s, "engine_graph_compiles_total") == c0
        assert cg.n_delta >= 2 and len(cg.dead_pairs) >= 1
        objs = e._objects_by_name()
        sg = s.ShardedGraph(cg, mesh(s, data=2, graph=4))
        seeds, q, _ = lookup_grid(cg, objs, [("user", u) for u in users],
                                  "doc", "read")
        grids[s.name] = (sg.query_grid(seeds, q),
                         sg.query_async(seeds, *flat_of(q)))
        interner = objs["doc"]
        for b, u in enumerate(users):
            want = set(e.lookup_resources("doc", "read", "user", u))
            got = {interner.string(i)
                   for i in np.flatnonzero(grids[s.name][0][b]).tolist()
                   if 2 <= i < len(interner)}
            assert got == want, (s.name, u)
    assert np.array_equal(grids["jax"][0], grids["torch"][0])
    same_future(grids["jax"][1], grids["torch"][1])


@pytest.fixture
def dense4(monkeypatch):
    """Dense blocks at test scale on both packages."""
    for s in SIDES:
        monkeypatch.setattr(s.reach, "DENSE_MIN_EDGES", 4)


def _engine_parity(engines, users):
    items = {s.name: [s.CheckItem("doc", f"d{d}", "read", "user", u)
                      for d in range(12) for u in users] for s in SIDES}
    want = engines["single"].check_bulk(items["torch"])
    for s in SIDES:
        assert engines[s.name].check_bulk(items[s.name]) == want, s.name
    for u in users:
        w = sorted(engines["single"].lookup_resources("doc", "read", "user",
                                                      u))
        for s in SIDES:
            assert sorted(engines[s.name].lookup_resources(
                "doc", "read", "user", u)) == w, (s.name, u)


def test_engine_mesh_routes_queries_through_sharded(dense4):
    engines = {}
    for s in SIDES:
        engines[s.name], users = build_engine(
            s, seed=5, mesh=mesh(s, data=2, graph=4))
    engines["single"], _ = build_engine(T, seed=5)
    em = engines["torch"]
    cg = em.compiled()
    assert cg.blocks, "need dense blocks to exercise the kernel path"
    sg = em._backend(cg)
    assert sg is not cg and sg._block_meta, \
        "a mesh engine routes through ShardedGraph with kept blocks"
    _engine_parity(engines, users)
    c0 = counter(T, "engine_graph_compiles_total")
    for name, eng in engines.items():
        s = J if name == "jax" else T
        eng.write_relationships([
            s.WriteOp("delete", s.rel("doc:d0#reader@user:u1")),
            s.WriteOp("touch", s.rel("doc:d2#banned@user:u0"))])
    _engine_parity(engines, users)
    assert counter(T, "engine_graph_compiles_total") == c0
    sg2 = em._sharded
    assert sg2.cg is em.compiled()
    # the incremental view shares the resident shards: no rebuild per
    # write (the level src/dst chunks are the same tensors)
    assert sg2 is not sg and sg2._state is sg._state
    for sh in sg2._state.shards.values():
        assert all(lv[0].numel() and lv[1].numel() for lv in sh["levels"])


def _proxy_script(s, tmp_path, tag):
    from importlib import import_module

    Options = import_module(s.pkg + ".proxy.options").Options
    InMemoryClient = import_module(s.pkg + ".proxy.inmemory").InMemoryClient
    kw = {"device": "cpu"} if s is T else {}

    async def go():
        cfg = Options(rule_files=[RULES], bootstrap_files=[BOOTSTRAP],
                      upstream=fake_kube_class(s.pkg)(),
                      workflow_database_path=str(tmp_path / f"{tag}.db"),
                      engine_mesh="data=2,graph=4", **kw).complete()
        assert cfg.engine.mesh is not None
        await cfg.workflow.resume_pending()
        alice = InMemoryClient(cfg.server.handle, user="alice")
        bob = InMemoryClient(cfg.server.handle, user="bob")
        seen = []
        for ns in ("mesh-a", "mesh-b"):
            resp = await alice.post("/api/v1/namespaces", {
                "apiVersion": "v1", "kind": "Namespace",
                "metadata": {"name": ns}})
            seen.append(resp.status)
        for who in (alice, bob):
            resp = await who.get("/api/v1/namespaces")
            seen.append(sorted(o["metadata"]["name"]
                               for o in json.loads(resp.body)["items"]))
        resp = await alice.delete("/api/v1/namespaces/mesh-b")
        seen.append(resp.status)
        resp = await alice.get("/api/v1/namespaces")
        seen.append([o["metadata"]["name"]
                     for o in json.loads(resp.body)["items"]])
        sharded = cfg.engine._sharded is not None
        await cfg.workflow.shutdown()
        return seen, sharded

    return asyncio.run(go())


def test_proxy_with_engine_mesh(tmp_path):
    got = {s.name: _proxy_script(s, tmp_path, s.name) for s in SIDES}
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == [201, 201, ["mesh-a", "mesh-b"], [], 200,
                               ["mesh-a"]]
    assert got["torch"][1], "the port's proxy served through the mesh"


CAVEAT_BOOTSTRAP = """
schema: |-
  use expiration
  caveat ip_allowlist(ip ipaddress, allowed list<ipaddress>) {
    ip in allowed
  }
  caveat win(now timestamp, until timestamp) { now < until }
  definition user {}
  definition doc {
    relation viewer: user | user with ip_allowlist
      | user with win | user with expiration
    permission view = viewer
  }
relationships: |-
  doc:readme#viewer@user:alice
  doc:readme#viewer@user:bob[ip_allowlist:{"allowed":["10.0.0.0/8"]}]
  doc:plan#viewer@user:bob[ip_allowlist:{"allowed":["192.168.0.0/16"]}]
"""


def test_sharded_caveated_matches_single_device_and_oracle():
    em = {s.name: engine(s, CAVEAT_BOOTSTRAP, mesh=mesh(s, data=2, graph=4))
          for s in SIDES}
    e1 = engine(T, CAVEAT_BOOTSTRAP)
    fb0 = counter(T, "engine_caveat_mesh_fallback_total")
    items = {s.name: [s.CheckItem("doc", d, "view", "user", u)
                      for d in ("readme", "plan") for u in ("alice", "bob")]
             for s in SIDES}
    for ctx in ({"ip": "10.0.0.5"}, {"ip": "192.168.1.1"},
                {"ip": "8.8.8.8"}, None):
        got = em["torch"].check_bulk(items["torch"], context=ctx)
        assert got == em["jax"].check_bulk(items["jax"], context=ctx), ctx
        assert got == e1.check_bulk(items["torch"], context=ctx), ctx
        o = em["torch"].oracle(context=ctx)
        assert got == [o.check(i.resource_type, i.resource_id, i.permission,
                               i.subject_type, i.subject_id)
                       for i in items["torch"]], ctx
    assert em["torch"]._sharded is not None
    assert counter(T, "engine_caveat_mesh_fallback_total") == fb0
    for ctx in ({"ip": "10.0.0.5"}, None):
        want = sorted(e1.lookup_resources("doc", "view", "user", "bob",
                                          context=ctx))
        for s in SIDES:
            assert sorted(em[s.name].lookup_resources(
                "doc", "view", "user", "bob", context=ctx)) == want
    # missing context fails closed, counted through the mesh path
    for s in SIDES:
        c0 = counter(s, "engine_caveat_denied_missing_context_total")
        assert em[s.name].check_bulk(
            [s.CheckItem("doc", "readme", "view", "user", "bob")]) == [False]
        assert counter(s, "engine_caveat_denied_missing_context_total") > c0
    # the futures' counters, caveats_missing included, equal JAX's
    futs = {}
    for s in SIDES:
        cg = em[s.name].compiled()
        objs = em[s.name]._objects_by_name()
        seeds = np.asarray([cg.encode_subject("user", "bob", None, objs)],
                           dtype=np.int32)
        qs = np.asarray([cg.encode_target("doc", d, "view", objs)
                         for d in ("readme", "plan")], dtype=np.int32)
        futs[s.name] = em[s.name]._backend(cg).query_async(
            seeds, qs, np.zeros(2, dtype=np.int32))
    same_future(futs["jax"], futs["torch"])
    assert futs["torch"].caveats_missing() > 0


def test_sharded_caveated_incremental_churn_differential():
    rng = np.random.default_rng(0xCAFE)
    em = {s.name: engine(s, CAVEAT_BOOTSTRAP, mesh=mesh(s, data=2, graph=4))
          for s in SIDES}
    e1 = engine(T, CAVEAT_BOOTSTRAP)
    users = [f"u{i}" for i in range(6)]
    docs = [f"d{i}" for i in range(5)]
    ctxs = ['{"allowed":["10.0.0.0/8"]}', '{"allowed":["172.16.0.0/12"]}']
    req = {"ip": "10.5.5.5"}
    now_fixed = time.time()

    def wr(kind, *args, **kw):
        for s in SIDES:
            op = s.WriteOp(kind, s.Relationship(*args, **kw))
            em[s.name].write_relationships([op])
            if s is T:
                e1.write_relationships([op])

    for name, e in (("torch", em["torch"]), ("single", e1)):
        e.check_bulk([T.CheckItem("doc", "readme", "view", "user",
                                  "alice")], context=req, now=now_fixed)
    em["jax"].check_bulk([J.CheckItem("doc", "readme", "view", "user",
                                      "alice")], context=req, now=now_fixed)
    compiles0 = counter(T, "engine_graph_compiles_total")
    fb0 = counter(T, "engine_caveat_mesh_fallback_total")
    live: list = []
    for step in range(16):
        kind = int(rng.integers(4))
        d = docs[int(rng.integers(len(docs)))]
        u = users[int(rng.integers(len(users)))]
        if kind == 0 and live:
            args = live.pop(int(rng.integers(len(live))))
            wr("delete", *args[0], **args[1])
        elif kind == 1:
            ctx = ctxs[int(rng.integers(len(ctxs)))]
            a = (("doc", d, "viewer", "user", u, None, None,
                  "ip_allowlist", ctx), {})
            wr("touch", *a[0], **a[1])
            live.append(a)
        elif kind == 2:
            exp = now_fixed + (300.0 if rng.random() < 0.5 else -300.0)
            a = (("doc", d, "viewer", "user", u), {"expiration": exp})
            wr("touch", *a[0], **a[1])
            live.append(a)
        else:
            a = (("doc", d, "viewer", "user", u), {})
            wr("touch", *a[0], **a[1])
            live.append(a)
        for ctx in (req, None):
            its = {s.name: [s.CheckItem("doc", dd, "view", "user", uu)
                            for dd in docs for uu in users] for s in SIDES}
            got = em["torch"].check_bulk(its["torch"], context=ctx,
                                         now=now_fixed)
            assert got == em["jax"].check_bulk(its["jax"], context=ctx,
                                               now=now_fixed), (step, ctx)
            assert got == e1.check_bulk(its["torch"], context=ctx,
                                        now=now_fixed), (step, ctx)
            o = em["torch"].oracle(now=now_fixed, context=ctx)
            assert got == [o.check(i.resource_type, i.resource_id,
                                   i.permission, i.subject_type,
                                   i.subject_id) for i in its["torch"]]
        want = sorted(e1.lookup_resources("doc", "view", "user", u,
                                          now=now_fixed, context=req))
        for s in SIDES:
            assert sorted(em[s.name].lookup_resources(
                "doc", "view", "user", u, now=now_fixed,
                context=req)) == want, (step, s.name)
    assert counter(T, "engine_graph_compiles_total") <= compiles0 + 4
    assert counter(T, "engine_caveat_mesh_fallback_total") == fb0


def test_sharded_updated_carries_caveat_instance_append():
    em = engine(T, CAVEAT_BOOTSTRAP, mesh=mesh(T, data=2, graph=4))
    ej = engine(J, CAVEAT_BOOTSTRAP, mesh=mesh(J, data=2, graph=4))
    for s, e in ((T, em), (J, ej)):
        e.check_bulk([s.CheckItem("doc", "readme", "view", "user", "bob")],
                     context={"ip": "10.0.0.1"})
    sg0 = em._sharded
    assert sg0 is not None
    inst0 = sg0._state.inst
    compiles0 = counter(T, "engine_graph_compiles_total")
    upd0 = counter(T, "engine_sharded_updates_total")
    rel = ('doc:memo#viewer@user:carol'
           '[ip_allowlist:{"allowed":["172.16.0.0/12"]}]')
    for s, e in ((T, em), (J, ej)):
        e.write_relationships([s.WriteOp("touch", s.rel(rel))])
    for ctx, want in (({"ip": "172.16.9.9"}, [True]),
                      ({"ip": "10.0.0.1"}, [False]), (None, [False])):
        for s, e in ((T, em), (J, ej)):
            assert e.check_bulk([s.CheckItem("doc", "memo", "view", "user",
                                             "carol")],
                                context=ctx) == want, (s.name, ctx)
    assert counter(T, "engine_graph_compiles_total") == compiles0, \
        "an instance append must not recompile"
    assert counter(T, "engine_sharded_updates_total") > upd0
    sg1 = em._sharded
    assert sg1 is not sg0 and sg1._state is sg0._state, \
        "updated() must reuse the resident mesh state"
    assert sg1._state.inst != inst0, \
        "the replicated instance tables must have advanced"
    assert em.oracle(context={"ip": "172.16.9.9"}).check(
        "doc", "memo", "view", "user", "carol")


def test_sharded_kstep_fuses_convergence_checks():
    out = {}
    for s in SIDES:
        e, users = build_engine(s, seed=3)
        cg = e.compiled()
        objs = e._objects_by_name()
        sg = s.ShardedGraph(cg, mesh(s, data=2, graph=4))
        assert sg.k_steps >= 2
        off = cg.offset_of("doc", "read")
        n = cg.type_sizes["doc"]
        seeds = np.asarray([cg.encode_subject("user", users[0], None,
                                              objs)], dtype=np.int32)
        qs = off + np.arange(n, dtype=np.int32)
        qb = np.zeros(n, dtype=np.int32)
        f1 = cg.query_async(seeds, qs, qb)
        sg4 = s.ShardedGraph(cg, mesh(s, data=2, graph=4), k_steps=4)
        out[s.name] = (f1, sg.query_async(seeds, qs, qb),
                       sg4.query_async(seeds, qs, qb), sg.k_steps)
    for fj, ft in zip(out["jax"][1:3], out["torch"][1:3]):
        same_future(fj, ft)
    f1, fm, f4, k = out["torch"]
    want = f1.result()
    iters_single = f1.iterations()
    assert np.array_equal(fm.result(), want)
    checks = fm.conv_checks()
    assert 1 <= checks <= -(-iters_single // k) + 1
    assert fm.iterations() == iters_single
    assert fm.iterations() <= checks * k
    if iters_single > k:
        assert checks < iters_single
    assert np.array_equal(f4.result(), want)
    assert f4.conv_checks() <= -(-iters_single // 4) + 1
    assert f4.iterations() == iters_single


def test_sharded_refuses_unstratified_caveated_graph():
    for s in SIDES:
        e = engine(s, CAVEAT_BOOTSTRAP)
        cg = e.compiled()
        assert s.ShardedGraph.unsupported_reason(cg) is None
        kw = dict(res_src=None, res_dst=None, res_exp=None, res_cav=None,
                  res_level_bounds=None)
        if s is J:
            kw["_device"] = {}
        bare = dataclasses.replace(cg, **kw)
        assert s.ShardedGraph.unsupported_reason(bare) is not None
        with pytest.raises(ValueError, match="cannot serve"):
            s.ShardedGraph(bare, mesh(s))
        e2 = engine(s, CAVEAT_BOOTSTRAP, mesh=mesh(s))
        fb0 = counter(s, "engine_caveat_mesh_fallback_total")
        assert e2._backend(bare) is bare
        assert counter(s, "engine_caveat_mesh_fallback_total") == fb0 + 1


def test_mesh_topology_label():
    t = mesh_topology(mesh(T, data=2, graph=4))
    assert t == {"devices": 8, "data": 2, "graph": 4, "platform": "cpu"}
    j = j_parallel.mesh.mesh_topology(mesh(J, data=2, graph=4))
    assert {k: v for k, v in t.items() if k != "platform"} == \
        {k: v for k, v in j.items() if k != "platform"}
    # the default split: data=2 from 4 even cells on, as the reference
    for n in (1, 2, 3, 4, 6, 8):
        assert T.make_mesh(n, devices=CPU8[:n]).shape == dict(
            J.make_mesh(n, devices=jax.devices()[:n]).shape)


def test_mesh_spec_parsing():
    from spicedb_kubeapi_proxy_tpu.parallel.mesh import (
        MeshSpecError as JMeshSpecError,
    )
    from spicedb_kubeapi_proxy_tpu.parallel.mesh import (
        parse_mesh_spec as jparse,
    )
    from spicedb_kubeapi_proxy_tpu_torch.parallel.mesh import parse_mesh_spec
    from spicedb_kubeapi_proxy_tpu_torch.proxy import options as topts

    for spec in ("auto", "data=2,graph=4", "graph=8"):
        assert parse_mesh_spec(spec) == jparse(spec)
        assert topts._parse_mesh_spec(spec) == jparse(spec)
    for bad in ("nope", "data=x", "data=0", "rows=2"):
        with pytest.raises(JMeshSpecError) as je:
            jparse(bad)
        with pytest.raises(MeshSpecError) as te:
            parse_mesh_spec(bad)
        assert str(te.value) == str(je.value)
        with pytest.raises(topts.OptionsError):
            topts._parse_mesh_spec(bad)
    with pytest.raises(topts.OptionsError, match="engine-mesh applies"):
        topts.Options(engine_endpoint="tcp://h:1", engine_mesh="auto",
                      rule_content="x", upstream_url="http://u").validate()


def test_sharded_update_after_recompile_with_equal_signature():
    rng = np.random.default_rng(7)
    rels = [f"namespace:n{i}#creator@user:u{int(rng.integers(50))}"
            for i in range(300)]
    got = {}
    for s in SIDES:
        em = engine(s, mesh=mesh(s, 4))
        em.write_relationships(touch(s, rels))
        item = s.CheckItem("namespace", "n1", "view", "user", "u49")
        assert em.check_bulk([item]) == [False]
        upd0 = counter(s, "engine_sharded_updates_total")
        sig0 = em.compiled().signature()
        em.write_relationships(touch(s, ["namespace:n1#viewer@user:u49"]))
        got[s.name] = em.check_bulk([item])
        assert got[s.name] == [True], \
            "stale sharded shards after an equal-signature recompile"
        assert em.oracle().check("namespace", "n1", "view", "user", "u49")
        assert counter(s, "engine_sharded_updates_total") > upd0
        if s is T:
            assert em.compiled().signature() == sig0, \
                "the case needs the recompile to keep the signature"
    assert got["jax"] == got["torch"]


def test_sharded_incremental_interleaving_fuzz():
    rng = np.random.default_rng(0xFADE)
    bootstrap = """
schema: |-
  use expiration

  definition cluster {}
  definition user {}
  definition namespace {
    relation cluster: cluster
    relation creator: user
    relation viewer: user | user with expiration
    permission admin = creator
    permission view = viewer + creator
  }
  definition pod {
    relation namespace: namespace
    relation creator: user
    relation viewer: user
    permission view = viewer + creator + namespace->view
  }
relationships: ""
"""
    em = {s.name: engine(s, bootstrap, mesh=mesh(s, 4)) for s in SIDES}
    e1 = engine(T, bootstrap)
    live: list = []

    def wr(kind, *args, **kw):
        for s in SIDES:
            ops = [s.WriteOp(kind, s.rel(args[0]) if not kw
                             else s.Relationship(*args, **kw))]
            em[s.name].write_relationships(ops)
            if s is T:
                e1.write_relationships(ops)

    seed = [f"namespace:n{i}#creator@user:u{int(rng.integers(12))}"
            for i in range(40)]
    for s in SIDES:
        em[s.name].write_relationships(touch(s, seed))
    e1.write_relationships(touch(T, seed))
    live += seed
    now_fixed = 1_700_000_000.0
    for step in range(14):
        kind = rng.integers(5)
        if kind == 0 and live:
            wr("delete", live.pop(int(rng.integers(len(live)))))
        elif kind == 1:
            r = (f"namespace:n{int(rng.integers(40))}#viewer"
                 f"@user:u{int(rng.integers(12))}")
            wr("touch", r)
            live.append(r)
        elif kind == 2:
            r = f"namespace:fresh-{step}#creator@user:new-u{step}"
            wr("touch", r)
            live.append(r)
        elif kind == 3:
            r = (f"pod:n{int(rng.integers(40))}/p{step}#viewer"
                 f"@user:u{int(rng.integers(12))}")
            wr("touch", r)
            live.append(r)
        else:
            exp = now_fixed + (300.0 if rng.random() < 0.5 else -300.0)
            wr("touch", "namespace", f"n{int(rng.integers(40))}", "viewer",
               "user", f"u{int(rng.integers(12))}", expiration=exp)
        pairs = list(zip(rng.integers(42, size=12).tolist(),
                         rng.integers(12, size=12).tolist()))
        its = {s.name: [s.CheckItem("namespace", f"n{i}", "view", "user",
                                    f"u{u}") for i, u in pairs]
               for s in SIDES}
        got = em["torch"].check_bulk(its["torch"], now=now_fixed)
        assert got == e1.check_bulk(its["torch"], now=now_fixed), step
        assert got == em["jax"].check_bulk(its["jax"], now=now_fixed), step
        oracle = em["torch"].oracle(now=now_fixed)
        for it, g in zip(its["torch"], got):
            assert g == oracle.check(it.resource_type, it.resource_id,
                                     it.permission, it.subject_type,
                                     it.subject_id), (step, it)
        u = f"u{int(rng.integers(12))}"
        want = sorted(e1.lookup_resources("namespace", "view", "user", u,
                                          now=now_fixed))
        for s in SIDES:
            assert sorted(em[s.name].lookup_resources(
                "namespace", "view", "user", u, now=now_fixed)) == want


def _watch_script(s, tmp_path):
    from importlib import import_module
    from urllib.parse import parse_qs

    Options = import_module(s.pkg + ".proxy.options").Options
    InMemoryClient = import_module(s.pkg + ".proxy.inmemory").InMemoryClient
    kw = {"device": "cpu"} if s is T else {}

    async def go():
        cfg = Options(rule_files=[RULES], bootstrap_files=[BOOTSTRAP],
                      upstream=fake_kube_class(s.pkg)(),
                      workflow_database_path=str(tmp_path / f"w{s.name}.db"),
                      engine_mesh="data=2,graph=4", **kw).complete()
        await cfg.workflow.resume_pending()
        alice = InMemoryClient(cfg.server.handle, user="alice")
        resp = await alice.post("/api/v1/namespaces", {
            "apiVersion": "v1", "kind": "Namespace",
            "metadata": {"name": "mw-a"}})
        assert resp.status == 201
        resp = await alice.get("/api/v1/namespaces",
                               query=parse_qs("watch=true"))
        assert resp.status == 200 and resp.stream is not None
        frames: list = []

        async def consume():
            async for f in resp.stream:
                frames.append(json.loads(bytes(f)))
                if len(frames) >= 2:
                    return

        task = asyncio.ensure_future(consume())
        await asyncio.sleep(0.1)
        resp2 = await alice.post("/api/v1/namespaces", {
            "apiVersion": "v1", "kind": "Namespace",
            "metadata": {"name": "mw-b"}})
        assert resp2.status == 201
        await asyncio.wait_for(task, timeout=15)
        sharded = cfg.engine._sharded is not None
        await cfg.workflow.shutdown()
        return [(f["type"], f["object"]["metadata"]["name"])
                for f in frames], sharded

    return asyncio.run(go())


def test_watch_over_engine_mesh(tmp_path):
    got = {s.name: _watch_script(s, tmp_path) for s in SIDES}
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == [("ADDED", "mw-a"), ("ADDED", "mw-b")]
    assert got["torch"][1]


def test_semiring_push_pull_differential_churn(monkeypatch):
    monkeypatch.setenv("SDBKP_BITPROP", "interpret")
    for s in SIDES:
        monkeypatch.setattr(s.reach, "DENSE_MIN_EDGES", 8)
    rng = np.random.default_rng(0x5E31)
    users = [f"u{i}" for i in range(7)]
    docs = [f"d{i}" for i in range(10)]
    engines = {("single", "jax"): engine(J, CAVEAT_BOOTSTRAP),
               ("single", "torch"): engine(T, CAVEAT_BOOTSTRAP),
               ("mesh", "jax"): engine(J, CAVEAT_BOOTSTRAP,
                                       mesh=mesh(J, data=2, graph=4)),
               ("mesh", "torch"): engine(T, CAVEAT_BOOTSTRAP,
                                         mesh=mesh(T, data=2, graph=4))}
    side = {"jax": J, "torch": T}
    seed_rels = [f"doc:{d}#viewer@user:{u}" for d in docs for u in users
                 if (docs.index(d) * 7 + users.index(u)) % 2]
    for (_, p), e in engines.items():
        e.write_relationships(touch(side[p], seed_rels))
    cg = engines[("single", "torch")].compiled()
    assert cg.blocks, "differential needs at least one dense block"
    assert any(b is not None for b in cg._dev()["blocks_bits"]), \
        "differential needs a bit-packed dual (real push path)"
    now_fixed = time.time()
    req = {"ip": "10.5.5.5"}
    ctxs = ['{"allowed":["10.0.0.0/8"]}', '{"allowed":["172.16.0.0/12"]}']
    live: list = []
    for step in range(6):
        kind = int(rng.integers(4))
        d = docs[int(rng.integers(len(docs)))]
        u = users[int(rng.integers(len(users)))]
        if kind == 0 and live:
            op = ("delete",) + live.pop(int(rng.integers(len(live))))
        elif kind == 1:
            a = (("doc", d, "viewer", "user", u, None, None, "ip_allowlist",
                  ctxs[int(rng.integers(len(ctxs)))]), {})
            live.append(a)
            op = ("touch",) + a
        elif kind == 2:
            exp = now_fixed + (300.0 if rng.random() < 0.5 else -300.0)
            a = (("doc", d, "viewer", "user", u), {"expiration": exp})
            live.append(a)
            op = ("touch",) + a
        else:
            a = (("doc", d, "viewer", "user", u), {})
            live.append(a)
            op = ("touch",) + a
        for (_, p), e in engines.items():
            s = side[p]
            e.write_relationships([s.WriteOp(
                op[0], s.Relationship(*op[1], **op[2]))])
        for ctx in (req, None):
            o = engines[("single", "torch")].oracle(now=now_fixed,
                                                    context=ctx)
            want = [o.check("doc", d_, "view", "user", u_)
                    for d_ in docs for u_ in users]
            for mode in ("pull", "push", "auto"):
                with J.semiring.force_mode(mode), \
                        T.semiring.force_mode(mode):
                    for (kind_, p), e in engines.items():
                        s = side[p]
                        items = [s.CheckItem("doc", d_, "view", "user", u_)
                                 for d_ in docs for u_ in users]
                        got = e.check_bulk(items, context=ctx,
                                           now=now_fixed)
                        assert got == want, (step, ctx, mode, kind_, p)


# -- the port's own cases ---------------------------------------------------


@pytest.mark.parametrize("graph", [2, 4, 8])
def test_kept_block_shards_meet_the_card_kernels_layout(dense4, graph):
    """Every kept shard is what ``dense_or_matmul`` accepts on the card
    (ops/bitprop.py ``_require``): a contiguous int8 ``[n_dst, w]`` tensor,
    ``w % 16 == 0``, 16-byte aligned; and its frontier, the state's
    columns ``src_off + g*w ... + w``, starts 16-byte aligned with a row
    stride that is a multiple of 16 bytes. Each shard holds exactly the
    block's live cells of its columns."""
    e, users = build_engine(T, seed=5)
    e.write_relationships(touch(T, ["doc:d0#banned@user:u1"]))
    cg = e.compiled()
    assert cg.blocks
    sg = T.ShardedGraph(cg, mesh(T, data=8 // graph, graph=graph))
    shards = sg.block_shards()
    assert shards and len(shards) == len(sg._block_meta) * graph
    Mp = (cg.M // t_reach.LANE + 1) * t_reach.LANE
    V = torch.zeros((3, Mp), dtype=torch.uint8)
    for bm, g, A in shards:
        w = bm.n_src // graph
        assert A.dtype == torch.int8 and A.is_contiguous()
        assert tuple(A.shape) == (bm.n_dst, w) and w % 16 == 0
        assert A.data_ptr() % 16 == 0
        lo = bm.src_off + g * w
        f = V[:, lo:lo + w]
        assert lo % 16 == 0 and f.stride(1) == 1
        assert (f.stride(0) * f.element_size()) % 16 == 0
        full = next(b for b in cg.resident.blocks
                    if (b.dst_off, b.src_off) == (bm.dst_off, bm.src_off))
        dl, sl = cg._live_cells(full)
        want = torch.zeros((bm.n_dst, bm.n_src), dtype=torch.int8)
        want[torch.as_tensor(dl), torch.as_tensor(sl)] = 1
        assert torch.equal(A, want[:, g * w:(g + 1) * w])


def test_mesh_readers_never_see_a_mixed_revision(monkeypatch):
    """Reader threads query a mesh engine while a writer folds writes
    (kills of base edges and dense-block cells, overlay adds, deletes)
    into the shared mesh state in place. Every read equals the oracle at
    one revision between the last acknowledged write before it and the
    store's revision after it: never a mix of two."""
    from spicedb_kubeapi_proxy_tpu_torch.engine.evaluator import (
        OracleEvaluator,
    )
    from spicedb_kubeapi_proxy_tpu_torch.engine.store import Store

    monkeypatch.setattr(t_reach, "DENSE_MIN_EDGES", 5)
    schema = T.parse_schema("""
definition user {}
definition group {
  relation member: user | group#member
}
definition namespace {
  relation viewer: user | group#member
  permission view = viewer
}
""")
    e = T.Engine(schema=schema, device="cpu", mesh=mesh(T, data=2, graph=4))
    e.CHECK_PIPELINE_CHUNK = 16
    base = [f"namespace:ns{i}#viewer@user:u{(i * 3) % 8}" for i in range(8)]
    base += [f"namespace:ns{i}#viewer@group:g{i % 4}#member"
             for i in range(8)]
    base += [f"group:g{g}#member@user:u{g}" for g in range(4)]
    base += [f"group:g{g}#member@group:g{(g + 1) % 4}#member"
             for g in range(4)]
    e.write_relationships(touch(T, base))
    items = [("namespace", f"ns{n}", "view", "user", f"u{u}")
             for u in range(8) for n in range(8)]
    e.check_bulk([T.CheckItem(*it) for it in items])
    assert e._sharded is not None and e._sharded._block_meta
    rng = np.random.default_rng(3)
    writes = []
    for k in range(18):
        r = base[int(rng.integers(len(base)))] if k % 3 else (
            f"namespace:ns{rng.integers(8)}#viewer@user:u{rng.integers(8)}")
        writes.append(("delete" if k % 3 == 1 else "touch", r))
    shadow = Store()
    shadow.write(touch(T, base))
    want = {}
    rev = e.revision

    def expect(r):
        o = OracleEvaluator(schema, shadow.snapshot())
        want[r] = [o.check(*it) for it in items]

    expect(rev)
    for op, r in writes:
        shadow.write([T.WriteOp(op, T.rel(r))])
        rev += 1
        expect(rev)
    stop = threading.Event()
    errors, reads, acked = [], [0], [e.revision]

    def reader():
        while not stop.is_set():
            try:
                r0 = acked[0]
                got = e.check_bulk([T.CheckItem(*it) for it in items])
                r1 = e.revision
                if not any(got == want[r] for r in range(r0, r1 + 1)):
                    errors.append((r0, r1))
                reads[0] += 1
            except Exception as ex:  # noqa: BLE001 - reported below
                errors.append(repr(ex))

    threads = [threading.Thread(target=reader, daemon=True)
               for _ in range(3)]
    for t in threads:
        t.start()
    try:
        for op, r in writes:
            e.write_relationships([T.WriteOp(op, T.rel(r))])
            acked[0] = e.revision
            time.sleep(0.01)
    finally:
        stop.set()
        for t in threads:
            t.join(30)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:3]
    assert reads[0] > 0
    assert e.check_bulk([T.CheckItem(*it) for it in items]) == \
        want[e.revision]
    assert e._sharded._state is not None


def test_a_cuda_mesh_without_a_card_raises():
    """The default mesh takes every CUDA card of the world; with none it
    raises — nothing falls back to CPU cells."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default mesh is built there")
    with pytest.raises(RuntimeError, match="CUDA mesh was requested"):
        T.make_mesh()
    with pytest.raises(RuntimeError, match="CUDA mesh was requested"):
        t_parallel.mesh.mesh_from_spec("data=1,graph=2", "cuda")
    # the CPU's cells come only when asked for
    m = t_parallel.mesh.mesh_from_spec("data=2,graph=4", "cpu")
    assert mesh_topology(m) == {"devices": 8, "data": 2, "graph": 4,
                                "platform": "cpu"}
