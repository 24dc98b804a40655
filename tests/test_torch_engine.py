"""PyTorch port, engine/engine.py: the port Engine (plain kernels on CPU
tensors) against the JAX Engine (Pallas kernels in interpreter mode) and
the host OracleEvaluator on the same writes — list-filter masks and bulk
checks under push, pull and auto, on deploy/bootstrap.yaml (an expiring
``user:*`` wildcard) and on a schema with recursive groups (closured
blocks), intersection, exclusion and expired grants — plus the device
rule (cuda by default, never a quiet CPU fallback), caveated inputs
against the JAX engine, and an import guard proving the port never loads JAX or the
JAX package."""

import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from spicedb_kubeapi_proxy_tpu.engine import CheckItem as JCheckItem
from spicedb_kubeapi_proxy_tpu.engine import Engine as JEngine
from spicedb_kubeapi_proxy_tpu.engine import WriteOp as JWriteOp
from spicedb_kubeapi_proxy_tpu.models.tuples import \
    parse_relationship as jparse_rel
from spicedb_kubeapi_proxy_tpu.ops import reachability as jreach
from spicedb_kubeapi_proxy_tpu.ops import semiring as jsemi
from spicedb_kubeapi_proxy_tpu.utils.metrics import metrics as jmetrics
from spicedb_kubeapi_proxy_tpu_torch.engine import CheckItem, Engine, WriteOp
from spicedb_kubeapi_proxy_tpu_torch.engine.store import \
    RelationshipFilter
from spicedb_kubeapi_proxy_tpu_torch.models import SchemaError
from spicedb_kubeapi_proxy_tpu_torch.models.tuples import parse_relationship
from spicedb_kubeapi_proxy_tpu_torch.ops import reachability as treach
from spicedb_kubeapi_proxy_tpu_torch.ops import semiring as tsemi
from spicedb_kubeapi_proxy_tpu_torch.utils.metrics import metrics

from torch_parity import random_rels

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NOW = time.time()

with open(os.path.join(REPO, "deploy", "bootstrap.yaml")) as fh:
    BOOTSTRAP = fh.read()

RICH = """
schema: |-
  use expiration

  definition user {}
  definition group {
    relation member: user | group#member
  }
  definition namespace {
    relation creator: user
    relation viewer: user | user with expiration | group#member | user:* with expiration
    relation banned: user
    permission admin = creator
    permission view = (viewer + creator) - banned
  }
  definition pod {
    relation namespace: namespace
    relation creator: user
    relation viewer: user
    relation auditor: user
    permission edit = creator
    permission view = viewer + creator + namespace->view
    permission audit = auditor & namespace->view
  }
relationships: ""
"""


def _engines(monkeypatch, bootstrap, rels, dense_min):
    monkeypatch.setenv("SDBKP_BITPROP", "interpret")
    monkeypatch.setenv("SDBKP_SEMIRING", "interpret")
    monkeypatch.setattr(jreach, "DENSE_MIN_EDGES", dense_min)
    monkeypatch.setattr(treach, "DENSE_MIN_EDGES", dense_min)
    je = JEngine(bootstrap)
    je.write_relationships([JWriteOp("touch", jparse_rel(r)) for r in rels])
    te = Engine(bootstrap, device="cpu")
    te.write_relationships([WriteOp("touch", parse_relationship(r))
                            for r in rels])
    return je, te


def _users(n=9):
    return [f"u{i}" for i in range(n)] + ["nobody"]


def _assert_parity(je, te, perms, subject_counts):
    """Every user's mask on both engines and the oracle, then one bulk
    check for each count of distinct subjects (B > 8 has no push)."""
    oracle = te.oracle(now=NOW)
    users = _users()
    for rtype, perm in perms:
        for u in users:
            jm, _ = je.lookup_resources_mask(rtype, perm, "user", u, now=NOW)
            tm, interner = te.lookup_resources_mask(rtype, perm, "user", u,
                                                    now=NOW)
            np.testing.assert_array_equal(tm, jm, err_msg=f"{rtype}#{perm}@{u}")
            ids = {interner.string(i) for i in np.flatnonzero(tm)}
            assert ids == oracle.lookup_resources(rtype, perm, "user", u)
    for n_subjects in subject_counts:
        items = []
        rng = np.random.default_rng(n_subjects)
        for _ in range(120):
            rtype, perm = perms[rng.integers(len(perms))]
            rid = {"pod": "p", "namespace": "ns"}[rtype] + str(
                rng.integers(14))
            items.append((rtype, rid, perm, "user",
                          users[rng.integers(n_subjects)]))
        want = je.check_bulk([JCheckItem(*it) for it in items], now=NOW)
        got = te.check_bulk([CheckItem(*it) for it in items], now=NOW)
        assert got == want
        assert got == [oracle.check(*it) for it in items]
        assert any(got) and not all(got)


@pytest.mark.parametrize("mode", ["auto", "push", "pull"])
def test_bootstrap_wildcard_expiring_parity(monkeypatch, mode):
    rels = random_rels(np.random.default_rng(11), nested=False,
                       expiring="wildcard", now=NOW)
    je, te = _engines(monkeypatch, BOOTSTRAP, rels, 8)
    assert any(b.n_dst for b in te.compiled().blocks)
    with jsemi.force_mode(mode), tsemi.force_mode(mode):
        # 10 subjects: B > 8 takes pull; 4: the bit kernel under push
        _assert_parity(je, te, [("pod", "view"), ("namespace", "view"),
                                ("pod", "edit")], (4, 10))


@pytest.mark.parametrize("dense_min", [2, 1024])
def test_recursive_groups_intersection_exclusion_parity(monkeypatch,
                                                       dense_min):
    rng = np.random.default_rng(7)
    rels = random_rels(rng, n_groups=5, now=NOW)
    rels += ["namespace:ns0#banned@user:u3", "pod:p2#auditor@user:u5",
             "pod:p4#auditor@user:u1", "pod:p5#auditor@user:u2"]
    je, te = _engines(monkeypatch, RICH, rels, dense_min)
    blocks = te.compiled().blocks
    assert any(b.closured for b in blocks) == (dense_min == 2)
    for mode in ("auto", "pull"):
        with jsemi.force_mode(mode), tsemi.force_mode(mode):
            _assert_parity(je, te, [("pod", "view"), ("pod", "audit"),
                                    ("namespace", "view")], (10,))


def test_writes_recompile_and_counters(monkeypatch):
    """A write between objects the compiled layout covers is one
    incremental overlay update on both engines: no second compile."""
    rels = random_rels(np.random.default_rng(3), nested=False,
                       expiring="wildcard", now=NOW)
    je, te = _engines(monkeypatch, BOOTSTRAP, rels, 8)
    metrics.reset()
    jmetrics.reset()
    before = te.lookup_resources("pod", "view", "user", "u0", now=NOW)
    je.lookup_resources("pod", "view", "user", "u0", now=NOW)
    cg0 = te.compiled()
    rel = parse_relationship("pod:p0#viewer@user:u0")
    op = "delete" if "p0" in before else "touch"
    te.write_relationships([WriteOp(op, rel)])
    je.write_relationships([JWriteOp(op, jparse_rel(str(rel)))])
    after = te.lookup_resources("pod", "view", "user", "u0", now=NOW)
    cg1 = te.compiled()
    assert cg1 is not cg0 and cg1.revision == te.revision
    assert cg1.resident is cg0.resident  # patched in place, not rebuilt
    assert ("p0" in after) != ("p0" in before)
    assert sorted(after) == sorted(
        je.lookup_resources("pod", "view", "user", "u0", now=NOW))
    for reg in (metrics, jmetrics):
        assert reg.counter("engine_graph_compiles_total").value == 1
        assert reg.counter(
            "engine_graph_incremental_updates_total").value == 1
    assert metrics.counter("engine_semiring_push_steps_total").value > 0
    te.check_bulk([CheckItem("pod", "p1", "view", "user", f"u{i}")
                   for i in range(9)], now=NOW)
    assert metrics.counter("engine_semiring_pull_steps_total").value > 0
    assert [r.resource_id for r in te.read_relationships(
        RelationshipFilter(resource_type="pod", resource_id="p0",
                           relation="viewer", subject_id="u0"))] == \
        (["p0"] if op == "touch" else [])


def test_chunked_bulk_check_pipeline(monkeypatch):
    rels = random_rels(np.random.default_rng(5), nested=False,
                       expiring="wildcard", now=NOW)
    _, te = _engines(monkeypatch, BOOTSTRAP, rels, 8)
    items = [CheckItem("pod", f"p{i % 12}", "view", "user", f"u{i % 9}")
             for i in range(50)]
    whole = te.check_bulk(items, now=NOW)
    te.CHECK_PIPELINE_CHUNK = 7
    fut = te.check_bulk_async(items, now=NOW)
    assert fut.result() == whole
    assert fut.iterations() >= 1
    assert te.check_bulk([], now=NOW) == []
    # unknown types, permissions and subjects read the trash slot: False
    assert te.check_bulk([CheckItem("pod", "p0", "nope", "user", "u0"),
                          CheckItem("nope", "x", "view", "user", "u0"),
                          CheckItem("pod", "p0", "view", "nope", "u0")],
                         now=NOW) == [False, False, False]
    assert te.lookup_resources_mask("nope", "view", "user", "u0") == \
        (None, None)


def test_device_default_is_cuda(monkeypatch):
    """No device argument means cuda; without one, construction raises
    instead of quietly running on the CPU."""
    assert Engine(device="cpu").device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine()
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(device="cuda")
    with pytest.raises(ValueError):
        Engine(device="meta")


def test_caveats_are_refused():
    """The three caveated inputs the engine once refused (a caveat
    definition, a ``with <caveat>`` grant, a caveated write) now load on
    both engines and agree on every verdict under a request context
    that satisfies the caveat, one that does not, and none."""
    caveated = BOOTSTRAP.replace(
        "definition user {}",
        "caveat on_tuesday(day string) {\n    day == 'tuesday'\n  }\n\n"
        "  definition user {}").replace(
        "relation viewer: user\n", "relation viewer: user | user with "
        "on_tuesday\n")
    je, te = JEngine(caveated), Engine(caveated, device="cpu")
    assert set(te.schema.caveat_defs) == {"on_tuesday"}
    rel = 'pod:p#viewer@user:u[on_tuesday:{"day":"tuesday"}]'
    je.write_relationships([JWriteOp("touch", jparse_rel(rel))])
    te.write_relationships([WriteOp("touch", parse_relationship(rel))])
    item = ("pod", "p", "view", "user", "u")
    for ctx, want in (({"day": "tuesday"}, True), ({"day": "monday"}, True),
                      (None, True)):
        # the tuple's own context supplies `day` and wins over the request
        assert te.check(CheckItem(*item), now=NOW, context=ctx) is want
        assert je.check(JCheckItem(*item), now=NOW, context=ctx) is want
    rel = "pod:q#viewer@user:u[on_tuesday]"
    je.write_relationships([JWriteOp("touch", jparse_rel(rel))])
    te.write_relationships([WriteOp("touch", parse_relationship(rel))])
    item = ("pod", "q", "view", "user", "u")
    for ctx, want in (({"day": "tuesday"}, True), ({"day": "monday"}, False),
                      (None, False)):
        assert te.check(CheckItem(*item), now=NOW, context=ctx) is want
        assert je.check(JCheckItem(*item), now=NOW, context=ctx) is want
        assert te.lookup_resources("pod", "view", "user", "u", now=NOW,
                                   context=ctx) == \
            je.lookup_resources("pod", "view", "user", "u", now=NOW,
                                context=ctx)
    with pytest.raises(SchemaError, match="unknown trait"):
        Engine(BOOTSTRAP.replace("relation creator: user",
                                 "relation creator: user with on_tuesday",
                                 1), device="cpu")


GUARD = r"""
import importlib.abc, sys
class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib") or top == "spicedb_kubeapi_proxy_tpu":
            raise ImportError("port imported " + name)
        return None
sys.meta_path.insert(0, Refuse())
import pkgutil, importlib
import spicedb_kubeapi_proxy_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
import spicedb_kubeapi_proxy_tpu_torch.engine.compaction
import spicedb_kubeapi_proxy_tpu_torch.engine.batcher
import spicedb_kubeapi_proxy_tpu_torch.engine.decision_cache
import spicedb_kubeapi_proxy_tpu_torch.utils.features
from spicedb_kubeapi_proxy_tpu_torch.engine import Engine, CheckItem
from spicedb_kubeapi_proxy_tpu_torch.engine import WriteOp
from spicedb_kubeapi_proxy_tpu_torch.models.tuples import parse_relationship
e = Engine(device="cpu")
assert e.check_bulk([CheckItem("pod", "x", "view", "user", "u")]) == [False]
e.enable_compaction(1.0)
e.write_relationships([WriteOp("touch", parse_relationship(
    "pod:x#viewer@user:u"))])
assert e.check_bulk([CheckItem("pod", "x", "view", "user", "u")]) == [True]
assert e.compactor.compact()
e.close_compaction()
e.enable_decision_cache()
e.enable_lookup_batching(window=0.001)
assert e.lookup_resources("pod", "view", "user", "u") == ["x"]
assert e.lookup_resources("pod", "view", "user", "u") == ["x"]
e.disable_lookup_batching()
e.disable_decision_cache()
import tempfile
d = tempfile.mkdtemp()
e.enable_persistence(d, wal_fsync="always")
e.write_relationships([WriteOp("touch", parse_relationship(
    "pod:y#viewer@user:u"))])
e.close_persistence()
r = Engine(device="cpu", device_graph_budget_bytes=1)
assert r.enable_persistence(d).recovery.snapshot_path
assert sorted(r.lookup_resources("pod", "view", "user", "u")) == ["x", "y"]
assert r.compiled().tier is not None
r.close_persistence()
import shutil
shutil.rmtree(d)
import asyncio, threading
from spicedb_kubeapi_proxy_tpu_torch.engine.remote import (
    EngineServer, RemoteEngine, main)
g = Engine(device="cpu")
loop = asyncio.new_event_loop()
th = threading.Thread(target=loop.run_forever, daemon=True)
th.start()
srv = EngineServer(g)
asyncio.run_coroutine_threadsafe(srv.start(), loop).result(30)
c = RemoteEngine("127.0.0.1", srv.port)
stream = c.watch_push_stream(c.revision)
assert c.check_bulk([CheckItem("pod", "z", "view", "user", "u")]) == [False]
c.write_relationships([WriteOp("touch", parse_relationship(
    "pod:z#viewer@user:u"))])
m, ids = c.lookup_resources_mask("pod", "view", "user", "u")
assert [ids.string(i) for i in m.nonzero()[0]] == ["z"]
ev = []
while not ev:
    ev = stream.next_batch()
assert ev[0].relationship.resource_id == "z"
stream.close()
c.close()
asyncio.run_coroutine_threadsafe(srv.stop(), loop).result(60)
loop.call_soon_threadsafe(loop.stop)
th.join(30)
# main's lazy imports, as far as argument validation
for argv in (["--engine-insecure", "--device", "cpu", "--admission",
              "--data-dir", tempfile.mkdtemp(), "--wal-fsync", "never"],
             ["--engine-insecure", "--device", "tpu"]):
    try:
        main(argv)
        raise AssertionError(argv)
    except SystemExit as ex:
        assert ex.code == 2, argv
# the proxy (rules, authz, dtx, obs) on the port's engine: one dual-write
# create and one prefiltered list through proxy/inmemory.py
import json
from spicedb_kubeapi_proxy_tpu_torch.proxy.options import Options
from spicedb_kubeapi_proxy_tpu_torch.proxy.inmemkube import InMemoryKube
from spicedb_kubeapi_proxy_tpu_torch.proxy.inmemory import InMemoryClient
cfg = Options(rule_content=open("deploy/rules.yaml").read(), device="cpu",
              upstream=InMemoryKube(), audit_log="stderr",
              workflow_database_path=tempfile.mkdtemp() + "/dtx.sqlite"
              ).complete()
async def serve():
    await cfg.workflow.resume_pending()
    a = InMemoryClient(cfg.server.handle, user="alice")
    r = await a.post("/api/v1/namespaces", {"metadata": {"name": "g"}})
    assert r.status == 201, r.body
    r = await a.get("/api/v1/namespaces")
    assert [i["metadata"]["name"] for i in json.loads(r.body)["items"]] \
        == ["g"], r.body
    await cfg.workflow.shutdown()
asyncio.run(serve())
cfg.deps.audit.close()
cfg.engine.close_compaction()
# scale-out: a planner over two in-process engines and one engine host,
# the split journal, a grow through the mover (the host's slice ops), the
# frontier exchange and an autoscale tick
from spicedb_kubeapi_proxy_tpu_torch.autoscale import (
    AutoscaleController, AutoscalePolicy, parse_policy)
from spicedb_kubeapi_proxy_tpu_torch.scaleout import (
    FrontierConfig, ShardedEngine, ShardMap, SplitJournal)
loop = asyncio.new_event_loop()
th = threading.Thread(target=loop.run_forever, daemon=True)
th.start()
hosted = Engine(device="cpu")
srv = EngineServer(hosted)
asyncio.run_coroutine_threadsafe(srv.start(), loop).result(30)
host = RemoteEngine("127.0.0.1", srv.port)
m1 = ShardMap(version=1, groups=((("h", 1),), (("h", 2),)))
sp = ShardedEngine(m1, [Engine(device="cpu"), Engine(device="cpu")],
                   journal=SplitJournal(tempfile.mkdtemp() + "/sj.sqlite"),
                   frontier=FrontierConfig())
sp.write_relationships([WriteOp("touch", parse_relationship(r)) for r in (
    "namespace:a#viewer@user:u", "pod:a/p#creator@user:u",
    "pod:b/p#viewer@user:u")])
m2 = ShardMap(version=2, groups=m1.groups + ((("127.0.0.1", srv.port),),))
coord = sp.begin_rebalance(m2, new_clients={2: host})
assert coord.wait(60) and coord.error is None, coord.error
assert sorted(sp.lookup_resources("pod", "view", "user", "u")) == \
    ["a/p", "b/p"]
assert host.frontier_pairs() == ()
assert sp.frontier_closure("user", "u") == set()
ctl = AutoscaleController(sp, AutoscalePolicy(parse_policy(
    "max_groups=2,hysteresis_ticks=1,cooldown_seconds=0")), mode="dry-run")
assert ctl.tick(now=0.0).action == "shrink"
sp.close()
asyncio.run_coroutine_threadsafe(srv.stop(), loop).result(60)
loop.call_soon_threadsafe(loop.stop)
th.join(30)
# replication and OIDC: a sync-replicated write through a mirror stream
# to a follower, the failover helpers, the sanitizer, the build hook, a
# bearer token through the OIDC authenticator and the demo's build
from spicedb_kubeapi_proxy_tpu_torch.obs import profile
from spicedb_kubeapi_proxy_tpu_torch.parallel import (
    FailoverCoordinator, MirroredEngine, choose_candidate, follower_loop,
    parse_peers)
from spicedb_kubeapi_proxy_tpu_torch.proxy import demo, jose, oidc
from spicedb_kubeapi_proxy_tpu_torch.utils import sanitizer
assert profile.install_kernel_build_hook()
assert parse_peers("a:1,b:2") == [("a", 1), ("b", 2)]
assert choose_candidate({0: {"term": 1}, 1: {"term": 2}}) == 1
lead = MirroredEngine(Engine(device="cpu"), term=1, mirror_queries=False,
                      sync_replication=True, replication_timeout=30.0)
fol = Engine(device="cpu")
loop = asyncio.new_event_loop()
th = threading.Thread(target=loop.run_forever, daemon=True)
th.start()
srv = EngineServer(lead)
asyncio.run_coroutine_threadsafe(srv.start(), loop).result(30)
ft = threading.Thread(target=follower_loop, args=(fol, "127.0.0.1",
                      srv.port), kwargs=dict(current_term=1, ack=True),
                      daemon=True)
ft.start()
import time
deadline = time.monotonic() + 30
while not lead._subs and time.monotonic() < deadline:
    time.sleep(0.02)
lead.write_relationships([WriteOp("touch", parse_relationship(
    "pod:m#viewer@user:u"))])
assert fol.revision == lead.revision  # the ack waited for the follower
asyncio.run_coroutine_threadsafe(srv.stop(), loop).result(60)
ft.join(30)
loop.call_soon_threadsafe(loop.stop)
th.join(30)
a = oidc.OIDCAuthenticator(issuer_url="https://i", client_id="c",
                           jwks_uri="j", fetch=lambda u: b'{"keys": []}')
assert a.authenticate_token("x.y.z") is None
assert jose.b64url_encode(b"ok") == "b2s"
assert sanitizer.enforced_violations() == []
cfg = demo.build(port=0, device="cpu")
cfg.engine.close_compaction()
from spicedb_kubeapi_proxy_tpu_torch.loadgen import (
    run_sweep, trace_shaped_config)
from spicedb_kubeapi_proxy_tpu_torch.loadgen.schedule import DEFAULT_MIX
sw = run_sweep(lambda m: trace_shaped_config(0.3, 40.0 * m, seed=1),
               {op: (lambda a: None) for op in DEFAULT_MIX}, (1.0,),
               {op: 5.0 for op in DEFAULT_MIX}, max_workers=4)
assert sw.points[0].fired_n > 0 and sw.knee_rps
from spicedb_kubeapi_proxy_tpu_torch.chaos import brownout_schedule
from spicedb_kubeapi_proxy_tpu_torch.chaos.campaign import (
    Campaign, CampaignConfig)
from spicedb_kubeapi_proxy_tpu_torch.engine.remote import RemoteEngine
chaos_srv = EngineServer(Engine(device="cpu"), allow_chaos=True)
loop = asyncio.new_event_loop()
th = threading.Thread(target=loop.run_forever, daemon=True)
th.start()
asyncio.run_coroutine_threadsafe(chaos_srv.start(), loop).result(30)
rc = RemoteEngine("127.0.0.1", chaos_srv.port, retries=0)
sched = brownout_schedule(0)
assert rc.chaos_arm(sched.encode())["digest"] == sched.digest()
rc.chaos_reset()
rc.close()
asyncio.run_coroutine_threadsafe(chaos_srv.stop(), loop).result(60)
loop.call_soon_threadsafe(loop.stop)
th.join(30)
res = Campaign(CampaignConfig(seeds=(0,), inproc=True, device="cpu")).run()
assert res["ok"] and len(res["episodes"]) == 4, res["violations"]
bad = [m for m in sys.modules if m.split(".")[0] in
       ("jax", "jaxlib", "spicedb_kubeapi_proxy_tpu")]
assert not bad, bad
print("ok")
"""


def _port_imports():
    """(file, module) for every import statement in the port's sources."""
    import ast

    root = os.path.join(REPO, "spicedb_kubeapi_proxy_tpu_torch")
    for d, _, files in os.walk(root):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(d, f)
            with open(path) as fh:
                tree = ast.parse(fh.read(), path)
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    for a in node.names:
                        yield path, a.name
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    yield path, node.module or ""


def test_port_never_imports_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", GUARD], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
    # and no source of the port names them, nor torch.distributed (torch
    # imports that itself, so the module check above cannot see it): the
    # mirror and failover run over the engine protocol alone
    bad = [(p, m) for p, m in _port_imports()
           if m.split(".")[0] in ("jax", "jaxlib",
                                  "spicedb_kubeapi_proxy_tpu")
           or m == "torch.distributed" or m.startswith("torch.distributed.")]
    assert not bad, bad
