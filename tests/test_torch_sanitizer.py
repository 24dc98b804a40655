"""PyTorch port, the runtime concurrency sanitizer (utils/sanitizer.py).

Every case of test_sanitizer.py runs here on the port's copy
(``port_cases``), whose scope is the port's own package directory: a
lock created from the port's code is instrumented, one created from the
JAX package's is not, and the reverse for the JAX sanitizer. Then the
port under the sanitizer: a fresh interpreter installs it BEFORE it
imports the port, drives threaded lists, bulk checks and writes, a
compactor fold, the decision cache and a mirrored sync-replicated write
over a live follower stream on the CPU, and must record no lock-order
cycle and no loop-blocking call (the enforced kinds) in the port's
code. The port's locks that the reference does not have (the resident
state's reader/writer lock, ``Engine._echo_lock``, the mirror's locks)
are in that graph.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading

from spicedb_kubeapi_proxy_tpu.utils import sanitizer as jsanitizer
from spicedb_kubeapi_proxy_tpu_torch.utils import sanitizer

from torch_parity import port_cases

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CASES = port_cases("test_sanitizer.py")
globals().update(_CASES)
_G = next(iter(_CASES.values())).__globals__
fresh_state = _G["fresh_state"]
reinstall_guard = _G["reinstall_guard"]


def test_every_jax_case_runs_on_the_port():
    assert len(_CASES) == 13
    assert _G["sanitizer"] is sanitizer


def test_each_sanitizer_scopes_to_its_own_package(fresh_state,
                                                  reinstall_guard):
    from spicedb_kubeapi_proxy_tpu.utils.metrics import Registry as JReg
    from spicedb_kubeapi_proxy_tpu_torch.utils.metrics import Registry

    assert sanitizer._PKG_MARKER != jsanitizer._PKG_MARKER
    sanitizer.install()
    try:
        assert isinstance(Registry()._lock, sanitizer.SanitizedLock)
        assert not isinstance(JReg()._lock, sanitizer.SanitizedLock)
    finally:
        sanitizer.uninstall()
    was = jsanitizer.installed()
    jsanitizer.install()
    try:
        assert not isinstance(Registry()._lock, jsanitizer.SanitizedLock)
        assert isinstance(JReg()._lock, jsanitizer.SanitizedLock)
    finally:
        if not was:
            jsanitizer.uninstall()


_WORKLOAD = r"""
import json, os, sys, threading, time
sys.path.insert(0, sys.argv[1])
from spicedb_kubeapi_proxy_tpu_torch.utils import sanitizer
sanitizer.install()

import asyncio
from spicedb_kubeapi_proxy_tpu_torch.engine import (
    CheckItem, Engine, RelationshipFilter, WriteOp)
from spicedb_kubeapi_proxy_tpu_torch.engine.remote import EngineServer
from spicedb_kubeapi_proxy_tpu_torch.models.tuples import parse_relationship
from spicedb_kubeapi_proxy_tpu_torch.ops import reachability
from spicedb_kubeapi_proxy_tpu_torch.parallel.multihost import (
    MirroredEngine, follower_loop)

reachability.DENSE_MIN_EDGES = 4
SCHEMA = '''schema: |-
  definition user {}
  definition group {
    relation member: user | group#member
  }
  definition namespace {
    relation viewer: user | group#member
    permission view = viewer
  }
  definition pod {
    relation namespace: namespace
    relation viewer: user
    permission view = viewer + namespace->view
  }
relationships: ""
'''

def rel(s):
    return parse_relationship(s)

seed = []
for g in range(4):
    seed.append(f"group:g{g}#member@user:u{g}")
    seed.append(f"group:g{g}#member@group:g{(g + 1) % 4}#member")
for n in range(4):
    seed.append(f"namespace:ns{n}#viewer@group:g{n}#member")
for p in range(24):
    seed.append(f"pod:ns{p % 4}/p{p}#namespace@namespace:ns{p % 4}")
    seed.append(f"pod:ns{p % 4}/p{p}#viewer@user:u{p % 7}")

leader_engine = Engine(SCHEMA, device="cpu")
leader_engine.write_relationships([WriteOp("touch", rel(s)) for s in seed])
leader_engine.enable_decision_cache(max_entries=256)
leader_engine.enable_lookup_batching(window=0.002, max_rows=4)
leader_engine.enable_compaction(0.5)
follower = Engine(SCHEMA, device="cpu")
follower.write_relationships([WriteOp("touch", rel(s)) for s in seed])
leader = MirroredEngine(leader_engine, term=1, mirror_queries=False,
                        sync_replication=True, replication_timeout=30.0)

loop = asyncio.new_event_loop()
lt = threading.Thread(target=loop.run_forever, daemon=True)
lt.start()
server = EngineServer(leader, token="t")
port = asyncio.run_coroutine_threadsafe(server.start(), loop).result(30)
ft = threading.Thread(target=follower_loop, daemon=True, args=(
    follower, "127.0.0.1", port, "t", None, None, follower.revision),
    kwargs=dict(current_term=1, ack=True))
ft.start()
deadline = time.monotonic() + 30
while not leader._subs and time.monotonic() < deadline:
    time.sleep(0.02)
assert leader._subs, "the follower never subscribed"

errors = []

def lister(i):
    try:
        for k in range(6):
            leader.lookup_resources_mask("pod", "view", "user", f"u{(i + k) % 7}")
    except Exception as e:
        errors.append(repr(e))

def checker(i):
    try:
        items = [CheckItem("pod", f"ns{p % 4}/p{p}", "view", "user", f"u{i}")
                 for p in range(24)]
        for _ in range(3):
            leader.check_bulk(items)
    except Exception as e:
        errors.append(repr(e))

def writer(i):
    try:
        for k in range(6):
            leader.write_relationships([WriteOp("touch", rel(
                f"pod:ns{k % 4}/w{i}-{k}#viewer@user:u{i}"))])
        leader.delete_relationships(RelationshipFilter(
            resource_type="pod", resource_id=f"ns0/w{i}-0"))
    except Exception as e:
        errors.append(repr(e))

ts = [threading.Thread(target=f, args=(i,)) for i in range(3)
      for f in (lister, checker, writer)]
for t in ts: t.start()
for t in ts: t.join(120)
leader_engine.compactor.compact()
leader.write_relationships([WriteOp("touch", rel("pod:ns1/last#viewer@user:u1"))])
deadline = time.monotonic() + 30
while follower.revision != leader_engine.revision and time.monotonic() < deadline:
    time.sleep(0.02)
same = follower.revision == leader_engine.revision
asyncio.run_coroutine_threadsafe(server.stop(), loop).result(60)
ft.join(30)
loop.call_soon_threadsafe(loop.stop)
lt.join(30)
leader_engine.close_compaction()
print("RESULT " + json.dumps({
    "errors": errors, "same_revision": same,
    "enforced": [v.render() for v in sanitizer.enforced_violations()],
    "edges": sum(len(v) for v in sanitizer._state.edges.values()),
    "sites": sorted(sanitizer._state.edges)}))
"""


def test_port_workload_under_the_sanitizer_has_no_cycle(tmp_path):
    script = tmp_path / "workload.py"
    script.write_text(_WORKLOAD)
    env = dict(os.environ)
    env.pop("PROXY_SANITIZE", None)
    proc = subprocess.run([sys.executable, str(script), REPO],
                          capture_output=True, text=True, timeout=240,
                          env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("RESULT ")][-1]
    got = json.loads(line[len("RESULT "):])
    assert got["errors"] == []
    assert got["same_revision"]
    assert got["enforced"] == [], got["enforced"]
    # the graph really saw the port's own locks nest
    assert got["edges"] > 0
    assert any(s.startswith("engine" + os.sep + "engine.py")
               for s in got["sites"]), got["sites"]
    assert any(s.startswith("parallel" + os.sep + "multihost.py")
               for s in got["sites"]), got["sites"]
