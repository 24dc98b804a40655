"""PyTorch port, live schema migration (migration/, the engine's migrate
surface and the engine host's ``migrate_*`` ops), held against the JAX
package.

(a) Every test of test_migration.py on the port's engine (``device="cpu"``):
diff classification, the digest's order independence, additive and
rewriting migrations end to end with the watch stream held exactly once,
the typed refusals, the single active migration and the coordinated cut,
abort, decision-cache survivors, the boot crash matrix, the wire ops on
loopback and the SIGKILL-mid-backfill acceptance run against the port's
engine-host CLI. (b) Across packages: ``diff_schemas`` / ``ir_digest`` on
a set of schema pairs, the same store and target migrated on both engines
(status, watch streams, masks and verdicts, and a fresh engine compiled
under S'), records written by either package resolved by the other, the
unchanged JAX proxy and the JAX client driving a port host. (c) The
port's own hazards: a cache fill and a compaction fold held across the
cut, the device, overlay and tier budget of the new graph, the old base's
device state freed when its last view drops, the write gate across a
write's device half, lookups in flight with batching on, and no backfill
echo on a push stream.
"""

from __future__ import annotations

import asyncio
import dataclasses
import gc
import json
import os
import shutil
import subprocess
import sys
import threading
import time
import weakref

import numpy as np
import pytest

from spicedb_kubeapi_proxy_tpu.engine import CheckItem as JCheckItem
from spicedb_kubeapi_proxy_tpu.engine import Engine as JEngine
from spicedb_kubeapi_proxy_tpu.engine import WriteOp as JWriteOp
from spicedb_kubeapi_proxy_tpu.engine import remote as jremote
from spicedb_kubeapi_proxy_tpu.engine.engine import \
    SchemaViolation as JSchemaViolation
from spicedb_kubeapi_proxy_tpu.migration import recover as jrecover
from spicedb_kubeapi_proxy_tpu.models import parse_schema as jparse_schema
from spicedb_kubeapi_proxy_tpu.models import schema as jschema
from spicedb_kubeapi_proxy_tpu.models.tuples import \
    Relationship as JRelationship
from spicedb_kubeapi_proxy_tpu.ops import reachability as JR
from spicedb_kubeapi_proxy_tpu_torch.engine import CheckItem, Engine
from spicedb_kubeapi_proxy_tpu_torch.engine import remote
from spicedb_kubeapi_proxy_tpu_torch.engine.engine import (
    EngineFuture,
    SchemaViolation,
)
from spicedb_kubeapi_proxy_tpu_torch.engine.store import (
    RelationshipFilter,
    StoreError,
    WriteOp,
)
from spicedb_kubeapi_proxy_tpu_torch.migration import recover, schema_digest
from spicedb_kubeapi_proxy_tpu_torch.models import parse_schema
from spicedb_kubeapi_proxy_tpu_torch.models.schema import (
    ADDITIVE,
    INCOMPATIBLE,
    REWRITING,
    IncompatibleSchemaChange,
    diff_schemas,
    ir_digest,
    require_compatible,
)
from spicedb_kubeapi_proxy_tpu_torch.models.tuples import Relationship
from spicedb_kubeapi_proxy_tpu_torch.ops import reachability as R
from torch_parity import serving

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# test_migration.py's schemas
BASE = """
definition user {}
definition group {
  relation member: user
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
"""

# additive: pod grows an auditor relation + audit permission
ADDITIVE_TARGET = BASE.replace(
    "  relation viewer: user\n",
    "  relation viewer: user\n  relation auditor: user\n").replace(
    "  permission view = viewer + namespace->view\n",
    "  permission view = viewer + namespace->view\n"
    "  permission audit = auditor\n")

# rewriting: a caveat attached to the live pod#viewer relation
REWRITING_TARGET = ADDITIVE_TARGET.replace(
    "definition user {}",
    "caveat probation(level int) {\n  level < 3\n}\n\n"
    "definition user {}").replace(
    "  relation viewer: user\n  relation auditor: user\n",
    "  relation viewer: user | user with probation\n"
    "  relation auditor: user\n")

# incompatible: pod#viewer dropped while tuples may reference it
INCOMPATIBLE_TARGET = BASE.replace(
    "  relation viewer: user\n  permission view = viewer +"
    " namespace->view\n",
    "  permission view = namespace->view\n")

# additive, and it moves verdicts: pod#view no longer follows the
# namespace (a permission expression change), so "owner" loses ns/p0
NARROWING_TARGET = BASE.replace(
    "  permission view = viewer + namespace->view\n",
    "  permission view = viewer\n")


def _engine(schema_text: str = BASE, **kw) -> Engine:
    return Engine(schema=parse_schema(schema_text), device="cpu", **kw)


def _seed_ops(n: int = 12) -> list:
    rows = [("pod", f"ns/p{i}", "viewer", "user", f"u{i}")
            for i in range(n)]
    rows += [("namespace", "ns0", "viewer", "user", "owner"),
             ("pod", "ns/p0", "namespace", "namespace", "ns0")]
    return rows


def _seed(e, n: int = 12) -> None:
    jax = isinstance(e, JEngine)
    op, rel = (JWriteOp, JRelationship) if jax else (WriteOp, Relationship)
    e.write_relationships([op("touch", rel(*r)) for r in _seed_ops(n)])


def _wait_phase(status, phase: str, budget: float = 30.0) -> dict:
    deadline = time.monotonic() + budget
    while True:
        st = status()
        if st is not None and st["phase"] == phase:
            return st
        assert time.monotonic() < deadline, st
        time.sleep(0.01)


# ---------------------------------------------------------------------------
# (a) test_migration.py on the port: diff classification
# ---------------------------------------------------------------------------


def test_diff_classifies_additive():
    d = diff_schemas(parse_schema(BASE), parse_schema(ADDITIVE_TARGET))
    assert d.classification == ADDITIVE
    assert not d.rewrite_relations
    assert not d.is_affected("namespace", "view")


def test_diff_classifies_rewriting_with_member_closure():
    d = diff_schemas(parse_schema(ADDITIVE_TARGET),
                     parse_schema(REWRITING_TARGET))
    assert d.classification == REWRITING
    assert ("pod", "viewer") in d.rewrite_relations
    assert d.is_affected("pod", "view")
    assert not d.is_affected("namespace", "view")
    assert not d.is_affected("group", "member")


def test_diff_incompatible_typed_refusal_names_the_member():
    with pytest.raises(IncompatibleSchemaChange) as ei:
        require_compatible(parse_schema(BASE),
                           parse_schema(INCOMPATIBLE_TARGET))
    msg = str(ei.value)
    assert "pod" in msg and "viewer" in msg
    assert ei.value.reasons


def test_ir_digest_order_independent():
    blocks = [b for b in BASE.split("definition") if b.strip()]
    reordered = "definition" + "definition".join(reversed(blocks))
    assert ir_digest(parse_schema(BASE)) == ir_digest(
        parse_schema(reordered))
    assert ir_digest(parse_schema(BASE)) != ir_digest(
        parse_schema(ADDITIVE_TARGET))


# ---------------------------------------------------------------------------
# (a) engine-level migrations
# ---------------------------------------------------------------------------


def test_additive_migration_end_to_end():
    e = _engine()
    _seed(e)
    item = CheckItem("pod", "ns/p3", "view", "user", "u3")
    assert e.check(item)
    st = e.begin_schema_migration(ADDITIVE_TARGET, wait=True)
    assert st["phase"] == "done"
    assert st["classification"] == "additive"
    assert st["backfilled"] == 0
    assert st["time_to_cut_ms"] is not None
    assert e.check(item)
    e.write_relationships([WriteOp("touch", Relationship(
        "pod", "ns/p3", "auditor", "user", "aud"))])
    assert e.check(CheckItem("pod", "ns/p3", "audit", "user", "aud"))


def test_rewriting_migration_backfills_and_keeps_watch_exactly_once():
    e = _engine(ADDITIVE_TARGET)
    _seed(e, n=9)
    before = e.watch_since(0)
    rev0 = e.revision
    item = CheckItem("pod", "ns/p1", "view", "user", "u1")
    ns_item = CheckItem("namespace", "ns0", "view", "user", "owner")
    assert e.check(item) and e.check(ns_item)
    st = e.begin_schema_migration(REWRITING_TARGET, wait=True, batch=4)
    assert st["phase"] == "done", st
    assert st["classification"] == "rewriting"
    assert st["backfilled"] == 9
    assert st["suppressed"] >= 3
    after = e.watch_since(0)
    assert [(ev.revision, ev.relationship) for ev in after] == \
        [(ev.revision, ev.relationship) for ev in before]
    assert all(ev.revision <= rev0 for ev in after)
    assert e.check(item) and e.check(ns_item)
    e.write_relationships([WriteOp("touch", Relationship(
        "pod", "ns/p1", "viewer", "user", "probie",
        caveat="probation", caveat_context='{"level": 1}'))])
    assert e.check(CheckItem("pod", "ns/p1", "view", "user", "probie"))


def test_incompatible_refused_before_any_state_change():
    e = _engine()
    _seed(e)
    rev0 = e.revision
    schema0 = e.schema
    with pytest.raises(IncompatibleSchemaChange):
        e.begin_schema_migration(INCOMPATIBLE_TARGET)
    assert e.revision == rev0
    assert e.schema is schema0
    st = e.begin_schema_migration(ADDITIVE_TARGET, wait=True)
    assert st["phase"] == "done"


def test_rewriting_refused_when_stored_tuple_invalid_under_target():
    e = _engine(ADDITIVE_TARGET)
    _seed(e, n=3)
    required = ADDITIVE_TARGET.replace(
        "definition user {}",
        "caveat probation(level int) {\n  level < 3\n}\n\n"
        "definition user {}").replace(
        "  relation viewer: user\n  relation auditor: user\n",
        "  relation viewer: user with probation\n"
        "  relation auditor: user\n")
    rev0 = e.revision
    with pytest.raises(IncompatibleSchemaChange, match="does not validate"):
        e.begin_schema_migration(required)
    assert e.revision == rev0


def test_single_active_migration_and_coordinated_cut():
    e = _engine()
    _seed(e)
    e.begin_schema_migration(ADDITIVE_TARGET, hold_at_dual=True)
    _wait_phase(e.migration_status, "dual")
    with pytest.raises(StoreError, match="already running"):
        e.begin_schema_migration(REWRITING_TARGET)
    st = e.cut_schema_migration(wait=True)
    assert st["phase"] == "done"
    assert e.cut_schema_migration(wait=True)["phase"] == "done"


def test_abort_before_cut_restores_nothing_because_nothing_changed():
    e = _engine()
    _seed(e)
    schema0 = e.schema
    e.begin_schema_migration(ADDITIVE_TARGET, hold_at_dual=True)
    _wait_phase(e.migration_status, "dual")
    st = e.abort_schema_migration()
    assert st["phase"] == "aborted"
    assert e.schema is schema0
    assert e._write_gate is None
    e.begin_schema_migration(ADDITIVE_TARGET, wait=True)
    with pytest.raises(StoreError, match="cannot abort"):
        e.abort_schema_migration()


def _cached_pairs(e) -> set:
    pairs = set()
    for sh in e._decision_cache._shards:
        with sh.lock:
            for k in sh.entries:
                pairs.add((k[0], k[2], k[4] if k[0] == "check" else k[3]))
    return pairs


def test_decision_cache_unaffected_keys_survive_the_cut():
    e = _engine(ADDITIVE_TARGET)
    e.enable_decision_cache()
    _seed(e, n=6)
    e.check(CheckItem("namespace", "ns0", "view", "user", "owner"))
    e.check(CheckItem("pod", "ns/p2", "view", "user", "u2"))
    e.lookup_resources_mask("namespace", "view", "user", "owner")
    e.lookup_resources_mask("pod", "view", "user", "u2")
    assert {("check", "namespace", "view"), ("check", "pod", "view"),
            ("lookup", "namespace", "view"),
            ("lookup", "pod", "view")} <= _cached_pairs(e)
    st = e.begin_schema_migration(REWRITING_TARGET, wait=True)
    assert st["phase"] == "done"
    survivors = _cached_pairs(e)
    assert ("check", "namespace", "view") in survivors
    assert ("lookup", "namespace", "view") in survivors
    assert ("check", "pod", "view") not in survivors
    assert ("lookup", "pod", "view") not in survivors


# ---------------------------------------------------------------------------
# (a) boot crash matrix (record files)
# ---------------------------------------------------------------------------


def _record(path, phase, to_text, suppressed=()):
    doc = {"phase": phase, "to_text": to_text,
           "to_digest": schema_digest(to_text),
           "suppressed_revisions": list(suppressed),
           "started": time.time(), "updated": time.time()}
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f)
    return str(path)


@pytest.mark.parametrize("phase", ["planned", "compiling", "backfill",
                                   "dual"])
def test_recover_aborts_pre_cut_phases(tmp_path, phase):
    e = _engine()
    schema0 = e.schema
    path = _record(tmp_path / "migration.json", phase, ADDITIVE_TARGET,
                   suppressed=(7, 9))
    out = recover(e, path)
    assert out["action"] == "aborted" and out["phase"] == phase
    assert not os.path.exists(path)
    assert e.schema is schema0
    assert {7, 9} <= set(e._watch_suppress)


def test_recover_resumes_persisted_cut(tmp_path):
    e = _engine()
    _seed(e, n=3)
    assert e.check(CheckItem("pod", "ns/p1", "view", "user", "u1"))
    path = _record(tmp_path / "migration.json", "cut", ADDITIVE_TARGET)
    out = recover(e, path)
    assert out["action"] == "resumed" and out["phase"] == "cut"
    assert ir_digest(e.schema) == ir_digest(parse_schema(ADDITIVE_TARGET))
    # the next read compiles under S'
    assert e.compiled().schema is e.schema
    assert e.check(CheckItem("pod", "ns/p1", "view", "user", "u1"))
    with open(path, encoding="utf-8") as f:
        assert json.load(f)["phase"] == "done"
    out2 = recover(e, path)
    assert out2["action"] == "cleared"
    assert not os.path.exists(path)


def test_recover_done_marker_reapplies_until_bootstrap_catches_up(
        tmp_path):
    e = _engine()
    path = _record(tmp_path / "migration.json", "done", ADDITIVE_TARGET)
    out = recover(e, path)
    assert out["action"] == "resumed"
    assert ir_digest(e.schema) == ir_digest(parse_schema(ADDITIVE_TARGET))
    assert os.path.exists(path)


def test_recover_unreadable_record_fails_toward_booted_schema(tmp_path):
    e = _engine()
    schema0 = e.schema
    path = str(tmp_path / "migration.json")
    with open(path, "w") as f:
        f.write("{not json")
    out = recover(e, path)
    assert out["action"] == "aborted"
    assert e.schema is schema0
    assert os.path.exists(path + ".corrupt")


def test_recover_nothing_to_do():
    e = _engine()
    assert recover(e, None) is None
    assert recover(e, "/nonexistent/migration.json") is None
    assert e.recover_schema_migration() is None  # not durable: no record


# ---------------------------------------------------------------------------
# (a) wire surface + acceptance
# ---------------------------------------------------------------------------


def test_wire_migrate_ops_loopback():
    e = _engine()
    _seed(e)
    with serving(remote.EngineServer, e) as s:
        client = remote.RemoteEngine("127.0.0.1", s.port)
        try:
            with pytest.raises(SchemaViolation, match="incompatible"):
                client.migrate_begin(INCOMPATIBLE_TARGET)
            assert client.migrate_status() is None  # nothing began
            st = client.migrate_begin(ADDITIVE_TARGET, hold_at_dual=True)
            assert st["phase"] in ("planned", "compiling", "backfill",
                                   "dual")
            _wait_phase(client.migrate_status, "dual")
            st = client.migrate_cut(wait=True)
            assert st["phase"] == "done"
            assert client.migrate_status()["phase"] == "done"
            with pytest.raises(StoreError, match="cannot abort"):
                client.migrate_abort()
        finally:
            client.close()


_BOOT_YAML = """\
schema: |-
%s
relationships: ""
"""


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _boot_host(tmp_path, port, extra=()):
    boot = tmp_path / "bootstrap.yaml"
    boot.write_text(_BOOT_YAML % "\n".join(
        "  " + ln for ln in BASE.strip().splitlines()))
    data = tmp_path / "data"
    data.mkdir(exist_ok=True)
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "FAILPOINTS")}
    return subprocess.Popen(
        [sys.executable, "-m", "spicedb_kubeapi_proxy_tpu_torch.engine.remote",
         "--device", "cpu", "--bootstrap", str(boot),
         "--bind-port", str(port), "--engine-insecure",
         "--data-dir", str(data), "--wal-fsync", "always", *extra],
        cwd=REPO, env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.STDOUT)


def _wait_up(client, budget=90.0):
    deadline = time.monotonic() + budget
    last = None
    while time.monotonic() < deadline:
        try:
            _ = client.revision
            return
        except Exception as err:  # noqa: BLE001 - boot poll
            last = err
            time.sleep(0.2)
    raise RuntimeError(f"host never came up: {last}")


def _target_with_workflow_defs() -> str:
    # parse_bootstrap appends the workflow definitions to every booted
    # schema, so the migration target must carry them too
    from spicedb_kubeapi_proxy_tpu_torch.models.bootstrap import \
        WORKFLOW_DEFS

    return "\n".join([REWRITING_TARGET.replace(
        "  relation auditor: user\n", "").replace(
        "  permission audit = auditor\n", "")]
        + list(WORKFLOW_DEFS.values()))


def test_acceptance_sigkill_mid_backfill_under_load(tmp_path):
    """test_migration.py's acceptance run against the port's CLI: a
    rewriting migration under check/write load, SIGKILL mid-backfill,
    restart (the boot crash matrix aborts the torn attempt), re-begin
    completes. Zero acked writes lost; the unaffected namespace#view
    verdict never flaps."""
    port = _free_port()
    proc = _boot_host(tmp_path, port)
    client = remote.RemoteEngine("127.0.0.1", port, timeout=15.0)
    target = _target_with_workflow_defs()
    acked: list[int] = []
    flaps: list[tuple] = []
    stop = threading.Event()
    try:
        _wait_up(client)
        client.write_relationships(
            [WriteOp("touch", Relationship(
                "pod", f"ns/p{i}", "viewer", "user", f"u{i}"))
             for i in range(60)]
            + [WriteOp("touch", Relationship(
                "namespace", "ns0", "viewer", "user", "owner"))])
        probe = CheckItem("namespace", "ns0", "view", "user", "owner")
        want = client.check(probe)
        assert want is True

        def load():
            i = 1000
            while not stop.is_set():
                try:
                    client.write_relationships([WriteOp(
                        "touch", Relationship("pod", f"ns/p{i}", "viewer",
                                              "user", f"u{i}"))])
                    acked.append(i)
                    if client.check(probe) != want:
                        flaps.append(("during", i))
                except Exception:  # noqa: BLE001 - the kill window
                    pass
                i += 1
                time.sleep(0.01)

        lt = threading.Thread(target=load, daemon=True)
        lt.start()
        client.migrate_begin(target, batch=4, backfill_pause=0.2)
        deadline = time.monotonic() + 60
        while True:
            st = client.migrate_status()
            if st and st["phase"] == "backfill" and st["backfilled"] > 0:
                break
            assert time.monotonic() < deadline, st
            time.sleep(0.02)
        proc.kill()
        proc.wait(timeout=15)
        stop.set()
        lt.join(10)

        proc = _boot_host(tmp_path, port)
        _wait_up(client)
        st = client.migrate_status()
        assert st is None or st["phase"] in ("aborted", "done")
        assert client.check(probe) == want
        present = {r.resource_id for r in client.read_relationships(
            RelationshipFilter(resource_type="pod", relation="viewer"))}
        missing = [i for i in acked if f"ns/p{i}" not in present]
        assert not missing, f"acked writes lost: {missing[:10]}"

        st = client.migrate_begin(target, wait=True)
        assert st["phase"] == "done", st
        assert st["backfilled"] >= 60
        assert client.check(probe) == want
        assert not flaps
        client.write_relationships([WriteOp("touch", Relationship(
            "pod", "ns/p0", "viewer", "user", "probie",
            caveat="probation", caveat_context='{"level": 1}'))])
        assert client.check(CheckItem("pod", "ns/p0", "view", "user",
                                      "probie"))
    finally:
        stop.set()
        client.close()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=15)


# ---------------------------------------------------------------------------
# (b) across packages: the diff classifier
# ---------------------------------------------------------------------------

CAVEATED = """
caveat window(level int, limit int) {
  level < limit
}
definition user {}
definition namespace {
  relation viewer: user | user with window
  permission view = viewer
}
definition pod {
  relation namespace: namespace
  relation viewer: user
  relation banned: user
  permission view = (viewer + namespace->view) - banned
}
"""

DIFF_PAIRS = {
    "additive": (BASE, ADDITIVE_TARGET),
    "rewriting": (ADDITIVE_TARGET, REWRITING_TARGET),
    "rewriting-from-base": (BASE, REWRITING_TARGET),
    "incompatible": (BASE, INCOMPATIBLE_TARGET),
    "permission-expression": (BASE, NARROWING_TARGET),
    "caveat-body-changed": (CAVEATED, CAVEATED.replace(
        "level < limit", "level <= limit")),
    "caveat-removed-in-use": (CAVEATED, CAVEATED.replace(
        "caveat window(level int, limit int) {\n  level < limit\n}\n",
        "").replace(" | user with window", "")),
    "caveat-removed-unused": (CAVEATED.replace(
        " | user with window", ""), CAVEATED.replace(
        "caveat window(level int, limit int) {\n  level < limit\n}\n",
        "").replace(" | user with window", "")),
    "kind-flip": (CAVEATED, CAVEATED.replace(
        "  relation banned: user\n", "  permission banned = viewer\n")),
    "definition-removed": (CAVEATED, CAVEATED.replace(
        "definition pod {", "definition pod_gone {")),
    "subject-type-gained": (CAVEATED, CAVEATED.replace(
        "  relation banned: user\n",
        "  relation banned: user | namespace#viewer\n")),
}


@pytest.mark.parametrize("name", sorted(DIFF_PAIRS))
def test_diff_and_digest_agree_with_jax(name):
    old, new = DIFF_PAIRS[name]
    got = diff_schemas(parse_schema(old), parse_schema(new))
    want = jschema.diff_schemas(jparse_schema(old), jparse_schema(new))
    for f in ("classification", "changed", "affected",
              "rewrite_relations", "reasons"):
        assert getattr(got, f) == getattr(want, f), f
    for text in (old, new):
        assert ir_digest(parse_schema(text)) == jschema.ir_digest(
            jparse_schema(text))
    if got.classification == INCOMPATIBLE:
        with pytest.raises(IncompatibleSchemaChange) as a:
            require_compatible(parse_schema(old), parse_schema(new))
        with pytest.raises(jschema.IncompatibleSchemaChange) as b:
            jschema.require_compatible(jparse_schema(old),
                                       jparse_schema(new))
        assert str(a.value) == str(b.value)


# ---------------------------------------------------------------------------
# (b) the same migration on both engines
# ---------------------------------------------------------------------------


@pytest.fixture
def small_blocks(monkeypatch):
    """Blocks from 4 edges up on both sides, so the small graph forms
    dense blocks and bit duals; the JAX kernels in interpreter mode."""
    monkeypatch.setenv("SDBKP_BITPROP", "interpret")
    monkeypatch.setenv("SDBKP_SEMIRING", "interpret")
    monkeypatch.setattr(JR, "DENSE_MIN_EDGES", 4)
    monkeypatch.setattr(R, "DENSE_MIN_EDGES", 4)


def _parity_rows(n_pods: int = 24) -> list:
    rng = np.random.default_rng(7)
    rows = set()
    for p in range(n_pods):
        rows.add(("pod", f"ns/p{p}", "viewer", "user",
                  f"u{rng.integers(9)}"))
        rows.add(("pod", f"ns/p{p}", "namespace", "namespace",
                  f"ns{rng.integers(3)}"))
    for n in range(3):
        rows.add(("namespace", f"ns{n}", "viewer", "group", f"g{n}",
                  "member"))
        rows.add(("namespace", f"ns{n}", "viewer", "user", f"u{n + 5}"))
    for g in range(3):
        for _ in range(3):
            rows.add(("group", f"g{g}", "member", "user",
                      f"u{rng.integers(9)}"))
    return sorted(rows)


USERS = [f"u{i}" for i in range(9)] + ["nobody"]


def _answers(e, jax: bool, perms=(("pod", "view"), ("namespace", "view")),
             context=None):
    """Sorted ids a (type, permission, user), and verdicts for every
    (pod, user) pair, from either package's engine."""
    item = JCheckItem if jax else CheckItem
    out = {}
    for rt, perm in perms:
        for u in USERS:
            out[(rt, perm, u)] = sorted(e.lookup_resources(
                rt, perm, "user", u, context=context))
    items = [item("pod", f"ns/p{p}", "view", "user", u)
             for p in range(24) for u in USERS]
    out["checks"] = [bool(x) for x in e.check_bulk(items, context=context)]
    return out


def _events(evs) -> list:
    return [(ev.revision, ev.operation,
             dataclasses.astuple(ev.relationship)) for ev in evs]


STATUS_FIELDS = ("phase", "classification", "to_digest", "from_digest",
                 "reasons", "affected", "backfilled", "suppressed", "lag",
                 "error")


@pytest.mark.parametrize("source,target", [
    (BASE, ADDITIVE_TARGET), (ADDITIVE_TARGET, REWRITING_TARGET),
    (BASE, NARROWING_TARGET)], ids=["additive", "rewriting", "narrowing"])
def test_migration_matches_jax_and_a_fresh_compile(small_blocks, source,
                                                   target):
    rows = _parity_rows()
    e = _engine(source)
    je = JEngine(schema=jparse_schema(source))
    e.write_relationships([WriteOp("touch", Relationship(*r))
                           for r in rows])
    je.write_relationships([JWriteOp("touch", JRelationship(*r))
                            for r in rows])
    assert _answers(e, False) == _answers(je, True)
    st = e.begin_schema_migration(target, wait=True, batch=5)
    jst = je.begin_schema_migration(target, wait=True, batch=5)
    assert {k: st[k] for k in STATUS_FIELDS} == \
        {k: jst[k] for k in STATUS_FIELDS}
    assert st["phase"] == "done"
    assert e.revision == je.revision
    assert _events(e.watch_since(0)) == _events(je.watch_since(0))
    fresh = _engine(target)
    fresh.write_relationships([WriteOp("touch", Relationship(*r))
                               for r in rows])
    got = _answers(e, False)
    assert got == _answers(je, True)
    assert got == _answers(fresh, False)
    for u in USERS:
        m, _ = e.lookup_resources_mask("pod", "view", "user", u)
        jm, _ = je.lookup_resources_mask("pod", "view", "user", u)
        np.testing.assert_array_equal(m, np.asarray(jm), err_msg=u)
    if target == REWRITING_TARGET:
        # the migrated surface on both: caveated grants under two contexts
        for eng, op, rel in ((e, WriteOp, Relationship),
                             (je, JWriteOp, JRelationship)):
            eng.write_relationships([
                op("touch", rel("pod", "ns/p3", "viewer", "user", "u8",
                                caveat="probation")),
                op("touch", rel("pod", "ns/p4", "viewer", "user", "u8",
                                caveat="probation",
                                caveat_context='{"level": 1}'))])
        for ctx in ({"level": 2}, {"level": 5}):
            assert _answers(e, False, context=ctx) == \
                _answers(je, True, context=ctx), ctx
        assert _events(e.watch_since(0)) == _events(je.watch_since(0))


# ---------------------------------------------------------------------------
# (b) records across packages
# ---------------------------------------------------------------------------


def _durable(pkg: str, d: str):
    if pkg == "jax":
        e = JEngine(schema=jparse_schema(ADDITIVE_TARGET))
    else:
        e = _engine(ADDITIVE_TARGET)
    e.enable_persistence(d, wal_fsync="always", auto_checkpoint=False)
    _seed(e, n=9)
    return e


def _readable(e, revision: int) -> bool:
    try:
        e.watch_since(revision)
        return True
    except Exception:  # noqa: BLE001 - either package's StoreError
        return False


@pytest.mark.parametrize("phase", ["dual", "cut", "done"])
@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax")])
def test_record_written_by_one_package_resolves_in_the_other(
        tmp_path, writer, reader, phase):
    d, d2 = str(tmp_path / "w"), str(tmp_path / "r")
    w = _durable(writer, d)
    w.begin_schema_migration(REWRITING_TARGET, batch=4,
                             hold_at_dual=phase == "dual",
                             wait=phase != "dual")
    if phase == "dual":
        # the status moves before the record is persisted
        _wait_phase(lambda: json.load(open(os.path.join(
            d, "migration.json"), encoding="utf-8")), "dual")
    shutil.copytree(d, d2)
    if phase == "dual":
        w.abort_schema_migration()
    want_events = _events(w.watch_since(0))
    w.close_persistence(final_checkpoint=False)
    rec = os.path.join(d2, "migration.json")
    with open(rec, encoding="utf-8") as f:
        doc = json.load(f)
    assert doc["phase"] == ("dual" if phase == "dual" else "done")
    if phase == "cut":  # a crash between the CUT record and the swap
        doc["phase"] = "cut"
        with open(rec, "w", encoding="utf-8") as f:
            json.dump(doc, f)
    # the reader boots with the old schema, as the data dir's own
    # bootstrap would give it
    if reader == "jax":
        r = JEngine(schema=jparse_schema(ADDITIVE_TARGET))
    else:
        r = _engine(ADDITIVE_TARGET)
    r.enable_persistence(d2, wal_fsync="always", auto_checkpoint=False)
    try:
        out = r.recover_schema_migration()
        if phase == "dual":
            assert out["action"] == "aborted" and out["phase"] == "dual"
            assert not os.path.exists(rec)
            assert ir_digest(parse_schema(ADDITIVE_TARGET)) == \
                jschema.ir_digest(r.schema)
        else:
            assert out["action"] == "resumed" and out["phase"] == phase
            assert jschema.ir_digest(r.schema) == ir_digest(
                parse_schema(REWRITING_TARGET))
            with open(rec, encoding="utf-8") as f:
                assert json.load(f)["phase"] == "done"
        assert set(doc["suppressed_revisions"]) <= set(r._watch_suppress)
        # the replayed history (recovery keeps what the WAL holds): the
        # writer's events past its floor, echoes left out
        floor = next(k for k in range(r.revision + 1) if _readable(r, k))
        got_events = _events(r.watch_since(floor))
        assert got_events == [ev for ev in want_events if ev[0] > floor]
        # and it serves: the same answers as the writer's package would
        ref = _engine(ADDITIVE_TARGET if phase == "dual"
                      else REWRITING_TARGET)
        _seed(ref, n=9)
        jax = reader == "jax"
        for u in ("u1", "u4", "owner", "nobody"):
            assert sorted(r.lookup_resources("pod", "view", "user", u)) \
                == sorted(ref.lookup_resources("pod", "view", "user", u))
        if phase != "dual":
            op, rel = (JWriteOp, JRelationship) if jax else \
                (WriteOp, Relationship)
            r.write_relationships([op("touch", rel(
                "pod", "ns/p1", "viewer", "user", "probie",
                caveat="probation", caveat_context='{"level": 1}'))])
            item = JCheckItem if jax else CheckItem
            assert r.check(item("pod", "ns/p1", "view", "user", "probie"))
    finally:
        r.close_persistence(final_checkpoint=False)


# ---------------------------------------------------------------------------
# (b) the JAX client and the unchanged JAX proxy against a port host
# ---------------------------------------------------------------------------


def test_jax_client_drives_migrate_ops_on_a_port_host():
    e = _engine()
    _seed(e)
    with serving(remote.EngineServer, e) as s:
        jc = jremote.RemoteEngine("127.0.0.1", s.port)
        try:
            with pytest.raises(JSchemaViolation, match="incompatible"):
                jc.migrate_begin(INCOMPATIBLE_TARGET)
            assert jc.migrate_status() is None
            jc.migrate_begin(ADDITIVE_TARGET, hold_at_dual=True)
            _wait_phase(jc.migrate_status, "dual")
            st = jc.migrate_abort()
            assert st["phase"] == "aborted"
            assert e.schema.definitions["pod"].relations.get(
                "auditor") is None
            jc.migrate_begin(REWRITING_TARGET, hold_at_dual=True, batch=4)
            _wait_phase(jc.migrate_status, "dual")
            st = jc.migrate_cut(wait=True)
            assert st["phase"] == "done" and st["backfilled"] == 12
            # the reference's status keys, all of them
            je = JEngine(schema=jparse_schema(BASE))
            _seed(je)
            jst = je.begin_schema_migration(REWRITING_TARGET, wait=True,
                                            batch=4)
            assert set(st) == set(jst)
            assert {k: st[k] for k in STATUS_FIELDS} == \
                {k: jst[k] for k in STATUS_FIELDS}
            assert jc.check(JCheckItem("pod", "ns/p3", "view", "user",
                                       "u3"))
        finally:
            jc.close()


def test_jax_proxy_migrates_a_port_host(tmp_path):
    """The unchanged JAX proxy with ``--engine-endpoint tcp://...`` and
    ``--migrate-schema`` migrates a port host at boot (its wire op), then
    serves through the migrated engine."""
    from fake_kube import FakeKube
    from spicedb_kubeapi_proxy_tpu.proxy.inmemory import InMemoryClient
    from spicedb_kubeapi_proxy_tpu.proxy.options import Options
    from spicedb_kubeapi_proxy_tpu_torch.models.bootstrap import (
        DEFAULT_BOOTSTRAP,
        parse_bootstrap,
    )

    with open(os.path.join(REPO, "deploy", "rules.yaml")) as fh:
        rules = fh.read()
    text = parse_bootstrap(DEFAULT_BOOTSTRAP).schema_text
    # the operator's file: the namespace gains an auditor relation and
    # an audit permission, the workflow definitions left out (the proxy
    # appends them)
    target = text.split("definition lock")[0].replace(
        "  relation viewer: user\n\n", "  relation viewer: user\n"
        "  relation auditor: user\n\n").replace(
        "  permission no_one_at_all = nil\n",
        "  permission no_one_at_all = nil\n"
        "  permission audit = auditor + creator\n")
    assert "audit = auditor" in target
    mig = tmp_path / "target.zed"
    mig.write_text(target)
    engine = Engine(device="cpu")
    with serving(remote.EngineServer, engine) as s:

        async def go():
            cfg = Options(
                engine_endpoint=f"tcp://127.0.0.1:{s.port}",
                engine_insecure=True,
                rule_content=rules,
                upstream=FakeKube(),
                migrate_schema=str(mig),
                workflow_database_path=str(tmp_path / "dtx.sqlite"),
            ).complete()
            assert isinstance(cfg.engine, jremote.RemoteEngine)
            await cfg.workflow.resume_pending()
            st = await asyncio.to_thread(
                _wait_phase, cfg.engine.migrate_status, "done", 60.0)
            assert st["classification"] == "additive"
            assert "audit" in engine.schema.definitions[
                "namespace"].permissions
            alice = InMemoryClient(cfg.server.handle, user="alice")
            bob = InMemoryClient(cfg.server.handle, user="bob")
            resp = await alice.post("/api/v1/namespaces", {
                "apiVersion": "v1", "kind": "Namespace",
                "metadata": {"name": "migrated-ns"}})
            assert resp.status == 201, resp.body
            resp = await alice.get("/api/v1/namespaces")
            assert [o["metadata"]["name"] for o in
                    json.loads(resp.body)["items"]] == ["migrated-ns"]
            resp = await bob.get("/api/v1/namespaces")
            assert json.loads(resp.body)["items"] == []
            # the new permission answers under S' on the port host
            assert engine.check(CheckItem("namespace", "migrated-ns",
                                          "audit", "user", "alice"))
            await cfg.workflow.shutdown()
            cfg.engine.close()

        box: dict = {}

        def run():
            try:
                asyncio.run(go())
            except BaseException as ex:  # noqa: BLE001 - re-raised below
                box["error"] = ex

        t = threading.Thread(target=run, daemon=True)
        t.start()
        t.join(120)
        assert not t.is_alive(), "the proxy flow did not finish"
        if "error" in box:
            raise box["error"]


# ---------------------------------------------------------------------------
# (c) a cache fill and a compaction fold held across the cut
# ---------------------------------------------------------------------------


def _hold_first(obj, name):
    """Wrap ``obj.name`` so its first call computes its answer, then parks
    until ``release`` is set; later calls pass through. Returns (entered,
    release)."""
    real = getattr(obj, name)
    entered, release = threading.Event(), threading.Event()
    first = [True]

    def held(*a, **kw):
        if not first[0]:
            return real(*a, **kw)
        first[0] = False
        value = real(*a, **kw).result()
        entered.set()
        assert release.wait(30)
        return EngineFuture(None, lambda _: value)

    setattr(obj, name, held)
    return entered, release


@pytest.mark.parametrize("kind", ["lookup", "check"])
def test_cache_fill_straddling_the_cut_never_lands(kind):
    """A fill that dispatched on S and lands after the cut, under the same
    revision key, must not be served for an affected pair; a caller that
    comes after the cut must not join its flight."""
    e = _engine()
    _seed(e)
    e.enable_decision_cache()
    item = CheckItem("pod", "ns/p0", "view", "user", "owner")

    def ask():
        if kind == "lookup":
            return sorted(e.lookup_resources("pod", "view", "user",
                                             "owner"))
        return e.check(item)

    s_answer = ask()
    assert s_answer in (["ns/p0"], True)
    e.enable_decision_cache()  # empty again, so the next ask misses
    entered, release = _hold_first(
        e, "_lookup_direct" if kind == "lookup" else "_check_bulk_dispatch")
    got: dict = {}
    t = threading.Thread(target=lambda: got.setdefault("held", ask()))
    t.start()
    assert entered.wait(30)
    st = e.begin_schema_migration(NARROWING_TARGET, wait=True)
    assert st["phase"] == "done" and st["classification"] == "additive"
    # after the cut, before the held fill lands: a new caller
    t2 = threading.Thread(target=lambda: got.setdefault("after", ask()))
    t2.start()
    t2.join(0.5)
    release.set()
    t.join(30)
    t2.join(30)
    assert not t.is_alive() and not t2.is_alive()
    want = [] if kind == "lookup" else False
    assert got["held"] == s_answer  # it began before the cut
    assert got["after"] == want
    assert ask() == want
    assert ask() == want  # from the cache now


def test_compaction_fold_straddling_the_cut_never_publishes():
    e = _engine()
    _seed(e)
    e.compiled()
    comp = e.enable_compaction(1.0)
    try:
        real = e._compile_fresh
        entered, release = threading.Event(), threading.Event()

        def held(schema=None):
            cg = real(schema)
            if schema is None and threading.current_thread() is fold:
                entered.set()
                assert release.wait(30)
            return cg

        e._compile_fresh = held
        out: dict = {}
        fold = threading.Thread(target=lambda: out.setdefault(
            "published", comp.compact()))
        fold.start()
        assert entered.wait(30)
        st = e.begin_schema_migration(NARROWING_TARGET, wait=True)
        assert st["phase"] == "done"
        release.set()
        fold.join(30)
        assert not fold.is_alive() and out["published"] is False
        assert e.compiled().schema is e.schema
        assert e.lookup_resources("pod", "view", "user", "owner") == []
        assert not e.check(CheckItem("pod", "ns/p0", "view", "user",
                                     "owner"))
        # a fold after the cut compiles under S' and publishes
        assert comp.compact() is True
        assert e.lookup_resources("pod", "view", "user", "owner") == []
    finally:
        e.close_compaction()


# ---------------------------------------------------------------------------
# (c) the new graph's device, overlay and tier budget; the old base
# ---------------------------------------------------------------------------


def test_cpu_engine_migrates_on_the_cpu():
    """The dual compile takes the engine's device (the reference compiles
    with no device, which in the port means cuda: on this box it would
    raise, and on a card a CPU engine would serve a cuda graph) and its
    overlay capacity."""
    e = _engine(delta_capacity=256)
    _seed(e)
    st = e.begin_schema_migration(REWRITING_TARGET, wait=True)
    assert st["phase"] == "done", st
    cg = e.compiled()
    assert cg.schema is e.schema
    assert cg.device.type == "cpu"
    assert cg.delta_cap == 256
    assert e._head is cg
    assert e.check(CheckItem("pod", "ns/p5", "view", "user", "u5"))
    assert cg._dev()["src"].device.type == "cpu"


def test_tiered_engine_stays_tiered_after_the_cut(small_blocks):
    rows = _parity_rows()
    e = _engine(source := ADDITIVE_TARGET, device_graph_budget_bytes=4096)
    base = _engine(source)
    for eng in (e, base):
        eng.write_relationships([WriteOp("touch", Relationship(*r))
                                 for r in rows])
    old = e.compiled()
    assert old.tier is not None and old.tier.budget_bytes == 4096
    assert old.blocks, "the graph formed no dense block to tier"
    before = _answers(e, False)
    assert before == _answers(base, False)
    for eng in (e, base):
        assert eng.begin_schema_migration(REWRITING_TARGET, wait=True,
                                          batch=5)["phase"] == "done"
    cg = e.compiled()
    assert cg.schema is e.schema and cg.tier is not None
    assert cg.tier.budget_bytes == 4096
    assert cg.tier is not old.tier
    assert _answers(e, False) == _answers(base, False) == before
    assert cg.tier.stats()["cold_blocks"] + cg.tier.stats()[
        "hot_blocks"] == len(cg.blocks)


def test_old_base_is_freed_when_its_last_view_drops(small_blocks):
    """No release at the cut: a view of the old base still answers; its
    device state (and, tiered, its TierStore's prefetch workers) goes when
    the last view does."""
    e = _engine(ADDITIVE_TARGET, device_graph_budget_bytes=4096)
    e.write_relationships([WriteOp("touch", Relationship(*r))
                           for r in _parity_rows()])
    e.lookup_resources("pod", "view", "user", "u1")
    view = e.compiled()
    tier = view.tier
    res = weakref.ref(view.resident)
    assert tier.prefetcher._pool is not None  # the list streamed blocks
    want = view.query(np.asarray([view.encode_subject(
        "user", "u1", None, e._objects_by_name())], dtype=np.int32),
        np.arange(view.M, dtype=np.int32),
        np.zeros(view.M, dtype=np.int32))
    assert e.begin_schema_migration(REWRITING_TARGET,
                                    wait=True)["phase"] == "done"
    assert e.compiled() is not view
    assert res() is not None and not view.resident.released
    again = view.query(np.asarray([view.encode_subject(
        "user", "u1", None, e._objects_by_name())], dtype=np.int32),
        np.arange(view.M, dtype=np.int32),
        np.zeros(view.M, dtype=np.int32))
    np.testing.assert_array_equal(again, want)
    del view, again, want
    gc.collect()
    assert res() is None
    assert tier.prefetcher._pool is None  # its workers were shut down


def test_freeze_waits_for_a_writes_device_half():
    """The gate covers the whole write: the cut cannot freeze while a
    write admitted before it is still applying its device patch, and that
    write is in every answer after the cut."""
    e = _engine()
    _seed(e)
    e.begin_schema_migration(REWRITING_TARGET, hold_at_dual=True)
    _wait_phase(e.migration_status, "dual")
    real = e._apply_and_publish
    entered, release = threading.Event(), threading.Event()

    def held(cg):
        entered.set()
        assert release.wait(30)
        return real(cg)

    e._apply_and_publish = held
    t = threading.Thread(target=lambda: e.write_relationships([WriteOp(
        "touch", Relationship("pod", "ns/p7", "viewer", "user", "late"))]))
    t.start()
    assert entered.wait(30)
    e._apply_and_publish = real
    e.cut_schema_migration(wait=False)
    time.sleep(0.3)
    assert e.migration_status()["phase"] == "dual"  # frozen, not cut
    release.set()
    t.join(30)
    e._migrator.join(30)
    assert not t.is_alive()
    assert e.migration_status()["phase"] == "done"
    assert e.check(CheckItem("pod", "ns/p7", "view", "user", "late"))
    assert "ns/p7" in e.lookup_resources("pod", "view", "user", "late")


def test_writes_acked_around_the_cut_are_in_every_answer():
    e = _engine()
    _seed(e)
    e.enable_decision_cache()
    acked: list = []
    stop = threading.Event()

    def writer():
        i = 0
        while not stop.is_set():
            e.write_relationships([WriteOp("touch", Relationship(
                "pod", f"ns/w{i}", "viewer", "user", f"w{i % 5}"))])
            acked.append(i)
            i += 1
            time.sleep(0.002)

    t = threading.Thread(target=writer)
    t.start()
    try:
        st = e.begin_schema_migration(REWRITING_TARGET, wait=True,
                                      batch=3)
    finally:
        stop.set()
        t.join(30)
    assert not t.is_alive()
    assert st["phase"] == "done", st
    assert acked
    oracle = e.oracle()
    for u in (f"w{k}" for k in range(5)):
        assert set(e.lookup_resources("pod", "view", "user", u)) == \
            oracle.lookup_resources("pod", "view", "user", u)
    assert all(e.check_bulk([CheckItem("pod", f"ns/w{i}", "view", "user",
                                       f"w{i % 5}") for i in acked]))


def test_lookups_in_flight_with_batching_see_one_schema(small_blocks):
    """Lookups through the batcher while the migration runs: every mask is
    S's answer or S''s, never a mix; the unaffected permission's masks
    never move."""
    rows = _parity_rows()
    e = _engine()
    e.write_relationships([WriteOp("touch", Relationship(*r))
                           for r in rows])
    e.enable_lookup_batching(window=0.002, max_rows=4)
    e.enable_decision_cache()
    after = _engine(NARROWING_TARGET)
    after.write_relationships([WriteOp("touch", Relationship(*r))
                               for r in rows])
    users = USERS[:6]
    want_s = {u: e.lookup_resources_mask("pod", "view", "user", u)[0]
              for u in users}
    want_s2 = {u: after.lookup_resources_mask("pod", "view", "user", u)[0]
               for u in users}
    assert any(not np.array_equal(want_s[u], want_s2[u]) for u in users)
    ns_want = {u: e.lookup_resources_mask("namespace", "view", "user",
                                          u)[0] for u in users}
    seen: list = []
    errors: list = []
    stop = threading.Event()

    def lister(k):
        while not stop.is_set():
            u = users[k % len(users)]
            try:
                m, _ = e.lookup_resources_mask("pod", "view", "user", u)
                n, _ = e.lookup_resources_mask("namespace", "view",
                                               "user", u)
            except Exception as ex:  # noqa: BLE001 - re-raised below
                errors.append(ex)
                return
            seen.append((u, m, n))
            k += 1

    # more listers than cores, and a short switch interval, so threads
    # interleave inside the cut
    ts = [threading.Thread(target=lister, args=(k,))
          for k in range(min(2 * (os.cpu_count() or 4), 24))]
    swi = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in ts:
            t.start()
        st = e.begin_schema_migration(NARROWING_TARGET, wait=True)
        time.sleep(0.1)
    finally:
        stop.set()
        for t in ts:
            t.join(30)
        sys.setswitchinterval(swi)
    assert not any(t.is_alive() for t in ts)
    assert st["phase"] == "done" and not errors
    assert seen
    for u, m, n in seen:
        assert np.array_equal(m, want_s[u]) or np.array_equal(
            m, want_s2[u]), u
        np.testing.assert_array_equal(n, ns_want[u], err_msg=u)
    for u in users:
        np.testing.assert_array_equal(
            e.lookup_resources_mask("pod", "view", "user", u)[0],
            want_s2[u], err_msg=u)
    e.disable_lookup_batching()


# ---------------------------------------------------------------------------
# (c) watch streams: no echo, and no spin on an echo-only tail
# ---------------------------------------------------------------------------


def test_push_stream_never_carries_a_backfill_echo(monkeypatch):
    """A push stream parked before the begin wakes on each backfill write;
    the echo must already be suppressed when it reads the records (each
    batch here returns 0.2 s after its commit, so a stream that reads
    before the echo is armed would deliver it)."""
    from spicedb_kubeapi_proxy_tpu_torch.migration import SchemaMigrator

    real = SchemaMigrator._write_backfill_batch

    def slow(self, ops):
        rev = real(self, ops)
        time.sleep(0.2)
        return rev

    monkeypatch.setattr(SchemaMigrator, "_write_backfill_batch", slow)
    e = _engine(ADDITIVE_TARGET)
    _seed(e, n=9)
    rev0 = e.revision
    with serving(remote.EngineServer, e) as s:
        client = remote.RemoteEngine("127.0.0.1", s.port)
        stream = client.watch_push_stream(rev0)
        try:
            st = client.migrate_begin(REWRITING_TARGET, batch=4, wait=True)
            assert st["phase"] == "done" and st["suppressed"] == 3
            # an echo-only tail: the wait runs its whole timeout
            t0 = time.monotonic()
            assert e.wait_events(rev0, 0.3) == []
            assert time.monotonic() - t0 >= 0.25
            rev = client.write_relationships([WriteOp("touch", Relationship(
                "pod", "ns/p2", "viewer", "user", "after"))])
            got = []
            while not got:  # [] would be a liveness heartbeat
                got = stream.next_batch()
            assert [ev.revision for ev in got] == [rev]
            assert got[0].relationship.subject_id == "after"
        finally:
            stream.close()
            client.close()
