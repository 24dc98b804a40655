"""PyTorch port, the scale-out planner's coordinated schema migration
(``ShardedEngine.begin_schema_migration``, its coordinated cut, the
rollback of a begin that a group refuses, and ``_recover_migration``
after a planner restart) held against the JAX package.

One script runs over two engine hosts of one package and a planner of
one package, on the chaos campaign's ``MIGRATED_SCHEMA`` target:

1. seed the campaign's static grants, read pod#view, pod#edit and
   namespace#view for owners, direct viewers, creators and an intruder;
2. ``begin_schema_migration(target, wait=True)``: every group held at
   dual, then the coordinated cut; read the verdicts again, and a
   caveated grant written after the cut;
3. a second begin that a group refuses (a migration of its own already
   runs there): the planner takes back the group it began, and the
   journal holds no record;
4. a planner stopped after it persisted the dual-wait record: a new
   planner over the same journal aborts every group;
5. a planner stopped after it persisted the cutting record: a new
   planner re-issues every cut.

The port's planner over port hosts and the JAX planner over port hosts
must give what the JAX planner over JAX hosts gives: the status
documents, the verdicts, and the record on each group.
"""

from __future__ import annotations

import time

import pytest

from spicedb_kubeapi_proxy_tpu.chaos import campaign as jcampaign
from spicedb_kubeapi_proxy_tpu_torch.chaos import campaign as tcampaign

from torch_parity import package, serving

# the second target: an additive change on top of the first
SECOND_EXTRA = """
definition auditlog {
  relation reader: user
  permission read = reader
}
"""

PROBES = [
    (rt, rid, perm, "user", sub)
    for i in range(3)
    for rt, rid, perm, sub in (
        ("pod", f"ns{i}/p0", "view", f"owner{i}"),
        ("pod", f"ns{i}/p0", "view", f"direct{i}"),
        ("pod", f"ns{i}/p0", "view", "intruder"),
        ("pod", f"ns{i}/p0", "edit", f"creator{i}"),
        ("pod", f"ns{i}/p0", "edit", f"direct{i}"),
        ("namespace", f"ns{i}", "view", f"owner{i}"),
        ("namespace", f"ns{i}", "view", "intruder"),
        ("pod", f"ns{i}/p0", "view", f"prob{i}"),
    )
]

# the per-group record fields that hold answers (never clocks)
_STATUS_KEYS = ("phase", "classification", "backfilled", "error",
                "affected", "hold_at_dual", "lag")


def _status(st):
    if st is None:
        return None
    return {k: st[k] for k in _STATUS_KEYS if k in st}


def _planner_status(st):
    if st is None:
        return None
    return {k: v for k, v in st.items() if k != "lag"}


def _wait_phase(client, want: str, budget: float = 60.0):
    deadline = time.monotonic() + budget
    while True:
        st = client.migrate_status()
        if st is not None and st.get("phase") == want:
            return st
        assert time.monotonic() < deadline, st
        time.sleep(0.05)


def _scenario(planner_pkg: str, host_pkg: str, tmp_path) -> dict:
    P, H = package(planner_pkg), package(host_pkg)
    camp = {"jax": jcampaign, "torch": tcampaign}[planner_pkg]
    target = camp._migration_target_text()
    second = target + "\n" + SECOND_EXTRA
    out: dict = {}
    engines = [H.engine(camp.SCHEMA_YAML) for _ in range(2)]
    with serving(H.EngineServer, engines[0]) as s0, \
            serving(H.EngineServer, engines[1]) as s1:
        smap = P.ShardMap(version=1, groups=(
            (("127.0.0.1", s0.port),), (("127.0.0.1", s1.port),)))
        journal_path = str(tmp_path / f"{planner_pkg}-{host_pkg}.sqlite")
        clients: list = []

        def planner():
            cs = [P.RemoteEngine("127.0.0.1", s.port) for s in (s0, s1)]
            clients.extend(cs)
            return P.ShardedEngine(smap, cs,
                                   journal=P.SplitJournal(journal_path))

        def verdicts(p, context=None):
            items = [P.CheckItem(*a) for a in PROBES]
            return [bool(v) for v in p.check_bulk(items, context=context)]

        def groups():
            return [_status(c.migrate_status()) for c in clients[:2]]

        p = planner()
        rel = P.Relationship
        writes = []
        for i in range(camp.NS_COUNT):
            ns = f"ns{i}"
            writes += [
                rel("namespace", ns, "viewer", "user", f"owner{i}", None),
                rel("pod", f"{ns}/p0", "namespace", "namespace", ns, None),
                rel("pod", f"{ns}/p0", "viewer", "user", f"direct{i}",
                    None),
                rel("pod", f"{ns}/p0", "creator", "user", f"creator{i}",
                    None)]
        p.write_relationships([P.WriteOp("touch", r) for r in writes])
        out["before"] = verdicts(p)

        # 2: the coordinated cut
        st = p.begin_schema_migration(target, wait=True, timeout=120.0)
        out["begin"] = _planner_status(st)
        out["after_cut_status"] = _planner_status(p.migration_status())
        out["after_cut_groups"] = groups()
        out["after_cut"] = verdicts(p)
        p.write_relationships([P.WriteOp("touch", rel(
            "pod", f"ns{i}/p0", "viewer", "user", f"prob{i}", None,
            caveat="probation", caveat_context='{"level": 1}'))
            for i in range(3)])
        out["caveated"] = verdicts(p, context={})
        assert p.journal.load_migration() is None

        # 3: a begin that group 1 refuses rolls group 0 back
        clients[1].migrate_begin(second, hold_at_dual=True)
        with pytest.raises(Exception) as exc:
            p.begin_schema_migration(second)
        out["refused"] = type(exc.value).__name__
        out["refused_groups"] = groups()
        assert p.journal.load_migration() is None
        clients[1].migrate_abort()
        _wait_phase(clients[1], "aborted")
        p.close()

        # 4: a planner that persisted dual-wait and stopped
        p = planner()
        p._coordinate_cut = lambda deadline: None
        out["dual_wait_begin"] = _planner_status(
            p.begin_schema_migration(second))
        out["dual_wait_record"] = p.journal.load_migration()["phase"]
        for c in clients[-2:]:
            _wait_phase(c, "dual")
        p.close()
        p = planner()
        out["recovered_abort"] = _planner_status(p.migration_status())
        for c in clients[-2:]:
            _wait_phase(c, "aborted")
        out["recovered_abort_groups"] = [
            _status(c.migrate_status()) for c in clients[-2:]]
        assert p.journal.load_migration() is None
        out["after_abort"] = verdicts(p, context={})

        # 5: a planner that persisted the cutting record and stopped
        def crash_after_point_of_no_return(deadline, p=p):
            for c in p.groups:
                _wait_phase(c, "dual")
            p.journal.save_migration({"phase": "cutting",
                                      "groups": len(p.groups)})

        p._coordinate_cut = crash_after_point_of_no_return
        p.begin_schema_migration(second)
        p._migration_thread.join(60)
        out["cutting_record"] = p.journal.load_migration()["phase"]
        p.close()
        p = planner()
        out["recovered_cut"] = _planner_status(p.migration_status())
        for c in clients[-2:]:
            _wait_phase(c, "done")
        out["recovered_cut_groups"] = [
            _status(c.migrate_status()) for c in clients[-2:]]
        assert p.journal.load_migration() is None
        out["final"] = verdicts(p, context={})
        p.write_relationships([P.WriteOp("touch", rel(
            "auditlog", "a1", "reader", "user", "owner0", None))])
        out["new_type"] = bool(p.check(P.CheckItem(
            "auditlog", "a1", "read", "user", "owner0")))
        p.close()
        for c in clients:
            c.close()
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return _scenario("jax", "jax", tmp_path_factory.mktemp("ref"))


def test_the_reference_script_drives_every_branch(reference):
    r = reference
    assert r["begin"]["phase"] == "done"
    assert [g["phase"] for g in r["after_cut_groups"]] == ["done"] * 2
    assert r["refused_groups"][0]["phase"] == "aborted"
    assert r["dual_wait_record"] == "dual-wait"
    assert r["recovered_abort"]["phase"] == "aborted"
    assert r["cutting_record"] == "cutting"
    assert r["recovered_cut"]["phase"] == "done"
    assert r["new_type"] is True
    # the verdicts moved only where the target grants more
    assert r["before"] == r["after_cut"]
    assert r["caveated"] != r["after_cut"]


@pytest.mark.parametrize("planner_pkg", ["torch", "jax"])
def test_coordinated_migration_over_port_hosts_matches_jax(
        reference, planner_pkg, tmp_path):
    got = _scenario(planner_pkg, "torch", tmp_path)
    assert got == reference


class _Group:
    """A port engine as one planner group, with two faults a failover
    set shows: ``forget`` makes the group answer no migration (its
    leader died and a peer that never migrated took over), and
    ``abort_delay`` makes each abort take that long (a host joining a
    busy migrator thread)."""

    def __init__(self, engine, abort_delay: float = 0.0):
        self._engine = engine
        self.abort_delay = abort_delay
        self.forget = False

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def migration_status(self):
        return None if self.forget else self._engine.migration_status()

    def abort_schema_migration(self):
        time.sleep(self.abort_delay)
        return self._engine.abort_schema_migration()


def test_a_failed_coordinated_migration_is_published_after_its_rollback():
    """The campaign's crash episode: group 0's leader dies mid-migration,
    the planner's coordination fails, and the operator begins again the
    moment the planner reports ``failed``. Every group must already be
    rolled back by then, so the second begin runs to its cut instead of
    meeting the first attempt's migration on a slow-to-abort group."""
    P = package("torch")
    target = tcampaign._migration_target_text()
    engines = [P.engine(tcampaign.SCHEMA_YAML) for _ in range(2)]
    groups = [_Group(engines[0]), _Group(engines[1], abort_delay=1.0)]
    smap = P.ShardMap(version=1, groups=(
        (("127.0.0.1", 1),), (("127.0.0.1", 2),)))
    p = P.ShardedEngine(smap, groups)
    groups[0].forget = True
    p.begin_schema_migration(target)
    deadline = time.monotonic() + 30.0
    while p.migration_status()["phase"] not in ("done", "failed",
                                                "aborted"):
        assert time.monotonic() < deadline
        time.sleep(0.01)
    st = p.migration_status()
    assert st["phase"] == "failed"
    assert "failed/aborted before the coordinated cut" in st["error"]
    assert [e.migration_status()["phase"] for e in engines] \
        == ["aborted", "aborted"]
    groups[0].forget = False
    st = p.begin_schema_migration(target, wait=True, timeout=60.0)
    assert st["phase"] == "done"
    assert [e.migration_status()["phase"] for e in engines] \
        == ["done", "done"]
    p.close()
