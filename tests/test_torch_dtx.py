"""The durable dual write on both packages: ``tests/test_dtx.py``'s
workflow, lock and recovery cases, each run against the JAX package's
``dtx/`` over the JAX ``Engine`` and the JAX ``InMemoryKube``, and against
the port's ``dtx/`` over the port's ``Engine(device="cpu")`` and the
port's ``InMemoryKube``.

The tests are the JAX suite's, word for word, but for two lines: the
failpoint fixture names ``pkg``, and the lock-conflict case's local import
of ``resource_lock_rel`` is bound with the other names. The autouse ``pkg``
fixture binds this module's names to one package's objects for the
duration of a test (tolerance: exact).
"""

import asyncio
import base64
import functools
import importlib
import json

import pytest

import fake_kube
from torch_parity import fake_kube_class

JAX, PORT = "spicedb_kubeapi_proxy_tpu", "spicedb_kubeapi_proxy_tpu_torch"

# name -> module (under the package) it is imported from
NAMES = {
    "ActivityHandler": ".dtx", "WorkflowEngine": ".dtx",
    "WorkflowInput": ".dtx", "register_workflows": ".dtx",
    "ActivityError": ".dtx.runner",
    "LOCK_MODE_OPTIMISTIC": ".dtx.workflow",
    "LOCK_MODE_PESSIMISTIC": ".dtx.workflow",
    "resource_lock_rel": ".dtx.workflow",
    "CheckItem": ".engine", "Engine": ".engine",
    "RelationshipFilter": ".engine", "WriteOp": ".engine",
    "parse_relationship": ".models.tuples",
    "failpoints": ".utils.failpoints",
}


def _bind(pkg: str) -> None:
    g = globals()
    for name, mod in NAMES.items():
        g[name] = getattr(importlib.import_module(pkg + mod), name)
    if pkg == PORT:
        g["Engine"] = functools.partial(g["Engine"], device="cpu")
        g["FakeKube"] = fake_kube_class(PORT)
    else:
        g["FakeKube"] = fake_kube.FakeKube


_bind(JAX)  # the names the module body reads at collection


@pytest.fixture(autouse=True, params=[JAX, PORT], ids=["jax", "port"])
def pkg(request):
    _bind(request.param)
    yield request.param


def ns_create_input(name="team-a", user="alice") -> WorkflowInput:
    body = json.dumps({"metadata": {"name": name}, "kind": "Namespace"})
    return WorkflowInput(
        verb="create",
        path="/api/v1/namespaces",
        uri="/api/v1/namespaces",
        headers={"Content-Type": "application/json"},
        user_name=user,
        object_name=name,
        namespace="",
        api_group="",
        resource="namespaces",
        body_b64=base64.b64encode(body.encode()).decode(),
        preconditions=[{
            "must_exist": False,
            "filter": {"resource_type": "namespace", "resource_id": name,
                       "relation": "cluster"},
        }],
        creates=[
            f"namespace:{name}#creator@user:{user}",
            f"namespace:{name}#cluster@cluster:cluster",
        ],
    )


def ns_delete_input(name="team-a", user="alice") -> WorkflowInput:
    return WorkflowInput(
        verb="delete",
        path=f"/api/v1/namespaces/{name}",
        uri=f"/api/v1/namespaces/{name}",
        headers={},
        user_name=user,
        object_name=name,
        namespace="",
        api_group="",
        resource="namespaces",
        deletes=[
            f"namespace:{name}#creator@user:{user}",
            f"namespace:{name}#cluster@cluster:cluster",
        ],
    )


class World:
    """Engine + fake kube + workflow runner wired together."""

    def __init__(self, db_path=":memory:"):
        self.engine = Engine()
        self.kube = FakeKube()
        self.db_path = db_path
        self.runner = self.new_runner()

    def new_runner(self) -> WorkflowEngine:
        r = WorkflowEngine(db_path=self.db_path)
        register_workflows(r)
        ActivityHandler(self.engine, self.kube).register(r)
        return r

    def no_leftover_locks(self) -> bool:
        return not self.engine.store.exists(
            RelationshipFilter(resource_type="lock"))

    def has_rel(self, rel: str) -> bool:
        r = parse_relationship(rel)
        return self.engine.store.exists(RelationshipFilter(
            r.resource_type, r.resource_id, r.relation,
            r.subject_type, r.subject_id, r.subject_relation))


@pytest.fixture(autouse=True)
def clear_failpoints(pkg):
    failpoints.disable_all()
    yield
    failpoints.disable_all()


@pytest.mark.parametrize("mode", [LOCK_MODE_PESSIMISTIC, LOCK_MODE_OPTIMISTIC])
def test_dual_write_happy_path(mode):
    async def run():
        w = World()
        iid = await w.runner.create_instance(mode, ns_create_input().to_dict())
        out = await w.runner.get_result(iid, timeout=10)
        assert out["status"] == 201
        body = json.loads(base64.b64decode(out["body_b64"]))
        assert body["metadata"]["name"] == "team-a"
        assert ("namespaces", "", "team-a") in w.kube.objects
        assert w.has_rel("namespace:team-a#creator@user:alice")
        assert w.engine.check(CheckItem("namespace", "team-a", "view",
                                        "user", "alice"))
        assert w.no_leftover_locks()
    asyncio.run(run())


@pytest.mark.parametrize("mode", [LOCK_MODE_PESSIMISTIC, LOCK_MODE_OPTIMISTIC])
def test_spicedb_precondition_failure_conflict(mode):
    async def run():
        w = World()
        # precondition (cluster rel must not exist) already violated
        w.engine.write_relationships(
            [WriteOp("touch",
                     parse_relationship("namespace:team-a#cluster@cluster:cluster"))])
        iid = await w.runner.create_instance(mode, ns_create_input().to_dict())
        out = await w.runner.get_result(iid, timeout=10)
        assert out["status"] == 409
        assert ("namespaces", "", "team-a") not in w.kube.objects
        assert not w.has_rel("namespace:team-a#creator@user:alice")
        assert w.no_leftover_locks()
    asyncio.run(run())


def test_lock_conflict_returns_409():
    async def run():
        w = World()
        lock = resource_lock_rel(ns_create_input(), "other-workflow")
        w.engine.write_relationships([WriteOp("touch", parse_relationship(lock))])
        iid = await w.runner.create_instance(
            LOCK_MODE_PESSIMISTIC, ns_create_input().to_dict())
        out = await w.runner.get_result(iid, timeout=10)
        assert out["status"] == 409
        assert not w.has_rel("namespace:team-a#creator@user:alice")
        # the other workflow's lock is untouched
        assert w.engine.store.exists(RelationshipFilter(resource_type="lock"))
    asyncio.run(run())


def test_kube_rejection_rolls_back():
    async def run():
        w = World()
        # kube rejects with a NON-retryable failure status (422)
        w.kube.fail_next(n=1, status=422, method="POST")
        iid = await w.runner.create_instance(
            LOCK_MODE_PESSIMISTIC, ns_create_input().to_dict())
        out = await w.runner.get_result(iid, timeout=10)
        assert out["status"] == 422
        assert not w.has_rel("namespace:team-a#creator@user:alice")
        assert w.no_leftover_locks()
    asyncio.run(run())


def test_unsupported_verb_rejected_before_any_side_effect():
    """A dual-write on a verb outside create/update/patch/delete is
    rejected up front in BOTH lock modes — before any SpiceDB write, so
    nothing needs rolling back, no retry budget burns, and (critically)
    the optimistic path's existence arbitration cannot fabricate success
    over committed relationship writes (a collection GET answers 200).
    The activity's verb->method map and _is_successful stay as
    defense-in-depth behind it."""
    async def run():
        for mode in (LOCK_MODE_PESSIMISTIC, LOCK_MODE_OPTIMISTIC):
            w = World()
            inp = ns_create_input()
            inp.verb = "deletecollection"
            iid = await w.runner.create_instance(mode, inp.to_dict())
            with pytest.raises(Exception, match="unsupported kube verb"):
                await w.runner.get_result(iid, timeout=10)
            assert not w.has_rel("namespace:team-a#creator@user:alice"), mode
            assert w.no_leftover_locks(), mode
            assert not w.kube.requests, (mode, "kube must never be hit")
    asyncio.run(run())


def test_kube_transient_exception_retried():
    async def run():
        w = World()
        w.kube.fail_next(n=2, exception=ConnectionError("kaboom"),
                         method="POST")
        iid = await w.runner.create_instance(
            LOCK_MODE_PESSIMISTIC, ns_create_input().to_dict())
        out = await w.runner.get_result(iid, timeout=15)
        assert out["status"] == 201
        assert w.has_rel("namespace:team-a#creator@user:alice")
        assert w.no_leftover_locks()
    asyncio.run(run())


def test_delete_with_404_is_success():
    async def run():
        w = World()
        w.engine.write_relationships([
            WriteOp("touch",
                    parse_relationship("namespace:team-a#creator@user:alice")),
            WriteOp("touch",
                    parse_relationship("namespace:team-a#cluster@cluster:cluster")),
        ])
        # object already gone from kube: delete still succeeds (404 ok)
        iid = await w.runner.create_instance(
            LOCK_MODE_PESSIMISTIC, ns_delete_input().to_dict())
        out = await w.runner.get_result(iid, timeout=10)
        assert out["status"] == 404
        assert not w.has_rel("namespace:team-a#creator@user:alice")
        assert w.no_leftover_locks()
    asyncio.run(run())


@pytest.mark.parametrize("mode", [LOCK_MODE_PESSIMISTIC, LOCK_MODE_OPTIMISTIC])
@pytest.mark.parametrize("failpoint", [
    "panicWriteSpiceDB",     # before the spicedb side effect
    "panicSpiceDBReadResp",  # after the spicedb side effect
    "panicKubeWrite",        # before the kube side effect
    "panicKubeReadResp",     # after the kube side effect
])
def test_crash_matrix_resume_exactly_once(tmp_path, mode, failpoint):
    """Crash at every side-effect edge; a restarted worker must complete the
    dual-write exactly once (reference proxy_test.go:650-830)."""
    async def run():
        db = str(tmp_path / f"dtx-{mode}-{failpoint}.sqlite")
        w = World(db_path=db)
        failpoints.enable(failpoint, 1)
        iid = await w.runner.create_instance(mode, ns_create_input().to_dict())
        with pytest.raises(asyncio.TimeoutError):
            await w.runner.get_result(iid, timeout=0.5)
        assert w.runner.pending_count() == 1
        # "restart": a fresh engine over the same event log
        w.runner = w.new_runner()
        resumed = await w.runner.resume_pending()
        assert resumed == [iid]
        out = await w.runner.get_result(iid, timeout=15)
        assert out["status"] in (201, 409)  # 409: kube write landed pre-crash
        assert ("namespaces", "", "team-a") in w.kube.objects
        assert w.has_rel("namespace:team-a#creator@user:alice")
        assert w.has_rel("namespace:team-a#cluster@cluster:cluster")
        assert w.no_leftover_locks()
        # exactly-once: no duplicate objects, exactly one creator rel
        rels = list(w.engine.read_relationships(RelationshipFilter(
            resource_type="namespace", relation="creator")))
        assert len(rels) == 1
    asyncio.run(run())


def test_optimistic_ambiguous_kube_failure_object_exists():
    """Kube activity fails but the write landed: no rollback
    (reference workflow.go:335-348)."""
    async def run():
        w = World()
        # the object already exists in kube (simulating a prior landed write),
        # and the kube activity raises
        w.kube.objects[("namespaces", "", "team-a")] = {
            "kind": "Namespace", "metadata": {"name": "team-a"}}
        w.kube.fail_next(n=10, exception=ConnectionError("down"),
                         method="POST")
        iid = await w.runner.create_instance(
            LOCK_MODE_OPTIMISTIC, ns_create_input().to_dict())
        out = await w.runner.get_result(iid, timeout=10)
        assert out["status"] == 200
        assert w.has_rel("namespace:team-a#creator@user:alice")
    asyncio.run(run())


def test_optimistic_ambiguous_kube_failure_object_absent():
    async def run():
        w = World()
        # POSTs fail; the existence probe (GET) succeeds and reports absent,
        # so the relationship write must be rolled back (workflow.go:341-346)
        w.kube.fail_next(n=20, exception=ConnectionError("down"),
                         method="POST")
        iid = await w.runner.create_instance(
            LOCK_MODE_OPTIMISTIC, ns_create_input().to_dict())
        with pytest.raises(ActivityError):
            await w.runner.get_result(iid, timeout=10)
        assert not w.has_rel("namespace:team-a#creator@user:alice")
    asyncio.run(run())


def seed_pod_delete_by_filter(w: "World") -> "WorkflowInput":
    """Three pod viewer rels + the kube object, and the deleteByFilter
    input that removes them — shared by the happy-path and crash-resume
    variants."""
    w.engine.write_relationships([
        WriteOp("touch", parse_relationship(f"pod:ns/p#viewer@user:u{i}"))
        for i in range(3)
    ])
    w.kube.objects[("pods", "ns", "p")] = {
        "kind": "Pod", "metadata": {"name": "p", "namespace": "ns"}}
    return WorkflowInput(
        verb="delete", path="/api/v1/namespaces/ns/pods/p",
        uri="/api/v1/namespaces/ns/pods/p", headers={},
        user_name="alice", object_name="p", namespace="ns",
        api_group="", resource="pods",
        delete_by_filter=[{"resource_type": "pod", "resource_id": "ns/p"}],
    )


@pytest.mark.parametrize("failpoint", ["panicReadSpiceDB",
                                       "panicSpiceDBReadRelResp"])
def test_crash_during_delete_by_filter_read_resumes(tmp_path, failpoint):
    """Crash inside the ReadRelationships activity (before/after the
    read) while expanding deleteByFilter: the resumed workflow still
    deletes the stable concrete set exactly once (reference
    workflow.go:354-389; failpoints at activity.go:153,155)."""
    async def run():
        db = str(tmp_path / f"dbf-{failpoint}.sqlite")
        w = World(db_path=db)
        inp = seed_pod_delete_by_filter(w)
        failpoints.enable(failpoint, 1)
        iid = await w.runner.create_instance(LOCK_MODE_PESSIMISTIC,
                                             inp.to_dict())
        with pytest.raises(asyncio.TimeoutError):
            await w.runner.get_result(iid, timeout=0.5)
        w.runner = w.new_runner()
        await w.runner.resume_pending()
        out = await w.runner.get_result(iid, timeout=10)
        assert out["status"] == 200
        assert not w.engine.store.exists(
            RelationshipFilter(resource_type="pod"))
        assert w.no_leftover_locks()
    asyncio.run(run())


def test_crash_during_kube_existence_probe_resumes(tmp_path):
    """Optimistic arbitration: the kube write fails ambiguously, then the
    process dies INSIDE the existence probe (failpoint at
    activity.go:233-247). The resumed workflow re-probes, finds the
    object absent, and rolls the relationships back."""
    async def run():
        db = str(tmp_path / "probe.sqlite")
        w = World(db_path=db)
        w.kube.fail_next(n=20, exception=ConnectionError("down"),
                         method="POST")
        failpoints.enable("panicCheckKube", 1)
        iid = await w.runner.create_instance(
            LOCK_MODE_OPTIMISTIC, ns_create_input().to_dict())
        with pytest.raises(asyncio.TimeoutError):
            await w.runner.get_result(iid, timeout=1.0)
        w.runner = w.new_runner()
        await w.runner.resume_pending()
        with pytest.raises(ActivityError):
            await w.runner.get_result(iid, timeout=10)
        assert not w.has_rel("namespace:team-a#creator@user:alice")
        assert ("namespaces", "", "team-a") not in w.kube.objects
    asyncio.run(run())


def test_delete_by_filter_expansion():
    async def run():
        w = World()
        inp = seed_pod_delete_by_filter(w)
        iid = await w.runner.create_instance(LOCK_MODE_PESSIMISTIC,
                                             inp.to_dict())
        out = await w.runner.get_result(iid, timeout=10)
        assert out["status"] == 200
        assert not w.engine.store.exists(
            RelationshipFilter(resource_type="pod"))
        assert w.no_leftover_locks()
    asyncio.run(run())


def test_workflow_determinism_replay_guard(tmp_path):
    """Replaying with different workflow code fails loudly."""
    async def run():
        db = str(tmp_path / "det.sqlite")
        w = World(db_path=db)
        failpoints.enable("panicKubeWrite", 1)
        iid = await w.runner.create_instance(
            LOCK_MODE_PESSIMISTIC, ns_create_input().to_dict())
        with pytest.raises(asyncio.TimeoutError):
            await w.runner.get_result(iid, timeout=0.5)
        # resume with a DIFFERENT (incompatible) workflow registered
        w.runner = w.new_runner()

        def bogus(ctx, input):
            yield ctx.call("read_relationships", filter={})
            return None

        w.runner.register_workflow(LOCK_MODE_PESSIMISTIC, bogus)
        await w.runner.resume_pending()
        with pytest.raises(ActivityError, match="non-deterministic"):
            await w.runner.get_result(iid, timeout=5)
    asyncio.run(run())


@pytest.mark.parametrize("mode", [LOCK_MODE_PESSIMISTIC, LOCK_MODE_OPTIMISTIC])
def test_ownership_stealing_prevented_when_crashing(tmp_path, mode):
    """paul creates chani's namespace but crashes before reading the kube
    response; the resumed workflow completes PAUL's ownership, and chani's
    later create conflicts instead of stealing it (reference
    proxy_test.go:734-747)."""
    async def run():
        db = str(tmp_path / f"steal-{mode}.sqlite")
        w = World(db_path=db)
        failpoints.enable("panicKubeReadResp", 1)
        iid = await w.runner.create_instance(
            mode, ns_create_input(name="chani-ns", user="paul").to_dict())
        with pytest.raises(asyncio.TimeoutError):
            await w.runner.get_result(iid, timeout=0.5)
        # "restart": paul's dual-write resumes and completes
        w.runner = w.new_runner()
        await w.runner.resume_pending()
        out = await w.runner.get_result(iid, timeout=15)
        assert out["status"] in (201, 409)
        assert w.has_rel("namespace:chani-ns#creator@user:paul")

        # chani attempts to create "her" namespace: conflict, not theft
        iid2 = await w.runner.create_instance(
            mode, ns_create_input(name="chani-ns", user="chani").to_dict())
        out2 = await w.runner.get_result(iid2, timeout=15)
        assert out2["status"] == 409
        assert w.has_rel("namespace:chani-ns#creator@user:paul")
        assert not w.has_rel("namespace:chani-ns#creator@user:chani")
        # chani can't view it — paul owns it and hasn't shared
        assert not w.engine.check(CheckItem("namespace", "chani-ns", "view",
                                            "user", "chani"))
        assert w.engine.check(CheckItem("namespace", "chani-ns", "view",
                                        "user", "paul"))
        assert w.no_leftover_locks()
    asyncio.run(run())


@pytest.mark.parametrize("mode", [LOCK_MODE_PESSIMISTIC, LOCK_MODE_OPTIMISTIC])
def test_ownership_stealing_prevented_when_retrying(tmp_path, mode):
    """paul owns the namespace; chani's create crashes before reading the
    kube response. The resumed retry must surface the conflict and roll
    chani's relationships back — not grant her ownership (reference
    proxy_test.go:748-760)."""
    async def run():
        db = str(tmp_path / f"steal2-{mode}.sqlite")
        w = World(db_path=db)
        iid = await w.runner.create_instance(
            mode, ns_create_input(name="chani-ns", user="paul").to_dict())
        out = await w.runner.get_result(iid, timeout=15)
        assert out["status"] == 201

        # the failpoint is armed but chani's create conflicts at the
        # SpiceDB precondition before any kube write — exactly like the
        # reference run of this scenario, where the rule preconditions are
        # the ownership guard (its kube-409-on-create path deliberately
        # KEEPS relationships, for crash-resume of one's own landed write)
        failpoints.enable("panicKubeReadResp", 1)
        iid2 = await w.runner.create_instance(
            mode, ns_create_input(name="chani-ns", user="chani").to_dict())
        out2 = await w.runner.get_result(iid2, timeout=15)
        assert out2["status"] == 409
        assert w.has_rel("namespace:chani-ns#creator@user:paul")
        assert not w.has_rel("namespace:chani-ns#creator@user:chani")
        assert not w.engine.check(CheckItem("namespace", "chani-ns", "view",
                                            "user", "chani"))
        assert w.no_leftover_locks()
    asyncio.run(run())


@pytest.mark.parametrize("mode", [LOCK_MODE_PESSIMISTIC, LOCK_MODE_OPTIMISTIC])
@pytest.mark.parametrize("rep", range(5))
def test_single_writer_per_object(mode, rep):
    """Two users race to create the same namespace: exactly one wins,
    the loser gets 409 (pessimistic lock conflict / optimistic
    already-exists), run 5x per lock mode — the reference runs this under
    MustPassRepeatedly(5) (proxy_test.go:866-904)."""
    async def run():
        w = World()
        i1, i2 = await asyncio.gather(
            w.runner.create_instance(
                mode, ns_create_input(name="race-ns", user="paul").to_dict()),
            w.runner.create_instance(
                mode, ns_create_input(name="race-ns", user="chani").to_dict()),
        )
        o1, o2 = await asyncio.gather(
            w.runner.get_result(i1, timeout=20),
            w.runner.get_result(i2, timeout=20),
        )
        statuses = sorted([o1["status"], o2["status"]])
        assert statuses == [201, 409], statuses
        winner = "paul" if o1["status"] == 201 else "chani"
        loser = "chani" if winner == "paul" else "paul"
        assert w.has_rel(f"namespace:race-ns#creator@user:{winner}")
        assert not w.has_rel(f"namespace:race-ns#creator@user:{loser}")
        assert w.no_leftover_locks()
    asyncio.run(run())
