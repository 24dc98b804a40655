"""PyTorch port, the chaos plane (chaos/, the engine host's flag-gated
``chaos_*`` ops) held against the JAX package.

Every case of test_chaos.py runs here on the port (``port_cases``: the
same bodies, its engines and proxy on the CPU): upstream retries, engine
breakers, and the mirror's partition and heartbeat failpoints. So does
every case of test_chaos_campaign.py: the failpoint env hardening, the
schedule digest pinned at ``BROWNOUT_SEED0_DIGEST``, the fault actions,
the flag-gated wire ops against a port host, the retry budgets at every
layer, the Retry-After audit, the invariant checkers and the in-process
campaign (``device="cpu"``). Its three subprocess compositions spawn the
port's host CLI with ``--device cpu`` and stay ``slow``, as in the JAX
suite.

Then the two packages side by side: a schedule encoded by either package
arms a host of the other to the same digest, and the same request
sequence leaves the same fault history; the checkers agree case for case
on the same records; and a shrink whose retiring group cannot take its
GC drop completes in the port, where the JAX mover parks.
"""

from __future__ import annotations

import random

import pytest

from spicedb_kubeapi_proxy_tpu import chaos as jchaos
from spicedb_kubeapi_proxy_tpu.chaos import invariants as jinv
from spicedb_kubeapi_proxy_tpu.engine import Engine as JEngine
from spicedb_kubeapi_proxy_tpu.utils.failpoints import \
    failpoints as jfailpoints
from spicedb_kubeapi_proxy_tpu_torch import chaos as tchaos
from spicedb_kubeapi_proxy_tpu_torch.chaos import campaign as tcampaign
from spicedb_kubeapi_proxy_tpu_torch.chaos import invariants as tinv
from spicedb_kubeapi_proxy_tpu_torch.engine import Engine
from spicedb_kubeapi_proxy_tpu_torch.engine import remote
from spicedb_kubeapi_proxy_tpu_torch.utils.failpoints import failpoints

from torch_parity import package, port_cases, serving

_PORT = "spicedb_kubeapi_proxy_tpu_torch"

_CHAOS = port_cases("test_chaos.py", replacements=(
    # the port's engines run where they are told: the CPU here
    ("Engine()", 'Engine(device="cpu")'),
    ('            upstream_url=f"http://127.0.0.1:{upstream_port}",\n'
     '            workflow_database_path=str(tmp_path / "dtx.sqlite"),\n'
     '        ).complete()',
     '            upstream_url=f"http://127.0.0.1:{upstream_port}",\n'
     '            workflow_database_path=str(tmp_path / "dtx.sqlite"),\n'
     '            device="cpu",\n'
     '        ).complete()'),
    # an in-process upstream is the port's own in-memory kube (the HTTP
    # ones stay the test suite's FakeKube behind its loopback server)
    ("from fake_kube import FakeKube, serve_upstream\n",
     "from fake_kube import FakeKube, serve_upstream\n"
     "from torch_parity import fake_kube_class\n"
     f'PortFakeKube = fake_kube_class("{_PORT}")\n'),
    ("            upstream=FakeKube(),\n"
     '            workflow_database_path=str(tmp_path / "dtx.sqlite"),\n'
     "            engine_retries=0,",
     "            upstream=PortFakeKube(),\n"
     '            workflow_database_path=str(tmp_path / "dtx.sqlite"),\n'
     "            engine_retries=0,"),
))

_CAMPAIGN = port_cases("test_chaos_campaign.py", replacements=(
    ("Engine()", 'Engine(device="cpu")'),
    ("Engine(bootstrap=SHARD_SCHEMA)",
     'Engine(bootstrap=SHARD_SCHEMA, device="cpu")'),
    ('inproc=True,', 'inproc=True, device="cpu",'),
    # the subprocess topologies spawn the port's host CLI on the CPU
    ('cfg = CampaignConfig(seeds=(0,), episodes="short",\n'
     '                         workdir=str(tmp_path))',
     'cfg = CampaignConfig(seeds=(0,), episodes="short",\n'
     '                         workdir=str(tmp_path), device="cpu")'),
    ("SubprocessTopology(workdir=str(tmp_path))",
     'SubprocessTopology(workdir=str(tmp_path), device="cpu")'),
))


def _fixture(cases, name):
    return next(iter(cases.values())).__globals__[name]


globals().update(_CHAOS)
globals().update(_CAMPAIGN)


@pytest.fixture(autouse=True)
def _clean_slate():
    """Both JAX suites' autouse fixture (failpoints disarmed, metrics
    reset around every case), for the port's registries and the JAX
    ones the cross-package cases arm."""
    from spicedb_kubeapi_proxy_tpu.utils.metrics import metrics as jm
    from spicedb_kubeapi_proxy_tpu_torch.utils.metrics import metrics as tm

    for reg in (failpoints, jfailpoints):
        reg.disable_all()
    tm.reset()
    jm.reset()
    yield
    for reg in (failpoints, jfailpoints):
        reg.disable_all()
    tm.reset()
    jm.reset()


BROWNOUT_SEED0_DIGEST = _fixture(_CAMPAIGN, "BROWNOUT_SEED0_DIGEST")
_SLOW = ("test_subprocess_campaign_one_seed",
         "test_sharded_watch_resumes_across_group_leader_sigkill",
         "test_watch_resumes_across_leader_sigkill_in_dual_write_window")


def test_every_jax_case_runs_on_the_port():
    assert len(_CHAOS) == 13
    assert len(_CAMPAIGN) == 22
    for name in _SLOW:
        assert any(m.name == "slow"
                   for m in getattr(_CAMPAIGN[name], "pytestmark", []))
    assert sum(1 for n in _CAMPAIGN if n not in _SLOW) == 19
    g = _CAMPAIGN["test_inproc_campaign_one_seed_zero_violations"] \
        .__globals__
    assert g["Campaign"] is tcampaign.Campaign
    assert g["EngineServer"] is remote.EngineServer
    assert g["failpoints"] is failpoints


def test_the_port_pins_the_same_seed0_digest():
    assert tchaos.brownout_schedule(0).digest() == BROWNOUT_SEED0_DIGEST
    for seed in range(6):
        assert tchaos.brownout_schedule(seed).digest() == \
            jchaos.brownout_schedule(seed).digest()
        assert tchaos.brownout_schedule(seed).encode() == \
            jchaos.brownout_schedule(seed).encode()


def test_subprocess_host_argv_is_the_port_cli():
    argv = tcampaign._host_argv("b.yaml", 1, [11, 12], "/d", "cpu")
    assert argv[1:3] == ["-m", f"{_PORT}.engine.remote"]
    assert argv[argv.index("--bind-port") + 1] == "12"
    assert argv[argv.index("--peers") + 1] == "127.0.0.1:11,127.0.0.1:12"
    for flag in ("--enable-chaos-ops", "--min-sync-replicas",
                 "--mirror-heartbeat-seconds", "--failover-boot-grace"):
        assert flag in argv
    assert argv[-2:] == ["--device", "cpu"]
    # the card is the default: no --device then
    assert "--device" not in tcampaign._host_argv("b", 0, [1, 2], "/d",
                                                  "cuda")


def test_campaign_on_cuda_without_a_card_raises(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tcampaign.Campaign(tcampaign.CampaignConfig(
            seeds=(0,), inproc=True, workdir=str(tmp_path)))


# -- the wire form across packages -----------------------------------------


_SCHED = {"seed": 11, "faults": [
    {"site": "engine.dispatch", "action": "error", "p": 0.5,
     "budget": 40},
    {"site": "engine.respond", "action": "drop", "p": 0.25,
     "budget": 40}]}


def _arm_and_drive(host_pkg: str, sched_pkg: str):
    """Arm a host of ``host_pkg`` with the schedule as ``sched_pkg``
    encodes it, send 24 revision requests, and return (the arm answer,
    each request's outcome, the host's chaos status)."""
    P = package(host_pkg)
    S = {"jax": jchaos, "torch": tchaos}[sched_pkg]
    sched = S.FaultSchedule.parse(_SCHED)
    eng = Engine(device="cpu") if host_pkg == "torch" else JEngine()
    with serving(P.EngineServer, eng, allow_chaos=True) as srv:
        c = P.RemoteEngine("127.0.0.1", srv.port, retries=0, timeout=0.5,
                           connect_timeout=2.0)
        try:
            armed = c.chaos_arm(sched.encode())
            outcomes = []
            for _ in range(24):
                try:
                    c.revision
                    outcomes.append("ok")
                except Exception as e:  # noqa: BLE001 - the fault's kind
                    outcomes.append(type(e).__name__)
                    c.close()
                    c = P.RemoteEngine("127.0.0.1", srv.port, retries=0,
                                       timeout=0.5, connect_timeout=2.0)
            status = c.chaos_status()
            c.chaos_reset()
        finally:
            c.close()
    return sched.digest(), armed, outcomes, status


@pytest.mark.parametrize("sched_pkg,host_pkg",
                         [("jax", "torch"), ("torch", "jax")])
def test_a_schedule_arms_the_other_package_to_the_same_digest(
        sched_pkg, host_pkg):
    digest, armed, outcomes, status = _arm_and_drive(host_pkg, sched_pkg)
    same_digest, same_armed, same_outcomes, same_status = \
        _arm_and_drive(sched_pkg, sched_pkg)
    assert armed["digest"] == digest == same_armed["digest"]
    assert armed["armed"] == same_armed["armed"] == [
        "engine.dispatch", "engine.respond"]
    # the same request sequence performs the same faults, in order
    assert "ok" in outcomes and set(outcomes) != {"ok"}
    assert outcomes == same_outcomes
    assert [tuple(h) for h in status["history"]] == \
        [tuple(h) for h in same_status["history"]]
    assert status["history_digest"] == same_status["history_digest"]


@pytest.mark.parametrize("op", ["chaos_arm", "chaos_reset", "chaos_status"])
def test_a_host_without_the_flag_refuses_as_the_jax_host(op):
    """Each package's client against each package's host without
    --enable-chaos-ops: the same exception kind and text."""
    def refusal(host_pkg, client_pkg):
        H, C = package(host_pkg), package(client_pkg)
        eng = Engine(device="cpu") if host_pkg == "torch" else JEngine()
        with serving(H.EngineServer, eng) as srv:
            c = C.RemoteEngine("127.0.0.1", srv.port, retries=0)
            try:
                with pytest.raises(C.StoreError) as exc:
                    getattr(c, op)(*([_SCHED] if op == "chaos_arm"
                                     else []))
            finally:
                c.close()
        return type(exc.value).__name__, str(exc.value)

    for client in ("torch", "jax"):
        got = refusal("torch", client)
        assert got == refusal("jax", client)
        assert "boot with --enable-chaos-ops" in got[1]


# -- the checkers, case for case -------------------------------------------


def _records(inv, rng: random.Random, n: int) -> list:
    kinds = [inv.KIND_CHECK, inv.KIND_WRITE, inv.KIND_DELETE,
             inv.KIND_LOOKUP, inv.KIND_MIGRATION_PROBE]
    outcomes = [inv.OUTCOME_OK, inv.OUTCOME_SHED, inv.OUTCOME_ERROR]
    out = []
    for seq in range(n):
        kind = rng.choice(kinds)
        out.append(inv.OpRecord(
            kind, rng.choice(outcomes), seq=rng.randrange(2 * n),
            key=f"k{rng.randrange(4)}",
            verdict=rng.choice([None, True, False]),
            expected=rng.choice([None, True, False]),
            rel=f"r{rng.randrange(6)}", shards=(rng.randrange(2),),
            retry_after=rng.choice([None, 0.0, 1.0, 90.0])))
    return out


def _evidence(inv, seed: int):
    rng = random.Random(seed)
    return inv.EpisodeEvidence(
        name=f"e{seed}", records=_records(inv, rng, 40),
        readback={f"r{i}": rng.random() < 0.8 for i in range(5)},
        pending_splits=rng.choice([None, 0, 2]),
        retries_observed=rng.choice([None, 5.0, 500.0]),
        budget_ratio=0.1, budget_burst=20.0, attempts=rng.choice(
            [None, 100]),
        rebalance_transition=rng.choice([
            None, {"phase": "done"},
            {"phase": "copying", "slices": [{"state": "cut"}, {}]}]),
        migration_affected=frozenset({"k0"}),
        migration_status=rng.choice([
            None, {"phase": "done"}, {"phase": "dual", "error": "x"}]))


@pytest.mark.parametrize("seed", range(12))
def test_checkers_agree_with_the_jax_package(seed):
    got = [str(v) for v in tinv.check_all(_evidence(tinv, seed))]
    want = [str(v) for v in jinv.check_all(_evidence(jinv, seed))]
    assert got == want
    assert tinv.retry_amplification_bound(0.1, 20.0, seed) == \
        jinv.retry_amplification_bound(0.1, 20.0, seed)


# -- a shrink whose retiring group refuses its GC drop ---------------------


def _shrink_with_a_refusing_retiree(pkg: str, error=None) -> tuple:
    """Two in-process groups; the retiring one answers every slice_drop
    with ``error(P)``, by default the min-sync refusal a host whose peer
    was killed gives."""
    P = package(pkg)
    if error is None:
        def error(P):
            return P.StoreError("only 0 live replica(s), below the "
                                "min-sync-replicas floor of 1")
    schema = _fixture(_CAMPAIGN, "SHARD_SCHEMA")
    engines = [P.engine(schema) for _ in range(2)]

    class Retiring:
        def __init__(self, inner):
            self._inner = inner

        def __getattr__(self, name):
            return getattr(self._inner, name)

        def slice_drop(self, ranges):
            raise error(P)

        @property
        def revision(self):
            return self._inner.revision

        @property
        def store(self):
            return self._inner.store

    smap = P.ShardMap(version=1, groups=((("127.0.0.1", 1),),
                                         (("127.0.0.1", 2),)))
    planner = P.ShardedEngine(smap, [engines[0], Retiring(engines[1])])
    ns = [f"ns{i}" for i in range(16)]
    planner.write_relationships([
        P.WriteOp("create", P.Relationship("pod", f"{n}/p0", "viewer",
                                           "user", "al", None))
        for n in ns])
    mover = planner.begin_rebalance(P.shrink_map(planner.map))
    mover.wait(30)
    ids = sorted(planner.lookup_resources("pod", "view", "user", "al"))
    out = (planner.map.version, len(planner.groups),
           type(mover.error).__name__ if mover.error else None, ids)
    planner.close()
    return out


def test_a_retiring_group_that_refuses_gc_still_shrinks():
    version, groups, error, ids = _shrink_with_a_refusing_retiree("torch")
    assert (version, groups, error) == (2, 1, None)
    assert ids == sorted(f"ns{i}/p0" for i in range(16))
    # the JAX mover parks the shrink before its commit (ROADMAP §C)
    jversion, jgroups, jerror, jids = \
        _shrink_with_a_refusing_retiree("jax")
    assert (jversion, jgroups, jerror) == (1, 2, "StoreError")
    assert jids == ids


def test_a_retiring_group_nobody_listens_at_still_shrinks():
    """A retiring group whose hosts are all gone refuses the connection:
    the port skips its GC and commits; the JAX package parks."""
    def refused(P):
        return ConnectionRefusedError(111, "Connection refused")

    assert _shrink_with_a_refusing_retiree("torch", refused)[:3] == \
        (2, 1, None)
    assert _shrink_with_a_refusing_retiree("jax", refused)[:3] == \
        (1, 2, "ConnectionRefusedError")


@pytest.mark.parametrize("error", [
    lambda P: TimeoutError("timed out"),
    lambda P: P.StoreError("permission denied"),
    lambda P: RuntimeError("a fault inside slice_drop"),
], ids=["timeout", "other-store-error", "bug"])
def test_a_retiring_group_with_another_gc_failure_parks_the_shrink(error):
    """Only the sync-floor refusal and a refused connection let a shrink
    skip its retiring group's GC: any other failure parks the shrink
    before its commit in the port as in the JAX package."""
    want_type = type(error(package("torch"))).__name__
    for pkg in ("torch", "jax"):
        version, groups, err, ids = _shrink_with_a_refusing_retiree(
            pkg, error)
        assert (version, groups, err) == (1, 2, want_type), pkg
        assert ids == sorted(f"ns{i}/p0" for i in range(16)), pkg


# -- the elastic episode's SIGKILL lands on the retiring group -------------


def test_subprocess_topology_finds_a_group_by_its_endpoints():
    topo = object.__new__(tcampaign.SubprocessTopology)
    topo.ports = [[11, 12], [21, 22], [31, 32], [41, 42]]
    assert topo.group_index((("127.0.0.1", 41), ("127.0.0.1", 42))) == 3
    assert topo.group_index([["127.0.0.1", 21], ["127.0.0.1", 22]]) == 1
    with pytest.raises(KeyError):
        topo.group_index((("127.0.0.1", 51), ("127.0.0.1", 52)))


class _SkewedCrashTopology(tcampaign.InprocTopology):
    """In-process groups that take kills (recorded; nothing dies) and
    number their groups one above the planner's index, as a subprocess
    topology does from the second seed on, once the first seed's shrink
    has retired a group."""

    supports_crash = True

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.killed = []

    def group_index(self, endpoints) -> int:
        (_host, port), = endpoints
        return port  # a placeholder port is the planner's index + 1

    def kill_group_leader(self, g):
        self.killed.append(g)
        return g, 0


def test_the_elastic_shrink_kills_the_retiring_groups_leader(tmp_path):
    camp = tcampaign.Campaign(tcampaign.CampaignConfig(
        seeds=(0,), inproc=True, device="cpu", workdir=str(tmp_path)))
    topo = camp.topology = _SkewedCrashTopology(str(tmp_path), "cpu")
    planner = topo.make_planner()
    try:
        camp._seed_static()
        camp.elastic_episode(0, tcampaign._SeedState())
    finally:
        topo.close()
    ev = camp.result["episodes"][-1]
    assert [(t["phase"], t["converged"]) for t in ev["transitions"]] \
        == [("grow", True), ("shrink", True), ("regrow", True)]
    # the grow appended planner group 2 at placeholder port 3; the
    # shrink retired it, so the kill names topology group 3, never the
    # planner's index 2 (a live group from the second seed on)
    assert topo.killed == [3]
    assert ev["killed"] == "group3/peer0"
    assert camp.violations == []
    assert len(planner.groups) == 3
