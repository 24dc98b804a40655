"""PyTorch port, open-loop load generation (loadgen/) held against the
JAX package.

Every case of test_loadgen.py runs here on the port (``port_cases``: the
same bodies, its engine and proxy on the CPU): the schedule pins, the
open-loop driver, the sweep and knee math, and the SLO, shed-audit,
LookupSubjects, wildcard and Table cases on the port's proxy. Then the
two packages side by side: the same ``ScheduleConfig`` gives the same
arrivals, compared as exact arrays, and ``run_sweep`` over the same
deterministic ops gives the same curve, knee, saturation flag, burst
windows and SLO attainment (every field that is not a wall-clock
reading).
"""

from __future__ import annotations

import numpy as np
import pytest

from spicedb_kubeapi_proxy_tpu import admission as jadmission
from spicedb_kubeapi_proxy_tpu import loadgen as jloadgen
from spicedb_kubeapi_proxy_tpu_torch import admission as tadmission
from spicedb_kubeapi_proxy_tpu_torch import loadgen as tloadgen
from spicedb_kubeapi_proxy_tpu_torch.loadgen import driver as tdriver

from torch_parity import port_cases

_PORT = "spicedb_kubeapi_proxy_tpu_torch"

_CASES = port_cases("test_loadgen.py", replacements=(
    # the port's engine and proxy run where they are told: the CPU here
    ("e = Engine(schema=parse_schema(SCHEMA))",
     'e = Engine(schema=parse_schema(SCHEMA), device="cpu")'),
    ("rule_content=LIST_RULES, upstream=FakeKube(),",
     'rule_content=LIST_RULES, upstream=FakeKube(), device="cpu",'),
    # the fake upstream over the port's own in-memory kube
    ("    from fake_kube import FakeKube\n",
     "    from torch_parity import fake_kube_class\n"
     f'    FakeKube = fake_kube_class("{_PORT}")\n'),
))
globals().update(_CASES)


def test_every_jax_case_runs_on_the_port():
    assert len(_CASES) == 25
    g = _CASES["test_run_sweep_curve_and_burst_schema"].__globals__
    assert g["run_sweep"] is tloadgen.run_sweep
    assert g["OpenLoopDriver"] is tloadgen.OpenLoopDriver
    assert g["tracer"].__class__.__module__.startswith(_PORT)


def _arrays(schedule) -> dict:
    return {
        "t": np.array([a.t for a in schedule], dtype=np.float64),
        "op": np.array([a.op for a in schedule]),
        "tenant": np.array([a.tenant for a in schedule]),
        "key": np.array([a.key for a in schedule], dtype=np.int64),
        "ns_key": np.array([a.ns_key for a in schedule], dtype=np.int64),
        "phase": np.array([a.phase for a in schedule]),
        "burst": np.array([a.burst for a in schedule], dtype=bool),
    }


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_schedules_are_byte_identical_to_the_jax_package(seed):
    got = tloadgen.build_schedule(tloadgen.trace_shaped_config(
        4.0, 300.0, tenants=8, seed=seed))
    want = jloadgen.build_schedule(jloadgen.trace_shaped_config(
        4.0, 300.0, tenants=8, seed=seed))
    assert len(got) == len(want) > 1000
    g, w = _arrays(got), _arrays(want)
    for k in g:
        assert g[k].dtype == w[k].dtype, k
        assert np.array_equal(g[k], w[k]), k
    # float64 times, bit for bit
    assert g["t"].tobytes() == w["t"].tobytes()
    assert [tuple(vars(a).values()) for a in got] == \
        [tuple(vars(a).values()) for a in want]
    # and the burst windows the sweep slices by
    from spicedb_kubeapi_proxy_tpu.loadgen.schedule import \
        burst_windows as jwindows
    from spicedb_kubeapi_proxy_tpu_torch.loadgen.schedule import \
        burst_windows as twindows
    cfg_t = tloadgen.trace_shaped_config(4.0, 300.0, seed=seed)
    cfg_j = jloadgen.trace_shaped_config(4.0, 300.0, seed=seed)
    assert twindows(cfg_t) == jwindows(cfg_j)


def _sweep(lg, adm) -> dict:
    """``run_sweep`` of package ``lg`` over ops whose outcome is a pure
    function of the arrival and the point: fast answers below 2x, and at
    2x and above three arrivals in four shed (so the knee is crossed and
    interpolated). The SLO is wide, so goodput counts completions."""
    from spicedb_kubeapi_proxy_tpu.loadgen import schedule as jsched

    point = {"m": 0.0}

    def make_config(m):
        point["m"] = m
        return lg.trace_shaped_config(1.0, 120.0 * m, tenants=4, seed=5)

    def op(a):
        if point["m"] >= 2.0 and a.key % 4:
            raise adm.AdmissionRejected("check", "loadgen test",
                                        retry_after=1.0)

    ops = {name: op for name in jsched.DEFAULT_MIX}
    slo = {name: 30.0 for name in ops}
    res = lg.run_sweep(make_config, ops, (0.5, 1.0, 2.0, 3.0), slo,
                       max_workers=8, trace_ops=True, drain_timeout=20.0)
    d = res.to_dict()
    # drop the wall-clock readings: latency quantiles, dispatcher
    # lateness and the windows' epoch stamps
    for pt in d["curve"]:
        pt.pop("late")
        pt["classes"] = sorted(pt["classes"])
    for b in d["bursts"].values():
        b.pop("window_epoch")
        b["classes"] = {op: st["n"] for op, st in b["classes"].items()}
    d.pop("tail_attribution")
    return d


def test_sweep_output_matches_the_jax_package():
    got = _sweep(tloadgen, tadmission)
    want = _sweep(jloadgen, jadmission)
    assert got == want
    assert got["knee_saturated"] is True
    assert got["knee_rps"] is not None
    assert [p["shed"] > 0 for p in got["curve"]] == \
        [False, False, True, True]
    assert set(got["bursts"]) == {"watch-storm", "get-wave", "reconcile"}


def test_driver_metric_families_match_the_jax_package():
    """The driver's metric families carry the JAX package's names and
    labels (the metrics contract of lint/metrics.md)."""
    from spicedb_kubeapi_proxy_tpu.utils.metrics import metrics as jm
    from spicedb_kubeapi_proxy_tpu_torch.utils.metrics import metrics as tm

    cfg_t = tloadgen.ScheduleConfig(duration=0.2, rate=50.0, seed=3,
                                    mix={"check": 1.0})
    cfg_j = jloadgen.ScheduleConfig(duration=0.2, rate=50.0, seed=3,
                                    mix={"check": 1.0})
    rt = tdriver.OpenLoopDriver({"check": lambda a: None}).run(
        tloadgen.build_schedule(cfg_t), duration=0.2)
    rj = jloadgen.OpenLoopDriver({"check": lambda a: None}).run(
        jloadgen.build_schedule(cfg_j), duration=0.2)
    assert rt.fired_n == rj.fired_n > 0
    for reg in (tm, jm):
        assert reg.hist_snapshot("loadgen_op_seconds", op="check") \
            is not None
        assert reg.counter("loadgen_ops_total", op="check",
                           outcome="ok").value >= rt.fired_n


def test_lookup_subjects_matches_the_jax_package():
    """The sweep's lookup-subjects class: the port finds the candidate
    subjects with numpy over the store's columns (``Store.subject_ids``)
    where the JAX package reads one row per tuple; the answers are the
    same over grants, group members, a wildcard and deletes."""
    import random

    from spicedb_kubeapi_proxy_tpu.engine import Engine as JEngine
    from spicedb_kubeapi_proxy_tpu.engine.store import \
        RelationshipFilter as JFilter
    from spicedb_kubeapi_proxy_tpu.engine.store import WriteOp as JWriteOp
    from spicedb_kubeapi_proxy_tpu.models import parse_schema as jparse
    from spicedb_kubeapi_proxy_tpu.models.tuples import \
        parse_relationship as jrel
    from spicedb_kubeapi_proxy_tpu_torch.engine import Engine
    from spicedb_kubeapi_proxy_tpu_torch.engine.store import (
        RelationshipFilter,
        WriteOp,
    )
    from spicedb_kubeapi_proxy_tpu_torch.models import parse_schema
    from spicedb_kubeapi_proxy_tpu_torch.models.tuples import \
        parse_relationship

    schema = _CASES["test_identical_seed_identical_schedule"] \
        .__globals__["SCHEMA"]
    rng = random.Random(3)
    tuples = sorted({f"namespace:ns{rng.randrange(6)}#viewer@user:"
                     f"u{rng.randrange(20)}" for _ in range(40)}
                    | {f"group:g{rng.randrange(3)}#member@user:"
                       f"u{rng.randrange(20)}" for _ in range(12)}
                    | {f"namespace:ns{i}#viewer@group:g{i % 3}#member"
                       for i in range(0, 6, 2)}
                    | {"namespace:ns5#viewer@user:*"})
    gone = tuples[::5]
    te = Engine(schema=parse_schema(schema), device="cpu")
    je = JEngine(schema=jparse(schema))
    te.write_relationships([WriteOp("touch", parse_relationship(t))
                            for t in tuples])
    je.write_relationships([JWriteOp("touch", jrel(t)) for t in tuples])
    for t in gone:
        r = parse_relationship(t)
        kw = dict(resource_type=r.resource_type, resource_id=r.resource_id,
                  relation=r.relation, subject_type=r.subject_type,
                  subject_id=r.subject_id)
        te.delete_relationships(RelationshipFilter(**kw))
        je.delete_relationships(JFilter(**kw))
    for st in ("user", "group", "nosuch"):
        assert te.store.subject_ids(st) == sorted({
            r.subject_id for r in je.read_relationships(
                JFilter(subject_type=st))})
    for i in range(6):
        assert te.lookup_subjects("namespace", f"ns{i}", "view", "user") \
            == je.lookup_subjects("namespace", f"ns{i}", "view", "user")


def test_a_bulk_check_of_many_subjects_splits_and_matches_jax(monkeypatch):
    """A chunk whose distinct subjects need more row-slots than
    ``Engine.CHECK_MAX_ROW_SLOTS`` dispatches in parts, by subject: the
    verdicts, in the caller's order, are the JAX package's."""
    import random

    from spicedb_kubeapi_proxy_tpu.engine import CheckItem as JItem
    from spicedb_kubeapi_proxy_tpu.engine import Engine as JEngine
    from spicedb_kubeapi_proxy_tpu.engine.store import WriteOp as JWriteOp
    from spicedb_kubeapi_proxy_tpu.models import parse_schema as jparse
    from spicedb_kubeapi_proxy_tpu.models.tuples import \
        parse_relationship as jrel
    from spicedb_kubeapi_proxy_tpu_torch.engine import (
        CheckItem,
        Engine,
        WriteOp,
    )
    from spicedb_kubeapi_proxy_tpu_torch.models import parse_schema
    from spicedb_kubeapi_proxy_tpu_torch.models.tuples import \
        parse_relationship
    from spicedb_kubeapi_proxy_tpu_torch.utils.metrics import metrics

    schema = _CASES["test_identical_seed_identical_schedule"] \
        .__globals__["SCHEMA"]
    rng = random.Random(5)
    tuples = sorted({f"namespace:ns{rng.randrange(8)}#viewer@user:"
                     f"u{rng.randrange(40)}" for _ in range(60)}
                    | {f"group:g{rng.randrange(4)}#member@user:"
                       f"u{rng.randrange(40)}" for _ in range(20)}
                    | {"namespace:ns1#viewer@group:g1#member",
                       "namespace:ns7#viewer@user:*"})
    te = Engine(schema=parse_schema(schema), device="cpu")
    je = JEngine(schema=jparse(schema))
    te.write_relationships([WriteOp("touch", parse_relationship(t))
                            for t in tuples])
    je.write_relationships([JWriteOp("touch", jrel(t)) for t in tuples])
    args = [("namespace", f"ns{rng.randrange(8)}", "view", "user",
             f"u{rng.randrange(45)}") for _ in range(300)]
    want = je.check_bulk([JItem(*a) for a in args])
    M = te.compiled().M
    monkeypatch.setattr(Engine, "CHECK_MAX_ROW_SLOTS", 7 * M)
    n0 = metrics.counter("engine_checks_total").value
    assert te.check_bulk([CheckItem(*a) for a in args]) == want
    assert metrics.counter("engine_checks_total").value - n0 == len(args)
    for i in range(8):
        assert te.lookup_subjects("namespace", f"ns{i}", "view", "user") \
            == je.lookup_subjects("namespace", f"ns{i}", "view", "user")


RICH_SCHEMA = """
use expiration

caveat lvl(level int) {
  level < 3
}

definition user {}

definition group {
  relation member: user | group#member | user:*
  relation banned: user
  permission active = member - banned
}

definition folder {
  relation parent: folder
  relation owner: user | group#member
  relation viewer: user | group#member | user:* | user with lvl | user with expiration
  relation editor: user | group#active
  permission edit = owner + editor
  permission view = viewer + edit + parent->view
  permission both = viewer & editor
  permission only = view - editor
  permission deep = parent->edit + parent->only
}
"""


def _rich_tuples(rng, now: float) -> list:
    from datetime import datetime, timezone

    def stamp(t):
        return datetime.fromtimestamp(t, timezone.utc).strftime(
            "%Y-%m-%dT%H:%M:%SZ")

    out = set()
    for _ in range(14):
        out.add(f"group:g{rng.randrange(4)}#member@user:u{rng.randrange(12)}")
    out.add(f"group:g{rng.randrange(4)}#member@group:g{rng.randrange(4)}"
            "#member")
    out.add(f"group:g{rng.randrange(4)}#banned@user:u{rng.randrange(12)}")
    for f in range(8):
        if f:
            out.add(f"folder:f{f}#parent@folder:f{rng.randrange(f)}")
        out.add(f"folder:f{f}#owner@user:u{rng.randrange(12)}")
        out.add(f"folder:f{f}#viewer@group:g{rng.randrange(4)}#member")
        out.add(f"folder:f{f}#editor@user:u{rng.randrange(12)}")
        out.add(f"folder:f{f}#editor@group:g{rng.randrange(4)}#active")
        out.add(f"folder:f{f}#viewer@user:u{rng.randrange(12)}"
                f"[lvl:{{\"level\": {rng.randrange(6)}}}]")
        out.add(f"folder:f{f}#viewer@user:u{rng.randrange(12)}"
                f"[expiration:{stamp(now + rng.choice((-3600, 3600)))}]")
    if rng.random() < 0.5:
        out.add(f"folder:f{rng.randrange(8)}#viewer@user:*")
    if rng.random() < 0.5:
        out.add(f"group:g{rng.randrange(4)}#member@user:*")
    # one tuple a relationship (a caveat or an expiration is not a key)
    return sorted({t.split("[")[0]: t for t in sorted(out)}.values())


@pytest.mark.parametrize("seed", range(6))
def test_lookup_subjects_candidates_hold_over_a_rich_schema(seed):
    """Usersets, arrows, an intersection, exclusions, a caveat, expiring
    grants, wildcards and deletes: the port's schema-guided candidates
    give the JAX package's answers for every (folder, permission) and
    subject shape."""
    import random
    import time as _time

    from spicedb_kubeapi_proxy_tpu.engine import Engine as JEngine
    from spicedb_kubeapi_proxy_tpu.engine.store import WriteOp as JWriteOp
    from spicedb_kubeapi_proxy_tpu.models.tuples import \
        parse_relationship as jrel
    from spicedb_kubeapi_proxy_tpu_torch.engine import Engine, WriteOp
    from spicedb_kubeapi_proxy_tpu_torch.models.tuples import \
        parse_relationship

    boot = "schema: |-\n" + "\n".join(
        "  " + ln for ln in RICH_SCHEMA.strip().splitlines()) \
        + "\nrelationships: \"\"\n"
    rng = random.Random(seed)
    now = _time.time()
    tuples = _rich_tuples(rng, now)
    te = Engine(bootstrap=boot, device="cpu")
    je = JEngine(bootstrap=boot)
    te.write_relationships([WriteOp("touch", parse_relationship(t))
                            for t in tuples])
    je.write_relationships([JWriteOp("touch", jrel(t)) for t in tuples])
    gone = rng.sample(tuples, 4)
    te.write_relationships([WriteOp("delete", parse_relationship(t))
                            for t in gone])
    je.write_relationships([JWriteOp("delete", jrel(t)) for t in gone])
    ctx = {"level": 1}
    for f in range(9):  # f8 does not exist
        for perm in ("view", "edit", "both", "only", "deep", "parent"):
            for st, srel in (("user", None), ("group", "member"),
                             ("group", "active")):
                got = te.lookup_subjects("folder", f"f{f}", perm, st, srel,
                                         now=now, context=ctx)
                want = je.lookup_subjects("folder", f"f{f}", perm, st,
                                          srel, now=now, context=ctx)
                assert got == want, (f, perm, st, srel)
    # from a group: the start object is a subject of the asked type
    for g in range(5):  # g4 does not exist
        for perm in ("member", "active", "banned"):
            for st, srel in (("user", None), ("group", "member"),
                             ("group", "active")):
                got = te.lookup_subjects("group", f"g{g}", perm, st, srel,
                                         now=now, context=ctx)
                want = je.lookup_subjects("group", f"g{g}", perm, st, srel,
                                          now=now, context=ctx)
                assert got == want, (g, perm, st, srel)


@pytest.mark.parametrize("nested", [False, True])
def test_lookup_subjects_of_a_group_names_itself_only_as_a_subject(nested):
    """``group:g1#member`` holds ``member`` on ``group:g1``, but both
    packages report g1 only when some tuple names it as a subject: never
    without nesting, and with it once ``group:g1#member`` is granted
    elsewhere."""
    from spicedb_kubeapi_proxy_tpu.engine import Engine as JEngine
    from spicedb_kubeapi_proxy_tpu.engine.store import WriteOp as JWriteOp
    from spicedb_kubeapi_proxy_tpu.models.tuples import \
        parse_relationship as jrel
    from spicedb_kubeapi_proxy_tpu_torch.engine import Engine, WriteOp
    from spicedb_kubeapi_proxy_tpu_torch.models.tuples import \
        parse_relationship

    boot = "schema: |-\n" + "\n".join(
        "  " + ln for ln in RICH_SCHEMA.strip().splitlines()) \
        + "\nrelationships: \"\"\n"
    tuples = ["group:g1#member@user:u1", "group:g2#member@user:u2"]
    if nested:
        tuples.append("folder:f0#viewer@group:g1#member")
    te = Engine(bootstrap=boot, device="cpu")
    je = JEngine(bootstrap=boot)
    te.write_relationships([WriteOp("touch", parse_relationship(t))
                            for t in tuples])
    je.write_relationships([JWriteOp("touch", jrel(t)) for t in tuples])
    got = te.lookup_subjects("group", "g1", "member", "group", "member")
    assert got == je.lookup_subjects("group", "g1", "member", "group",
                                     "member")
    assert got == (["g1"] if nested else [])
