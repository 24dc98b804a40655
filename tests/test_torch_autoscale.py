"""PyTorch port, elastic scale-out (autoscale/ and the shrink half of
scaleout/rebalance.py), held against the JAX package.

``parse_policy`` and ``AutoscalePolicy.observe`` over one ``Signals``
sequence decide the same on both packages; the shrink cases of
test_autoscale.py (component removal, token translation, grow -> shrink
round trips, a shrink crashed after its first cut, archive retirement)
run through one body on both, with equal end states; the controller in
``apply`` mode drives a real grow and a real shrink on port engines (and
over port engine hosts, on their own ``load_status`` probes); every
``--autoscale*`` option is validated as the JAX package validates it,
and /readyz shows the ``autoscale`` line.
"""

from __future__ import annotations

import asyncio
import os
import random
import time

import pytest

from torch_parity import counter, package, serving

JAX, PORT = package("jax"), package("torch")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCHEMA_YAML = """\
schema: |-
  definition user {}

  definition namespace {
    relation viewer: user
    permission view = viewer
  }

  definition pod {
    relation namespace: namespace
    relation viewer: user
    permission view = viewer + namespace->view
  }
relationships: ""
"""


def both(fn, *args, **kw):
    got = {P.name: fn(P, *args, **kw) for P in (JAX, PORT)}
    assert got["torch"] == got["jax"]
    return got["torch"]


def _map(P, n: int, version: int = 1):
    return P.ShardMap(version=version,
                      groups=tuple((("127.0.0.1", 0),) for _ in range(n)))


def _seed_writes(P, n_ns: int, users: int = 4) -> list:
    out = []
    for i in range(n_ns):
        for rt, rid, rl, st, sid in (
                ("namespace", f"ns{i}", "viewer", "user", f"u{i % users}"),
                ("pod", f"ns{i}/p0", "namespace", "namespace", f"ns{i}"),
                ("pod", f"ns{i}/p0", "viewer", "user", f"u{i % users}")):
            out.append(P.WriteOp("create", P.Relationship(rt, rid, rl, st,
                                                          sid)))
    return out


def _stores(P, engines) -> list:
    return [sorted(r.key() for r in e.read_relationships(
        P.RelationshipFilter())) for e in engines]


def _wait_gc(p, budget: float = 30.0) -> None:
    deadline = time.monotonic() + budget
    while time.monotonic() < deadline:
        if all(t.gc_complete for t in p._archived_transitions):
            return
        time.sleep(0.01)
    raise AssertionError("archived transitions never finished GC")


def _exact(P, p, n_ns: int) -> list:
    out = []
    for i in range(n_ns):
        ok = p.check(P.CheckItem("pod", f"ns{i}/p0", "view", "user",
                                 f"u{i % 4}"))
        bad = p.check(P.CheckItem("pod", f"ns{i}/p0", "view", "user",
                                  "intruder"))
        assert ok and not bad, i
        out.append((ok, bad))
    return out


# -- the policy kernel --------------------------------------------------------


def test_policy_decides_the_same_on_one_signal_sequence():
    rng = random.Random(20)
    seq = []
    for i in range(400):
        seq.append(dict(
            n_groups=rng.randint(1, 6),
            occupancy=rng.choice([0.0, 0.1, 0.29, 0.3, 0.5, 0.79, 0.8,
                                  0.95]),
            burn_rate=rng.choice([0.0, 0.5, 1.0, 1.5, 2.0, 5.0]),
            latency_ms=rng.choice([0.0, 10.0, 60.0]),
            rebalance_active=rng.random() < 0.05,
            gc_pending=rng.random() < 0.05))
    specs = ("", "max_groups=3,hysteresis_ticks=2,cooldown_seconds=0",
             "min_groups=2,max_groups=5,grow_latency_ms=50,"
             "hysteresis_ticks=1,cooldown_seconds=7.5",
             "grow_occupancy=0.7,shrink_occupancy=0.2,grow_burn=3")

    def run(P):
        out = []
        for spec in specs:
            cfg = P.parse_policy(spec)
            pol = P.AutoscalePolicy(cfg)
            for i, s in enumerate(seq):
                prop = pol.observe(P.Signals(**s), now=float(i))
                out.append(None if prop is None else
                           (prop.action, prop.target_groups, prop.reason))
        return out

    got = both(run)
    assert {p[0] for p in got if p} == {"grow", "shrink"}


def test_policy_hysteresis_cooldown_and_guards():
    def run(P):
        pol = P.AutoscalePolicy(P.PolicyConfig(
            min_groups=1, max_groups=4, hysteresis_ticks=3,
            cooldown_seconds=100.0))
        hot = P.Signals(n_groups=2, occupancy=0.9)
        cold = P.Signals(n_groups=2, occupancy=0.1)
        seq = [pol.observe(s, now=t) for t, s in enumerate(
            (hot, hot, cold, hot, hot, hot, hot, hot, hot, hot))]
        assert seq[:5] == [None] * 5
        assert seq[5] is not None and seq[5].action == "grow"
        assert seq[6:] == [None] * 4
        assert pol.observe(hot, now=106.0) is not None
        g = P.AutoscalePolicy(P.PolicyConfig(
            min_groups=1, max_groups=3, hysteresis_ticks=1,
            cooldown_seconds=0.0))
        out = [g.observe(P.Signals(n_groups=2, occupancy=0.05,
                                   burn_rate=1.5), now=0.0),
               g.observe(P.Signals(n_groups=2, occupancy=0.05,
                                   burn_rate=0.2), now=1.0),
               g.observe(P.Signals(n_groups=1, occupancy=0.0), now=2.0),
               g.observe(P.Signals(n_groups=3, occupancy=0.99), now=3.0)]
        assert out[0] is None and out[1].action == "shrink"
        assert out[2] is None and out[3] is None
        return [None if p is None else (p.action, p.target_groups)
                for p in seq + out]

    both(run)


def test_policy_parsing_and_validation():
    def run(P):
        cfg = P.parse_policy("max_groups=6,grow_occupancy=0.7,"
                             "hysteresis_ticks=2")
        assert (cfg.max_groups, cfg.grow_occupancy, cfg.hysteresis_ticks,
                cfg.cooldown_seconds) == (6, 0.7, 2, 300.0)
        msgs = []
        for spec in ("bogus_knob=1", "max_groups=lots", "min_groups=5,"
                     "max_groups=2", "grow_occupancy=0.5,"
                     "shrink_occupancy=0.6", "hysteresis_ticks=0",
                     "cooldown_seconds=-1", "grow_burn=0",
                     "grow_latency_ms=-1", "grow_occupancy=1.5"):
            with pytest.raises(P.AutoscaleError) as ei:
                P.parse_policy(spec)
            msgs.append(str(ei.value))
        return msgs

    msgs = both(run)
    for m, want in zip(msgs, ("unknown", "bad autoscale", "min_groups",
                              "thrash", "hysteresis")):
        assert want in m


# -- shrink: component removal and token translation -------------------------


def test_drop_component_units():
    def run(P):
        v = P.RevisionVector((5, 7, 9))
        assert v.drop_component(2) == (5, 7)
        assert v.drop_component(0) == (7, 9)
        assert isinstance(v.drop_component(1), P.RevisionVector)
        msgs = []
        for i in (3, -1):
            with pytest.raises(P.ShardMapError) as ei:
                v.drop_component(i)
            msgs.append(str(ei.value))
        assert all("drop component" in m for m in msgs)
        return msgs

    both(run)


def test_shrink_token_translation():
    def run(P):
        engines = [P.engine(SCHEMA_YAML), P.engine(SCHEMA_YAML)]
        p = P.ShardedEngine(_map(P, 2), engines)
        p.write_relationships(_seed_writes(P, 12))
        tok_at = p.revision_vector().encode(map_version=1)
        coord = p.begin_rebalance(P.shrink_map(p.map))
        assert coord.wait(90) and coord.error is None
        assert p.map.version == 2 and len(p.groups) == 1
        assert len(p.revision_vector()) == 1
        t = p._archived_transitions[-1]
        assert t.retire == 1 and t.retire_cut is not None
        replay = p.watch_since(tok_at)
        msgs = []
        for tok, exc in (("v0.0@m1", P.StoreError),
                         ("v0.0@m9", P.ShardMapError),
                         ("v0.0.0.0", P.ShardMapError)):
            with pytest.raises(exc) as ei:
                p.watch_since(tok)
            msgs.append(str(ei.value))
        assert "predates the shrink" in msgs[0]
        assert "no transition" in msgs[1]
        assert "no recorded transition" in msgs[2]
        out = (t.retire_cut, [e.relationship.key() for e in replay], msgs,
               _stores(P, engines))
        p.close()
        return out

    both(run)


def test_grow_then_shrink_round_trip():
    def run(P):
        n_ns = 16
        engines = [P.engine(SCHEMA_YAML), P.engine(SCHEMA_YAML)]
        p = P.ShardedEngine(_map(P, 2), engines)
        p.write_relationships(_seed_writes(P, n_ns))
        extra = P.engine(SCHEMA_YAML)
        grown = P.ShardMap(version=2,
                           groups=p.map.groups + ((("127.0.0.1", 0),),))
        coord = p.begin_rebalance(grown, new_clients={2: extra})
        assert coord.wait(90) and coord.error is None
        assert p.map.version == 2 and len(p.groups) == 3
        _wait_gc(p)
        mid = _stores(P, engines + [extra])
        coord = p.begin_rebalance(P.shrink_map(p.map))
        assert coord.wait(90) and coord.error is None
        assert p.map.version == 3 and len(p.groups) == 2
        assert p.rebalance_status() is None
        _wait_gc(p)
        exact = _exact(P, p, n_ns)
        assert not extra.store.exists(P.RelationshipFilter(
            resource_type="pod"))
        for i in range(n_ns):
            f = P.RelationshipFilter(resource_type="pod",
                                     resource_id=f"ns{i}/p0")
            assert [gi for gi, e in enumerate(engines)
                    if e.store.exists(f)] == [p.map.shard_for(f"ns{i}",
                                                              "pod")]
        out = mid, _stores(P, engines + [extra]), exact
        p.close()
        return out

    both(run)


def test_shrink_crash_after_cut_resumes(tmp_path):
    def run(P):
        n_ns = 12
        old = _map(P, 3, 1)
        new = P.shrink_map(old, version=2)
        engines = [P.engine(SCHEMA_YAML) for _ in range(3)]
        journal = P.SplitJournal(str(tmp_path / P.name / "sj.sqlite"))
        p = P.ShardedEngine(old, engines, journal=journal)
        p.write_relationships(_seed_writes(P, n_ns))
        t = P.MapTransition(old, new, P.plan_moves(old, new, retire=2),
                            retire=2)
        p._install_transition(t)
        coord = P.RebalanceCoordinator(p, t)
        for i, sl in enumerate(t.slices):
            copy_rev, rows = coord._slice_read(sl.src, sl.ranges)
            coord._slice_load(sl.dst, rows)
            t.set_state(sl, "catchup", copy_rev=copy_rev,
                        replayed=copy_rev)
            while coord._catch_up_once(sl) > 0:
                pass
            if i == 0:
                t.set_state(sl, "cut", src_cut=coord._src_revision(sl.src),
                            dst_cut=coord._src_revision(sl.dst))
        coord._persist()
        p.close(close_journal=False)
        p2 = P.ShardedEngine(old, engines, journal=journal)
        assert p2._coordinator is not None and p2._coordinator.wait(90)
        assert p2._coordinator.error is None, p2._coordinator.error
        assert p2.map.version == 2 and len(p2.groups) == 2
        _wait_gc(p2)
        exact = _exact(P, p2, n_ns)
        assert not engines[2].store.exists(P.RelationshipFilter(
            resource_type="pod"))
        out = (journal.load_transition()["phase"], exact,
               _stores(P, engines))
        p2.close()
        return out

    both(run)


def test_stale_archives_retired_across_grow_shrink_grow():
    def run(P):
        n_ns = 12
        engines = [P.engine(SCHEMA_YAML), P.engine(SCHEMA_YAML)]
        p = P.ShardedEngine(_map(P, 2), engines)
        p.write_relationships(_seed_writes(P, n_ns))
        r0 = counter(P, "scaleout_archives_retired_total")

        def grow():
            extra = P.engine(SCHEMA_YAML)
            grown = P.ShardMap(version=p.map.version + 1,
                               groups=p.map.groups
                               + ((("127.0.0.1", 0),),))
            coord = p.begin_rebalance(grown, new_clients={2: extra})
            assert coord.wait(90) and coord.error is None
            _wait_gc(p)
            return extra

        grow()
        coord = p.begin_rebalance(P.shrink_map(p.map))
        assert coord.wait(90) and coord.error is None
        _wait_gc(p)
        retired = counter(P, "scaleout_archives_retired_total") - r0
        assert retired > 0
        n = len(p.groups)
        for past in p._archived_transitions:
            refs = ({sl.src for sl in past.slices}
                    | {sl.dst for sl in past.slices})
            refs.discard(past.retire)
            assert all(gi < n for gi in refs)
        extra = grow()
        assert not p._copies_may_linger()
        out = retired, _exact(P, p, n_ns), _stores(P, engines + [extra])
        p.close()
        return out

    both(run)


# -- the controller ----------------------------------------------------------


def test_controller_apply_mode_drives_real_transitions():
    def run(P):
        n_ns = 10
        engines = [P.engine(SCHEMA_YAML), P.engine(SCHEMA_YAML)]
        p = P.ShardedEngine(_map(P, 2), engines)
        p.write_relationships(_seed_writes(P, n_ns))
        sig = {"occupancy": 0.95}

        def signal_fn():
            return P.Signals(
                n_groups=len(p.groups), occupancy=sig["occupancy"],
                rebalance_active=p.rebalance_status() is not None,
                gc_pending=any(not t.gc_complete
                               for t in p._archived_transitions))

        spares = []

        def grow_source(gi):
            e = P.engine(SCHEMA_YAML)
            spares.append(e)
            return ((("127.0.0.1", 0),), e)

        ctl = P.AutoscaleController(
            p, P.AutoscalePolicy(P.PolicyConfig(
                min_groups=2, max_groups=3, hysteresis_ticks=2,
                cooldown_seconds=0.0)),
            mode="apply", signal_fn=signal_fn,
            grow_group_source=grow_source)
        started0 = counter(P, "autoscale_transitions_total",
                           action="grow", outcome="started")
        props = []
        for ts in range(10):
            prop = ctl.tick(now=float(ts))
            if prop is not None:
                props.append((ts, prop.action, prop.target_groups))
                break
        assert props and props[0][1] == "grow" and props[0][0] >= 1
        assert counter(P, "autoscale_transitions_total", action="grow",
                       outcome="started") > started0
        assert p._coordinator.wait(90) and p._coordinator.error is None
        assert len(p.groups) == 3 and p.map.version == 2
        _wait_gc(p)
        st = ctl.status()
        assert st["mode"] == "apply" and st["transitions"] == 1
        sig["occupancy"] = 0.02
        for ts in range(100, 120):
            prop = ctl.tick(now=float(ts))
            if prop is not None:
                props.append((ts, prop.action, prop.target_groups))
                break
        assert props[-1][1] == "shrink"
        assert p._coordinator.wait(90) and p._coordinator.error is None
        assert len(p.groups) == 2 and p.map.version == 3
        _wait_gc(p)
        assert ctl.status()["transitions"] == 2
        out = (props, ctl.status(), _exact(P, p, n_ns),
               _stores(P, engines + spares))
        p.close()
        return out

    both(run)


def test_controller_dry_run_and_grow_without_source():
    def run(P):
        p = P.ShardedEngine(_map(P, 2), [P.engine(SCHEMA_YAML)
                                         for _ in range(2)])
        dry = P.AutoscaleController(
            p, P.AutoscalePolicy(P.PolicyConfig(hysteresis_ticks=1,
                                                cooldown_seconds=0.0)),
            mode="dry-run",
            signal_fn=lambda: P.Signals(n_groups=2, occupancy=0.99))
        prop = dry.tick(now=0.0)
        assert prop is not None and prop.action == "grow"
        assert p.rebalance_status() is None and p.map.version == 1
        assert dry.status()["last_proposal"]["mode"] == "dry-run"
        f0 = counter(P, "autoscale_transitions_total", action="grow",
                     outcome="failed")
        app = P.AutoscaleController(
            p, P.AutoscalePolicy(P.PolicyConfig(hysteresis_ticks=1,
                                                cooldown_seconds=0.0)),
            mode="apply",
            signal_fn=lambda: P.Signals(n_groups=2, occupancy=0.99))
        assert app.tick(now=0.0) is not None
        failed = counter(P, "autoscale_transitions_total", action="grow",
                         outcome="failed") - f0
        assert failed == 1 and len(p.groups) == 2
        assert app.status()["transitions"] == 0
        out = dry.status(), app.status(), failed
        p.close()
        return out

    both(run)


def test_controller_shrinks_port_hosts_on_their_own_probes(tmp_path):
    """Apply mode with REAL signal collection over port engine hosts:
    ``load_status`` reads an idle fleet, the policy SKILL.md's recipe
    uses (max_groups=3, hysteresis 2, no cooldown) proposes 4 -> 3 on
    the second tick, and the shrink lands with every grant intact."""
    n_ns = 16
    engines = [PORT.engine(SCHEMA_YAML) for _ in range(4)]
    ctxs = [serving(PORT.EngineServer, e) for e in engines]
    servers = [c.__enter__() for c in ctxs]
    clients = [PORT.RemoteEngine("127.0.0.1", s.port, timeout=30)
               for s in servers]
    try:
        p = PORT.ShardedEngine(_map(PORT, 4), clients)
        p.write_relationships(_seed_writes(PORT, n_ns))
        ctl = PORT.AutoscaleController(
            p, PORT.AutoscalePolicy(PORT.parse_policy(
                "max_groups=3,hysteresis_ticks=2,cooldown_seconds=0")),
            mode="apply")
        sig = ctl.collect_signals()
        assert sig.n_groups == 4 and sig.occupancy == 0.0
        assert ctl.tick(now=0.0) is None
        prop = ctl.tick(now=1.0)
        assert prop is not None and (prop.action, prop.target_groups) == \
            ("shrink", 3)
        assert p._coordinator.wait(90) and p._coordinator.error is None
        assert len(p.groups) == 3 and p.map.version == 2
        _wait_gc(p)
        _exact(PORT, p, n_ns)
        assert not engines[3].store.exists(PORT.RelationshipFilter(
            resource_type="pod"))
        p.close()
    finally:
        for c in clients:
            c.close()
        for c in ctxs:
            c.__exit__(None, None, None)


# -- options and /readyz -----------------------------------------------------


def test_options_validate_every_autoscale_flag():
    good = '{"version": 1, "groups": [["127.0.0.1:1"], ["127.0.0.1:2"]]}'

    def run(P):
        msgs = []
        for kw in ({"autoscale": "sometimes", "shard_map": good},
                   {"autoscale": "apply"},
                   {"autoscale": "dry-run"},
                   {"autoscale_policy": "bogus=1", "shard_map": good},
                   {"autoscale_policy": "max_groups=x", "shard_map": good},
                   {"autoscale_policy": "min_groups=3,max_groups=2",
                    "shard_map": good}):
            with pytest.raises(P.OptionsError) as ei:
                P.Options(rule_content="x", upstream=object(),
                          **kw).validate()
            msgs.append(str(ei.value))
        for mode in ("off", "dry-run", "apply"):
            P.Options(shard_map=good, autoscale=mode,
                      autoscale_policy="max_groups=3",
                      autoscale_tick_seconds=1.0, rule_content="x",
                      upstream=object()).validate()
        return msgs

    msgs = both(run)
    assert "requires --shard-map" in msgs[1]
    assert msgs[3].startswith("autoscale-policy:")


def test_readyz_shows_the_autoscale_line(tmp_path):
    rules = open(os.path.join(REPO, "deploy", "rules.yaml")).read()

    def run(P):
        async def go():
            srvs = [P.EngineServer(P.engine(SCHEMA_YAML)) for _ in range(3)]
            ports = [await s.start() for s in srvs]
            smap = '{"version": 1, "groups": [%s]}' % ", ".join(
                '["127.0.0.1:%d"]' % pt for pt in ports)
            cfg = P.Options(
                shard_map=smap, autoscale="dry-run",
                autoscale_policy="min_groups=2,max_groups=3,"
                                 "hysteresis_ticks=1,cooldown_seconds=0",
                autoscale_tick_seconds=9999,
                shard_journal_path=str(tmp_path / P.name / "sj.sqlite"),
                engine_insecure=True, rule_content=rules,
                upstream=P.FakeKube(),
                workflow_database_path=str(tmp_path / P.name
                                           / "dtx.sqlite"),
            ).complete()
            assert cfg.autoscale_controller is not None
            await cfg.workflow.resume_pending()
            alice = P.InMemoryClient(cfg.server.handle, user="alice")
            seen = []
            for _ in range(2):
                body = (await alice.get("/readyz")).body.decode()
                seen.append([ln for ln in body.splitlines()
                             if "autoscale:" in ln or "sharding:" in ln])
                await asyncio.to_thread(cfg.autoscale_controller.tick,
                                        0.0)
            cfg.autoscale_controller.stop()
            await cfg.workflow.shutdown()
            cfg.engine.close()
            for s in srvs:
                await s.stop()
            return seen

        return asyncio.run(go())

    seen = both(run)
    assert "[+]autoscale: mode=dry-run groups=3 transitions=0 last=none" \
        in seen[0]
    assert seen[1][-1].endswith("last=shrink->2")
