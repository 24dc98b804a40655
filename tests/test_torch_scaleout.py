"""PyTorch port, scale-out (scaleout/): the shard map, the scatter-gather
planner, the split-write journal and the engine host's slice ops, held
against the JAX package.

Every case of test_scaleout.py but the two-peer end-to-end run (its
groups are ``--peers`` failover sets, which the port's engine host does
not serve yet) runs here on BOTH packages: the same tuples and the same
``ShardMap`` go into a JAX ``ShardedEngine`` over JAX ``Engine``s and a
port ``ShardedEngine`` over port ``Engine(device="cpu")``s, each body
asserts the reference's expectations on its package, and what it saw
(routing, verdicts, ids, masks, revision vectors, watch streams, journal
entries, counters) must be equal across the two. Then the wire in both
directions: the JAX planner over port ``EngineServer``s and the port
planner over JAX ones give the same answers and the same ``slice_read``
frames as each package over its own hosts.
"""

from __future__ import annotations

import asyncio
import os
import random
import threading
import time

import pytest

from torch_parity import counter, package, serving

JAX, PORT = package("jax"), package("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RULES = open(os.path.join(REPO, "deploy", "rules.yaml")).read()

SCHEMA_YAML = """\
schema: |-
  use expiration

  definition user {}

  definition group {
    relation member: user
  }

  definition namespace {
    relation creator: user
    relation viewer: user | group#member
    permission admin = creator
    permission view = viewer + creator
  }

  definition pod {
    relation namespace: namespace
    relation creator: user
    relation viewer: user
    permission edit = creator
    permission view = viewer + creator + namespace->view
  }
relationships: ""
"""


def both(fn, *args, **kw):
    """``fn(P, ...)`` on the JAX package, then on the port; what each
    returns must be equal. Returns the port's."""
    got = {P.name: fn(P, *args, **kw) for P in (JAX, PORT)}
    assert got["torch"] == got["jax"]
    return got["torch"]


def _map(P, n: int, version: int = 1):
    return P.ShardMap(version=version,
                      groups=tuple((("127.0.0.1", 0),) for _ in range(n)))


def _planner(P, n: int, journal=None, cache=None):
    engines = [P.engine(SCHEMA_YAML) for _ in range(n)]
    return P.ShardedEngine(_map(P, n), engines, journal=journal,
                           cache=cache), engines


def _ops_count(P, mode: str, op: str = "check_bulk") -> float:
    return sum(counter(P, "scaleout_ops_total", group=str(gi), op=op,
                       mode=mode) for gi in range(8))


def w(P, op, rt, rid, rl, st, sid, srl=None):
    return P.WriteOp(op, P.Relationship(rt, rid, rl, st, sid, srl))


def _pending(journal) -> list:
    """The journal's pending entries without their random ids."""
    return [{k: (sorted(v) if isinstance(v, set) else v)
             for k, v in e.items() if k != "id"}
            for e in journal.pending()]


# -- the shard map -----------------------------------------------------------


def test_shard_map_routes_every_tuple_as_the_jax_package_does():
    doc = ('{"version": 3, "groups": [["127.0.0.1:7001", '
           '"127.0.0.1:7002"], ["127.0.0.1:7011"], ["127.0.0.1:7021"]]}')

    def run(P):
        m1, m2 = P.parse_shard_map(doc), P.parse_shard_map(doc)
        assert m1.version == 3 and m1.n_groups == 3
        assert m1.groups[0] == (("127.0.0.1", 7001), ("127.0.0.1", 7002))
        owners = {}
        for i in range(300):
            key = (f"ns{i}", "pod")
            owners[key] = m1.shard_for(*key)
            assert m2.shard_for(*key) == owners[key]
        per_group = [0] * 3
        for g in owners.values():
            per_group[g] += 1
        assert all(c > 0 for c in per_group), per_group
        types = ("pod", "deployment", "secret", "configmap", "service",
                 "job", "team", "doc")
        assert len({m1.shard_for("nsx", t) for t in types}) > 1
        rng = random.Random(5)
        rows = [(rng.choice(types), f"ns{rng.randrange(500)}/o{k}")
                for k in range(2000)]
        rows += [("namespace", f"ns{k}") for k in range(50)]
        return (m1.ring_points(),
                [m1.shard_of(t, r) for t, r in rows],
                [m1.anchor_shard(t, r) for t, r in rows],
                [P.hash_key(r.split("/")[0], t) for t, r in rows],
                m1.describe())

    got = both(run)
    assert None in got[1]  # the bare ids replicate


def test_shard_map_validation_errors():
    def run(P):
        out = []
        for text in ("not json", '{"version": 0, "groups": [["h:1"]]}',
                     '{"version": 1, "groups": []}',
                     '{"version": 1, "groups": [["nonsense"]]}',
                     '{"version": 1, "groups": [["h:1"]], '
                     '"virtual_nodes": "x"}', "[1]"):
            with pytest.raises(P.ShardMapError) as ei:
                P.parse_shard_map(text)
            out.append(str(ei.value))
        with pytest.raises(P.ShardMapError) as ei:
            P.load_shard_map("/definitely/not/a/file.json")
        out.append(str(ei.value))
        return out

    msgs = both(run)
    assert "shard map group 0: --peers entry 'nonsense'" in msgs[3]


def test_endpoint_grammar_has_one_owner_in_the_port():
    from spicedb_kubeapi_proxy_tpu.parallel.failover import (
        FailoverError,
        parse_peers,
    )
    from spicedb_kubeapi_proxy_tpu_torch.proxy import options
    from spicedb_kubeapi_proxy_tpu_torch.utils.net import (
        EndpointError,
        parse_endpoints,
    )

    assert options.parse_endpoints is parse_endpoints
    for spec in ("h:1", "h:1,h2:2", " [::1]:9 , h:65535 ", "h:0", "h",
                 "h:70000", "", ",", ":5", "h:x"):
        try:
            want = parse_peers(spec)
        except FailoverError as e:
            with pytest.raises(EndpointError) as ei:
                parse_endpoints(spec)
            assert str(ei.value) == str(e)
        else:
            assert parse_endpoints(spec) == want
    with pytest.raises(PORT.OptionsError, match="invalid engine endpoint"):
        PORT.Options(engine_endpoint="tcp://nonsense", rule_content="x",
                     upstream=object()).validate()


def test_global_vs_namespaced_split():
    def run(P):
        assert P.split_resource("ns1/p0") == ("ns1", True)
        assert P.split_resource("ns1") == ("", False)
        m = _map(P, 4)
        assert m.shard_of("pod", "ns1/p0") is not None
        assert m.shard_of("namespace", "ns1") is None
        a = m.anchor_shard("namespace", "ns1")
        assert a == m.anchor_shard("namespace", "ns1") and 0 <= a < 4
        return m.shard_of("pod", "ns1/p0"), a

    both(run)


def test_revision_vector_ordering_merge_encode():
    def run(P):
        RV = P.RevisionVector
        v0 = RV.zero(3)
        v1 = v0.bump(1, 5)
        v2 = v1.bump(0, 2)
        assert v1 == (0, 5, 0) and v2 == (2, 5, 0)
        assert v2.dominates(v1) and not v1.dominates(v2)
        assert v1.join(RV((3, 1, 0))) == (3, 5, 0)
        assert v2.bump(1, 3) == (2, 5, 0)
        assert RV.parse(v2.encode()) == v2
        assert RV.parse([1, 2, 3]) == (1, 2, 3)
        with pytest.raises(P.ShardMapError):
            RV.parse("x1.2")
        assert v2 > v1 > v0
        return (v2.encode(), v2.encode(map_version=4),
                RV.parse_versioned("v1.2@m3"), tuple(RV((1, 2)).extend(4)),
                tuple(RV((5, 7, 9)).drop_component(1)))

    both(run)


# -- planner routing ---------------------------------------------------------


def test_single_shard_check_routes_direct_no_scatter():
    def run(P):
        p, _ = _planner(P, 2)
        p.write_relationships([
            w(P, "create", "pod", "nsa/p0", "viewer", "user", "al"),
            w(P, "create", "pod", "nsb/p0", "viewer", "user", "bo")])
        s0, d0 = _ops_count(P, "scatter"), _ops_count(P, "single")
        got = [p.check(P.CheckItem("pod", "nsa/p0", "view", "user", "al")),
               p.check(P.CheckItem("pod", "nsa/p0", "view", "user", "bo")),
               p.check(P.CheckItem("pod", "nsb/p0", "view", "user", "bo"))]
        assert got == [True, False, True]
        assert _ops_count(P, "scatter") == s0  # NO scatter for checks
        singles = _ops_count(P, "single") - d0
        assert singles >= 3
        out = p.check_bulk([
            P.CheckItem("pod", "nsa/p0", "view", "user", "al"),
            P.CheckItem("pod", "nsb/p0", "view", "user", "al"),
            P.CheckItem("pod", "nsb/p0", "view", "user", "bo")])
        assert out == [True, False, True]
        per_group = {(gi, mode): counter(P, "scaleout_ops_total",
                                         group=str(gi), op="check_bulk",
                                         mode=mode)
                     for gi in range(2) for mode in ("single", "scatter")}
        p.close()
        return got, singles, out, per_group

    both(run)


def _oracle_writes(seed: int = 11, n_ns: int = 12, n_users: int = 6):
    rng = random.Random(seed)
    rows = []
    for i in range(n_ns):
        rows.append(("namespace", f"ns{i}", "viewer", "user",
                     f"u{rng.randrange(n_users)}", None))
    rows.append(("group", "admins", "member", "user", "u0", None))
    rows.append(("namespace", "ns0", "viewer", "group", "admins",
                 "member"))
    for i in range(n_ns):
        for pj in range(3):
            rows.append(("pod", f"ns{i}/p{pj}", "namespace", "namespace",
                         f"ns{i}", None))
            if rng.random() < 0.5:
                rows.append(("pod", f"ns{i}/p{pj}", "viewer", "user",
                             f"u{rng.randrange(n_users)}", None))
    return rows


def test_scatter_gather_parity_with_unsharded_oracle():
    rows, n_users, n_ns = _oracle_writes(), 6, 12

    def run(P):
        writes = [w(P, "create", *r) for r in rows]
        oracle = P.engine(SCHEMA_YAML)
        oracle.write_relationships(list(writes))
        out = {}
        for n_shards in (2, 3):
            p, engines = _planner(P, n_shards)
            p.write_relationships(list(writes))
            res = {"groups": [sorted(r.key() for r in e.read_relationships(
                P.RelationshipFilter())) for e in engines]}
            for u in [f"u{i}" for i in range(n_users)]:
                want = sorted(oracle.lookup_resources(
                    "pod", "view", "user", u))
                got = sorted(p.lookup_resources("pod", "view", "user", u))
                assert got == want, (n_shards, u)
                mask, interner = p.lookup_resources_mask(
                    "pod", "view", "user", u)
                assert P.mask_to_ids(mask, interner) == want
                nsv = sorted(p.lookup_resources("namespace", "view",
                                                "user", u))
                assert nsv == sorted(oracle.lookup_resources(
                    "namespace", "view", "user", u))
                res[u] = (got, mask.tobytes(), nsv)
            res["subjects"] = (
                p.lookup_subjects("pod", "ns0/p0", "view", "user"),
                p.lookup_subjects("namespace", "ns0", "view", "user"))
            assert res["subjects"] == (
                oracle.lookup_subjects("pod", "ns0/p0", "view", "user"),
                oracle.lookup_subjects("namespace", "ns0", "view", "user"))
            items = [P.CheckItem("pod", f"ns{i}/p{j}", "view", "user",
                                 f"u{(i + j) % n_users}")
                     for i in range(n_ns) for j in range(3)]
            res["bulk"] = p.check_bulk(items)
            assert res["bulk"] == oracle.check_bulk(items)
            res["vector"] = tuple(p.revision_vector())
            out[n_shards] = res
            p.close()
        return out

    both(run)


def test_read_and_exists_route_and_dedupe():
    def run(P):
        p, engines = _planner(P, 2)
        p.write_relationships([
            w(P, "create", "namespace", "ns1", "creator", "user", "al"),
            w(P, "create", "pod", "ns1/p0", "viewer", "user", "al"),
            w(P, "create", "pod", "ns2/p0", "viewer", "user", "bo")])
        F = P.RelationshipFilter
        one = p.read_relationships(F(resource_type="namespace",
                                     resource_id="ns1"))
        assert len(one) == 1
        pods = p.read_relationships(F(resource_type="pod"))
        assert {r.resource_id for r in pods} == {"ns1/p0", "ns2/p0"}
        assert p.exists(F(resource_type="pod", resource_id="ns2/p0"))
        assert not p.exists(F(resource_type="pod", resource_id="ns3/p9"))
        n = p.delete_relationships(F(resource_type="namespace",
                                     resource_id="ns1"))
        assert n == 1
        for e in engines:
            assert not e.store.exists(F(resource_type="namespace",
                                        resource_id="ns1"))
        p.close()
        return ([r.key() for r in one], sorted(r.key() for r in pods), n)

    both(run)


def test_gather_at_mixed_revisions_is_not_torn():
    def run(P):
        p, _ = _planner(P, 2)
        sa = p.map.shard_of("pod", "nsa/p0")
        sb = p.map.shard_of("pod", "nsb/p0")
        assert sa != sb
        p.write_relationships([w(P, "create", "pod", "nsa/p0", "viewer",
                                 "user", "al")])
        v1 = p.revision_vector()
        assert sorted(p.lookup_resources("pod", "view", "user", "al")) \
            == ["nsa/p0"]
        p.write_relationships([w(P, "create", "pod", "nsb/p1", "viewer",
                                 "user", "al")])
        v2 = p.revision_vector()
        assert v2[sb] > v1[sb] and v2[sa] == v1[sa]
        got = sorted(p.lookup_resources("pod", "view", "user", "al"))
        assert got == ["nsa/p0", "nsb/p1"]
        p.close()
        return tuple(v1), tuple(v2), got

    both(run)


def test_vector_cache_never_serves_after_component_advance():
    def run(P):
        p, _ = _planner(P, 2, cache=P.ShardVectorCache())
        p.write_relationships([w(P, "create", "pod", "nsa/p0", "viewer",
                                 "user", "al")])
        items = [P.CheckItem("pod", "nsa/p0", "view", "user", "al")]
        seen = [p.try_cached_check(items), p.check_bulk(items),
                p.try_cached_check(items)]
        assert seen == [None, [True], [True]]
        p.write_relationships([w(P, "create", "pod", "nsb/p0", "viewer",
                                 "user", "bo")])
        seen.append(p.try_cached_check(items))
        assert seen[-1] is None
        seen += [p.check_bulk(items), p.try_cached_check(items),
                 p.try_cached_check(items, context={"ip": "1.2.3.4"})]
        assert seen[-3:] == [[True], [True], None]
        hits = (counter(P, "scaleout_cache_hits_total"),
                counter(P, "scaleout_cache_misses_total"))
        p.close()
        return seen, hits

    both(run)


def test_vector_cache_unit_semantics_and_ttl():
    def run(P):
        c = P.ShardVectorCache(max_entries=2)
        v1, v2 = P.RevisionVector((1, 1)), P.RevisionVector((2, 1))
        c.put("k", v1, [True])
        out = [c.get("k", v1), c.get("k", v2)]
        c.retire_below(v2)
        out.append(c.get("k", v1))
        for k, v in (("a", [1]), ("b", [2]), ("c", [3])):
            c.put(k, v1, v)
        out += [c.get("a", v1), c.get("c", v1)]
        assert out == [[True], None, None, None, [3]]
        now = [0.0]
        t = P.ShardVectorCache(ttl=5.0, clock=lambda: now[0])
        t.put("k", v1, [True])
        for ts in (4.9, 5.1):
            now[0] = ts
            out.append(t.get("k", v1))
        assert out[-2:] == [[True], None]
        return out

    both(run)


def test_cache_key_tolerates_list_valued_context():
    def run(P):
        p, _ = _planner(P, 2, cache=P.ShardVectorCache())
        p.write_relationships([w(P, "create", "pod", "nsa/p0", "viewer",
                                 "user", "al")])
        items = [P.CheckItem("pod", "nsa/p0", "view", "user", "al")]
        ctx = {"user": "al", "groups": ["system:authenticated", "dev"],
               "verb": "get", "ip": "10.0.0.1"}
        out = [p.try_cached_check(items, context=ctx),
               p.check_bulk(items, context=ctx),
               p.try_cached_check(items, context=ctx),
               p.try_cached_check(items, context=dict(ctx,
                                                      groups=["other"]))]
        assert out == [None, [True], [True], None]
        p.close()
        return out

    both(run)


# -- cross-shard split writes (the journal) ----------------------------------


class _FlakyWrites:
    """An engine whose write_relationships dies (after optionally
    applying): the mid-split crash injector."""

    def __init__(self, inner, fail_times: int = 1,
                 apply_before_dying: bool = False):
        self._inner = inner
        self.fail_times = fail_times
        self.apply_before_dying = apply_before_dying

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def write_relationships(self, ops, preconditions=()):
        if self.fail_times > 0:
            self.fail_times -= 1
            if self.apply_before_dying:
                self._inner.write_relationships(ops, preconditions)
            raise ConnectionResetError("injected mid-split crash")
        return self._inner.write_relationships(ops, preconditions)


class _Raising:
    """An engine whose write_relationships raises ``exc()``."""

    def __init__(self, inner, exc):
        self._inner, self._exc = inner, exc

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def write_relationships(self, ops, preconditions=()):
        raise self._exc()


def _two_pod_split(P):
    return [w(P, "create", "pod", "nsa/p0", "viewer", "user", "al"),
            w(P, "create", "pod", "nsb/p0", "viewer", "user", "al")]


def _stores(P, engines) -> list:
    return [sorted(r.key() for r in e.read_relationships(
        P.RelationshipFilter())) for e in engines]


def test_cross_shard_split_write_journals_and_replays(tmp_path):
    def run(P):
        engines = [P.engine(SCHEMA_YAML), P.engine(SCHEMA_YAML)]
        journal = P.SplitJournal(str(tmp_path / P.name / "sj.sqlite"))
        smap = _map(P, 2)
        flaky = P.ShardedEngine(smap, [engines[0], _FlakyWrites(engines[1])],
                                journal=journal)
        ops = [w(P, "create", "namespace", "ns1", "creator", "user", "al"),
               *_two_pod_split(P)]
        with pytest.raises(ConnectionResetError):
            flaky.write_relationships(ops)
        pending = _pending(journal)
        assert len(pending) == 1
        assert 0 in pending[0]["applied"] and 1 not in pending[0]["applied"]
        F = P.RelationshipFilter(resource_type="namespace",
                                 resource_id="ns1")
        assert engines[0].store.exists(F)
        assert not engines[1].store.exists(F)
        torn = _stores(P, engines)
        p2 = P.ShardedEngine(smap, engines, journal=journal)
        assert journal.pending_count() == 0
        for e in engines:
            assert e.store.exists(F)
        verdicts = [p2.check(P.CheckItem("pod", f"ns{x}/p0", "view",
                                         "user", "al")) for x in "ab"]
        assert verdicts == [True, True]
        replays = counter(P, "scaleout_split_replays_total")
        out = pending, torn, _stores(P, engines), verdicts, replays
        p2.close()
        return out

    both(run)


def test_replay_idempotent_when_shard_applied_before_crash(tmp_path):
    def run(P):
        engines = [P.engine(SCHEMA_YAML), P.engine(SCHEMA_YAML)]
        journal = P.SplitJournal(str(tmp_path / P.name / "sj.sqlite"))
        flaky = P.ShardedEngine(
            _map(P, 2),
            [engines[0], _FlakyWrites(engines[1], apply_before_dying=True)],
            journal=journal)
        with pytest.raises(ConnectionResetError):
            flaky.write_relationships(_two_pod_split(P))
        pending = _pending(journal)
        p2 = P.ShardedEngine(_map(P, 2), engines, journal=journal)
        assert journal.pending_count() == 0
        assert p2.check(P.CheckItem("pod", "nsb/p0", "view", "user", "al"))
        rows = p2.read_relationships(P.RelationshipFilter(
            resource_type="pod", resource_id="nsb/p0"))
        assert len(rows) == 1
        p2.close()
        return pending, _stores(P, engines)

    both(run)


def test_first_shard_rejection_closes_the_journal_entry(tmp_path):
    def run(P):
        engines = [P.engine(SCHEMA_YAML), P.engine(SCHEMA_YAML)]
        journal = P.SplitJournal(str(tmp_path / P.name / "sj.sqlite"))
        flaky = P.ShardedEngine(
            _map(P, 2), [_Raising(engines[0], lambda: P.PreconditionFailed(
                "injected engine-answered rejection")), engines[1]],
            journal=journal)
        with pytest.raises(P.PreconditionFailed):
            flaky.write_relationships(_two_pod_split(P))
        assert journal.pending_count() == 0
        p2 = P.ShardedEngine(_map(P, 2), engines, journal=journal)
        v = p2.check(P.CheckItem("pod", "nsb/p0", "view", "user", "al"))
        assert not v
        p2.close()
        return v, _stores(P, engines)

    both(run)


@pytest.mark.parametrize("failure", ["transport", "deadline"])
def test_first_shard_ambiguous_failure_stays_pending(tmp_path, failure):
    """A transport death or an exhausted deadline on the first shard may
    have applied: the entry stays pending and recovery touch-replays
    everything (at least once, never silently half-applied)."""

    def run(P):
        engines = [P.engine(SCHEMA_YAML), P.engine(SCHEMA_YAML)]
        journal = P.SplitJournal(str(tmp_path / P.name / "sj.sqlite"))
        if failure == "transport":
            first = _FlakyWrites(engines[0], apply_before_dying=True)
            exc = ConnectionResetError
        else:
            first = _Raising(engines[0], lambda: P.DependencyUnavailable(
                "engine:x", "deadline exhausted"))
            exc = P.DependencyUnavailable
        flaky = P.ShardedEngine(_map(P, 2), [first, engines[1]],
                                journal=journal)
        with pytest.raises(exc):
            flaky.write_relationships(_two_pod_split(P))
        pending = _pending(journal)
        assert len(pending) == 1
        p2 = P.ShardedEngine(_map(P, 2), engines, journal=journal)
        assert journal.pending_count() == 0
        v = [p2.check(P.CheckItem("pod", f"ns{x}/p0", "view", "user",
                                  "al")) for x in "ab"]
        assert v == [True, True]
        assert len(p2.read_relationships(P.RelationshipFilter(
            resource_type="pod", resource_id="nsa/p0"))) == 1
        p2.close()
        return pending, v, _stores(P, engines)

    both(run)


def _ns_on(m, rtype: str, group: int, tag: str = "q") -> str:
    return next(f"{tag}{i}" for i in range(256)
                if m.shard_for(f"{tag}{i}", rtype) == group)


def test_later_shard_precondition_cannot_reject():
    def run(P):
        p, _ = _planner(P, 2)
        ns0, ns1 = _ns_on(p.map, "pod", 0), _ns_on(p.map, "pod", 1)
        pc = P.Precondition(P.RelationshipFilter(
            resource_type="pod", resource_id=f"{ns1}/p9",
            relation="viewer"), must_exist=True)
        with pytest.raises(P.PreconditionFailed):
            p.write_relationships([
                w(P, "create", "pod", f"{ns0}/p1", "viewer", "user", "al"),
                w(P, "create", "pod", f"{ns1}/p1", "viewer", "user", "al"),
            ], [pc])
        got = [p.exists(P.RelationshipFilter(resource_type="pod",
                                             resource_id=f"{n}/p1"))
               for n in (ns0, ns1)]
        assert got == [False, False]
        p.close()
        return ns0, ns1, got

    both(run)


def test_single_shard_write_routes_cross_shard_preconditions():
    def run(P):
        p, _ = _planner(P, 2)
        ns0, ns1 = _ns_on(p.map, "pod", 0), _ns_on(p.map, "pod", 1)
        p.write_relationships([w(P, "create", "pod", f"{ns1}/guard",
                                 "viewer", "user", "g")])
        guard = P.RelationshipFilter(resource_type="pod",
                                     resource_id=f"{ns1}/guard",
                                     relation="viewer")
        p.write_relationships(
            [w(P, "create", "pod", f"{ns0}/p0", "viewer", "user", "al")],
            [P.Precondition(guard, must_exist=True)])
        assert p.check(P.CheckItem("pod", f"{ns0}/p0", "view", "user",
                                   "al"))
        with pytest.raises(P.PreconditionFailed):
            p.write_relationships(
                [w(P, "create", "pod", f"{ns0}/p1", "viewer", "user",
                   "al")], [P.Precondition(guard, must_exist=False)])
        gone = p.exists(P.RelationshipFilter(resource_type="pod",
                                             resource_id=f"{ns0}/p1"))
        assert not gone
        p.close()
        return ns0, ns1, gone

    both(run)


def test_unanchored_precondition_probed_not_bound_per_shard():
    def run(P):
        p, _ = _planner(P, 2)
        p.write_relationships([w(P, "create", "pod", "nsa/p0", "viewer",
                                 "user", "al")])
        pc = P.Precondition(P.RelationshipFilter(resource_type="pod"),
                            must_exist=True)
        p.write_relationships([
            w(P, "create", "namespace", "ns1", "creator", "user", "al"),
            w(P, "create", "pod", "nsb/p0", "viewer", "user", "al")], [pc])
        v = p.check(P.CheckItem("pod", "nsb/p0", "view", "user", "al"))
        assert v
        p.close()
        return v

    both(run)


def test_scatter_delete_precondition_decides_before_any_leg():
    def run(P):
        p, _ = _planner(P, 3)
        p.write_relationships([
            w(P, "create", "pod", f"ns{x}/p0", "viewer", "user", "al")
            for x in "abc"])
        pc = P.Precondition(P.RelationshipFilter(
            resource_type="namespace", resource_id="ghost"),
            must_exist=True)
        with pytest.raises(P.PreconditionFailed):
            p.delete_relationships(P.RelationshipFilter(
                resource_type="pod"), [pc])
        n = len(p.read_relationships(P.RelationshipFilter(
            resource_type="pod")))
        assert n == 3
        # and without the precondition every shard deletes its slice
        gone = p.delete_relationships(P.RelationshipFilter(
            resource_type="pod"))
        assert gone == 3
        p.close()
        return n, gone

    both(run)


def test_recovery_reroutes_entries_from_a_different_map(tmp_path):
    def rel(rt, rid):
        return {"resource_type": rt, "resource_id": rid,
                "relation": "viewer" if rt == "pod" else "creator",
                "subject_type": "user", "subject_id": "al",
                "subject_relation": None, "expiration": None,
                "caveat": None, "caveat_context": None}

    def run(P):
        journal = P.SplitJournal(str(tmp_path / P.name / "sj.sqlite"))
        plan = {0: [{"op": "create", "rel": rel("namespace", "n1")}],
                3: [{"op": "create", "rel": rel("pod", "nsz/p0")}]}
        sid = journal.begin(plan, [], map_version=9)
        journal.mark_applied(sid, 0)
        engines = [P.engine(SCHEMA_YAML), P.engine(SCHEMA_YAML)]
        p = P.ShardedEngine(_map(P, 2, version=10), engines,
                            journal=journal)
        assert journal.pending_count() == 0
        ok = p.exists(P.RelationshipFilter(resource_type="pod",
                                           resource_id="nsz/p0"))
        assert ok
        p.close()
        return _stores(P, engines)

    both(run)


def test_boot_survives_unreachable_shard_with_pending_splits(tmp_path):
    def run(P):
        engines = [P.engine(SCHEMA_YAML), P.engine(SCHEMA_YAML)]
        journal = P.SplitJournal(str(tmp_path / P.name / "sj.sqlite"))
        flaky = P.ShardedEngine(_map(P, 2),
                                [engines[0], _FlakyWrites(engines[1])],
                                journal=journal)
        with pytest.raises(ConnectionResetError):
            flaky.write_relationships(_two_pod_split(P))
        down = P.ShardedEngine(
            _map(P, 2), [engines[0], _FlakyWrites(engines[1],
                                                  fail_times=99)],
            journal=journal)
        assert journal.pending_count() == 1
        assert down.sharding_status()["pending_splits"] == 1
        deferred = counter(P, "scaleout_split_replay_deferred_total")
        p2 = P.ShardedEngine(_map(P, 2), engines, journal=journal)
        assert journal.pending_count() == 0
        assert p2.check(P.CheckItem("pod", "nsb/p0", "view", "user", "al"))
        p2.close()
        return deferred >= 1, _stores(P, engines)

    both(run)


def test_split_write_retries_deferred_recovery_first(tmp_path):
    def run(P):
        engines = [P.engine(SCHEMA_YAML), P.engine(SCHEMA_YAML)]
        journal = P.SplitJournal(str(tmp_path / P.name / "sj.sqlite"))
        flaky = P.ShardedEngine(_map(P, 2),
                                [engines[0], _FlakyWrites(engines[1])],
                                journal=journal)
        with pytest.raises(ConnectionResetError):
            flaky.write_relationships(_two_pod_split(P))
        p2 = P.ShardedEngine(_map(P, 2), engines, journal=journal,
                             recover=False)
        assert journal.pending_count() == 1
        p2.write_relationships([w(P, "create", "namespace", "nsx",
                                  "creator", "user", "al")])
        assert journal.pending_count() == 0
        assert p2.check(P.CheckItem("pod", "nsb/p0", "view", "user", "al"))
        p2.close()
        return _stores(P, engines)

    both(run)


# -- admission ---------------------------------------------------------------


class _Shedding:
    def __init__(self, P, inner, retry_after: float):
        self._P, self._inner, self.retry_after = P, inner, retry_after

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def lookup_resources(self, *a, **kw):
        raise self._P.AdmissionRejected("lookup-prefilter", "host full",
                                        retry_after=self.retry_after,
                                        dependency="engine-admission")


def test_partial_shed_scatter_fails_closed_max_retry_after():
    def run(P):
        engines = [P.engine(SCHEMA_YAML) for _ in range(3)]
        p = P.ShardedEngine(_map(P, 3), [
            engines[0], _Shedding(P, engines[1], 2.0),
            _Shedding(P, engines[2], 7.0)])
        before = counter(P, "scaleout_partial_shed_total")
        with pytest.raises(P.AdmissionRejected) as ei:
            p.lookup_resources("pod", "view", "user", "al")
        out = (ei.value.retry_after, ei.value.dependency, str(ei.value),
               counter(P, "scaleout_partial_shed_total") - before)
        assert out[0] == 7.0 and out[1] == "shard-admission"
        assert out[3] == 1
        p.close()
        return out

    both(run)


def test_admission_fanout_and_scaled_cost():
    def run(P):
        p, _ = _planner(P, 4)
        out = [p.admission_fanout(c) for c in (
            P.LOOKUP_PREFILTER, P.WATCH_RECOMPUTE, P.CHECK, P.WRITE_DTX)]
        assert out == [4, 4, 1, 1]
        s = P.LOOKUP_PREFILTER.scaled(4)
        assert s.weight == P.LOOKUP_PREFILTER.weight * 4
        assert (s.name, s.priority) == (P.LOOKUP_PREFILTER.name,
                                        P.LOOKUP_PREFILTER.priority)
        assert P.CHECK.scaled(1) is P.CHECK
        p.close()
        return out, s.weight

    both(run)


def test_middleware_charges_scatter_per_shard():
    def run(P):
        import importlib

        mw = importlib.import_module(P.base + ".authz.middleware")
        ri = importlib.import_module(P.base + ".proxy.requestinfo")
        types = importlib.import_module(P.base + ".proxy.types")
        rin = importlib.import_module(P.base + ".rules.input")
        matcher = importlib.import_module(P.base + ".rules.matcher")

        class Recording:
            def __init__(self):
                self.classes = []

            async def acquire_async(self, tenant, cls):
                self.classes.append(cls)

                class T:
                    def release(self, observe=True):
                        pass

                return T()

        async def upstream(req):
            return types.ProxyResponse(status=200, headers={
                "Content-Type": "application/json"},
                body=b'{"kind":"NamespaceList","items":[]}')

        p, _ = _planner(P, 3)
        adm = Recording()
        deps = mw.AuthzDeps(matcher=matcher.MapMatcher.from_yaml(RULES),
                            engine=p, upstream=upstream, admission=adm)
        req = types.ProxyRequest(
            method="GET", path="/api/v1/namespaces", query={}, headers={},
            body=b"", request_info=ri.parse_request_info(
                "GET", "/api/v1/namespaces", {}),
            user=rin.UserInfo(name="alice"))
        resp = asyncio.run(mw.authorize(req, deps))
        assert resp.status == 200 and len(adm.classes) == 1
        cls = adm.classes[0]
        assert cls.name == "lookup-prefilter"
        assert cls.weight == P.LOOKUP_PREFILTER.weight * 3
        p.close()
        return resp.status, resp.body, cls.name, cls.weight

    both(run)


# -- watch streams -----------------------------------------------------------


def _drain(stream, want: int, budget: float = 20.0) -> list:
    seen = []
    deadline = time.monotonic() + budget
    while len(seen) < want and time.monotonic() < deadline:
        seen.extend(stream.next_batch())
    return seen


def test_sharded_watch_stream_vector_resumption():
    def run(P):
        p, _ = _planner(P, 2)
        stream = p.watch_push_stream(p.map.zero_vector())
        try:
            p.write_relationships([
                w(P, "create", "pod", "nsa/p0", "viewer", "user", "al"),
                w(P, "create", "pod", "nsb/p0", "viewer", "user", "bo")])
            seen = _drain(stream, 2)
            assert len(seen) == 2
            vecs = [e.revision for e in seen]
            assert all(isinstance(v, P.RevisionVector) for v in vecs)
            for a, b in zip(vecs, vecs[1:]):
                assert b.dominates(a)
            assert p.watch_since(vecs[-1]) == []
            replay = p.watch_since(p.map.zero_vector())
            assert {e.relationship.resource_id for e in replay} == {
                "nsa/p0", "nsb/p0"}
            return (sorted((e.operation, e.relationship.key())
                           for e in seen), tuple(vecs[-1]),
                    [(tuple(e.revision), e.operation, e.relationship.key())
                     for e in replay])
        finally:
            stream.close()
            p.close()

    both(run)


def test_namespaced_lookup_subjects_routes_direct():
    def run(P):
        p, _ = _planner(P, 3)
        p.write_relationships([
            w(P, "create", "pod", "nsa/p0", "viewer", "user", "al"),
            w(P, "create", "namespace", "ns1", "viewer", "user", "gl")])
        s0 = _ops_count(P, "scatter", op="lookup_subjects")
        d0 = _ops_count(P, "single", op="lookup_subjects")
        a = p.lookup_subjects("pod", "nsa/p0", "view", "user")
        assert a == ["al"]
        assert _ops_count(P, "scatter", op="lookup_subjects") == s0
        assert _ops_count(P, "single", op="lookup_subjects") == d0 + 1
        b = p.lookup_subjects("namespace", "ns1", "view", "user")
        assert b == ["gl"]
        assert _ops_count(P, "scatter", op="lookup_subjects") > s0
        p.close()
        return a, b

    both(run)


# -- /readyz's sharding line and the options ---------------------------------


def _readyz(P, tmp_path, n: int = 2) -> str:
    async def go():
        srvs = [P.EngineServer(P.engine(SCHEMA_YAML)) for _ in range(n)]
        ports = [await s.start() for s in srvs]
        smap = ('{"version": 2, "groups": [%s]}' % ", ".join(
            '["127.0.0.1:%d"]' % pt for pt in ports))
        cfg = P.Options(
            shard_map=smap,
            shard_journal_path=str(tmp_path / P.name / "sj.sqlite"),
            engine_insecure=True, rule_content=RULES,
            upstream=P.FakeKube(),
            workflow_database_path=str(tmp_path / P.name / "dtx.sqlite"),
        ).complete()
        assert isinstance(cfg.engine, P.ShardedEngine)
        await cfg.workflow.resume_pending()
        alice = P.InMemoryClient(cfg.server.handle, user="alice")
        resp = await alice.get("/readyz")
        assert resp.status == 200, resp.body
        lst = await alice.get("/api/v1/namespaces")
        assert lst.status == 200
        await cfg.workflow.shutdown()
        cfg.engine.close()
        for s in srvs:
            await s.stop()
        return resp.body.decode(), lst.body

    return asyncio.run(go())


def test_readyz_reports_sharding_line(tmp_path):
    def run(P):
        body, lst = _readyz(P, tmp_path)
        line = next(ln for ln in body.splitlines() if "sharding:" in ln)
        assert "[+]sharding: groups=2 map_version=2" in line
        assert "g0=leader/0 g1=leader/0 pending_splits=0" in line
        assert "autoscale:" not in body
        return line, lst

    both(run)


def test_options_validation():
    good = '{"version": 1, "groups": [["127.0.0.1:1"]]}'

    def run(P):
        msgs = []
        for kw in ({"engine_endpoint": "tcp://h:1"},
                   {"bootstrap_content": "x"},
                   {"snapshot_path": "/tmp/x"}, {"data_dir": "/tmp/x"},
                   {"lookup_batch_window": 0.01}):
            with pytest.raises(P.OptionsError) as ei:
                P.Options(shard_map=good, rule_content="x",
                          upstream=object(), **kw).validate()
            msgs.append(str(ei.value))
        with pytest.raises(P.OptionsError) as ei:
            P.Options(shard_map='{"version": 0, "groups": [["h:1"]]}',
                      rule_content="x", upstream=object()).validate()
        msgs.append(str(ei.value))
        for kw in ({"frontier_exchange": True},
                   {"frontier_max_rounds": 0, "shard_map": good}):
            with pytest.raises(P.OptionsError) as ei:
                P.Options(rule_content="x", upstream=object(),
                          **kw).validate()
            msgs.append(str(ei.value))
        P.Options(shard_map=good, frontier_exchange=True,
                  frontier_max_rounds=2, shard_cache=True,
                  rule_content="x", upstream=object()).validate()
        return msgs

    msgs = both(run)
    assert "mutually exclusive" in msgs[0] and "bootstrap" in msgs[1]


def test_port_refuses_device_beside_a_shard_map():
    good = '{"version": 1, "groups": [["127.0.0.1:1"]]}'
    with pytest.raises(PORT.OptionsError,
                       match="each engine group owns its own"):
        PORT.Options(shard_map=good, device="cpu", rule_content="x",
                     upstream=object()).validate()
    # a proxy host without a card may still front the groups: no device
    # is resolved for a shard map
    PORT.Options(shard_map=good, rule_content="x",
                 upstream=object()).validate()


# -- the wire, in both directions --------------------------------------------


def _wire_script(P, engines, clients, tmp, journal_name):
    """One script through a planner over ``clients`` (engine-host
    clients of either package, their engines ``engines``): writes (one
    split), checks, lists, masks, subjects, reads, the vector, a push
    stream, and every slice op. Returns what it saw."""
    smap = _map(P, len(clients))
    journal = P.SplitJournal(str(tmp / journal_name))
    p = P.ShardedEngine(smap, clients, journal=journal)
    rows = _oracle_writes(seed=3)
    stream = p.watch_push_stream(p.revision_vector())
    try:
        p.write_relationships([w(P, "create", *r) for r in rows])
        p.write_relationships([
            w(P, "touch", "namespace", "ns1", "creator", "user", "u5"),
            w(P, "touch", "pod", "ns2/p9", "viewer", "user", "u5"),
            w(P, "touch", "pod", "ns7/p9", "viewer", "user", "u5")])
        assert journal.pending_count() == 0
        out = {"vector": tuple(p.revision_vector())}
        out["lists"] = {u: sorted(p.lookup_resources("pod", "view", "user",
                                                     u))
                        for u in ("u0", "u1", "u2", "u5")}
        out["masks"] = {u: P.mask_to_ids(*p.lookup_resources_mask(
            "pod", "view", "user", u)) for u in ("u0", "u5")}
        items = [P.CheckItem("pod", f"ns{i}/p{j}", "view", "user",
                             f"u{(i * 3 + j) % 6}")
                 for i in range(12) for j in range(3)]
        out["bulk"] = p.check_bulk(items)
        out["subjects"] = (
            p.lookup_subjects("pod", "ns0/p0", "view", "user"),
            p.lookup_subjects("namespace", "ns1", "view", "user"))
        out["reads"] = sorted(r.key() for r in p.read_relationships(
            P.RelationshipFilter(resource_type="pod")))
        # a global row's event arrives once from every group
        n_glob = sum("/" not in r[1] for r in rows) + 1
        want = len(rows) + 3 + (len(clients) - 1) * n_glob
        seen = _drain(stream, want)
        out["stream"] = sorted((e.operation, e.relationship.key())
                               for e in seen)
        assert len(seen) == want
        out["watch"] = [(tuple(e.revision), e.operation,
                         e.relationship.key())
                        for e in p.watch_since(p.map.zero_vector())]
        # the mover's data plane, on every host
        slices = []
        for c in clients:
            ranges = [(0, 1 << 31), (3 << 30, 1 << 32)]
            rev, got = c.slice_read(ranges)
            grev, glob = c.slice_read([], want_globals=True)
            slices.append((rev, sorted(r.key() for r in got), grev,
                           sorted(r.key() for r in glob)))
        out["slice_read"] = slices
        # load/apply/drop/watch on the last host, then its content
        c = clients[-1]
        moved = [P.Relationship("pod", "zz/p0", "viewer", "user", "m0"),
                 P.Relationship("pod", "zz/p1", "viewer", "user", "m1")]
        r0 = c.revision
        out["load"] = c.slice_load(moved) - r0
        out["load_again"] = c.slice_load(moved) - r0
        out["apply"] = c.slice_apply([P.WriteOp("delete", moved[0])]) - r0
        out["slice_watch"] = [(e.revision - r0, e.operation,
                               e.relationship.key())
                              for e in c.slice_watch_since(r0)]
        h = P.hash_key("zz", "pod")
        out["drop"] = c.slice_drop([(h, h + 1)])
        out["after"] = _stores(P, engines)
        return out
    finally:
        stream.close()
        p.close()


@pytest.mark.parametrize("planner,host", [("jax", "torch"),
                                          ("torch", "jax")])
def test_planner_over_the_other_packages_hosts(tmp_path, planner, host):
    """The JAX planner over port engine hosts and the port planner over
    JAX ones: the same answers, streams and ``slice_*`` results as the
    planner's own package over its own hosts."""
    Pp = {"jax": JAX, "torch": PORT}[planner]
    Ph = {"jax": JAX, "torch": PORT}[host]

    def over(Pclient, Phost, tag):
        engines = [Phost.engine(SCHEMA_YAML) for _ in range(3)]
        with serving(Phost.EngineServer, engines[0]) as s0, \
                serving(Phost.EngineServer, engines[1]) as s1, \
                serving(Phost.EngineServer, engines[2]) as s2:
            clients = [Pclient.RemoteEngine("127.0.0.1", s.port,
                                            timeout=30)
                       for s in (s0, s1, s2)]
            try:
                return _wire_script(Pclient, engines, clients, tmp_path,
                                    f"{tag}.sqlite")
            finally:
                for c in clients:
                    c.close()

    same = over(Pp, Pp, "same")
    cross = over(Pp, Ph, "cross")
    assert cross == same
    # a load is one write (two rows, one power-of-two chunk); loading it
    # again touches the same rows: one more revision, no new row
    assert (same["load"], same["load_again"], same["drop"]) == (1, 2, 1)
    assert same["slice_watch"][-1][1] == "delete"


def test_engines_sharing_a_device_never_deadlock():
    """Several port engines on one device behind one planner, hit from
    many threads at once (scatter lists, routed checks, split writes):
    every call returns, and the answers match a single engine's."""
    rows = _oracle_writes(seed=9, n_ns=16)
    p, engines = _planner(PORT, 3)
    oracle = PORT.engine(SCHEMA_YAML)
    ops = [w(PORT, "create", *r) for r in rows]
    p.write_relationships(list(ops))
    oracle.write_relationships(list(ops))
    errors, done = [], threading.Event()
    want = {u: sorted(oracle.lookup_resources("pod", "view", "user", u))
            for u in ("u0", "u1", "u2")}
    barrier = threading.Barrier(9)

    def lister(k):
        barrier.wait(10)
        for i in range(12):
            u = f"u{(k + i) % 3}"
            if sorted(p.lookup_resources("pod", "view", "user", u)) \
                    != want[u]:
                errors.append(("list", k, u))

    def checker(k):
        barrier.wait(10)
        for i in range(12):
            p.check_bulk([PORT.CheckItem("pod", f"ns{j}/p0", "view",
                                         "user", f"u{k}")
                          for j in range(16)])

    def writer():
        barrier.wait(10)
        for i in range(12):
            p.write_relationships([
                w(PORT, "touch", "namespace", f"wn{i}", "creator", "user",
                  "wr"),
                w(PORT, "touch", "pod", f"wn{i}/p0", "viewer", "user",
                  "wr")])

    threads = ([threading.Thread(target=lister, args=(k,))
                for k in range(4)]
               + [threading.Thread(target=checker, args=(k,))
                  for k in range(4)]
               + [threading.Thread(target=writer)])
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    done.set()
    assert not any(t.is_alive() for t in threads), "a thread hung"
    assert not errors, errors[:3]
    assert sorted(p.lookup_resources("pod", "view", "user", "wr")) == \
        sorted(f"wn{i}/p0" for i in range(12))
    p.close()


def test_sliced_rows_and_columns_round_trip_like_the_jax_host():
    """The host helpers the slice ops and the in-process mover share:
    ``_slice_rows`` picks the same rows as the JAX package's for the same
    ranges, ``po2_chunks`` splits the same, and the npz column codec
    round-trips expirations, caveats and usersets."""
    import importlib

    from spicedb_kubeapi_proxy_tpu.engine import remote as jr
    from spicedb_kubeapi_proxy_tpu_torch.engine import remote as pr

    for n in (0, 1, 5, 2048, 2049, 5000):
        assert pr.po2_chunks(n) == jr.po2_chunks(n)
    rows = _oracle_writes(seed=4)
    got = {}
    for P, r in ((JAX, jr), (PORT, pr)):
        e = P.engine(SCHEMA_YAML)
        e.write_relationships([w(P, "create", *x) for x in rows])
        ranges = [(0, 1 << 30), (1 << 31, 3 << 30)]
        picked = sorted(x.key() for x in r._slice_rows(e, ranges, False))
        glob = sorted(x.key() for x in r._slice_rows(e, (), True))
        rels = [P.Relationship("pod", "a/p", "viewer", "user", "u", None,
                               1.7e9, "c", '{"x": 1}'),
                P.Relationship("namespace", "a", "viewer", "group", "g",
                               "member")]
        codec = importlib.import_module(P.base + ".persistence.codec")
        frame = codec.encode_bulk_cols(r._rels_to_cols(rels))
        back = r._cols_to_rels(codec.decode_bulk_cols(frame))
        assert back == rels
        got[P.name] = (picked, glob, r._rels_to_cols(rels))
    assert got["torch"] == got["jax"]
