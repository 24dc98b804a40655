"""PyTorch port, the cross-shard frontier exchange (scaleout/frontier.py,
the planner's ``frontier_closure`` and the engine host's
``frontier_pairs`` / ``frontier_expand`` ops), held against the JAX
package.

The reference bench's frontier schema (bench.py's ``_FRONTIER_SCHEMA``:
``team#member`` namespaced, so partitioned rather than replicated, and
referenced by ``doc#owner`` rows in other namespaces) and the nested
two-hop chain of test_autoscale.py run through a JAX planner and a port
planner, in process and over each package's engine hosts: closures,
rounds, boundary tuples and wire bytes read from the
``scaleout_frontier_*`` counters must be equal across the packages, and
the answers equal an unsharded engine's. A starved round budget fails
closed (denies, counts ``budget-exhausted``); a non-monotone schema is
refused.
"""

from __future__ import annotations

import pytest

from torch_parity import counter, package, serving

JAX, PORT = package("jax"), package("torch")

# bench.py's _FRONTIER_SCHEMA
BENCH_FRONTIER = """\
schema: |-
  definition user {}

  definition team {
    relation member: user
  }

  definition doc {
    relation owner: team#member
    relation viewer: user
    permission view = viewer + owner
  }
relationships: ""
"""

# test_autoscale.py's nested chain schema
NESTED = """\
schema: |-
  definition user {}

  definition team {
    relation member: user | team#member
    permission view = member
  }

  definition doc {
    relation owner: team#member
    relation viewer: user
    permission view = viewer + owner
  }
relationships: ""
"""

NON_MONOTONE = """\
schema: |-
  definition user {}

  definition team {
    relation member: user
  }

  definition doc {
    relation owner: team#member
    relation banned: user
    permission view = owner - banned
  }
relationships: ""
"""


def both(fn, *args, **kw):
    got = {P.name: fn(P, *args, **kw) for P in (JAX, PORT)}
    assert got["torch"] == got["jax"]
    return got["torch"]


def _map(P, n: int):
    return P.ShardMap(version=1,
                      groups=tuple((("127.0.0.1", 0),) for _ in range(n)))


def w(P, op, rt, rid, rl, st, sid, srl=None):
    return P.WriteOp(op, P.Relationship(rt, rid, rl, st, sid, srl))


def _counters(P) -> dict:
    h = P.metrics.hist_snapshot("scaleout_frontier_rounds") or {}
    return {
        "scatter": counter(P, "scaleout_frontier_wire_bytes_total",
                           direction="scatter"),
        "gather": counter(P, "scaleout_frontier_wire_bytes_total",
                          direction="gather"),
        "boundary": counter(P, "scaleout_frontier_boundary_tuples_total"),
        "converged": counter(P, "scaleout_frontier_exchanges_total",
                             outcome="converged"),
        "exhausted": counter(P, "scaleout_frontier_exchanges_total",
                             outcome="budget-exhausted"),
        "rounds": h.get("total", 0.0), "exchanges": h.get("n", 0)}


def _delta(P, before: dict) -> dict:
    now = _counters(P)
    return {k: now[k] - before[k] for k in now}


def _bench_writes(P, n_pairs: int = 16):
    out = []
    for i in range(n_pairs):
        out.append(w(P, "create", "team", f"a{i}/t", "member", "user",
                     f"u{i % 8}"))
        out.append(w(P, "create", "doc", f"b{i}/d", "owner", "team",
                     f"a{i}/t", "member"))
        out.append(w(P, "create", "doc", f"b{i}/d", "viewer", "user",
                     f"v{i % 8}"))
    return out


def test_reference_pairs_extraction_and_refusal():
    def run(P):
        pairs = [P.reference_pairs(P.engine(y).schema)
                 for y in (BENCH_FRONTIER, NESTED)]
        assert pairs == [(("team", "member"),)] * 2
        none = P.reference_pairs(P.engine(
            BENCH_FRONTIER.replace("team#member", "user")).schema)
        assert none == ()
        with pytest.raises(P.FrontierError) as ei:
            P.reference_pairs(P.engine(NON_MONOTONE).schema)
        assert "monotone" in str(ei.value)
        return pairs, none, str(ei.value)

    both(run)


def test_frontier_wire_form_and_local_leg():
    def run(P):
        descs = {("team", "a1/t", "member"), ("user", "u0", None),
                 ("team", "a0/t", "member")}
        raw = P.encode_frontier(descs)
        assert P.decode_frontier(raw) == descs
        assert P.decode_frontier(raw.decode()) == descs
        e = P.engine(NESTED)
        e.write_relationships([
            w(P, "create", "team", "x/t", "member", "user", "u0"),
            w(P, "create", "team", "y/t", "member", "team", "x/t",
              "member")])
        leg = P.expand_local(e, [("user", "u0", None)],
                             [("team", "member")])
        return raw, sorted(leg, key=str)

    raw, leg = both(run)
    assert leg == [("team", "x/t", "member"), ("team", "y/t", "member")]


def _bench_run(P, clients, oracle, n_pairs: int):
    p = P.ShardedEngine(_map(P, len(clients)), clients,
                        frontier=P.FrontierConfig())
    writes = _bench_writes(P, n_pairs)
    p.write_relationships(list(writes))
    oracle.write_relationships(list(writes))
    c0 = _counters(P)
    out = {"checks": [], "lists": {}, "closures": {}}
    for i in range(n_pairs):
        for subj in (f"u{i % 8}", f"v{i % 8}", "intruder"):
            item = P.CheckItem("doc", f"b{i}/d", "view", "user", subj)
            got = p.check(item)
            assert got == oracle.check(item), (i, subj)
            out["checks"].append(got)
    for u in ("u0", "u3", "v1", "intruder"):
        got = sorted(p.lookup_resources("doc", "view", "user", u))
        assert got == sorted(oracle.lookup_resources("doc", "view", "user",
                                                     u))
        out["lists"][u] = got
        out["closures"][u] = sorted(p.frontier_closure("user", u),
                                    key=str)
    out["counters"] = _delta(P, c0)
    # single-copy placement: every team and doc row on exactly ONE group
    f = P.RelationshipFilter
    for i in range(n_pairs):
        for rt, rid in (("team", f"a{i}/t"), ("doc", f"b{i}/d")):
            assert sum(1 for c in clients
                       if c.read_relationships(f(resource_type=rt,
                                                 resource_id=rid))) == 1
    p.close()
    return out


def test_bench_frontier_cell_in_process():
    def run(P):
        engines = [P.engine(BENCH_FRONTIER) for _ in range(3)]
        return _bench_run(P, engines, P.engine(BENCH_FRONTIER), 16)

    out = both(run)
    assert any(out["checks"]) and out["counters"]["converged"] > 0
    assert 0 < out["counters"]["scatter"] and 0 < out["counters"]["gather"]
    assert out["counters"]["exhausted"] == 0


def test_bench_frontier_cell_over_the_wire_both_directions():
    """The port planner over JAX hosts and the JAX planner over port
    hosts: the wire legs (``frontier_pairs`` / ``frontier_expand``)
    answer as the planner's own package's hosts do."""
    def over(Pc, Ph):
        engines = [Ph.engine(BENCH_FRONTIER) for _ in range(3)]
        with serving(Ph.EngineServer, engines[0]) as a, \
                serving(Ph.EngineServer, engines[1]) as b, \
                serving(Ph.EngineServer, engines[2]) as c:
            clients = [Pc.RemoteEngine("127.0.0.1", s.port, timeout=30)
                       for s in (a, b, c)]
            try:
                return _bench_run(Pc, clients, Pc.engine(BENCH_FRONTIER),
                                  12)
            finally:
                for cl in clients:
                    cl.close()

    same = over(JAX, JAX)
    assert over(JAX, PORT) == same
    assert over(PORT, JAX) == same
    assert over(PORT, PORT) == same


def _chain(P, max_rounds: int = 8):
    """The 2-hop cross-shard chain: u0 -> teamB (group 0) -> teamA
    (group 1) -> doc (group 0, owned by teamA#member)."""
    smap = _map(P, 2)
    engines = [P.engine(NESTED), P.engine(NESTED)]
    p = P.ShardedEngine(smap, engines,
                        frontier=P.FrontierConfig(max_rounds=max_rounds))
    oracle = P.engine(NESTED)

    def ns_on(rtype, group, tag):
        return next(f"{tag}{i}" for i in range(10_000)
                    if smap.shard_for(f"{tag}{i}", rtype) == group)

    team_b = ns_on("team", 0, "tb") + "/t"
    team_a = ns_on("team", 1, "ta") + "/t"
    doc = ns_on("doc", 0, "dd") + "/d"
    writes = [w(P, "create", "team", team_b, "member", "user", "u0"),
              w(P, "create", "team", team_a, "member", "team", team_b,
                "member"),
              w(P, "create", "doc", doc, "owner", "team", team_a,
                "member"),
              w(P, "create", "doc", doc, "viewer", "user", "direct")]
    p.write_relationships(writes)
    oracle.write_relationships(writes)
    return p, engines, oracle, (team_b, team_a, doc)


def test_nested_chain_oracle_parity_and_counters():
    def run(P):
        p, engines, oracle, (team_b, team_a, doc) = _chain(P)
        c0 = _counters(P)
        for rt, rid in (("team", team_b), ("team", team_a), ("doc", doc)):
            f = P.RelationshipFilter(resource_type=rt, resource_id=rid)
            assert sum(1 for e in engines if e.store.exists(f)) == 1
        verdicts = []
        for sid in ("u0", "direct", "intruder"):
            item = P.CheckItem("doc", doc, "view", "user", sid)
            got = p.check(item)
            assert got == oracle.check(item), sid
            verdicts.append(got)
        assert verdicts == [True, True, False]
        ids = sorted(p.lookup_resources("doc", "view", "user", "u0"))
        assert ids == sorted(oracle.lookup_resources("doc", "view",
                                                     "user", "u0"))
        assert p.lookup_resources("doc", "view", "user", "intruder") == []
        closure = sorted(p.frontier_closure("user", "u0"), key=str)
        d = _delta(P, c0)
        assert 0 < d["scatter"] < 4096 and 0 < d["gather"] < 4096
        assert d["converged"] > 0
        p.close()
        return verdicts, ids, closure, d

    out = both(run)
    assert len(out[2]) == 2  # both teams, found across the two groups


def test_budget_exhaustion_fails_closed():
    def run(P):
        p, _, oracle, (team_b, team_a, doc) = _chain(P, max_rounds=1)
        c0 = _counters(P)
        assert oracle.check(P.CheckItem("doc", doc, "view", "user", "u0"))
        denied = p.check(P.CheckItem("doc", doc, "view", "user", "u0"))
        assert not denied
        listed = p.lookup_resources("doc", "view", "user", "u0")
        assert listed == []  # under-lists, never over-grants
        assert p.check(P.CheckItem("doc", doc, "view", "user", "direct"))
        d = _delta(P, c0)
        assert d["exhausted"] >= 1 and d["converged"] == 0
        p.close()
        return denied, listed, d

    both(run)


def test_non_monotone_schema_refused_on_first_use():
    def run(P):
        engines = [P.engine(NON_MONOTONE), P.engine(NON_MONOTONE)]
        p = P.ShardedEngine(_map(P, 2), engines,
                            frontier=P.FrontierConfig())
        with pytest.raises(P.FrontierError) as ei:
            p.check(P.CheckItem("doc", "a/d", "view", "user", "u0"))
        p.close()
        return str(ei.value)

    assert "monotone" in both(run)
