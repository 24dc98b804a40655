"""PyTorch port, the caveat VM (caveats/) and conditional grants through
the engine, held against the JAX package byte for byte: (a) the port's
``eval_caveats`` against the JAX ``eval_caveats`` on test_caveats.py's
randomized differential (10 random tapes x 4 requests), its IPv6 corpus,
division by zero, unseen request strings and request-list overflow; (b)
list masks, bulk verdicts and the missing-context counter of the port
Engine against the JAX Engine on a small graph of bench.py's caveated
mesh configuration (MESH_SCHEMA, MESH_CTXS) under push, pull and auto,
for a context both stored contexts allow, one only the first allows and
none; (c) a caveat combined with an expiration; (d) a caveated churn
differential: fallback reasons, the overlay's caveat rows, the instance
tables and the verdict-flip bounds after every write; (e) a reference
caveat table carried across by convert.py; (f) a compaction fold that
keeps the instance table; (g) the store's caveat columns, reads and watch
log, and the schema's caveat definitions. The JAX side runs its Pallas
kernels in interpreter mode; both sides lower DENSE_MIN_EDGES so dense
blocks and bit duals form. Every comparison is exact: the results are
booleans and integer counts.
"""

import random
import time

import jax
import numpy as np
import pytest
import torch

from bench import MESH_CTXS, MESH_SCHEMA
from chip_smoke import build_rows
from spicedb_kubeapi_proxy_tpu.caveats.ast import (
    CaveatDef as JCaveatDef,
    CaveatParam as JCaveatParam,
    CaveatType as JCaveatType,
    parse_caveat_body as jparse_body,
)
from spicedb_kubeapi_proxy_tpu.caveats.vm import \
    build_caveat_table as jbuild_table
from spicedb_kubeapi_proxy_tpu.caveats.vm import eval_caveats as jeval
from spicedb_kubeapi_proxy_tpu.engine import CheckItem as JCheckItem
from spicedb_kubeapi_proxy_tpu.engine import Engine as JEngine
from spicedb_kubeapi_proxy_tpu.engine.store import WriteOp as JWriteOp
from spicedb_kubeapi_proxy_tpu.models import parse_schema as jparse_schema
from spicedb_kubeapi_proxy_tpu.models.bootstrap import \
    parse_bootstrap as jparse_bootstrap
from spicedb_kubeapi_proxy_tpu.models.tuples import \
    Relationship as JRelationship
from spicedb_kubeapi_proxy_tpu.models.tuples import \
    parse_relationship as jparse_rel
from spicedb_kubeapi_proxy_tpu.ops import reachability as jreach
from spicedb_kubeapi_proxy_tpu.ops import semiring as jsemi
from spicedb_kubeapi_proxy_tpu.utils.metrics import metrics as jmetrics
from spicedb_kubeapi_proxy_tpu_torch.caveats import ast as tast
from spicedb_kubeapi_proxy_tpu_torch.caveats.vm import (
    build_caveat_table,
    eval_caveats,
)
from spicedb_kubeapi_proxy_tpu_torch.convert import from_reference_arrays
from spicedb_kubeapi_proxy_tpu_torch.engine import CheckItem, Engine
from spicedb_kubeapi_proxy_tpu_torch.engine.engine import SchemaViolation
from spicedb_kubeapi_proxy_tpu_torch.engine.store import (
    RelationshipFilter,
    WriteOp,
)
from spicedb_kubeapi_proxy_tpu_torch.models import SchemaError, parse_schema
from spicedb_kubeapi_proxy_tpu_torch.models.bootstrap import parse_bootstrap
from spicedb_kubeapi_proxy_tpu_torch.models.tuples import (
    Relationship,
    canonical_context,
    parse_relationship,
)
from spicedb_kubeapi_proxy_tpu_torch.ops import reachability as treach
from spicedb_kubeapi_proxy_tpu_torch.ops import semiring as tsemi
from spicedb_kubeapi_proxy_tpu_torch.utils.metrics import metrics

from test_caveats import (
    IP6_BOOT,
    IP_BOOT,
    _BASE_TS,
    _PARAMS,
    _gen_bool,
    _rand_ctx,
)
from torch_parity import flatten_graph

CPU = torch.device("cpu")
# the JAX VM as the reference's fixpoint runs it, inside a jit (one trace
# per tape shape; an eager call retraces its scan every time)
jeval_jit = jax.jit(jeval, static_argnums=(0, 3))
NOW = time.time()
# phase 10's three request contexts: both stored contexts allow the
# first, only the first stored context allows the second, and without
# one every caveated grant fails closed
CONTEXTS = ({"ip": "10.1.2.3"}, {"ip": "192.168.1.1"}, None)
MISSING = "engine_caveat_denied_missing_context_total"


@pytest.fixture
def interpreted(monkeypatch):
    monkeypatch.setenv("SDBKP_BITPROP", "interpret")
    monkeypatch.setenv("SDBKP_SEMIRING", "interpret")
    monkeypatch.setattr(jreach, "DENSE_MIN_EDGES", 8)
    monkeypatch.setattr(treach, "DENSE_MIN_EDGES", 8)


# -- (a) the VM against the JAX VM ---------------------------------------------


def _port_def(d):
    """A JAX-package CaveatDef as the port's, its body re-parsed."""
    expr = tast.parse_caveat_body(str(d.expr))
    assert str(expr) == str(d.expr)
    return tast.CaveatDef(d.name, tuple(
        tast.CaveatParam(p.name, tast.CaveatType(p.type.name, p.type.elem))
        for p in d.params), expr)


def _tables(jdefs: dict, inst: list, tdefs=None):
    """The same instance list tabled by both packages (``tdefs``: the
    port's definitions, else ``jdefs`` re-parsed): equal shapes and
    instance rows."""
    ids = np.arange(1, len(inst))
    jt = jbuild_table(jdefs, inst, ids)
    if tdefs is None:
        tdefs = {n: _port_def(d) for n, d in jdefs.items()}
    tt = build_caveat_table(tdefs, inst, ids)
    assert tt.signature() == jt.signature()
    np.testing.assert_array_equal(tt.inst_row, jt.inst_row)
    assert tt.key_row == jt.key_row
    return jt, tt


def _eval_both(jt, tt, ctx, now):
    """(cav_ok, missing) of one request on both VMs, asserted equal."""
    jreq, jts = jt.encode_request(ctx, now)
    treq, tts = tt.encode_request(ctx, now)
    assert tts == jts
    jok, jmiss = jeval_jit(jt.metas, jt.device_static(), jreq, jt.n_rows)
    tok, tmiss = eval_caveats(tt.metas, tt.device_static(CPU), treq,
                              tt.n_rows)
    assert tok.dtype == torch.uint8
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    assert int(tmiss) == int(jmiss)
    return tok.numpy(), int(tmiss)


def test_vm_randomized_differential():
    """test_caveats' differential, on both VMs: 10 random tapes over
    every parameter type, 6 random tuple contexts each, 4 requests."""
    rng = random.Random(20260803)
    seen_missing = seen_allow = 0
    for _ in range(10):
        expr = _gen_bool(rng, 3)
        inst = [("", "")] + [
            ("c", canonical_context(_rand_ctx(rng)) or "") for _ in range(6)]
        jt, tt = _tables({"c": JCaveatDef("c", _PARAMS, expr)}, inst)
        for _ in range(4):
            ctx = _rand_ctx(rng)
            ctx.setdefault("now", _BASE_TS)
            ok, missing = _eval_both(jt, tt, ctx, _BASE_TS)
            seen_missing += missing
            seen_allow += int(ok[1:].sum())
    assert seen_missing and seen_allow  # the corpus exercises both arms


def test_vm_ipv6_corpus():
    """The IPv6 corpus of test_caveats over every caveat shape of its
    schema (literal mixed-family CIDR list, wide equality and order, a
    parameter list holding a v6 element and a v4-only one)."""
    defs = jparse_bootstrap(IP6_BOOT).schema.caveat_defs
    tdefs = parse_bootstrap(IP6_BOOT).schema.caveat_defs
    inst = [("", ""), ("office_net", ""),
            ("same_addr", canonical_context({"peer": "2001:db8::42"})),
            ("below", canonical_context({"peer": "2001:db8::100"})),
            ("dyn_list", canonical_context(
                {"allowed": ["10.1.0.0/16", "2001:db8::/64"]})),
            ("dyn_list", canonical_context({"allowed": ["10.1.0.0/16"]}))]
    jt, tt = _tables(dict(defs), inst, dict(tdefs))
    assert max(m.T for m in tt.metas) > 8  # the wide lowering's tapes
    corpus = [
        "2001:db8::", "2001:db8::1", "2001:db8::42", "2001:db8::100",
        "2001:db8::ffff:ffff:ffff:ffff", "2001:db8:0:1::", "fe80::1",
        "::1", "::", "ffff:ffff:ffff:ffff:ffff:ffff:ffff:ffff",
        "10.0.0.0", "10.1.2.3", "10.255.255.255", "11.0.0.0",
        "192.168.1.7", "0.0.0.0", "255.255.255.255",
        "::ffff:10.0.0.1", "::ffff:192.168.1.7", "not-an-ip"]
    allowed = set()
    for ip in corpus:
        ok, _ = _eval_both(jt, tt, {"ip": ip}, 0.0)
        allowed |= {(ip, r) for r in np.flatnonzero(ok[1:]).tolist()}
    assert len(allowed) > 10
    _eval_both(jt, tt, None, 0.0)


def _one(name, params, body, ctx_json=""):
    d = JCaveatDef(name, tuple(JCaveatParam(n, JCaveatType(*t))
                               for n, t in params), jparse_body(body))
    td = tast.CaveatDef(name, tuple(tast.CaveatParam(n, tast.CaveatType(*t))
                                    for n, t in params),
                        tast.parse_caveat_body(body))
    return _tables({name: d}, [("", ""), (name, ctx_json)], {name: td})


@pytest.mark.parametrize("case", ["div-by-zero", "unseen-strings",
                                  "list-overflow"])
def test_vm_edge_cases(case):
    if case == "div-by-zero":
        # a / 0 has no verdict: missing context, fail closed
        jt, tt = _one("d", [("a", ("int",)), ("b", ("int",))], "a / b >= 1",
                      canonical_context({"a": 4}))
        got = [_eval_both(jt, tt, {"b": b}, 0.0) for b in (2, 8, 0)]
        assert [(int(ok[1]), m) for ok, m in got] == [(1, 0), (0, 0), (0, 1)]
    elif case == "unseen-strings":
        # two unseen request strings never compare equal (distinct
        # scratch codes); equal ones do
        jt, tt = _one("own", [("user", ("string",)), ("owner", ("string",))],
                      "user == owner")
        assert _eval_both(jt, tt, {"user": "mallory", "owner": "prod"},
                          0.0)[0][1] == 0
        assert _eval_both(jt, tt, {"user": "same", "owner": "same"},
                          0.0)[0][1] == 1
        jt, tt = _one("mem", [("u", ("string",)),
                              ("us", ("list", "string"))], "u in us")
        assert _eval_both(jt, tt, {"u": "eve", "us": ["adam", "bob"]},
                          0.0)[0][1] == 0
        assert _eval_both(jt, tt, {"u": "bob", "us": ["adam", "bob"]},
                          0.0)[0][1] == 1
    else:
        # a request list past the table's capacity (K=16) stays UNKNOWN
        # and is counted on both sides; one at capacity is exact
        jt, tt = _one("grp", [("team", ("string",)),
                              ("groups", ("list", "string"))],
                      "team in groups", canonical_context({"team": "g7"}))
        key = "engine_caveat_request_list_overflow_total"
        j0, t0 = jmetrics.counter(key).value, metrics.counter(key).value
        ok, missing = _eval_both(jt, tt, {"groups": [f"g{i}" for i in
                                                      range(16)]}, 0.0)
        assert ok[1] == 1 and missing == 0
        ok, missing = _eval_both(jt, tt, {"groups": [f"g{i}" for i in
                                                      range(17)]}, 0.0)
        assert ok[1] == 0 and missing == 1
        assert metrics.counter(key).value - t0 == 1
        assert jmetrics.counter(key).value - j0 == 1


# -- (b) the engine against the JAX engine -------------------------------------


def _mesh_rows(seed=2):
    """A small graph of bench.py's caveated mesh mix, by chip_smoke's
    generator: 30% of the flat pod#viewer grants carry ip_allowlist,
    alternating the two stored contexts, and a nested group chain."""
    return build_rows(48, 16, 4, 8, 700, seed, cav_share=0.3)


def _mesh_engines(rows=None):
    rows = _mesh_rows() if rows is None else rows
    je = JEngine(schema=jparse_schema(MESH_SCHEMA))
    te = Engine(schema=parse_schema(MESH_SCHEMA), device="cpu")
    je.bulk_load(rows)
    te.bulk_load(rows)
    # instance ids follow the reference's interning order
    assert te.store.caveat_instances == je.store.caveat_instances
    return je, te


def _counted(reg, fn):
    c0 = reg.counter(MISSING).value
    out = fn()
    return out, reg.counter(MISSING).value - c0


@pytest.mark.parametrize("mode", ["auto", "push", "pull"])
def test_engine_mesh_parity(interpreted, mode):
    rows = _mesh_rows()
    assert set(rows["caveat_context"]) == {""} | set(MESH_CTXS)
    je, te = _mesh_engines(rows)
    tcg = te.compiled()
    assert any(b.n_dst for b in tcg.blocks)
    assert tcg.caveats.n_inst == 2 and tcg.run_meta().cav_rows == 9
    assert np.count_nonzero(tcg.res_cav) == int(
        (rows["caveat"] != "").sum())
    users = [f"u{i}" for i in range(16)] + ["nobody"]
    masks = {}
    with jsemi.force_mode(mode), tsemi.force_mode(mode):
        for ctx in CONTEXTS:
            oracle = te.oracle(now=NOW, context=ctx)
            for u in users:
                (jm, _), jn = _counted(jmetrics, lambda: je.lookup_resources_mask(
                    "pod", "view", "user", u, now=NOW, context=ctx))
                (tm, pods), tn = _counted(metrics, lambda: te.lookup_resources_mask(
                    "pod", "view", "user", u, now=NOW, context=ctx))
                np.testing.assert_array_equal(tm, jm, err_msg=f"{u} {ctx}")
                assert tn == jn == (2 if ctx is None else 0)
                assert {pods.string(i) for i in np.flatnonzero(tm)} == \
                    oracle.lookup_resources("pod", "view", "user", u)
                masks[(u, None if ctx is None else ctx["ip"])] = tm
            items = [("pod", f"ns/p{p}", "view", "user", u)
                     for u in users[:10] for p in range(48)]
            want, jn = _counted(jmetrics, lambda: je.check_bulk(
                [JCheckItem(*it) for it in items], now=NOW, context=ctx))
            got, tn = _counted(metrics, lambda: te.check_bulk(
                [CheckItem(*it) for it in items], now=NOW, context=ctx))
            assert got == want and tn == jn
            assert got == [oracle.check(*it) for it in items]
    # the caveat bites: allow-both >= allow-first >= none, strictly
    both = sum(int(masks[(u, "10.1.2.3")].sum()) for u in users)
    first = sum(int(masks[(u, "192.168.1.1")].sum()) for u in users)
    none = sum(int(masks[(u, None)].sum()) for u in users)
    for u in users:
        assert not (masks[(u, "192.168.1.1")] & ~masks[(u, "10.1.2.3")]).any()
        assert not (masks[(u, None)] & ~masks[(u, "192.168.1.1")]).any()
    assert both > first > none


def test_caveat_with_expiration(interpreted):
    """A conditional grant that also expires: allowed only while live and
    under a satisfying context, on both engines and the oracle."""
    je, te = JEngine(IP_BOOT), Engine(IP_BOOT, device="cpu")
    soon = time.time() + 60
    ctx_json = canonical_context({"allowed": ["10.0.0.0/8"]})
    for e, R, W in ((je, JRelationship, JWriteOp), (te, Relationship,
                                                    WriteOp)):
        e.write_relationships([W("touch", R(
            "doc", "readme", "viewer", "user", "carol", None, soon,
            "ip_allowlist", ctx_json))])
    cells = [(soon - 30, {"ip": "10.1.1.1"}, True),
             (soon - 30, {"ip": "11.1.1.1"}, False),
             (soon - 30, None, False),
             (soon + 30, {"ip": "10.1.1.1"}, False)]
    for now, ctx, want in cells:
        got = te.check(CheckItem("doc", "readme", "view", "user", "carol"),
                       now=now, context=ctx)
        assert got is want
        assert je.check(JCheckItem("doc", "readme", "view", "user",
                                   "carol"), now=now, context=ctx) is want
        assert te.oracle(now=now, context=ctx).check(
            "doc", "readme", "view", "user", "carol") is want


# -- (d) caveated churn --------------------------------------------------------

CHURN_SCHEMA = """
use expiration

caveat ip_allowlist(ip ipaddress, allowed list<ipaddress>) {
  ip in allowed
}
caveat after(now timestamp, start timestamp) { now >= start }

definition user {}
definition group {
  relation member: user | group#member | group#member with ip_allowlist
}
definition doc {
  relation viewer: user | user with ip_allowlist | user with after
  relation group: group
  permission view = viewer + group->member
}
"""

REASONS = ("layout", "overflow", "stratification-inversion",
           "closured-expiry", "closured-caveat", "caveat", "unlogged",
           "history-trimmed", "unstratified")


def _ctx(*nets):
    return canonical_context({"allowed": list(nets)})


def _churn_base():
    rels = [f"group:g{i % 3}#member@user:u{i}" for i in range(9)]
    rels += ["group:g0#member@group:g1#member",
             "group:g1#member@group:g2#member"]
    rels += [f"doc:d{i}#group@group:g{i % 3}" for i in range(6)]
    rels += [f"doc:d{i}#viewer@user:u{(i + 4) % 9}" for i in range(6)]
    rels += [f'doc:d{i}#viewer@user:u{i}[ip_allowlist:{_ctx("10.0.0.0/8")}]'
             for i in range(3)]
    rels += [f'doc:d{i}#viewer@user:u{i}'
             f'[ip_allowlist:{_ctx("192.168.0.0/16")}]' for i in range(3, 6)]
    return rels


def _churn_plan():
    """Writes, each a list of (op, relationship string): reuse of a stored
    context; a new context on a spare row, reused in the same write; a
    caveat attached to a base grant, then stripped; a delete; a
    conditional edge inside the closured group chain (closured-caveat);
    new contexts filling the 8-row bucket, then one more (caveat); the
    first tuple of a caveat the compile saw no instance of (caveat), and
    a second one on a spare row, which extends the verdict-flip bounds."""
    t0 = int(NOW) - 100

    def grant(doc, user, net):
        return ("touch", f"doc:{doc}#viewer@user:{user}"
                         f"[ip_allowlist:{_ctx(net)}]")

    return [[grant("d0", "u7", "10.0.0.0/8")],
            [grant("d1", "u8", "10.1.0.0/16"),
             grant("d2", "u8", "10.1.0.0/16")],
            [grant("d0", "u4", "10.0.0.0/8")],
            [("touch", "doc:d0#viewer@user:u4")],
            [("delete", "doc:d3#viewer@user:u3")],
            [("touch", "group:g0#member@group:g2#member"
                       f"[ip_allowlist:{_ctx('10.0.0.0/8')}]")],
            [grant("d5", f"u{k}", f"10.{k}.0.0/16") for k in range(2, 7)],
            [grant("d5", "u8", "10.8.0.0/16")],
            [("touch", f'doc:d4#viewer@user:u1[after:{{"start":{t0}}}]')],
            [("touch",
              f'doc:d4#viewer@user:u2[after:{{"start":{t0 + 50}}}]')]]


def _graph_state(cg) -> dict:
    c = cg.caveats
    return {"n_delta": cg.n_delta,
            "delta_cav": np.array(cg.delta_cav[:cg.n_delta]),
            "delta_exp": np.array(cg.delta_exp[:cg.n_delta]),
            "res_cav": np.array(cg.res_cav),
            "key_row": dict(c.key_row), "inst_row": np.array(c.inst_row),
            "n_inst": c.n_inst, "n_rows": c.n_rows,
            "time_bounds": np.array(c.time_bounds),
            "metas": [tuple(m.__dict__.values()) for m in c.metas],
            "hosts": [[np.array(getattr(h, k)) for k in (
                "ctx_e", "ctx_v", "ctx_k", "lo_e", "lo_v", "hi_e", "hi_v",
                "list_k", "real")] for h in c.hosts]}


def _assert_same_state(a: dict, b: dict, where: str):
    assert a.keys() == b.keys()
    for k in a:
        if k == "hosts":
            assert len(a[k]) == len(b[k]), where
            for ha, hb in zip(a[k], b[k]):
                for x, y in zip(ha, hb):
                    np.testing.assert_array_equal(x, y, err_msg=where)
        elif isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{where} {k}")
        else:
            assert a[k] == b[k], f"{where} {k}"


def test_caveated_churn_differential(interpreted, monkeypatch):
    # blocks from 2 edges up: the two-edge group chain is a closured block
    monkeypatch.setattr(jreach, "DENSE_MIN_EDGES", 2)
    monkeypatch.setattr(treach, "DENSE_MIN_EDGES", 2)
    je = JEngine(schema=jparse_schema(CHURN_SCHEMA))
    te = Engine(schema=parse_schema(CHURN_SCHEMA), device="cpu")
    base = _churn_base()
    for e, W, parse in ((je, JWriteOp, jparse_rel), (te, WriteOp,
                                                     parse_relationship)):
        e.write_relationships([W("touch", parse(r)) for r in base])
    je.compiled()
    tcg = te.compiled()
    assert any(b.closured for b in tcg.blocks)
    assert tcg.caveats.n_inst == 2 and tcg.caveats.metas[0].n_pad == 8
    ctx = {"ip": "10.3.4.5"}
    items = [("doc", f"d{i}", "view", "user", f"u{j}")
             for i in range(6) for j in range(9)]
    seen = set()
    for step, ops in enumerate(_churn_plan()):
        fj = {r: jmetrics.counter("engine_graph_incremental_fallback_total",
                                  reason=r).value for r in REASONS}
        ft = {r: metrics.counter("engine_graph_incremental_fallback_total",
                                 reason=r).value for r in REASONS}
        je.write_relationships([JWriteOp(op, jparse_rel(t)) for op, t in ops])
        te.write_relationships([WriteOp(op, parse_relationship(t))
                                for op, t in ops])
        dj = {r: jmetrics.counter("engine_graph_incremental_fallback_total",
                                  reason=r).value - fj[r] for r in REASONS}
        dt = {r: metrics.counter("engine_graph_incremental_fallback_total",
                                 reason=r).value - ft[r] for r in REASONS}
        assert dt == dj, f"step {step}: {dt} != {dj}"
        seen |= {r for r, v in dt.items() if v}
        want = je.check_bulk([JCheckItem(*it) for it in items], now=NOW,
                             context=ctx)
        got = te.check_bulk([CheckItem(*it) for it in items], now=NOW,
                            context=ctx)
        assert got == want, f"step {step}"
        oracle = te.oracle(now=NOW, context=ctx)
        assert got == [oracle.check(*it) for it in items]
        _assert_same_state(_graph_state(je.compiled()),
                           _graph_state(te.compiled()), f"step {step}")
    assert seen == {"caveat", "closured-caveat"}


# -- (e) convert, (f) compaction ------------------------------------------------


def test_convert_carries_caveat_table(interpreted):
    """A JAX-compiled caveated graph carried across evaluates the same VM
    rows and answers the same masks under every context."""
    je, _ = _mesh_engines()
    jcg = je.compiled()
    tcg = from_reference_arrays(flatten_graph(jcg), device="cpu")
    jc, tc = jcg.caveats, tcg.caveats
    assert tc.signature() == jc.signature() and tc.key_row == jc.key_row
    np.testing.assert_array_equal(tc.time_bounds, jc.time_bounds)
    np.testing.assert_array_equal(tcg.res_cav, jcg.res_cav)
    objs = je._objects_by_name()
    off, n = jcg.offset_of("pod", "view"), jcg.type_sizes["pod"]
    qs = off + np.arange(n, dtype=np.int32)
    qb = np.zeros(n, dtype=np.int32)
    for ctx in CONTEXTS:
        _eval_both(jc, tc, ctx, NOW)
        for u in ("u0", "u3", "u7"):
            seeds = np.asarray([jcg.encode_subject("user", u, None, objs)],
                               dtype=np.int32)
            jf = jcg.query_async(seeds, qs, qb, now=NOW, context=ctx)
            tf = tcg.query_async(seeds, qs, qb, now=NOW, context=ctx)
            np.testing.assert_array_equal(tf.result(), jf.result())
            assert tf.caveats_missing() == jf.caveats_missing()


def test_compaction_keeps_instance_table(interpreted):
    """Caveated writes (a new context on a spare row among them) folded
    by the compactor: the fresh base holds the same instance table as
    the JAX engine's fold, and the same masks."""
    je, te = _mesh_engines()
    for e in (je, te):
        e.compiled()
    new = _ctx("172.16.0.0/12")
    for k in range(4):
        text = f"pod:ns/p{k}#viewer@user:u{k + 1}[ip_allowlist:{new}]"
        je.write_relationships([JWriteOp("touch", jparse_rel(text))])
        te.write_relationships([WriteOp("touch", parse_relationship(text))])
    for e in (je, te):
        c = e.enable_compaction()
        assert c.compact()
        e.close_compaction()
    jc, tc = je.compiled().caveats, te.compiled().caveats
    assert te.compiled().n_delta == 0 and tc.n_inst == 3
    assert tc.key_row == jc.key_row and tc.signature() == jc.signature()
    np.testing.assert_array_equal(tc.inst_row, jc.inst_row)
    ctx = {"ip": "172.16.5.5"}
    for u in ("u1", "u2", "u3", "u4"):
        jm, _ = je.lookup_resources_mask("pod", "view", "user", u, now=NOW,
                                         context=ctx)
        tm, _ = te.lookup_resources_mask("pod", "view", "user", u, now=NOW,
                                         context=ctx)
        np.testing.assert_array_equal(tm, jm)


# -- (g) store and schema --------------------------------------------------------


def test_store_caveat_columns_reads_and_watch():
    """bulk_load's caveat columns (with the reference's validation),
    the shared instance table, reads and watch records that carry
    caveat and context."""
    e = Engine(IP_BOOT, device="cpu")
    je = JEngine(IP_BOOT)
    ok_cols = {
        "resource_type": ["doc"], "resource_id": ["bk"],
        "relation": ["viewer"], "subject_type": ["user"],
        "subject_id": ["zed"], "caveat": ["ip_allowlist"],
        "caveat_context": ['{"allowed":["10.0.0.0/8"]}'],
    }
    e.bulk_load(ok_cols)
    je.bulk_load(ok_cols)
    assert e.check(CheckItem("doc", "bk", "view", "user", "zed"),
                   context={"ip": "10.1.1.1"})
    with pytest.raises(SchemaViolation):
        e.bulk_load({**ok_cols, "resource_id": ["bk2"],
                     "caveat": ["ip_allowlst"]})
    with pytest.raises(SchemaViolation):
        e.bulk_load({**ok_cols, "resource_id": ["bk3"],
                     "caveat_context": ['{"allowed":"not-a-list"}']})
    assert e.store.snapshot().caveat_instances == \
        je.store.snapshot().caveat_instances
    rel = parse_relationship(
        'doc:z#viewer@user:w[ip_allowlist:{"allowed":["10.9.9.9"]}]')
    rev0 = e.revision
    e.write_relationships([WriteOp("touch", rel)])
    ev = e.watch_since(rev0)[-1].relationship
    assert (ev.caveat, ev.caveat_context) == (
        "ip_allowlist", '{"allowed":["10.9.9.9"]}')
    got = e.read_relationships(RelationshipFilter(resource_type="doc",
                                                  resource_id="z"))
    assert got == [rel]
    with pytest.raises(SchemaViolation, match="no parameter"):
        e.write_relationships([WriteOp("touch", parse_relationship(
            'doc:x#viewer@user:d2[ip_allowlist:{"nope":1}]'))])
    e3 = Engine(schema=parse_schema("""
      caveat ip_allowlist(ip ipaddress, allowed list<ipaddress>) {
        ip in allowed
      }
      definition user {}
      definition doc {
        relation viewer: user with ip_allowlist
        permission view = viewer
      }"""), device="cpu")
    with pytest.raises(SchemaViolation, match="does not allow"):
        e3.write_relationships([WriteOp("touch", parse_relationship(
            "doc:x#viewer@user:plain"))])


def test_schema_caveat_definitions_match():
    """The port parses caveat definitions as the JAX package does, and
    refuses what it refuses."""
    for text in (MESH_SCHEMA, CHURN_SCHEMA,
                 IP6_BOOT.split("|-")[1].split("relationships:")[0]):
        js, ts = jparse_schema(text), parse_schema(text)
        assert ts.caveats == js.caveats
        for name, jd in js.caveat_defs.items():
            td = ts.caveat_defs[name]
            assert [(p.name, str(p.type)) for p in td.params] == \
                [(p.name, str(p.type)) for p in jd.params]
            assert str(td.expr) == str(jd.expr)
        assert {(d, r, str(a), a.caveat)
                for d, dd in ts.definitions.items()
                for r, rr in dd.relations.items() for a in rr.allowed} == \
            {(d, r, str(a), a.caveat)
             for d, dd in js.definitions.items()
             for r, rr in dd.relations.items() for a in rr.allowed}
    for bad, msg in (("caveat c(a int) { a == 1 }\n"
                      "caveat c(b int) { b == 1 }\ndefinition user {}",
                      "duplicate caveat"),
                     ("caveat c(x frobnicator) { true }\ndefinition u {}",
                      "parameter type"),
                     ("caveat c(day string) { day + 1 == 2 }\n"
                      "definition user {}", "caveat"),
                     ("definition user {}\ndefinition doc {\n"
                      "  relation viewer: user with expirations\n}",
                      "unknown trait")):
        with pytest.raises(SchemaError, match=msg):
            parse_schema(bad)
    with pytest.raises(ValueError, match="unknown trait"):
        parse_bootstrap(IP_BOOT.replace("[ip_allowlist:", "[ip_alowlist:"))
