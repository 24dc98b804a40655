"""PyTorch port, tracing inside the engine: obs/trace.py's spans on the
list and check paths, the profiler bridge and ``engine_host_syncs_total``.

Every ``tracer.span`` of the engine (``engine.lookup``,
``engine.dispatch``, ``fixpoint``, ``caveat_vm``, ``host_sync``,
``engine.result``, ``engine.batch_wait``, ``engine.check``,
``engine.encode_checks``) records on
a request trace when one is active, and opens a ``record_function`` range
of its name while a torch profiler records; with neither it is one shared
no-op. The async ``device`` leaf span goes to request traces only. Runs
on the CPU on a small caveated graph (an ip_allowlist caveat on a third
of the pod grants, a nested group chain).
"""

from __future__ import annotations

import threading
import timeit

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from spicedb_kubeapi_proxy_tpu_torch.engine import CheckItem, Engine, WriteOp
from spicedb_kubeapi_proxy_tpu_torch.models import parse_schema
from spicedb_kubeapi_proxy_tpu_torch.models.tuples import parse_relationship
from spicedb_kubeapi_proxy_tpu_torch.obs import trace as trace_mod
from spicedb_kubeapi_proxy_tpu_torch.obs.trace import NULL_SPAN, tracer
from spicedb_kubeapi_proxy_tpu_torch.ops import semiring
from spicedb_kubeapi_proxy_tpu_torch.utils.metrics import metrics

SCHEMA = """
caveat ip_allowlist(ip ipaddress, allowed list<ipaddress>) {
  ip in allowed
}

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
  relation viewer: user | user with ip_allowlist
  permission view = viewer + namespace->view
}
"""

ALLOWED = '{"allowed":["10.0.0.0/8"]}'
CTX = {"ip": "10.1.2.3"}
# the engine's spans of one list, by the path it takes
LIST_SPANS = {"engine.lookup", "engine.dispatch", "fixpoint", "caveat_vm",
              "host_sync", "engine.result"}
SITES = ("iter", "level", "readback")


def _rels() -> list:
    rels = []
    for g in range(4):  # a nested chain: group g+1 holds group g
        rels.append(f"group:g{g + 1}#member@group:g{g}#member")
    for u in range(12):
        rels.append(f"group:g{u % 5}#member@user:u{u}")
    for n in range(6):
        rels.append(f"namespace:n{n}#viewer@group:g{n % 5}#member")
    for p in range(30):
        rels.append(f"pod:p{p}#namespace@namespace:n{p % 6}")
        grant = f"pod:p{p}#viewer@user:u{p % 12}"
        rels.append(grant + (f"[ip_allowlist:{ALLOWED}]" if p % 3 == 0
                             else ""))
    return rels


@pytest.fixture
def engine():
    e = Engine(schema=parse_schema(SCHEMA), device="cpu")
    e.write_relationships([WriteOp("touch", parse_relationship(r))
                           for r in _rels()])
    e.compiled()
    yield e
    e.disable_lookup_batching()


@pytest.fixture
def traced():
    """Keep-everything request tracing for the test, the defaults after."""
    tracer.configure(sample=1.0, slow_ms=250.0, ring=256)
    tracer.reset()
    yield
    tracer.configure(sample=0.1, slow_ms=250.0, ring=256)
    tracer.reset()


def _syncs() -> dict:
    return {s: metrics.counter("engine_host_syncs_total", site=s).value
            for s in SITES}


def _profile_all_threads():
    from torch._C._profiler import _ExperimentalConfig

    return profile(activities=[ProfilerActivity.CPU],
                   experimental_config=_ExperimentalConfig(
                       profile_all_threads=True))


def _ranges(prof, names) -> list:
    """(start_ns, end_ns, name, thread) of the host ranges named in
    ``names``, in start order."""
    out = []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == DeviceType.CPU and ev.name() in names:
            out.append((ev.start_ns(), ev.start_ns() + ev.duration_ns(),
                        ev.name(), ev.start_thread_id()))
    return sorted(out)


def _spans(kept: dict) -> list:
    return sorted(kept["spans"], key=lambda s: s["start_ns"])


def test_idle_span_is_the_shared_no_op(engine, monkeypatch):
    """No request trace and no profiler: a lookup and a check open no
    range and make no span (nor a scope for one), and record nothing."""
    assert tracer.span("engine.lookup", resource_type="pod") is NULL_SPAN
    with tracer.span("fixpoint") as sp:
        assert sp is NULL_SPAN

    def refuse(*a, **k):
        raise AssertionError("a span site did work with nothing recording")

    monkeypatch.setattr(trace_mod, "_SpanScope", refuse)
    monkeypatch.setattr(trace_mod, "Span", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    tracer.reset()
    mask, _ = engine.lookup_resources_mask("pod", "view", "user", "u0",
                                           context=CTX)
    assert mask.any()
    assert engine.check_bulk([CheckItem("pod", "p0", "view", "user", "u0")],
                             context=CTX) == [True]
    assert tracer.begin("device") is None
    assert tracer.recent() == []


def test_idle_span_site_costs_a_fraction_of_a_range():
    """With nothing recording, a span site (the shared no-op) costs a
    small part of what a bare ``record_function`` costs with no profiler
    on, which is what every site would pay if it opened a range."""

    def site():
        with tracer.span("host_sync", site="iter"):
            pass

    def bare():
        with torch.profiler.record_function("host_sync"):
            pass

    def per_call_us(fn, n):
        return min(timeit.repeat(fn, number=n, repeat=5)) / n * 1e6

    tracer.reset()
    got_site = per_call_us(site, 20000)
    got_bare = per_call_us(bare, 2000)
    print(f"span site {got_site:.3f} us, bare record_function "
          f"{got_bare:.3f} us")
    assert got_site < 0.5 * got_bare


@pytest.mark.parametrize("path", ["direct", "fused"])
def test_profiler_sees_the_engine_spans_on_its_clock(engine, traced, path):
    """Under a CPU profiler of all threads, a direct (contexted) and a
    fused (two rows) lookup leave the engine's ranges, nested on their
    thread; inside a request trace each span's recorded start and end
    match its range's within 1 ms. The async ``device`` span is no
    range."""
    if path == "fused":
        engine.enable_lookup_batching(window=5.0, max_rows=2)
        users, ctx = ("u0", "u3"), None
    else:
        users, ctx = ("u0",), CTX
    prof = _profile_all_threads()
    prof.start()
    try:
        with tracer.span("warm"):
            pass  # torch resolves the range's operators on first use
        with tracer.start("request"):
            # the last submit fills the batch and dispatches it here
            futs = [engine.lookup_resources_mask_async(
                "pod", "view", "user", u, context=ctx) for u in users]
            masks = [f.result()[0] for f in futs]
    finally:
        prof.stop()
    assert all(m is not None and m.any() for m in masks)
    names = LIST_SPANS | {"device"}
    ranges = _ranges(prof, names)
    assert {r[2] for r in ranges} == LIST_SPANS
    assert len({r[3] for r in ranges}) == 1  # all on the calling thread

    def inside(r, parent):
        return any(p[2] == parent and p[0] <= r[0] and r[1] <= p[1]
                   for p in ranges)

    for r in ranges:
        if r[2] == "host_sync":
            assert inside(r, "fixpoint") or inside(r, "engine.result"), r
        elif r[2] == "fixpoint":
            assert inside(r, "engine.dispatch"), r
        elif r[2] == "caveat_vm":
            assert inside(r, "fixpoint"), r
        elif r[2] == "engine.dispatch":
            assert inside(r, "engine.lookup"), r
    assert sum(r[2] == "engine.lookup" for r in ranges) == len(users)
    assert sum(r[2] == "engine.dispatch" for r in ranges) == 1
    assert sum(r[2] == "engine.result" for r in ranges) == len(users)

    (kept,) = tracer.recent()
    spans = [s for s in _spans(kept) if s["name"] in LIST_SPANS]
    assert len(spans) == len(ranges)
    for sp, r in zip(spans, ranges):
        assert sp["name"] == r[2]
        end = sp["start_ns"] + sp["duration_us"] * 1000
        assert abs(sp["start_ns"] - r[0]) < 1_000_000, (sp, r)
        assert abs(end - r[1]) < 1_000_000, (sp, r)


def test_request_trace_records_the_engine_spans(engine, traced):
    """An in-process lookup and check inside a request trace record the
    engine's spans with their attributes and parents, and the ``device``
    leaf span with the fixpoint's iterations (and, for a list, the
    frontier's occupancy)."""
    with tracer.start("request"):
        mask, _ = engine.lookup_resources_mask("pod", "view", "user", "u0",
                                               context=CTX)
        got = engine.check_bulk(
            [CheckItem("pod", f"p{p}", "view", "user", "u0")
             for p in range(6)], context=CTX)
    assert got == [bool(mask[engine._objects_by_name()["pod"].id_map()[
        f"p{p}"]]) for p in range(6)]
    (kept,) = tracer.recent()
    spans = _spans(kept)
    by_id = {s["span_id"]: s for s in spans}
    names = {s["name"] for s in spans}
    assert LIST_SPANS | {"device", "engine.check",
                         "engine.encode_checks"} <= names

    def parent(s):
        return by_id.get(s["parent_id"], {}).get("name")

    for s in spans:
        if s["name"] == "engine.dispatch":
            assert parent(s) == "engine.lookup"
            assert s["attrs"] == {"rows": 1}
        elif s["name"] == "fixpoint":
            assert parent(s) in ("engine.dispatch", "engine.check")
            assert s["attrs"]["rows"] >= 1 and s["attrs"]["iters"] >= 1
        elif s["name"] == "caveat_vm":
            assert parent(s) == "fixpoint"
        elif s["name"] == "host_sync":
            assert parent(s) in ("fixpoint", "engine.result")
            assert s["attrs"]["site"] in SITES
        elif s["name"] == "engine.encode_checks":
            assert parent(s) == "engine.check"
            assert s["attrs"] == {"items": 6}
        elif s["name"] == "engine.lookup":
            assert s["attrs"] == {"resource_type": "pod",
                                  "permission": "view"}
    dev = {s["attrs"]["kind"]: s for s in spans if s["name"] == "device"}
    assert set(dev) == {"lookup", "check"}
    assert dev["lookup"]["attrs"]["frontier_occupancy"] == int(mask.sum())
    assert dev["lookup"]["attrs"]["fixpoint_iters"] >= 1
    assert dev["check"]["attrs"]["fixpoint_iters"] >= 1
    assert dev["check"]["attrs"]["rows"] == 6
    n_sync = sum(s["name"] == "host_sync" for s in spans)
    assert n_sync >= 4  # two fixpoints' iterations and two readbacks


@pytest.mark.parametrize("mode", ["push", "pull"])
def test_host_sync_counter_counts_a_known_fixpoint(engine, mode):
    """Outside auto mode no hop reads the occupancy: a list costs one
    read an iteration and one readback."""
    with semiring.force_mode(mode):
        before = _syncs()
        fut = engine.lookup_resources_mask_async("pod", "view", "user", "u1",
                                                 context=CTX)
        fut.result()
        fut.result()  # a future reads its answer back once
        after = _syncs()
    got = {s: after[s] - before[s] for s in SITES}
    assert fut.iterations() >= 2
    assert got == {"iter": fut.iterations(), "level": 0, "readback": 1}


def test_batch_wait_is_its_own_span(engine):
    """A fused lookup whose batch the timer dispatches: the caller's
    ``engine.result`` holds an ``engine.batch_wait`` range for the time
    it blocked, and the dispatch runs on the timer's thread."""
    engine.enable_lookup_batching(window=0.5, max_rows=8)
    prof = _profile_all_threads()
    prof.start()
    try:
        with tracer.span("warm"):
            pass
        futs = [engine.lookup_resources_mask_async("pod", "view", "user", u)
                for u in ("u6", "u7")]
        masks = [f.result()[0] for f in futs]
    finally:
        prof.stop()
    assert all(m is not None for m in masks)
    ranges = _ranges(prof, {"engine.result", "engine.batch_wait",
                            "engine.dispatch"})
    waits = [r for r in ranges if r[2] == "engine.batch_wait"]
    results = [r for r in ranges if r[2] == "engine.result"]
    (dispatch,) = [r for r in ranges if r[2] == "engine.dispatch"]
    assert len(results) == 2 and results[0][3] == results[1][3]
    me = results[0][3]  # the profiler's id of the calling thread
    # the first result blocks on the window; the second finds it resolved
    assert len(waits) == 1 and waits[0][3] == me
    assert results[0][0] <= waits[0][0] and waits[0][1] <= results[0][1]
    assert dispatch[3] != me
    # the batch resolves its futures before its dispatch range closes
    assert waits[0][0] <= dispatch[0] <= waits[0][1]


def test_host_sync_counter_matches_the_recorded_spans(engine, traced):
    """In auto mode, every counted read is one ``host_sync`` span of its
    site, and the iteration reads equal the fixpoint's iterations."""
    before = _syncs()
    with tracer.start("request"):
        fut = engine.lookup_resources_mask_async("pod", "view", "user", "u2",
                                                 context=CTX)
        fut.result()
    after = _syncs()
    (kept,) = tracer.recent()
    spans = [s for s in kept["spans"] if s["name"] == "host_sync"]
    for site in SITES:
        n = sum(s["attrs"]["site"] == site for s in spans)
        assert after[site] - before[site] == n, site
    assert after["iter"] - before["iter"] == fut.iterations()
    assert after["readback"] - before["readback"] == 1


def test_fused_dispatch_observes_its_iterations(engine):
    """``engine_fixpoint_iterations`` counts every dispatch, fused ones
    too: once for a batch of two rows, as ``engine_lookup_seconds``."""
    engine.enable_lookup_batching(window=5.0, max_rows=2)
    it = metrics.histogram("engine_fixpoint_iterations")
    lk = metrics.histogram("engine_lookup_seconds")
    n_it, s_it, n_lk = it.n, it.total, lk.n
    futs = [engine.lookup_resources_mask_async("pod", "view", "user", u)
            for u in ("u4", "u5")]
    for f in futs:
        f.result()
    assert it.n - n_it == 1 and lk.n - n_lk == 1
    assert it.total - s_it == futs[0].iterations() >= 1


def test_span_error_marks_span_and_trace(traced):
    with pytest.raises(ValueError):
        with tracer.start("request"):
            with tracer.span("engine.lookup"):
                raise ValueError("boom")
    (kept,) = tracer.recent()
    assert kept["flags"].get("error") is True
    (sp,) = [s for s in kept["spans"] if s["name"] == "engine.lookup"]
    assert "boom" in sp["attrs"]["error"]


def test_profiler_range_without_a_request_trace():
    """A profiler alone: the span is a range (no request span), on a
    worker thread too."""
    prof = _profile_all_threads()
    prof.start()
    try:
        with tracer.span("fixpoint") as sp:
            assert sp is NULL_SPAN
        with tracer.span("engine.result"):
            pass

        def worker():
            with tracer.span("host_sync", site="iter"):
                pass

        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
    finally:
        prof.stop()
    got = _ranges(prof, {"fixpoint", "engine.result", "host_sync"})
    assert [r[2] for r in got] == ["fixpoint", "engine.result", "host_sync"]
    assert got[2][3] != got[0][3]
    assert tracer.span("fixpoint") is NULL_SPAN
