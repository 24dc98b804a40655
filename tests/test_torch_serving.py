"""PyTorch port, the serving front: the lookup batcher (engine/batcher.py),
the revision-keyed decision cache with singleflight
(engine/decision_cache.py) and the rest of the Engine's query surface
(``try_cached_check``, ``watch_gate``, ``lookup_subjects``), held
against the JAX engine on the same writes, with its Pallas kernels in
interpreter mode, and against the host OracleEvaluator.

(a) the JAX package's test_batcher.py, ported onto the port's Engine;
fused masks byte for byte against the JAX engine's fused masks for 1 to
8 rows, homogeneous and mixed compositions with unknown types;
``query_async(q_contig_grid=...)`` against the reference's and against
the port's own gather; the bucketed ``n_b`` a fused batch gives
``bit_or_matmul``. (b) the engine- and cache-level tests of the JAX
package's test_decision_cache.py, ported; a differential against the
JAX engine and the oracle with cache and batcher both on; a threaded
read-your-writes check; the compactor's ``retire_below``; caveat-context
digests, and contexted lists fused one batch a digest (which the JAX
engine dispatches alone); a cached, batched list beside a write waiting
on a bulk check.
(c) ``watch_gate`` and ``lookup_subjects`` against the JAX engine.

Every threaded wait is bounded (``_within``, joins with a timeout), so a
hung window timer fails its test instead of running out the suite's
clock. Every comparison is exact: masks and verdicts are booleans.
"""

import os
import sys
import threading
import time

import numpy as np
import pytest

from bench import BENCH_SCHEMA as JBENCH_SCHEMA
from bench import MESH_SCHEMA
from chip_smoke import build_rows
from spicedb_kubeapi_proxy_tpu.engine import CheckItem as JCheckItem
from spicedb_kubeapi_proxy_tpu.engine import Engine as JEngine
from spicedb_kubeapi_proxy_tpu.engine import WriteOp as JWriteOp
from spicedb_kubeapi_proxy_tpu.engine.store import \
    RelationshipFilter as JRelationshipFilter
from spicedb_kubeapi_proxy_tpu.models import parse_schema as jparse_schema
from spicedb_kubeapi_proxy_tpu.models.tuples import \
    Relationship as JRelationship
from spicedb_kubeapi_proxy_tpu.models.tuples import \
    parse_relationship as jparse_rel
from spicedb_kubeapi_proxy_tpu.ops import reachability as jreach
from spicedb_kubeapi_proxy_tpu.utils.metrics import metrics as jmetrics
from spicedb_kubeapi_proxy_tpu_torch.engine import (
    CheckItem,
    Engine,
    RelationshipFilter,
    WriteOp,
)
from spicedb_kubeapi_proxy_tpu_torch.engine.decision_cache import (
    MISS,
    DecisionCache,
)
from spicedb_kubeapi_proxy_tpu_torch.engine.store import Store
from spicedb_kubeapi_proxy_tpu_torch.models import parse_schema
from spicedb_kubeapi_proxy_tpu_torch.models.tuples import (
    Relationship,
    parse_relationship,
)
from spicedb_kubeapi_proxy_tpu_torch.ops import bitprop as tbitprop
from spicedb_kubeapi_proxy_tpu_torch.ops import reachability as treach
from spicedb_kubeapi_proxy_tpu_torch.utils.metrics import metrics

from torch_parity import random_rels

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MISSING = "engine_caveat_denied_missing_context_total"


def _within(fn, seconds: float = 30.0):
    """``fn()`` on a daemon thread, failing the test if it has not
    returned within ``seconds`` (a hung batch timer or flight)."""
    box: dict = {}

    def run():
        try:
            box["value"] = fn()
        except BaseException as ex:  # noqa: BLE001 - re-raised below
            box["error"] = ex

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(seconds)
    assert not t.is_alive(), f"did not return within {seconds} s"
    if "error" in box:
        raise box["error"]
    return box["value"]


def _join_all(threads, seconds: float = 30.0) -> None:
    deadline = time.time() + seconds
    for t in threads:
        t.join(max(0.0, deadline - time.time()))
    assert not any(t.is_alive() for t in threads), "a thread hung"


@pytest.fixture
def kernels_interpreted(monkeypatch):
    """JAX Pallas kernels in interpreter mode; blocks from 2 edges up on
    both sides, so small graphs form dense blocks and bit duals."""
    monkeypatch.setenv("SDBKP_BITPROP", "interpret")
    monkeypatch.setenv("SDBKP_SEMIRING", "interpret")
    monkeypatch.setattr(jreach, "DENSE_MIN_EDGES", 2)
    monkeypatch.setattr(treach, "DENSE_MIN_EDGES", 2)


# ---------------------------------------------------------------------------
# (a) the batcher: test_batcher.py on the port
# ---------------------------------------------------------------------------

BATCH_SCHEMA = """
definition user {}
definition ns {
  relation viewer: user
  permission view = viewer
}
definition pod {
  relation owner: user
  permission view = owner
}
"""


def _batch_rels() -> list:
    rng = np.random.default_rng(0)
    rels = {f"ns:n{rng.integers(30)}#viewer@user:u{rng.integers(20)}"
            for _ in range(200)} | {
        f"pod:p{i}#owner@user:u{i % 20}" for i in range(25)}
    return sorted(rels)


def build(batch_window=None, max_rows=8):
    e = Engine(schema=parse_schema(BATCH_SCHEMA), device="cpu")
    e.write_relationships(
        [WriteOp("touch", parse_relationship(r)) for r in _batch_rels()])
    if batch_window is not None:
        e.enable_lookup_batching(window=batch_window, max_rows=max_rows)
    return e


def jbuild(batch_window=None, max_rows=8):
    e = JEngine(schema=jparse_schema(BATCH_SCHEMA))
    e.write_relationships(
        [JWriteOp("touch", jparse_rel(r)) for r in _batch_rels()])
    if batch_window is not None:
        e.enable_lookup_batching(window=batch_window, max_rows=max_rows)
    return e


def masks(e, subjects, rtype="ns"):
    futs = [e.lookup_resources_mask_async(rtype, "view", "user", u)
            for u in subjects]
    return _within(lambda: [f.result() for f in futs])


def test_batched_matches_unbatched_across_types():
    plain = build()
    batched = build(batch_window=5.0, max_rows=4)  # flushes on max_rows
    subjects = [f"u{i}" for i in range(8)]
    want_ns = masks(plain, subjects, "ns")
    want_pod = masks(plain, subjects[:4], "pod")

    # heterogeneous batch: mixed types fuse into the same dispatches
    futs = [batched.lookup_resources_mask_async("ns", "view", "user", u)
            for u in subjects[:2]]
    futs += [batched.lookup_resources_mask_async("pod", "view", "user", u)
             for u in subjects[:2]]
    got = _within(lambda: [f.result() for f in futs])
    np.testing.assert_array_equal(got[0][0], want_ns[0][0])
    np.testing.assert_array_equal(got[1][0], want_ns[1][0])
    np.testing.assert_array_equal(got[2][0], want_pod[0][0])
    np.testing.assert_array_equal(got[3][0], want_pod[1][0])

    # full sweep through the batcher (window flush for the tail)
    batched2 = build(batch_window=0.01, max_rows=4)
    got_all = masks(batched2, subjects, "ns")
    for (gm, _), (wm, _) in zip(got_all, want_ns):
        np.testing.assert_array_equal(gm, wm)


def test_window_flush_single_item():
    e = build(batch_window=0.01)
    mask, interner = _within(lambda: e.lookup_resources_mask(
        "ns", "view", "user", "u3"))
    names = {interner.string(i) for i in np.flatnonzero(mask)}
    assert names == set(_within(lambda: e.lookup_resources(
        "ns", "view", "user", "u3")))


def test_unknown_type_resolves_none():
    e = build(batch_window=0.01)
    fut = e.lookup_resources_mask_async("nosuch", "view", "user", "u1")
    assert _within(fut.result) == (None, None)


def test_error_propagates_to_all_waiters():
    e = build(batch_window=5.0, max_rows=2)

    def boom(*a, **k):
        raise RuntimeError("device on fire")

    e.compiled()  # pre-build the graph
    e._batcher._dispatch = boom
    f1 = e.lookup_resources_mask_async("ns", "view", "user", "u1")
    f2 = e.lookup_resources_mask_async("ns", "view", "user", "u2")
    with pytest.raises(RuntimeError, match="on fire"):
        _within(f1.result)
    with pytest.raises(RuntimeError, match="on fire"):
        _within(f2.result)


def test_explicit_now_bypasses_batcher():
    # a pinned evaluation time cannot share the batch's dispatch clock
    e = build(batch_window=5.0, max_rows=8)
    t0 = time.perf_counter()
    mask, interner = _within(lambda: e.lookup_resources_mask(
        "ns", "view", "user", "u3", now=time.time()))
    assert interner is not None  # resolved without waiting on the window
    assert time.perf_counter() - t0 < 5.0


def test_concurrent_threads_fuse():
    e = build(batch_window=0.05, max_rows=8)
    plain = build()
    subjects = [f"u{i}" for i in range(8)]
    want = {u: m for u, (m, _) in zip(subjects, masks(plain, subjects))}
    results = {}
    lock = threading.Lock()
    b0 = metrics.counter("engine_lookup_batches_total").value

    def worker(u):
        m, _ = e.lookup_resources_mask("ns", "view", "user", u)
        with lock:
            results[u] = m

    threads = [threading.Thread(target=worker, args=(u,), daemon=True)
               for u in subjects]
    for t in threads:
        t.start()
    _join_all(threads)
    for u in subjects:
        np.testing.assert_array_equal(results[u], want[u])
    # the 8 concurrent lookups went through fused dispatches
    assert metrics.counter("engine_lookup_batches_total").value - b0 >= 1


def test_close_marks_batcher_dead_and_submits_fall_through():
    # a submit racing disable_lookup_batching (shutdown) must not queue
    # into a dead batcher whose timer will never fire
    e = build(batch_window=60.0, max_rows=100)  # nothing flushes on its own
    b = e._batcher
    b.close()
    fut = b.submit("ns", "view", "user", "u3", None)
    mask, interner = _within(fut.result)  # direct path, no window wait
    want, _ = build().lookup_resources_mask("ns", "view", "user", "u3")
    np.testing.assert_array_equal(mask, want)


def test_disable_lookup_batching_closes_and_flushes():
    e = build(batch_window=60.0, max_rows=100)
    b = e._batcher
    pending = e.lookup_resources_mask_async("ns", "view", "user", "u1")
    e.disable_lookup_batching()
    assert b._closed
    # the pending lookup was flushed by close(), not abandoned
    mask, interner = _within(pending.result)
    want, _ = build().lookup_resources_mask("ns", "view", "user", "u1")
    np.testing.assert_array_equal(mask, want)
    # new lookups take the direct path
    m2, _ = _within(lambda: e.lookup_resources_mask(
        "ns", "view", "user", "u2"))
    assert m2 is not None


@pytest.fixture(scope="module")
def fused_pair():
    """One JAX engine (Pallas interpreted) and one port engine on the
    batcher's graph, dense blocks and bit duals formed on both."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SDBKP_BITPROP", "interpret")
        mp.setenv("SDBKP_SEMIRING", "interpret")
        mp.setattr(jreach, "DENSE_MIN_EDGES", 2)
        mp.setattr(treach, "DENSE_MIN_EDGES", 2)
        je, te = jbuild(), build()
        tcg = te.compiled()
        assert any(b is not None for b in tcg._dev()["blocks_bits"])
        je.compiled()
        yield je, te


def _composition(kind: str, R: int) -> list:
    """R lookups: one type and permission for every row (homogeneous), or
    ns, pod and an unknown type in turn (mixed)."""
    users = [f"u{(3 * i + 1) % 20}" for i in range(R)]
    if kind == "homogeneous":
        return [("ns", "view", u) for u in users]
    types = ("ns", "pod", "nosuch")
    return [(types[i % 3], "view", u) for i, u in enumerate(users)]


def _fused(e, reg, rows: list) -> tuple:
    """Submit ``rows`` through a fresh batcher that flushes exactly at
    ``len(rows)``: (results, fused dispatches)."""
    e.enable_lookup_batching(window=30.0, max_rows=len(rows))
    try:
        b0 = reg.counter("engine_lookup_batches_total").value
        futs = [e.lookup_resources_mask_async(rt, perm, "user", u)
                for rt, perm, u in rows]
        got = _within(lambda: [f.result() for f in futs])
        return got, reg.counter("engine_lookup_batches_total").value - b0
    finally:
        e.disable_lookup_batching()


@pytest.mark.parametrize("kind", ["homogeneous", "mixed"])
@pytest.mark.parametrize("R", range(1, 9))
def test_fused_masks_match_jax_engine(fused_pair, R, kind):
    je, te = fused_pair
    rows = _composition(kind, R)
    jgot, jn = _fused(je, jmetrics, rows)
    tgot, tn = _fused(te, metrics, rows)
    assert jn == tn == 1
    for (rt, _, u), (jm, ji), (tm, ti) in zip(rows, jgot, tgot):
        if rt == "nosuch":
            assert jm is None and tm is None and ji is None and ti is None
            continue
        np.testing.assert_array_equal(tm, jm, err_msg=f"{rt}@{u} R={R}")
        alone, _ = te.lookup_resources_mask(rt, "view", "user", u)
        np.testing.assert_array_equal(tm, alone)


def _grid_query(cg, objs, users, rtype="ns"):
    off = cg.offset_of(rtype, "view")
    n = cg.type_sizes[rtype]
    seeds = np.asarray([cg.encode_subject("user", u, None, objs)
                        for u in users], dtype=np.int32)
    q_slots = np.concatenate([off + np.arange(n, dtype=np.int32)
                              for _ in users])
    q_batch = np.repeat(np.arange(len(users), dtype=np.int32), n)
    return seeds, q_slots, q_batch, (off, n, len(users))


@pytest.mark.parametrize("R", [1, 3, 8])
def test_query_async_contig_grid(fused_pair, R):
    """The fused-grid readout equals the reference's grid readout and the
    port's own gather of the same slots; a promise whose shape does not
    fit falls back to the gather on both sides."""
    je, te = fused_pair
    jcg, tcg = je.compiled(), te.compiled()
    users = [f"u{i}" for i in range(R)]
    js, jq, jb, jgrid = _grid_query(jcg, je._objects_by_name(), users)
    ts, tq, tb, tgrid = _grid_query(tcg, te._objects_by_name(), users)
    assert jgrid == tgrid
    np.testing.assert_array_equal(js, ts)
    want = np.asarray(jcg.query_async(js, jq, jb, q_contig_grid=jgrid,
                                      q_cache_key=("g", R)).result())
    got = tcg.query_async(ts, tq, tb, q_contig_grid=tgrid).result()
    gathered = tcg.query_async(ts, tq, tb).result()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(gathered, want)
    assert got.any()
    # Q != L * R: the promise is refused and the arrays are gathered
    jbad = np.asarray(jcg.query_async(js, jq[:-1], jb[:-1],
                                      q_contig_grid=jgrid).result())
    tbad = tcg.query_async(ts, tq[:-1], tb[:-1], q_contig_grid=tgrid,
                           q_cache_key=("bad", R)).result()
    np.testing.assert_array_equal(tbad, jbad)
    np.testing.assert_array_equal(tbad, want[:-1])


@pytest.mark.parametrize("R,n_b", [(2, 2), (3, 4), (5, 8), (8, 8)])
def test_fused_batch_bit_kernel_n_b(fused_pair, monkeypatch, R, n_b):
    """A fused batch of R rows reaches bit_or_matmul (its plain version
    here, the tensors being on the CPU) at n_b = the bucket of R."""
    _, te = fused_pair
    seen = []
    real = tbitprop.bit_or_matmul

    def spy(a, vb, nb):
        seen.append(nb)
        return real(a, vb, nb)

    monkeypatch.setattr(tbitprop, "bit_or_matmul", spy)
    got, n = _fused(te, metrics, _composition("homogeneous", R))
    assert n == 1 and all(m is not None for m, _ in got)
    assert seen and set(seen) == {n_b}, seen


# ---------------------------------------------------------------------------
# (b) the decision cache: test_decision_cache.py on the port
# ---------------------------------------------------------------------------

CACHE_SCHEMA = """
use expiration
definition user {}
definition group {
  relation member: user
}
definition ns {
  relation viewer: user | group#member | user with expiration
  permission view = viewer
}
"""

CACHE_RELS = (
    "ns:n0#viewer@user:u0",
    "ns:n1#viewer@user:u0",
    "ns:n1#viewer@user:u1",
    "ns:n2#viewer@group:g0#member",
    "group:g0#member@user:u2",
)


def cbuild(cache=True, rels=None):
    e = Engine(schema=parse_schema(CACHE_SCHEMA), device="cpu")
    e.write_relationships([
        WriteOp("touch", parse_relationship(r))
        for r in (rels or CACHE_RELS)])
    if cache:
        e.enable_decision_cache()
    return e


def lookups_total():
    return metrics.counter("engine_lookups_total").value


def checks_total():
    return metrics.counter("engine_checks_total").value


def test_repeat_lookup_zero_dispatches():
    e = cbuild()
    m1, it1 = e.lookup_resources_mask("ns", "view", "user", "u0")
    before = lookups_total()
    m2, it2 = e.lookup_resources_mask("ns", "view", "user", "u0")
    assert lookups_total() == before  # served host-side, no dispatch
    np.testing.assert_array_equal(m1, m2)
    assert it2 is it1
    # lookup_resources shares the SAME mask entry
    ids = e.lookup_resources("ns", "view", "user", "u0")
    assert lookups_total() == before
    assert set(ids) == {"n0", "n1"}


def test_repeat_lookup_zero_dispatches_with_batcher():
    e = cbuild()
    e.enable_lookup_batching(window=0.005)
    _within(lambda: e.lookup_resources_mask("ns", "view", "user", "u1"))
    before = lookups_total()
    batches = metrics.counter("engine_lookup_batches_total").value
    _within(lambda: e.lookup_resources_mask("ns", "view", "user", "u1"))
    assert lookups_total() == before
    assert metrics.counter("engine_lookup_batches_total").value == batches


def test_copy_on_read_protects_cached_mask():
    e = cbuild()
    m1, _ = e.lookup_resources_mask("ns", "view", "user", "u0")
    assert m1.any()
    m1[:] = False  # caller mutates its copy
    m2, _ = e.lookup_resources_mask("ns", "view", "user", "u0")
    assert m2.any(), "cached array was mutated through a caller's copy"


def test_repeat_check_zero_dispatches_and_negative_caching():
    e = cbuild()
    items = [CheckItem("ns", "n0", "view", "user", "u0"),
             CheckItem("ns", "n0", "view", "user", "u1")]
    assert e.check_bulk(items) == [True, False]
    before = checks_total()
    assert e.check_bulk(items) == [True, False]  # both polarities cached
    assert checks_total() == before


def test_check_miss_residue_dispatches_in_order():
    e = cbuild()
    e.check_bulk([CheckItem("ns", "n0", "view", "user", "u0")])
    before = checks_total()
    # one hit + one miss: only the residue dispatches, order preserved
    got = e.check_bulk([CheckItem("ns", "n1", "view", "user", "u1"),
                        CheckItem("ns", "n0", "view", "user", "u0"),
                        CheckItem("ns", "n2", "view", "user", "u2")])
    assert got == [True, True, True]
    assert checks_total() - before == 2


def test_explicit_now_bypasses_cache():
    e = cbuild()
    now = time.time()
    e.lookup_resources_mask("ns", "view", "user", "u0", now=now)
    before = lookups_total()
    e.lookup_resources_mask("ns", "view", "user", "u0", now=now)
    assert lookups_total() - before == 1  # pinned-clock queries never cache


def test_trivial_lookup_counts_and_caches():
    e = cbuild()
    before = lookups_total()
    assert e.lookup_resources_mask("nosuch", "view", "user", "u0") == \
        (None, None)
    # the direct path counts trivial lookups like the batched path does
    assert lookups_total() - before == 1
    assert e.lookup_resources_mask("nosuch", "view", "user", "u0") == \
        (None, None)
    assert lookups_total() - before == 1  # repeat is a cache hit


def test_write_and_delete_invalidate():
    e = cbuild()
    assert e.check_bulk([CheckItem("ns", "n9", "view", "user", "u9")]) == \
        [False]
    e.write_relationships(
        [WriteOp("touch", parse_relationship("ns:n9#viewer@user:u9"))])
    assert e.check_bulk([CheckItem("ns", "n9", "view", "user", "u9")]) == \
        [True]
    mask, interner = e.lookup_resources_mask("ns", "view", "user", "u9")
    assert mask[interner.lookup("n9")]
    e.delete_relationships(
        RelationshipFilter(resource_type="ns", resource_id="n9"))
    assert e.check_bulk([CheckItem("ns", "n9", "view", "user", "u9")]) == \
        [False]
    mask, _ = e.lookup_resources_mask("ns", "view", "user", "u9")
    assert not mask.any()


def test_expiration_boundary_kills_entries():
    e = cbuild()
    e.check_bulk([CheckItem("ns", "n0", "view", "user", "u0")])  # warm
    now = time.time()
    e.write_relationships([WriteOp("touch", Relationship(
        "ns", "nexp", "viewer", "user", "uexp", expiration=now + 1.2))])
    item = CheckItem("ns", "nexp", "view", "user", "uexp")
    assert e.check_bulk([item]) == [True]
    before = checks_total()
    assert e.check_bulk([item]) == [True]
    assert checks_total() == before  # cached while the watermark holds
    time.sleep(max(0.0, now + 1.25 - time.time()))
    # the boundary passed with NO write: the entry must die at the
    # watermark and the fresh dispatch must see the expired tuple
    assert e.check_bulk([item]) == [False]
    mask, _ = e.lookup_resources_mask("ns", "view", "user", "uexp")
    assert not mask.any()


def _mutation_steps(write, delete, exp_at):
    """The differential's mutation steps (writes, deletes and an expiry),
    over ``write(op, rel_string | Relationship fields)`` and
    ``delete(resource_id)``."""
    return [
        lambda: write("touch", "ns:n3#viewer@user:u1"),
        lambda: write("touch", ("ns", "n4", "viewer", "user", "u0", exp_at)),
        lambda: delete("n1"),
        lambda: write("touch", "group:g0#member@user:u1"),
        lambda: write("delete", "ns:n0#viewer@user:u0"),
        lambda: time.sleep(max(0.0, exp_at + 0.05 - time.time())),
    ]


def test_differential_vs_oracle_across_mutations():
    """A cache-enabled engine must agree with OracleEvaluator after every
    mutation step: writes, deletes, and a tuple-expiration boundary."""
    e = cbuild()
    e.check_bulk([CheckItem("ns", "n0", "view", "user", "u0")])  # warm

    def write(op, rel):
        r = parse_relationship(rel) if isinstance(rel, str) else \
            Relationship(*rel[:5], expiration=rel[5])
        e.write_relationships([WriteOp(op, r)])

    steps = _mutation_steps(write, lambda rid: e.delete_relationships(
        RelationshipFilter(resource_type="ns", resource_id=rid)),
        time.time() + 2.5)
    users = [f"u{i}" for i in range(4)]
    nss = [f"n{i}" for i in range(5)]

    def compare_once():
        oracle = e.oracle()  # snapshot + clock at comparison time
        bad = []
        for u in users:
            got = set(e.lookup_resources("ns", "view", "user", u))
            want = oracle.lookup_resources("ns", "view", "user", u)
            if got != want:
                bad.append((u, got, want))
        items = [CheckItem("ns", n, "view", "user", u)
                 for n in nss for u in users]
        got = e.check_bulk(items)
        want = [oracle.check("ns", n, "view", "user", u)
                for n in nss for u in users]
        if got != want:
            bad.append(("checks", got, want))
        return bad

    def assert_agreement():
        # twice: the second round is served from the cache and must still
        # agree; a mismatch is retried against a fresh oracle once (the
        # wall clock may cross an expiry between oracle and engine)
        for _ in range(2):
            bad = compare_once()
            if bad:
                bad = compare_once()
            assert not bad, bad

    assert_agreement()
    for step in steps:
        step()
        assert_agreement()


def test_cache_disabled_engine_agrees():
    plain, cached = cbuild(cache=False), cbuild()
    for u in ("u0", "u1", "u2", "u9"):
        a = set(plain.lookup_resources("ns", "view", "user", u))
        b = set(cached.lookup_resources("ns", "view", "user", u))
        assert a == b


def test_singleflight_one_dispatch_for_concurrent_identical_lookups():
    e = cbuild()
    e.lookup_resources_mask("ns", "view", "user", "uwarm")  # warm
    gate = threading.Event()
    orig = e._lookup_submit
    calls = []

    def gated(*a, **k):
        calls.append(a)
        gate.wait(5.0)
        return orig(*a, **k)

    e._lookup_submit = gated
    before = lookups_total()
    piggy0 = metrics.counter(
        "engine_decision_cache_piggybacks_total").value
    n = 8
    results = [None] * n

    def run(i):
        results[i] = e.lookup_resources_mask("ns", "view", "user", "u0")

    threads = [threading.Thread(target=run, args=(i,), daemon=True)
               for i in range(n)]
    for t in threads:
        t.start()
    time.sleep(0.2)  # let every thread reach the flight
    gate.set()
    _join_all(threads)
    e._lookup_submit = orig
    assert len(calls) == 1  # ONE leader dispatched
    assert lookups_total() - before == 1  # metrics delta agrees
    assert metrics.counter(
        "engine_decision_cache_piggybacks_total").value - piggy0 == n - 1
    ref = results[0][0].copy()
    for mask, _ in results:
        np.testing.assert_array_equal(mask, ref)
    # every caller got its OWN copy: mutating one leaves the rest intact
    results[0][0][:] = False
    np.testing.assert_array_equal(results[1][0], ref)


def test_singleflight_error_propagates_and_is_not_cached():
    e = cbuild()
    e.lookup_resources_mask("ns", "view", "user", "uwarm")

    def boom(*a, **k):
        raise RuntimeError("device on fire")

    orig = e._lookup_submit
    e._lookup_submit = boom
    with pytest.raises(RuntimeError):
        e.lookup_resources_mask("ns", "view", "user", "u0")
    e._lookup_submit = orig
    # the error was not cached: the next call dispatches and succeeds
    mask, _ = e.lookup_resources_mask("ns", "view", "user", "u0")
    assert mask.any()


def test_try_cached_check_probe():
    e = cbuild()
    items = [CheckItem("ns", "n0", "view", "user", "u0"),
             CheckItem("ns", "n1", "view", "user", "u1")]
    assert e.try_cached_check(items) is None  # cold: no full answer
    e.check_bulk(items)
    assert e.try_cached_check(items) == [True, True]
    assert e.try_cached_check([]) == []
    # partial coverage -> None (a partial answer would dispatch anyway)
    assert e.try_cached_check(
        items + [CheckItem("ns", "n2", "view", "user", "u0")]) is None
    # a write moves the revision: the probe must miss, not serve stale
    e.write_relationships(
        [WriteOp("touch", parse_relationship("ns:n7#viewer@user:u7"))])
    assert e.try_cached_check(items) is None
    e2 = cbuild(cache=False)
    assert e2.try_cached_check(items) is None


def test_store_next_expiry_watermark():
    s = Store()
    now = time.time()
    assert s.next_expiry(now) == float("inf")
    s.write([WriteOp("touch", Relationship("ns", "a", "viewer", "user", "x",
                                           expiration=now + 50)),
             WriteOp("touch", Relationship("ns", "b", "viewer", "user", "x",
                                           expiration=now + 10)),
             WriteOp("touch", Relationship("ns", "c", "viewer", "user", "x"))])
    assert s.next_expiry(now) == pytest.approx(now + 10)
    # strictly-after semantics: AT the boundary the next one is reported
    assert s.next_expiry(now + 10) == pytest.approx(now + 50)
    assert s.next_expiry(now + 50) == float("inf")
    # deleting the nearest boundary moves the watermark
    s.write([WriteOp("delete", Relationship("ns", "b", "viewer", "user", "x",
                                            expiration=now + 10))])
    assert s.next_expiry(now) == pytest.approx(now + 50)


def test_lru_eviction_and_byte_budget():
    c = DecisionCache(max_entries=4, max_mask_bytes=1 << 30, shards=1)
    t = time.time()
    for i in range(8):
        c.put(("check", 1, i), True, float("inf"), 0, t)
    assert c.stats()["entries"] == 4
    assert c.get(("check", 1, 0), t) is MISS  # cold end evicted
    assert c.get(("check", 1, 7), t) is True
    # byte budget evicts mask-bearing entries independently of count
    cb = DecisionCache(max_entries=1000, max_mask_bytes=100, shards=1)
    cb.put(("lookup", 1, "a"), ("m", None), float("inf"), 60, t)
    cb.put(("lookup", 1, "b"), ("m", None), float("inf"), 60, t)
    assert cb.stats()["mask_bytes"] <= 100
    assert cb.get(("lookup", 1, "a"), t) is MISS
    assert cb.get(("lookup", 1, "b"), t) is not MISS


def test_born_dead_entries_are_not_stored():
    c = DecisionCache(shards=1)
    t = time.time()
    c.put(("check", 1, "k"), True, t - 1.0, 0, t)  # deadline already past
    assert c.stats()["entries"] == 0
    assert c.get(("check", 1, "k"), t) is MISS


def test_disable_clears_gauges():
    e = cbuild()
    e.lookup_resources_mask("ns", "view", "user", "u0")
    g = metrics.gauge("engine_decision_cache_entries")
    before = g.value
    assert before >= 1
    e.disable_decision_cache()
    assert g.value <= before - 1
    # cache off: dispatches again (no phantom hits)
    before_l = lookups_total()
    e.lookup_resources_mask("ns", "view", "user", "u0")
    assert lookups_total() - before_l == 1


# -- beyond the JAX package's own tests ----------------------------------------


def test_differential_vs_jax_engine_cache_and_batcher_on(
        kernels_interpreted):
    """Cache and batcher on, on both engines: after every mutation step
    (writes, deletes, an expiry) each user's fused list mask is byte-equal
    to the JAX engine's and to the oracle, and the bulk verdicts agree,
    served twice (the second round from the cache)."""
    je = JEngine(schema=jparse_schema(CACHE_SCHEMA))
    je.write_relationships([JWriteOp("touch", jparse_rel(r))
                            for r in CACHE_RELS])
    te = cbuild(cache=False)
    for e in (je, te):
        e.enable_decision_cache()
        e.enable_lookup_batching(window=0.002, max_rows=4)

    def write(op, rel):
        if isinstance(rel, str):
            je.write_relationships([JWriteOp(op, jparse_rel(rel))])
            te.write_relationships([WriteOp(op, parse_relationship(rel))])
        else:
            je.write_relationships([JWriteOp(op, JRelationship(
                *rel[:5], expiration=rel[5]))])
            te.write_relationships([WriteOp(op, Relationship(
                *rel[:5], expiration=rel[5]))])

    def delete(rid):
        je.delete_relationships(JRelationshipFilter(
            resource_type="ns", resource_id=rid))
        te.delete_relationships(RelationshipFilter(
            resource_type="ns", resource_id=rid))

    users = [f"u{i}" for i in range(4)]
    items = [("ns", f"n{i}", "view", "user", u) for i in range(5)
             for u in users]
    b0 = metrics.counter("engine_lookup_batches_total").value

    def compare_once():
        oracle = te.oracle()
        bad = []
        jgot = masks(je, users)
        tgot = masks(te, users)
        for u, (jm, _), (tm, ti) in zip(users, jgot, tgot):
            if not np.array_equal(jm, tm):
                bad.append((u, "jax"))
            ids = {ti.string(i) for i in np.flatnonzero(tm)}
            if ids != oracle.lookup_resources("ns", "view", "user", u):
                bad.append((u, "oracle"))
        jv = je.check_bulk([JCheckItem(*it) for it in items])
        tv = te.check_bulk([CheckItem(*it) for it in items])
        if tv != jv or tv != [oracle.check(*it) for it in items]:
            bad.append(("checks", tv, jv))
        return bad

    def assert_agreement():
        for _ in range(2):
            bad = compare_once()
            if bad:  # a clock race across the expiry: retry once
                bad = compare_once()
            assert not bad, bad

    assert_agreement()
    for step in _mutation_steps(write, delete, time.time() + 2.5):
        step()
        assert_agreement()
    assert metrics.counter("engine_lookup_batches_total").value > b0


def test_read_your_writes_threaded():
    """Readers keep the cache warm on one user while a writer grants and
    revokes namespaces: once a write has returned, the writer's own list,
    bulk check and cache probe always see it, never an answer cached
    before it."""
    e = cbuild()
    e.enable_lookup_batching(window=0.001, max_rows=4)
    stop = threading.Event()
    errors: list = []

    def reader(k):
        i = 0
        while not stop.is_set():
            try:
                e.lookup_resources_mask("ns", "view", "user", "uw")
                e.check_bulk([CheckItem("ns", f"w{(i + k) % 6}", "view",
                                        "user", "uw")])
                i += 1
            except Exception as ex:  # noqa: BLE001 - reported below
                errors.append(ex)
                return

    def writer():
        for i in range(24):
            ns = f"w{i % 6}"
            item = CheckItem("ns", ns, "view", "user", "uw")
            grant = i % 12 < 6
            rel = parse_relationship(f"ns:{ns}#viewer@user:uw")
            e.write_relationships([WriteOp("touch" if grant else "delete",
                                           rel)])
            mask, interner = e.lookup_resources_mask("ns", "view", "user",
                                                     "uw")
            idx = interner.lookup(ns)
            seen = bool(idx is not None and mask[idx])
            probe = e.try_cached_check([item])
            if seen != grant or probe not in (None, [grant]) \
                    or e.check_bulk([item]) != [grant]:
                errors.append((i, ns, grant, seen, probe))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        readers = [threading.Thread(target=reader, args=(k,), daemon=True)
                   for k in range(3)]
        for t in readers:
            t.start()
        w = threading.Thread(target=writer, daemon=True)
        w.start()
        _join_all([w], 60)
    finally:
        stop.set()
        sys.setswitchinterval(old)
        _join_all(readers, 30)
    assert not errors, errors[:3]


def test_compaction_retires_entries_below_the_fold():
    e = cbuild()
    c = e.enable_compaction(1.0)  # manual folds only
    try:
        e.lookup_resources_mask("ns", "view", "user", "u0")
        e.check_bulk([CheckItem("ns", "n0", "view", "user", "u0")])
        e.write_relationships(
            [WriteOp("touch", parse_relationship("ns:n5#viewer@user:u0"))])
        rev = e.revision
        m_new, _ = e.lookup_resources_mask("ns", "view", "user", "u0")
        cache = e._decision_cache
        assert cache.stats()["entries"] == 3
        r0 = metrics.counter("engine_decision_cache_retired_total").value
        assert c.compact() is True
        assert e.compiled().revision == rev
        # the two entries of the older revision went; the one at the fold
        # revision stays and still serves without a dispatch
        assert cache.stats()["entries"] == 1
        assert metrics.counter(
            "engine_decision_cache_retired_total").value - r0 == 2
        before = lookups_total()
        m2, _ = e.lookup_resources_mask("ns", "view", "user", "u0")
        assert lookups_total() == before
        np.testing.assert_array_equal(m2, m_new)
    finally:
        e.close_compaction()


CAV_CONTEXTS = ({"ip": "10.1.2.3"}, {"ip": "192.168.1.1"}, None)


def test_caveated_context_digests(kernels_interpreted):
    """Three request contexts give three cache entries, each byte-equal to
    the JAX engine's mask; a context that differs only in an undeclared
    key hits the declared one's entry; a contexted list whose digest has
    shown no company is dispatched at once, waiting for no batch, and a
    context-free fused batch counts its missing-context denials once a
    dispatch, as the JAX engine does."""
    rows = build_rows(48, 16, 4, 8, 700, 2, cav_share=0.3)
    je = JEngine(schema=jparse_schema(MESH_SCHEMA))
    te = Engine(schema=parse_schema(MESH_SCHEMA), device="cpu")
    je.bulk_load(rows)
    te.bulk_load(rows)
    te.enable_decision_cache()
    te.enable_lookup_batching(window=30.0, max_rows=4)
    cache = te._decision_cache
    u = "u12"  # a user whose three masks all differ
    got = []
    for ctx in CAV_CONTEXTS[:2]:
        n0 = cache.stats()["entries"]
        b0 = metrics.counter("engine_lookup_batches_total").value
        tm, _ = _within(lambda: te.lookup_resources_mask(
            "pod", "view", "user", u, context=ctx))
        jm, _ = je.lookup_resources_mask("pod", "view", "user", u,
                                         context=ctx)
        np.testing.assert_array_equal(tm, jm)
        assert cache.stats()["entries"] == n0 + 1
        # the first list of its digest went direct: no fused dispatch,
        # and no batch waits out the 30 s window
        assert metrics.counter("engine_lookup_batches_total").value == b0
        assert not te._batcher._pending
        got.append(tm)
    b0 = metrics.counter("engine_lookup_batches_total").value
    # the context-free one fuses: four users in one dispatch, two
    # missing-context denials (two instances) counted once
    users = ["u12", "u4", "u5", "u6"]
    m0, j0 = metrics.counter(MISSING).value, jmetrics.counter(MISSING).value
    tgot = masks(te, users, "pod")
    assert metrics.counter("engine_lookup_batches_total").value == b0 + 1
    je.enable_lookup_batching(window=30.0, max_rows=4)
    jgot = masks(je, users, "pod")
    assert metrics.counter(MISSING).value - m0 == 2
    assert jmetrics.counter(MISSING).value - j0 == 2
    for (tm, _), (jm, _) in zip(tgot, jgot):
        np.testing.assert_array_equal(tm, jm)
    got.append(tgot[0][0])
    assert not (got[1] & ~got[0]).any() and not (got[2] & ~got[1]).any()
    assert got[0].sum() > got[1].sum() > got[2].sum()
    # every context's entry serves again without a dispatch
    before = lookups_total()
    for ctx, want in zip(CAV_CONTEXTS, got):
        tm, _ = te.lookup_resources_mask("pod", "view", "user", u,
                                         context=ctx)
        np.testing.assert_array_equal(tm, want)
    # an undeclared key (the middleware's verb) shares the declared entry
    h0 = metrics.counter("engine_decision_cache_hits_total",
                         kind="lookup").value
    tm, _ = te.lookup_resources_mask(
        "pod", "view", "user", u, context=dict(CAV_CONTEXTS[0], verb="list"))
    np.testing.assert_array_equal(tm, got[0])
    assert lookups_total() == before
    assert metrics.counter("engine_decision_cache_hits_total",
                           kind="lookup").value - h0 == 1
    # and so does a bulk check: one entry for both contexts
    item = CheckItem("pod", "ns/p1", "view", "user", u)
    te.check_bulk([item], context=CAV_CONTEXTS[0])
    c0 = checks_total()
    assert te.check_bulk([item], context=dict(CAV_CONTEXTS[0], verb="get")) \
        == je.check_bulk([JCheckItem("pod", "ns/p1", "view", "user", u)],
                         context=CAV_CONTEXTS[0])
    assert checks_total() == c0
    assert te.try_cached_check([item], context=dict(
        CAV_CONTEXTS[0], verb="get")) is not None
    te.disable_lookup_batching()
    je.disable_lookup_batching()


def _caveated_pair(batch_window=None, max_rows=8):
    """A JAX engine without batching (it dispatches each contexted list
    alone) and a port engine, both on the small caveated mesh rows."""
    rows = build_rows(48, 16, 4, 8, 700, 2, cav_share=0.3)
    je = JEngine(schema=jparse_schema(MESH_SCHEMA))
    te = Engine(schema=parse_schema(MESH_SCHEMA), device="cpu")
    je.bulk_load(rows)
    te.bulk_load(rows)
    te.compiled()
    if batch_window is not None:
        te.enable_lookup_batching(window=batch_window, max_rows=max_rows)
    return je, te


def _contexted_counts() -> tuple:
    return (metrics.counter("engine_lookups_contexted_total").value,
            metrics.counter("engine_lookups_contexted_fused_total").value,
            metrics.counter("engine_lookup_batches_total").value)


def test_contexted_lists_fuse_per_digest(kernels_interpreted):
    """One list under each of the cell's two contexts opens its digest
    (dispatched at once: the digest has shown no company yet). Then lists
    under those two contexts, one that differs from the first only in an
    undeclared key, and one with no declared key at all (its digest is
    the context-free one), interleaved within the window: one fused
    dispatch forms per digest, the undeclared-key context in the first
    context's, no dispatch mixes digests, every mask equals the JAX
    engine's direct mask under its own context, and the missing-context
    denials move as the JAX engine's."""
    je, te = _caveated_pair(batch_window=30.0, max_rows=4)
    cg = te.compiled()
    a, b = CAV_CONTEXTS[:2]
    a2, bare = dict(a, verb="list"), {"verb": "list"}
    users = ["u12", "u4", "u5", "u6"]
    openers = [("u7", a), ("u7", b)]
    lists = []
    for i, u in enumerate(users):
        lists += [(u, a if i % 2 == 0 else a2), (u, b), (u, bare)]
    seen = []
    inner = te._batcher._dispatch_rows

    def spy(cg_, objs, rows):
        seen.append([te._digest(cg_, r[1]) for r in rows])
        return inner(cg_, objs, rows)

    te._batcher._dispatch_rows = spy
    c0, f0, b0 = _contexted_counts()
    m0, j0 = metrics.counter(MISSING).value, jmetrics.counter(MISSING).value
    got = [_within(lambda: te.lookup_resources_mask(
        "pod", "view", "user", u, context=ctx))[0] for u, ctx in openers]
    assert _contexted_counts()[1:] == (f0, b0) and not seen
    futs = [te.lookup_resources_mask_async("pod", "view", "user", u,
                                           context=ctx)
            for u, ctx in lists]
    got += _within(lambda: [f.result()[0] for f in futs])
    want = [je.lookup_resources_mask("pod", "view", "user", u,
                                     context=ctx)[0]
            for u, ctx in openers + lists]
    for (u, ctx), tm, jm in zip(openers + lists, got, want):
        np.testing.assert_array_equal(tm, jm, err_msg=f"{u} {ctx}")
    digests = {"a": te._digest(cg, a), "b": te._digest(cg, b)}
    assert te._digest(cg, a2) == digests["a"] != digests["b"]
    assert te._digest(cg, bare) is None
    # one dispatch per digest, four rows each, none mixing two digests
    assert sorted(map(str, (d[0] for d in seen))) == sorted(
        map(str, [digests["a"], digests["b"], None]))
    assert all(len(d) == 4 and len(set(d)) == 1 for d in seen)
    c1, f1, b1 = _contexted_counts()
    assert (c1 - c0, f1 - f0, b1 - b0) == (14, 12, 3)
    # the bare context's four lists deny two instances each, as the
    # JAX engine's four direct dispatches do
    assert jmetrics.counter(MISSING).value - j0 == 8
    assert metrics.counter(MISSING).value - m0 == 8
    assert not te._batcher._pending and not te._batcher._timers
    te.disable_lookup_batching()


@pytest.mark.parametrize(
    "case", ["cold", "explicit_now", "batching_off", "after_company"])
def test_contexted_list_alone(kernels_interpreted, case):
    """A contexted list whose digest has shown no company, one with an
    explicit ``now``, and one on an engine with batching off dispatch
    directly. After a batch of its digest held two rows, a lone list
    waits in its digest's batch until the window's timer dispatches it
    alone; the next lone list, past the window, goes direct again. Each
    mask equals the JAX engine's."""
    window = {"cold": 0.5, "explicit_now": 30.0, "batching_off": None,
              "after_company": 0.5}[case]
    je, te = _caveated_pair(batch_window=window, max_rows=8)
    ctx = CAV_CONTEXTS[1]
    kw = {"now": time.time()} if case == "explicit_now" else {}

    def lists(users):
        futs = [te.lookup_resources_mask_async("pod", "view", "user", u,
                                               context=ctx, **kw)
                for u in users]
        for u, f in zip(users, futs):
            jm, _ = je.lookup_resources_mask("pod", "view", "user", u,
                                             context=ctx, **kw)
            np.testing.assert_array_equal(_within(f.result)[0], jm)

    c0, f0, b0 = _contexted_counts()
    if case == "after_company":
        # the first goes direct; the next two follow it within the
        # window and share the timer's dispatch
        lists(["u12", "u4", "u5"])
        assert _contexted_counts() == (c0 + 3, f0 + 2, b0 + 1)
        time.sleep(2 * window)
        t0 = time.perf_counter()
        lists(["u6"])
        assert time.perf_counter() - t0 >= window
        assert _contexted_counts() == (c0 + 4, f0 + 2, b0 + 2)
        time.sleep(2 * window)
        lists(["u7"])
        assert _contexted_counts() == (c0 + 5, f0 + 2, b0 + 2)
    else:
        lists(["u12"])
        assert _contexted_counts() == (c0 + 1, f0, b0)
    if te._batcher is not None:
        assert not te._batcher._pending and not te._batcher._timers
        te.disable_lookup_batching()


TWO_CAVEAT_SCHEMA = """
caveat ip_allowlist(ip ipaddress, allowed list<ipaddress>) {
  ip in allowed
}
caveat level_ok(level int, min int) { level >= min }
definition user {}
definition pod {
  relation viewer: user | user with ip_allowlist | user with level_ok
  permission view = viewer
}
"""
SPLIT_CONTEXTS = ({"ip": "10.1.2.3", "level": 1},
                  {"ip": "10.1.2.3", "level": 5})


def _batch_of_two_digests():
    """A JAX and a port engine with one open batch holding a list under
    each of two contexts that differ only in ``level``: they share a
    digest while no ``level_ok`` instance is compiled (a list under the
    first, dispatched at once, opens the digest), and differ on the graph
    of the ``level_ok`` grant written before the batch dispatches."""
    rels = ['pod:p1#viewer@user:u0[ip_allowlist:{"allowed":["10.0.0.0/8"]}]',
            "pod:p2#viewer@user:u0"]
    grant = 'pod:p0#viewer@user:u0[level_ok:{"min":3}]'
    je = JEngine(schema=jparse_schema(TWO_CAVEAT_SCHEMA))
    te = Engine(schema=parse_schema(TWO_CAVEAT_SCHEMA), device="cpu")
    je.write_relationships([JWriteOp("touch", jparse_rel(r)) for r in rels])
    te.write_relationships([WriteOp("touch", parse_relationship(r))
                            for r in rels])
    te.enable_lookup_batching(window=30.0, max_rows=8)
    low, high = SPLIT_CONTEXTS
    cg = te.compiled()
    assert te._digest(cg, low) == te._digest(cg, high)
    tm, _ = _within(lambda: te.lookup_resources_mask(
        "pod", "view", "user", "u0", context=low))
    np.testing.assert_array_equal(tm, je.lookup_resources_mask(
        "pod", "view", "user", "u0", context=low)[0])
    futs = [te.lookup_resources_mask_async("pod", "view", "user", "u0",
                                           context=c) for c in (low, high)]
    assert len(te._batcher._pending) == 1
    je.write_relationships([JWriteOp("touch", jparse_rel(grant))])
    te.write_relationships([WriteOp("touch", parse_relationship(grant))])
    return je, te, futs


def test_a_batch_splits_when_a_newer_graph_reads_more_of_its_contexts(
        kernels_interpreted):
    """The open batch of two contexts that shared a digest at submit
    splits on the graph it runs on into one dispatch a digest, each mask
    equal to the JAX engine's at the same revision."""
    je, te, futs = _batch_of_two_digests()
    b0 = metrics.counter("engine_lookup_batches_total").value
    te._batcher.flush()
    got = _within(lambda: [f.result() for f in futs])
    assert metrics.counter("engine_lookup_batches_total").value - b0 == 2
    for c, (tm, interner) in zip(SPLIT_CONTEXTS, got):
        jm, _ = je.lookup_resources_mask("pod", "view", "user", "u0",
                                         context=c)
        np.testing.assert_array_equal(tm, jm)
        seen = {interner.string(i) for i in np.flatnonzero(tm)}
        assert ("p0" in seen) == (c is SPLIT_CONTEXTS[1])
    te.disable_lookup_batching()


def test_a_failed_digest_group_leaves_the_others_answers(
        kernels_interpreted):
    """When the second digest group of a split batch fails to dispatch,
    its caller gets the error and the first group's caller still gets
    its mask."""
    je, te, futs = _batch_of_two_digests()
    inner = te._batcher._dispatch_rows
    calls = []

    def second_fails(cg, objs, rows):
        calls.append(len(rows))
        if len(calls) == 2:
            raise RuntimeError("second group lost")
        return inner(cg, objs, rows)

    te._batcher._dispatch_rows = second_fails
    te._batcher.flush()
    assert calls == [1, 1]
    tm, _ = _within(futs[0].result)
    jm, _ = je.lookup_resources_mask("pod", "view", "user", "u0",
                                     context=SPLIT_CONTEXTS[0])
    np.testing.assert_array_equal(tm, jm)
    with pytest.raises(RuntimeError, match="second group lost"):
        _within(futs[1].result)
    te.disable_lookup_batching()


def test_query_array_cache_keeps_to_its_byte_cap(monkeypatch):
    """The host query arrays of row compositions are cached, the oldest
    evicted once their bytes would pass ``Q_HOST_BYTES``, and an entry
    larger than the cap is built and not kept."""
    import spicedb_kubeapi_proxy_tpu_torch.engine.engine as teng

    te = Engine(schema=parse_schema(MESH_SCHEMA), device="cpu")
    monkeypatch.setattr(teng, "Q_HOST_BYTES", 3 * 8 * 100)
    one = ((10, 100),)
    qs, qb = te._q_arrays(one)
    np.testing.assert_array_equal(qs, 10 + np.arange(100))
    assert not qb.any() and te._q_arrays(one)[0] is qs
    two = ((10, 100), (10, 100))
    qs2, qb2 = te._q_arrays(two)
    np.testing.assert_array_equal(qb2, np.repeat([0, 1], 100))
    assert te._q_host_bytes == 3 * 8 * 100
    te._q_arrays(((500, 100),))  # past the cap: the oldest goes
    assert list(te._q_host) == [two, ((500, 100),)]
    assert te._q_host_bytes == 3 * 8 * 100
    te._q_arrays(((0, 100),) * 4)  # alone past the cap: not kept
    assert list(te._q_host) == [two, ((500, 100),)]


def test_cached_batched_list_beside_a_write_waiting_on_a_bulk_check():
    """A write whose device patch waits for a bulk check's shared hold
    leaves the engine lock free: a cached, batched list meanwhile answers
    from the published revision, a follower of its flight too, and the
    list after the write returns sees the write (a new cache key)."""
    e = cbuild()
    e.enable_lookup_batching(window=0.002, max_rows=8)
    cg = e.compiled()
    assert "n5" not in _within(lambda: e.lookup_resources(
        "ns", "view", "user", "u1"))
    held, release = threading.Event(), threading.Event()

    def bulk_check():  # the shared side, held as a chunked bulk check does
        with cg.resident.lock.shared():
            held.set()
            release.wait(10)

    done = []
    t_bulk = threading.Thread(target=bulk_check, daemon=True)
    t_bulk.start()
    assert held.wait(10)
    t_w = threading.Thread(target=lambda: done.append(e.write_relationships(
        [WriteOp("touch", parse_relationship("ns:n5#viewer@user:u1"))])),
        daemon=True)
    t_w.start()
    deadline = time.time() + 10
    while cg.resident.lock._waiting != 1:
        assert time.time() < deadline, "the write never waited"
        time.sleep(0.001)
    t0 = time.perf_counter()
    # a new key (u2) fused and dispatched beside the waiting writer, with
    # followers of its flight; a repeat (u1) served from the cache
    futs = [e.lookup_resources_mask_async("ns", "view", "user", "u2")
            for _ in range(3)]
    got = _within(lambda: [f.result()[0] for f in futs], 10)
    assert all(np.array_equal(g, got[0]) for g in got)
    assert "n5" not in _within(lambda: e.lookup_resources(
        "ns", "view", "user", "u1"), 10)
    assert time.perf_counter() - t0 < 5 and not done
    release.set()
    _join_all([t_bulk, t_w], 10)
    assert done
    assert "n5" in _within(lambda: e.lookup_resources(
        "ns", "view", "user", "u1"))


# ---------------------------------------------------------------------------
# (c) the rest of the query surface
# ---------------------------------------------------------------------------


def _deploy_bootstrap() -> str:
    with open(os.path.join(REPO, "deploy", "bootstrap.yaml")) as fh:
        return fh.read()


def _schema_text(which: str) -> tuple:
    """(schema or bootstrap text, whether it is a bootstrap)."""
    if which == "deploy":
        return _deploy_bootstrap(), True
    return {"bench": JBENCH_SCHEMA, "mesh": MESH_SCHEMA}[which], False


@pytest.mark.parametrize("which", ["bench", "mesh", "deploy"])
def test_watch_gate_matches_reference(which):
    text, is_boot = _schema_text(which)
    if is_boot:
        je, te = JEngine(text), Engine(text, device="cpu")
    else:
        je = JEngine(schema=jparse_schema(text))
        te = Engine(schema=parse_schema(text), device="cpu")
    pairs = [(t, n) for t, d in je.schema.definitions.items()
             for n in list(d.relations) + list(d.permissions)]
    assert len(pairs) >= 8
    for t, n in pairs + [("pod", "nosuch"), ("nosuch", "view")]:
        assert te.watch_gate(t, n) == je.watch_gate(t, n), (t, n)
    assert te.watch_gate("pod", "view")[0] >= {"pod", "namespace"}


@pytest.mark.parametrize("cache", [False, True])
def test_lookup_subjects_matches_jax_engine(kernels_interpreted, cache):
    """LookupSubjects on both engines, an expiring ``user:*`` grant
    included (every known user passes it, the literal '*' is never
    reported), at a pinned clock and on the wall clock."""
    now = time.time()
    rels = random_rels(np.random.default_rng(5), nested=False,
                       expiring="wildcard", now=now)
    boot = _deploy_bootstrap()
    je, te = JEngine(boot), Engine(boot, device="cpu")
    je.write_relationships([JWriteOp("touch", jparse_rel(r)) for r in rels])
    te.write_relationships([WriteOp("touch", parse_relationship(r))
                            for r in rels])
    if cache:
        te.enable_decision_cache()
    users = sorted({r.split("@user:")[1].split("[")[0] for r in rels
                    if "@user:" in r} - {"*"})
    for rt, rid, perm in (("namespace", "ns0", "view"),
                          ("namespace", "ns1", "view"),
                          ("pod", "p3", "view"), ("pod", "p4", "edit"),
                          ("namespace", "nosuch", "view")):
        for kw in ({"now": now}, {}):
            want = je.lookup_subjects(rt, rid, perm, "user", **kw)
            got = te.lookup_subjects(rt, rid, perm, "user", **kw)
            assert got == want, (rt, rid, perm, kw)
            assert "*" not in got
        if (rt, rid) == ("namespace", "ns0"):
            assert got == users  # the wildcard grant passes every user
    assert te.lookup_subjects("namespace", "ns1", "view", "user",
                              chunk=2) == je.lookup_subjects(
        "namespace", "ns1", "view", "user")
