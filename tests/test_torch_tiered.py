"""PyTorch port, tiered block residency (storage/ and the tiered dispatch
of ops/reachability.py), held against the JAX package.

test_tiered.py's eight tests on the port, each parity check three-way: a
tiered port engine against the JAX tiered engine (its Pallas kernels in
interpreter mode) and against an untiered port engine. Beyond those: a
budget below the demand set (the largest demanded block can never stay
hot, so every dispatch streams it), a compaction fold (a fresh TierStore,
pins reset), push and pull forced, the block bytes the tier registers
(the port's own tensors), and a block built while a write's device patch
is still queued (it must match the device state the dispatch runs with,
not the newer host state).
"""

import os

import numpy as np
import pytest
import torch

import spicedb_kubeapi_proxy_tpu.ops.reachability as JR
from spicedb_kubeapi_proxy_tpu.engine import Engine as JEngine
from spicedb_kubeapi_proxy_tpu.engine.engine import CheckItem as JCheckItem
from spicedb_kubeapi_proxy_tpu.engine.store import WriteOp as JWriteOp
from spicedb_kubeapi_proxy_tpu.models import parse_schema as jparse_schema
from spicedb_kubeapi_proxy_tpu.models.tuples import \
    Relationship as JRelationship
from spicedb_kubeapi_proxy_tpu.ops import semiring as jsemi
import spicedb_kubeapi_proxy_tpu_torch.ops.reachability as R
from spicedb_kubeapi_proxy_tpu_torch.engine import Engine
from spicedb_kubeapi_proxy_tpu_torch.engine.engine import CheckItem
from spicedb_kubeapi_proxy_tpu_torch.engine.store import Store, WriteOp
from spicedb_kubeapi_proxy_tpu_torch.models import parse_schema
from spicedb_kubeapi_proxy_tpu_torch.models.tuples import Relationship
from spicedb_kubeapi_proxy_tpu_torch.ops import semiring as tsemi
from spicedb_kubeapi_proxy_tpu_torch.persistence import codec
from spicedb_kubeapi_proxy_tpu_torch.storage import ColdArena, TierStore
from spicedb_kubeapi_proxy_tpu_torch.utils.metrics import metrics

SCHEMA = """
definition user {}

definition ns {
  relation viewer: user
  permission view = viewer
}

definition pod {
  relation viewer: user
  relation owner: ns
  permission view = viewer + owner->view
}

definition secret {
  relation viewer: user
  permission view = viewer
}
"""


@pytest.fixture(autouse=True)
def small_blocks(monkeypatch):
    """Blocks from 4 edges up on both sides, so the small graph forms
    dense blocks and bit duals; the JAX kernels in interpreter mode."""
    monkeypatch.setenv("SDBKP_BITPROP", "interpret")
    monkeypatch.setenv("SDBKP_SEMIRING", "interpret")
    monkeypatch.setattr(JR, "DENSE_MIN_EDGES", 4)
    monkeypatch.setattr(R, "DENSE_MIN_EDGES", 4)


def _ops(n=40):
    """pod.view traffic exercises the pod and ns blocks; the secret
    blocks exist (same size class) but no query demands them."""
    rows = []
    for i in range(n):
        rows.append(("pod", f"p{i}", "viewer", "user", f"u{i % 7}"))
        rows.append(("secret", f"s{i}", "viewer", "user", f"u{i % 5}"))
        rows.append(("pod", f"p{i}", "owner", "ns", f"n{i % 3}"))
    for j in range(3):
        rows.append(("ns", f"n{j}", "viewer", "user", "admin"))
    return rows


def _build(budget=None, n=40, **kw):
    e = Engine(schema=parse_schema(SCHEMA), device="cpu",
               device_graph_budget_bytes=budget, **kw)
    e.write_relationships([WriteOp("touch", Relationship(*r))
                           for r in _ops(n)])
    return e


def _jbuild(budget=None, n=40):
    e = JEngine(schema=jparse_schema(SCHEMA),
                device_graph_budget_bytes=budget)
    e.write_relationships([JWriteOp("touch", JRelationship(*r))
                           for r in _ops(n)])
    return e


def _queries(n=40):
    return [(f"p{i}", u) for i in range(n) for u in ("u0", "u3", "admin")]


def _stalls():
    return metrics.histogram("engine_tier_miss_stall_seconds").n


def _three_way(tiered, base, jt, queries=None):
    """Verdicts and pod#view masks: tiered port == untiered port == JAX
    tiered."""
    qs = _queries() if queries is None else queries
    got = tiered.check_bulk([CheckItem("pod", p, "view", "user", u)
                             for p, u in qs])
    assert got == base.check_bulk([CheckItem("pod", p, "view", "user", u)
                                   for p, u in qs])
    assert got == [bool(x) for x in jt.check_bulk(
        [JCheckItem("pod", p, "view", "user", u) for p, u in qs])]
    for u in ("u0", "u3", "admin", "nobody"):
        tm, _ = tiered.lookup_resources_mask("pod", "view", "user", u)
        bm, _ = base.lookup_resources_mask("pod", "view", "user", u)
        jm, _ = jt.lookup_resources_mask("pod", "view", "user", u)
        np.testing.assert_array_equal(tm, bm, err_msg=u)
        np.testing.assert_array_equal(tm, np.asarray(jm), err_msg=u)
    return got


def test_all_cold_parity():
    """Budget 1: nothing ever admits, every dispatch streams its demand
    set, and every answer matches."""
    base, tiered, jt = _build(), _build(budget=1), _jbuild(budget=1)
    s0 = _stalls()
    _three_way(tiered, base, jt)
    cg = tiered.compiled()
    assert cg.tier is not None and len(cg.blocks) >= 3
    st = cg.tier.stats()
    assert st["hot_blocks"] == 0, "a 1-byte budget admitted a block"
    assert st["hot_bytes"] == 0
    assert _stalls() > s0, "streaming never recorded a miss stall"
    assert st == {**jt.compiled().tier.stats(), "cold_bytes":
                  st["cold_bytes"]}, "accesses differ from the reference"


def test_untouched_definitions_zero_device_bytes():
    """Demand closure: the secret blocks pod traffic cannot reach record
    no access, never become resident and add no hot bytes."""
    e = _build()
    for p, u in _queries():
        e.check(CheckItem("pod", p, "view", "user", u))
    cg = e.compiled()
    tier = cg.enable_tiering(budget_bytes=1 << 40)  # everything could fit
    assert cg._dev()["blocks"] == (None,) * len(cg.blocks)
    for p, u in _queries():
        e.check(CheckItem("pod", p, "view", "user", u))
    st = tier.stats()
    untouched = [i for i, a in st["accesses"].items() if a == 0]
    assert untouched, "expected an undemanded block (the secret one)"
    for i in untouched:
        assert not tier.entry_resident(i)
    touched = sum(tier._entries[i].nbytes
                  for i, a in st["accesses"].items()
                  if a > 0 and tier.entry_resident(i))
    tier.publish_gauges()
    assert metrics.gauge("engine_tier_hot_bytes").value == touched > 0
    assert st["cold_bytes"] > 0, "untouched blocks must stay cold"


def test_block_bytes_are_the_ports():
    """Each block registers the bytes of the port's own tensors: the int8
    block and its int32 bit dual (not a TPU lane layout)."""
    e = _build(budget=1 << 40)
    for p, u in _queries()[:6]:
        e.check(CheckItem("pod", p, "view", "user", u))
    cg = e.compiled()
    seen = 0
    for i in range(len(cg.blocks)):
        payload = cg.tier.peek(i)
        if payload is None:
            continue
        A, Ab, _ = payload
        n = A.numel() * A.element_size()
        if Ab is not None:
            n += Ab.numel() * Ab.element_size()
        assert cg.tier._entries[i].nbytes == n == R.block_nbytes(
            cg.blocks[i])
        seen += 1
    assert seen >= 2


@pytest.mark.parametrize("mode", ["auto", "push", "pull"])
def test_churn_differential_promote_demote_stream(mode):
    """Overlay appends and deletes interleaved with demotes (the next
    dispatch streams the block back) and placement sweeps: three-way
    parity after every step, and no recompile on the port."""
    rng = np.random.default_rng(42)
    base, tiered, jt = _build(), _build(budget=1 << 40), _jbuild(1 << 40)
    probes = [("p1", "admin"), ("p3", "u3"), ("cx0", "u0"), ("p9", "u2")]
    with tsemi.force_mode(mode), jsemi.force_mode(mode):
        _three_way(tiered, base, jt, probes)
        tier = tiered.compiled().tier
        c0 = metrics.counter("engine_graph_compiles_total").value
        live = set()
        for step in range(24):
            op = rng.integers(3)
            if op == 0 or not live:
                rid = f"cx{int(rng.integers(4))}"
                w = ("touch", ("pod", rid, "viewer", "user", "u0"))
                live.add(rid)
            elif op == 1:
                w = ("delete", ("pod", live.pop(), "viewer", "user", "u0"))
            else:
                w = ("touch", ("secret", f"sx{int(rng.integers(4))}",
                               "viewer", "user", "u1"))
            if step == 5:  # a base pod#viewer edge: a block cell killed
                w = ("delete", ("pod", "p1", "viewer", "user", "u1"))
            base.write_relationships([WriteOp(w[0], Relationship(*w[1]))])
            tiered.write_relationships(
                [WriteOp(w[0], Relationship(*w[1]))])
            jt.write_relationships([JWriteOp(w[0], JRelationship(*w[1]))])
            if step % 5 == 4:
                resident = [i for i in range(len(tiered.compiled().blocks))
                            if tier.entry_resident(i)]
                if resident:
                    tier.demote(int(rng.choice(resident)))
            if step % 7 == 6:
                R.tier_maintain(tiered.compiled())
            _three_way(tiered, base, jt, probes)
        assert metrics.counter("engine_graph_compiles_total").value == c0, \
            "steady-state churn recompiled"
        assert tier.stats()["pinned_blocks"] >= 1  # the killed cell's
        _three_way(tiered, base, jt)


def test_beyond_budget_cold_start_parity_and_stalls():
    """A fresh engine whose graph exceeds the budget from the first
    query: the cold start streams, answers match, and the miss counters
    move."""
    base, jt = _build(), _jbuild(budget=1)
    s0 = _stalls()
    m0 = metrics.counter("engine_tier_misses_total").value
    cold = _build(budget=1)
    _three_way(cold, base, jt)
    assert _stalls() > s0
    assert metrics.counter("engine_tier_misses_total").value > m0


def test_budget_below_the_demand_set():
    """A budget of half the largest block a pod list demands: that block
    can never stay hot, so every list streams it (bytes streamed rise
    each time) while the smaller demanded blocks settle hot; answers
    match throughout."""
    probe = _build(budget=1 << 40)
    probe.lookup_resources_mask("pod", "view", "user", "u0")
    cg = probe.compiled()
    demanded = [i for i, a in cg.tier.stats()["accesses"].items() if a]
    big = max(demanded, key=lambda i: cg.tier._entries[i].nbytes)
    budget = cg.tier._entries[big].nbytes // 2
    base, tiered, jt = _build(), _build(budget=budget), _jbuild(budget)
    for k in range(4):
        b0 = metrics.counter("engine_tier_streamed_bytes_total").value
        _three_way(tiered, base, jt)
        assert metrics.counter("engine_tier_streamed_bytes_total").value > b0
        assert not tiered.compiled().tier.entry_resident(big), k
    assert tiered.compiled().tier.hot_bytes() <= budget


def test_compaction_fold_on_a_tiered_engine():
    """Writes pin their blocks; a compaction fold publishes a fresh base
    with a fresh TierStore (pins reset, blocks cold again) and the
    answers carry across the fold unchanged."""
    base, jt = _build(), _jbuild(1 << 40)
    tiered = _build(budget=1 << 40)
    tiered.enable_compaction(1.0)
    _three_way(tiered, base, jt)
    for w in (("delete", ("pod", "p2", "viewer", "user", "u2")),
              ("touch", ("pod", "p4", "viewer", "user", "u3"))):
        base.write_relationships([WriteOp(w[0], Relationship(*w[1]))])
        tiered.write_relationships([WriteOp(w[0], Relationship(*w[1]))])
        jt.write_relationships([JWriteOp(w[0], JRelationship(*w[1]))])
    old = tiered.compiled()
    assert old.tier.stats()["pinned_blocks"] >= 1
    _three_way(tiered, base, jt)
    assert tiered.compactor.compact()
    fresh = tiered.compiled()
    assert fresh.resident is not old.resident
    assert fresh.revision == old.revision
    assert fresh.tier is not old.tier
    assert fresh.tier.stats()["pinned_blocks"] == 0
    assert fresh.tier.hot_bytes() == 0
    _three_way(tiered, base, jt)
    tiered.close_compaction()


@pytest.mark.parametrize("call", ["list", "bulk"])
def test_retiering_between_build_and_dispatch(call):
    """A re-tiering that drops the device state after a dispatch built it
    but before the dispatch holds the shared side: the dispatch builds
    the state again and answers as before."""
    base, tiered = _build(), _build(budget=1 << 40)
    qs = [CheckItem("pod", p, "view", "user", u) for p, u in _queries()]
    want = base.check_bulk(qs)
    want_mask, _ = base.lookup_resources_mask("pod", "view", "user", "u3")
    tiered.lookup_resources_mask("pod", "view", "user", "u3")
    cg = tiered.compiled()
    build = cg._dev

    def build_then_retier():
        d = build()
        del cg._dev  # once
        cg.enable_tiering(1)
        assert not cg.resident.tensors
        return d

    cg._dev = build_then_retier
    if call == "list":
        got, _ = tiered.lookup_resources_mask("pod", "view", "user", "u3")
        np.testing.assert_array_equal(got, want_mask)
    else:
        assert tiered.check_bulk(qs) == want
    assert "_dev" not in vars(cg) and cg.resident.tensors
    assert cg.tier.budget_bytes == 1


def test_lists_beside_retiering():
    """Lists on threads of their own while the budget changes under them:
    none fails and every mask equals the untiered engine's."""
    import threading

    base, tiered = _build(), _build(budget=1 << 40)
    users = ("u0", "u3", "admin", "nobody")
    want = {u: base.lookup_resources_mask("pod", "view", "user", u)[0]
            for u in users}
    cg = tiered.compiled()
    errors, stop = [], threading.Event()

    def lister(k):
        try:
            while not stop.is_set():
                u = users[k % len(users)]
                got, _ = tiered.lookup_resources_mask("pod", "view", "user",
                                                      u)
                np.testing.assert_array_equal(got, want[u], err_msg=u)
                k += 1
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(exc)

    threads = [threading.Thread(target=lister, args=(k,)) for k in range(3)]
    for t in threads:
        t.start()
    for budget in (1, 1 << 40, 1, 1 << 20) * 5:
        cg.enable_tiering(budget)
    stop.set()
    for t in threads:
        t.join()
    assert not errors, errors[0]


def test_block_built_at_the_device_watermark():
    """A write's host commit lands before its device patch: a block a
    dispatch builds in between must be cut by the ledger the device
    state reflects, not the newer one, or the dispatch would see the base
    edge gone and its overlay copy not yet there (a mixed revision)."""
    e = _build(budget=1)
    cg = e.compiled()
    objs = e._objects_by_name()
    off, n = cg.offset_of("pod", "view"), cg.type_sizes["pod"]
    q = off + np.arange(n, dtype=np.int32)
    z = np.zeros(n, dtype=np.int32)
    seed = np.asarray([cg.encode_subject("user", "u1", None, objs)],
                      np.int32)
    p1 = objs["pod"].lookup("p1")
    assert cg.query(seed, q, z)[p1]  # p1#viewer@u1 is a base block cell
    # re-touch the base edge with an expiration: the commit kills the
    # block cell and adds an overlay slot; the device patch stays queued
    e.store.write([WriteOp("touch", Relationship(
        "pod", "p1", "viewer", "user", "u1", None, 4102444800.0))])
    recs = [(False, r.rel) for r in e.store.watch_since(cg.revision)]
    inc = R.incremental_update(cg, recs, e.store.revision, e.store,
                               sync_device=False)
    assert inc is not None and inc.resident.applied < inc.patch_seq
    assert len(inc.dead_set) == 1
    assert cg.query(seed, q, z)[p1], "mixed revision: the edge vanished"
    inc.resident.flush(inc.patch_seq)
    assert inc.query(seed, q, z)[p1]


def test_tier_store_placement_mechanics():
    """Headroom admission, colder-victim eviction, pinned immunity,
    recency decay (the port's copy of the TierStore)."""
    tier = TierStore(budget_bytes=1000, arena=ColdArena())
    for i, nb in enumerate((400, 400, 400)):
        tier.register(i, nb, level=0)
    payload = ("A", None, None)
    assert tier.admit(0, payload)
    assert tier.admit(1, payload)
    assert not tier.admit(2, payload)
    tier.lookup((1,))
    tier.place()
    tier.lookup((2,))
    assert tier.admit(2, payload)
    assert not tier.entry_resident(0)
    tier.pin(1)
    assert tier.admit(1, payload, pinned=True)
    tier.demand_cache_put(("k",), (0, 1))
    assert tier.demand_cache_get(("k",)) == (0, 1)
    tier.close()


def test_cold_arena_memory_and_spill(tmp_path):
    cols = {"dst_local": np.arange(5, dtype=np.int32),
            "src_local": np.arange(5, 0, -1, dtype=np.int32)}
    mem = ColdArena()
    mem.put(7, cols)
    np.testing.assert_array_equal(mem.get(7)["dst_local"], cols["dst_local"])
    assert mem.nbytes > 0
    mem.drop(7)
    assert not mem.has(7)
    spill = ColdArena(spill_dir=str(tmp_path))
    spill.put(3, cols)
    out = spill.get(3)
    np.testing.assert_array_equal(out["src_local"], cols["src_local"])
    assert isinstance(out["src_local"], np.memmap)


def test_codec_dir_save_load_mmap(tmp_path):
    arrays = {"a": np.arange(100, dtype=np.int32),
              "b": (np.arange(50) % 2).astype(np.uint8)}
    path = str(tmp_path / "arena")
    assert codec.save(path, arrays) == sum(a.nbytes for a in arrays.values())
    eager = codec.load(path)
    lazy = codec.load(path, mmap=True)
    for k in arrays:
        np.testing.assert_array_equal(eager[k], arrays[k])
        np.testing.assert_array_equal(lazy[k], arrays[k])
        assert isinstance(lazy[k], np.memmap)
        assert not isinstance(eager[k], np.memmap)


def test_store_save_dir_mmap_recovery(tmp_path):
    """A directory snapshot loads mmap-backed and the restored tiered
    engine answers like the original; a spilled arena serves the blocks."""
    e = _build()
    qs = [CheckItem("pod", p, "view", "user", u) for p, u in _queries()]
    want = e.check_bulk(qs)
    path = str(tmp_path / "snap")
    assert e.store.save_dir(path) > 0 and os.path.isdir(path)
    e2 = Engine(schema=parse_schema(SCHEMA), device="cpu",
                device_graph_budget_bytes=1,
                tier_spill_dir=str(tmp_path / "spill"))
    e2.store.load(path, mmap=True)
    assert e2.check_bulk(qs) == want
    assert os.listdir(str(tmp_path / "spill"))
    s = Store()
    s.load(path, mmap=True)
    assert s.revision == e.store.revision
    assert torch.get_default_device().type == "cpu"
