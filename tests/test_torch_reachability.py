"""PyTorch port, ops/reachability.py: the host compiler against the JAX
one on the same rows (identical arrays), and the device fixpoint on the
very same compiled graph (carried across with
convert.from_reference_arrays) against the JAX ``_run`` with its Pallas
kernels in interpreter mode: identical masks, ``iterations`` and
``push_steps`` under push, pull and auto, and the same
``ConvergenceError`` contract."""

import time

import numpy as np
import pytest

from spicedb_kubeapi_proxy_tpu.engine import Engine as JEngine
from spicedb_kubeapi_proxy_tpu.engine import WriteOp as JWriteOp
from spicedb_kubeapi_proxy_tpu.models import parse_schema as jparse
from spicedb_kubeapi_proxy_tpu.models.tuples import \
    parse_relationship as jparse_rel
from spicedb_kubeapi_proxy_tpu.ops import reachability as jreach
from spicedb_kubeapi_proxy_tpu.ops import semiring as jsemi
from spicedb_kubeapi_proxy_tpu_torch import convert
from spicedb_kubeapi_proxy_tpu_torch.engine import Store, WriteOp
from spicedb_kubeapi_proxy_tpu_torch.models import parse_schema
from spicedb_kubeapi_proxy_tpu_torch.models.tuples import parse_relationship
from spicedb_kubeapi_proxy_tpu_torch.ops import reachability as treach
from spicedb_kubeapi_proxy_tpu_torch.ops import semiring as tsemi

from torch_parity import expr_tuple, flatten_graph, random_rels

SCHEMA = """
use expiration

definition user {}
definition group {
  relation member: user | group#member
}
definition namespace {
  relation creator: user
  relation viewer: user | user with expiration | group#member | user:* with expiration
  relation banned: user
  permission admin = creator
  permission view = (viewer + creator) - banned
}
definition pod {
  relation namespace: namespace
  relation creator: user
  relation viewer: user
  relation auditor: user
  permission edit = creator
  permission view = viewer + creator + namespace->view
  permission audit = auditor & namespace->view
}
"""

NOW = time.time()


def _rels(seed):
    rng = np.random.default_rng(seed)
    rels = random_rels(rng, now=NOW)
    rels += [f"namespace:ns0#banned@user:u{rng.integers(9)}",
             f"pod:p{rng.integers(12)}#auditor@user:u{rng.integers(9)}",
             "pod:p3#auditor@user:u4"]
    return rels


@pytest.fixture
def jax_kernels(monkeypatch):
    monkeypatch.setenv("SDBKP_BITPROP", "interpret")
    monkeypatch.setenv("SDBKP_SEMIRING", "interpret")


def _jax_graph(monkeypatch, seed, dense_min):
    monkeypatch.setattr(jreach, "DENSE_MIN_EDGES", dense_min)
    e = JEngine(schema=jparse(SCHEMA))
    e.write_relationships([JWriteOp("touch", jparse_rel(r))
                           for r in _rels(seed)])
    return e, e.compiled()


@pytest.mark.parametrize("dense_min", [2, 8, 1024])
@pytest.mark.parametrize("seed", [0, 1])
def test_compile_graph_matches_reference(monkeypatch, dense_min, seed):
    monkeypatch.setattr(time, "time", lambda: NOW)
    monkeypatch.setattr(treach, "DENSE_MIN_EDGES", dense_min)
    _, jcg = _jax_graph(monkeypatch, seed, dense_min)
    st = Store()
    st.write([WriteOp("touch", parse_relationship(r)) for r in _rels(seed)])
    tcg = treach.compile_graph(parse_schema(SCHEMA), st.snapshot(),
                               device="cpu")
    assert tcg.M == jcg.M and tcg.base_time == jcg.base_time
    assert tcg.slot_offset == jcg.slot_offset
    assert tcg.type_sizes == jcg.type_sizes
    assert (tcg.n_edges, tcg.n_levels, tcg.res_level_bounds) == \
        (jcg.n_edges, jcg.n_levels, jcg.res_level_bounds)
    for f in ("src", "dst", "exp_rel", "res_src", "res_dst", "res_exp",
              "res_idx", "range_levels", "range_offs", "delta_src",
              "delta_dst", "delta_exp"):
        np.testing.assert_array_equal(getattr(tcg, f), getattr(jcg, f),
                                      err_msg=f)
    assert len(tcg.blocks) == len(jcg.blocks)
    for tb, jb in zip(tcg.blocks, jcg.blocks):
        assert (tb.dst_off, tb.n_dst, tb.src_off, tb.n_src, tb.level,
                tb.closured) == (jb.dst_off, jb.n_dst, jb.src_off,
                                 jb.n_src, jb.level, jb.closured)
        np.testing.assert_array_equal(tb.dst_local, jb.dst_local)
        np.testing.assert_array_equal(tb.src_local, jb.src_local)
    assert [(p.dst_off, p.size, p.level, str(p.expr),
             sorted((str(k), v) for k, v in p.leaf_off.items()))
            for p in tcg.programs] == \
        [(p.dst_off, p.size, p.level, str(p.expr),
          sorted((str(k), v) for k, v in p.leaf_off.items()))
         for p in jcg.programs]
    assert tcg.run_meta().level_ranges == jcg.run_meta().level_ranges
    if dense_min == 2:
        assert any(b.closured for b in tcg.blocks)


def _queries(e, cg, B):
    """Seeds for B users plus a contiguous list-filter window and a
    scattered check batch."""
    objs = e._objects_by_name()
    seeds = np.asarray([cg.encode_subject("user", f"u{b}", None, objs)
                        for b in range(B)], dtype=np.int32)
    off = cg.offset_of("pod", "view")
    n = cg.type_sizes["pod"]
    lst = (off + np.arange(n, dtype=np.int32), np.zeros(n, dtype=np.int32))
    rng = np.random.default_rng(B)
    perms = [("pod", "view"), ("pod", "audit"), ("namespace", "view"),
             ("group", "member"), ("pod", "edit")]
    qs, qb = [], []
    for _ in range(40):
        t, p = perms[rng.integers(len(perms))]
        qs.append(cg.offset_of(t, p) + rng.integers(2, 16))
        qb.append(rng.integers(B))
    return seeds, lst, (np.asarray(qs, np.int32), np.asarray(qb, np.int32))


@pytest.mark.parametrize("dense_min", [2, 1024])
@pytest.mark.parametrize("mode", ["push", "pull", "auto"])
def test_run_matches_reference(monkeypatch, jax_kernels, dense_min, mode):
    e, jcg = _jax_graph(monkeypatch, 3, dense_min)
    tcg = convert.from_reference_arrays(flatten_graph(jcg), device="cpu")
    pushes = 0
    for B in (1, 9):  # 1: the list filter and push; 9: B > 8, pull only
        seeds, lst, chk = _queries(e, jcg, B)
        # auto's branch follows the crossover; forced modes ignore it
        for crossover in ((1.0, 0.0) if mode == "auto" else (1.0,)):
            jcg.spmm_crossover = tcg.spmm_crossover = crossover
            for (qs, qb), contig in ((lst, True), (chk, None)):
                if contig and B > 1:
                    continue
                with jsemi.force_mode(mode), tsemi.force_mode(mode):
                    jf = jcg.query_async(seeds, qs, qb, now=NOW,
                                         q_contiguous=contig)
                    tf = tcg.query_async(seeds, qs, qb, now=NOW,
                                         q_contiguous=contig)
                    want = jf.result()
                    np.testing.assert_array_equal(tf.result(), want)
                assert tf.iterations() == jf.iterations()
                assert tf.push_steps() == jf.push_steps()
                if mode == "pull" or B > 8 or crossover == 0.0:
                    assert tf.push_steps() == 0
                pushes += tf.push_steps()
    # the fixpoint did real work: some grant reached through the graph
    assert want.any()
    # the push path (bit-packed duals) really ran where blocks formed
    assert (pushes > 0) == (mode != "pull" and dense_min < 1024)


def test_convergence_error_matches_reference(monkeypatch, jax_kernels):
    """Nested groups iterate in the core (no dense closure at the default
    threshold): a 1-iteration budget must raise on both sides."""
    e, jcg = _jax_graph(monkeypatch, 4, 1024)
    tcg = convert.from_reference_arrays(flatten_graph(jcg), device="cpu")
    seeds, (qs, qb), _ = _queries(e, jcg, 1)
    full = jcg.query_async(seeds, qs, qb, now=NOW)
    assert full.result() is not None and full.iterations() > 1
    assert tcg.query_async(seeds, qs, qb, now=NOW).iterations() == \
        full.iterations()
    for cg in (jcg, tcg):
        fut = cg.query_async(seeds, qs, qb, now=NOW, max_iters=1)
        with pytest.raises(Exception) as ei:
            fut.result()
        assert type(ei.value).__name__ == "ConvergenceError"
    with pytest.raises(treach.ConvergenceError):
        tcg.query(seeds, qs, qb, now=NOW, max_iters=1)


def test_convert_from_full_edges_and_res_idx(monkeypatch, jax_kernels):
    """The unstratified input form (full edge arrays + res_idx, no level
    views) runs every residual edge in the core and still agrees."""
    e, jcg = _jax_graph(monkeypatch, 5, 1024)
    flat = flatten_graph(jcg)
    for k in ("res_src", "res_dst", "res_exp", "res_level_bounds",
              "range_levels", "n_levels"):
        flat.pop(k)
    for p in flat["programs"]:
        p["level"] = 0  # unstratified: one core, every program per hop
    tcg = convert.from_reference_arrays(flat, device="cpu")
    assert tcg.run_meta().n_levels == 0
    seeds, (qs, qb), chk = _queries(e, jcg, 1)
    np.testing.assert_array_equal(
        tcg.query(seeds, qs, qb, now=NOW),
        jcg.query(seeds, qs, qb, now=NOW))


def test_expr_round_trip(monkeypatch):
    _, jcg = _jax_graph(monkeypatch, 0, 1024)
    for p in jcg.programs:
        t = expr_tuple(p.expr)
        assert str(convert.expr_from_tuple(t)) == str(p.expr)
    with pytest.raises(ValueError):
        convert.expr_from_tuple(("xor", ("nil",)))


def test_hop_bytes_matches_reference(monkeypatch, jax_kernels):
    _, jcg = _jax_graph(monkeypatch, 0, 2)
    tcg = convert.from_reference_arrays(flatten_graph(jcg), device="cpu")
    for batch in (1, 8, 64):
        assert tcg.hop_bytes(batch) == jcg.hop_bytes(batch)


def test_device_bytes_counts_blocks(monkeypatch, jax_kernels):
    _, jcg = _jax_graph(monkeypatch, 0, 2)
    tcg = convert.from_reference_arrays(flatten_graph(jcg), device="cpu")
    dense = sum(b.n_dst * b.n_src for b in tcg.blocks)
    assert tcg.device_bytes() > dense
