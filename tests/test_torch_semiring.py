"""PyTorch port, ops/semiring.py: one masked-semiring hop under push, pull
and both auto branches, on the very same compiled graph (carried across
with convert.from_reference_arrays), against the JAX propagate with its
Pallas kernels in interpreter mode — byte-identical at every hop — plus
the mode-policy helpers."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spicedb_kubeapi_proxy_tpu.engine import Engine as JEngine, WriteOp
from spicedb_kubeapi_proxy_tpu.models import parse_schema
from spicedb_kubeapi_proxy_tpu.models.tuples import parse_relationship
from spicedb_kubeapi_proxy_tpu.ops import reachability as jreach
from spicedb_kubeapi_proxy_tpu.ops import semiring as jsemi
from spicedb_kubeapi_proxy_tpu_torch import convert
from spicedb_kubeapi_proxy_tpu_torch.ops import semiring as tsemi

from torch_parity import flatten_graph

SCHEMA = """
definition user {}
definition group {
  relation member: user
}
definition doc {
  relation viewer: user | group#member
  relation banned: user
  permission view = viewer - banned
}
"""


@pytest.fixture
def graphs(monkeypatch):
    """A small JAX engine whose graph forms dense blocks WITH bit duals
    (interpreter-mode kernels, lowered dense threshold), and the same
    compiled graph on the port (CPU tensors)."""
    monkeypatch.setenv("SDBKP_BITPROP", "interpret")
    monkeypatch.setenv("SDBKP_SEMIRING", "interpret")
    monkeypatch.setattr(jreach, "DENSE_MIN_EDGES", 8)
    e = JEngine(schema=parse_schema(SCHEMA))
    rels = [f"doc:d{i}#viewer@user:u{(i * 3 + j) % 7}"
            for i in range(12) for j in range(3)]
    rels += [f"group:g{i}#member@user:u{i % 7}" for i in range(4)]
    rels += [f"doc:d{i}#viewer@group:g{i % 4}#member" for i in range(6)]
    rels += ["doc:d0#banned@user:u0"]
    e.write_relationships(
        [WriteOp("touch", parse_relationship(r)) for r in rels])
    cg = e.compiled()
    d = cg._dev()
    assert any(b is not None for b in d["blocks_bits"])
    tcg = convert.from_reference_arrays(flatten_graph(cg), device="cpu")
    return e, cg, d, tcg, tcg._dev()


@pytest.mark.parametrize("B", [1, 8, 9])
def test_propagate_matches_reference_every_hop(graphs, B):
    e, cg, d, tcg, td = graphs
    meta = cg.run_meta()
    tmeta = tcg.run_meta()
    Mp = (cg.M // jreach.LANE + 1) * jreach.LANE
    act = jsemi.edge_activation(d["exp"], np.float32(0.0), d["cav"], None)
    dact = jsemi.edge_activation(d["dexp"], np.float32(0.0), d["dcav"],
                                 None)
    tact = tsemi.edge_activation(td["exp"], np.float32(0.0))
    tdact = tsemi.edge_activation(td["dexp"], np.float32(0.0))
    np.testing.assert_array_equal(tact.numpy(), np.asarray(act))
    objs = e._objects_by_name()
    V = np.zeros((B, Mp), dtype=np.uint8)
    for b in range(B):
        for s in cg.encode_subject("user", f"u{b % 7}", None, objs):
            if 0 <= s < cg.M:
                V[b, s] = 1

    jitted = {}  # one trace per mode, reused by every hop

    def jhop(Vf, mode, crossover):
        if mode not in jitted:
            jitted[mode] = jax.jit(lambda V, x, mode=mode: jsemi.propagate(
                meta.blocks, d["blocks"], d["blocks_bits"], d["src"],
                d["dst"], act, d["dsrc"], d["ddst"], dact, V,
                jsemi.frontier_occupancy(V), x, level=None, mode=mode))
        prop, is_push = jitted[mode](jnp.asarray(Vf), jnp.float32(crossover))
        return np.asarray(prop), int(is_push)

    def thop(Vf, mode, use_push):
        prop, is_push = tsemi.propagate(
            tmeta.blocks, td["blocks"], td["blocks_bits"], td["src"],
            td["dst"], tact, td["dsrc"], td["ddst"], tdact,
            torch.from_numpy(Vf), use_push, level=None, mode=mode)
        return prop.numpy(), is_push

    pushes = 1 if B <= 8 else 0  # the bit kernel takes at most 8 rows
    for hop in range(6):
        cases = [("push", 1.0, True), ("pull", 1.0, True),
                 ("auto", 1.0, True), ("auto", -1.0, False)]
        want = None
        for mode, crossover, use_push in cases:
            jp, jpush = jhop(V, mode, crossover)
            tp, tpush = thop(V, mode, use_push)
            np.testing.assert_array_equal(tp, jp, err_msg=f"{mode}@{hop}")
            assert tpush == jpush
            want = jp if want is None else want
            np.testing.assert_array_equal(jp, want)
        assert [thop(V, m, u)[1] for m, _, u in cases] == \
            [pushes, 0, pushes, 0]
        V2 = V | want
        if np.array_equal(V2, V):
            break
        V = V2
    assert hop >= 1


@pytest.mark.parametrize("B", [1, 9])
def test_propagate_passes_frontier_without_copy(graphs, monkeypatch, B):
    """Every dense hop gets its block's slice of the state as a strided
    view of the same storage (no copy), and the hop still equals the JAX
    reference under push, pull and auto."""
    e, cg, d, tcg, td = graphs
    meta, tmeta = cg.run_meta(), tcg.run_meta()
    Mp = (cg.M // jreach.LANE + 1) * jreach.LANE
    rng = np.random.default_rng(B)
    V = (rng.random((B, Mp)) < 0.2).astype(np.uint8)
    act = jsemi.edge_activation(d["exp"], np.float32(0.0), d["cav"], None)
    dact = jsemi.edge_activation(d["dexp"], np.float32(0.0), d["dcav"],
                                 None)
    tact = tsemi.edge_activation(td["exp"], np.float32(0.0))
    tdact = tsemi.edge_activation(td["dexp"], np.float32(0.0))
    Vt = torch.from_numpy(V)
    seen = []
    dense = tsemi.bitprop.dense_or_matmul

    def spy(A, f):
        seen.append(f)
        return dense(A, f)

    monkeypatch.setattr(tsemi.bitprop, "dense_or_matmul", spy)
    offs = {bm.src_off for bm in tmeta.blocks}
    for mode in ("push", "pull", "auto"):
        seen.clear()
        want, jpush = jax.jit(lambda Vf, mode=mode: jsemi.propagate(
            meta.blocks, d["blocks"], d["blocks_bits"], d["src"], d["dst"],
            act, d["dsrc"], d["ddst"], dact, Vf,
            jsemi.frontier_occupancy(Vf), jnp.float32(1.0), level=None,
            mode=mode))(jnp.asarray(V))
        got, tpush = tsemi.propagate(
            tmeta.blocks, td["blocks"], td["blocks_bits"], td["src"],
            td["dst"], tact, td["dsrc"], td["ddst"], tdact, Vt, True,
            level=None, mode=mode)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert tpush == int(jpush)
        if mode == "pull" or B > 8:
            assert seen, "the pull hop launched no dense block"
        for f in seen:
            assert f.untyped_storage().data_ptr() == \
                Vt.untyped_storage().data_ptr()
            assert f.stride(0) == Mp
            assert (f.data_ptr() - Vt.data_ptr()) in offs


def test_propagate_level_filter_and_no_blocks(graphs):
    """A level with no selected block reports is_push 0 in every mode."""
    e, cg, d, tcg, td = graphs
    tmeta = tcg.run_meta()
    Mp = (tcg.M // 128 + 1) * 128
    V = torch.zeros((1, Mp), dtype=torch.uint8)
    act = tsemi.edge_activation(td["exp"], 0.0)
    dact = tsemi.edge_activation(td["dexp"], 0.0)
    for mode in ("push", "pull", "auto"):
        prop, is_push = tsemi.propagate(
            tmeta.blocks, td["blocks"], td["blocks_bits"], td["src"],
            td["dst"], act, td["dsrc"], td["ddst"], dact, V, True,
            level=99, mode=mode)
        assert is_push == 0 and not prop.any()


def test_edge_activation_matches_reference():
    exp = np.asarray([1.0, -1.0, 5.0, np.inf, -np.inf, 0.0],
                     dtype=np.float32)
    for now in (0.0, 1.0, -2.5, 4.999):
        want = np.asarray(jsemi.edge_activation(
            jnp.asarray(exp), np.float32(now), None, None))
        got = tsemi.edge_activation(torch.from_numpy(exp), np.float32(now))
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("ewma", [None, 0.0, 0.001, 0.3, 0.96, 1.0])
def test_crossover_matches_reference(ewma):
    assert tsemi.crossover_from_occupancy(ewma) == \
        jsemi.crossover_from_occupancy(ewma)


@pytest.mark.parametrize("count,numel", [(0, 128), (1, 256), (37, 1024),
                                         (1000, 3 * 1024)])
def test_frontier_occupancy_matches_reference(count, numel):
    V = np.zeros(numel, dtype=np.uint8)
    V[:count] = 1
    want = float(jsemi.frontier_occupancy(jnp.asarray(V)))
    assert tsemi.frontier_occupancy(count, numel) == want


def test_force_mode_and_env(monkeypatch):
    assert tsemi.resolved_mode() == "auto"
    monkeypatch.setenv("SDBKP_SEMIRING_MODE", "pull")
    assert tsemi.resolved_mode() == "pull"
    monkeypatch.setenv("SDBKP_SEMIRING_MODE", "bogus")
    assert tsemi.resolved_mode() == "auto"
    with tsemi.force_mode("push"):
        assert tsemi.resolved_mode() == "push"
        with tsemi.force_mode("pull"):
            assert tsemi.resolved_mode() == "pull"
        assert tsemi.resolved_mode() == "push"
    assert tsemi.resolved_mode() == "auto"
    with pytest.raises(ValueError):
        with tsemi.force_mode("sideways"):
            pass
