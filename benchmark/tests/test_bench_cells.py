"""Each cell, at a tiny size on the CPU, runs the whole harness past the
look for a card and comes out correct; with the timed path broken
underneath, or with the plain reference in the program's place and a
guarantee broken, it comes out not correct."""

import numpy as np
import pytest

from benchmark import control, run as R
from benchmark.tests.conftest import tiny

CELLS = ["headline.list_fanout", "caveated.list_ctx", "headline.bulk_check"]
SEED = 2**31 + 12345


RATE = {"headline.list_fanout": "list_rate", "caveated.list_ctx": "list_rate",
        "headline.bulk_check": "check_rate"}


def _run(spec, workload, seed=SEED, trace=False, adjust=tiny):
    return R.run_cell(spec, workload, seed, 1.0, trace, device="cpu",
                      adjust=adjust)


@pytest.mark.parametrize("workload", CELLS)
def test_cell_is_correct_on_the_cpu(spec_full, workload):
    out = _run(spec_full, workload)
    assert out["correct"] is True, out["compared"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "compared"
    assert set(out["metrics"]) == {"setup_s", RATE[workload]}
    assert out["metrics"][RATE[workload]]["value"] > 0


@pytest.mark.parametrize("workload", CELLS)
def test_traced_run_reports_its_layers(spec_full, workload):
    out = _run(spec_full, workload, trace=True)
    assert out["correct"] is True
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert RATE[workload] not in out["metrics"]
    assert "load_s" in out["metrics"]
    if workload == "headline.list_fanout":
        # the dispatches are fused batches, nearly all of them full (the
        # batcher's 2 ms timer may still close one early)
        assert out["metrics"]["lists_per_dispatch"]["value"] >= 7.5


def test_a_module_loaded_after_the_window_is_refused(spec_full,
                                                     monkeypatch):
    """A forbidden module that a metric reader or the reference loads
    after the window has closed still stops the run without a result."""
    import sys
    import types

    from benchmark import spec as S

    orig = S.reference

    def reference(name):
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
        return orig(name)

    monkeypatch.setattr(S, "reference", reference)
    with pytest.raises(SystemExit):
        _run(spec_full, "headline.list_fanout")


def _flip_middle(monkeypatch):
    """An answer altered where it is produced: the fixpoint's readout
    (past a row's two pseudo objects, which the engine masks after)."""
    from spicedb_kubeapi_proxy_tpu_torch.ops import reachability

    orig = reachability.QueryFuture.result

    def result(self):
        out = np.array(orig(self), copy=True)
        out[len(out) // 2 + 3] ^= True
        return out

    monkeypatch.setattr(reachability.QueryFuture, "result", result)


def _half_batch(monkeypatch):
    """Half of a dispatch's rows left out: their answers read empty."""
    from spicedb_kubeapi_proxy_tpu_torch.ops import reachability

    orig_q = reachability.CompiledGraph.query_async
    orig_r = reachability.QueryFuture.result

    def query_async(self, seed_slots, q_slots, q_batch, *a, **kw):
        fut = orig_q(self, seed_slots, q_slots, q_batch, *a, **kw)
        rows = len(seed_slots)
        fut._drop = (np.asarray(q_batch) >= (rows + 1) // 2
                     if rows > 1 else None)
        return fut

    def result(self):
        out = np.array(orig_r(self), copy=True)
        drop = getattr(self, "_drop", None)
        if drop is not None:
            out[drop[:len(out)]] = False
        return out

    monkeypatch.setattr(reachability.CompiledGraph, "query_async",
                        query_async)
    monkeypatch.setattr(reachability.QueryFuture, "result", result)


def _unchanged_state(monkeypatch):
    """A hop that returns its state unchanged: nothing propagates."""
    import torch

    from spicedb_kubeapi_proxy_tpu_torch.ops import semiring

    def propagate(block_meta, blocks, blocks_bits, src, dst, act, dsrc,
                  ddst, dact, Vflat, use_push, **kw):
        return torch.zeros_like(Vflat), 0

    monkeypatch.setattr(semiring, "propagate", propagate)


FAULTS = {"answer_altered": _flip_middle, "half_batch": _half_batch,
          "unchanged_state": _unchanged_state}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", CELLS)
def test_broken_timed_path_is_not_correct(spec_full, monkeypatch,
                                          workload, fault):
    FAULTS[fault](monkeypatch)
    out = _run(spec_full, workload)
    assert out["correct"] is False, out["compared"]


CONTROLS = [("headline.list_fanout", "stale"), ("caveated.list_ctx", "stale"),
            ("caveated.list_ctx", "caveat_open"),
            ("headline.bulk_check", "stale")]


@pytest.mark.parametrize("workload,kind", CONTROLS)
def test_control_is_not_correct(spec_full, workload, kind):
    for seed in (1, 2, 3):
        out = control.run_control(spec_full, workload, kind, seed, 64,
                                  tiny)
        assert out["correct"] is False, out


@pytest.mark.parametrize("workload", ["headline.list_fanout",
                                      "headline.bulk_check"])
def test_corrupted_output_is_caught(spec_full, workload):
    """One mask entry or one verdict changed after the program answered."""
    from types import SimpleNamespace

    from benchmark import spec as S
    from benchmark.drive import Request

    cell = S.cell(spec_full, workload)
    tiny(cell)
    cfg, traffic = cell["config"], cell["traffic"]
    data = S.generator(cfg["generator"]).generate(cfg, 5)
    data.pop("cols")
    op = S.op(traffic["op"])
    st = op.prepare(SimpleNamespace(engine=None, data=data, traffic=traffic,
                                    seed=5, cfg=cfg))
    ref = S.reference(cfg["generator"]).Reference(cfg, data)
    key = next(op.stream(st, "window"))[0]
    good = control.control_outputs(traffic["op"], st, ref, [key])
    assert all(v == 0 for v in op.judge(st, ref, good).values())
    r = good[0]
    if traffic["op"] == "list":
        bits, n, interner = r.output
        mask = np.unpackbits(bits, count=n)
        mask[7] ^= 1
        bad = Request(r.key, output=op.keep(st, (mask, interner)))
    else:
        verdicts = list(r.output)
        verdicts[3] = not verdicts[3]
        bad = Request(r.key, output=verdicts)
    got = op.judge(st, ref, [bad])
    assert all(v == 1 for v in got.values()), got
