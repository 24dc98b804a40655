"""The reduction of the program's spans (benchmark/spans.py) and the
readers of the metrics it feeds: self time, the device's idle time
outside every program span, the existing reduction left as it was when
the program's ranges and their device mirrors join a trace, and a traced
run of the list cell on the CPU."""

from types import SimpleNamespace

import numpy as np
import pytest
from torch.autograd import DeviceType

from benchmark import run as R, spans, spec as S, tracing
from benchmark.tests.conftest import tiny

SEED = 2**31 + 4242
READERS = ("host_syncs_per_list", "host_sync_wait_ms_per_list",
           "fixpoint_host_ms_per_list", "caveat_vm_host_ms_per_list",
           "engine_host_ms_per_list", "idle_outside_program.list")


class _Ev:
    """One raw profiler event as ``kineto_results.events()`` yields it."""

    def __init__(self, kind, start, dur, name, tid=1, corr=0, link=0):
        self._v = (kind, start, dur, name, tid, corr, link)

    def device_type(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def name(self):
        return self._v[3]

    def start_thread_id(self):
        return self._v[4]

    def correlation_id(self):
        return self._v[5]

    def linked_correlation_id(self):
        return self._v[6]


def _prof(evs):
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: list(evs))))


def _host(start, dur, name, tid=1, corr=0):
    return _Ev(DeviceType.CPU, start, dur, name, tid, corr)


def _dev(start, dur, name, link=0):
    return _Ev(DeviceType.CUDA, start, dur, name, 0, 0, link)


def test_self_time_less_the_direct_children_on_one_thread():
    # thread 1: a direct list; thread 2: a fused dispatch on a timer
    rows = [(0, 100, "engine.lookup", 1), (10, 60, "engine.dispatch", 1),
            (20, 55, "fixpoint", 1), (22, 30, "caveat_vm", 1),
            (40, 50, "host_sync", 1), (70, 95, "engine.result", 1),
            (75, 85, "host_sync", 1), (200, 300, "engine.dispatch", 2),
            (210, 290, "fixpoint", 2), (250, 260, "host_sync", 2),
            (50, 120, "fixpoint", 3)]  # overlaps thread 1: no child
    got = spans.summarize(rows, [], 1e-6)["spans"]
    ns = {k: [v[0], round(v[1] * 1e9), round(v[2] * 1e9)]
          for k, v in got.items()}
    assert ns == {"engine.lookup": [1, 100, 25],
                  "engine.dispatch": [2, 150, 35],
                  "fixpoint": [3, 185, 157],
                  "caveat_vm": [1, 8, 8], "host_sync": [3, 30, 30],
                  "engine.result": [1, 25, 15]}


def _tree(rng, lo, hi, depth, tid, out, names):
    """Random properly nested spans inside [lo, hi); returns the ns its
    direct children cover."""
    covered, t = 0, lo
    while depth and t < hi - 2 and rng.random() < 0.7:
        a = int(rng.integers(t, hi - 1))
        b = int(rng.integers(a + 1, hi))
        i = len(out)
        out.append(None)
        inner = _tree(rng, a, b, depth - 1, tid, out, names)
        out[i] = ((a, b, names[int(rng.integers(len(names)))], tid),
                  b - a - inner)
        covered += b - a
        t = b
    return covered


@pytest.mark.parametrize("seed", range(5))
def test_self_time_against_a_built_tree(seed):
    rng = np.random.default_rng(seed)
    made: list = []
    for tid in (1, 2, 3):
        _tree(rng, 0, 10_000, 4, tid, made, spans.PROGRAM)
    want: dict = {}
    for (lo, hi, nm, _), own in made:
        w = want.setdefault(nm, [0, 0, 0])
        w[0] += 1
        w[1] += hi - lo
        w[2] += own
    got = spans.summarize([m[0] for m in made], [], 1e-5)["spans"]
    assert {k: [v[0], round(v[1] * 1e9), round(v[2] * 1e9)]
            for k, v in got.items()} == want


@pytest.mark.parametrize("seed", range(5))
def test_idle_outside_every_program_span(seed):
    rng = np.random.default_rng(seed)
    window = 5_000
    rows = []
    for tid in (1, 2):
        a = np.sort(rng.integers(0, window, 16))
        rows += [(int(x), int(y), "fixpoint", tid)
                 for x, y in zip(a[::2], a[1::2])]
    b = np.sort(rng.integers(0, window, 20))
    busy = [(int(x), int(y)) for x, y in zip(b[::2], b[1::2])]
    grid = np.zeros(window, dtype=bool)
    for lo, hi, *_ in rows:
        grid[lo:hi] = True
    for lo, hi in busy:
        grid[lo:hi] = True
    got = spans.summarize(rows, busy, window * 1e-9)
    assert got["idle_outside_s"] == pytest.approx(
        (~grid).sum() * 1e-9, abs=1e-15)
    assert got["n_device"] == len(busy)


def _base_events():
    """A list's torch operators, their launches and kernels, with idle
    device gaps under an operator and in bare Python."""
    return [
        _host(100, 50, "aten::index_add_", 1, 1),
        _host(110, 5, "cudaLaunchKernel", 1, 2),
        _dev(120, 40, "indexFuncLargeIndex", 2),
        _host(300, 20, "aten::sum", 1, 3),
        _host(305, 5, "cudaLaunchKernel", 1, 4),
        _dev(310, 10, "reduce_kernel", 4),
        _host(500, 200, "aten::copy_", 1, 5),
        _dev(690, 5, "copy_kernel", 5),
        _dev(900, 20, "bit_or_matmul_kernel", 0),
    ]


def _program_events():
    """The program's ranges around them, and their device mirrors (user
    annotations, named like the host ranges)."""
    return [
        _host(50, 900, "engine.lookup", 1, 10),
        _host(60, 700, "engine.dispatch", 1, 11),
        _host(70, 640, "fixpoint", 1, 12),
        _host(90, 80, "caveat_vm", 1, 13),
        _host(480, 230, "host_sync", 1, 14),
        _dev(115, 50, "caveat_vm"),
        _dev(70, 640, "fixpoint"),
    ]


def test_existing_reduction_reads_the_same_with_program_ranges():
    base = tracing.reduce(_prof(_base_events()), 1e-6)
    more = tracing.reduce(_prof(_base_events() + _program_events()), 1e-6)
    for k in ("busy_s", "kernels", "n_device", "window_s"):
        assert more[k] == base[k], k
    assert more["ranges"]["aten::index_add_"] == \
        base["ranges"]["aten::index_add_"]
    assert more["ranges"]["caveat_vm"] == (1, pytest.approx(40e-9))
    old, new = dict(base["idle_gaps"]), dict(more["idle_gaps"])
    assert sum(new.values()) == pytest.approx(sum(old.values()))
    # a gap under a torch operator keeps its name; only the bare
    # Python gaps take the program's names
    for nm, s in old.items():
        if nm != "no host operation":
            assert new[nm] == pytest.approx(s), nm
    assert new.get("no host operation", 0.0) < old["no host operation"]
    assert set(new) - set(old) <= set(spans.PROGRAM)


def test_program_reduction_of_a_profile():
    got = spans.reduce(_prof(_base_events() + _program_events()), 1e-6)
    # the two mirrors are no device activity
    assert got["n_device"] == 4
    s = {k: [v[0], round(v[1] * 1e9), round(v[2] * 1e9)]
         for k, v in got["spans"].items()}
    assert s == {"engine.lookup": [1, 900, 200],
                 "engine.dispatch": [1, 700, 60],
                 "fixpoint": [1, 640, 330], "caveat_vm": [1, 80, 80],
                 "host_sync": [1, 230, 230]}
    # program spans and device work cover [50, 950]
    assert got["idle_outside_s"] == pytest.approx(100e-9)


def _rec(**kw):
    rec = {"op": "list", "answers_all": 4, "counters": {},
           "trace": {"window_s": 1e-6}}
    rec.update(kw)
    return rec


def test_readers_read_nothing_without_the_programs_spans():
    """The parent's run: no counter and no program ranges. Nothing is
    read, and nothing raises."""
    prof = _prof(_base_events())  # noqa: F841 - the readers find it
    rec = _rec()
    for name in READERS:
        assert S.metric_reader(name)(rec) is None, name
    del prof
    rec = _rec()  # no profiler in any calling frame
    for name in READERS:
        assert S.metric_reader(name)(rec) is None, name
    assert S.metric_reader("host_sync_wait_ms_per_list")(
        _rec(trace=None)) is None


def test_readers_find_the_stopped_profiler_of_the_run():
    """As run.run_cell holds it: a closure's cell, under any name, in the
    frame that calls the readers; the first reduces, the rest reuse."""
    held = None
    # a fused list on a second thread: its result blocked on the batch,
    # which is no engine host time
    fused = [_host(960, 20, "engine.result", 2, 15),
             _host(965, 10, "engine.batch_wait", 2, 16)]

    def start():
        nonlocal held
        held = _prof(_base_events() + _program_events() + fused)

    start()
    rec = _rec(counters={"engine_host_syncs_total": 10.0})
    got = {n: S.metric_reader(n)(rec) for n in READERS}
    assert spans.of(rec) is spans.of(rec)
    assert "program_spans" not in rec
    assert got == {
        "host_syncs_per_list": 2.5,
        "host_sync_wait_ms_per_list": pytest.approx(230e-6 / 4),
        "fixpoint_host_ms_per_list": pytest.approx(330e-6 / 4),
        "caveat_vm_host_ms_per_list": pytest.approx(80e-6 / 4),
        "engine_host_ms_per_list": pytest.approx(270e-6 / 4),
        "idle_outside_program.list": pytest.approx(8.0)}


def test_traced_cpu_run_reports_the_program_spans(spec):
    """The list cell traced at a tiny size on the CPU: every program
    metric but the device's idle share (no device activity here) reads
    from the run's own spans and counter."""
    out = R.run_cell(spec, "caveated.list_ctx", SEED, 1.0, True,
                     device="cpu", adjust=tiny)
    assert out["correct"] is True
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert "idle_outside_program.list" not in m
    assert 1.0 <= m["host_syncs_per_list"] <= 10.0
    for name in READERS[1:-1]:
        assert m[name] > 0.0, name
    assert out["metrics"]["host_syncs_per_list"]["unit"] == "syncs"
