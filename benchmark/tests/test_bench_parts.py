"""The yardstick's parts: the frozen byte counts, the launch spy, the
trace reduction, the reference, and what the harness may import."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest

from benchmark import roofline, run as R, spec as S, tracing
from benchmark.tests.conftest import ROOT, tiny

HERE = os.path.join(ROOT, "benchmark")


def test_bit_hop_bytes_on_a_hand_built_block():
    # 64 destination rows of 8 words, 2 frontier rows, 3 words live
    assert roofline.bit_hop_bytes(64, 8, 2, 3) == 64 * 3 * 4 + 2 * 8 * 4 \
        + 2 * 64
    assert roofline.bit_hop_bytes(64, 8, 1, 0) == 8 * 4 + 64


def test_dense_hop_bytes_and_ops_on_a_hand_built_block():
    # [128 x 256] int8 block, batch 16, 5 live source columns
    assert roofline.dense_hop_bytes(128, 256, 16, 5) == 128 * 5 \
        + 16 * 256 + 16 * 128
    assert roofline.dense_hop_ops(128, 16, 5) == 2 * 16 * 128 * 5
    t = roofline.bound_s(3.35e12, 0)
    assert t == pytest.approx(1.0)
    assert roofline.bound_s(0, 1.979e15) == pytest.approx(1.0)


def test_launch_spy_counts_the_live_frontier():
    import torch

    from benchmark.launches import LaunchSpy
    from spicedb_kubeapi_proxy_tpu_torch.ops import bitprop

    a = torch.zeros((64, 8), dtype=torch.int32)
    vb = torch.zeros((bitprop.BIT_B_MAX, 8), dtype=torch.int32)
    vb[0, 1] = 5
    vb[1, 1] = 1
    vb[1, 6] = 1
    vb[3, 7] = 1  # past n_b: not live
    A = torch.zeros((128, 64), dtype=torch.int8)
    f = torch.zeros((16, 64), dtype=torch.uint8)
    f[0, 3] = f[5, 3] = f[9, 40] = 1
    spy = LaunchSpy(torch, bitprop)
    before = bitprop.bit_or_matmul.launches
    spy.install()
    try:
        bitprop.bit_or_matmul(a, vb, 2)
        bitprop.dense_or_matmul(A, f)
    finally:
        spy.remove()
    assert bitprop.bit_or_matmul.launches == before  # plain path: none
    got = spy.totals()
    assert got["bit_or_matmul"]["n"] == 1
    assert got["bit_or_matmul"]["bound_s"] == pytest.approx(
        roofline.bound_s(roofline.bit_hop_bytes(64, 8, 2, 2)))
    assert got["dense_or_matmul"]["bound_s"] == pytest.approx(
        roofline.bound_s(roofline.dense_hop_bytes(128, 64, 16, 2),
                         roofline.dense_hop_ops(128, 16, 2)))


def _brute_gaps(g_lo, g_hi, host):
    want = {}
    for lo, hi in zip(g_lo.tolist(), g_hi.tolist()):
        m = (lo + hi) // 2
        c = [(h[1], i) for i, h in enumerate(host) if h[0] <= m <= h[0] + h[1]]
        nm = host[min(c)[1]][2] if c else "no host operation"
        want[nm] = want.get(nm, 0.0) + (hi - lo) * 1e-9
    return want


@pytest.mark.parametrize("seed", range(5))
def test_idle_gaps_named_by_the_innermost_host_operation(seed):
    rng = np.random.default_rng(seed)
    lo, dur = rng.integers(0, 10000, 300), rng.integers(1, 3000, 300)
    host = [(int(a), int(d), f"op{i % 40}") for i, (a, d) in
            enumerate(zip(lo, dur))]
    g_lo = np.sort(rng.integers(0, 10000, 40))
    g_hi = g_lo + rng.integers(1, 50, 40)
    got = dict(tracing._name_gaps(g_lo, g_hi, host))
    want = _brute_gaps(g_lo, g_hi, host)
    assert set(got) == set(want)
    for k in got:
        assert got[k] == pytest.approx(want[k])


def test_range_device_time_follows_the_launching_thread():
    # host: (start, duration, name, thread, correlation)
    host = [(0, 100, "caveat_vm", 1, 10), (10, 5, "aten::add", 1, 11),
            (200, 5, "aten::add", 1, 12), (20, 5, "aten::add", 2, 13),
            (300, 50, "aten::index_add_", 2, 14),
            (310, 5, "cudaLaunchKernel", 2, 15)]
    # device: (start, duration, name, linked correlation)
    dev = [(50, 7, "k1", 11), (210, 3, "k2", 12), (60, 4, "k3", 13),
           (400, 9, "k4", 15)]
    dur = np.asarray([d[1] for d in dev], dtype=np.int64)
    got = tracing._range_device_s(dev, dur, host)
    assert got["caveat_vm"] == (1, pytest.approx(7e-9))
    assert got["aten::index_add_"] == (1, pytest.approx(9e-9))


def test_reference_answers_depend_on_the_context(spec):
    cell = S.cell(spec, "caveated.list_ctx")
    tiny(cell)
    cfg = cell["config"]
    data = S.generator(cfg["generator"]).generate(cfg, 9)
    ref = S.reference(cfg["generator"]).Reference(cfg, data)
    both, first, none = ({"ip": "10.1.2.3"}, {"ip": "192.168.1.1"}, None)
    diff = 0
    for u in range(40):
        a, b, c = (ref.lookup(u, x) for x in (both, first, none))
        assert (c <= b).all() and (b <= a).all()
        diff += int(a.sum() - c.sum())
        assert c.any()
    assert diff > 0
    # nested groups: a member of g6 views what g0's namespaces hold
    member = ref.ns_view
    assert member.any()


def test_reference_agrees_with_a_row_by_row_reading(spec):
    cell = S.cell(spec, "caveated.list_ctx")
    tiny(cell)
    cfg = cell["config"]
    data = S.generator(cfg["generator"]).generate(cfg, 4)
    ref = S.reference(cfg["generator"]).Reference(cfg, data)
    rows = data["rows"]
    groups = {}
    for g, u in zip(*rows["group#member@user"][:2]):
        groups.setdefault(int(u), set()).add(int(g))
    nest = list(zip(*rows["group#member@group#member"][:2]))
    ns_of = dict(zip(*(x.tolist() for x in rows["pod#namespace@namespace"])))
    ns_groups = {}
    for n, g in zip(*rows["namespace#viewer@group#member"][:2]):
        ns_groups.setdefault(int(n), set()).add(int(g))
    p, u, c = rows["pod#viewer@user"]
    ctx = {"ip": "192.168.1.1"}
    for user in range(0, 300, 37):
        mine = set(groups.get(user, ()))
        while True:
            more = {int(pa) for pa, ch in nest if int(ch) in mine} - mine
            if not more:
                break
            mine |= more
        want = np.zeros(len(data["names"]["pod"]), dtype=bool)
        for pod, n in ns_of.items():
            if ns_groups.get(n, set()) & mine:
                want[pod] = True
        sel = u == user
        for pod, ci in zip(p[sel].tolist(), c[sel].tolist()):
            # stored context 0 allows 192.168/16, context 1 does not
            if ci in (-1, 0):
                want[pod] = True
        assert (ref.lookup(user, ctx) == want).all()


@pytest.mark.parametrize("name,bad", [
    ("spicedb_kubeapi_proxy_tpu_torch.engine", False),
    ("spicedb_kubeapi_proxy_tpu", True), ("spicedb_kubeapi_proxy_tpu.ops",
                                           True),
    ("jax", True), ("jaxlib.xla_client", True), ("flax.linen", True),
    ("jaxtyping", False)])
def test_forbidden_names_compare_whole(monkeypatch, name, bad):
    monkeypatch.setitem(sys.modules, name, sys)
    assert (name.split(".")[0] in R.forbidden_modules()) is bad


def _py_files():
    for d, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_file_imports_jax_or_the_jax_package():
    for path in _py_files():
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in R.FORBIDDEN, (path, n)


def test_reference_imports_neither_torch_nor_the_port():
    for f in os.listdir(os.path.join(HERE, "reference")):
        if not f.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(HERE, "reference", f)).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                assert node.level == 0, f
                names = [node.module]
            else:
                continue
            for n in names:
                assert n.split(".")[0] in ("numpy", "ipaddress", "json",
                                           "typing", "__future__"), (f, n)


def test_importing_the_harness_loads_no_forbidden_module():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from benchmark import run, drive, tracing, launches, control, "
            "spec as S\n"
            "sp = S.load_spec()\n"
            "for w in sp['workloads']:\n"
            "    c = S.cell(sp, w['name'])\n"
            "    S.op(c['traffic']['op']); S.generator("
            "c['config']['generator']); S.reference(c['config']['generator'])"
            "\n"
            "for m in sp['end_to_end'] + sp['per_layer']:\n"
            "    S.metric_reader(m['name'])\n"
            "import spicedb_kubeapi_proxy_tpu_torch.engine\n"
            "print(run.forbidden_modules())\n" % ROOT)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, env=env, cwd="/")
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip().splitlines()[-1] == "[]"


def test_run_without_a_card_exits_without_a_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would measure")
    p = subprocess.run([sys.executable, os.path.join(HERE, "run.py"),
                        "--workload", "caveated.list_ctx", "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 2
    assert p.stdout == ""


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["headline.list_fanout",
                                      "caveated.list_ctx",
                                      "headline.bulk_check"])
def test_cell_is_correct_on_the_card(spec_full, workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernels run only there")
    out = R.run_cell(spec_full, workload, 2**31 + 99, 2.0, True, device="cuda",
                     adjust=tiny)
    assert out["correct"] is True, out["compared"]
    assert out["device"]["busy_s"] > 0


class _Future:
    def __init__(self, log, k):
        self.log, self.k = log, k

    def result(self):
        self.log.append(("answer", self.k))
        return self.k


def test_closed_loop_keeps_its_depth_and_refills_in_bursts():
    from benchmark import drive

    log: list = []

    def stream():
        k = 0
        while True:
            def send(k=k):
                log.append(("send", k))
                return _Future(log, k)
            yield k, send
            k += 1

    reqs, t0, t_close = drive.run(stream(), depth=6, burst=3, seconds=0.05)
    assert t_close - t0 >= 0.05
    sent = [k for what, k in log if what == "send"]
    assert sent == list(range(len(reqs)))
    # six in flight before the first answer, then three answers before
    # each three sends, oldest first
    assert [w for w, _ in log[:12]] == ["send"] * 6 + ["answer"] * 3 + [
        "send"] * 3
    assert [k for w, k in log if w == "answer"] == sorted(
        k for w, k in log if w == "answer")
    assert all(r.output == r.key and r.t_end is not None for r in reqs)
    assert sum(r.t_end > t_close for r in reqs) == 6  # drained after
    assert all(r.latency() >= 0 for r in reqs)
