"""The port's multi-process mesh over ``torch.distributed`` with gloo, held
against the JAX package: tests/test_multihost.py's four cases on the port.

- Two processes x 2 CPU cells make one 4-cell mesh (``init_distributed``
  with ``--device cpu``'s gloo backend): the full engine path (bulk
  load, dense blocks, the cross-process MAX joins, an incremental write)
  answers as the JAX package's single-device engine does, with the data
  rows split across the processes (``auto``: data=2) and with one data
  row whose graph axis spans both (data=1, graph=4).
- The engine-host CLI as leader (process 0, serving) and follower
  (``--mirror-leader``, replaying in lockstep), both ``--device cpu
  --distributed ... --engine-mesh auto``, serves writes, bulk checks and
  lists over TCP like a JAX engine; a failing write fails alike on both.
- The mirror's check-item codec round-trips any field content.
- A dead follower makes the leader's next collective fail (gloo) and
  never answer; the leader survives, and restarting the set heals it.

Every subprocess waits under a deadline of its own (120 s or less) and
its output is drained after a kill. On a machine with four cards, the
``cuda`` case runs four ranks over NCCL, one card each, against each
rank's single-device engine (``pytest -m cuda``; it skips elsewhere).
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import threading
import time

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = r"""
import json, os, sys
proc, n, port, repo, axes = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                             sys.argv[4], sys.argv[5])
sys.path.insert(0, repo)
import numpy as np
import torch
from spicedb_kubeapi_proxy_tpu_torch.parallel.multihost import init_distributed
init_distributed(f"127.0.0.1:{port},{n},{proc}", "cpu")
import torch.distributed as dist
from spicedb_kubeapi_proxy_tpu_torch.engine import CheckItem, Engine, WriteOp
from spicedb_kubeapi_proxy_tpu_torch.models.tuples import parse_relationship
from spicedb_kubeapi_proxy_tpu_torch.ops import bitprop, reachability
from spicedb_kubeapi_proxy_tpu_torch.parallel import make_mesh

reachability.DENSE_MIN_EDGES = 4  # dense blocks at this scale
cpu = torch.device("cpu")
cells = [(r, cpu) for r in range(n) for _ in range(2)]
kw = json.loads(axes)
mesh = make_mesh(len(cells), devices=cells, **kw)
rng = np.random.default_rng(7)
rels = [f"namespace:n{i}#creator@user:u{int(rng.integers(50))}"
        for i in range(300)]
rels += [f"pod:n{i%30}/p{i}#namespace@namespace:n{i%30}"
         for i in range(200)]
em = Engine(mesh=mesh, device="cpu")
em.write_relationships([WriteOp("touch", parse_relationship(r))
                        for r in rels])
pairs = list(zip(rng.integers(300, size=32).tolist(),
                 rng.integers(50, size=32).tolist()))
items = [CheckItem("namespace", f"n{i}", "view", "user", f"u{u}")
         for i, u in pairs]
out = {"checks": em.check_bulk(items),
       "lookup": sorted(em.lookup_resources("namespace", "view", "user",
                                            "u3")),
       "pods": sorted(em.lookup_resources("pod", "view", "user", "u3"))}
assert em._sharded is not None and em._sharded._block_meta
em.write_relationships([WriteOp("touch", parse_relationship(
    "namespace:n1#viewer@user:u49"))])
out["after"] = em.check_bulk(
    [CheckItem("namespace", "n1", "view", "user", "u49")])
out["pairs"] = pairs
out["rels"] = rels
out["mesh"] = dict(mesh.shape)
out["dense"] = bitprop.dense_or_matmul.launches
dist.destroy_process_group()
print("RESULT " + json.dumps(out), flush=True)
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env():
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = REPO
    return env


def _reap(procs, deadline_s: float = 20.0) -> list:
    """Terminate, wait under one shared deadline, kill stragglers; every
    process's output, drained."""
    for p in procs:
        if p.poll() is None:
            p.terminate()
    deadline = time.monotonic() + deadline_s
    outs = []
    for p in procs:
        try:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
        outs.append(p.communicate()[0] or "")
    return outs


@pytest.mark.parametrize("axes", [{}, {"data": 1, "graph": 4}],
                         ids=["auto-data-rows", "graph-spans-processes"])
def test_two_process_sharded_engine_parity(tmp_path, axes):
    """2 processes x 2 CPU cells: one 4-cell mesh, cross-process joins
    over gloo; the answers equal the JAX single-device engine's, an
    incremental write included."""
    from spicedb_kubeapi_proxy_tpu.engine import CheckItem, Engine, WriteOp
    from spicedb_kubeapi_proxy_tpu.models.tuples import parse_relationship

    script = tmp_path / "mh_worker.py"
    script.write_text(WORKER)
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(i), "2", str(port), REPO,
         json.dumps(axes)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=_env(), cwd=str(tmp_path))
        for i in range(2)]
    # one SHARED deadline for both workers
    deadline = time.monotonic() + 120
    timed_out = False
    for p in procs:
        try:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            timed_out = True
    outs = _reap(procs)
    if timed_out:
        pytest.fail("multihost workers timed out; outputs:\n"
                    + "\n---\n".join(o[-2000:] for o in outs))
    results = []
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out[-2000:]}"
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        assert line, out[-2000:]
        results.append(json.loads(line[-1][len("RESULT "):]))
    a, b = results
    assert a == b, "both processes read the same gathered answers"
    assert a["mesh"] == ({"data": 2, "graph": 2} if not axes
                         else {"data": 1, "graph": 4})
    # the reference: the JAX package's single-device engine
    ref = Engine()
    ref.write_relationships([WriteOp("touch", parse_relationship(r))
                             for r in a["rels"]])
    items = [CheckItem("namespace", f"n{i}", "view", "user", f"u{u}")
             for i, u in a["pairs"]]
    assert a["checks"] == ref.check_bulk(items)
    assert a["lookup"] == sorted(ref.lookup_resources(
        "namespace", "view", "user", "u3"))
    assert a["pods"] == sorted(ref.lookup_resources("pod", "view", "user",
                                                    "u3"))
    assert a["after"] == [True]


SERVE_WORKER = r"""
import os, sys
role, port_coord, port_tcp, repo = (sys.argv[1], sys.argv[2], sys.argv[3],
                                    sys.argv[4])
sys.path.insert(0, repo)
from spicedb_kubeapi_proxy_tpu_torch.engine.remote import main

pid = "0" if role == "leader" else "1"
argv = ["--device", "cpu", "--distributed", f"127.0.0.1:{port_coord},2,{pid}",
        "--engine-mesh", "auto", "--token", "mh-tok",
        "--engine-insecure"]  # loopback-only test fixture
if role == "leader":
    argv += ["--bind-port", port_tcp]
    print("LEADER STARTING", flush=True)
else:
    argv += ["--mirror-leader", f"127.0.0.1:{port_tcp}",
             "--bind-port", "0"]
    print("FOLLOWER STARTING", flush=True)
sys.exit(main(argv))
"""


def _boot_pair(script, port_coord, port_tcp, budget=120.0):
    """Leader + follower host CLIs; returns once the leader accepts."""
    procs = [subprocess.Popen(
        [sys.executable, script, role, str(port_coord), str(port_tcp),
         REPO], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=_env(), cwd=REPO)
        for role in ("leader", "follower")]
    try:
        deadline = time.monotonic() + budget
        while True:
            try:
                socket.create_connection(("127.0.0.1", port_tcp),
                                         timeout=1).close()
                return procs
            except OSError:
                for p in procs:
                    if p.poll() is not None:
                        raise AssertionError(
                            p.communicate()[0][-2000:])
                if time.monotonic() > deadline:
                    raise AssertionError("leader never bound")
                time.sleep(0.25)
    except BaseException:
        _reap(procs)  # a surviving leader would hold port_tcp
        raise


def test_multihost_serving_leader_follower(tmp_path):
    """Multi-host serving: the port's host CLI as leader (process 0,
    serving TCP, MirroredEngine in lockstep) and follower (process 1,
    replaying the mirror stream), one gloo world, one mesh over both
    processes' CPU cells; a client's writes, bulk checks and lists agree
    with the JAX package's engine, and a failing write fails alike on
    both processes (the follower keeps replaying)."""
    from spicedb_kubeapi_proxy_tpu.engine import CheckItem, Engine, WriteOp
    from spicedb_kubeapi_proxy_tpu.models.tuples import parse_relationship
    from spicedb_kubeapi_proxy_tpu_torch.engine import (
        CheckItem as TCheckItem,
        RelationshipFilter,
        WriteOp as TWriteOp,
    )
    from spicedb_kubeapi_proxy_tpu_torch.engine.remote import RemoteEngine
    from spicedb_kubeapi_proxy_tpu_torch.engine.store import (
        Precondition,
        PreconditionFailed,
    )
    from spicedb_kubeapi_proxy_tpu_torch.models.tuples import (
        parse_relationship as tparse,
    )

    script = tmp_path / "serve_worker.py"
    script.write_text(SERVE_WORKER)
    port_tcp = _free_port()
    procs = _boot_pair(str(script), _free_port(), port_tcp)
    client = None
    try:
        client = RemoteEngine("127.0.0.1", port_tcp, token="mh-tok",
                              timeout=60.0)
        rels = [f"namespace:n{i}#creator@user:u{i % 7}" for i in range(40)]
        client.write_relationships([TWriteOp("touch", tparse(r))
                                    for r in rels])
        ref = Engine()
        ref.write_relationships([WriteOp("touch", parse_relationship(r))
                                 for r in rels])
        idx = [(f"n{i}", f"u{i % 5}") for i in range(25)]
        assert client.check_bulk([TCheckItem("namespace", n, "view", "user",
                                             u) for n, u in idx]) == \
            ref.check_bulk([CheckItem("namespace", n, "view", "user", u)
                            for n, u in idx])
        assert sorted(client.lookup_resources(
            "namespace", "view", "user", "u3")) == \
            sorted(ref.lookup_resources("namespace", "view", "user", "u3"))
        client.write_relationships([TWriteOp("touch", tparse(
            "namespace:n1#viewer@user:u6"))])
        assert client.check_bulk([TCheckItem(
            "namespace", "n1", "view", "user", "u6")]) == [True]
        with pytest.raises(PreconditionFailed):
            client.write_relationships(
                [TWriteOp("touch", tparse("namespace:nope#viewer@user:u0"))],
                [Precondition(RelationshipFilter(
                    resource_type="ghost-type"), must_exist=True)])
        assert client.check_bulk([TCheckItem(
            "namespace", "n1", "view", "user", "u6")]) == [True]
    finally:
        if client is not None:
            client.close()
        outs = _reap(procs)
    for role, out in zip(("leader", "follower"), outs):
        assert "STARTING" in out, (role, out[-1500:])
        assert "Traceback" not in out, (role, out[-2500:])
    assert "distributed: process 0 of 2 (gloo)" in outs[0], outs[0][-1500:]
    assert "engine mesh: {'devices': 2, 'data': 1, 'graph': 2, " \
        "'platform': 'cpu'}" in outs[0], outs[0][-1500:]


def test_mirror_check_item_codec_round_trip():
    """The mirror's check-item codec is injective for any client field
    content and keeps '' apart from None; a malformed payload fails."""
    from spicedb_kubeapi_proxy_tpu_torch.engine import CheckItem
    from spicedb_kubeapi_proxy_tpu_torch.parallel.multihost import (
        MultiHostError,
        decode_check_items,
        encode_check_items,
        normalize_check_item,
    )

    items = [
        CheckItem("pod", "ns/p1", "view", "user", "alice", None),
        CheckItem("pod", "a\x1fb", "view", "user", "c\x1ed", None),
        CheckItem("group", "g\nx", "member", "group", "inner", "member"),
        CheckItem("ns", "", "view", "user", "u", ""),
        CheckItem("t", "名前", "view", "user", "ünïcode", None),
    ]
    got = decode_check_items(encode_check_items(items))
    assert got == items
    assert got[3].subject_relation == "" and got[0].subject_relation is None
    n = normalize_check_item(CheckItem("pod", 123, "view", "user", 7, None))
    assert n.resource_id == "123" and n.subject_id == "7"
    assert decode_check_items(encode_check_items([n])) == [n]
    with pytest.raises(MultiHostError):
        decode_check_items(encode_check_items(items)[:-3])


def test_multihost_follower_death_blocks_leader_restart_heals(tmp_path):
    """SPMD is all-or-nothing: with a dead follower the leader's next
    collective fails (gloo errors fast) and never answers; the leader
    process survives; restarting the set as a unit on the same serving
    port heals it."""
    from spicedb_kubeapi_proxy_tpu_torch.engine import CheckItem, WriteOp
    from spicedb_kubeapi_proxy_tpu_torch.engine.remote import RemoteEngine
    from spicedb_kubeapi_proxy_tpu_torch.models.tuples import (
        parse_relationship,
    )

    script = tmp_path / "serve_worker.py"
    script.write_text(SERVE_WORKER)
    port_tcp = _free_port()
    procs = _boot_pair(str(script), _free_port(), port_tcp)
    client = None
    try:
        client = RemoteEngine("127.0.0.1", port_tcp, token="mh-tok",
                              timeout=30.0)
        client.write_relationships([WriteOp("touch", parse_relationship(
            "namespace:alive#creator@user:u1"))])
        item = CheckItem("namespace", "alive", "view", "user", "u1")
        assert client.check_bulk([item]) == [True]
        procs[1].kill()
        procs[1].wait(timeout=10)
        result: dict = {}

        def doomed_check():
            c2 = RemoteEngine("127.0.0.1", port_tcp, token="mh-tok",
                              timeout=60.0, retries=0)
            try:
                result["got"] = c2.check_bulk([item])
            except Exception as e:  # noqa: BLE001 - the expected failure
                result["err"] = e
            finally:
                c2.close()

        t = threading.Thread(target=doomed_check, daemon=True)
        t.start()
        t.join(60.0)
        # gloo fails the collective fast: an error, never an answer
        assert not t.is_alive(), "the leader's collective never failed"
        assert "got" not in result, \
            f"leader ANSWERED with a dead follower: {result}"
        assert "err" in result
        assert procs[0].poll() is None, "leader process died"
    finally:
        if client is not None:
            client.close()
        _reap(procs)
    # the orchestrator's restart: a fresh set on the same serving port
    procs = _boot_pair(str(script), _free_port(), port_tcp)
    client = None
    try:
        client = RemoteEngine("127.0.0.1", port_tcp, token="mh-tok",
                              timeout=60.0)
        client.write_relationships([WriteOp("touch", parse_relationship(
            "namespace:healed#creator@user:u2"))])
        assert client.check_bulk([CheckItem(
            "namespace", "healed", "view", "user", "u2")]) == [True]
    finally:
        if client is not None:
            client.close()
        _reap(procs)


NCCL_WORKER = r"""
import json, os, sys
rank, n, port, repo = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
sys.path.insert(0, repo)
import numpy as np
import torch
dev = torch.device("cuda", rank)
from spicedb_kubeapi_proxy_tpu_torch.parallel.multihost import init_distributed
init_distributed(f"127.0.0.1:{port},{n},{rank}", dev)
import torch.distributed as dist
from spicedb_kubeapi_proxy_tpu_torch.engine import CheckItem, Engine, WriteOp
from spicedb_kubeapi_proxy_tpu_torch.models.tuples import parse_relationship
from spicedb_kubeapi_proxy_tpu_torch.ops import bitprop, reachability
from spicedb_kubeapi_proxy_tpu_torch.parallel import make_mesh

reachability.DENSE_MIN_EDGES = 4
cells = [(r, torch.device("cuda", r)) for r in range(n)]
rng = np.random.default_rng(7)
rels = [f"namespace:n{i}#creator@user:u{int(rng.integers(50))}"
        for i in range(3000)]
rels += [f"pod:n{i%300}/p{i}#namespace@namespace:n{i%300}"
         for i in range(20000)]
rels += [f"pod:n{i%300}/p{i}#viewer@user:u{int(rng.integers(50))}"
         for i in range(20000)]
ops = [WriteOp("touch", parse_relationship(r)) for r in sorted(set(rels))]
single = Engine(device=dev)
single.write_relationships(ops)
items = [CheckItem("pod", f"n{i%300}/p{i}", "view", "user", f"u{u}")
         for i, u in zip(rng.integers(20000, size=2048).tolist(),
                         rng.integers(50, size=2048).tolist())]
out = {}
for axes in ({}, {"data": 1, "graph": 4}):
    mesh = make_mesh(n, devices=cells, **axes)
    em = Engine(device=dev, mesh=mesh)
    em.write_relationships(ops)
    bitprop.reset_launch_counts()
    ok = em.check_bulk(items) == single.check_bulk(items)
    for u in ("u3", "u7", "u11"):
        ok &= sorted(em.lookup_resources("pod", "view", "user", u)) == \
            sorted(single.lookup_resources("pod", "view", "user", u))
    w = [WriteOp("touch", parse_relationship("pod:n1/p1#viewer@user:u49"))]
    em.write_relationships(w)
    single.write_relationships(w)
    ok &= em.check_bulk([CheckItem("pod", "n1/p1", "view", "user",
                                   "u49")]) == [True]
    out[json.dumps(mesh.shape)] = {
        "ok": bool(ok), "dense": bitprop.dense_or_matmul.launches,
        "bits": bitprop.bit_or_matmul.launches}
dist.destroy_process_group()
print("RESULT " + json.dumps(out), flush=True)
"""


@pytest.mark.cuda
def test_four_ranks_over_nccl_match_the_single_device_engine(tmp_path):
    """Four processes, one card each, one NCCL world: the mesh at (2, 2)
    (the data rows on different ranks, each row's graph join across
    two) and at (1, 4) answers checks, lists and a write as each rank's
    single-device engine does, through the dense kernel."""
    import torch

    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards (NCCL puts one rank on a card)")
    script = tmp_path / "nccl_worker.py"
    script.write_text(NCCL_WORKER)
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), "4", str(port), REPO],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=_env(), cwd=str(tmp_path)) for r in range(4)]
    deadline = time.monotonic() + 120
    for p in procs:
        try:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            pass
    outs = _reap(procs)
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out[-2000:]}"
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        assert line, out[-2000:]
        res = json.loads(line[-1][len("RESULT "):])
        assert set(res) == {'{"data": 2, "graph": 2}',
                            '{"data": 1, "graph": 4}'}, res
        for shape, got in res.items():
            assert got["ok"] and got["dense"] > 0 and got["bits"] == 0, \
                (r, shape, got)
        print(f"rank {r}: {res}")
