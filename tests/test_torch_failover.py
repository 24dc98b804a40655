"""PyTorch port, leader failover (parallel/failover.py,
parallel/multihost.py and the engine host's ``--peers`` mode) held
against the JAX package.

Every case of test_failover.py runs here on the port (``port_cases``):
term fencing over the wire, the election order, term persistence, sync
replication acks and the min-sync floor, the equal-term conflict, the
role gate, client-side failover, /readyz's replication line, and the
acceptance run, which spawns two port host CLIs (``python -m
spicedb_kubeapi_proxy_tpu_torch.engine.remote --peers ... --device
cpu``), SIGKILLs the leader under acknowledged writes and reads every
one back from the promoted follower. Then the two packages side by side:
the pure functions agree, and a JAX client follows a port failover set
as it follows a JAX one.
"""

from __future__ import annotations

import asyncio

import pytest

from spicedb_kubeapi_proxy_tpu.engine import remote as jremote
from spicedb_kubeapi_proxy_tpu.parallel import failover as jfailover
from spicedb_kubeapi_proxy_tpu.parallel import multihost as jmultihost
from spicedb_kubeapi_proxy_tpu_torch.engine import (
    CheckItem,
    Engine,
    WriteOp,
)
from spicedb_kubeapi_proxy_tpu_torch.engine import remote
from spicedb_kubeapi_proxy_tpu_torch.models.tuples import parse_relationship
from spicedb_kubeapi_proxy_tpu_torch.parallel import failover, multihost

from torch_parity import port_cases

_CASES = port_cases("test_failover.py", replacements=(
    # the port's engine runs where it is told: the CPU here
    ("Engine()", 'Engine(device="cpu")'),
    # the spawned peers are the port's host CLI, on the CPU
    ('os.environ["JAX_PLATFORMS"] = "cpu"\nsys.path.insert(0, repo)\n'
     'import jax\njax.config.update("jax_platforms", "cpu")\n',
     "sys.path.insert(0, repo)\n"),
    ('"--token", "fo-tok", "--engine-insecure",',
     '"--token", "fo-tok", "--engine-insecure", "--device", "cpu",'),
))
globals().update(_CASES)


def test_every_jax_case_runs_on_the_port():
    assert len(_CASES) == 20
    g = next(iter(_CASES.values())).__globals__
    assert g["MirroredEngine"] is multihost.MirroredEngine
    assert g["FailoverEngine"] is remote.FailoverEngine
    assert "torch.engine.remote import main" in g["FAILOVER_WORKER"]


@pytest.mark.parametrize("spec", [
    "a:1,b:2", "[::1]:50051", " h:7 , k:8 ", "", "a", "a:0", "a:x",
    "a:70000"])
def test_parse_peers_agrees_with_the_jax_package(spec):
    def run(mod):
        try:
            return mod.parse_peers(spec)
        except mod.FailoverError as e:
            return ("error", str(e))
    assert run(failover) == run(jfailover)


def test_election_and_fencing_agree_with_the_jax_package():
    import itertools
    import random

    rng = random.Random(7)
    for _ in range(200):
        n = rng.randint(0, 4)
        states = {pid: {"term": rng.randint(0, 3),
                        "revision": rng.randint(0, 5)}
                  for pid in rng.sample(range(6), n)}
        assert failover.choose_candidate(states) \
            == jfailover.choose_candidate(states)
    for frame_term, cur in itertools.product((None, 0, 1, 2, 5), (0, 2)):
        def run(mod):
            try:
                return mod.fence_term(frame_term, cur)
            except mod.StaleTermError as e:
                return ("stale", str(e))
        assert run(multihost) == run(jmultihost)
    items = [CheckItem("pod", "ns/p\x00", "view", "user", "", None),
             CheckItem("pod", "é", "view", "user", "u", "member")]
    assert multihost.encode_check_items(items) \
        == jmultihost.encode_check_items(items)
    assert failover.ROLE_GAUGE == jfailover.ROLE_GAUGE


def test_jax_client_follows_a_port_failover_set():
    """A JAX ``FailoverEngine`` over two port hosts: a follower's
    not_leader re-aims it at the leader, a promotion re-resolves it."""
    def status(role, term, pid):
        d = {"role": role, "term": term, "revision": 0, "peer_id": pid,
             "lag": 0}

        def fn():
            return dict(d)
        fn.d = d
        return fn

    async def go():
        e_a, e_b = Engine(device="cpu"), Engine(device="cpu")
        st_a, st_b = status("leader", 1, 0), status("follower", 1, 1)
        srv_a = remote.EngineServer(e_a, failover_status=st_a)
        srv_b = remote.EngineServer(e_b, failover_status=st_b)
        port_a, port_b = await srv_a.start(), await srv_b.start()
        fe = jremote.FailoverEngine(
            [("127.0.0.1", port_b), ("127.0.0.1", port_a)],
            connect_timeout=1.0, timeout=5.0, retries=0,
            probe_timeout=2.0, resolve_deadline=5.0)
        from spicedb_kubeapi_proxy_tpu.engine import WriteOp as JWriteOp
        from spicedb_kubeapi_proxy_tpu.models.tuples import (
            parse_relationship as jparse,
        )
        w = [JWriteOp("touch", jparse("namespace:n1#creator@user:alice"))]
        assert await asyncio.to_thread(fe.write_relationships, w) == 1
        assert e_a.revision == 1 and e_b.revision == 0
        await srv_a.stop()
        st_b.d.update(role="leader", term=2)
        e_b.write_relationships([WriteOp("touch", parse_relationship(
            "namespace:n9#creator@user:bob"))])
        from spicedb_kubeapi_proxy_tpu.engine import CheckItem as JCheck
        got = await asyncio.to_thread(
            fe.check_bulk, [JCheck("namespace", "n9", "view", "user", "bob"),
                            JCheck("namespace", "n1", "view", "user",
                                   "alice")])
        assert got == [True, False]
        st = await asyncio.to_thread(fe.replication_status)
        assert st["role"] == "leader" and st["term"] == 2
        fe.close()
        await srv_b.stop()

    asyncio.run(go())


def test_load_status_on_a_gated_leader_answers_as_the_jax_host():
    """The reference's fault, copied as it is: with a failover role
    provider, ``load_status`` is role-gated and runs against the gate's
    ``_EngineView``, which has no ``admission``; both hosts answer
    ``kind: "internal"`` alike (a follower answers ``not_leader``)."""
    import socket

    def leader():
        return {"role": "leader", "term": 1, "revision": 0,
                "peer_id": 0, "lag": 0}

    frames = {}
    for name, rem, eng in (
            ("jax", jremote, lambda: __import__(
                "spicedb_kubeapi_proxy_tpu.engine",
                fromlist=["Engine"]).Engine()),
            ("torch", remote, lambda: Engine(device="cpu"))):
        async def go(rem=rem, eng=eng):
            srv = rem.EngineServer(eng(), failover_status=leader)
            port = await srv.start()
            try:
                def ask():
                    s = socket.create_connection(("127.0.0.1", port),
                                                 timeout=10)
                    try:
                        s.sendall(rem._pack({"op": "load_status"}))
                        return rem._read_frame_sync(s)
                    finally:
                        s.close()
                return await asyncio.to_thread(ask)
            finally:
                await srv.stop()
        frames[name] = asyncio.run(go())
    assert frames["torch"] == frames["jax"]
    assert frames["torch"]["kind"] == "internal"
    assert "admission" in frames["torch"]["error"]
