"""PyTorch port, durability (persistence/ and the store's journal,
replay and snapshot half), held against the JAX package.

(a) test_persistence.py's store, WAL, recovery, checkpointer,
engine-restart and SIGKILL tests and test_snapshot.py's five tests, run
on the port's own modules; (b) the formats carried across packages: a
snapshot and a WAL written by the JAX store load into the port's store,
and the reverse, at the same revision with the same rows, interners and
caveat instances, after which the two engines answer byte-equal (the
caveated mesh graph included, under three request contexts); (c) a
restore on a serving engine: the decision cache never serves an entry of
the replaced lineage (same revision number, other rows), the old base's
device state is released, and a watcher from before the restore must
re-list.
"""

import os
import struct
import subprocess
import sys
import time

import numpy as np
import pytest

from bench import MESH_SCHEMA
from chip_smoke import build_rows
from spicedb_kubeapi_proxy_tpu.engine import CheckItem as JCheckItem
from spicedb_kubeapi_proxy_tpu.engine import Engine as JEngine
from spicedb_kubeapi_proxy_tpu.engine.store import Store as JStore
from spicedb_kubeapi_proxy_tpu.engine.store import WriteOp as JWriteOp
from spicedb_kubeapi_proxy_tpu.engine.store import \
    RelationshipFilter as JFilter
from spicedb_kubeapi_proxy_tpu.models import parse_schema as jparse_schema
from spicedb_kubeapi_proxy_tpu.models.tuples import \
    Relationship as JRelationship
from spicedb_kubeapi_proxy_tpu.persistence import Persistence as JPersistence
from spicedb_kubeapi_proxy_tpu.persistence import recover as jrecover
from spicedb_kubeapi_proxy_tpu_torch.engine import (
    CheckItem,
    Engine,
    RelationshipFilter,
    WriteOp,
)
from spicedb_kubeapi_proxy_tpu_torch.engine.store import Store, StoreError
from spicedb_kubeapi_proxy_tpu_torch.models import parse_schema
from spicedb_kubeapi_proxy_tpu_torch.models.tuples import (
    Relationship,
    parse_relationship,
)
from spicedb_kubeapi_proxy_tpu_torch.persistence import (
    Persistence,
    RecoveryError,
    WalError,
    WriteAheadLog,
    decode_bulk_cols,
    encode_bulk_cols,
    list_snapshots,
    parse_fsync_policy,
    recover,
)
from spicedb_kubeapi_proxy_tpu_torch.persistence import wal as walmod
from spicedb_kubeapi_proxy_tpu_torch.utils.metrics import metrics

SCHEMA_TEXT = """
use expiration

definition user {}
definition group { relation member: user }
definition ns {
  relation viewer: user | group#member | user with expiration
  relation banned: user
  permission view = viewer - banned
}
"""
SCHEMA = parse_schema(SCHEMA_TEXT)


def rel(i, u="u0", exp=None):
    return Relationship("ns", f"n{i}", "viewer", "user", u, None, exp)


def all_reads(store):
    return sorted(str(r) for r in store.read(RelationshipFilter()))


# -- (a) the WAL ---------------------------------------------------------------


def test_fsync_policy_parse():
    assert parse_fsync_policy("always") == ("always", 0.0)
    assert parse_fsync_policy("off") == ("off", 0.0)
    mode, iv = parse_fsync_policy("interval:250")
    assert mode == "interval" and iv == pytest.approx(0.25)
    for bad in ("", "sometimes", "interval:", "interval:-5", "interval:x"):
        with pytest.raises(WalError):
            parse_fsync_policy(bad)
    # the reference's default policy, unchanged
    assert walmod.DEFAULT_FSYNC == "interval:100"
    assert walmod.MAX_WAL_FRAME == 1 << 31


def test_wal_round_trip_with_blobs(tmp_path):
    d = str(tmp_path / "wal")
    w = WriteAheadLog(d, fsync="off")
    w.append({"kind": "write", "rev": 1, "effects": [{"op": "touch"}]})
    w.append({"kind": "bulk_load", "rev": 2}, b"\x00\x01binary\xffblob")
    w.append({"kind": "write", "rev": 3, "effects": []})
    w.close()
    got = list(walmod.replay(d))
    assert [m["rev"] for m, _ in got] == [1, 2, 3]
    assert got[1][1] == b"\x00\x01binary\xffblob"
    assert got[0][1] is None
    assert [m["rev"] for m, _ in walmod.replay(d, from_revision=2)] == [3]


def test_wal_rotation_and_prune(tmp_path):
    d = str(tmp_path / "wal")
    w = WriteAheadLog(d, fsync="off", segment_bytes=256)
    for i in range(1, 41):
        w.append({"kind": "write", "rev": i,
                  "effects": [{"pad": "x" * 64}]})
    segs = walmod.list_segments(d)
    assert len(segs) > 2, "expected rotation at 256-byte segments"
    assert [m["rev"] for m, _ in walmod.replay(d)] == list(range(1, 41))
    w.prune_upto(20)
    kept = walmod.list_segments(d)
    assert kept and kept[0][0] <= 21
    assert [m["rev"] for m, _ in walmod.replay(d, from_revision=20)] \
        == list(range(21, 41))
    w.close()


def test_wal_torn_tail_truncates_cleanly(tmp_path):
    d = str(tmp_path / "wal")
    w = WriteAheadLog(d, fsync="off")
    for i in range(1, 6):
        w.append({"kind": "write", "rev": i, "effects": []})
    w.close()
    path = walmod.list_segments(d)[-1][1]
    with open(path, "ab") as f:
        f.write(struct.pack(">II", 1000, 0) + b"short")
    size_torn = os.path.getsize(path)
    assert [m["rev"] for m, _ in walmod.replay(d)] == [1, 2, 3, 4, 5]
    assert os.path.getsize(path) < size_torn, "torn tail not truncated"
    assert [m["rev"] for m, _ in walmod.replay(d)] == [1, 2, 3, 4, 5]
    w2 = WriteAheadLog(d, fsync="off")
    w2.append({"kind": "write", "rev": 6, "effects": []})
    w2.close()
    assert [m["rev"] for m, _ in walmod.replay(d)] == [1, 2, 3, 4, 5, 6]


def test_wal_torn_first_frame_removes_segment(tmp_path):
    d = str(tmp_path / "wal")
    w = WriteAheadLog(d, fsync="off", segment_bytes=64)
    w.append({"kind": "write", "rev": 1,
              "effects": [{"pad": "x" * 64}]})
    w.append({"kind": "write", "rev": 2, "effects": []})
    w.close()
    segs = walmod.list_segments(d)
    assert len(segs) == 2
    with open(segs[-1][1], "r+b") as f:
        f.truncate(len(walmod.MAGIC) + 3)
    assert [m["rev"] for m, _ in walmod.replay(d)] == [1]
    assert not os.path.exists(segs[-1][1])
    w2 = WriteAheadLog(d, fsync="off")
    w2.append({"kind": "write", "rev": 2, "effects": []})
    w2.close()
    assert [m["rev"] for m, _ in walmod.replay(d)] == [1, 2]


def test_wal_rejects_oversized_frame(tmp_path, monkeypatch):
    monkeypatch.setattr(walmod, "MAX_WAL_FRAME", 64)
    w = WriteAheadLog(str(tmp_path / "wal"), fsync="off")
    with pytest.raises(WalError, match="frame bound"):
        w.append({"kind": "bulk_load", "rev": 1}, b"x" * 128)
    w.close()


def test_recovery_fails_closed_on_mid_history_corruption(tmp_path):
    d = str(tmp_path / "data")
    s = Store()
    p = Persistence.open(s, d, wal_fsync="off", segment_bytes=64,
                         auto_checkpoint=False)
    for i in range(6):
        s.write([WriteOp("touch", rel(i))])
    p.wal.sync()
    p.close(final_checkpoint=False)
    segs = walmod.list_segments(os.path.join(d, "wal"))
    assert len(segs) >= 3
    with open(segs[1][1], "r+b") as f:
        f.seek(len(walmod.MAGIC) + 2)
        b = f.read(1)
        f.seek(len(walmod.MAGIC) + 2)
        f.write(bytes([b[0] ^ 0xFF]))
    with pytest.raises(RecoveryError, match="mid-history"):
        recover(Store(), d)


def test_wal_corrupt_crc_detected(tmp_path):
    d = str(tmp_path / "wal")
    w = WriteAheadLog(d, fsync="off")
    w.append({"kind": "write", "rev": 1, "effects": []})
    w.append({"kind": "write", "rev": 2, "effects": []})
    w.close()
    path = walmod.list_segments(d)[-1][1]
    data = bytearray(open(path, "rb").read())
    data[-3] ^= 0xFF
    open(path, "wb").write(bytes(data))
    assert [m["rev"] for m, _ in walmod.replay(d)] == [1]


# -- (a) the store's journal and recovery ---------------------------------------


def test_recover_write_delete_bulk_and_expiry(tmp_path):
    d = str(tmp_path / "data")
    s = Store()
    p = Persistence.open(s, d, wal_fsync="off", auto_checkpoint=False)
    now = time.time()
    for i in range(10):
        s.write([WriteOp("touch", rel(i, f"u{i % 3}"))])
    s.write([WriteOp("touch", rel(99, "exp-user", now + 3600))])
    s.write([WriteOp("touch", rel(98, "dead-user", now - 10))])  # expired
    s.delete_by_filter(RelationshipFilter(resource_id="n3"))
    s.bulk_load({"resource_type": ["pod"] * 3,
                 "resource_id": ["a", "b", "c"],
                 "relation": ["viewer"] * 3,
                 "subject_type": ["user"] * 3,
                 "subject_id": ["x", "y", "z"]})
    s.write([WriteOp("delete", rel(1, "u1"))])
    p.wal.sync()
    want_rev, want_reads, want_len = s.revision, all_reads(s), len(s)
    s2 = Store()
    res = recover(s2, d)  # a crash: no close, no checkpoint
    assert res.snapshot_path is None
    assert res.replayed_records == res.revision == want_rev
    assert s2.revision == want_rev
    assert len(s2) == want_len
    assert all_reads(s2) == want_reads
    assert s2.write([WriteOp("touch", rel(500))]) == want_rev + 1
    p.close(final_checkpoint=False)


def test_snapshot_checkpoint_then_tail_replay(tmp_path):
    d = str(tmp_path / "data")
    s = Store()
    p = Persistence.open(s, d, wal_fsync="off", auto_checkpoint=False)
    for i in range(5):
        s.write([WriteOp("touch", rel(i))])
    assert p.checkpoint_now() == 5
    assert [r for r, _ in list_snapshots(os.path.join(d, "snapshots"))] \
        == [5]
    for i in range(5, 8):
        s.write([WriteOp("touch", rel(i))])
    p.wal.sync()
    want = all_reads(s)
    s2 = Store()
    res = recover(s2, d)
    assert res.snapshot_revision == 5
    assert res.replayed_records == 3
    assert s2.revision == 8 and all_reads(s2) == want
    p.close(final_checkpoint=False)


def test_corrupt_snapshot_falls_back_to_previous(tmp_path):
    d = str(tmp_path / "data")
    s = Store()
    p = Persistence.open(s, d, wal_fsync="off", auto_checkpoint=False)
    for i in range(4):
        s.write([WriteOp("touch", rel(i))])
    p.checkpoint_now()
    for i in range(4, 9):
        s.write([WriteOp("touch", rel(i))])
    p.checkpoint_now()
    s.write([WriteOp("touch", rel(100, "tail-user"))])
    p.wal.sync()
    want_rev, want = s.revision, all_reads(s)
    snaps = list_snapshots(os.path.join(d, "snapshots"))
    assert len(snaps) == 2
    newest = snaps[-1][1]
    with open(newest, "r+b") as f:
        f.seek(0)
        f.write(b"\xde\xad\xbe\xef" * 8)
    s2 = Store()
    res = recover(s2, d)
    assert res.corrupt_snapshots == [newest]
    assert res.snapshot_revision == snaps[0][0]
    assert s2.revision == want_rev and all_reads(s2) == want
    p.close(final_checkpoint=False)


def test_checkpointer_auto_triggers_and_prunes(tmp_path):
    d = str(tmp_path / "data")
    s = Store()
    p = Persistence.open(s, d, wal_fsync="off", segment_bytes=512,
                         checkpoint_wal_records=10, checkpoint_keep=1)
    for i in range(25):
        s.write([WriteOp("touch", rel(i))])
    deadline = time.monotonic() + 10
    snap_dir = os.path.join(d, "snapshots")
    while time.monotonic() < deadline and not list_snapshots(snap_dir):
        time.sleep(0.05)
    assert list_snapshots(snap_dir), "threshold checkpoint never ran"
    p.close()  # final checkpoint at rev 25
    assert list_snapshots(snap_dir)[-1][0] == 25
    s2 = Store()
    res = recover(s2, d)
    assert s2.revision == 25 and res.replayed_records == 0
    assert len(s2) == 25


def test_final_checkpoint_makes_next_boot_replay_free(tmp_path):
    d = str(tmp_path / "data")
    s = Store()
    p = Persistence.open(s, d, wal_fsync="off", auto_checkpoint=False)
    for i in range(6):
        s.write([WriteOp("touch", rel(i))])
    p.close()
    s2 = Store()
    res = recover(s2, d)
    assert res.replayed_records == 0 and res.snapshot_revision == 6
    assert s2.revision == 6 and len(s2) == 6


# -- (a) the engine's restart ---------------------------------------------------


def engine_checks(e, now=None):
    return [e.check(CheckItem("ns", n, "view", "user", u), now=now)
            for n, u in (("dev", "alice"), ("dev", "bob"),
                         ("prod", "carol"), ("tmp", "dave"),
                         ("dev", "nobody"))]


def test_differential_engine_restart(tmp_path):
    """A write/delete/expire workload recovered by a fresh engine answers
    byte-identically, at a revision that resumes past the pre-crash one."""
    d = str(tmp_path / "data")
    e = Engine(schema=SCHEMA, device="cpu")
    e.enable_persistence(d, wal_fsync="off", auto_checkpoint=False)
    now = time.time()
    e.write_relationships(
        [WriteOp("touch", parse_relationship(r)) for r in (
            "group:eng#member@user:alice",
            "ns:dev#viewer@group:eng#member",
            "ns:dev#viewer@user:bob",
            "ns:dev#banned@user:bob",
            "ns:tmp#viewer@user:dave",
        )])
    e.write_relationships([WriteOp("touch", Relationship(
        "ns", "prod", "viewer", "user", "carol", None, now + 3600))])
    e.write_relationships([WriteOp("touch", Relationship(
        "ns", "prod", "viewer", "user", "eve", None, now - 5))])
    e.delete_relationships(RelationshipFilter(resource_id="tmp"))
    e.persistence.wal.sync()
    pre_rev = e.revision
    pin = time.time()
    want_checks = engine_checks(e, now=pin)
    want_lookup = sorted(e.lookup_resources("ns", "view", "user", "alice"))
    want_reads = all_reads(e.store)

    e2 = Engine(schema=SCHEMA, device="cpu")
    p2 = e2.enable_persistence(d, wal_fsync="off", auto_checkpoint=False)
    assert p2.recovery.replayed_records == pre_rev
    assert e2.revision == pre_rev
    assert all_reads(e2.store) == want_reads
    assert engine_checks(e2, now=pin) == want_checks
    assert sorted(e2.lookup_resources("ns", "view", "user", "alice")) \
        == want_lookup
    assert e2.write_relationships(
        [WriteOp("touch", parse_relationship("ns:new#viewer@user:zed"))]
    ) == pre_rev + 1
    e2.close_persistence(final_checkpoint=False)
    e.close_persistence(final_checkpoint=False)


def test_load_snapshot_refused_with_persistence(tmp_path):
    e = Engine(schema=SCHEMA, device="cpu")
    path = str(tmp_path / "snap.npz")
    e.save_snapshot(path)
    e.enable_persistence(str(tmp_path / "data"), wal_fsync="off",
                         auto_checkpoint=False)
    with pytest.raises(StoreError):
        e.load_snapshot(path)
    e.close_persistence(final_checkpoint=False)


_CHILD = r"""
import sys
sys.path.insert(0, {repo!r})
from spicedb_kubeapi_proxy_tpu_torch.engine.store import Store, WriteOp
from spicedb_kubeapi_proxy_tpu_torch.models.tuples import Relationship
from spicedb_kubeapi_proxy_tpu_torch.persistence import Persistence

s = Store()
p = Persistence.open(s, {data_dir!r}, wal_fsync="always",
                     auto_checkpoint=False)
i = 0
while True:
    rev = s.write([WriteOp("touch", Relationship(
        "ns", "n%d" % i, "viewer", "user", "u%d" % (i % 7)))])
    # the ack: printed only after the journaled write returned
    print("ACK %d %d" % (rev, i), flush=True)
    i += 1
"""


def test_sigkill_mid_write_load_recovers_every_acked_write(tmp_path):
    """SIGKILL a port writer mid-load: recovery holds every acknowledged
    write, with revisions resuming above the highest acked one."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    d = str(tmp_path / "data")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.Popen(
        [sys.executable, "-c", _CHILD.format(repo=repo, data_dir=d)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env)
    acked = []
    try:
        deadline = time.monotonic() + 60
        while len(acked) < 25 and time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            if line.startswith("ACK "):
                _, rev, i = line.split()
                acked.append((int(rev), int(i)))
        assert len(acked) >= 25, (acked, proc.stderr.read())
    finally:
        proc.kill()
        proc.wait(timeout=30)
    s = Store()
    res = recover(s, d)
    max_rev = max(r for r, _ in acked)
    for _, i in acked:
        assert s.exists(RelationshipFilter(
            resource_type="ns", resource_id=f"n{i}")), f"lost acked n{i}"
    revs = [r for r, _ in acked]
    assert revs == sorted(set(revs))
    assert s.revision >= max_rev
    assert res.revision == s.revision
    assert s.write([WriteOp("touch", rel(10_000))]) > max_rev


def test_bulk_cols_codec_round_trip():
    cols = {
        "resource_type": ["pod", "pod", "ns"],
        "resource_id": np.asarray(["a", "b", "c"]),
        "relation": ["viewer"] * 3,
        "subject_type": ["user"] * 3,
        "subject_id": [b"x", "y", 7],
        "expiration": [None, 123.5, float("nan")],
    }
    out = decode_bulk_cols(encode_bulk_cols(cols))
    assert [str(x) for x in out["resource_id"]] == ["a", "b", "c"]
    assert [str(x) for x in out["subject_id"]] == ["x", "y", "7"]
    exp = out["expiration"]
    assert np.isnan(exp[0]) and exp[1] == 123.5 and np.isnan(exp[2])


# -- (a) test_snapshot.py's five, on the port ---------------------------------


def build():
    e = Engine(schema=SCHEMA, device="cpu")
    e.write_relationships([WriteOp("touch", parse_relationship(r)) for r in (
        "group:eng#member@user:alice",
        "ns:dev#viewer@group:eng#member",
        "ns:dev#viewer@user:bob",
        "ns:dev#banned@user:bob",
        "ns:prod#viewer@user:carol[expiration:2124-01-01T00:00:00Z]",
        "ns:tmp#viewer@user:dave",
    )])
    # a deleted row must not resurrect through a snapshot
    e.delete_relationships(RelationshipFilter(resource_id="tmp"))
    return e


def checks(e):
    return [e.check(CheckItem("ns", n, "view", "user", u))
            for n, u in (("dev", "alice"), ("dev", "bob"), ("prod", "carol"),
                         ("tmp", "dave"), ("dev", "nobody"))]


def test_snapshot_round_trip(tmp_path):
    e = build()
    want = checks(e)
    assert want == [True, False, True, False, False]
    path = str(tmp_path / "graph.npz")
    e.save_snapshot(path)
    e2 = Engine(schema=SCHEMA, device="cpu")
    e2.load_snapshot(path)
    assert e2.revision == e.revision
    assert checks(e2) == want
    orig = sorted(str(r) for r in e.read_relationships(RelationshipFilter()))
    back = sorted(str(r) for r in e2.read_relationships(RelationshipFilter()))
    assert back == orig


def test_snapshot_resumed_writes_and_interning(tmp_path):
    e = build()
    path = str(tmp_path / "graph.npz")
    e.save_snapshot(path)
    e2 = Engine(schema=SCHEMA, device="cpu")
    e2.load_snapshot(path)
    e2.write_relationships([WriteOp("touch", parse_relationship(
        "ns:dev#viewer@user:erin"))])
    assert e2.check(CheckItem("ns", "dev", "view", "user", "erin"))
    assert e2.check(CheckItem("ns", "dev", "view", "user", "alice"))
    e2.delete_relationships(RelationshipFilter(subject_id="alice"))
    assert not e2.check(CheckItem("ns", "dev", "view", "user", "alice"))


def test_snapshot_watch_relist_contract(tmp_path):
    e = build()
    rev = e.revision
    path = str(tmp_path / "graph.npz")
    e.save_snapshot(path)
    e2 = Engine(schema=SCHEMA, device="cpu")
    e2.load_snapshot(path)
    assert e2.watch_since(rev) == []
    with pytest.raises(StoreError, match="re-list"):
        e2.watch_since(rev - 2)


def test_snapshot_round_trip_with_closured_block(tmp_path, monkeypatch):
    """A closured self-pair block survives save/load: the restored engine
    re-closes at compile, an incremental delete takes the O(block)
    re-close path, and answers stay exact."""
    import spicedb_kubeapi_proxy_tpu_torch.ops.reachability as R

    monkeypatch.setattr(R, "DENSE_MIN_EDGES", 1)
    schema = parse_schema("""
definition user {}
definition group { relation member: user | group#member }
definition namespace {
  relation viewer: group#member
  permission view = viewer
}
""")
    e = Engine(schema=schema, device="cpu")
    e.write_relationships([WriteOp("touch", parse_relationship(r)) for r in (
        "group:leaf#member@user:alice",
        "group:mid#member@group:leaf#member",
        "group:root#member@group:mid#member",
        "namespace:ns#viewer@group:root#member",
    )])
    assert any(b.closured for b in e.compiled().blocks)
    path = str(tmp_path / "closured.npz")
    e.save_snapshot(path)
    e2 = Engine(schema=schema, device="cpu")
    e2.load_snapshot(path)
    assert any(b.closured for b in e2.compiled().blocks)
    item = CheckItem("namespace", "ns", "view", "user", "alice")
    assert e2.check(item)
    compiles = metrics.counter("engine_graph_compiles_total").value
    e2.write_relationships([WriteOp("delete", parse_relationship(
        "group:mid#member@group:leaf#member"))])
    assert not e2.check(item)
    assert metrics.counter("engine_graph_compiles_total").value == compiles
    e2.write_relationships([WriteOp("touch", parse_relationship(
        "group:mid#member@group:leaf#member"))])
    assert e2.check(item)


def test_snapshot_atomic_overwrite(tmp_path):
    e = build()
    path = str(tmp_path / "graph.npz")
    e.save_snapshot(path)
    e.write_relationships([WriteOp("touch", parse_relationship(
        "ns:dev#viewer@user:frank"))])
    e.save_snapshot(path)
    e2 = Engine(schema=SCHEMA, device="cpu")
    e2.load_snapshot(path)
    assert e2.check(CheckItem("ns", "dev", "view", "user", "frank"))


# -- (b) the formats, across the two packages ---------------------------------

NOW = time.time()
CONTEXTS = ({"ip": "10.1.2.3"}, {"ip": "192.168.1.1"}, None)


def _mesh_rows():
    """A small graph of bench.py's caveated mesh mix (chip_smoke's
    generator): caveated flat grants in two stored contexts, a group
    chain."""
    return build_rows(48, 16, 4, 8, 700, 2, cav_share=0.3)


def _mutations():
    """The same writes for both packages, as (op, fields): a caveated
    grant in a new context, an expiring grant, a re-touch, deletes."""
    return [
        ("touch", ("pod", "ns/p1", "viewer", "user", "u3", None, None,
                   "ip_allowlist", '{"allowed":["192.168.0.0/16"]}')),
        ("touch", ("pod", "ns/p2", "viewer", "user", "u4", None,
                   NOW + 3600, None, None)),
        ("touch", ("pod", "ns/p5", "viewer", "user", "u0", None, None,
                   None, None)),
        ("delete", ("pod", "ns/p5", "viewer", "user", "u0", None, None,
                    None, None)),
        ("touch", ("group", "g3", "member", "user", "u9", None, None,
                   None, None)),
    ]


def _drive_jax(store_or_engine):
    """Bulk-load and mutate a JAX store (or engine) in place."""
    s = getattr(store_or_engine, "store", store_or_engine)
    s.bulk_load(_mesh_rows())
    for op, f in _mutations():
        s.write([JWriteOp(op, JRelationship(*f))])
    s.delete_by_filter(JFilter(resource_type="pod", resource_id="ns/p7"))


def _drive_port(store_or_engine):
    s = getattr(store_or_engine, "store", store_or_engine)
    s.bulk_load(_mesh_rows())
    for op, f in _mutations():
        s.write([WriteOp(op, Relationship(*f))])
    s.delete_by_filter(RelationshipFilter(resource_type="pod",
                                          resource_id="ns/p7"))


def _state(s) -> dict:
    """Revision, live rows, interners and caveat instances of a store of
    either package."""
    f = (JFilter if isinstance(s, JStore) else RelationshipFilter)()
    return {
        "revision": s.revision,
        "rows": sorted(str(r) for r in s.read(f, now=0.0)),
        "types": s.types.strings(),
        "relations": s.relations.strings(),
        "objects": {t: it.strings() for t, it in s.objects.items()},
        "caveat_instances": [tuple(p) for p in s.caveat_instances],
        "len": len(s),
    }


def _answers_equal(je, te):
    """Masks and verdicts of a JAX and a port engine, byte for byte,
    under each request context (the caveated grants included)."""
    users = [f"u{i}" for i in range(16)]
    items = [(f"ns/p{i}", u) for i in range(48) for u in users[:6]]
    for ctx in CONTEXTS:
        for u in users:
            jm, _ = je.lookup_resources_mask("pod", "view", "user", u,
                                             now=NOW, context=ctx)
            tm, _ = te.lookup_resources_mask("pod", "view", "user", u,
                                             now=NOW, context=ctx)
            np.testing.assert_array_equal(np.asarray(jm), tm,
                                          err_msg=f"{u} {ctx}")
        jv = je.check_bulk([JCheckItem("pod", p, "view", "user", u)
                            for p, u in items], now=NOW, context=ctx)
        tv = te.check_bulk([CheckItem("pod", p, "view", "user", u)
                            for p, u in items], now=NOW, context=ctx)
        assert list(map(bool, jv)) == list(map(bool, tv)), ctx


@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
def test_snapshot_crosses_packages(tmp_path, direction):
    """A snapshot written by one package's store loads into the other's
    (npz keys and meta JSON alike), and the two engines then answer
    byte-equal on the caveated graph."""
    je = JEngine(schema=jparse_schema(MESH_SCHEMA))
    te = Engine(schema=parse_schema(MESH_SCHEMA), device="cpu")
    path = str(tmp_path / "snap.npz")
    if direction == "jax-to-port":
        _drive_jax(je)
        je.save_snapshot(path)
        with np.load(path) as z:
            assert sorted(z.files) == ["cav", "exp", "meta", "rid", "rl",
                                       "rt", "sid", "srl", "st"]
        te.load_snapshot(path)
    else:
        _drive_port(te)
        te.save_snapshot(path)
        je.load_snapshot(path)
    assert _state(te.store) == _state(je.store)
    assert len(te.store.caveat_instances) > 3  # the new context interned
    _answers_equal(je, te)
    # both restored stores go on writing at the same next revision
    rj = je.write_relationships([JWriteOp("touch", JRelationship(
        "pod", "ns/p9", "viewer", "user", "u1"))])
    rt = te.write_relationships([WriteOp("touch", Relationship(
        "pod", "ns/p9", "viewer", "user", "u1"))])
    assert rj == rt
    _answers_equal(je, te)


@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
@pytest.mark.parametrize("checkpoint", [False, True])
def test_wal_crosses_packages(tmp_path, direction, checkpoint):
    """A data dir journaled by one package's store (a bulk-load frame,
    write, delete and filter-delete records; with ``checkpoint`` a
    snapshot in the middle) recovers into the other's at the same
    revision and state, record for record."""
    d = str(tmp_path / "data")
    if direction == "jax-to-port":
        src, open_, drive, dst, rec = (JStore(), JPersistence.open,
                                       _drive_jax, Store(), recover)
    else:
        src, open_, drive, dst, rec = (Store(), Persistence.open,
                                       _drive_port, JStore(), jrecover)
    p = open_(src, d, wal_fsync="off", auto_checkpoint=False)
    drive(src)
    if checkpoint:
        p.checkpoint_now()
        more = (JWriteOp if isinstance(src, JStore) else WriteOp)(
            "touch", (JRelationship if isinstance(src, JStore)
                      else Relationship)("pod", "ns/p11", "viewer", "user",
                                         "u2"))
        src.write([more])
    p.wal.sync()
    kinds = [m["kind"] for m, _ in walmod.replay(os.path.join(d, "wal"))]
    if not checkpoint:
        assert kinds[0] == "bulk_load" and "delete" in kinds
    res = rec(dst, d)
    assert res.revision == src.revision
    assert res.replayed_records == (1 if checkpoint else len(kinds))
    assert _state(dst) == _state(src)
    p.close(final_checkpoint=False)


def test_recovered_engines_answer_alike(tmp_path):
    """A JAX engine and a port engine each recover the same JAX-written
    data dir (snapshot + tail) and answer byte-equal."""
    d = str(tmp_path / "data")
    src = JStore()
    p = JPersistence.open(src, d, wal_fsync="off", auto_checkpoint=False)
    _drive_jax(src)
    p.checkpoint_now()
    src.write([JWriteOp("delete", JRelationship(
        "group", "g3", "member", "user", "u9"))])
    p.close(final_checkpoint=False)
    je = JEngine(schema=jparse_schema(MESH_SCHEMA))
    te = Engine(schema=parse_schema(MESH_SCHEMA), device="cpu")
    je.enable_persistence(d, wal_fsync="off", auto_checkpoint=False)
    je.close_persistence(final_checkpoint=False)
    pt = te.enable_persistence(d, wal_fsync="off", auto_checkpoint=False)
    assert pt.recovery.replayed_records == 1
    assert te.revision == je.revision == src.revision
    _answers_equal(je, te)
    te.close_persistence(final_checkpoint=False)


# -- (c) a restore on a serving engine ------------------------------------------


def _lineage(e, users):
    """Write one small lineage: each user in ``users`` views ns:dev."""
    for u in users:
        e.write_relationships([WriteOp("touch", parse_relationship(
            f"ns:dev#viewer@user:{u}"))])


def test_restore_never_serves_the_old_lineage(tmp_path):
    """A restore landing on the revision number the cache already holds,
    with other rows: the cache is cleared (lists and checks dispatch
    again and see the restored rows), the batcher's window does not leak
    across, the old base's device state is released, and a watcher from
    before the restore must re-list."""
    a = Engine(schema=SCHEMA, device="cpu")
    _lineage(a, ["alice", "bob", "carol"])
    path = str(tmp_path / "a.npz")
    a.save_snapshot(path)

    b = Engine(schema=SCHEMA, device="cpu")
    b.enable_decision_cache()
    b.enable_lookup_batching(window=0.001)
    _lineage(b, ["dave", "erin", "frank"])
    assert b.revision == a.revision  # the same number, other rows
    rev = b.revision
    item = CheckItem("ns", "dev", "view", "user", "dave")
    assert b.lookup_resources("ns", "view", "user", "dave") == ["dev"]
    assert b.check_bulk([item]) == [True]
    assert b.lookup_resources("ns", "view", "user", "dave") == ["dev"]
    old = b.compiled()
    hits0 = metrics.counter("engine_decision_cache_hits_total",
                            kind="lookup").value

    b.load_snapshot(path)
    assert b.revision == rev
    assert old.resident.released and not old.resident.tensors
    with pytest.raises(RuntimeError, match="released"):
        old.query(np.zeros((1, 2), np.int32), np.zeros(1, np.int32),
                  np.zeros(1, np.int32))
    assert b.lookup_resources("ns", "view", "user", "dave") == []
    assert b.lookup_resources("ns", "view", "user", "alice") == ["dev"]
    assert b.check_bulk([item]) == [False]
    assert b.try_cached_check([item]) == [False]  # refilled, new lineage
    assert metrics.counter("engine_decision_cache_hits_total",
                           kind="lookup").value == hits0
    with pytest.raises(StoreError, match="re-list"):
        b.watch_since(rev - 1)
    # the restored engine goes on writing, folding incrementally
    b.write_relationships([WriteOp("touch", parse_relationship(
        "ns:dev#banned@user:alice"))])
    assert b.lookup_resources("ns", "view", "user", "alice") == []
    b.disable_lookup_batching()
    b.disable_decision_cache()


@pytest.mark.parametrize("call", ["list", "bulk"])
def test_restore_between_build_and_dispatch(tmp_path, call):
    """A list or bulk check whose device state a restore releases after
    the call built it but before the call holds the shared side: the call
    raises the restore error (never a lookup in the emptied state), and
    the next one answers from the restored rows."""
    a = Engine(schema=SCHEMA, device="cpu")
    _lineage(a, ["alice"])
    path = str(tmp_path / "a.npz")
    a.save_snapshot(path)
    b = Engine(schema=SCHEMA, device="cpu")
    _lineage(b, ["dave"])
    item = CheckItem("ns", "dev", "view", "user", "dave")
    assert b.check_bulk([item]) == [True]
    cg = b.compiled()
    build = cg._dev

    def build_then_restore():
        d = build()
        del cg._dev  # once
        b.load_snapshot(path)
        return d

    cg._dev = build_then_restore
    with pytest.raises(RuntimeError, match="released by a store restore"):
        if call == "list":
            b.lookup_resources_mask("ns", "view", "user", "dave")
        else:
            b.check_bulk([item])
    assert b.check_bulk([item]) == [False]
    assert b.lookup_resources("ns", "view", "user", "alice") == ["dev"]


def test_lists_beside_restores(tmp_path):
    """Lists on threads of their own while the engine restores snapshots
    under them: a list either answers from one lineage whole or raises
    the restore error, and after the last restore answers from it."""
    import threading

    a = Engine(schema=SCHEMA, device="cpu")
    _lineage(a, ["alice", "bob"])
    path = str(tmp_path / "a.npz")
    a.save_snapshot(path)
    b = Engine(schema=SCHEMA, device="cpu")
    _lineage(b, ["alice", "carol"])
    lineages = ({"alice": ["dev"], "bob": ["dev"], "carol": []},
                {"alice": ["dev"], "bob": [], "carol": ["dev"]})
    errors, stop = [], threading.Event()
    answered = [0]

    def lister(k):
        users = ("alice", "bob", "carol")
        try:
            while not stop.is_set():
                u = users[k % 3]
                k += 1
                try:
                    got = b.lookup_resources("ns", "view", "user", u)
                except RuntimeError as exc:
                    if "released by a store restore" not in str(exc):
                        raise
                    continue
                assert any(got == ln[u] for ln in lineages), (u, got)
                answered[0] += 1
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(exc)

    threads = [threading.Thread(target=lister, args=(k,)) for k in range(3)]
    for t in threads:
        t.start()
    for _ in range(10):
        b.load_snapshot(path)
        time.sleep(0.005)
    stop.set()
    for t in threads:
        t.join()
    assert not errors, errors[0]
    assert answered[0] > 0
    assert b.lookup_resources("ns", "view", "user", "bob") == ["dev"]


def test_persistence_on_an_empty_dir_keeps_the_compiled_graph(tmp_path):
    """Enabling persistence on an empty data dir restores nothing, so the
    published graph stays (the path that makes a loaded engine durable:
    load, enable, checkpoint); a recovery that restores resets it."""
    e = Engine(schema=SCHEMA, device="cpu")
    _lineage(e, ["alice"])
    cg = e.compiled()
    p = e.enable_persistence(str(tmp_path / "d"), wal_fsync="off",
                             auto_checkpoint=False)
    assert p.recovery.snapshot_path is None
    assert e.compiled() is cg
    assert p.checkpoint_now() == e.revision
    e.close_persistence(final_checkpoint=False)
    e2 = Engine(schema=SCHEMA, device="cpu")
    _lineage(e2, ["zed"])
    cg2 = e2.compiled()
    e2.enable_persistence(str(tmp_path / "d"), wal_fsync="off",
                          auto_checkpoint=False)
    assert e2.compiled() is not cg2 and cg2.resident.released
    assert e2.lookup_resources("ns", "view", "user", "alice") == ["dev"]
    assert e2.lookup_resources("ns", "view", "user", "zed") == []
    e2.close_persistence(final_checkpoint=False)


def test_failed_recovery_still_resets_the_views(tmp_path):
    """A recovery that loads a snapshot and then fails closed on a
    corrupt sealed WAL segment has already replaced the store: the
    engine must not go on serving the graph compiled before it."""
    d = str(tmp_path / "data")
    s = Store()
    p = Persistence.open(s, d, wal_fsync="off", segment_bytes=64,
                         auto_checkpoint=False)
    s.write([WriteOp("touch", parse_relationship("ns:dev#viewer@user:ann"))])
    p.checkpoint_now()
    for i in range(6):
        s.write([WriteOp("touch", rel(i))])
    p.close(final_checkpoint=False)
    segs = walmod.list_segments(os.path.join(d, "wal"))
    with open(segs[-2][1], "r+b") as f:  # a sealed, non-final segment
        f.seek(len(walmod.MAGIC) + 2)
        b = f.read(1)
        f.seek(len(walmod.MAGIC) + 2)
        f.write(bytes([b[0] ^ 0xFF]))
    e = Engine(schema=SCHEMA, device="cpu")
    _lineage(e, ["zed"])
    cg = e.compiled()
    with pytest.raises(RecoveryError, match="mid-history"):
        e.enable_persistence(d, wal_fsync="off", auto_checkpoint=False)
    assert e.persistence is None and cg.resident.released
    assert e.lookup_resources("ns", "view", "user", "ann") == ["dev"]
    assert e.lookup_resources("ns", "view", "user", "zed") == []
