"""PyTorch port, the engine host's transport and CLI on the CPU.

TLS on the ``tcp://`` engine wire with a real self-signed CA (the JAX
package's test_engine_tls.py, on a port host): JSON and binary frames,
pooled socket reuse, a plaintext client refused, a wrong CA, skip-verify,
mutual TLS, the push watch; the JAX client over TLS to a port host; the
tlsconf errors. The CLI (``python -m
spicedb_kubeapi_proxy_tpu_torch.engine.remote``): serving TLS, refusing
plaintext without the opt-out, half TLS, the data-dir flags
(test_persistence.py's CLI test), the flags it refuses until their
ROADMAP items land, a data dir's migration record resolved at boot (an
abort before the cut, the cut finished after it), ``--device`` (cuda unless asked, never a
silent fallback), and a boot with ``--device cpu --data-dir`` that
recovers a store the JAX engine wrote, answers a JAX client as the JAX
engine does, and checkpoints on SIGTERM into a dir the JAX engine reads
back. Every CLI subprocess passes ``--device cpu``.
"""

import datetime
import ipaddress
import os
import signal
import socket
import ssl
import subprocess
import sys
import threading
import time

import pytest
import torch

from cryptography import x509
from cryptography.hazmat.primitives import hashes, serialization
from cryptography.hazmat.primitives.asymmetric import ec
from cryptography.x509.oid import NameOID

from spicedb_kubeapi_proxy_tpu.engine import CheckItem as JCheckItem
from spicedb_kubeapi_proxy_tpu.engine import Engine as JEngine
from spicedb_kubeapi_proxy_tpu.engine import WriteOp as JWriteOp
from spicedb_kubeapi_proxy_tpu.engine import remote as jremote
from spicedb_kubeapi_proxy_tpu.engine.store import \
    RelationshipFilter as JRelationshipFilter
from spicedb_kubeapi_proxy_tpu.models.tuples import \
    parse_relationship as jparse_rel
from spicedb_kubeapi_proxy_tpu_torch.engine import CheckItem, Engine, WriteOp
from spicedb_kubeapi_proxy_tpu_torch.engine import remote
from spicedb_kubeapi_proxy_tpu_torch.models.tuples import parse_relationship
from spicedb_kubeapi_proxy_tpu_torch.utils.tlsconf import (
    TLSConfigError,
    client_ssl_context,
    server_ssl_context,
)

from torch_parity import serving

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _key():
    return ec.generate_private_key(ec.SECP256R1())


def _name(cn):
    return x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, cn)])


def _cert(subject, issuer, pub, signer, *, ca=False, san=None):
    now = datetime.datetime.now(datetime.timezone.utc)
    b = (x509.CertificateBuilder()
         .subject_name(subject)
         .issuer_name(issuer)
         .public_key(pub)
         .serial_number(x509.random_serial_number())
         .not_valid_before(now - datetime.timedelta(minutes=5))
         .not_valid_after(now + datetime.timedelta(days=1))
         .add_extension(x509.BasicConstraints(ca=ca, path_length=None),
                        critical=True))
    if san:
        b = b.add_extension(x509.SubjectAlternativeName(san), critical=False)
    return b.sign(signer, hashes.SHA256())


@pytest.fixture(scope="module")
def pki(tmp_path_factory):
    """CA + engine-host server cert + a client cert, and a SECOND
    independent CA for negative tests."""
    d = tmp_path_factory.mktemp("engine-pki")

    def write(path, *objs):
        data = b"".join(
            o.private_bytes(serialization.Encoding.PEM,
                            serialization.PrivateFormat.PKCS8,
                            serialization.NoEncryption())
            if hasattr(o, "private_bytes")
            else o.public_bytes(serialization.Encoding.PEM)
            for o in objs)
        p = d / path
        p.write_bytes(data)
        return str(p)

    files = {}
    for prefix in ("ca", "otherca"):
        ca_key = _key()
        ca_name = _name(f"engine-{prefix}")
        ca_cert = _cert(ca_name, ca_name, ca_key.public_key(), ca_key,
                        ca=True)
        files[prefix] = write(f"{prefix}.pem", ca_cert)
        srv_key = _key()
        srv_cert = _cert(
            _name("engine-host"), ca_name, srv_key.public_key(), ca_key,
            san=[x509.DNSName("localhost"),
                 x509.IPAddress(ipaddress.ip_address("127.0.0.1"))])
        files[f"{prefix}_server_cert"] = write(f"{prefix}-server.pem",
                                               srv_cert)
        files[f"{prefix}_server_key"] = write(f"{prefix}-server-key.pem",
                                              srv_key)
        cl_key = _key()
        cl_cert = _cert(_name("proxy-client"), ca_name,
                        cl_key.public_key(), ca_key)
        files[f"{prefix}_client"] = write(f"{prefix}-client.pem",
                                          cl_cert, cl_key)
    return files


def _seed_engine() -> Engine:
    e = Engine(device="cpu")
    e.write_relationships([
        WriteOp("touch", parse_relationship(
            f"namespace:n{i}#creator@user:u{i % 3}"))
        for i in range(10)
    ])
    return e


def _tls_host(engine, pki, client_ca=None, token="tls-tok"):
    return serving(remote.EngineServer, engine, token=token,
                   ssl_context=server_ssl_context(
                       pki["ca_server_cert"], pki["ca_server_key"],
                       client_ca_file=client_ca))


def _tls_client(port, pki, **kw):
    kw.setdefault("ssl_context", client_ssl_context(ca_file=pki["ca"]))
    return remote.RemoteEngine("127.0.0.1", port, token="tls-tok",
                               server_hostname="localhost", **kw)


# ---------------------------------------------------------------------------
# TLS on the wire (test_engine_tls.py on a port host)
# ---------------------------------------------------------------------------


def test_tls_request_path_json_and_binary_frames(pki):
    """check_bulk (JSON frames) and lookup_resources (binary mask frame +
    id sync) over TLS with CA verification, from both packages' clients."""
    e = _seed_engine()
    with _tls_host(e, pki) as s:
        c = _tls_client(s.port, pki)
        jc = jremote.RemoteEngine(
            "127.0.0.1", s.port, token="tls-tok",
            ssl_context=client_ssl_context(ca_file=pki["ca"]),
            server_hostname="localhost")
        try:
            assert c.check_bulk([
                CheckItem("namespace", "n1", "view", "user", "u1"),
                CheckItem("namespace", "n1", "view", "user", "u2"),
            ]) == [True, False]
            assert sorted(c.lookup_resources("namespace", "view", "user",
                                             "u0")) == ["n0", "n3", "n6",
                                                        "n9"]
            c.write_relationships([WriteOp("touch", parse_relationship(
                "namespace:fresh#creator@user:u1"))])
            assert c.check_bulk([CheckItem(
                "namespace", "fresh", "view", "user", "u1")]) == [True]
            assert jc.check_bulk([JCheckItem(
                "namespace", "fresh", "view", "user", "u1")]) == [True]
            assert sorted(jc.lookup_resources(
                "namespace", "view", "user", "u1")) == ["fresh", "n1",
                                                        "n4", "n7"]
        finally:
            c.close()
            jc.close()


def test_tls_pooled_sockets_are_reused(pki):
    e = _seed_engine()
    with _tls_host(e, pki) as s:
        c = _tls_client(s.port, pki)
        try:
            for _ in range(3):
                c.check_bulk([CheckItem("namespace", "n1", "view", "user",
                                        "u1")])
            with c._pool_lock:
                pooled = list(c._pool)
            assert len(pooled) == 1  # sequential calls rode ONE socket
            c.check_bulk([CheckItem("namespace", "n1", "view", "user",
                                    "u1")])
            with c._pool_lock:
                assert c._pool and c._pool[0] is pooled[0]
        finally:
            c.close()


def test_plaintext_client_rejected_by_tls_server(pki):
    e = _seed_engine()
    with _tls_host(e, pki) as s:
        c = remote.RemoteEngine("127.0.0.1", s.port, token="tls-tok")
        try:
            with pytest.raises(Exception):
                c.check_bulk([CheckItem("namespace", "n1", "view", "user",
                                        "u1")])
        finally:
            c.close()


def test_wrong_ca_rejected(pki):
    e = _seed_engine()
    with _tls_host(e, pki) as s:
        c = _tls_client(s.port, pki, ssl_context=client_ssl_context(
            ca_file=pki["otherca"]))
        try:
            with pytest.raises(ssl.SSLError):
                c.check_bulk([CheckItem("namespace", "n1", "view", "user",
                                        "u1")])
        finally:
            c.close()


def test_skip_verify_ca_still_encrypts(pki):
    e = _seed_engine()
    with _tls_host(e, pki) as s:
        c = _tls_client(s.port, pki, ssl_context=client_ssl_context(
            skip_verify=True))
        try:
            assert c.check_bulk([CheckItem(
                "namespace", "n1", "view", "user", "u1")]) == [True]
        finally:
            c.close()


def test_mutual_tls_requires_client_cert(pki):
    e = _seed_engine()
    with _tls_host(e, pki, client_ca=pki["ca"]) as s:
        bare = _tls_client(s.port, pki)
        try:
            # TLS 1.3 reports the missing client cert after the client's
            # handshake: an SSLError or a reset on first read (OSError)
            with pytest.raises(OSError):
                bare.check_bulk([CheckItem("namespace", "n1", "view",
                                           "user", "u1")])
        finally:
            bare.close()
        withcert = _tls_client(s.port, pki, ssl_context=client_ssl_context(
            ca_file=pki["ca"], client_cert_file=pki["ca_client"]))
        try:
            assert withcert.check_bulk([CheckItem(
                "namespace", "n1", "view", "user", "u1")]) == [True]
        finally:
            withcert.close()


def test_push_watch_stream_over_tls(pki):
    e = _seed_engine()
    with _tls_host(e, pki) as s:
        c = _tls_client(s.port, pki)
        try:
            stream = c.watch_push_stream(c.revision)
            try:
                t = threading.Thread(
                    target=lambda: e.write_relationships(
                        [WriteOp("touch", parse_relationship(
                            "namespace:pushed#viewer@user:u9"))]),
                    daemon=True)
                t.start()
                got = []
                deadline = time.monotonic() + 30
                while not got:
                    assert time.monotonic() < deadline
                    got = stream.next_batch()  # [] = heartbeat
                assert any(ev.relationship.resource_id == "pushed"
                           for ev in got)
                t.join(5)
            finally:
                stream.close()
        finally:
            c.close()


def test_tlsconf_error_surfaces(tmp_path):
    with pytest.raises(TLSConfigError):
        server_ssl_context(str(tmp_path / "no.pem"),
                           str(tmp_path / "no-key.pem"))
    with pytest.raises(TLSConfigError):
        client_ssl_context(ca_file=str(tmp_path / "no-ca.pem"))


def test_ca_file_pins_trust_to_that_bundle(pki):
    pinned = client_ssl_context(ca_file=pki["ca"])
    assert pinned.cert_store_stats()["x509_ca"] == 1
    system = client_ssl_context()
    assert system.cert_store_stats() != pinned.cert_store_stats() \
        or system.cert_store_stats()["x509_ca"] <= 1  # bare image


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawn(args: list) -> subprocess.Popen:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.Popen(
        [sys.executable, "-m", "spicedb_kubeapi_proxy_tpu_torch.engine.remote",
         "--device", "cpu", *args],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def _wait_bound(p: subprocess.Popen, port: int, seconds: float = 90):
    deadline = time.monotonic() + seconds
    while True:
        try:
            socket.create_connection(("127.0.0.1", port), timeout=1).close()
            return
        except OSError:
            assert p.poll() is None, p.communicate()[0][-3000:]
            assert time.monotonic() < deadline, "host never bound"
            time.sleep(0.2)


def _stop(p: subprocess.Popen) -> tuple:
    """SIGTERM, then (exit code, output)."""
    p.send_signal(signal.SIGTERM)
    try:
        out = p.communicate(timeout=60)[0]
    except subprocess.TimeoutExpired:
        p.kill()
        out = p.communicate()[0]
        raise AssertionError("host ignored SIGTERM:\n" + out[-3000:])
    return p.returncode, out


def test_engine_host_cli_serves_tls(pki, tmp_path):
    """The CLI wires its TLS context into the server (a TLS client with
    the CA completes a request)."""
    boot = tmp_path / "boot.yaml"
    boot.write_text("schema: |\n  definition user {}\n")
    port = _free_port()
    p = _spawn(["--bootstrap", str(boot), "--bind-port", str(port),
                "--token", "cli-tok",
                "--tls-cert-file", pki["ca_server_cert"],
                "--tls-key-file", pki["ca_server_key"]])
    try:
        _wait_bound(p, port)
        c = remote.RemoteEngine(
            "127.0.0.1", port, token="cli-tok",
            ssl_context=client_ssl_context(ca_file=pki["ca"]),
            server_hostname="localhost")
        try:
            assert isinstance(c.revision, int)
        finally:
            c.close()
    finally:
        rc, out = _stop(p)
    assert rc == 0, out[-3000:]


def test_engine_host_cli_refuses_plaintext_without_opt_out():
    with pytest.raises(SystemExit) as exc:
        remote.main(["--bind-port", "0"])
    assert exc.value.code == 2  # argparse error, not a crash


def test_engine_host_cli_rejects_half_tls_and_conflicts(pki):
    with pytest.raises(SystemExit):
        remote.main(["--tls-cert-file", pki["ca_server_cert"]])  # no key
    with pytest.raises(SystemExit):
        remote.main(["--engine-insecure",
                     "--tls-cert-file", pki["ca_server_cert"],
                     "--tls-key-file", pki["ca_server_key"]])


def test_engine_host_cli_data_dir_flags():
    """test_persistence.py's CLI test on the port: --data-dir with
    --snapshot-path, and a bad fsync spec, are argparse errors."""
    with pytest.raises(SystemExit):
        remote.main(["--engine-insecure", "--data-dir", "/tmp/x",
                     "--snapshot-path", "/tmp/y.npz"])
    with pytest.raises(SystemExit):
        remote.main(["--engine-insecure", "--data-dir", "/tmp/x",
                     "--wal-fsync", "never"])


@pytest.mark.parametrize("flag,value,item", [
    (f, v, i) for f, v, i in (
        # the --peers failover flags are served (test_torch_mirror.py)
        ("--engine-mesh", "auto", "A.5"),
        ("--distributed", "127.0.0.1:1,2,0", "A.5"),
        ("--mirror-leader", "127.0.0.1:1", "A.5"),
        # served: the host boots with it and answers chaos_status
        ("--enable-chaos-ops", None, None))])
def test_engine_host_cli_refuses_unported_flags(capsys, tmp_path, flag,
                                                value, item):
    argv = ["--engine-insecure", "--device", "cpu", flag]
    if value is not None:
        argv.append(value)
    if item is None:
        _serve_chaos_status(tmp_path, argv)
        return
    with pytest.raises(SystemExit) as exc:
        remote.main(argv)
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert flag in err and f"ROADMAP {item}" in err


def _serve_chaos_status(tmp_path, argv):
    """Boot the port's host CLI with ``argv`` in a subprocess and read its
    ``chaos_status`` over the wire: nothing armed, an empty history."""
    import socket
    import subprocess

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    logf = open(tmp_path / "host.log", "wb")
    proc = subprocess.Popen(
        [sys.executable, "-m", "spicedb_kubeapi_proxy_tpu_torch.engine.remote",
         *argv, "--bind-port", str(port)],
        stdout=logf, stderr=subprocess.STDOUT, cwd=REPO)
    logf.close()
    try:
        deadline = time.monotonic() + 60
        while True:
            c = remote.RemoteEngine("127.0.0.1", port, retries=0,
                                    timeout=2.0, connect_timeout=1.0)
            try:
                st = c.chaos_status()
                break
            except Exception:
                assert proc.poll() is None, \
                    (tmp_path / "host.log").read_text()
                assert time.monotonic() < deadline, "host never answered"
                time.sleep(0.2)
            finally:
                c.close()
        assert st["sites"] == [] and st["history"] == []
        assert st["history_digest"]
    finally:
        proc.terminate()
        proc.wait(timeout=30)


def test_engine_host_cli_refuses_a_migrating_data_dir(tmp_path):
    """The CLI used to refuse a data dir holding a migration record; it
    now resolves it at boot as the JAX host does: a record from before the
    cut (here the dual window) aborts, and the host serves the booted
    schema."""
    d = tmp_path / "data"
    d.mkdir()
    (d / "migration.json").write_text(
        '{"phase": "dual", "suppressed_revisions": [3]}')
    port = _free_port()
    proc = _spawn(["--engine-insecure", "--bind-port", str(port),
                   "--data-dir", str(d)])
    try:
        _wait_bound(proc, port)
        jc = jremote.RemoteEngine("127.0.0.1", port)
        try:
            assert jc.migrate_status() is None
            assert jc.revision == 0
        finally:
            jc.close()
        assert not (d / "migration.json").exists()
    finally:
        rc, out = _stop(proc)
    assert rc == 0, out[-3000:]
    assert "schema migration record recovered: aborted (phase dual)" in out


def test_engine_host_cli_resumes_a_cut_migration_record(tmp_path):
    """A data dir the JAX engine journaled, holding a migration record
    persisted at its cut: the port's CLI boots with the old schema,
    finishes the cut (log ``resumed (phase cut)``), answers under the new
    schema, marks the record done, and exits 0 on SIGTERM."""
    import json

    from spicedb_kubeapi_proxy_tpu_torch.models.bootstrap import (
        DEFAULT_BOOTSTRAP,
        parse_bootstrap,
    )

    old = parse_bootstrap(DEFAULT_BOOTSTRAP).schema_text
    target = old.replace("  permission no_one_at_all = nil\n",
                         "  permission no_one_at_all = nil\n"
                         "  permission audit = viewer\n")
    assert target != old
    d = tmp_path / "data"
    je = JEngine()
    je.enable_persistence(str(d), wal_fsync="always")
    je.write_relationships([JWriteOp("touch", jparse_rel(r)) for r in (
        "namespace:n1#viewer@user:u1", "namespace:n2#creator@user:u2")])
    je.close_persistence(final_checkpoint=False)
    (d / "migration.json").write_text(json.dumps(
        {"phase": "cut", "to_text": target, "to_digest": "t",
         "suppressed_revisions": []}))
    port = _free_port()
    proc = _spawn(["--engine-insecure", "--bind-port", str(port),
                   "--data-dir", str(d)])
    try:
        _wait_bound(proc, port)
        jc = jremote.RemoteEngine("127.0.0.1", port)
        try:
            assert jc.check(JCheckItem("namespace", "n1", "audit", "user",
                                       "u1")) is True
            assert jc.check(JCheckItem("namespace", "n2", "audit", "user",
                                       "u2")) is False
            assert jc.check(JCheckItem("namespace", "n2", "view", "user",
                                       "u2")) is True
        finally:
            jc.close()
        assert json.loads((d / "migration.json").read_text())[
            "phase"] == "done"
    finally:
        rc, out = _stop(proc)
    assert rc == 0, out[-3000:]
    assert "schema migration record recovered: resumed (phase cut)" in out


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="the missing-card refusal needs a box without "
                           "CUDA")
def test_engine_host_cli_needs_a_card_unless_told_cpu(capsys):
    """No --device: cuda, and with no card the CLI exits non-zero with
    resolve_device's error instead of serving from the CPU."""
    with pytest.raises(SystemExit) as exc:
        remote.main(["--engine-insecure", "--bind-port", "0"])
    assert exc.value.code == 2
    assert "torch.cuda.is_available() is False" in capsys.readouterr().err


def test_engine_host_cli_recovers_a_jax_written_data_dir(tmp_path):
    """The JAX engine journals a store (a checkpoint, then a WAL tail);
    the port's CLI boots on that dir with --device cpu, answers a JAX
    client as the JAX engine does, takes a write, and on SIGTERM exits 0
    after its final checkpoint, which the JAX engine then recovers."""
    d = str(tmp_path / "data")
    je = JEngine()
    p = je.enable_persistence(d, wal_fsync="always")
    je.write_relationships([JWriteOp("touch", jparse_rel(
        f"namespace:n{i}#creator@user:u{i % 4}")) for i in range(12)])
    p.checkpoint_now()
    je.write_relationships([JWriteOp("touch", jparse_rel(r)) for r in (
        "pod:n1/a#namespace@namespace:n1", "pod:n1/b#viewer@user:u3",
        "namespace:n2#viewer@user:u0")])
    je.delete_relationships(JRelationshipFilter(
        resource_type="namespace", resource_id="n5"))
    users = [f"u{i}" for i in range(4)] + ["nobody"]
    want = {(rt, u): sorted(je.lookup_resources(rt, "view", "user", u))
            for rt in ("namespace", "pod") for u in users}
    items = [JCheckItem("namespace", f"n{i}", "view", "user", u)
             for i in range(12) for u in users]
    want_checks = je.check_bulk(items)
    rev = je.revision
    je.close_persistence(final_checkpoint=False)

    port = _free_port()
    proc = _spawn(["--engine-insecure", "--bind-port", str(port),
                   "--data-dir", d])
    try:
        _wait_bound(proc, port)
        jc = jremote.RemoteEngine("127.0.0.1", port)
        try:
            assert jc.revision == rev
            for (rt, u), ids in want.items():
                assert sorted(jc.lookup_resources(rt, "view", "user",
                                                  u)) == ids, (rt, u)
            assert jc.check_bulk(items) == want_checks
            jc.write_relationships([JWriteOp("touch", jparse_rel(
                "namespace:n5#viewer@user:u1"))])
        finally:
            jc.close()
    finally:
        rc, out = _stop(proc)
    assert rc == 0, out[-3000:]
    assert "persistence closed" in out
    back = JEngine()
    res = back.enable_persistence(d).recovery
    try:
        assert res.replayed_records == 0  # the port's final checkpoint
        assert back.revision == rev + 1
        assert back.check(JCheckItem("namespace", "n5", "view", "user",
                                     "u1"))
    finally:
        back.close_persistence(final_checkpoint=False)
