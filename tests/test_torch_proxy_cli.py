"""The port's proxy CLI: ``python -m spicedb_kubeapi_proxy_tpu_torch.proxy.cli``.

``--device cpu`` boots and serves the repo's rules over a port
``InMemoryKube`` reached by ``--upstream-url``; SIGTERM ends it with exit
0. Without ``--device`` the engine asks for ``cuda``: on a machine with no
card that is exit 2 with ``resolve_device``'s error, never a quiet CPU
fallback. Every flag whose half of the system the port lacks (only
``--engine-mesh`` now: the ``--oidc-*`` flags are served and held in
test_torch_oidc.py) is refused with the ROADMAP item that brings it, from
the CLI and from ``Options``.
The scale-out flags are accepted (``--device`` beside ``--shard-map`` is
refused), and a sharded port proxy lists byte for byte like the JAX proxy
over the same engine hosts.
"""

from __future__ import annotations

import asyncio
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request

import pytest
import torch

from spicedb_kubeapi_proxy_tpu_torch.proxy import cli
from spicedb_kubeapi_proxy_tpu_torch.proxy.inmemkube import InMemoryKube
from spicedb_kubeapi_proxy_tpu_torch.proxy.options import (
    _REFUSED,
    Options,
    OptionsError,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RULES = os.path.join(REPO, "deploy", "rules.yaml")
BOOTSTRAP = os.path.join(REPO, "deploy", "bootstrap.yaml")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def serve_upstream(kube):
    """Serve ``kube`` over loopback HTTP on a loop thread of its own;
    returns (port, stop)."""
    from spicedb_kubeapi_proxy_tpu_torch.proxy.server import (
        _read_request,
        _write_response,
    )

    loop = asyncio.new_event_loop()
    th = threading.Thread(target=loop.run_forever, daemon=True)
    th.start()

    async def conn(reader, writer):
        try:
            while True:
                req = await _read_request(reader)
                if req is None:
                    return
                await _write_response(writer, await kube(req))
        except (asyncio.IncompleteReadError, ConnectionResetError):
            pass
        finally:
            writer.close()

    server = asyncio.run_coroutine_threadsafe(
        asyncio.start_server(conn, "127.0.0.1", 0), loop).result(10)

    def stop():
        server.close()
        loop.call_soon_threadsafe(loop.stop)
        th.join(10)

    return server.sockets[0].getsockname()[1], stop


def _call(port, method, path, user, body=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", method=method,
        data=json.dumps(body).encode() if body is not None else None,
        headers={"X-Remote-User": user, "Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _env():
    return {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}


def test_cli_serves_on_the_cpu_and_exits_on_sigterm(tmp_path):
    up_port, stop_up = serve_upstream(InMemoryKube())
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "spicedb_kubeapi_proxy_tpu_torch.proxy.cli",
         "--device", "cpu", "--rule-file", RULES, "--bootstrap", BOOTSTRAP,
         "--upstream-url", f"http://127.0.0.1:{up_port}",
         "--bind-port", str(port),
         "--workflow-database-path", str(tmp_path / "dtx.sqlite")],
        cwd=REPO, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + 60
        while True:
            try:
                socket.create_connection(("127.0.0.1", port), 1).close()
                break
            except OSError:
                assert proc.poll() is None, proc.communicate()[1]
                assert time.monotonic() < deadline
                time.sleep(0.2)
        st, doc = _call(port, "POST", "/api/v1/namespaces", "alice",
                        {"apiVersion": "v1", "kind": "Namespace",
                         "metadata": {"name": "cli-ns"}})
        assert st == 201, doc
        st, doc = _call(port, "GET", "/api/v1/namespaces", "alice")
        assert st == 200
        assert [i["metadata"]["name"] for i in doc["items"]] == ["cli-ns"]
        st, doc = _call(port, "GET", "/api/v1/namespaces", "mallory")
        assert (st, doc["items"]) == (200, [])
        st, _ = _call(port, "GET", "/api/v1/namespaces/cli-ns", "mallory")
        assert st == 403
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=60)
        assert proc.returncode == 0, err
        assert "engine on cpu" in err
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
        stop_up()


def test_cli_without_device_refuses_to_run_on_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: no --device means cuda there")
    proc = subprocess.run(
        [sys.executable, "-m", "spicedb_kubeapi_proxy_tpu_torch.proxy.cli",
         "--rule-file", RULES, "--upstream-url", "http://127.0.0.1:1",
         "--workflow-database-path", str(tmp_path / "dtx.sqlite")],
        cwd=REPO, env=_env(), capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2
    assert "CUDA device requested but torch.cuda.is_available() is " \
        "False" in proc.stderr
    with pytest.raises(OptionsError, match="CUDA device requested"):
        Options(rule_files=[RULES], upstream=InMemoryKube()).complete()


def _value(name, default):
    if isinstance(default, bool):
        return True
    if isinstance(default, list):
        return ["k=v"]
    if isinstance(default, (int, float)):
        return default + 1
    return "x"


@pytest.mark.parametrize("name,default,flag,item,what", _REFUSED,
                         ids=[r[2] for r in _REFUSED])
def test_refused_flag_names_its_roadmap_item(capsys, tmp_path, name,
                                             default, flag, item, what):
    with pytest.raises(SystemExit) as ex:
        cli.main(["--device", "cpu", "--rule-file", RULES,
                  "--upstream-url", "http://127.0.0.1:1", flag, "x"])
    assert ex.value.code == 2
    err = capsys.readouterr().err
    assert f"{flag} is not supported" in err
    assert f"ROADMAP {item}" in err
    with pytest.raises(OptionsError, match=f"ROADMAP {item}"):
        Options(rule_files=[RULES], upstream=InMemoryKube(), device="cpu",
                **{name: _value(name, default)}).validate()


def test_device_is_for_in_process_engines():
    with pytest.raises(OptionsError, match="device applies to in-process"):
        Options(rule_files=[RULES], upstream=InMemoryKube(), device="cpu",
                engine_endpoint="tcp://127.0.0.1:1",
                engine_insecure=True).validate()
    with pytest.raises(OptionsError, match="unsupported device"):
        Options(rule_files=[RULES], upstream=InMemoryKube(),
                device="meta").validate()


# -- scale-out flags (scaleout/, autoscale/) ---------------------------------

_GROUPS = '{"version": 1, "groups": [["127.0.0.1:1"], ["127.0.0.1:2"]]}'
_SCALEOUT_FLAGS = (
    ("--shard-map", [_GROUPS]),
    ("--shard-journal-path", ["/tmp/sj.sqlite"]),
    ("--shard-cache", []),
    ("--rebalance-to", ['{"version": 2, "groups": [["127.0.0.1:1"], '
                        '["127.0.0.1:2"], ["127.0.0.1:3"]]}']),
    ("--autoscale", ["dry-run"]),
    ("--autoscale-policy", ["max_groups=3,hysteresis_ticks=2"]),
    ("--autoscale-tick-seconds", ["5"]),
    ("--frontier-exchange", []),
    ("--frontier-max-rounds", ["4"]),
)


@pytest.mark.parametrize("flag,args", _SCALEOUT_FLAGS,
                         ids=[f for f, _ in _SCALEOUT_FLAGS])
def test_scaleout_flag_is_accepted(flag, args):
    import argparse

    from spicedb_kubeapi_proxy_tpu_torch.proxy.options import (
        add_flags,
        options_from_args,
    )

    parser = argparse.ArgumentParser()
    add_flags(parser)
    argv = ["--rule-file", RULES, "--upstream-url", "http://127.0.0.1:1",
            flag, *args]
    if flag != "--shard-map":
        argv += ["--shard-map", _GROUPS]
    opts = options_from_args(parser.parse_args(argv))
    assert opts.shard_map == _GROUPS and opts.device is None
    dest = flag[2:].replace("-", "_")
    assert getattr(opts, dest) not in (None, False, "off")
    opts.validate()  # no card needed: each group's host owns its device


def test_device_is_refused_beside_a_shard_map(capsys):
    with pytest.raises(SystemExit) as ex:
        cli.main(["--device", "cpu", "--rule-file", RULES,
                  "--upstream-url", "http://127.0.0.1:1",
                  "--shard-map", _GROUPS])
    assert ex.value.code == 2
    assert "each engine group owns its own" in capsys.readouterr().err


def test_mesh_and_oidc_flags_still_name_their_items():
    # OIDC (A.6) is served now; the mesh flag still names A.5
    assert {item for *_, item, _what in _REFUSED} == {"A.5"}
    assert [r[2] for r in _REFUSED if r[3] == "A.5"] == ["--engine-mesh"]
    assert not any(r[2].startswith("--oidc-") for r in _REFUSED)


def test_sharded_port_proxy_lists_byte_for_byte_like_the_jax_proxy(
        tmp_path):
    """A port proxy and the JAX proxy, each with ``shard_map`` over the
    same two port engine hosts and one upstream: alice's create lands
    through the port proxy's dual write, and both proxies' lists (and
    mallory's empty one) are the same bytes."""
    from spicedb_kubeapi_proxy_tpu.proxy.inmemory import \
        InMemoryClient as JClient
    from spicedb_kubeapi_proxy_tpu.proxy.options import Options as JOptions
    from spicedb_kubeapi_proxy_tpu_torch.engine import Engine
    from spicedb_kubeapi_proxy_tpu_torch.engine.remote import EngineServer
    from spicedb_kubeapi_proxy_tpu_torch.proxy.inmemory import \
        InMemoryClient
    from torch_parity import serving

    rules = open(RULES).read()
    boot = open(BOOTSTRAP).read()
    engines = [Engine(bootstrap=boot, device="cpu") for _ in range(2)]
    with serving(EngineServer, engines[0]) as a, \
            serving(EngineServer, engines[1]) as b:
        smap = ('{"version": 1, "groups": [["127.0.0.1:%d"], '
                '["127.0.0.1:%d"]]}' % (a.port, b.port))
        kube = InMemoryKube()

        def cfg(opts_cls, tag):
            return opts_cls(
                shard_map=smap, engine_insecure=True, rule_content=rules,
                upstream=kube,
                shard_journal_path=str(tmp_path / f"{tag}-sj.sqlite"),
                workflow_database_path=str(tmp_path / f"{tag}-dtx.sqlite"),
            ).complete()

        async def go():
            port, jax = cfg(Options, "port"), cfg(JOptions, "jax")
            await port.workflow.resume_pending()
            await jax.workflow.resume_pending()
            pa = InMemoryClient(port.server.handle, user="alice")
            r = await pa.post("/api/v1/namespaces", {
                "apiVersion": "v1", "kind": "Namespace",
                "metadata": {"name": "team-a"}})
            assert r.status == 201, r.body
            out = []
            for user in ("alice", "mallory"):
                got = []
                for handle, client in ((port.server.handle, InMemoryClient),
                                       (jax.server.handle, JClient)):
                    resp = await client(handle, user=user).get(
                        "/api/v1/namespaces")
                    assert resp.status == 200
                    got.append(resp.body)
                assert got[0] == got[1], user
                out.append(json.loads(got[0])["items"])
            ready = (await pa.get("/readyz")).body.decode()
            for c in (port, jax):
                await c.workflow.shutdown()
                c.engine.close()
            return out, ready

        (alice, mallory), ready = asyncio.run(go())
    assert [i["metadata"]["name"] for i in alice] == ["team-a"]
    assert mallory == []
    assert "[+]sharding: groups=2 map_version=1" in ready
