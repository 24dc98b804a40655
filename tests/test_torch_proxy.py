"""The port's proxy against the JAX proxy, request by request.

One request script goes to two proxies built by each package's
``proxy/options.Options`` from the repo's ``deploy/rules.yaml`` and
``deploy/bootstrap.yaml``: the JAX proxy over the JAX ``Engine`` (on the
CPU) and the JAX ``InMemoryKube``, and the port's proxy over the port's
``Engine(device="cpu")`` and the port's ``InMemoryKube``. Every response's
status, content type and body must be byte-equal (tolerance: exact). The
script covers namespace and pod create, get, list and delete as alice,
bob and mallory; JSON, Table and protobuf lists; a post-filter rule; a
failed upstream create rolled back; a filtered watch; and a caveated list
under two ``X-Forwarded-For`` hops. It runs in process (each package's
``proxy/inmemory.InMemoryClient`` over its ``Server.handle``) and once
over real loopback HTTP through each ``Server``.
"""

from __future__ import annotations

import asyncio
import importlib
import json
import os
from urllib.parse import parse_qs

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RULES = open(os.path.join(REPO, "deploy", "rules.yaml")).read()
BOOTSTRAP = open(os.path.join(REPO, "deploy", "bootstrap.yaml")).read()
JAX, PORT = "spicedb_kubeapi_proxy_tpu", "spicedb_kubeapi_proxy_tpu_torch"

# a post-filtered list: configmaps are kept where the caller can view the
# pod of the same namespace/name
POSTFILTER_RULES = """
apiVersion: authzed.com/v1alpha1
kind: ProxyRule
metadata:
  name: list-configmaps-postfiltered
match:
- apiVersion: v1
  resource: configmaps
  verbs: ["list"]
postfilter:
- checkPermissionTemplate:
    tpl: "pod:{{namespacedName}}#view@user:{{user.name}}"
"""

# deploy/bootstrap.yaml with an IP-allowlisted viewer arm on namespaces
CAVEAT_BOOTSTRAP = BOOTSTRAP.replace(
    "  use expiration\n",
    "  use expiration\n\n  caveat ip_allowlist(ip ipaddress, "
    "allowed list<ipaddress>) {\n    ip in allowed\n  }\n", 1).replace(
    "relation viewer: user | group#member | user:* with expiration",
    "relation viewer: user | group#member | user:* with expiration"
    " | user with ip_allowlist", 1)
CAVEAT_RELS = (
    'namespace:c1#viewer@user:carol[ip_allowlist:{"allowed":["10.0.0.0/8"]}]',
    'namespace:c2#viewer@user:carol'
    '[ip_allowlist:{"allowed":["192.168.0.0/16"]}]',
    "namespace:c3#viewer@user:carol",
)

TABLE_ACCEPT = "application/json;as=Table;v=v1;g=meta.k8s.io"
PROTO = "application/vnd.kubernetes.protobuf"


def _ld(field_no: int, payload: bytes) -> bytes:
    n = len(payload)
    out = bytearray([(field_no << 3) | 2])
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            break
    return bytes(out) + payload


def _unknown(api_version: str, kind: str, raw: bytes) -> bytes:
    return (b"k8s\x00" + _ld(1, _ld(1, api_version.encode())
                             + _ld(2, kind.encode()))
            + _ld(2, raw) + _ld(4, PROTO.encode()))


def _proto_meta(meta: dict) -> bytes:
    out = _ld(1, meta["name"].encode())
    if meta.get("namespace"):
        out += _ld(3, meta["namespace"].encode())
    return out


def render(doc: dict, accept: str) -> tuple[str, bytes]:
    """A list document in the representation ``accept`` asks for (what a
    kube-apiserver would serve): a JSON or protobuf Table, or a protobuf
    List, each item carrying bytes the filters must keep as they are."""
    items = doc["items"]
    if "as=Table" in accept:
        if PROTO in accept:
            rows = b""
            for it in items:
                pom = _unknown("meta.k8s.io/v1", "PartialObjectMetadata",
                               _ld(1, _proto_meta(it["metadata"])))
                rows += _ld(3, _ld(1, _ld(1, b'"cell"')) + _ld(3, _ld(1, pom)))
            raw = _ld(1, _ld(2, b"rv1")) + rows
            return PROTO, _unknown("meta.k8s.io/v1", "Table", raw)
        table = {"kind": "Table", "apiVersion": "meta.k8s.io/v1",
                 "columnDefinitions": [{"name": "Name"}],
                 "rows": [{"cells": [it["metadata"]["name"]],
                           "object": {"kind": "PartialObjectMetadata",
                                      "metadata": it["metadata"]}}
                          for it in items]}
        return "application/json", json.dumps(table).encode()
    raw = _ld(1, _ld(2, doc["metadata"]["resourceVersion"].encode()))
    for it in items:
        raw += _ld(2, _ld(1, _proto_meta(it["metadata"]))
                   + _ld(2, b"\x0a\x03spec"))
    return PROTO, _unknown("v1", doc["kind"], raw)


class Upstream:
    """A package's ``InMemoryKube`` with Table and protobuf renderings of
    its lists and one-shot injected failures."""

    def __init__(self, pkg: str):
        self.kube = importlib.import_module(
            pkg + ".proxy.inmemkube").InMemoryKube()
        self.types = importlib.import_module(pkg + ".proxy.types")
        self.fail_next: list[str] = []  # methods to answer 500 once

    async def __call__(self, req):
        if self.fail_next and req.method == self.fail_next[0]:
            self.fail_next.pop(0)
            return self.types.kube_status(500, "injected upstream failure",
                                          "InternalError")
        resp = await self.kube(req)
        accept = next((v for k, v in req.headers.items()
                       if k.lower() == "accept"), "")
        if (req.method == "GET" and resp.status == 200
                and resp.stream is None
                and ("as=Table" in accept or PROTO in accept)):
            doc = json.loads(resp.body)
            if doc.get("kind", "").endswith("List"):
                ctype, body = render(doc, accept)
                return self.types.ProxyResponse(
                    status=200, headers={"Content-Type": ctype}, body=body)
        return resp


class Side:
    """One package's proxy, from its own Options."""

    def __init__(self, pkg: str, db: str, bootstrap: str, rules: str):
        self.pkg = pkg
        self.up = Upstream(pkg)
        opts = importlib.import_module(pkg + ".proxy.options").Options
        kw = dict(rule_content=rules, bootstrap_content=bootstrap,
                  upstream=self.up, workflow_database_path=db, bind_port=0)
        if pkg == PORT:
            kw["device"] = "cpu"
        self.cfg = opts(**kw).complete()
        self.types = importlib.import_module(pkg + ".proxy.types")
        self.port = None

    def write(self, *rels: str) -> None:
        eng = importlib.import_module(self.pkg + ".engine")
        tup = importlib.import_module(self.pkg + ".models.tuples")
        self.cfg.engine.write_relationships(
            [eng.WriteOp("touch", tup.parse_relationship(r)) for r in rels])

    def has(self, rel: str) -> bool:
        eng = importlib.import_module(self.pkg + ".engine")
        tup = importlib.import_module(self.pkg + ".models.tuples")
        r = tup.parse_relationship(rel)
        return self.cfg.engine.store.exists(eng.RelationshipFilter(
            r.resource_type, r.resource_id, r.relation,
            r.subject_type, r.subject_id))

    async def start(self, http: bool) -> None:
        await self.cfg.workflow.resume_pending()
        if http:
            await self.cfg.server.start()
            self.port = self.cfg.server.port

    async def stop(self) -> None:
        self.up.kube.stop_watches()
        if self.port is not None:
            await self.cfg.server.stop(grace=1.0)
        await self.cfg.workflow.shutdown()
        close = getattr(self.cfg.engine, "close_compaction", None)
        if close is not None:
            close()

    def _client(self, user):
        mod = importlib.import_module(self.pkg + ".proxy.inmemory")
        return mod.InMemoryClient(self.cfg.server.handle, user=user)

    def _headers(self, user, headers, body) -> dict:
        h = {"Content-Type": "application/json"}
        if user:
            h["X-Remote-User"] = user
        h.update(headers or {})
        return h

    async def call(self, method, path, user=None, body=None, headers=None,
                   query=""):
        data = json.dumps(body).encode() if body is not None else b""
        h = self._headers(user, headers, body)
        if self.port is None:
            resp = await self._client(user).request(
                method, path, body=data, query=parse_qs(query),
                headers=headers)
            return resp.status, resp.content_type, resp.body
        status, rh, b = await _http(self.port, method,
                                    path + ("?" + query if query else ""),
                                    h, data)
        return status, rh.get("content-type", "").split(";")[0], b

    async def watch(self, path, user, n, act):
        """The first ``n`` frames a watch delivers while ``act()`` runs."""
        h = self._headers(user, None, None)
        frames: list[bytes] = []
        if self.port is None:
            resp = await self._client(user).get(
                path, query=parse_qs("watch=true"))
            assert resp.status == 200 and resp.stream is not None

            async def consume():
                async for f in resp.stream:
                    frames.append(bytes(f))
                    if len(frames) >= n:
                        return
        else:
            status, _, (reader, writer) = await _http(
                self.port, "GET", path + "?watch=true", h, b"", stream=True)
            assert status == 200

            async def consume():
                try:
                    while len(frames) < n:
                        size = int((await reader.readline()).strip() or b"0",
                                   16)
                        if size == 0:
                            return
                        frames.append(await reader.readexactly(size))
                        await reader.readline()
                finally:
                    writer.close()
        task = asyncio.ensure_future(consume())
        await asyncio.sleep(0.1)
        await act()
        await asyncio.wait_for(task, timeout=30)
        return [json.loads(f) for f in frames]


async def _http(port, method, target, headers, data, stream=False):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    lines = [f"{method} {target} HTTP/1.1", f"Host: 127.0.0.1:{port}",
             *(f"{k}: {v}" for k, v in headers.items()),
             f"Content-Length: {len(data)}"]
    if not stream:
        lines.append("Connection: close")
    writer.write("\r\n".join(lines + ["", ""]).encode() + data)
    await writer.drain()
    status = int((await reader.readline()).split(b" ")[1])
    rh = {}
    while True:
        line = await reader.readline()
        if line in (b"\r\n", b"\n", b""):
            break
        k, _, v = line.decode().partition(":")
        rh[k.strip().lower()] = v.strip()
    if stream:
        return status, rh, (reader, writer)
    if "chunked" in rh.get("transfer-encoding", ""):
        chunks = []
        while True:
            size = int((await reader.readline()).strip() or b"0", 16)
            if size == 0:
                break
            chunks.append(await reader.readexactly(size))
            await reader.readline()
        body = b"".join(chunks)
    else:
        n = int(rh.get("content-length", 0))
        body = await reader.readexactly(n) if n else await reader.read()
    writer.close()
    return status, rh, body


def _ns(name):
    return {"apiVersion": "v1", "kind": "Namespace",
            "metadata": {"name": name}}


def _pod(ns, name):
    return {"apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": name, "namespace": ns},
            "spec": {"containers": [{"name": "c", "image": "busybox"}]}}


# (label, method, path, user, body, headers, query)
SCRIPT = [
    ("discovery", "GET", "/api", "alice", None, None, ""),
    ("ns create a", "POST", "/api/v1/namespaces", "alice", _ns("team-a"),
     None, ""),
    ("ns create b", "POST", "/api/v1/namespaces", "bob", _ns("team-b"),
     None, ""),
    ("ns create x", "POST", "/api/v1/namespaces", "alice", _ns("team-x"),
     None, ""),
    ("ns create taken", "POST", "/api/v1/namespaces", "mallory",
     _ns("team-x"), None, ""),
    ("ns get taken", "GET", "/api/v1/namespaces/team-x", "mallory", None,
     None, ""),
    ("ns list alice", "GET", "/api/v1/namespaces", "alice", None, None, ""),
    ("ns list bob", "GET", "/api/v1/namespaces", "bob", None, None, ""),
    ("ns list mallory", "GET", "/api/v1/namespaces", "mallory", None, None,
     ""),
    ("ns get alice", "GET", "/api/v1/namespaces/team-a", "alice", None,
     None, ""),
    ("ns get mallory", "GET", "/api/v1/namespaces/team-a", "mallory", None,
     None, ""),
    ("no user", "GET", "/api/v1/namespaces", None, None, None, ""),
    ("pod create alice", "POST", "/api/v1/namespaces/team-a/pods", "alice",
     _pod("team-a", "web"), None, ""),
    ("pod create alice 2", "POST", "/api/v1/namespaces/team-a/pods",
     "alice", _pod("team-a", "db"), None, ""),
    ("pod create mallory", "POST", "/api/v1/namespaces/team-a/pods",
     "mallory", _pod("team-a", "evil"), None, ""),
    ("pod create bob", "POST", "/api/v1/namespaces/team-b/pods", "bob",
     _pod("team-b", "api"), None, ""),
    ("pod list alice", "GET", "/api/v1/pods", "alice", None, None, ""),
    ("pod list bob", "GET", "/api/v1/pods", "bob", None, None, ""),
    ("pod list mallory", "GET", "/api/v1/pods", "mallory", None, None, ""),
    ("pod list ns", "GET", "/api/v1/namespaces/team-a/pods", "alice", None,
     None, ""),
    ("pod list ns bob", "GET", "/api/v1/namespaces/team-a/pods", "bob",
     None, None, ""),
    ("pod get alice", "GET", "/api/v1/namespaces/team-a/pods/web", "alice",
     None, None, ""),
    ("pod get bob", "GET", "/api/v1/namespaces/team-a/pods/web", "bob",
     None, None, ""),
    ("table list", "GET", "/api/v1/pods", "alice", None,
     {"Accept": TABLE_ACCEPT}, ""),
    ("table list bob", "GET", "/api/v1/namespaces", "bob", None,
     {"Accept": TABLE_ACCEPT}, ""),
    ("proto list", "GET", "/api/v1/pods", "alice", None,
     {"Accept": PROTO}, ""),
    ("proto list mallory", "GET", "/api/v1/pods", "mallory", None,
     {"Accept": PROTO}, ""),
    ("proto table", "GET", "/api/v1/namespaces", "bob", None,
     {"Accept": PROTO + ";as=Table;v=v1;g=meta.k8s.io"}, ""),
    ("postfilter alice", "GET", "/api/v1/configmaps", "alice", None, None,
     ""),
    ("postfilter bob", "GET", "/api/v1/configmaps", "bob", None, None, ""),
    ("unmatched", "GET", "/api/v1/secrets", "alice", None, None, ""),
    ("failed create", "POST", "/api/v1/namespaces/team-a/pods", "alice",
     _pod("team-a", "bad"), None, ""),
    ("after rollback", "GET", "/api/v1/pods", "alice", None, None, ""),
    ("pod delete bob", "DELETE", "/api/v1/namespaces/team-a/pods/db", "bob",
     None, None, ""),
    ("pod delete alice", "DELETE", "/api/v1/namespaces/team-a/pods/db",
     "alice", None, None, ""),
    ("after delete", "GET", "/api/v1/pods", "alice", None, None, ""),
    ("ns delete mallory", "DELETE", "/api/v1/namespaces/team-b", "mallory",
     None, None, ""),
    ("ns delete bob", "DELETE", "/api/v1/namespaces/team-b", "bob", None,
     None, ""),
    ("ns list after delete", "GET", "/api/v1/namespaces", "bob", None, None,
     ""),
]


async def _run_script(sides, tmp_path):
    out = {}
    for label, method, path, user, body, headers, query in SCRIPT:
        if label == "postfilter alice":
            for s in sides:
                for ns, name in (("team-a", "web"), ("team-b", "api"),
                                 ("team-a", "other")):
                    s.up.kube.put("configmaps", name, ns,
                                  {"data": {"k": name}})
        if label == "failed create":
            for s in sides:
                s.up.fail_next.append("POST")
        got = [await s.call(method, path, user, body, headers, query)
               for s in sides]
        assert got[0] == got[1], (label, got)
        out[label] = got[1]
    # the rolled-back create left no relationship on either side
    for s in sides:
        assert not s.has("pod:team-a/bad#creator@user:alice"), s.pkg
        assert s.has("pod:team-a/web#creator@user:alice"), s.pkg
        assert not s.has("pod:team-a/db#creator@user:alice"), s.pkg
    return out


async def _watch(sides):
    async def act_for(s):
        async def act():
            await s.call("POST", "/api/v1/namespaces", "bob", _ns("w-bob"))
            await s.call("POST", "/api/v1/namespaces", "alice",
                         _ns("w-alice"))
        return act
    got = [await s.watch("/api/v1/namespaces", "alice", 3, await act_for(s))
           for s in sides]
    assert got[0] == got[1]
    assert [f["object"]["metadata"]["name"] for f in got[1]] == [
        "team-a", "team-x", "w-alice"]
    assert [f["type"] for f in got[1]] == ["ADDED"] * 3


async def _caveated(sides):
    for s in sides:
        s.write(*CAVEAT_RELS)
        for n in ("c1", "c2", "c3"):
            s.up.kube.put("namespaces", n)
    names = {}
    for xff in ("203.0.113.9, 10.1.2.3", "10.1.2.3, 192.168.7.7", None):
        h = {"X-Forwarded-For": xff} if xff else None
        got = [await s.call("GET", "/api/v1/namespaces", "carol", None, h)
               for s in sides]
        assert got[0] == got[1], (xff, got)
        names[xff] = [i["metadata"]["name"]
                      for i in json.loads(got[1][2])["items"]]
    return names


@pytest.mark.parametrize("transport", ["inprocess", "http"])
def test_port_proxy_answers_as_the_jax_proxy(tmp_path, transport):
    async def go():
        sides = [Side(pkg, str(tmp_path / f"{pkg}.sqlite"), BOOTSTRAP,
                      RULES + "\n---\n" + POSTFILTER_RULES)
                 for pkg in (JAX, PORT)]
        for s in sides:
            await s.start(transport == "http")
        try:
            out = await _run_script(sides, tmp_path)
            await _watch(sides)
        finally:
            for s in sides:
                await s.stop()
        return out

    out = asyncio.run(go())
    assert out["ns create a"][0] == 201
    assert out["ns create taken"][0] == 409
    # a create of an object that exists counts as applied (the Go
    # proxy's workflow.go:252-275), so mallory's 409 leaves her creator
    # relationship in place on both sides
    assert out["ns get taken"][0] == 200
    assert out["ns get mallory"][0] == 403
    assert out["ns delete mallory"][0] == 403
    assert out["pod create mallory"][0] == 403
    assert out["pod get bob"][0] == 403
    assert out["failed create"][0] == 500
    assert out["pod delete bob"][0] == 403
    assert out["pod delete alice"][0] == 200
    listed = [i["metadata"]["name"]
              for i in json.loads(out["pod list alice"][2])["items"]]
    assert listed == ["db", "web"]
    assert json.loads(out["pod list mallory"][2])["items"] == []
    assert json.loads(out["postfilter alice"][2])["items"][0][
        "metadata"]["name"] == "web"
    assert out["proto list"][1] == PROTO
    assert out["table list"][1] == "application/json"


def test_caveated_list_follows_the_last_forwarded_hop(tmp_path):
    async def go():
        sides = [Side(pkg, str(tmp_path / f"{pkg}.sqlite"),
                      CAVEAT_BOOTSTRAP, RULES) for pkg in (JAX, PORT)]
        for s in sides:
            await s.start(False)
        try:
            return await _caveated(sides)
        finally:
            for s in sides:
                await s.stop()

    names = asyncio.run(go())
    assert names == {"203.0.113.9, 10.1.2.3": ["c1", "c3"],
                     "10.1.2.3, 192.168.7.7": ["c2", "c3"],
                     None: ["c3"]}


def test_port_proxy_serves_on_the_port_engine(tmp_path):
    """The in-process engine is the port's, on the device asked for, and
    a list's prefilter is one mask dispatch on it."""
    from spicedb_kubeapi_proxy_tpu_torch.engine import Engine
    from spicedb_kubeapi_proxy_tpu_torch.utils.metrics import metrics

    s = Side(PORT, str(tmp_path / "p.sqlite"), BOOTSTRAP, RULES)
    assert isinstance(s.cfg.engine, Engine)
    assert str(s.cfg.engine.device) == "cpu"

    async def go():
        await s.start(False)
        try:
            await s.call("POST", "/api/v1/namespaces", "alice", _ns("n1"))
            c = metrics.counter("engine_lookups_total")
            before = c.value
            st, _, body = await s.call("GET", "/api/v1/namespaces", "alice")
            assert st == 200
            assert [i["metadata"]["name"]
                    for i in json.loads(body)["items"]] == ["n1"]
            assert c.value == before + 1
        finally:
            await s.stop()

    asyncio.run(go())


def test_port_proxy_over_a_port_engine_host(tmp_path):
    """``tcp://`` builds the port's ``RemoteEngine``: the port's proxy
    serves a dual-write create and a prefiltered list from a port engine
    host as it does in process."""
    from spicedb_kubeapi_proxy_tpu_torch.engine import Engine
    from spicedb_kubeapi_proxy_tpu_torch.engine.remote import (
        EngineServer,
        RemoteEngine,
    )
    from spicedb_kubeapi_proxy_tpu_torch.proxy.options import Options
    from torch_parity import serving

    host = Engine(BOOTSTRAP, device="cpu")
    with serving(EngineServer, host) as srv:
        up = Upstream(PORT)
        cfg = Options(rule_content=RULES, upstream=up, engine_insecure=True,
                      engine_endpoint=f"tcp://127.0.0.1:{srv.port}",
                      workflow_database_path=str(tmp_path / "d.sqlite")
                      ).complete()
        assert isinstance(cfg.engine, RemoteEngine)
        client = importlib.import_module(
            PORT + ".proxy.inmemory").InMemoryClient

        async def go():
            await cfg.workflow.resume_pending()
            try:
                a = client(cfg.server.handle, user="alice")
                r = await a.post("/api/v1/namespaces", _ns("remote-ns"))
                assert r.status == 201, r.body
                r = await a.get("/api/v1/namespaces")
                assert [i["metadata"]["name"] for i in
                        json.loads(r.body)["items"]] == ["remote-ns"]
                m = client(cfg.server.handle, user="mallory")
                r = await m.get("/api/v1/namespaces/remote-ns")
                assert r.status == 403
            finally:
                await cfg.workflow.shutdown()
                cfg.engine.close()

        asyncio.run(go())
    assert host.store.exists(importlib.import_module(
        PORT + ".engine").RelationshipFilter(
        "namespace", "remote-ns", "creator", "user", "alice"))
