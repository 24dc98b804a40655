"""The proxy server: asyncio HTTP/1.1 serving the authorization middleware.

Mirrors the Go proxy's pkg/proxy/server.go: a handler chain (panic
recovery → logging → request-info → authentication → authorization →
reverse proxy) mounted alongside /readyz and /livez
(server.go:85-94,147-155). Built on stdlib asyncio streams — no external
HTTP framework — with chunked transfer for watch streams.

The handler core operates on ProxyRequest/ProxyResponse, so the exact same
chain serves the socket listener, the in-memory transport
(pkg/inmemory role, inmemory.py), and tests.
"""

from __future__ import annotations

import asyncio
import logging
import time
import traceback
from dataclasses import dataclass, field
from typing import Optional
from urllib.parse import parse_qs, unquote, urlsplit

from ..authz import AuthzDeps, authorize
from ..obs.trace import tracer
from ..proxy.authn import (
    AuthenticationError,
    ClientCertAuthenticator,
    HeaderAuthenticator,
)
from ..proxy.requestinfo import parse_request_info
from ..proxy.types import ProxyRequest, ProxyResponse, kube_status
from ..utils.metrics import metrics
from ..utils.net import drain_server

log = logging.getLogger("sdbkp.proxy")

MAX_BODY = 64 * 1024 * 1024

# fixed infra endpoints that never open a trace: probe/scrape cadence
# would otherwise cycle real request traces out of the bounded ring
_UNTRACED_PATHS = frozenset({
    "/livez", "/readyz", "/metrics", "/debug/traces", "/debug/config",
    "/debug/slo"})


class Server:
    """Serves the handler chain over TCP; also exposes `handle` for
    in-memory clients (reference GetEmbeddedClient, server.go:303-350)."""

    def __init__(self, deps: AuthzDeps,
                 authenticator: Optional[HeaderAuthenticator] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 config_dump: Optional[dict] = None,
                 ssl_context=None,
                 client_ca_configured: bool = False,
                 requestheader_allowed_names: tuple = (),
                 token_authenticator=None,
                 enable_debug_traces: bool = False,
                 slo_monitor=None,
                 enable_debug_slo: bool = False,
                 autoscale_controller=None):
        self.deps = deps
        self.authenticator = authenticator or HeaderAuthenticator()
        self.cert_authenticator = ClientCertAuthenticator()
        # kube static-token-file authn (authn.go:40-47); None = disabled
        self.token_authenticator = token_authenticator
        self.host = host
        self.port = port
        # sanitized options for /debug/config (the reference's debugmap
        # struct tags produce the same kind of secret-free dump)
        self.config_dump = config_dump
        # TLS serving (reference serves TLS with kube's secure-serving
        # stack, server.go:164-202). With a client CA configured, a peer's
        # verified cert IS its identity (CN -> user, O -> groups) — except
        # peers whose CN is in requestheader_allowed_names, which are
        # trusted FRONT PROXIES allowed to assert end-user identity via
        # X-Remote-* headers (kube's --requestheader-allowed-names
        # contract, authn.go:40-47). Cert-less connections never get
        # header identity when a client CA is configured.
        self.ssl_context = ssl_context
        self.client_ca_configured = client_ca_configured
        self.requestheader_allowed_names = set(requestheader_allowed_names)
        # /debug/traces posture mirrors /debug/config: traces name other
        # subjects' request paths and timings, so the endpoint is opt-in
        # (--enable-debug-traces) on top of authentication
        self.enable_debug_traces = enable_debug_traces
        # live SLO monitor (obs/slo.py); /debug/slo posture mirrors
        # /debug/traces — flag-gated on top of authentication
        self.slo_monitor = slo_monitor
        self.enable_debug_slo = enable_debug_slo
        # autoscale controller (autoscale/controller.py); surfaced on
        # /readyz so operators see dry-run proposals before trusting
        # --autoscale=apply
        self.autoscale_controller = autoscale_controller
        self._server: Optional[asyncio.AbstractServer] = None
        self._conns: set = set()  # live connection-handler tasks

    # -- handler chain -------------------------------------------------------

    async def handle(self, req: ProxyRequest) -> ProxyResponse:
        """Panic recovery → logging → tracing → request info → authn →
        authz. The root span adopts an incoming W3C ``traceparent`` (or
        mints a fresh trace); every response carries ``X-Trace-Id`` while
        tracing is on, so a shed/failed request is followable from the
        client's error body straight into ``/debug/traces``. Fixed infra
        endpoints (health probes, scrapes, the introspection endpoints
        themselves) never trace: at kubelet/Prometheus cadence their
        sampled zero-span traces would cycle real request traces out of
        the fixed ring on a low-traffic replica."""
        start = time.monotonic()
        trace_id = None
        if req.path in _UNTRACED_PATHS:
            resp = await self._recovered_inner(req)
        else:
            tp = next((v for k, v in req.headers.items()
                       if k.lower() == "traceparent"), None)
            with tracer.start("request", traceparent=tp,
                              method=req.method, path=req.path) as root:
                resp = await self._recovered_inner(req)
                root.set("status", resp.status)
                if resp.status >= 500 and not tracer.flagged("shed"):
                    # breaker-open / dependency-down responses are traces
                    # worth keeping: flag so tail sampling never drops
                    # them. Shed 503s stay "shed"-only — a load shed is
                    # the admission design WORKING, and it must not
                    # pollute an operator's error-trace filter
                    tracer.flag("error")
                trace_id = root.trace_id
                if trace_id is not None:
                    resp.headers.setdefault("X-Trace-Id", trace_id)
        dur = time.monotonic() - start
        metrics.counter("proxy_requests_total",
                        verb=(req.request_info.verb if req.request_info
                              else req.method),
                        code=resp.status).inc()
        metrics.histogram("proxy_request_seconds").observe(dur)
        if trace_id is not None and dur >= tracer.slow_s:
            log.warning("slow request: %s %s -> %d (%.1fms, trace %s)",
                        req.method, req.path, resp.status, dur * 1e3,
                        trace_id)
        log.info("%s %s -> %d (%.1fms)", req.method, req.path, resp.status,
                 dur * 1e3)
        return resp

    async def _recovered_inner(self, req: ProxyRequest) -> ProxyResponse:
        try:
            return await self._handle_inner(req)
        except Exception as e:  # panic recovery (server.go:149)
            log.error("panic serving %s %s: %s\n%s", req.method, req.path,
                      e, traceback.format_exc())
            metrics.counter("proxy_panics").inc()
            return kube_status(500, "internal error")

    async def _handle_inner(self, req: ProxyRequest) -> ProxyResponse:
        if req.path == "/livez":
            return ProxyResponse(status=200, body=b"ok")
        if req.path == "/readyz":
            # readiness is per-dependency: an open circuit breaker on the
            # upstream kube-apiserver or an engine endpoint makes the
            # replica unready, with the dependency NAMED in the body
            # (kube readyz check style) so the operator sees which leg is
            # degraded — instead of the unconditional 200 that would keep
            # routing traffic into guaranteed 503s
            reasons = [(b.dependency, r)
                       for b in getattr(self.deps, "breakers", ())
                       if (r := b.open_reason()) is not None]
            # replicated engine set: report role|term|lag so an
            # orchestrator can gate traffic THROUGH the failover window
            # (role != leader means requests would only 503 fail-closed)
            repl_line = None
            repl_fn = getattr(self.deps.engine, "replication_status", None)
            if repl_fn is not None:
                try:
                    # to_thread: the status probe is one blocking socket
                    # round trip — it must not park the event loop
                    st = await asyncio.to_thread(repl_fn)
                except Exception:  # noqa: BLE001 - readyz must answer
                    st = {"role": "electing", "term": None, "lag": None}
                detail = (f"role={st.get('role')} term={st.get('term')} "
                          f"lag={st.get('lag')}")
                if st.get("role") == "leader":
                    repl_line = f"replication: {detail}"
                else:
                    reasons.append(("replication", detail))
            info_lines = [] if repl_line is None else [repl_line]
            # sharded deployments (scaleout/): shard count, per-group
            # role/lag, map version — INFORMATIONAL like admission (a
            # degraded group degrades a slice of the keyspace; pulling
            # the whole replica would turn a partial outage into a full
            # one), but visible here BEFORE that group starts shedding
            shard_fn = getattr(self.deps.engine, "sharding_status", None)
            if shard_fn is not None:
                try:
                    st = await asyncio.to_thread(shard_fn)
                    per_group = " ".join(
                        f"g{g['group']}={g['role']}/"
                        f"{'?' if g['lag'] is None else g['lag']}"
                        for g in st["groups"])
                    info_lines.append(
                        f"sharding: groups={len(st['groups'])} "
                        f"map_version={st['version']} {per_group} "
                        f"pending_splits={st['pending_splits']}")
                    reb = st.get("rebalance")
                    if reb:
                        # a live tuple move in flight: informational
                        # like the sharding line (migration is the
                        # system working, not unreadiness)
                        info_lines.append(
                            f"rebalance: to_version="
                            f"{reb['to_version']} "
                            f"moving={reb['moving']} "
                            f"copied={reb['copied']} "
                            f"cut={reb['cut']} lag={reb['lag']}")
                except Exception:  # noqa: BLE001 - readyz must answer
                    info_lines.append("sharding: status unavailable")
            # live schema migration (migration/migrator.py): phase/lag
            # — INFORMATIONAL like rebalance (a migration in flight is
            # the system changing schemas without downtime, not
            # unreadiness); covers the sharded planner's aggregate and
            # the single-engine (in-proc or remote) status alike
            mig_fn = (getattr(self.deps.engine, "migration_status", None)
                      or getattr(self.deps.engine, "migrate_status",
                                 None))
            if mig_fn is not None:
                try:
                    mig = await asyncio.to_thread(mig_fn)
                except Exception:  # noqa: BLE001 - readyz must answer
                    mig = None
                if mig:
                    info_lines.append(
                        f"migration: phase={mig.get('phase')} "
                        f"classification={mig.get('classification')} "
                        f"lag={mig.get('lag')} "
                        f"backfilled={mig.get('backfilled')}")
            # autoscaler posture: INFORMATIONAL like migration — a
            # proposal (or a transition it started) is the elasticity
            # design working, not unreadiness
            if self.autoscale_controller is not None:
                try:
                    st = self.autoscale_controller.status()
                    last = st.get("last_proposal")
                    last_s = ("none" if not last else
                              f"{last['action']}->"
                              f"{last['target_groups']}")
                    info_lines.append(
                        f"autoscale: mode={st['mode']} "
                        f"groups={st['groups']} "
                        f"transitions={st['transitions']} "
                        f"last={last_s}")
                except Exception:  # noqa: BLE001 - readyz must answer
                    info_lines.append("autoscale: status unavailable")
            # admission shed/queue state is INFORMATIONAL: shedding is
            # the overload design working, not unreadiness — pulling a
            # shedding replica from rotation would dump its share of the
            # load onto the rest and cascade
            adm = getattr(self.deps, "admission", None)
            if adm is not None:
                st = adm.status()
                info_lines.append(
                    f"admission: limit={st['limit']} "
                    f"inflight={st['inflight']} queued={st['queued']} "
                    f"shed={st['shed_total']}")
            if reasons:
                body = "".join(f"[-]{dep}: {reason}\n"
                               for dep, reason in reasons)
                return ProxyResponse(
                    status=503, headers={"Content-Type": "text/plain"},
                    body=body.encode())
            body = b"ok" if not info_lines else (
                "".join(f"[+]{line}\n" for line in info_lines) + "ok"
            ).encode()
            return ProxyResponse(status=200, body=body)
        if req.path == "/metrics":
            return ProxyResponse(
                status=200, headers={"Content-Type": "text/plain"},
                body=metrics.render().encode())
        if req.request_info is None:
            req.request_info = parse_request_info(req.method, req.path,
                                                  req.query)
        if req.user is None and self.token_authenticator is not None:
            auth = next((v for k, v in req.headers.items()
                         if k.lower() == "authorization"), "")
            if auth.lower().startswith("bearer "):
                # to_thread: OIDC verification can do a blocking JWKS
                # fetch (plus modular-exponentiation work) — neither
                # belongs on the event loop
                with tracer.span("authn"):
                    user = await asyncio.to_thread(
                        self.token_authenticator.authenticate_token,
                        auth[7:].strip())
                if user is None:
                    # credentials were presented and are wrong: reject
                    # rather than falling through to weaker identities
                    return kube_status(401, "invalid bearer token",
                                       "Unauthorized")
                req.user = user
        if req.user is None:
            try:
                req.user = self.authenticator.authenticate(req.headers)
            except AuthenticationError as e:
                return kube_status(401, str(e), "Unauthorized")
        if req.path == "/debug/traces":
            # flag-gated AND authenticated (traces name other subjects'
            # request paths and timings); the ring is the recent
            # TAIL-KEPT set — error/shed/slow always, the rest sampled
            if not self.enable_debug_traces or not tracer.enabled:
                return kube_status(
                    404, "trace endpoint disabled "
                         "(--enable-debug-traces, --trace-sample>0)",
                    "NotFound")
            import json as _json

            try:
                limit = int(req.query_get("limit", "64"))
            except ValueError:
                limit = 64
            traces = tracer.recent(limit)
            # cross-process engine hosts keep their span fragments in
            # their OWN ring: fetch and stitch them in by trace_id so an
            # operator reads one complete trace here. In-process engines
            # (and tcp:// hosts sharing this interpreter) stitched live,
            # so only EXTERNAL fragments merge — never duplicates.
            fetch = getattr(self.deps.engine, "fetch_traces", None)
            if fetch is not None:
                try:
                    frags = await asyncio.to_thread(fetch, limit)
                except Exception:  # noqa: BLE001 - diagnostics only
                    frags = []
                # shallow-copy before stitching: recent() hands back the
                # ring's own dicts, and mutating them would re-append
                # fragments on every later fetch
                traces = [dict(t) for t in traces]
                by_id = {t["trace_id"]: t for t in traces}
                for f in frags:
                    if not f.get("external"):
                        continue
                    local = by_id.get(f["trace_id"])
                    if local is not None:
                        local["spans"] = local["spans"] + f["spans"]
                    else:
                        # a later fragment of the same trace (a re-aimed
                        # request leaves spans on several hosts) must
                        # merge into THIS entry, not append another
                        traces.append(f)
                        by_id[f["trace_id"]] = f
            return ProxyResponse(
                status=200, headers={"Content-Type": "application/json"},
                body=_json.dumps({"traces": traces}).encode())
        if req.path == "/debug/slo":
            # flag-gated AND authenticated: declared objectives +
            # multi-window burn rates, fresh-sampled so an operator
            # debugging an alert reads NOW, not the last tick
            if not self.enable_debug_slo or self.slo_monitor is None:
                return kube_status(
                    404, "SLO endpoint disabled "
                         "(--enable-debug-slo, --slo-objectives)",
                    "NotFound")
            import json as _json

            mon = self.slo_monitor
            await asyncio.to_thread(mon.tick)
            return ProxyResponse(
                status=200, headers={"Content-Type": "application/json"},
                body=_json.dumps(mon.status()).encode())
        if req.path == "/debug/config":
            # flag-gated (Options.enable_debug_config) AND authenticated:
            # the dump is allowlisted, but config topology still doesn't
            # belong on an endpoint that exists by default
            if self.config_dump is None:
                return kube_status(404, "not found", "NotFound")
            import json as _json

            return ProxyResponse(
                status=200, headers={"Content-Type": "application/json"},
                body=_json.dumps(self.config_dump, indent=2).encode())
        return await authorize(req, self.deps)

    # -- TCP serving ---------------------------------------------------------

    async def start(self) -> int:
        self._server = await asyncio.start_server(
            self._serve_connection, self.host, self.port,
            ssl=self.ssl_context)
        self.port = self._server.sockets[0].getsockname()[1]
        log.info("proxy listening on %s:%d (%s)", self.host, self.port,
                 "https" if self.ssl_context else "http")
        return self.port

    async def stop(self, grace: float = 2.0) -> None:
        """Stop listening and drain connections (utils/net.py: idle
        streaming handlers never write, so without the drain
        ``wait_closed()`` blocks forever on any idle watch)."""
        if self._server is None:
            return
        await drain_server(self._server, self._conns, grace)
        self._server = None

    async def _serve_connection(self, reader: asyncio.StreamReader,
                                writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        self._conns.add(task)
        try:
            await self._serve_connection_inner(reader, writer)
        finally:
            self._conns.discard(task)

    async def _serve_connection_inner(self, reader: asyncio.StreamReader,
                                      writer: asyncio.StreamWriter) -> None:
        # cert identity is per-connection: resolve once, stamp each request
        peer_user = None
        peer_error: Optional[str] = None
        if self.ssl_context is not None:
            peercert = writer.get_extra_info("peercert")
            if peercert:
                try:
                    peer_user = self.cert_authenticator.authenticate_peer(
                        peercert)
                except AuthenticationError as e:
                    peer_error = str(e)
        try:
            while True:
                req = await _read_request(reader)
                if req is None:
                    return
                if peer_user is not None and \
                        peer_user.name in self.requestheader_allowed_names:
                    # trusted front proxy: its X-Remote-* headers carry the
                    # end-user identity (header authn path runs as usual)
                    pass
                elif peer_user is not None:
                    # verified client cert IS the identity; headers from
                    # ordinary cert users must not escalate
                    req.user = peer_user
                elif peer_error is not None or (
                        self.ssl_context is not None
                        and self.client_ca_configured):
                    # a client CA is configured: identity headers are only
                    # trusted from allowed cert-bearing front proxies
                    # (anyone can send headers; only proxies hold certs)
                    req.headers = {
                        k: v for k, v in req.headers.items()
                        if not k.lower().startswith("x-remote-")}
                resp = await self.handle(req)
                conn_hdr = next((v for k, v in req.headers.items()
                                 if k.lower() == "connection"), "")
                keep_alive = conn_hdr.lower() != "close"
                await _write_response(writer, resp)
                if resp.stream is not None or not keep_alive:
                    return
        except (asyncio.IncompleteReadError, ConnectionResetError):
            pass
        except Exception:
            log.exception("connection handler error")
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:
                pass


async def _read_request(reader: asyncio.StreamReader) -> Optional[ProxyRequest]:
    try:
        request_line = await reader.readline()
    except (asyncio.IncompleteReadError, ConnectionResetError):
        return None
    if not request_line:
        return None
    parts = request_line.decode("latin-1").strip().split(" ")
    if len(parts) != 3:
        return None
    method, target, _version = parts
    headers: dict[str, str] = {}
    while True:
        line = await reader.readline()
        if line in (b"\r\n", b"\n", b""):
            break
        k, _, v = line.decode("latin-1").partition(":")
        k, v = k.strip(), v.strip()
        if k.lower() in ("x-remote-group",) and k in headers:
            headers[k] = headers[k] + "," + v  # repeated group headers
        else:
            headers[k] = v
    body = b""
    if "Content-Length" in {k.title(): None for k in headers}:
        n = int(next(v for k, v in headers.items()
                     if k.lower() == "content-length"))
        if n > MAX_BODY:
            return None
        body = await reader.readexactly(n)
    elif any(k.lower() == "transfer-encoding"
             and "chunked" in v.lower() for k, v in headers.items()):
        chunks = []
        total = 0
        while True:
            size_line = await reader.readline()
            size = int(size_line.strip().split(b";")[0], 16)
            if size == 0:
                await reader.readline()
                break
            total += size
            if total > MAX_BODY:  # same cap as Content-Length bodies
                return None
            chunks.append(await reader.readexactly(size))
            await reader.readline()
        body = b"".join(chunks)
    u = urlsplit(target)
    query = parse_qs(u.query, keep_blank_values=True)
    return ProxyRequest(method=method, path=unquote(u.path), query=query,
                        headers=headers, body=body)


async def _write_response(writer: asyncio.StreamWriter,
                          resp: ProxyResponse) -> None:
    headers = dict(resp.headers)
    if resp.stream is not None:
        headers.pop("Content-Length", None)
        headers["Transfer-Encoding"] = "chunked"
    else:
        headers["Content-Length"] = str(len(resp.body))
    headers.setdefault("Content-Type", "application/json")
    lines = [f"HTTP/1.1 {resp.status} {_reason(resp.status)}\r\n"]
    for k, v in headers.items():
        lines.append(f"{k}: {v}\r\n")
    lines.append("\r\n")
    writer.write("".join(lines).encode("latin-1"))
    await writer.drain()
    if resp.stream is None:
        writer.write(resp.body)
        await writer.drain()
        return
    try:
        async for frame in resp.stream:
            writer.write(f"{len(frame):x}\r\n".encode())
            writer.write(frame)
            writer.write(b"\r\n")
            await writer.drain()
    finally:
        try:
            writer.write(b"0\r\n\r\n")
            await writer.drain()
        except (ConnectionResetError, BrokenPipeError):
            pass


def _reason(status: int) -> str:
    return {
        200: "OK", 201: "Created", 202: "Accepted", 204: "No Content",
        400: "Bad Request", 401: "Unauthorized", 403: "Forbidden",
        404: "Not Found", 405: "Method Not Allowed", 409: "Conflict",
        422: "Unprocessable Entity", 500: "Internal Server Error",
        502: "Bad Gateway", 504: "Gateway Timeout",
    }.get(status, "Status")
