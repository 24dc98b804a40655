"""Async HTTP(S) client for the upstream kube-apiserver.

The reverse-proxy transport (reference pkg/proxy/server.go:95-118 uses
httputil.ReverseProxy; activities replay raw URIs with admin credentials,
activity.go:175-231). Built on asyncio streams: per-request connections,
TLS with CA/client-cert options, bearer tokens, and chunked/streaming
response bodies surfaced as async frame iterators (watch).
"""

from __future__ import annotations

import asyncio
import ssl
import time
from typing import AsyncIterator, Optional
from urllib.parse import urlsplit

from ..utils.failpoints import FailPointError, failpoints
from ..utils.metrics import metrics
from ..utils.resilience import (
    CircuitBreaker,
    Deadline,
    RetryBudget,
    RetryPolicy,
)
from .types import ProxyRequest, ProxyResponse

HOP_HEADERS = {"connection", "keep-alive", "transfer-encoding", "upgrade",
               "proxy-connection", "te", "trailer", "content-length", "host"}

# "the transport failed": the connection could not be established, died,
# or timed out. These feed the circuit breaker and — pre-response, on
# idempotent requests only — the retry path. FailPointError is included
# so the upstream.connect/upstream.read failpoints drive the exact same
# classification chaos tests need to exercise.
TRANSPORT_ERRORS = (OSError, asyncio.TimeoutError, TimeoutError,
                    asyncio.IncompleteReadError, FailPointError)


class HttpUpstream:
    """Upstream callable: forwards a ProxyRequest to a base URL.

    Auth headers of the incoming request are replaced by the proxy's own
    credentials (the reference proxies with its admin transport and passes
    user identity via rules, not kube impersonation).
    """

    def __init__(self, base_url: str, token: Optional[str] = None,
                 ca_file: Optional[str] = None,
                 client_cert: Optional[str] = None,
                 client_key: Optional[str] = None,
                 insecure_skip_verify: bool = False,
                 connect_timeout: float = 5.0,
                 request_deadline: float = 30.0,
                 retries: int = 1,
                 retry_policy: Optional[RetryPolicy] = None,
                 breaker: Optional[CircuitBreaker] = None,
                 breaker_failure_threshold: int = 5,
                 breaker_reset_seconds: float = 10.0,
                 retry_budget: Optional[RetryBudget] = None):
        u = urlsplit(base_url)
        self.scheme = u.scheme or "http"
        self.host = u.hostname or "127.0.0.1"
        self.port = u.port or (443 if self.scheme == "https" else 80)
        self.token = token
        # per-attempt connect budget and per-request total deadline (0 =
        # unlimited); a watch's deadline covers establishment only — the
        # long-lived frame stream is exempt by design
        self.connect_timeout = connect_timeout
        self.request_deadline = request_deadline
        # retries apply ONLY to idempotent requests (GET/HEAD: get, list,
        # watch establishment) that failed BEFORE a status line arrived —
        # a write may have been applied even if the response never came
        self.retries = retries
        self.retry_policy = retry_policy or RetryPolicy(base=0.05, cap=1.0)
        # shared token-bucket retry allowance (utils/resilience.py
        # RetryBudget): bounds total upstream retries under sustained
        # failure so a wedged kube-apiserver never sees a retry storm
        # on top of its outage. None = unbudgeted.
        self.retry_budget = retry_budget
        self.breaker = breaker or CircuitBreaker(
            "upstream", failure_threshold=breaker_failure_threshold,
            reset_timeout=breaker_reset_seconds)
        self._ssl: Optional[ssl.SSLContext] = None
        if self.scheme == "https":
            ctx = ssl.create_default_context(cafile=ca_file)
            if client_cert:
                ctx.load_cert_chain(client_cert, client_key)
            if insecure_skip_verify:
                ctx.check_hostname = False
                ctx.verify_mode = ssl.CERT_NONE
            self._ssl = ctx

    async def __call__(self, req: ProxyRequest) -> ProxyResponse:
        deadline = Deadline.after(self.request_deadline)
        attempts = (self.retries + 1
                    if req.method.upper() in ("GET", "HEAD") else 1)
        delays = self.retry_policy.delays()
        if self.retry_budget is not None:
            self.retry_budget.on_attempt()
        while True:
            attempts -= 1
            self.breaker.allow()
            head_seen = [False]
            start = time.monotonic()
            try:
                resp = await self._attempt(req, deadline, head_seen)
            except TRANSPORT_ERRORS:
                self.breaker.record_failure()
                # an exhausted deadline is terminal even for idempotent
                # requests: surface it as the 503-mapped family
                deadline.check("upstream")
                if attempts <= 0 or head_seen[0]:
                    raise
                if self.retry_budget is not None \
                        and not self.retry_budget.allow():
                    # budget dry: surface the failure (counted) rather
                    # than pile a retry storm onto a wedged upstream
                    raise
                metrics.counter("proxy_dependency_retries_total",
                                dependency="upstream").inc()
                await asyncio.sleep(min(next(delays), deadline.remaining()))
                continue
            except BaseException:
                # non-transport outcome (e.g. the handler task was
                # cancelled mid-attempt): no verdict on the dependency,
                # but the admitted half-open probe slot must not leak
                self.breaker.release()
                raise
            self.breaker.record_success()
            metrics.histogram("proxy_dependency_seconds",
                              dependency="upstream").observe(
                time.monotonic() - start)
            return resp

    async def _attempt(self, req: ProxyRequest, deadline: Deadline,
                       head_seen: list) -> ProxyResponse:
        failpoints.hit("upstream.connect")
        try:
            reader, writer = await asyncio.wait_for(
                asyncio.open_connection(self.host, self.port, ssl=self._ssl),
                deadline.budget(self.connect_timeout))
        except (asyncio.TimeoutError, TimeoutError):
            raise ConnectionError(
                f"connect to upstream {self.host}:{self.port} "
                "timed out") from None
        try:
            headers = {k: v for k, v in req.headers.items()
                       if k.lower() not in HOP_HEADERS
                       and not k.lower().startswith("x-remote-")
                       and k.lower() not in ("authorization", "accept")}
            headers["Host"] = f"{self.host}:{self.port}"
            accept = next((v for k, v in req.headers.items()
                           if k.lower() == "accept"), "")
            headers["Accept"] = rewrite_accept(accept, _is_watch(req))
            headers["Connection"] = "close"
            if self.token:
                headers["Authorization"] = f"Bearer {self.token}"
            if req.body:
                headers["Content-Length"] = str(len(req.body))
            lines = [f"{req.method} {req.uri} HTTP/1.1\r\n"]
            for k, v in headers.items():
                lines.append(f"{k}: {v}\r\n")
            lines.append("\r\n")
            writer.write("".join(lines).encode("latin-1"))
            if req.body:
                writer.write(req.body)
            await writer.drain()

            failpoints.hit("upstream.read")
            status, resp_headers = await asyncio.wait_for(
                _read_head(reader), deadline.budget())
            head_seen[0] = True
            is_stream = _is_watch(req) and status == 200
            if is_stream:
                return ProxyResponse(
                    status=status, headers=resp_headers,
                    stream=_stream_body(reader, writer, resp_headers))
            body = await asyncio.wait_for(
                _read_body(reader, resp_headers), deadline.budget())
            writer.close()
            return ProxyResponse(status=status, headers=resp_headers, body=body)
        except BaseException:
            writer.close()
            raise


def rewrite_accept(accept: str, watching: bool,
                   json_only: bool = False) -> str:
    """Accept rewriting for upstream requests: the filterer parses JSON
    (incl. Table) and kube protobuf objects/lists/Tables/watch frames
    (authz/filterer.py, authz/watch.py, proxy/kubeproto.py), so protobuf
    ranges pass through — on watches only while the ``ProtobufWatch``
    gate is on (off = the legacy JSON downgrade, counted in /metrics so
    a fleet of proto watchers re-encoded as JSON is visible to the
    operator). ``json_only`` strips protobuf unconditionally (the
    postfilter path resolves rule expressions over item JSON). Anything
    else is stripped; an emptied Accept falls back to JSON."""

    from ..utils.features import features
    from ..utils.metrics import metrics

    proto_ok = not json_only and features.enabled("ProtobufNegotiation")
    proto_watch_ok = proto_ok and (
        not watching or features.enabled("ProtobufWatch"))
    downgraded = False

    def keep(r: str) -> bool:
        nonlocal downgraded
        low = r.lower()
        if "json" in low:
            return True
        if "protobuf" not in low:
            return False
        if proto_watch_ok:
            return True
        if watching and not json_only:
            downgraded = True
        return False

    out = ",".join(r for r in accept.split(",")
                   if keep(r)) or "application/json"
    if downgraded:
        # one count per watch request whose proto preference we rewrote
        metrics.counter("proxy_proto_watch_downgrades_total").inc()
    return out


def _is_watch(req: ProxyRequest) -> bool:
    v = req.query.get("watch")
    return bool(v) and v[0] in ("", "1", "true", "True")


async def _read_head(reader) -> tuple[int, dict]:
    status_line = await reader.readline()
    parts = status_line.decode("latin-1").split(" ", 2)
    try:
        status = int(parts[1].strip())
    except (IndexError, ValueError):
        # upstream closed (or garbled) before a status line: surface a
        # connection error — the retry/error paths handle those — not a
        # bare IndexError/ValueError from the parse (str.isdigit would
        # still admit non-ASCII digits that int() rejects)
        raise ConnectionResetError(
            "upstream closed the connection before sending a response "
            f"status line ({status_line[:60]!r})") from None
    headers: dict[str, str] = {}
    while True:
        line = await reader.readline()
        if line in (b"\r\n", b"\n", b""):
            break
        k, _, v = line.decode("latin-1").partition(":")
        headers[k.strip()] = v.strip()
    return status, headers


def _header(headers: dict, name: str) -> Optional[str]:
    for k, v in headers.items():
        if k.lower() == name:
            return v
    return None


def _chunk_size(size_line: bytes) -> int:
    """Chunked-transfer size line -> int. Garbage surfaces as a
    connection error the way _read_head does for a garbled status line —
    the retry/error paths classify it as a transport failure instead of
    a bare ValueError escaping to the panic handler."""
    try:
        size = int(size_line.strip().split(b";")[0] or b"0", 16)
    except ValueError:
        size = -1  # int() admits a leading '-'; treat both the same
    if size < 0:
        raise ConnectionResetError(
            "upstream sent a garbled chunk-size line "
            f"({size_line[:40]!r})")
    return size


async def _read_body(reader, headers: dict) -> bytes:
    te = _header(headers, "transfer-encoding") or ""
    if "chunked" in te.lower():
        chunks = []
        while True:
            size_line = await reader.readline()
            if not size_line:
                break
            size = _chunk_size(size_line)
            if size == 0:
                await reader.readline()
                break
            chunks.append(await reader.readexactly(size))
            await reader.readline()
        return b"".join(chunks)
    cl = _header(headers, "content-length")
    if cl is not None:
        return await reader.readexactly(int(cl))
    return await reader.read()


# largest single proto watch frame we will buffer; a corrupt/desynced
# length prefix must abort the stream, not grow the buffer toward 4 GiB
MAX_WATCH_FRAME = 64 * 1024 * 1024


def _split_frames(buf: bytes, proto: bool) -> tuple[list[bytes], bytes]:
    """Complete frames + remainder. JSON watch streams are
    newline-delimited; protobuf streams are 4-byte big-endian
    length-prefixed (kube LengthDelimitedFramer) — frames keep their
    length prefix so downstream passthrough is byte-identical. Raises
    ValueError on an absurd length prefix (ends the watch; the client
    re-lists and re-watches)."""
    frames = []
    if proto:
        while len(buf) >= 4:
            n = int.from_bytes(buf[:4], "big")
            if n > MAX_WATCH_FRAME:
                raise ValueError(
                    f"proto watch frame of {n} bytes exceeds limit "
                    "(corrupt or desynchronized stream)")
            if len(buf) < 4 + n:
                break
            frames.append(buf[:4 + n])
            buf = buf[4 + n:]
    else:
        while b"\n" in buf:
            frame, buf = buf.split(b"\n", 1)
            frames.append(frame + b"\n")
    return frames, buf


def _is_proto_stream(headers: dict) -> bool:
    ct = (_header(headers, "content-type") or "").lower()
    return "protobuf" in ct


async def _stream_body(reader, writer, headers: dict) -> AsyncIterator[bytes]:
    """Yield watch frames, preserving raw bytes (newline-delimited JSON
    or length-prefixed kube protobuf, by response Content-Type)."""
    te = _header(headers, "transfer-encoding") or ""
    proto = _is_proto_stream(headers)
    buf = b""
    try:
        if "chunked" in te.lower():
            while True:
                size_line = await reader.readline()
                if not size_line:
                    break
                size = _chunk_size(size_line)
                if size == 0:
                    break
                data = await reader.readexactly(size)
                await reader.readline()
                buf += data
                frames, buf = _split_frames(buf, proto)
                for frame in frames:
                    yield frame
        elif proto:
            while True:
                data = await reader.read(65536)
                if not data:
                    break
                buf += data
                frames, buf = _split_frames(buf, proto)
                for frame in frames:
                    yield frame
        else:
            while True:
                line = await reader.readline()
                if not line:
                    break
                yield line
        if buf and not proto:
            # proto: a partial frame at EOF is a dead connection's torso —
            # drop it (the filter would fail closed on it anyway); JSON:
            # surface the partial line, the join refuses to judge it
            yield buf
    finally:
        writer.close()
