"""The engine host: the port's :class:`Engine` served over TCP.

Counterpart of the JAX package's ``engine/remote.py``, on the same wire,
so either package's client talks to either package's host. One engine
host owns the GPU and N proxy replicas consume the same engine API
remotely (the reference proxy's ``--spicedb-endpoint host:port`` with a
bearer token, its pkg/proxy/options.go:325-369): ``EngineServer`` wraps
an in-process :class:`Engine`; ``RemoteEngine`` is a drop-in client
exposing the surface the proxy consumes (check_bulk, lookup_resources,
write/read/delete relationships, watch_since, revision, store.exists);
``FailoverEngine`` follows whichever of several hosts leads.

Protocol: 4-byte big-endian length-prefixed frames.
    request:  JSON {"op": str, "token": str?, ...args}
    response: JSON {"ok": true, "result": ...}
            | JSON {"ok": false, "kind": str, "error": str}
            | binary: 0x00 byte + 4-byte meta length + meta JSON + payload
Errors round-trip by kind so precondition failures and schema violations
keep their meaning across the wire. The host serves TLS from a cert/key
pair (``--tls-cert-file``/``--tls-key-file``, optional
``--tls-client-ca-file`` for mutual TLS) and refuses to serve plaintext
unless explicitly ``--engine-insecure``; clients verify against the
system store or a CA bundle (utils/tlsconf.py).

The ``lookup_mask`` op returns the allowed set as a PACKED BITMASK over
the resource type's interned object space (1 bit per padded object
index: 16 KB at the headline's 131,072-slot pod space) instead of a
multi-MB JSON id list. Mask indices resolve through a client-side id
table synced INCREMENTALLY via ``object_ids`` (interners are append-only
within a store epoch; a snapshot restore mints a new epoch and
invalidates client caches).

The scale-out ops are served: the rebalance mover's ``slice_read/load/
apply/drop/watch`` (npz frames through persistence/codec.py, idempotent,
admission-classed ``rebalance``) and the frontier exchange's
``frontier_pairs/expand`` (scaleout/), with client methods on
``RemoteEngine`` and ``FailoverEngine``. So are the live schema
migration ops (``migrate_begin/status/cut/abort``), and the CLI resolves
a data dir's migration record at boot. A leader serves the mirror stream
(``mirror_subscribe``, parallel/multihost.py), and ``--peers`` runs the
host as one member of a replicated set with automatic leader failover
(parallel/failover.py): a follower answers only ``failover_state``. The
flag-gated chaos plane (``chaos_arm/reset/status``, ``--enable-chaos-ops``)
installs seeded fault schedules (chaos/schedule.py) into this process's
failpoint registry. ``python -m
spicedb_kubeapi_proxy_tpu_torch.engine.remote`` runs a standalone host
(``main``) on ``--device`` (``cuda`` by default).
"""

from __future__ import annotations

import asyncio
import errno
import hmac
import json
import logging
import os
import socket
import ssl
import struct
import threading
import time
from dataclasses import asdict
from functools import partial
from typing import Optional

from ..admission import AdmissionRejected, classify_op
from ..obs.trace import tracer
from ..utils.failpoints import FailPointError, failpoints
from ..utils.metrics import metrics
from ..utils.net import drain_server
from ..utils.resilience import (
    CircuitBreaker,
    Deadline,
    DependencyUnavailable,
    RetryBudget,
    RetryPolicy,
)

from ..models.schema import SchemaError
from ..models.tuples import Relationship
from .engine import CheckItem, Engine, SchemaViolation, WatchEvent
from .store import (
    Precondition,
    PreconditionFailed,
    RelationshipFilter,
    StoreError,
    WriteOp,
)

log = logging.getLogger("sdbkp.torch.engine.remote")

MAX_FRAME = 256 * 1024 * 1024
# Until a connection has authenticated once, frames are capped far smaller:
# an auth frame is a few hundred bytes, and the big limit exists for bulk
# relationship payloads that only authenticated peers may send. Without this
# an unauthenticated socket could make the server buffer 256MiB per frame.
MAX_FRAME_PREAUTH = 1024 * 1024

class _EngineView:
    """The ONE attribute the ``_op_*`` handlers touch, pinned at
    role-gate time: handlers run as plain functions against this view,
    so a failover demotion swapping ``server.engine`` mid-request can
    never reroute an op onto the deposed leader's bare engine."""

    __slots__ = ("engine",)

    def __init__(self, engine):
        self.engine = engine


class _Demoted(Exception):
    """Server-internal: the role gate re-check at op-execution time found
    the host demoted after the event-loop gate passed (EngineServer.
    _dispatch maps it to the ``not_leader`` wire kind)."""

    def __init__(self, role, term):
        super().__init__(f"demoted to {role} (term {term})")
        self.role = role
        self.term = term


class NotLeaderError(DependencyUnavailable):
    """The engine host answered but is not the replication leader
    (role-gated follower, or a deposed leader mid-demotion). Subclasses
    :class:`~..utils.resilience.DependencyUnavailable` so the authz
    middleware fails it CLOSED as a retryable kube 503 + Retry-After;
    the failover client treats it as a re-resolve trigger — the op was
    rejected BEFORE dispatch, so even a write is safe to re-aim."""

    def __init__(self, message: str = ""):
        super().__init__(
            "engine-leader",
            message or "engine host is not the replication leader",
            retry_after=1.0)


class RemoteEngineError(RuntimeError):
    pass


class EngineInternalError(RemoteEngineError):
    """The engine host ANSWERED kind="internal": an exception inside its
    op handler (including chaos-armed server-side faults). Distinct from
    the RemoteEngineError base — which also covers auth/proto/frame
    errors that are PERMANENT (wrong token, oversized frame) — so the
    authz middleware can map only genuine host-side failures to the
    retryable fail-closed 503 family without turning a misconfiguration
    into an endlessly-retried "transient" outage."""


_ERROR_KINDS = {
    "precondition": PreconditionFailed,
    "schema": SchemaViolation,
    "store": StoreError,
    "not_leader": NotLeaderError,
    "internal": EngineInternalError,
}

# ops that are safe to retry after a transport failure even if the
# request bytes reached the engine host: pure reads. Writes
# (write/delete_relationships) are NEVER in this set — once bytes are on
# the wire the server may have applied them, and a replay would
# double-apply (the no-retry-after-send invariant in _transact).
_IDEMPOTENT_OPS = frozenset({
    "check_bulk", "lookup_resources", "lookup_mask", "lookup_subjects",
    "object_ids", "revision", "exists", "watch_since", "watch_gate",
    "read_relationships", "traces",
    # the rebalance mover's slice ops are idempotent BY CONSTRUCTION
    # (slice_read is a pure read; slice_load/slice_apply replay as
    # TOUCH/last-per-key effects; slice_drop deletes are idempotent),
    # so unlike ordinary writes they are safe to re-send after an
    # ambiguous transport death — exactly what a mid-copy SIGKILL of a
    # group leader produces
    "slice_read", "slice_load", "slice_apply", "slice_drop",
    "slice_watch",
    # migration control reads + level-triggered controls: status is a
    # pure read; cut/abort converge to the same terminal state however
    # many times they land. migrate_begin is NOT here — a replay would
    # race the single-active-migration refusal.
    "migrate_status", "migrate_cut", "migrate_abort",
    # frontier exchange: both legs are pure reads (pair derivation is
    # a schema walk; expansion is a batch of lookup_resources)
    "frontier_expand", "frontier_pairs",
    # autoscaler signal probe: a pure read of admission/latency state
    "load_status",
})

# "the transport failed" (vs the engine answering with an error): socket
# errors — connect refused/reset/timeout, TLS failures — plus armed
# failpoints so chaos tests drive the same classification
TRANSPORT_ERRORS = (OSError, FailPointError)

# ops exempt from the server-side fault sites (engine.dispatch /
# engine.respond): the chaos CONTROL plane and failover resolution. A
# p=1 error/drop schedule would otherwise brick its own chaos_reset —
# an unrecoverable host where the campaign meant a recoverable fault —
# and blind the client-side leader discovery the campaign steers by.
_CHAOS_EXEMPT_OPS = frozenset({
    "chaos_arm", "chaos_reset", "chaos_status", "failover_state",
})


# -- codecs ------------------------------------------------------------------


def _rel_to_dict(r: Relationship) -> dict:
    return asdict(r)


def _rel_from_dict(d: dict) -> Relationship:
    return Relationship(**d)


def _filter_from_dict(d: dict) -> RelationshipFilter:
    return RelationshipFilter(**d)


def po2_chunks(n: int, cap: int = 2048):
    """Split ``n`` rows into descending power-of-two chunk sizes
    (at most the largest power of two within ``cap``). The JAX host
    chunks this way so its overlay scatter sees at most ``log2(cap)``
    shapes; the port keeps the same chunking so a mover batch lands as
    the same sequence of writes (and revisions) on either package's
    host, unless the port's overlay is too small for a 2,048-row chunk
    (:func:`mover_chunk_cap`)."""
    sizes = []
    c = 1
    while c * 2 <= cap:
        c <<= 1
    while n > 0:
        while c > n:
            c >>= 1
        sizes.append(c)
        n -= c
    return sizes


def mover_chunk_cap(engine) -> int:
    """The most rows one mover write carries into ``engine``: 2,048, and
    under the compactor's back-pressure at most half of what an empty
    overlay absorbs, so a chunk fits after a fold while tenant writes
    hold the rest (a chunk of the whole overlay would fit only an empty
    one, and one larger is refused for good)."""
    limit = engine.max_write_records()
    return 2048 if limit is None else max(1, min(2048, limit // 2))


def _apply_po2(engine, rows, op: "str | None") -> int:
    """Apply mover rows through the ordinary write path in power-of-two
    chunks (see :func:`po2_chunks`) of at most
    :func:`mover_chunk_cap`. ``op`` of None means ``rows`` are WriteOps
    already. Module-level on purpose: op handlers run against the
    role-gate's slim ``_EngineView`` pin, not the server object."""
    rev = engine.revision
    i = 0
    for c in po2_chunks(len(rows), mover_chunk_cap(engine)):
        chunk = rows[i:i + c]
        rev = engine.write_relationships(
            chunk if op is None else [WriteOp(op, r) for r in chunk])
        i += c
    return rev


def _watch_events_wire(engine, revision) -> list:
    """watch_since -> wire form (shared by the tenant watch op and the
    mover's rebalance-classed twin; module-level because op handlers
    run against the role-gate's slim ``_EngineView`` pin)."""
    return [
        {"revision": e.revision, "operation": e.operation,
         "rel": _rel_to_dict(e.relationship)}
        for e in engine.watch_since(revision)
    ]


def _slice_rows(engine, ranges, want_globals: bool) -> list:
    """Live relationships in the requested partition-key hash ranges
    (or the replicated global tuples) — the slice_read/slice_drop row
    scan, shared with the in-process fallback in scaleout/rebalance."""
    # function-level import: scaleout imports this module at load time
    from ..scaleout.shardmap import hash_key, split_resource

    rows = []
    for rel in engine.read_relationships(RelationshipFilter()):
        ns, namespaced = split_resource(rel.resource_id)
        if want_globals:
            if not namespaced:
                rows.append(rel)
            continue
        if not namespaced:
            continue
        h = hash_key(ns, rel.resource_type)
        if any(lo <= h < hi for lo, hi in ranges):
            rows.append(rel)
    return rows


def _rels_to_cols(rels: list) -> dict:
    """Relationship rows -> the columnar bulk form the npz codec
    (persistence/codec.py) carries (None expirations become NaN; optional strings become
    empty — ``_cols_to_rels`` is the inverse)."""
    cols = {k: [] for k in (
        "resource_type", "resource_id", "relation", "subject_type",
        "subject_id", "subject_relation", "expiration", "caveat",
        "caveat_context")}
    for r in rels:
        cols["resource_type"].append(r.resource_type)
        cols["resource_id"].append(r.resource_id)
        cols["relation"].append(r.relation)
        cols["subject_type"].append(r.subject_type)
        cols["subject_id"].append(r.subject_id)
        cols["subject_relation"].append(r.subject_relation or "")
        cols["expiration"].append(r.expiration)
        cols["caveat"].append(r.caveat or "")
        cols["caveat_context"].append(r.caveat_context or "")
    return cols


def _cols_to_rels(cols: dict) -> list:
    import math

    n = len(cols.get("resource_id", ()))
    srl = cols.get("subject_relation")
    exp = cols.get("expiration")
    cav = cols.get("caveat")
    ctx = cols.get("caveat_context")

    def opt(col, i):
        if col is None:
            return None
        v = str(col[i])
        return v or None

    out = []
    for i in range(n):
        e = None
        if exp is not None:
            ev = float(exp[i])
            e = None if (math.isnan(ev) or math.isinf(ev)) else ev
        out.append(Relationship(
            str(cols["resource_type"][i]), str(cols["resource_id"][i]),
            str(cols["relation"][i]), str(cols["subject_type"][i]),
            str(cols["subject_id"][i]), opt(srl, i), e,
            opt(cav, i), opt(ctx, i)))
    return out


# -- framing -----------------------------------------------------------------


def _pack(msg: dict) -> bytes:
    body = json.dumps(msg).encode()
    return struct.pack(">I", len(body)) + body


class BinaryResult:
    """An op result carried as a binary frame (meta JSON + raw payload)
    instead of the normal ``{"ok": true, "result": ...}`` JSON."""

    __slots__ = ("meta", "payload")

    def __init__(self, meta: dict, payload: bytes):
        self.meta = meta
        self.payload = payload


def _pack_binary(res: BinaryResult) -> bytes:
    # a leading NUL distinguishes binary frames: JSON bodies always start
    # with '{'
    meta = json.dumps(res.meta).encode()
    body = b"\x00" + struct.pack(">I", len(meta)) + meta + res.payload
    return struct.pack(">I", len(body)) + body


def _recv_exact(s: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = s.recv(n - len(buf))
        if not chunk:
            raise ConnectionResetError("engine connection closed")
        buf.extend(chunk)
    return bytes(buf)


def _read_frame_sync(s: socket.socket):
    """Blocking read of one response frame off a socket: a parsed JSON
    dict, or ``(meta, payload)`` for binary frames. The ONE place client-
    side framing lives (request path and watch push stream both use it)."""
    header = _recv_exact(s, 4)
    (n,) = struct.unpack(">I", header)
    if n > MAX_FRAME:
        raise RemoteEngineError(f"frame of {n} bytes exceeds limit")
    body = _recv_exact(s, n)
    if body[:1] == b"\x00":
        (m,) = struct.unpack(">I", body[1:5])
        return json.loads(body[5:5 + m]), body[5 + m:]
    return json.loads(body)


async def _read_frame(reader: asyncio.StreamReader,
                      limit: int = MAX_FRAME) -> Optional[dict]:
    try:
        header = await reader.readexactly(4)
    except (asyncio.IncompleteReadError, ConnectionResetError):
        return None
    (n,) = struct.unpack(">I", header)
    if n > limit:
        raise RemoteEngineError(f"frame of {n} bytes exceeds limit")
    body = await reader.readexactly(n)
    return json.loads(body)


# -- server ------------------------------------------------------------------


class EngineServer:
    """Serves an :class:`Engine` to remote proxies. Device queries run in
    worker threads so slow fixpoints never stall other connections'
    dispatches — concurrent queries pipeline on the device the same way
    in-process callers do.

    The workers come from a DEDICATED executor, not the loop's default
    pool: push-watch streams park a thread per subscriber waiting for
    events, and batched lookups (enable_lookup_batching) park up to
    max_rows threads per fill window — on a small host the default
    pool's min(32, cpus+4) workers would starve request handling (and an
    embedding application's own to_thread users would compete with the
    engine)."""

    def __init__(self, engine: Engine, host: str = "127.0.0.1",
                 port: int = 0, token: Optional[str] = None,
                 ssl_context=None, max_workers: int = 64,
                 failover_status=None, admission=None,
                 allow_chaos: bool = False):
        from concurrent.futures import ThreadPoolExecutor

        self.engine = engine
        # test-only fault plane (--enable-chaos-ops): when on, the
        # chaos_arm/chaos_reset/chaos_status wire ops let a campaign
        # runner install seeded fault schedules into THIS process's
        # failpoint registry — the only way to drive deterministic
        # multi-process chaos against subprocess engine hosts. Off by
        # default and meant to stay off outside test topologies.
        self.allow_chaos = allow_chaos
        self.host = host
        self.port = port
        self.token = token
        # admission controller (admission/): device-dispatching ops
        # acquire a cost-classed slot — tenant = the proxy replica's peer
        # address — BEFORE entering the worker pool, so one replica's
        # storm cannot monopolize a shared engine host and overload sheds
        # as wire-level "admission" rejections instead of queueing
        # unboundedly in the executor. None = ungated.
        self.admission = admission
        # replication role provider: a callable returning {role, term,
        # revision, peer_id, lag}. When set, every op except the control
        # plane is ROLE-GATED — a follower (or electing) host rejects with
        # kind "not_leader" instead of answering from possibly-stale
        # state. None = the single-host default: this process IS the
        # leader of itself.
        self.failover_status = failover_status
        # heartbeat cadence on idle mirror streams; failover deployments
        # shrink it so followers detect a dead leader in seconds, not
        # PUSH_HEARTBEAT multiples
        self.mirror_heartbeat = self.PUSH_HEARTBEAT
        # an ssl.SSLContext makes every connection TLS (utils/tlsconf.py);
        # None serves plaintext — the standalone CLI refuses that
        # combination unless --engine-insecure is explicit
        self.ssl_context = ssl_context
        self._server: Optional[asyncio.AbstractServer] = None
        self._conns: set = set()  # live connection-handler tasks
        # queues of the mirror streams this server pushes (stop() ends
        # each with the close sentinel, so no worker stays parked on one)
        self._mirror_queues: set = set()
        self._executor = ThreadPoolExecutor(
            max_workers=max_workers, thread_name_prefix="engine-host")

    async def _in_worker(self, fn, *args):
        """Run blocking work on the dedicated pool (to_thread semantics,
        minus contextvars, which the handlers don't use)."""
        return await asyncio.get_running_loop().run_in_executor(
            self._executor, partial(fn, *args))

    # a host restarted on its fixed port can find the port held for a
    # moment: clients that kept dialing it while it was down can be handed
    # it as their own source port (a loopback self-connect in the
    # ephemeral range), a socket they drop on their next read
    BIND_RETRY_SECONDS = 30.0

    async def start(self) -> int:
        deadline = time.monotonic() + (self.BIND_RETRY_SECONDS
                                       if self.port else 0.0)
        while True:
            try:
                self._server = await asyncio.start_server(
                    self._serve, self.host, self.port,
                    ssl=self.ssl_context)
                break
            except OSError as e:
                if e.errno != errno.EADDRINUSE \
                        or time.monotonic() >= deadline:
                    raise
                log.warning("port %s:%d in use; retrying the bind",
                            self.host, self.port)
                await asyncio.sleep(0.25)
        self.port = self._server.sockets[0].getsockname()[1]
        log.info("engine listening on %s:%d%s", self.host, self.port,
                 " (TLS)" if self.ssl_context else "")
        return self.port

    async def stop(self, grace: float = 2.0) -> None:
        """Stop listening, drain connections (utils/net.py: clients pool
        idle sockets blocked in _read_frame, which ``wait_closed()``
        would wait on forever on Python 3.12+), then JOIN the worker
        pool: once this returns no worker still runs a device dispatch,
        so the caller may release the engine's device memory."""
        if self._server is None:
            return
        store = getattr(self.engine, "store", None)

        # repeatedly release push loops parked in wait_events, and mirror
        # pushers parked on their queue, during the drain and the join (a
        # cancelled run_in_executor only unblocks when the worker thread
        # returns; a single wake can race a loop that re-parks before its
        # cancellation lands) — without this, each active watch_subscribe
        # or mirror stream holds the drain for up to its heartbeat
        async def _wake_loop():
            while True:
                if hasattr(store, "wake_waiters"):
                    store.wake_waiters()
                for q in list(self._mirror_queues):
                    q.put_nowait(None)  # unbounded: never parks the loop
                await asyncio.sleep(0.2)

        waker = asyncio.get_running_loop().create_task(_wake_loop())
        try:
            await drain_server(self._server, self._conns, grace)
            # drained handlers have given up their futures, but a worker
            # may still be inside an engine call: wait for it (queued
            # work that never started is cancelled)
            await asyncio.get_running_loop().run_in_executor(
                None, partial(self._executor.shutdown, wait=True,
                              cancel_futures=True))
        finally:
            if waker is not None:
                waker.cancel()
        self._server = None

    async def _serve(self, reader: asyncio.StreamReader,
                     writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        self._conns.add(task)
        try:
            await self._serve_inner(reader, writer)
        finally:
            self._conns.discard(task)

    async def _serve_inner(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        authed = not self.token
        # admission tenancy: the peer ADDRESS (one tenant per proxy
        # replica, however many pooled connections it opens) — server-
        # derived, never client-asserted, so a token holder cannot mint
        # fresh tenants to reset its fair-queue debt
        peer = writer.get_extra_info("peername")
        peer_tenant = peer[0] if isinstance(peer, (tuple, list)) and peer \
            else "local"
        try:
            while True:
                limit = MAX_FRAME if authed else MAX_FRAME_PREAUTH
                req = await _read_frame(reader, limit=limit)
                if req is None:
                    return
                resp = await self._dispatch(req, peer_tenant)
                if req.get("op") not in _CHAOS_EXEMPT_OPS \
                        and failpoints.branch("engine.respond"):
                    # chaos: the response falls into the void — the
                    # client sees a reset (its request MAY have applied:
                    # exactly the ambiguity the no-retry-after-send
                    # write rule and the split-journal pending rule are
                    # specified against)
                    return
                if isinstance(resp, BinaryResult):
                    authed = True
                    writer.write(_pack_binary(resp))
                else:
                    if resp.get("ok") or resp.get("kind") != "auth":
                        authed = True
                    writer.write(_pack(resp))
                await writer.drain()
                if not isinstance(resp, BinaryResult) and resp.get("ok") \
                        and req.get("op") == "mirror_subscribe":
                    # a follower: stream every mirrored engine action
                    # (parallel/multihost.py MirroredEngine); the reader
                    # now carries only follower acks
                    await self._push_mirror(reader, writer, req)
                    return
                if not isinstance(resp, BinaryResult) and resp.get("ok") \
                        and req.get("op") == "watch_subscribe":
                    # the ack is out; the connection now becomes a
                    # one-way server-push event stream
                    await self._push_events(writer,
                                            int(req["from_revision"]))
                    return
        except (ConnectionResetError, asyncio.IncompleteReadError):
            pass
        except Exception:
            log.exception("engine connection error")
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:
                pass

    async def _dispatch(self, req: dict, tenant: str = "local") -> dict:
        if self.token and not hmac.compare_digest(
                str(req.get("token") or ""), self.token):
            return {"ok": False, "kind": "auth", "error": "invalid token"}
        op = req.get("op")
        # trace stitching: the proxy forwards its span context as the
        # "tr" frame field (a W3C traceparent); engine-host spans (queue
        # wait, device dispatch, replication ack wait) attach under it —
        # into the SAME live trace when proxy and host share a process,
        # as a same-trace_id satellite fragment across processes
        with tracer.adopt(req.get("tr"), f"engine_host.{op}",
                          endpoint=f"{self.host}:{self.port}",
                          tenant=tenant):
            return await self._dispatch_traced(req, op, tenant)

    async def _dispatch_traced(self, req: dict, op, tenant: str) -> dict:
        ticket = None
        try:
            fn = getattr(self, f"_op_{op}", None)
            if fn is None:
                return {"ok": False, "kind": "proto",
                        "error": f"unknown op {op!r}"}
            if self.failover_status is not None \
                    and op not in ("failover_state", "traces",
                                   "chaos_arm", "chaos_reset",
                                   "chaos_status"):
                # chaos ops are control-plane like failover_state: a
                # campaign must be able to arm faults on FOLLOWERS (the
                # crash/partition targets) — a role gate would restrict
                # chaos to whichever host happens to lead
                # traces is diagnostics like failover_state: an operator
                # following a trace through a follower (or a deposed
                # leader) must be able to read its fragments
                st = self.failover_status()
                if st.get("role") != "leader":
                    # fail CLOSED, never stale: a follower's store trails
                    # the leader and a deposed leader's may be fenced off
                    return {"ok": False, "kind": "not_leader",
                            "error": f"engine host is {st.get('role')} "
                                     f"(term {st.get('term')}), not the "
                                     "replication leader"}
                # PIN the gate-approved engine for the op's whole
                # execution: ops dereference `self.engine` at call time,
                # so a demotion landing between this gate and the worker
                # slot would otherwise run a write against the freshly-
                # unwrapped BARE engine of a deposed leader (no mirror
                # frame, no term stamp, no replication floor). Running
                # the handler against an _EngineView closes that: even
                # if the op races a demotion, it goes through the term-
                # stamped mirrored wrapper — whose frames a newer
                # lineage fences and whose floored writes fail closed.
                view = _EngineView(self.engine)
                inner_fn = getattr(type(self), f"_op_{op}")

                def fn(r):  # noqa: F811 - deliberate gated shadow
                    st2 = self.failover_status()
                    if st2.get("role") != "leader":
                        # demotion already visible: reject rather than
                        # run a doomed (fenced) op to completion
                        raise _Demoted(st2.get("role"), st2.get("term"))
                    return inner_fn(view, r)
            if self.admission is not None:
                cls = classify_op(op, len(req.get("items") or ()) or 1)
                if cls is not None:
                    # admission runs AFTER the role gate (a follower's
                    # not_leader must win — its rejection re-aims the
                    # client) and BEFORE the worker pool: queued ops park
                    # a future here, not an executor thread. Tenancy is
                    # the PEER ADDRESS only — a wire-level override would
                    # let any token holder mint fresh zero-debt tenants
                    # per request and defeat the fair queue entirely
                    with tracer.span("engine_queue_wait",
                                     **{"class": cls.name}):
                        ticket = await self.admission.acquire_async(
                            tenant, cls)
            if op not in _CHAOS_EXEMPT_OPS \
                    and failpoints.armed("engine.dispatch"):
                # server-side fault site (chaos schedules): runs in the
                # WORKER thread so a delay action models a browned-out
                # device/host without stalling the event loop, an error
                # action a host answering with internal failures, and a
                # crash action a hard process death mid-dispatch
                inner0 = fn

                def fn(r, _inner=inner0):  # noqa: F811
                    failpoints.hit("engine.dispatch")
                    return _inner(r)
            captured = tracer.capture()
            if captured is not None:
                # run_in_executor does NOT copy contextvars: re-enter the
                # trace inside the worker so the device span (and any
                # replication-ack-wait span under it) stitches correctly
                inner = fn

                def fn(r, _inner=inner, _cap=captured):  # noqa: F811
                    with tracer.activate(_cap), \
                            tracer.span("engine_device", op=op):
                        return _inner(r)
            result = await self._in_worker(fn, req)
            if isinstance(result, BinaryResult):
                return result
            return {"ok": True, "result": result}
        except AdmissionRejected as e:
            # NOT a transport failure: rides a normal response frame, so
            # client breakers stay closed (the host is healthy, just full)
            return {"ok": False, "kind": "admission", "error": str(e),
                    "class": e.op_class, "retry_after": e.retry_after}
        except _Demoted as e:
            return {"ok": False, "kind": "not_leader",
                    "error": f"engine host was demoted to {e.role} "
                             f"(term {e.term}) before the op dispatched"}
        except PreconditionFailed as e:
            return {"ok": False, "kind": "precondition", "error": str(e)}
        except SchemaViolation as e:
            return {"ok": False, "kind": "schema", "error": str(e)}
        except SchemaError as e:
            # migrate_begin's typed incompatible refusal (and any parse
            # error in the proposed schema) is a SCHEMA answer, not a
            # host-side failure — kind "internal" would invite retries
            # against a permanent condition
            return {"ok": False, "kind": "schema", "error": str(e)}
        except StoreError as e:
            return {"ok": False, "kind": "store", "error": str(e)}
        except Exception as e:
            log.exception("engine op %s failed", op)
            return {"ok": False, "kind": "internal", "error": str(e)}
        finally:
            if ticket is not None:
                # the limiter's latency probe is the SINGLE-CHECK class
                # only — the one op whose duration is homogeneous.
                # Bulk-check spans scale with item count, lookups with
                # the fixpoint, and replicated writes with the sync-
                # replication wait: feeding that mixture to one baseline
                # would read op VARIETY as congestion and ratchet the
                # limit to minimum on a healthy host (device queueing
                # still surfaces in check latency — same chip). The
                # other classes still occupy weighted budget while held.
                ticket.release(
                    observe=ticket.cls.name == "check")

    # -- ops (run in worker threads) ----------------------------------------

    def _op_check_bulk(self, req: dict):
        items = [CheckItem(*it) for it in req["items"]]
        return self.engine.check_bulk(items, now=req.get("now"),
                                      context=req.get("ctx") or None)

    def _op_lookup_resources(self, req: dict):
        return self.engine.lookup_resources(
            req["resource_type"], req["permission"], req["subject_type"],
            req["subject_id"], req.get("subject_relation"),
            now=req.get("now"), context=req.get("ctx") or None)

    def _op_lookup_subjects(self, req: dict):
        return self.engine.lookup_subjects(
            req["resource_type"], req["resource_id"], req["permission"],
            req["subject_type"], req.get("subject_relation"),
            now=req.get("now"), context=req.get("ctx") or None)

    def _op_frontier_pairs(self, req: dict):
        """The schema's frontier reference pairs (scaleout/frontier.py)
        — raises the monotonicity refusal server-side so a planner
        enabling the exchange against an unsupported schema fails
        closed on first use."""
        from ..scaleout.frontier import reference_pairs

        return [list(p) for p in reference_pairs(self.engine.schema)]

    def _op_frontier_expand(self, req: dict):
        """One frontier-exchange leg against THIS group's local tuples
        (scaleout/frontier.py expand_local — one owner for the
        semantics, in-process and over the wire)."""
        from ..scaleout.frontier import decode_frontier, expand_local

        out = expand_local(
            self.engine, decode_frontier(req["descs"]),
            [(str(t), str(r)) for t, r in req["pairs"]],
            now=req.get("now"), context=req.get("ctx") or None)
        return sorted(([t, i, r] for t, i, r in out),
                      key=lambda d: (d[0], d[1], d[2] or ""))

    def _op_lookup_mask(self, req: dict):
        """The hot-path variant: packed bitmask over the type's object
        index space (see module docstring): constant-size, ~16 KB at a
        bucket-padded 100k-object space."""
        import numpy as np

        from ..ops.reachability import StateReleased

        for _ in range(3):
            # bracket the query with epoch reads: a concurrent snapshot
            # restore between them would otherwise stamp OLD-interner mask
            # indices with the NEW epoch — exactly the aliasing the epoch
            # exists to prevent (the client would resolve wrong names)
            epoch = self.engine.store.epoch
            try:
                mask, interner = self.engine.lookup_resources_mask(
                    req["resource_type"], req["permission"],
                    req["subject_type"], req["subject_id"],
                    req.get("subject_relation"), now=req.get("now"),
                    context=req.get("ctx") or None)
            except StateReleased:
                # the port frees a replaced lineage's device state at the
                # restore (the reference keeps immutable arrays), so a
                # dispatch that raced it fails instead of finishing on
                # the old graph: the same case as a changed epoch
                if self.engine.store.epoch == epoch:
                    raise
                continue
            if self.engine.store.epoch != epoch:
                continue
            if mask is None:
                return {"found": False}
            return BinaryResult(
                {"found": True, "n": int(mask.size), "gen": len(interner),
                 "epoch": epoch},
                np.packbits(mask).tobytes())
        raise StoreError("store epoch kept changing during lookup")

    def _op_object_ids(self, req: dict):
        """Incremental id-table sync: strings interned at or past ``from``
        for a resource type. Append-only within an epoch, so clients fetch
        only the delta."""
        store = self.engine.store
        with store._lock:
            epoch = store.epoch
            tid = store.types.lookup(req["type"])
            it = store.objects.get(tid) if tid is not None else None
            if it is None:
                return {"epoch": epoch, "gen": 0, "ids": []}
            strings = it.strings()
        start = max(0, int(req.get("from", 0)))
        return {"epoch": epoch, "gen": len(strings),
                "ids": strings[start:]}

    def _op_write_relationships(self, req: dict):
        ops = [WriteOp(o["op"], _rel_from_dict(o["rel"]))
               for o in req["ops"]]
        pcs = [Precondition(_filter_from_dict(p["filter"]), p["must_exist"])
               for p in req.get("preconditions", [])]
        return self.engine.write_relationships(ops, pcs)

    def _op_delete_relationships(self, req: dict):
        pcs = [Precondition(_filter_from_dict(p["filter"]), p["must_exist"])
               for p in req.get("preconditions", [])]
        return self.engine.delete_relationships(
            _filter_from_dict(req["filter"]), pcs)

    def _op_read_relationships(self, req: dict):
        return [_rel_to_dict(r) for r in self.engine.read_relationships(
            _filter_from_dict(req["filter"]))]

    # seconds between keepalive frames on an idle push stream (lets the
    # client distinguish "no events" from a dead peer)
    PUSH_HEARTBEAT = 15.0

    def _op_watch_subscribe(self, req: dict):
        """Ack only — _serve_inner switches the connection into the push
        loop after this response is written (reference watches are a
        long-lived server-push stream, pkg/authz/watch.go:29)."""
        int(req["from_revision"])  # validate now, fail as a JSON error
        return {"subscribed": True, "revision": self.engine.revision}

    async def _push_events(self, writer: asyncio.StreamWriter,
                           from_rev: int) -> None:
        """Server-push loop: block on the store's revision condition (in a
        worker thread) and write each event batch as it lands — no
        client polling, grant/revoke latency = write latency + one
        one-way trip. Heartbeats mark liveness on idle streams."""
        rev = from_rev
        while True:
            try:
                events = await self._in_worker(
                    self.engine.wait_events, rev, self.PUSH_HEARTBEAT)
            except StoreError as e:
                writer.write(_pack({"ok": False, "push": True,
                                    "kind": "store", "error": str(e)}))
                await writer.drain()
                return
            if events:
                rev = max(e.revision for e in events)
            writer.write(_pack({
                "ok": True, "push": True, "revision": rev,
                "events": [
                    {"revision": e.revision, "operation": e.operation,
                     "rel": _rel_to_dict(e.relationship)}
                    for e in events
                ]}))
            await writer.drain()

    def _op_mirror_subscribe(self, req: dict):
        """Ack for a follower's subscription; _serve_inner then switches
        the connection into the mirror-push loop. Only valid when the
        engine is a MirroredEngine leader. An optional
        ``from_revision`` (a restarting follower's recovered revision)
        makes the stream open with a catch-up frame — the delta from the
        leader's watch history, or a full state transfer when that
        history no longer reaches back far enough."""
        if not hasattr(self.engine, "subscribe"):
            raise StoreError(
                "engine host is not a multi-host leader "
                "(no MirroredEngine)")
        if "from_revision" in req:
            int(req["from_revision"])  # validate now, fail as a JSON error
            if not hasattr(self.engine, "subscribe_with_catchup"):
                raise StoreError(
                    "engine host does not support follower catch-up")
        return {"subscribed": True,
                "term": int(getattr(self.engine, "term", 0) or 0)}

    async def _mirror_ack_reader(self, reader: asyncio.StreamReader,
                                 q, eng) -> None:
        """Drain follower acknowledgements off the (otherwise one-way)
        mirror stream: ``{"ack": seq, "term": t}`` frames credit the
        subscriber's replication progress — the leader's sync-replicated
        writes wait on them (MirroredEngine._wait_replicated). ``eng``
        is the engine object PINNED by _push_mirror at subscribe time:
        acks belong to that wrapper's subscription, not to whatever a
        failover demotion may have swapped into self.engine since."""
        while True:
            frame = await _read_frame(reader)
            if frame is None:
                return
            seq = frame.get("ack")
            if seq is not None and hasattr(eng, "record_ack"):
                eng.record_ack(q, int(seq), frame.get("term"))

    @staticmethod
    def _mirror_hb(engine) -> dict:
        """An idle mirror stream's liveness frame, with the leader's term
        and sequence (the follower's lag)."""
        hb = {"ok": True, "hb": True}
        term = int(getattr(engine, "term", 0) or 0)
        if term:
            hb["term"] = term
        seq = getattr(engine, "mirror_seq", None)
        if seq is not None:
            hb["seq"] = int(seq)
        return hb

    async def _push_mirror(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter,
                           req: dict) -> None:
        import queue as _queue

        # pin the engine object: a failover demotion swaps self.engine
        # mid-stream, and the queue must be unsubscribed from the SAME
        # wrapper that registered it
        engine = self.engine
        if not hasattr(engine, "subscribe"):
            # demoted between the gated mirror_subscribe ack and this
            # push loop: the bare engine has no mirror surface — close
            # with the honest rejection, not an AttributeError
            writer.write(_pack({"ok": False, "kind": "not_leader",
                                "error": "engine host was demoted before "
                                         "the mirror stream started"}))
            await writer.drain()
            return
        if "from_revision" in req:
            # atomic cut (multihost.py subscribe_with_catchup): the
            # catch-up lands the follower at exactly the revision the
            # queued live frames continue from. A full state's cut and
            # encode can outlast the follower's heartbeat window (~16 s
            # at 10M rows against 2.5 s), and the reference sends nothing
            # meanwhile, so the follower drops the stream and asks again
            # forever: heartbeat while the worker cuts and encodes
            t0 = time.perf_counter()
            cut = asyncio.ensure_future(self._in_worker(
                partial(engine.subscribe_with_catchup,
                        int(req["from_revision"]),
                        subscriber_term=req.get("term"))))
            try:
                while not (await asyncio.wait(
                        {cut}, timeout=self.mirror_heartbeat))[0]:
                    writer.write(_pack(self._mirror_hb(engine)))
                    await writer.drain()
            except BaseException:
                # the follower left mid-cut: its subscription (registered
                # by the cut) must not outlive it
                cut.add_done_callback(
                    lambda f: f.cancelled() or f.exception() is not None
                    or engine.unsubscribe(f.result()[0]))
                raise
            q, meta, payload = cut.result()
            log.info("mirror catch-up from revision %s: %s to revision %d, "
                     "%d payload bytes, cut and encode %.3f s",
                     req["from_revision"],
                     "full state" if payload is not None else
                     f"{len(meta.get('effects') or ())} effects",
                     meta["revision"],
                     0 if payload is None else len(payload),
                     time.perf_counter() - t0)
        else:
            q, meta, payload = engine.subscribe(), None, None
        acks = asyncio.get_running_loop().create_task(
            self._mirror_ack_reader(reader, q, engine))
        self._mirror_queues.add(q)
        try:
            if meta is not None:
                frame = {"ok": True, "catchup": meta}
                if payload is not None:
                    writer.write(_pack_binary(BinaryResult(frame, payload)))
                else:
                    writer.write(_pack(frame))
                await writer.drain()
            while True:
                try:
                    wire = await self._in_worker(
                        q.get, True, self.mirror_heartbeat)
                except _queue.Empty:
                    if failpoints.branch("mirror.heartbeat"):
                        continue  # chaos: suppressed liveness heartbeat
                    writer.write(_pack(self._mirror_hb(engine)))
                    await writer.drain()
                    continue
                if wire is None:
                    # replication-timeout drop sentinel (MirroredEngine.
                    # _wait_replicated): close so the follower SEES it
                    return
                if failpoints.branch("mirror.partition"):
                    continue  # chaos: this frame falls into the void
                # pre-packed once by MirroredEngine._publish: the same
                # bytes object fans out to every follower
                writer.write(wire)
                await writer.drain()
        finally:
            self._mirror_queues.discard(q)
            acks.cancel()
            engine.unsubscribe(q)

    def _op_watch_since(self, req: dict):
        return _watch_events_wire(self.engine, req["revision"])

    def _op_slice_watch(self, req: dict):
        """watch_since for the rebalance mover's catch-up polls: the
        same answer, but admission-classed `rebalance` (lowest shed
        priority) — the mover's recurring polls must yield to tenant
        watch recomputes under saturation, per the migration-traffic
        contract."""
        return _watch_events_wire(self.engine, req["revision"])

    def _op_watch_gate(self, req: dict):
        types, use_exp = self.engine.watch_gate(
            req["resource_type"], req["name"])
        return {"types": sorted(types), "use_expiration": use_exp}

    def _op_revision(self, req: dict):
        return self.engine.revision

    def _op_failover_state(self, req: dict):
        """Replication-set introspection: NEVER role-gated — election
        probes and client-side failover resolution both depend on being
        able to ask a follower (or a deposed leader) what it is. A host
        with no coordinator is the leader of itself."""
        if self.failover_status is not None:
            return dict(self.failover_status())
        eng = self.engine
        return {"role": "leader",
                "term": int(getattr(eng, "term", 0) or 0),
                "revision": eng.revision, "peer_id": None, "lag": 0}

    def _op_load_status(self, req: dict):
        """Autoscaler signal probe (autoscale/controller.py): this
        host's admission occupancy (weighted in-flight cost over the
        AIMD limit) and mean engine check latency. Ungated
        control-plane like failover_state — a saturated host must
        still answer the probe that would relieve it."""
        occ = 0.0
        if self.admission is not None:
            st = self.admission.status()
            occ = max(0.0, min(1.0, float(st["inflight_cost"])
                               / max(1e-9, float(st["limit"]))))
        lat_ms = 0.0
        snap = metrics.hist_snapshot("engine_check_seconds")
        if snap and snap["n"]:
            lat_ms = snap["total"] / snap["n"] * 1e3
        return {"occupancy": occ, "check_ms": lat_ms}

    def _op_exists(self, req: dict):
        return self.engine.store.exists(_filter_from_dict(req["filter"]))

    # -- rebalance slice ops (scaleout/rebalance.py data plane) --------------

    # All idempotent, all admission-classed `rebalance` (lowest shed
    # priority): a live migration is cost-accounted and sheddable like
    # any tenant's bulk traffic.

    def _op_slice_read(self, req: dict):
        """Export the live namespaced tuples whose partition-key hash
        falls in the requested ``[lo, hi)`` ranges (or the replicated
        GLOBAL tuples with ``globals``), riding the npz codec as one
        binary frame. The revision is read BEFORE the row scan so the
        caller's catch-up replay covers any write that raced the scan
        (touch replays are idempotent: at-least-once)."""
        from ..persistence.codec import encode_bulk_cols

        ranges = [(int(lo), int(hi))
                  for lo, hi in (req.get("ranges") or ())]
        rev = int(self.engine.revision)
        rows = _slice_rows(self.engine, ranges,
                           bool(req.get("globals")))
        return BinaryResult({"slice": True, "revision": rev,
                             "n": len(rows)},
                            encode_bulk_cols(_rels_to_cols(rows)))

    def _op_slice_load(self, req: dict):
        """Idempotent slice import: the npz payload's rows apply as
        TOUCHes through the ordinary write path (validated, journaled,
        replicated, watch-logged — the merged sharded streams suppress
        these below the slice's cut revision)."""
        import base64

        from ..persistence.codec import decode_bulk_cols

        rels = _cols_to_rels(decode_bulk_cols(
            base64.b64decode(req["payload_b64"])))
        return {"revision": _apply_po2(self.engine, rels, "touch"),
                "rows": len(rels)}

    def _op_slice_apply(self, req: dict):
        """Catch-up replay: concrete touch/delete effects (already
        last-per-key deduped by the mover) through the ordinary write
        path."""
        ops = [WriteOp(o["op"], _rel_from_dict(o["rel"]))
               for o in req["ops"]]
        return {"revision": _apply_po2(self.engine, ops, None),
                "rows": len(ops)}

    def _op_slice_drop(self, req: dict):
        """GC after cutover: delete the moved rows — ordinary journaled
        deletes, idempotent, suppressed by the merged streams past the
        slice's cut revision."""
        ranges = [(int(lo), int(hi))
                  for lo, hi in (req.get("ranges") or ())]
        rows = _slice_rows(self.engine, ranges, False)
        return {"revision": _apply_po2(self.engine, rows, "delete"),
                "rows": len(rows)}

    def _op_traces(self, req: dict):
        """This host's recent kept-trace ring (diagnostics, never
        role-gated): cross-process deployments fetch their engine-side
        fragments through here — the proxy's /debug/traces merges them
        into its own traces by trace_id."""
        return tracer.recent(int(req.get("limit", 64)))

    # -- chaos control plane (flag-gated, test-only) -------------------------

    def _chaos_gate(self) -> None:
        if not self.allow_chaos:
            raise StoreError(
                "chaos ops are disabled on this host (boot with "
                "--enable-chaos-ops to accept fault schedules)")

    def _op_chaos_arm(self, req: dict):
        """Install a seeded fault schedule (chaos/schedule.py wire form)
        into this process's failpoint registry. Returns the schedule's
        digest so the campaign can pin that every process armed the
        byte-identical decision tables."""
        self._chaos_gate()
        from ..chaos.schedule import FaultSchedule

        sched = FaultSchedule.parse(req["schedule"])
        sched.arm()
        return {"armed": [s.site for s in sched.specs],
                "digest": sched.digest()}

    def _op_chaos_reset(self, req: dict):
        self._chaos_gate()
        failpoints.disable_all()
        return {"reset": True}

    def _op_chaos_status(self, req: dict):
        """Armed sites + trigger counts + this process's fault-history
        digest (deterministic for a given seed and request sequence)."""
        self._chaos_gate()
        return {"sites": failpoints.status(),
                "history": failpoints.history(),
                "history_digest": failpoints.history_digest()}

    # -- live schema migration control plane (migration/migrator.py) ---------
    # Admission-classed `rebalance` (admission/classes.py): a migration is
    # operator-driven bulk work, sheddable beneath tenant traffic. begin
    # is NOT idempotent (a replay would race the active-migration
    # refusal); status/cut/abort are.

    def _op_migrate_begin(self, req: dict):
        """Start a live migration to the supplied schema text. The diff
        classification (and a typed incompatible refusal) happens on this
        call's stack, before any state change, so the caller gets the
        refusal reasons synchronously; the phase machine then runs on a
        background thread of this host."""
        kwargs = {}
        for k in ("batch", "parity_samples"):
            if req.get(k) is not None:
                kwargs[k] = int(req[k])
        if req.get("hold_at_dual") is not None:
            kwargs["hold_at_dual"] = bool(req["hold_at_dual"])
        if req.get("backfill_pause") is not None:
            kwargs["backfill_pause"] = float(req["backfill_pause"])
        return self.engine.begin_schema_migration(
            req["schema_text"], wait=bool(req.get("wait")), **kwargs)

    def _op_migrate_status(self, req: dict):
        return self.engine.migration_status()

    def _op_migrate_cut(self, req: dict):
        """Release a ``hold_at_dual`` migration into its cut; idempotent:
        re-requesting the cut of an already-cut (or done) migration just
        reports its status."""
        return self.engine.cut_schema_migration(
            wait=bool(req.get("wait", True)))

    def _op_migrate_abort(self, req: dict):
        return self.engine.abort_schema_migration()


# -- client ------------------------------------------------------------------


class RemoteWatchStream:
    """Client end of a server-push watch subscription: a DEDICATED socket
    (never pooled) on which the engine host pushes event batches.
    ``next_batch()`` blocks until a batch, heartbeat (``[]``), or error.
    Zero steady-state request traffic — the reference's long-lived gRPC
    watch stream shape (pkg/authz/watch.go:29)."""

    def __init__(self, client: "RemoteEngine", from_revision: int):
        self._s = client._connect()
        # heartbeats arrive every PUSH_HEARTBEAT; anything slower means a
        # dead peer, not an idle stream
        self._s.settimeout(EngineServer.PUSH_HEARTBEAT * 3 + 5.0)
        msg = {"op": "watch_subscribe", "from_revision": from_revision}
        if client.token:
            msg["token"] = client.token
        try:
            self._s.sendall(_pack(msg))
            ack = self._read()
        except Exception:
            self._s.close()
            raise
        if isinstance(ack, tuple) or not ack.get("ok"):
            self._s.close()
            kind = ack.get("kind", "internal") if isinstance(ack, dict) \
                else "proto"
            err = ack.get("error", "") if isinstance(ack, dict) else ""
            raise _ERROR_KINDS.get(kind, RemoteEngineError)(err)
        self.revision = ack["result"]["revision"]

    def _read(self):
        return _read_frame_sync(self._s)

    def next_batch(self) -> list:
        """Blocks for the next pushed frame; ``[]`` is a liveness
        heartbeat. Raises the mapped error kind when the server ends the
        stream (e.g. trimmed watch history -> StoreError)."""
        frame = self._read()
        if not frame.get("ok"):
            raise _ERROR_KINDS.get(frame.get("kind", "internal"),
                                   RemoteEngineError)(frame.get("error", ""))
        events = [
            WatchEvent(d["revision"], d["operation"],
                       _rel_from_dict(d["rel"]))
            for d in frame.get("events", [])
        ]
        if events:
            self.revision = max(e.revision for e in events)
        return events

    def close(self) -> None:
        try:
            self._s.close()
        except OSError:
            pass


class RemoteInterner:
    """Client-side id→string view over a synced table; the sliver of the
    Interner surface the lookup paths touch."""

    __slots__ = ("_strings",)

    def __init__(self, strings: list[str]):
        self._strings = strings

    def __len__(self) -> int:
        return len(self._strings)

    def string(self, i: int) -> str:
        return self._strings[i]


class _StoreShim:
    """The sliver of Store the proxy touches remotely (idempotency-key and
    lock existence probes)."""

    def __init__(self, client: "RemoteEngine"):
        self._client = client

    def exists(self, f: RelationshipFilter) -> bool:
        return self._client._call("exists", filter=asdict(f))


class RemoteEngine:
    """Synchronous client with the Engine surface the proxy consumes.
    Thread-safe: a small connection pool lets concurrent request handlers
    (asyncio.to_thread workers) issue queries in parallel."""

    def __init__(self, host: str, port: int, token: Optional[str] = None,
                 timeout: float = 300.0, connect_timeout: float = 10.0,
                 pool_size: int = 8, ssl_context=None,
                 server_hostname: Optional[str] = None,
                 retries: int = 2,
                 retry_policy: Optional[RetryPolicy] = None,
                 breaker: Optional[CircuitBreaker] = None,
                 breaker_failure_threshold: int = 5,
                 breaker_reset_seconds: float = 10.0,
                 retry_budget: Optional[RetryBudget] = None):
        self.host = host
        self.port = port
        self.token = token
        # dependency identity for breaker state, /readyz reasons, metrics
        self.dependency = f"engine:{host}:{port}"
        # retries apply ONLY to _IDEMPOTENT_OPS (reads); transport
        # failures on writes surface after exactly one attempt
        self.retries = retries
        self.retry_policy = retry_policy or RetryPolicy(base=0.05, cap=1.0)
        # shared token-bucket retry allowance (utils/resilience.py
        # RetryBudget): one budget spans the WHOLE client stack above a
        # dependency (this client, a FailoverEngine's re-aims, a
        # planner's scatter re-issues), so sustained failure can't
        # multiply retries across layers. None = unbudgeted.
        self.retry_budget = retry_budget
        self.breaker = breaker or CircuitBreaker(
            self.dependency,
            failure_threshold=breaker_failure_threshold,
            reset_timeout=breaker_reset_seconds)
        # TLS to the engine host (utils/tlsconf.client_ssl_context);
        # server_hostname overrides the SNI/verification name when the
        # dialed address is not the certificate's name (e.g. an IP)
        self.ssl_context = ssl_context
        self.server_hostname = server_hostname or host
        # response wait: generous — the first query after a restore or a
        # declined write pays a graph compile measured in seconds at the
        # 10M-relationship scale, and a timed-out-but-completing server op
        # would otherwise be retried against a still-busy server
        self.timeout = timeout
        self.connect_timeout = connect_timeout
        self._pool: list[socket.socket] = []
        self._pool_lock = threading.Lock()
        self._pool_size = pool_size
        self.store = _StoreShim(self)
        # per-type id tables synced from the engine host (append-only
        # within a store epoch): type -> (epoch, [strings])
        self._ids_lock = threading.Lock()
        self._ids: dict[str, tuple[str, list[str]]] = {}

    # -- transport ----------------------------------------------------------

    def _connect(self, deadline: Optional[Deadline] = None
                 ) -> socket.socket:
        failpoints.hit("engine.connect")
        connect_budget = self.connect_timeout
        read_budget = self.timeout
        if deadline is not None:
            connect_budget = deadline.budget(self.connect_timeout)
            read_budget = deadline.budget(self.timeout)
        s = socket.create_connection((self.host, self.port),
                                     timeout=connect_budget)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        if self.ssl_context is not None:
            try:
                s = self.ssl_context.wrap_socket(
                    s, server_hostname=self.server_hostname)
            except Exception:
                s.close()
                raise
        s.settimeout(read_budget)
        return s

    def _acquire(self, deadline: Optional[Deadline] = None
                 ) -> tuple[socket.socket, bool]:
        """(live connection, fresh?): pooled sockets are liveness-probed
        first, so a stale one (engine host restarted, peer FIN pending) is
        replaced BEFORE any request bytes are written — retrying after a
        send could double-apply a write the server already processed.
        ``fresh`` tells the caller the server hasn't authenticated this
        connection yet (the pre-auth frame cap applies)."""
        while True:
            with self._pool_lock:
                if not self._pool:
                    break
                s = self._pool.pop()
            try:
                s.setblocking(False)
                try:
                    probe = s.recv(1)
                    alive = False  # b'' (FIN) or stray data: discard
                except (BlockingIOError, InterruptedError):
                    alive = True
                    probe = None
                except ssl.SSLWantReadError:
                    # TLS socket with no buffered record: alive (the
                    # plaintext path surfaces this case as BlockingIOError)
                    alive = True
                    probe = None
                if alive:
                    s.settimeout(self.timeout if deadline is None
                                 else deadline.budget(self.timeout))
                    return s, False
                del probe
            except OSError:
                pass
            s.close()
        return self._connect(deadline), True

    def _release(self, s: socket.socket) -> None:
        with self._pool_lock:
            if len(self._pool) < self._pool_size:
                self._pool.append(s)
                return
        s.close()

    def close(self) -> None:
        with self._pool_lock:
            for s in self._pool:
                s.close()
            self._pool.clear()

    def _call(self, op: str, **args):
        r = self._call_any(op, **args)
        if isinstance(r, tuple):
            raise RemoteEngineError(
                f"op {op!r} unexpectedly returned a binary frame")
        return r

    def _call_any(self, op: str, **args):
        """Like ``_call`` but passes binary responses through as a
        ``(meta, payload)`` tuple. Read ops retry transport failures
        (connect backoff included — a fresh connection is dialed per
        attempt once the pool is drained); every attempt is accounted to
        the endpoint's circuit breaker, and an open breaker fails fast
        with :class:`~..utils.resilience.BreakerOpen` before any
        connect."""
        msg = {"op": op, **args}
        if self.token:
            msg["token"] = self.token
        # span context rides the frame as a "tr" field (W3C traceparent)
        # so the engine host's spans stitch into this request's trace;
        # the rpc span brackets every attempt of this logical call —
        # under failover each endpoint tried appears as its own span
        rpc_span = tracer.begin("engine_rpc", op=op,
                                endpoint=self.dependency)
        if rpc_span is not None:
            msg["tr"] = rpc_span.traceparent()
        payload = _pack(msg)
        attempts = (self.retries + 1) if op in _IDEMPOTENT_OPS else 1
        delays = self.retry_policy.delays()
        if self.retry_budget is not None:
            self.retry_budget.on_attempt()
        # ONE wall-clock budget shared by every attempt: retries against
        # a host that accepts but never answers must not multiply the
        # caller's worst-case stall to attempts * read-timeout — the
        # self.timeout total is the bound either way (per-attempt socket
        # budgets are derived from what remains)
        deadline = Deadline.after(self.timeout)
        try:
            while True:
                attempts -= 1
                self.breaker.allow()
                start = time.monotonic()
                try:
                    resp = self._transact(payload, deadline)
                except TRANSPORT_ERRORS:
                    self.breaker.record_failure()
                    deadline.check(self.dependency)
                    if attempts <= 0:
                        raise
                    if self.retry_budget is not None \
                            and not self.retry_budget.allow():
                        # budget dry: surface the failure instead of
                        # joining a retry storm (the refusal is counted)
                        raise
                    metrics.counter("proxy_dependency_retries_total",
                                    dependency=self.dependency).inc()
                    time.sleep(min(next(delays), deadline.remaining()))
                    continue
                except BaseException:
                    # non-transport outcome (protocol/frame error,
                    # pre-auth rejection raised as an error kind): no
                    # verdict on the transport, but the admitted
                    # half-open probe slot must not leak or the breaker
                    # wedges open forever
                    self.breaker.release()
                    raise
                self.breaker.record_success()
                metrics.histogram("proxy_dependency_seconds",
                                  dependency=self.dependency).observe(
                    time.monotonic() - start)
                if isinstance(resp, tuple):
                    return resp  # (meta, payload) binary response
                if resp.get("ok"):
                    return resp.get("result")
                kind = resp.get("kind", "internal")
                err = resp.get("error", "")
                if kind == "admission":
                    # engine-host load shed: pre-dispatch by
                    # construction, so even writes are safe to retry
                    # after Retry-After. Its own dependency label keeps
                    # it distinguishable from proxy-side admission and
                    # from not_leader in the 503 metrics.
                    try:
                        retry_after = float(resp.get("retry_after") or 1.0)
                    except (TypeError, ValueError):
                        retry_after = 1.0
                    raise AdmissionRejected(
                        str(resp.get("class") or "?"), err,
                        retry_after=retry_after,
                        dependency="engine-admission")
                raise _ERROR_KINDS.get(kind, RemoteEngineError)(err)
        except BaseException as e:
            if rpc_span is not None:
                rpc_span.set("error", repr(e))
            raise
        finally:
            if rpc_span is not None:
                rpc_span.finish()

    def _transact(self, payload: bytes,
                  deadline: Optional[Deadline] = None):
        """ONE attempt: acquire a live connection, round-trip, release."""
        s, fresh = self._acquire(deadline)
        try:
            if fresh and self.token and len(payload) > MAX_FRAME_PREAUTH:
                # the server caps pre-auth frames; upgrade a fresh
                # connection with a cheap authenticated ping before the
                # big frame so bulk first-requests aren't dropped
                ping = self._round_trip(
                    s, _pack({"op": "revision", "token": self.token}))
                if not ping.get("ok"):
                    raise _ERROR_KINDS.get(
                        ping.get("kind", "internal"),
                        RemoteEngineError)(ping.get("error", ""))
            # no retry once bytes are on the wire for WRITES: the server
            # may have processed the op even if the connection then died,
            # and replaying a write would double-apply it (staleness is
            # handled by the pre-send liveness probe in _acquire). Reads
            # in _IDEMPOTENT_OPS retry at the _call_any layer.
            resp = self._round_trip(s, payload)
        except Exception:
            s.close()
            raise
        self._release(s)
        return resp

    def _round_trip(self, s: socket.socket, payload: bytes):
        s.sendall(payload)
        return self._read_response(s)

    def _read_response(self, s: socket.socket):
        """A JSON response dict, or (meta, payload) for binary frames."""
        failpoints.hit("engine.read")
        return _read_frame_sync(s)

    # -- engine surface ------------------------------------------------------

    def check(self, item: CheckItem, now: Optional[float] = None,
              context: Optional[dict] = None) -> bool:
        return self.check_bulk([item], now=now, context=context)[0]

    def check_bulk(self, items: list, now: Optional[float] = None,
                   context: Optional[dict] = None) -> list:
        # the request caveat context rides the frame as "ctx" (omitted
        # when empty so context-free frames stay byte-stable for older
        # hosts); the HOST's decision cache applies the context digest
        return self._call(
            "check_bulk", now=now, ctx=context or None,
            items=[[it.resource_type, it.resource_id, it.permission,
                    it.subject_type, it.subject_id, it.subject_relation]
                   for it in items])

    def lookup_subjects(self, resource_type: str, resource_id: str,
                        permission: str, subject_type: str,
                        subject_relation: Optional[str] = None,
                        now: Optional[float] = None,
                        context: Optional[dict] = None) -> list:
        return self._call(
            "lookup_subjects", resource_type=resource_type,
            resource_id=resource_id, permission=permission,
            subject_type=subject_type, subject_relation=subject_relation,
            now=now, ctx=context or None)

    def lookup_resources(self, resource_type: str, permission: str,
                         subject_type: str, subject_id: str,
                         subject_relation: Optional[str] = None,
                         now: Optional[float] = None,
                         context: Optional[dict] = None) -> list:
        """Materialize allowed id strings from the mask wire (one ~16KB
        frame + an amortized id-table delta, not a multi-MB JSON list);
        falls back to the JSON op against hosts predating lookup_mask."""
        try:
            mask, interner = self.lookup_resources_mask(
                resource_type, permission, subject_type, subject_id,
                subject_relation, now=now, context=context)
        except RemoteEngineError:
            return self._call(
                "lookup_resources", resource_type=resource_type,
                permission=permission, subject_type=subject_type,
                subject_id=subject_id, subject_relation=subject_relation,
                now=now, ctx=context or None)
        from .engine import mask_to_ids

        return mask_to_ids(mask, interner)

    def load_status(self) -> dict:
        """The host's autoscaler signals: admission occupancy [0, 1]
        and mean engine check latency in ms."""
        return self._call("load_status")

    def frontier_pairs(self) -> tuple:
        """The group's schema-derived frontier reference pairs."""
        return tuple((str(t), str(r))
                     for t, r in self._call("frontier_pairs"))

    def frontier_expand(self, descs, pairs,
                        now: Optional[float] = None,
                        context: Optional[dict] = None) -> set:
        """One frontier-exchange leg on this group; descriptors cross
        the wire in the canonical encode_frontier form (the planner's
        wire-bytes counters measure exactly these payloads)."""
        got = self._call(
            "frontier_expand",
            descs=[[t, i, r] for t, i, r in descs],
            pairs=[[t, r] for t, r in pairs],
            now=now, ctx=context or None)
        return {(str(t), str(i), None if r is None else str(r))
                for t, i, r in got}

    def lookup_resources_mask(self, resource_type: str, permission: str,
                              subject_type: str, subject_id: str,
                              subject_relation: Optional[str] = None,
                              now: Optional[float] = None,
                              context: Optional[dict] = None):
        """(bool mask over the type's object index space, id view) — the
        same vectorized surface the in-process engine exposes
        (engine.py lookup_resources_mask), over the binary wire."""
        import numpy as np

        for _ in range(3):
            r = self._call_any(
                "lookup_mask", resource_type=resource_type,
                permission=permission, subject_type=subject_type,
                subject_id=subject_id, subject_relation=subject_relation,
                now=now, ctx=context or None)
            if not isinstance(r, tuple):
                return None, None  # {"found": False}
            meta, payload = r
            mask = np.unpackbits(
                np.frombuffer(payload, dtype=np.uint8),
                count=meta["n"]).astype(bool)
            interner = self._sync_ids(resource_type, meta["gen"],
                                      meta["epoch"])
            if interner is not None:
                return mask, interner
            # epoch changed between the mask and the id sync (snapshot
            # restore on the host): mask indices and table disagree —
            # retry the whole query against the new epoch
        raise RemoteEngineError(
            "engine host epoch kept changing during lookup")

    def _sync_ids(self, rtype: str, gen: int,
                  epoch: str) -> Optional[RemoteInterner]:
        """Bring the cached id table for ``rtype`` up to ``gen`` within
        ``epoch``; None when the host reports a DIFFERENT epoch (caller
        retries). Only the missing tail rides the wire, and the table is
        SHARED (append-only within an epoch) — no per-lookup copy of a
        100k-entry list on the hot path."""
        with self._ids_lock:
            ent = self._ids.get(rtype)
            if ent is None or ent[0] != epoch:
                ent = (epoch, [])
                self._ids[rtype] = ent
            strings = ent[1]
            have = len(strings)
        if have < gen:
            r = self._call("object_ids", type=rtype, **{"from": have})
            if r["epoch"] != epoch:
                with self._ids_lock:
                    # the delta we fetched belongs to ANOTHER epoch's
                    # table; drop the cache so the retry resyncs from 0
                    if self._ids.get(rtype) is ent:
                        self._ids.pop(rtype, None)
                return None
            with self._ids_lock:
                # a concurrent fetcher may have extended past us: append
                # only the part of our delta it hasn't already covered
                cur = len(strings)
                if cur < have + len(r["ids"]):
                    strings.extend(r["ids"][cur - have:])
        return RemoteInterner(strings)

    def write_relationships(self, ops: list,
                            preconditions: list = ()) -> int:
        return self._call(
            "write_relationships",
            ops=[{"op": o.op, "rel": _rel_to_dict(o.rel)} for o in ops],
            preconditions=[{"filter": asdict(p.filter),
                            "must_exist": p.must_exist}
                           for p in preconditions])

    def delete_relationships(self, f: RelationshipFilter,
                             preconditions: list = ()) -> int:
        return self._call(
            "delete_relationships", filter=asdict(f),
            preconditions=[{"filter": asdict(p.filter),
                            "must_exist": p.must_exist}
                           for p in preconditions])

    def read_relationships(self, f: RelationshipFilter):
        return [_rel_from_dict(d)
                for d in self._call("read_relationships", filter=asdict(f))]

    def watch_since(self, revision: int) -> list:
        return [
            WatchEvent(d["revision"], d["operation"],
                       _rel_from_dict(d["rel"]))
            for d in self._call("watch_since", revision=revision)
        ]

    def watch_push_stream(self, from_revision: int) -> RemoteWatchStream:
        """Open a server-push event subscription (dedicated connection).
        The watch hub prefers this over polling ``watch_since`` — zero
        steady-state request traffic per engine (not per watcher)."""
        return RemoteWatchStream(self, from_revision)

    def watch_gate(self, resource_type: str, name: str
                   ) -> tuple[Optional[frozenset], bool]:
        """Schema-derived recompute gate for watches, fetched from the
        engine host (which owns the schema). (None, True) against an
        older host that lacks the op — callers then recompute
        unconditionally and keep the expiry tick (the safe direction)."""
        try:
            r = self._call("watch_gate", resource_type=resource_type,
                           name=name)
            return frozenset(r["types"]), bool(r["use_expiration"])
        except RemoteEngineError:
            return None, True

    # -- rebalance slice ops (idempotent mover data plane) -------------------

    def slice_read(self, ranges, want_globals: bool = False):
        """(src_revision, [Relationship...]) for the hash ranges — one
        npz binary frame, not a JSON row list."""
        from ..persistence.codec import decode_bulk_cols

        r = self._call_any("slice_read",
                           ranges=[[int(lo), int(hi)]
                                   for lo, hi in ranges],
                           **{"globals": bool(want_globals)})
        if not isinstance(r, tuple):
            raise RemoteEngineError(
                f"slice_read answered a non-binary frame: {r!r}")
        meta, payload = r
        return int(meta["revision"]), _cols_to_rels(
            decode_bulk_cols(payload))

    def slice_load(self, rels) -> int:
        """Idempotent TOUCH import of exported rows; returns the
        destination revision after the load."""
        import base64

        from ..persistence.codec import encode_bulk_cols

        r = self._call("slice_load", payload_b64=base64.b64encode(
            encode_bulk_cols(_rels_to_cols(list(rels)))).decode())
        return int(r["revision"])

    def slice_apply(self, ops) -> int:
        """Catch-up replay of concrete touch/delete effects."""
        r = self._call("slice_apply",
                       ops=[{"op": o.op, "rel": _rel_to_dict(o.rel)}
                            for o in ops])
        return int(r["revision"])

    def slice_drop(self, ranges) -> int:
        """Post-cutover GC of the moved rows; returns rows dropped."""
        r = self._call("slice_drop",
                       ranges=[[int(lo), int(hi)]
                               for lo, hi in ranges])
        return int(r["rows"])

    def slice_watch_since(self, revision: int) -> list:
        """The mover's catch-up poll: ``watch_since`` under the
        rebalance admission class; falls back to the tenant op against
        hosts predating it (same answer, old cost class)."""
        try:
            frames = self._call("slice_watch", revision=revision)
        except EngineInternalError:
            raise
        except RemoteEngineError:
            return self.watch_since(revision)
        return [
            WatchEvent(d["revision"], d["operation"],
                       _rel_from_dict(d["rel"]))
            for d in frames
        ]

    @property
    def revision(self) -> int:
        return self._call("revision")

    def failover_state(self) -> dict:
        """Replication role/term/revision of this endpoint (one
        single-attempt round trip — deliberately NOT in the idempotent
        retry set: resolution probes must answer fast about dead hosts,
        not burn a retry budget against them)."""
        return self._call("failover_state")

    # chaos control plane (single-attempt like failover_state: arming a
    # fault must not itself burn the retry budget it is about to test)

    def chaos_arm(self, schedule_doc: dict) -> dict:
        """Arm a fault schedule on the host (requires the host's
        --enable-chaos-ops); returns {armed, digest}."""
        return self._call("chaos_arm", schedule=schedule_doc)

    def chaos_reset(self) -> dict:
        return self._call("chaos_reset")

    def chaos_status(self) -> dict:
        return self._call("chaos_status")

    def fetch_traces(self, limit: int = 64) -> list:
        """The engine host's recent kept-trace ring (trace fragments
        sharing the proxy's trace_ids); [] against hosts predating the
        op — trace retrieval is diagnostics, never an error."""
        try:
            return self._call("traces", limit=limit) or []
        except RemoteEngineError:
            return []

    # live schema migration control plane (migration/migrator.py)

    def migrate_begin(self, schema_text: str, *,
                      hold_at_dual: Optional[bool] = None,
                      batch: Optional[int] = None,
                      backfill_pause: Optional[float] = None,
                      parity_samples: Optional[int] = None,
                      wait: bool = False) -> dict:
        """Begin a live schema migration on the host. Single-attempt (NOT
        idempotent: a replay would race the host's single-active-migration
        refusal); an incompatible change surfaces as the host's typed
        schema error (``SchemaViolation``) before any state change."""
        return self._call(
            "migrate_begin", schema_text=schema_text,
            hold_at_dual=hold_at_dual, batch=batch,
            backfill_pause=backfill_pause,
            parity_samples=parity_samples, wait=wait)

    def migrate_status(self) -> Optional[dict]:
        return self._call("migrate_status")

    def migrate_cut(self, wait: bool = True) -> dict:
        """Release a ``hold_at_dual`` migration into its cut
        (idempotent: a coordinator may retry it)."""
        return self._call("migrate_cut", wait=wait)

    def migrate_abort(self) -> dict:
        return self._call("migrate_abort")


# -- client-side engine failover ----------------------------------------------


class _PrimaryBreakerView:
    """The breaker surface (/readyz reasons, dual-write fast-fail) of
    whichever endpoint is CURRENTLY primary. A dead former leader's
    permanently-open breaker must not keep a successfully failed-over
    replica unready forever."""

    def __init__(self, fe: "FailoverEngine"):
        self._fe = fe

    @property
    def dependency(self) -> str:
        return self._fe._primary().breaker.dependency

    def open_reason(self):
        return self._fe._primary().breaker.open_reason()

    def check_open(self) -> None:
        self._fe._primary().breaker.check_open()


class _FailoverStoreShim:
    """The sliver of Store the proxy touches, over the failover client."""

    def __init__(self, fe: "FailoverEngine"):
        self._fe = fe

    def exists(self, f: RelationshipFilter) -> bool:
        return self._fe._invoke(lambda c: c.store.exists(f))


class FailoverEngine:
    """A RemoteEngine over a LIST of engine endpoints (``--engine-endpoint
    tcp://h1:p1,h2:p2,...``): every call goes to the current primary;
    when the primary stops answering — transport death, open breaker,
    exhausted deadline, or a role-gated ``not_leader`` rejection — the
    client re-resolves by probing every endpoint's ``failover_state``
    and re-aims at the leader with the highest term.

    Retry discipline under failover mirrors the single-endpoint client's:
    reads re-issue against the new primary transparently; writes re-issue
    ONLY when the failed attempt provably never dispatched (a not_leader
    rejection or an open breaker) — a write that died mid-transport may
    have been applied and surfaces its error instead. While no leader is
    reachable, calls raise :class:`~..utils.resilience.
    DependencyUnavailable`, which the authz middleware maps to the
    fail-closed kube 503 + Retry-After."""

    def __init__(self, endpoints: list, token: Optional[str] = None,
                 probe_timeout: float = 5.0,
                 resolve_deadline: float = 30.0, **client_kw):
        if not endpoints:
            raise RemoteEngineError("failover engine needs >= 1 endpoint")
        self.endpoints = [(h, int(p)) for h, p in endpoints]
        self.token = token
        # ONE retry budget spans the whole failover stack: per-endpoint
        # transport retries AND this layer's re-issues draw from the
        # same bucket, so a dead/browned-out set can't amplify load by
        # layers × retries (utils/resilience.py RetryBudget)
        self.retry_budget = client_kw.get("retry_budget")
        self._clients = [RemoteEngine(h, p, token=token, **client_kw)
                         for h, p in self.endpoints]
        # dedicated probe clients: short budgets, single attempt, and a
        # breaker that never opens — resolution must stay able to ask a
        # freshly-recovered host "are you the leader yet?" even after
        # thousands of failed probes. NO retry budget: probes are how
        # resolution heals, and their deposits/withdrawals would distort
        # the data-path budget.
        probe_kw = dict(client_kw)
        probe_kw.pop("breaker", None)
        probe_kw.pop("retry_budget", None)
        probe_kw["timeout"] = probe_timeout
        probe_kw["connect_timeout"] = min(
            probe_timeout, client_kw.get("connect_timeout", probe_timeout))
        probe_kw["retries"] = 0
        self._probes = [
            RemoteEngine(h, p, token=token,
                         breaker=CircuitBreaker(
                             f"engine-probe:{h}:{p}",
                             failure_threshold=1 << 30),
                         **probe_kw)
            for h, p in self.endpoints]
        self._resolve_deadline = resolve_deadline
        self._lock = threading.Lock()
        self._primary_idx = 0
        self._last_status: dict = {}
        # resolution singleflight: during a failover every blocked
        # request thread wants a resolution pass; one prober at a time
        # runs it and waiters piggyback on its outcome instead of
        # stampeding N-endpoint probe storms at the surviving host
        self._resolve_flight = threading.Lock()
        self._resolve_gen = 0
        self._resolve_ok = False
        # monotonic term floor: once this client has SEEN term T, no
        # endpoint claiming leadership at a lower term is ever followed
        # again — a deposed leader partitioned away from its peers still
        # answers "leader", and aiming reads at its fenced-off state
        # would serve stale verdicts (fail closed instead)
        self._max_term = 0
        self.dependency = "engine-failover:" + ",".join(
            f"{h}:{p}" for h, p in self.endpoints)
        self.breaker = _PrimaryBreakerView(self)
        self.store = _FailoverStoreShim(self)

    def _primary(self) -> RemoteEngine:
        with self._lock:
            return self._clients[self._primary_idx]

    # -- resolution ----------------------------------------------------------

    def _resolve(self) -> bool:
        """One resolution pass, singleflighted: callers that arrive
        while another thread is mid-pass wait for IT and share its
        outcome rather than launching a redundant probe storm."""
        gen = self._resolve_gen
        with self._resolve_flight:
            if self._resolve_gen != gen:
                return self._resolve_ok  # piggyback on the finished pass
            ok = self._resolve_once()
            self._resolve_gen += 1
            self._resolve_ok = ok
            return ok

    def _resolve_once(self) -> bool:
        """Probe every endpoint once and re-aim at the best reachable
        LEADER (highest term; ties by list order). Probing happens
        OUTSIDE the primary-index lock — healthy callers reading the
        index must not stall behind a resolution pass's connect
        timeouts."""
        t0 = time.monotonic()
        states = []
        for i, probe in enumerate(self._probes):
            try:
                st = probe.failover_state()
            except Exception as e:  # noqa: BLE001 - unreachable peer
                log.debug("failover probe %s:%s failed: %s",
                          *self.endpoints[i], e)
                continue
            states.append((i, st))
            self._max_term = max(self._max_term,
                                 int(st.get("term", 0) or 0))
        best = None
        for i, st in states:
            if st.get("role") != "leader":
                continue
            term = int(st.get("term", 0) or 0)
            if term < self._max_term:
                # a reachable-but-deposed leader (partitioned from its
                # peers, so it never demoted): following it would serve
                # its fenced-off lineage — stay unresolved (fail closed)
                log.warning(
                    "ignoring %s:%s claiming leadership at deposed term "
                    "%d (highest seen: %d)", *self.endpoints[i], term,
                    self._max_term)
                continue
            key = (-term, i)
            if best is None or key < best[0]:
                best = (key, i, st)
        if best is None:
            return False
        _, idx, st = best
        with self._lock:
            old = self._primary_idx
            self._primary_idx = idx
            self._last_status = dict(st)
        if idx != old:
            metrics.counter("failover_total").inc()
            metrics.histogram("failover_duration_seconds").observe(
                time.monotonic() - t0)
            log.warning(
                "engine failover: primary %s:%s -> %s:%s (term %s)",
                *self.endpoints[old], *self.endpoints[idx],
                st.get("term"))
        return True

    def _invoke(self, call, write: bool = False):
        c = self._primary()
        try:
            return call(c)
        except AdmissionRejected:
            # a healthy-but-overloaded leader shed the op: re-aiming at a
            # follower cannot help (it would only answer not_leader), and
            # a probe storm would add load to exactly the wrong host —
            # surface the shed (503 + Retry-After) immediately
            raise
        except NotLeaderError as e:
            cause, retry_ok = e, True  # rejected BEFORE dispatch
        except DependencyUnavailable as e:
            # BreakerOpen = no attempt reached the wire (safe even for a
            # write); an exhausted deadline may have dispatched
            from ..utils.resilience import BreakerOpen

            cause, retry_ok = e, (not write) or isinstance(e, BreakerOpen)
        except TRANSPORT_ERRORS as e:
            cause, retry_ok = e, not write
        if not retry_ok:
            # the outcome cannot change by waiting (the write MAY have
            # been applied): kick ONE resolution pass so the system
            # heals for subsequent calls, then surface the truth now —
            # never park a kube write for a whole election window just
            # to raise the same error
            self._resolve()
            raise cause
        # re-resolve (bounded by resolve_deadline — an election takes
        # heartbeat-timeout + promotion time) and re-issue. The re-issue
        # is a RETRY of the logical op: it draws from the shared budget,
        # so a whole fleet re-aiming at a browned-out set stays bounded.
        if self.retry_budget is not None and not self.retry_budget.allow():
            raise DependencyUnavailable(
                self.dependency,
                f"retry budget for {self.dependency} exhausted during "
                "failover re-aim",
                retry_after=1.0) from cause
        deadline = time.monotonic() + self._resolve_deadline
        while not self._resolve():
            if time.monotonic() >= deadline:
                raise DependencyUnavailable(
                    self.dependency,
                    "no engine replication leader reachable among "
                    f"{len(self.endpoints)} endpoints "
                    "(failover in progress?)",
                    retry_after=1.0) from cause
            time.sleep(0.2)
        return call(self._primary())

    # -- engine surface (the slice the proxy consumes) -----------------------

    def check(self, item: CheckItem, now: Optional[float] = None,
              context: Optional[dict] = None) -> bool:
        return self.check_bulk([item], now=now, context=context)[0]

    def check_bulk(self, items: list, now: Optional[float] = None,
                   context: Optional[dict] = None) -> list:
        return self._invoke(lambda c: c.check_bulk(items, now=now,
                                                   context=context))

    def lookup_subjects(self, resource_type: str, resource_id: str,
                        permission: str, subject_type: str,
                        subject_relation: Optional[str] = None,
                        now: Optional[float] = None,
                        context: Optional[dict] = None) -> list:
        return self._invoke(lambda c: c.lookup_subjects(
            resource_type, resource_id, permission, subject_type,
            subject_relation, now=now, context=context))

    def lookup_resources(self, resource_type: str, permission: str,
                         subject_type: str, subject_id: str,
                         subject_relation: Optional[str] = None,
                         now: Optional[float] = None,
                         context: Optional[dict] = None) -> list:
        return self._invoke(lambda c: c.lookup_resources(
            resource_type, permission, subject_type, subject_id,
            subject_relation, now=now, context=context))

    def lookup_resources_mask(self, resource_type: str, permission: str,
                              subject_type: str, subject_id: str,
                              subject_relation: Optional[str] = None,
                              now: Optional[float] = None,
                              context: Optional[dict] = None):
        return self._invoke(lambda c: c.lookup_resources_mask(
            resource_type, permission, subject_type, subject_id,
            subject_relation, now=now, context=context))

    def load_status(self) -> dict:
        return self._invoke(lambda c: c.load_status())

    def frontier_pairs(self) -> tuple:
        return self._invoke(lambda c: c.frontier_pairs())

    def frontier_expand(self, descs, pairs,
                        now: Optional[float] = None,
                        context: Optional[dict] = None) -> set:
        return self._invoke(lambda c: c.frontier_expand(
            descs, pairs, now=now, context=context))

    def write_relationships(self, ops: list,
                            preconditions: list = ()) -> int:
        return self._invoke(
            lambda c: c.write_relationships(ops, preconditions),
            write=True)

    def delete_relationships(self, f: RelationshipFilter,
                             preconditions: list = ()) -> int:
        return self._invoke(
            lambda c: c.delete_relationships(f, preconditions),
            write=True)

    def read_relationships(self, f: RelationshipFilter):
        return self._invoke(lambda c: c.read_relationships(f))

    def watch_since(self, revision: int) -> list:
        return self._invoke(lambda c: c.watch_since(revision))

    def watch_push_stream(self, from_revision: int) -> RemoteWatchStream:
        return self._invoke(lambda c: c.watch_push_stream(from_revision))

    def watch_gate(self, resource_type: str, name: str):
        return self._invoke(lambda c: c.watch_gate(resource_type, name))

    # rebalance slice ops: idempotent by construction, so they follow
    # the READ re-issue discipline — after a transport death or a
    # not_leader rejection (a SIGKILL'd group leader mid-copy), the
    # re-aimed re-issue converges instead of double-applying
    def slice_read(self, ranges, want_globals: bool = False):
        return self._invoke(
            lambda c: c.slice_read(ranges, want_globals=want_globals))

    def slice_load(self, rels) -> int:
        return self._invoke(lambda c: c.slice_load(rels))

    def slice_apply(self, ops) -> int:
        return self._invoke(lambda c: c.slice_apply(ops))

    def slice_drop(self, ranges) -> int:
        return self._invoke(lambda c: c.slice_drop(ranges))

    def slice_watch_since(self, revision: int) -> list:
        return self._invoke(lambda c: c.slice_watch_since(revision))

    # migration control plane: begin follows the WRITE discipline (no
    # re-issue after an ambiguous death — a replay races the host's
    # single-active-migration refusal); status/cut/abort are
    # level-triggered and re-aim like reads
    def migrate_begin(self, schema_text: str, **kw) -> dict:
        return self._invoke(lambda c: c.migrate_begin(schema_text, **kw),
                            write=True)

    def migrate_status(self) -> Optional[dict]:
        return self._invoke(lambda c: c.migrate_status())

    def migrate_cut(self, wait: bool = True) -> dict:
        return self._invoke(lambda c: c.migrate_cut(wait=wait))

    def migrate_abort(self) -> dict:
        return self._invoke(lambda c: c.migrate_abort())

    def chaos_arm(self, schedule_doc: dict) -> dict:
        """Arm a fault schedule on EVERY reachable endpoint of the set
        (a campaign targets the whole replication group — the fault must
        survive a failover). Returns {endpoint: result-or-error}."""
        out: dict = {}
        for c in self._clients:
            try:
                out[c.dependency] = c.chaos_arm(schedule_doc)
            except Exception as e:  # noqa: BLE001 - report per endpoint
                out[c.dependency] = {"error": repr(e)}
        return out

    def chaos_reset(self) -> dict:
        out: dict = {}
        for c in self._clients:
            try:
                out[c.dependency] = c.chaos_reset()
            except Exception as e:  # noqa: BLE001 - report per endpoint
                out[c.dependency] = {"error": repr(e)}
        return out

    def fetch_traces(self, limit: int = 64) -> list:
        """Trace fragments from EVERY reachable endpoint (a re-aimed
        request leaves spans on more than one host); per-endpoint
        failures contribute nothing rather than failing diagnostics."""
        out: list = []
        for c in self._clients:
            try:
                out.extend(c.fetch_traces(limit))
            except Exception:  # noqa: BLE001 - diagnostics best-effort
                continue
        return out

    @property
    def revision(self) -> int:
        return self._invoke(lambda c: c.revision)

    def _probe_primary(self) -> Optional[dict]:
        c = self._primary()
        if c.breaker.open_reason() is not None:
            return None  # known-dead: don't stack a connect timeout
        try:
            st = self._probes[self._clients.index(c)].failover_state()
        except Exception:  # noqa: BLE001 - unreachable primary
            return None
        term = int(st.get("term", 0) or 0)
        self._max_term = max(self._max_term, term)
        if st.get("role") != "leader" or term < self._max_term:
            return None  # demoted, or a deposed straggler still leading
        with self._lock:
            self._last_status = dict(st)
        return st

    def replication_status(self) -> dict:
        """{role, term, lag} of the current primary, for /readyz. When
        the primary looks dead or demoted, attempt a resolution pass
        first: an IDLE proxy has no data traffic to trigger _invoke's
        re-resolve, and without this its /readyz would stay unready
        forever after a failover — unreadiness would then keep the
        traffic away that could have healed it (the same trap the
        breaker's probe-eligible /readyz rule avoids)."""
        st = self._probe_primary()
        if st is None and self._resolve():
            st = self._probe_primary()
        if st is None:
            return {"role": "electing",
                    "term": self._last_status.get("term"), "lag": None}
        return {"role": st.get("role"), "term": st.get("term"),
                "lag": st.get("lag")}

    def close(self) -> None:
        for c in self._clients + self._probes:
            c.close()


def parse_bool_flag(v) -> bool:
    """argparse type for ``--flag``, ``--flag=true`` and ``--flag=false``
    (kube-style boolean flags; a copy of the JAX package's
    proxy/options.py ``parse_bool_flag``)."""
    import argparse

    if isinstance(v, bool):
        return v
    s = str(v).strip().lower()
    if s in ("1", "true", "t", "yes", "y", "on"):
        return True
    if s in ("0", "false", "f", "no", "n", "off"):
        return False
    raise argparse.ArgumentTypeError(f"expected a boolean, got {v!r}")


# flags of the JAX engine host that need a module the port does not have
# yet: (flag, ROADMAP item, what brings it)
_REFUSED_FLAGS = (
    ("--engine-mesh", "A.5", "device meshes"),
    ("--distributed", "A.5", "multi-host serving"),
    # the lockstep follower of a --distributed set (a --peers follower
    # dials its leader by itself)
    ("--mirror-leader", "A.5", "multi-host serving"),
)


def main(argv=None) -> int:
    """Standalone engine host: ``python -m
    spicedb_kubeapi_proxy_tpu_torch.engine.remote --bootstrap schema.yaml
    --bind-port 50051`` — the GPU-owning process proxies connect to (the
    JAX proxy too: ``--engine-endpoint tcp://host:50051``)."""
    import argparse
    import signal

    ap = argparse.ArgumentParser(prog="sdbkp-engine-torch",
                                 description="GPU engine host")
    ap.add_argument("--bootstrap", action="append", default=[],
                    help="schema/relationships bootstrap YAML (repeatable)")
    ap.add_argument("--bind-host", default="127.0.0.1")
    ap.add_argument("--bind-port", type=int, default=50051)
    ap.add_argument("--token", help="shared bearer token")
    ap.add_argument("--device", default="cuda",
                    help="torch device the engine runs on (default cuda; "
                         "a missing card is an error, never a fallback — "
                         "pass cpu to run on the CPU explicitly)")
    # transport security (reference remote-endpoint flag shape,
    # options.go:325-369): TLS is the default posture — serving requires
    # a cert/key pair, and plaintext requires an explicit opt-out
    ap.add_argument("--tls-cert-file",
                    help="serving certificate (PEM); enables TLS")
    ap.add_argument("--tls-key-file",
                    help="serving private key (PEM)")
    ap.add_argument("--tls-client-ca-file",
                    help="require client certificates signed by this CA "
                         "(mutual TLS, on top of the token)")
    ap.add_argument("--engine-insecure", action="store_true",
                    help="serve PLAINTEXT TCP (and dial the mirror "
                         "leader plaintext) — tokens and relationships "
                         "transit in the clear; never use across hosts")
    ap.add_argument("--mirror-ca-file",
                    help="(follower) CA bundle for verifying the mirror "
                         "leader's certificate (default: system store)")
    ap.add_argument("--mirror-skip-verify-ca", action="store_true",
                    help="(follower) TLS to the leader without "
                         "certificate verification")
    ap.add_argument("--snapshot-path",
                    help="relationship-store snapshot: loaded at boot if "
                         "present, saved on graceful shutdown (superseded "
                         "by --data-dir, which also survives SIGKILL)")
    ap.add_argument("--data-dir",
                    help="durable persistence directory (persistence/): "
                         "write-ahead log + snapshot checkpoints; crash "
                         "recovery replays the WAL tail at boot. Unset = "
                         "in-memory store")
    ap.add_argument("--wal-fsync", default="interval:100",
                    help="WAL fsync policy: always | interval:<ms> | off "
                         "(default interval:100)")
    ap.add_argument("--checkpoint-wal-bytes", type=int, default=64 << 20,
                    help="snapshot-checkpoint the store once this many "
                         "WAL bytes accumulate since the last checkpoint")
    ap.add_argument("--checkpoint-wal-records", type=int, default=50000,
                    help="...or this many WAL records, whichever first")
    ap.add_argument("--checkpoint-keep", type=int, default=2,
                    help="snapshot generations to retain (the WAL is "
                         "pruned only up to the OLDEST kept one, so "
                         "recovery can fall back a generation)")
    ap.add_argument("--peers",
                    help="replicated-set mode with AUTOMATIC leader "
                         "failover: comma-separated host:port of EVERY "
                         "engine host in the set, in peer-id order")
    ap.add_argument("--peer-id", type=int, default=0,
                    help="this process's index into --peers")
    ap.add_argument("--mirror-heartbeat-seconds", type=float, default=2.0,
                    help="(--peers) leader heartbeat cadence on the "
                         "mirror stream; followers detect a dead leader "
                         "within ~3x this")
    ap.add_argument("--mirror-heartbeat-timeout", type=float, default=0.0,
                    help="(--peers) follower's dead-leader window "
                         "(0 = 3x heartbeat + 1s)")
    ap.add_argument("--replication-timeout", type=float, default=10.0,
                    help="(--peers) how long an acked write waits for "
                         "follower acknowledgement before the laggard "
                         "is dropped to catch-up")
    ap.add_argument("--min-sync-replicas", type=int, default=0,
                    help="(--peers) durability floor: with fewer live "
                         "followers than this, writes FAIL CLOSED "
                         "instead of acking unreplicated (0 = keep "
                         "serving when the last follower dies — "
                         "availability over redundancy)")
    ap.add_argument("--failover-boot-grace", type=float, default=20.0,
                    help="(--peers) boot-time wait for the rest of the "
                         "set before electing from partial visibility")
    ap.add_argument("--lookup-batch-window", type=float, default=0.0,
                    help="fuse concurrent lookup_mask requests (across "
                         "ALL connected proxies) into shared device "
                         "dispatches, holding each for at most this many "
                         "seconds (0 = off)")
    ap.add_argument("--authz-cache", type=parse_bool_flag, nargs="?",
                    const=True, default=True, metavar="BOOL",
                    help="revision-keyed decision cache + singleflight: "
                         "identical checks/lookups at an unchanged "
                         "revision serve host-side, shared across ALL "
                         "connected proxy replicas (default on)")
    ap.add_argument("--authz-cache-size", type=int, default=65536,
                    help="max cached decisions (LRU entries)")
    ap.add_argument("--authz-cache-mask-bytes", type=int,
                    default=256 << 20,
                    help="resident lookup-mask byte budget")
    ap.add_argument("--delta-capacity", type=int, default=4096,
                    help="delta-overlay slots per compiled graph (size to "
                         "the write burst one compaction interval must "
                         "absorb)")
    ap.add_argument("--compact-threshold", type=float, default=0.75,
                    help="overlay-occupancy fraction that wakes the "
                         "background compactor; a full overlay sheds "
                         "writes with a bounded Retry-After (rides the "
                         "kind='admission' frame — breakers stay "
                         "closed) instead of stalling reads on a "
                         "synchronous recompile (0 disables)")
    ap.add_argument("--admission", type=parse_bool_flag, nargs="?",
                    const=True, default=False, metavar="BOOL",
                    help="admission control (admission/): cost-classed, "
                         "per-tenant (= proxy replica) fair queueing with "
                         "an adaptive concurrency limit and priority load "
                         "shedding in front of the dispatch pool "
                         "(default off)")
    ap.add_argument("--admission-initial-concurrency", type=float,
                    default=32.0,
                    help="adaptive limiter's starting weighted-cost limit")
    ap.add_argument("--admission-min-concurrency", type=float, default=4.0)
    ap.add_argument("--admission-max-concurrency", type=float,
                    default=512.0)
    ap.add_argument("--admission-tenant-rate", type=float, default=50.0,
                    help="per-tenant fair-share refill (cost units/s)")
    ap.add_argument("--admission-tenant-burst", type=float, default=100.0,
                    help="per-tenant debt cap (cost units a storm is "
                         "remembered for)")
    ap.add_argument("--admission-tenant-queue-depth", type=int, default=32)
    ap.add_argument("--admission-queue-depth", type=int, default=256,
                    help="global queued-request bound; past it the "
                         "lowest-priority class sheds first")
    ap.add_argument("--admission-queue-timeout", type=float, default=1.0,
                    help="max seconds a request may queue before it is "
                         "shed (503 + Retry-After, never a hang)")
    ap.add_argument("--trace-sample", type=float, default=0.1,
                    help="tail-sampling keep probability for engine-host "
                         "trace fragments (error/slow ops always kept; "
                         "0 disables span recording entirely)")
    ap.add_argument("--trace-slow-ms", type=float, default=250.0,
                    help="ops at or above this duration are always kept "
                         "by tail sampling")
    ap.add_argument("--enable-chaos-ops", action="store_true",
                    help="TEST ONLY: accept chaos_arm/chaos_reset/"
                         "chaos_status wire ops that install seeded "
                         "fault schedules (error/drop/delay/crash) into "
                         "this process's failpoint registry — how the "
                         "chaos campaign drives deterministic faults on "
                         "subprocess engine hosts. Never enable in "
                         "production")
    for flag, item, what in _REFUSED_FLAGS:
        ap.add_argument(flag, help=f"not in the PyTorch port yet: {what} "
                                   f"lands with ROADMAP {item} (refused)")
    args = ap.parse_args(argv)
    for flag, item, what in _REFUSED_FLAGS:
        v = getattr(args, flag[2:].replace("-", "_"))
        if v is not None:
            ap.error(f"{flag} is not supported by the PyTorch engine host: "
                     f"{what} lands in the port with ROADMAP {item}")
    logging.basicConfig(level=logging.INFO)
    log.info("engine host starting (pid %d)", os.getpid())
    if not 0.0 <= args.trace_sample <= 1.0:
        ap.error("--trace-sample must be in [0, 1]")
    tracer.configure(sample=args.trace_sample,
                     slow_ms=args.trace_slow_ms)

    from ..utils.tlsconf import (
        TLSConfigError,
        client_ssl_context,
        server_ssl_context,
    )

    if bool(args.tls_cert_file) != bool(args.tls_key_file):
        ap.error("--tls-cert-file and --tls-key-file go together")
    if args.engine_insecure and args.tls_cert_file:
        ap.error("--engine-insecure and --tls-cert-file are mutually "
                 "exclusive")
    from .compaction import validate_overlay_config

    try:
        # shared validator: clean flag error at boot, not a constructor
        # traceback
        validate_overlay_config(args.delta_capacity,
                                args.compact_threshold)
    except ValueError as e:
        ap.error(str(e))
    if args.admission:
        # shared validator (admission.validate_config): misconfiguration
        # is a clean flag error at boot, not a raw constructor traceback
        # or a silently-degenerate fair queue (rate 0 never forgives debt)
        from ..admission import validate_config

        try:
            validate_config(
                args.admission_initial_concurrency,
                args.admission_min_concurrency,
                args.admission_max_concurrency,
                args.admission_tenant_rate, args.admission_tenant_burst,
                args.admission_tenant_queue_depth,
                args.admission_queue_depth, args.admission_queue_timeout)
        except ValueError as e:
            ap.error(str(e))
    peers = None
    if args.peers:
        from ..parallel.failover import FailoverError, parse_peers

        try:
            peers = parse_peers(args.peers)
        except FailoverError as e:
            ap.error(str(e))
        if not 0 <= args.peer_id < len(peers):
            ap.error(f"--peer-id {args.peer_id} out of range for "
                     f"{len(peers)} peers")
        if args.mirror_heartbeat_seconds <= 0:
            ap.error("--mirror-heartbeat-seconds must be > 0")
    server_ssl = None
    if args.tls_cert_file:
        try:
            server_ssl = server_ssl_context(args.tls_cert_file,
                                            args.tls_key_file,
                                            args.tls_client_ca_file)
        except TLSConfigError as e:
            ap.error(str(e))
    elif not args.engine_insecure:
        ap.error("refusing to serve plaintext TCP: pass --tls-cert-file/"
                 "--tls-key-file, or --engine-insecure to opt out "
                 "explicitly (the token and every relationship would "
                 "transit in the clear)")
    mirror_ssl = None
    if not args.engine_insecure:
        try:
            mirror_ssl = client_ssl_context(
                args.mirror_ca_file, args.mirror_skip_verify_ca)
        except TLSConfigError as e:
            ap.error(str(e))
    if args.data_dir and args.snapshot_path:
        ap.error("--data-dir and --snapshot-path are mutually exclusive "
                 "(the data dir owns snapshots AND the write-ahead log)")
    from ..persistence.wal import WalError, parse_fsync_policy

    if args.data_dir:
        try:
            parse_fsync_policy(args.wal_fsync)
        except WalError as e:
            ap.error(str(e))
    from ..device import resolve_device

    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        ap.error(str(e))
    bootstrap = "\n---\n".join(open(f).read() for f in args.bootstrap) or None
    engine = Engine(bootstrap=bootstrap, device=device,
                    delta_capacity=args.delta_capacity)
    log.info("engine on %s", device)
    if args.compact_threshold > 0:
        engine.enable_compaction(args.compact_threshold)
        log.info("overlay compaction on: capacity %d, threshold %.2f",
                 args.delta_capacity, args.compact_threshold)
    persistence = None
    if args.data_dir:
        persistence = engine.enable_persistence(
            args.data_dir, wal_fsync=args.wal_fsync,
            checkpoint_wal_bytes=args.checkpoint_wal_bytes,
            checkpoint_wal_records=args.checkpoint_wal_records,
            checkpoint_keep=args.checkpoint_keep)
        log.info("persistence: %s (recovered revision %d, %d WAL "
                 "records replayed)", args.data_dir,
                 persistence.recovery.revision,
                 persistence.recovery.replayed_records)
        # boot crash matrix for a live schema migration killed mid-flight
        # (migration/migrator.py): no persisted cut -> clean abort, cut
        # persisted -> finish the cutover under the new schema
        mig = engine.recover_schema_migration()
        if mig is not None:
            log.info("schema migration record recovered: %s (phase %s)",
                     mig.get("action"), mig.get("phase"))
    if args.lookup_batch_window > 0:
        engine.enable_lookup_batching(args.lookup_batch_window)
    if args.authz_cache:
        engine.enable_decision_cache(
            max_entries=args.authz_cache_size,
            max_mask_bytes=args.authz_cache_mask_bytes)
    if engine.load_snapshot_if_exists(args.snapshot_path):
        log.info("loaded snapshot %s (revision %d)", args.snapshot_path,
                 engine.revision)
    admission = None
    if args.admission:
        from ..admission import AdmissionController

        admission = AdmissionController(
            initial_concurrency=args.admission_initial_concurrency,
            min_concurrency=args.admission_min_concurrency,
            max_concurrency=args.admission_max_concurrency,
            tenant_rate=args.admission_tenant_rate,
            tenant_burst=args.admission_tenant_burst,
            tenant_depth=args.admission_tenant_queue_depth,
            global_depth=args.admission_queue_depth,
            queue_timeout=args.admission_queue_timeout,
            dependency="engine-admission")
        log.info("admission control on: limit %.0f (%.0f..%.0f), queue "
                 "%d/%d, timeout %.2fs",
                 args.admission_initial_concurrency,
                 args.admission_min_concurrency,
                 args.admission_max_concurrency,
                 args.admission_tenant_queue_depth,
                 args.admission_queue_depth,
                 args.admission_queue_timeout)
    if args.enable_chaos_ops:
        log.warning("chaos ops ENABLED: this host accepts wire-armed "
                    "fault schedules (test topologies only)")
    server = EngineServer(engine, args.bind_host, args.bind_port,
                          token=args.token, ssl_context=server_ssl,
                          admission=admission,
                          allow_chaos=args.enable_chaos_ops)
    coordinator = None
    if peers is not None:
        from ..parallel.failover import FailoverCoordinator

        coordinator = FailoverCoordinator(
            engine, server, peers, args.peer_id,
            token=args.token, data_dir=args.data_dir,
            heartbeat_interval=args.mirror_heartbeat_seconds,
            heartbeat_timeout=(args.mirror_heartbeat_timeout or None),
            replication_timeout=args.replication_timeout,
            min_sync_replicas=args.min_sync_replicas,
            client_ssl=mirror_ssl,
            boot_grace=args.failover_boot_grace)
        log.info("failover set: peer %d of %d (term %d)", args.peer_id,
                 len(peers), coordinator.term)

    async def serve():
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(sig, stop.set)
        await server.start()
        if coordinator is not None:
            # the role state machine runs beside the asyncio server: it
            # swaps server.engine between the bare engine (follower,
            # role-gated) and the term-stamped mirror wrapper (leader)
            coordinator.start()
        await stop.wait()
        if coordinator is not None:
            coordinator.stop()
        await server.stop()
        from ..ops import bitprop

        log.info("kernel launches in this process: bit_or_matmul=%d "
                 "dense_or_matmul=%d", bitprop.bit_or_matmul.launches,
                 bitprop.dense_or_matmul.launches)
        if args.compact_threshold > 0:
            # stop the compactor before the final snapshot/checkpoint so
            # no fold races the state capture below
            await loop.run_in_executor(None, engine.close_compaction)
        if args.snapshot_path:
            engine.save_snapshot(args.snapshot_path)
            log.info("saved snapshot to %s", args.snapshot_path)
        if persistence is not None:
            # final checkpoint + WAL fsync: the next boot loads one
            # snapshot and replays zero records
            await loop.run_in_executor(None, engine.close_persistence)
            log.info("persistence closed (checkpointed %s)", args.data_dir)

    asyncio.run(serve())
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
