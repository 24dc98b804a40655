"""Filtered watch: join the upstream watch stream with live permission
updates from the engine.

Mirrors the reference's dual-stream join
(the Go proxy's pkg/authz/watch.go:27-111 and
responsefilterer.go:434-714): one side consumes relationship-update events
from the engine (the SpiceDB Watch API role) and recomputes the allowed
set — one device query for the WHOLE set per event batch, which also
catches grants/revocations mediated through arrows and usersets that the
reference's per-object re-checks of same-type events cannot see; the
other side decodes upstream watch frames, passing frames for allowed
objects through byte-identical, buffering the latest frame of
not-yet-allowed objects (flushed on an allow transition, dropped on
deny).

The engine side rides the shared :class:`~.watchhub.WatchHub`: one event
pump per engine (store-condition push in-process, server-push stream for
``tcp://`` hosts — no polling) and ONE allowed-set recompute per distinct
(prefilter rule, subject) group per relevant event batch, fanned out to
every watcher in the group. The per-watcher loop below sleeps on a single
queue carrying both upstream frames and hub updates — zero idle wakeups.
"""

from __future__ import annotations

import asyncio
import json
from typing import AsyncIterator, Optional

from ..engine import Engine
from ..proxy import kubeproto
from ..rules.compile import PreFilter

from ..rules.input import ResolveInput
from ..proxy.types import ProxyRequest, ProxyResponse
from .lookups import AllowedSet, run_prefilter
from .watchhub import WatchHub


async def filtered_watch(engine: Engine, upstream_resp: ProxyResponse,
                         pf: PreFilter, input: ResolveInput,
                         poll_interval: float = 0.05,
                         hub: Optional[WatchHub] = None) -> ProxyResponse:
    """Wrap an upstream watch response with permission filtering."""
    if upstream_resp.status != 200 or upstream_resp.stream is None:
        return upstream_resp

    # A private hub for direct callers (tests); the middleware passes the
    # proxy-wide hub so recomputes are shared across watchers.
    if hub is None:
        hub = WatchHub(engine, poll_interval)

    # The prefilter runs eagerly (not inside the streaming generator) so
    # PreFilterError surfaces as a 500 before the 200/chunked headers are
    # committed. Hub registration happens INSIDE the generator instead: a
    # stream the client abandons before the first frame is a generator
    # that never starts, and PEP 525 never runs its finally — an eager
    # registration would leak the watcher (and its queue) forever. The
    # snapshot→registration event gap is closed by hub.refresh() below.
    allowed = await run_prefilter(engine, pf, input)

    async def frames() -> AsyncIterator[bytes]:
        nonlocal allowed
        handle = await hub.register(pf, input)
        # one forced, ordered recompute: initial frames are HELD until it
        # lands, so grants/revocations that raced the initial snapshot
        # (or tick recomputes in flight across registration) can never
        # judge a frame with stale state
        await hub.refresh(handle)
        buffered: dict[tuple, bytes] = {}
        # frames held while a recompute covering an earlier event batch is
        # in flight — a revoked object's frame must be judged against the
        # POST-event allowed set, not race the device query (("pending")
        # markers from the hub; same ordering the old per-watcher loop
        # got by draining events before frames)
        held: list[bytes] = []
        waiting_for = handle.reg_seq  # highest pending seq seen
        applied = handle.reg_seq  # highest seq an applied set covers
        q = handle.queue  # hub updates AND upstream frames land here

        async def read_upstream():
            try:
                async for chunk in upstream_resp.stream:
                    q.put_nowait(("frame", chunk))
            finally:
                q.put_nowait(("frame", None))

        def emit(frame: bytes) -> Optional[bytes]:
            key = _frame_object_key(frame, pf)
            if key is None or allowed.allows(*key):
                return frame  # byte-identical passthrough
            buffered[key] = frame
            return None

        reader = asyncio.get_running_loop().create_task(read_upstream())
        try:
            while True:
                item = await q.get()
                kind = item[0]
                if kind == "frame":
                    frame = item[1]
                    if frame is None:
                        return  # upstream ended
                    if waiting_for > applied:
                        held.append(frame)
                        continue
                    try:
                        out = emit(frame)
                    except kubeproto.ProtoError:
                        # a proto frame we cannot judge (no keyable
                        # object): end the stream instead of leaking it —
                        # the client re-lists and re-watches
                        return
                    if out is not None:
                        yield out
                elif kind == "pending":
                    waiting_for = max(waiting_for, item[1])
                elif kind == "allowed":
                    if item[2] <= handle.reg_seq:
                        # strictly predates (or is concurrent with) our
                        # initial snapshot — e.g. an expiry-tick recompute
                        # already in flight at registration; our refresh's
                        # covering set (seq > reg_seq) is on its way
                        continue
                    fresh: AllowedSet = item[1]
                    for key in fresh.pairs - allowed.pairs:
                        frame = buffered.pop(key, None)
                        if frame is not None:
                            yield frame
                    for key in allowed.pairs - fresh.pairs:
                        buffered.pop(key, None)
                    allowed = fresh
                    applied = max(applied, item[2])
                    if applied >= waiting_for and held:
                        for frame in held:
                            try:
                                out = emit(frame)
                            except kubeproto.ProtoError:
                                return  # as above: never leak unjudged
                            if out is not None:
                                yield out
                        held = []
                else:  # "error": shared recompute or event pump died —
                    return  # end the stream; the client re-lists+rewatches
        finally:
            reader.cancel()
            await hub.unregister(handle)

    return ProxyResponse(status=200, headers=dict(upstream_resp.headers),
                         stream=frames())


def _frame_object_key(frame: bytes, pf: PreFilter) -> Optional[tuple]:
    """Extract (namespace, name) from a watch frame WITHOUT altering the
    frame bytes (the reference keeps raw bytes via a frame-capturing
    reader, pkg/authz/frames.go:13-68). Handles both JSON frames
    (newline-delimited WatchEvent documents) and kube-protobuf frames
    (4-byte length prefix + raw WatchEvent; reference negotiates the
    streaming serializer per content type, responsefilterer.go:557-626).

    The key space is defined by the PREFILTER's expressions: the grant
    side maps object ids through ``name_expr``/``namespace_expr``
    (run_prefilter_sync mapping), so the frame side must key identically — a prefilter
    with no namespace expression produces cluster-scoped ("", name) keys,
    and the frame's metadata.namespace must then be ignored rather than
    guessed from the resource name.

    FAIL CLOSED: raises :class:`~..proxy.kubeproto.ProtoError` for ANY
    frame carrying no judgeable object — truncated proto, unparseable
    JSON, rows without objects — and the join ends the stream rather
    than leaking bytes it cannot authorize. The only unjudged frames
    that pass are explicit progress/terminal markers (BOOKMARK, ERROR/
    Status) and bare whitespace keepalives."""
    stripped = frame.lstrip()
    if not stripped:
        return None  # newline keepalive: carries nothing
    if stripped[:1] != b"{" and len(frame) >= 4 and \
            int.from_bytes(frame[:4], "big") == len(frame) - 4:
        key = kubeproto.watch_frame_key(frame)  # may raise ProtoError
        if key is None:
            return None  # BOOKMARK / terminal Status: every consumer sees
        ns, name = key
        return (ns if pf.namespace_expr else "", name)
    try:
        ev = json.loads(frame)
        if ev.get("type") == "BOOKMARK":
            # bookmarks carry only a resourceVersion (no object to
            # authorize) and are progress markers every consumer may see:
            # pass through rather than keying on an empty name
            return None
        obj = ev.get("object") or {}
        if ev.get("type") == "ERROR" or obj.get("kind") == "Status":
            # a terminal Status (watch expiry, 410 Gone): no object to
            # judge, and suppressing it would leave the client hanging on
            # a dead watch instead of re-listing — pass it through (same
            # semantics as the proto path above)
            return None
        # Table-format watch events wrap rows (responsefilterer.go:667-677)
        if obj.get("kind") == "Table":
            rows = obj.get("rows") or []
            if rows:
                meta = (rows[0].get("object") or {}).get("metadata") or {}
            else:
                return None
        else:
            meta = obj.get("metadata") or {}
        ns = (meta.get("namespace") or "") if pf.namespace_expr else ""
        return (ns, meta.get("name") or "")
    except (ValueError, AttributeError, TypeError):
        # not JSON, not a well-formed proto frame, or JSON whose shape is
        # not a watch event (array/scalar top level, non-dict rows — a
        # broken aggregated-API backend): unjudgeable — fail closed with
        # the documented stream-ending error, never an unhandled crash
        raise kubeproto.ProtoError(
            "unparseable watch frame (truncated or unknown encoding)")
