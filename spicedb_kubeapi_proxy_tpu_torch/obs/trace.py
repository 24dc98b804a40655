"""Request tracing: W3C traceparent context + cheap in-process spans.

One trace follows one proxy request end-to-end. The proxy ingress adopts
an incoming ``traceparent`` header (or mints one), the authz middleware
opens named child spans for every stage it runs (authn, rule match,
admission wait, cache probe, engine dispatch, post-filter, upstream RTT),
and the remote-engine wire carries the context as a frame field so
engine-host spans (queue wait, device dispatch, replication ack wait)
stitch into the proxy's trace — in-process when proxy and engine host
share an interpreter (the test/bench shape), by shared trace_id across
processes otherwise.

Recording is TAIL-sampled: spans are buffered on the live trace and the
keep/drop decision happens when the root finishes — error, shed, and
slow-threshold traces are always kept, the rest kept with probability
``sample``. Kept traces land in a lock-sharded ring buffer served by
``/debug/traces``. ``sample == 0`` disables tracing entirely: every hook
degrades to a couple of attribute reads, so the hot path pays nothing
measurable (the bench acceptance pin).

Spans cross threads explicitly: ``contextvars`` carry the active span
through ``asyncio`` tasks and ``asyncio.to_thread``, and executor-pool
hops (which do NOT copy context) re-enter via ``capture()`` /
``activate()``.

While a ``torch.profiler`` records in the process, every ``span()`` also
opens a ``record_function`` range of its name for its extent, request
trace or not, so the program's layers appear on the profiler's timeline
beside the device's kernels. Spans stamp their start on the profiler's
clock (``time.time_ns()``, as kineto stamps host events), so a
``/debug/traces`` span lines up with a device trace of the same moment.
With neither a request trace nor a profiler on, ``span()`` returns one
shared no-op context. torch is never imported here: no profiler can
record in a process that has not loaded it. The engine's span names are
listed in ``obs/tracing.md``.
"""

from __future__ import annotations

import contextvars
import random
import sys
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Optional

_FLAG_SAMPLED = 0x01

# (trace, parent_span_id) of the code currently executing, or None
_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "sdbkp_trace", default=None)


def parse_traceparent(header) -> Optional[tuple[str, str, int]]:
    """``(trace_id, parent_span_id, flags)`` from a W3C ``traceparent``
    (version 00), or ``None`` for anything malformed — a bad header from
    an arbitrary client must start a fresh trace, never raise."""
    if not header or not isinstance(header, str):
        return None
    parts = header.strip().lower().split("-")
    if len(parts) != 4:
        return None
    version, trace_id, span_id, flags = parts
    if len(version) != 2 or len(trace_id) != 32 or len(span_id) != 16:
        return None
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    try:
        int(version, 16), int(trace_id, 16), int(span_id, 16)
        f = int(flags, 16)
    except ValueError:
        return None
    return trace_id, span_id, f


def format_traceparent(trace_id: str, span_id: str,
                       sampled: bool = True) -> str:
    return f"00-{trace_id}-{span_id}-{'01' if sampled else '00'}"


def _flag_exception(trace: "Trace", e: BaseException) -> None:
    """Trace-level flag for an exception crossing a span boundary: load
    sheds are the admission design WORKING and must stay distinguishable
    from real failures — they flag "shed", everything else "error" (both
    always survive tail sampling). Lazy import: only the exception path
    pays it, and obs/ stays import-light."""
    from ..admission import AdmissionRejected

    if isinstance(e, AdmissionRejected):
        trace.flag("shed")
    else:
        trace.flag("error")


def _new_trace_id() -> str:
    return f"{random.getrandbits(128):032x}"


def _new_span_id() -> str:
    return f"{random.getrandbits(64):016x}"


class Span:
    """One named, timed segment of a trace. ``set()`` attaches attributes
    (JSON-safe values only); ``finish()`` records it onto its trace —
    callable from any thread, exactly once (later calls are ignored)."""

    __slots__ = ("trace", "span_id", "parent_id", "name", "start_ns",
                 "_t0", "duration", "attrs", "_done")

    def __init__(self, trace: "Trace", parent_id: Optional[str], name: str,
                 attrs: Optional[dict] = None):
        self.trace = trace
        self.span_id = _new_span_id()
        self.parent_id = parent_id
        self.name = name
        self.start_ns = time.time_ns()  # the profiler's clock
        self._t0 = time.perf_counter()
        self.duration = 0.0
        self.attrs = dict(attrs) if attrs else {}
        self._done = False

    def set(self, key: str, value) -> None:
        self.attrs[key] = value

    def traceparent(self) -> str:
        return format_traceparent(self.trace.trace_id, self.span_id)

    @property
    def trace_id(self) -> str:
        return self.trace.trace_id

    def finish(self) -> None:
        if self._done:
            return
        self._done = True
        self.duration = time.perf_counter() - self._t0
        self.trace.record(self)

    def to_dict(self) -> dict:
        return {
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "start": self.start_ns / 1e9,
            "start_ns": self.start_ns,
            "duration_us": int(self.duration * 1e6),
            "attrs": self.attrs,
        }


class _NullSpan:
    """The disabled-path stand-in: every hook stays unconditional at the
    call site while costing nothing. It is also the shared no-op context
    ``Tracer.span`` returns when nothing records."""

    __slots__ = ()
    trace_id = None
    span_id = None

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        return None

    def set(self, key, value) -> None:
        pass

    def traceparent(self):
        return None

    def finish(self) -> None:
        pass


NULL_SPAN = _NullSpan()


class _SpanScope:
    """The extent of one ``Tracer.span``: a profiler range of its name
    when ``profiler`` (torch.autograd.profiler) is given, and a child
    span on the request trace when ``cur`` (the active (trace, parent))
    is. Entering yields the span, or NULL_SPAN without a request trace."""

    __slots__ = ("_profiler", "_cur", "_name", "_attrs", "_range", "_span",
                 "_token")

    def __init__(self, profiler, cur, name: str, attrs: dict):
        self._profiler = profiler
        self._cur = cur
        self._name = name
        self._attrs = attrs
        self._range = self._span = None

    def __enter__(self):
        if self._profiler is not None:
            self._range = self._profiler.record_function(self._name)
            self._range.__enter__()
        if self._cur is None:
            return NULL_SPAN
        trace, parent = self._cur
        sp = self._span = Span(trace, parent, self._name, self._attrs)
        self._token = _CURRENT.set((trace, sp.span_id))
        return sp

    def __exit__(self, exc_type, exc, tb) -> None:
        sp = self._span
        if sp is not None:
            # an exception marks the span AND flags the trace before
            # propagating
            if exc is not None:
                sp.set("error", repr(exc))
                _flag_exception(sp.trace, exc)
            _CURRENT.reset(self._token)
            sp.finish()
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)


class Trace:
    """A live trace: the span accumulator plus trace-level flags. Spans
    append under a lock (proxy event loop, to_thread workers, and engine
    host executor threads all record concurrently)."""

    __slots__ = ("trace_id", "external", "flags", "spans", "start_epoch",
                 "_t0", "_lock")

    def __init__(self, trace_id: Optional[str] = None,
                 external: bool = False):
        self.trace_id = trace_id or _new_trace_id()
        # external: the root lives in ANOTHER process (an engine host
        # serving a remote proxy's op) — this trace holds a satellite
        # fragment, finished per-op instead of per-request
        self.external = external
        self.flags: dict = {}
        self.spans: list[Span] = []
        self.start_epoch = time.time()
        self._t0 = time.perf_counter()
        self._lock = threading.Lock()

    def record(self, span: Span) -> None:
        with self._lock:
            self.spans.append(span)

    def flag(self, key: str, value=True) -> None:
        self.flags[key] = value

    def stage_micros(self) -> dict:
        """Total finished-span duration per span name, in integer
        microseconds — the audit line's per-stage attribution."""
        out: dict[str, int] = {}
        with self._lock:
            for s in self.spans:
                out[s.name] = out.get(s.name, 0) + int(s.duration * 1e6)
        return out

    def to_dict(self) -> dict:
        with self._lock:
            spans = [s.to_dict() for s in self.spans]
        return {
            "trace_id": self.trace_id,
            "start": self.start_epoch,
            "duration_us": int((time.perf_counter() - self._t0) * 1e6),
            "flags": dict(self.flags),
            "external": self.external,
            "spans": spans,
        }


class Tracer:
    """The process-global span recorder (module-level ``tracer``).
    ``configure()`` is how flags reach it; every hook below is safe to
    call with tracing disabled or no active trace."""

    RING_SHARDS = 8

    def __init__(self, sample: float = 0.1, slow_ms: float = 250.0,
                 ring: int = 256):
        self._rand = random.random
        self._ap = None  # torch.autograd.profiler, bound once torch loads
        self._live_lock = threading.Lock()
        self._live: dict[str, Trace] = {}
        self.configure(sample=sample, slow_ms=slow_ms, ring=ring)

    def configure(self, sample: Optional[float] = None,
                  slow_ms: Optional[float] = None,
                  ring: Optional[int] = None, _rand=None) -> None:
        if sample is not None:
            self.sample = max(0.0, min(1.0, float(sample)))
        if slow_ms is not None:
            self.slow_s = max(0.0, float(slow_ms)) / 1e3
        if ring is not None:
            per = max(1, int(ring) // self.RING_SHARDS)
            self._shards = [(threading.Lock(), deque(maxlen=per))
                            for _ in range(self.RING_SHARDS)]
        if _rand is not None:
            self._rand = _rand

    @property
    def enabled(self) -> bool:
        return self.sample > 0.0

    # -- context ------------------------------------------------------------

    def capture(self):
        """The active (trace, parent_span_id), for crossing an executor
        hop that does not copy contextvars; re-enter with
        :meth:`activate`."""
        return _CURRENT.get()

    @contextmanager
    def activate(self, captured):
        """Make a captured context the active one in THIS thread (worker
        pools; ``asyncio.to_thread`` copies context by itself)."""
        if captured is None:
            yield
            return
        token = _CURRENT.set(captured)
        try:
            yield
        finally:
            _CURRENT.reset(token)

    def current_trace_id(self) -> Optional[str]:
        cur = _CURRENT.get()
        return cur[0].trace_id if cur is not None else None

    def flag(self, key: str, value=True) -> None:
        """Set a trace-level flag (error/shed/...) on the active trace;
        flagged traces survive tail sampling unconditionally."""
        cur = _CURRENT.get()
        if cur is not None:
            cur[0].flag(key, value)

    def flagged(self, key: str) -> bool:
        cur = _CURRENT.get()
        return bool(cur is not None and cur[0].flags.get(key))

    def stage_micros(self) -> dict:
        cur = _CURRENT.get()
        return cur[0].stage_micros() if cur is not None else {}

    # -- span lifecycle -----------------------------------------------------

    @contextmanager
    def start(self, name: str, traceparent: Optional[str] = None, **attrs):
        """Open a ROOT span (proxy ingress): adopts the trace_id from a
        valid incoming ``traceparent``, mints one otherwise. Exiting the
        context finishes the trace and runs the tail-sampling decision."""
        if not self.enabled:
            yield NULL_SPAN
            return
        parsed = parse_traceparent(traceparent)
        trace = Trace(parsed[0] if parsed else None)
        root = Span(trace, parsed[1] if parsed else None, name, attrs)
        with self._live_lock:
            if trace.trace_id in self._live:
                # a second in-flight request reusing the same incoming
                # traceparent (client retry racing its original): sharing
                # the live entry would cross-stitch engine-host spans and
                # stage timings between unrelated requests — mint a fresh
                # trace and keep the client's id as an attribute
                requested = trace.trace_id
                trace = Trace()
                root = Span(trace, None, name, attrs)
                root.set("requested_trace_id", requested)
            self._live[trace.trace_id] = trace
        token = _CURRENT.set((trace, root.span_id))
        try:
            yield root
        except BaseException as e:
            root.set("error", repr(e))
            _flag_exception(trace, e)
            raise
        finally:
            _CURRENT.reset(token)
            root.finish()
            with self._live_lock:
                if self._live.get(trace.trace_id) is trace:
                    del self._live[trace.trace_id]
            self._tail_decide(trace, root)

    def span(self, name: str, **attrs):
        """A context: a child span of whatever request trace is active,
        and a profiler range of ``name`` while a torch profiler records.
        With neither, the shared no-op NULL_SPAN. Exceptions mark the
        span AND flag the trace as error before propagating."""
        cur = _CURRENT.get()
        if cur is not None and not self.enabled:
            cur = None
        # torch's process-wide flag (a profiler of all threads leaves its
        # thread-local check false); a torch without it records no range
        ap = self._ap or self._bind_profiler()
        prof = (ap if ap is not None
                and getattr(ap, "_is_profiler_enabled", False) else None)
        if cur is None and prof is None:
            return NULL_SPAN
        return _SpanScope(prof, cur, name, attrs)

    def _bind_profiler(self):
        """torch.autograd.profiler once torch is loaded, else None."""
        torch = sys.modules.get("torch")
        if torch is not None:
            self._ap = torch.autograd.profiler
        return self._ap

    def begin(self, name: str, **attrs) -> Optional[Span]:
        """Open a LEAF span without touching the context — for async
        dispatch paths whose completion callback runs elsewhere; the
        caller owns ``finish()``. Children never nest under it. Request
        traces only: it may end on another thread, so it never becomes a
        profiler range."""
        cur = _CURRENT.get()
        if cur is None or not self.enabled:
            return None
        trace, parent = cur
        return Span(trace, parent, name, attrs)

    @contextmanager
    def adopt(self, wire: Optional[str], name: str, **attrs):
        """Engine-host entry: attach to the trace named by a wire-carried
        ``traceparent``. When the trace is LIVE in this process (proxy and
        engine host sharing an interpreter), spans stitch straight into
        it; otherwise a satellite trace fragment is recorded under the
        same trace_id and tail-sampled on its own when the op ends."""
        parsed = parse_traceparent(wire) if wire else None
        if parsed is None or not self.enabled:
            yield NULL_SPAN
            return
        trace_id, parent_id, _flags = parsed
        with self._live_lock:
            live = self._live.get(trace_id)
        if live is not None:
            sp = Span(live, parent_id, name, attrs)
            token = _CURRENT.set((live, sp.span_id))
            try:
                yield sp
            except BaseException as e:
                sp.set("error", repr(e))
                _flag_exception(live, e)
                raise
            finally:
                _CURRENT.reset(token)
                sp.finish()
            return
        trace = Trace(trace_id, external=True)
        root = Span(trace, parent_id, name, attrs)
        token = _CURRENT.set((trace, root.span_id))
        try:
            yield root
        except BaseException as e:
            root.set("error", repr(e))
            _flag_exception(trace, e)
            raise
        finally:
            _CURRENT.reset(token)
            root.finish()
            self._tail_decide(trace, root)

    # -- tail sampling + ring -----------------------------------------------

    def _tail_decide(self, trace: Trace, root: Span) -> None:
        keep = (bool(trace.flags)
                or root.duration >= self.slow_s
                or self._rand() < self.sample)
        if not keep:
            return
        lock, ring = self._shards[hash(trace.trace_id) % self.RING_SHARDS]
        with lock:
            ring.append(trace.to_dict())

    def recent(self, limit: int = 64) -> list[dict]:
        """Most recent kept traces, newest first."""
        out: list[dict] = []
        for lock, ring in self._shards:
            with lock:
                out.extend(ring)
        out.sort(key=lambda t: t["start"], reverse=True)
        return out[:max(0, int(limit))]

    def reset(self) -> None:
        """Drop every kept trace (tests)."""
        for lock, ring in self._shards:
            with lock:
                ring.clear()


tracer = Tracer()
