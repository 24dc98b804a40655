"""Structured decision audit log: one JSON line per authorization verdict.

The reference proxy's explainability story is "which rule allowed this?";
this module answers it durably: every DENY is always logged, ALLOWS are
rate-capped (a fleet list is thousands of identical allows per second —
the cap keeps the log a decision record, not a traffic mirror). Lines are
self-contained JSON objects:

    {"ts": <iso8601>, "decision": "allow"|"deny", "verb": ..,
     "resource": .., "subresource": .., "namespace": .., "name": ..,
     "subject": .., "groups": [..], "rule": <matched rule name(s)>,
     "reason": .., "cache_hit": bool|null, "revision": int|null,
     "trace_id": <hex>|null, "stages_us": {<span name>: <micros>, ..}}

``rule`` is the comma-joined names of the rules whose checks decided the
request (null before matching). ``stages_us`` carries the per-stage span
durations recorded so far on the request's trace (empty when tracing is
off). Destination is a file path (append, line-buffered) or the literal
``stderr``.
"""

from __future__ import annotations

import json
import queue
import sys
import threading
import time
from datetime import datetime, timezone
from typing import Optional

from ..utils.metrics import metrics

_CLOSE = object()  # writer-thread shutdown sentinel


class AuditLog:
    """Thread-safe decision writer with a token-bucket cap on allows.

    Lines drain through a BOUNDED queue on a dedicated writer thread:
    ``decision()`` is called synchronously from the proxy's event loop
    (the authz chain), and a slow or contended audit disk must add
    queue-put time there, never a write syscall — denies are uncapped
    by design, so a 403 storm against a throttled volume would
    otherwise stall every concurrent request. A full queue drops the
    line (counted in ``audit_dropped_total``) rather than blocking:
    the audit log records decisions, it does not gate them."""

    QUEUE_DEPTH = 4096

    def __init__(self, dest: str, allow_rps: float = 10.0,
                 clock=time.monotonic, shed_rps: Optional[float] = None):
        self.dest = dest
        self.allow_rps = float(allow_rps)
        # sheds get their own budget (default: the allow cap): an
        # overload sheds thousands/second by design, and the audit log
        # must record that it HAPPENED (agreeing with the trace ring on
        # every rejection path) without becoming a traffic mirror of the
        # very storm being shed
        self.shed_rps = float(allow_rps if shed_rps is None else shed_rps)
        self._clock = clock
        self._lock = threading.Lock()
        # burst = one second of allowance (min 1: a single allow must
        # always be loggable)
        self._burst = max(1.0, self.allow_rps)
        self._tokens = self._burst
        self._shed_burst = max(1.0, self.shed_rps)
        self._shed_tokens = self._shed_burst
        self._last = clock()
        self._shed_last = clock()
        if dest == "stderr":
            self._fh = sys.stderr
            self._owns = False
        else:
            self._fh = open(dest, "a", buffering=1)
            self._owns = True
        self._q: queue.Queue = queue.Queue(maxsize=self.QUEUE_DEPTH)
        self._writer = threading.Thread(
            target=self._drain, name="audit-writer", daemon=True)
        self._writer.start()

    def _drain(self) -> None:
        while True:
            item = self._q.get()
            try:
                if item is _CLOSE:
                    return
                try:
                    self._fh.write(item)
                except (ValueError, OSError):
                    # closed/failed sink mid-shutdown: drop, never raise
                    metrics.counter("audit_dropped_total").inc()
            finally:
                self._q.task_done()

    def _take_allow(self) -> bool:
        with self._lock:
            now = self._clock()
            self._tokens = min(
                self._burst,
                self._tokens + (now - self._last) * self.allow_rps)
            self._last = now
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return True
            return False

    def _take_shed(self) -> bool:
        with self._lock:
            now = self._clock()
            self._shed_tokens = min(
                self._shed_burst,
                self._shed_tokens + (now - self._shed_last) * self.shed_rps)
            self._shed_last = now
            if self._shed_tokens >= 1.0:
                self._shed_tokens -= 1.0
                return True
            return False

    def shed(self, *, op_class: str, tenant: str = "", verb: str = "",
             resource: str = "", retry_after: float = 0.0,
             reason: str = "", trace_id: Optional[str] = None) -> None:
        """One rate-capped line per admission shed — the rejection paths
        that never reach a verdict (so :meth:`decision` never sees them)
        still leave an audit record agreeing with the trace ring:
        ``{"decision": "shed", "class": .., "tenant": .., "retry_after":
        .., "trace_id": ..}``. Capped-out sheds are counted
        (``audit_sheds_sampled_out_total``), not logged."""
        if not self._take_shed():
            metrics.counter("audit_sheds_sampled_out_total").inc()
            return
        rec = {
            "ts": datetime.now(timezone.utc).isoformat(
                timespec="milliseconds"),
            "decision": "shed",
            "class": op_class,
            "tenant": tenant,
            "verb": verb,
            "resource": resource,
            "retry_after": round(float(retry_after), 3),
            "reason": reason,
            "trace_id": trace_id,
        }
        line = json.dumps(rec, separators=(",", ":")) + "\n"
        try:
            self._q.put_nowait(line)
        except queue.Full:
            metrics.counter("audit_dropped_total").inc()
            return
        metrics.counter("audit_decisions_total", decision="shed").inc()

    def decision(self, *, allow: bool, verb: str = "", resource: str = "",
                 subresource: str = "", namespace: str = "", name: str = "",
                 subject: str = "", groups: Optional[list] = None,
                 rule: Optional[str] = None, reason: str = "",
                 cache_hit: Optional[bool] = None,
                 revision: Optional[int] = None,
                 trace_id: Optional[str] = None,
                 stages_us: Optional[dict] = None) -> None:
        """Write one decision line. Denies always; allows only while the
        rate cap has budget (capped-out allows are counted, not logged)."""
        if allow and not self._take_allow():
            metrics.counter("audit_allows_sampled_out_total").inc()
            return
        rec = {
            "ts": datetime.now(timezone.utc).isoformat(
                timespec="milliseconds"),
            "decision": "allow" if allow else "deny",
            "verb": verb,
            "resource": resource,
            "subresource": subresource,
            "namespace": namespace,
            "name": name,
            "subject": subject,
            "groups": list(groups or ()),
            "rule": rule,
            "reason": reason,
            "cache_hit": cache_hit,
            "revision": revision,
            "trace_id": trace_id,
            "stages_us": dict(stages_us or {}),
        }
        line = json.dumps(rec, separators=(",", ":")) + "\n"
        try:
            self._q.put_nowait(line)
        except queue.Full:
            metrics.counter("audit_dropped_total").inc()
            return
        metrics.counter("audit_decisions_total",
                        decision=rec["decision"]).inc()

    def flush(self, timeout: Optional[float] = None) -> bool:
        """Block until every queued line has been written (tests,
        shutdown); False when ``timeout`` expired first. Bounded waits
        matter at shutdown: a wedged sink (stale NFS mount, blocked
        pipe) must not turn SIGTERM into a hang."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._q.all_tasks_done:
            while self._q.unfinished_tasks:
                left = (None if deadline is None
                        else deadline - time.monotonic())
                if left is not None and left <= 0:
                    return False
                self._q.all_tasks_done.wait(left)
        return True

    def close(self, timeout: float = 5.0) -> None:
        if not self.flush(timeout):
            metrics.counter("audit_dropped_total").inc(
                self._q.unfinished_tasks)
        try:
            self._q.put_nowait(_CLOSE)
        except queue.Full:
            pass  # daemon writer dies with the process
        self._writer.join(timeout=timeout)
        if self._owns and not self._writer.is_alive():
            try:
                self._fh.close()
            except OSError:
                pass
