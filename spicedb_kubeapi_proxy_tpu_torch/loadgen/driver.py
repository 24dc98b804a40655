"""The open-loop workload driver.

The dispatcher walks the precomputed schedule and fires each arrival at
its scheduled time into a worker pool — it NEVER waits for a response
before the next arrival, and the pool's submission queue is unbounded,
so a server that falls behind sees the backlog a real fleet would
produce instead of a politely self-throttling client. Consequences, by
design:

- offered load is a property of the SCHEDULE, not the server: shedding,
  slow responses, and errors change outcomes, never the arrival times
  (the "never closes the loop" acceptance pin);
- latency is measured from ``max(scheduled arrival, actual submit)``:
  worker-pool backlog counts against the server exactly the way
  coordinated-omission-free load generators (wrk2 et al.) count it,
  while GENERATOR drift (the dispatcher thread losing the GIL to busy
  workers — a CPython artifact, not server queueing) does not; drift is
  reported separately as the ``late`` count so a run whose generator
  could not keep its own schedule says so;
- a shed (``AdmissionRejected``) is an accounted outcome, not an error:
  the curves need goodput AND shed rate per offered-load point.

Per-op latencies land in ``loadgen_op_seconds{op=...}`` histograms (the
sweep reads p50/p99/p99.9 out of windowed snapshot deltas) and in raw
per-arrival records (burst windows are sliced from these, since a burst
is a time window within one run, finer than a histogram window).
"""

from __future__ import annotations

import concurrent.futures
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from ..utils.metrics import metrics
from .schedule import Arrival

OUTCOME_OK = "ok"
OUTCOME_SHED = "shed"
OUTCOME_ERROR = "error"

# an arrival submitted more than this far behind its scheduled time is
# "late": the DISPATCHER (not the server) failed to keep the schedule,
# and the run's offered-load claim must say so
LATE_SUBMIT_S = 0.010


@dataclass(frozen=True)
class OpOutcome:
    """One fired arrival's fate."""

    arrival: Arrival
    outcome: str  # ok | shed | error
    latency_s: float  # completion - max(scheduled arrival, submit)
    exec_s: float  # completion - execution start (op service time)


@dataclass
class DriverReport:
    scheduled_n: int = 0
    fired_n: int = 0
    late_n: int = 0
    abandoned_n: int = 0  # still running when the drain deadline hit
    duration_s: float = 0.0  # schedule span (per config, not wall)
    wall_s: float = 0.0  # actual wall time incl. drain
    start_epoch: float = 0.0  # epoch of schedule t=0 (trace correlation)
    records: list = field(default_factory=list)  # [OpOutcome]
    hist_before: dict = field(default_factory=dict)  # op -> snapshot
    hist_after: dict = field(default_factory=dict)
    error_samples: list = field(default_factory=list)

    @property
    def offered_rps(self) -> float:
        return self.fired_n / self.duration_s if self.duration_s else 0.0

    def per_class(self) -> dict:
        out: dict = {}
        for r in self.records:
            c = out.setdefault(r.arrival.op, {"n": 0, "ok": 0, "shed": 0,
                                              "error": 0})
            c["n"] += 1
            c[r.outcome] += 1
        return out

    def latencies(self, op: Optional[str] = None,
                  phase: Optional[str] = None,
                  outcome: str = OUTCOME_OK) -> list[float]:
        return [r.latency_s for r in self.records
                if (op is None or r.arrival.op == op)
                and (phase is None or r.arrival.phase == phase)
                and r.outcome == outcome]


class OpenLoopDriver:
    """Fires a schedule into op callables without ever closing the loop.

    ``ops`` maps op-class name -> ``callable(arrival)``; an op raising
    ``AdmissionRejected`` records a shed, any other exception an error.
    ``slo_s`` (op -> seconds) marks traces over-SLO when ``trace_ops``
    is on, so tail sampling keeps exactly the slow/shed evidence the
    sweep's attribution step reads back."""

    def __init__(self, ops: dict[str, Callable[[Arrival], None]],
                 max_workers: int = 32,
                 slo_s: Optional[dict] = None,
                 trace_ops: bool = False,
                 drain_timeout: float = 30.0,
                 trace_attrs: Optional[dict] = None):
        self.ops = dict(ops)
        self.max_workers = int(max_workers)
        self.slo_s = dict(slo_s or {})
        self.trace_ops = trace_ops
        self.drain_timeout = drain_timeout
        # extra attrs stamped on every macro_op root span — the sweep
        # tags each point so attribution can tell one run's traces from
        # another's in the shared ring
        self.trace_attrs = dict(trace_attrs or {})
        self._hists = {
            op: metrics.histogram("loadgen_op_seconds", op=op)
            for op in self.ops
        }

    def run(self, schedule: list[Arrival], duration: float,
            time_scale: float = 1.0) -> DriverReport:
        """Replay ``schedule`` (arrival times multiplied by
        ``time_scale``), wait up to ``drain_timeout`` for stragglers,
        and return the report. ``duration`` is the schedule's nominal
        span — the denominator of every rate this report makes."""
        import sys

        from ..admission import AdmissionRejected
        from ..obs.trace import tracer

        rep = DriverReport(scheduled_n=len(schedule),
                           duration_s=duration * time_scale)
        rep.hist_before = {op: h.snapshot()
                           for op, h in self._hists.items()}
        lock = threading.Lock()
        sealed = threading.Event()  # set at the drain deadline
        pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=self.max_workers,
            thread_name_prefix="loadgen")
        # tighten the GIL switch interval for the run: with a pool of
        # busy workers, the default 5ms quantum can starve the
        # dispatcher thread for tens of ms and wreck schedule fidelity
        prev_si = sys.getswitchinterval()
        sys.setswitchinterval(0.001)
        t0 = time.perf_counter()
        rep.start_epoch = time.time()
        futs = []

        def fire(a: Arrival, target: float):
            t_exec = time.perf_counter()
            outcome = OUTCOME_OK
            err: Optional[BaseException] = None
            # sched = schedule-relative arrival time: burst windows are
            # defined in SCHEDULE time, and a backlogged op executes
            # long after its arrival — attribution must window on when
            # the op was OFFERED, not when a free worker got to it
            span_cm = (tracer.start("macro_op", op=a.op, tenant=a.tenant,
                                    phase=a.phase, sched=round(a.t, 6),
                                    **self.trace_attrs)
                       if self.trace_ops else _NULL_CM)
            try:
                with span_cm as root:
                    if root is not None:
                        # the open-loop backlog (scheduled arrival ->
                        # execution start) is a tail stage of its own:
                        # spans can't time the past, so it rides as an
                        # attr and attribution folds it in as the
                        # "driver_backlog" stage
                        root.set("backlog_us",
                                 max(0, int((t_exec - target) * 1e6)))
                    try:
                        self.ops[a.op](a)
                    except AdmissionRejected:
                        outcome = OUTCOME_SHED
                        tracer.flag("shed")
                    finally:
                        end = time.perf_counter()
                        slo = self.slo_s.get(a.op)
                        if slo is not None and end - target > slo \
                                and outcome == OUTCOME_OK:
                            # over-SLO traces must survive tail sampling:
                            # they are the burst attribution evidence
                            tracer.flag("slow_slo")
            except BaseException as e:  # noqa: BLE001 - account, continue
                outcome = OUTCOME_ERROR
                err = e
            end = time.perf_counter()
            if sealed.is_set():
                # the report was finalized at the drain deadline: a
                # straggler completing now must not observe into the
                # NEXT run's histogram window or mutate a report the
                # sweep is already reading
                metrics.counter("loadgen_ops_total", op=a.op,
                                outcome="abandoned").inc()
                return
            lat = end - target
            if outcome == OUTCOME_OK:
                # completions only: the latency curve and the burst
                # tails must measure the same quantity — a microsecond
                # fast-fail shed would otherwise drag the per-class
                # percentiles DOWN exactly where the curve is supposed
                # to show degradation
                self._hists[a.op].observe(lat)
            metrics.counter("loadgen_ops_total", op=a.op,
                            outcome=outcome).inc()
            with lock:
                rep.records.append(OpOutcome(a, outcome, lat,
                                             end - t_exec))
                if err is not None and len(rep.error_samples) < 8:
                    rep.error_samples.append(f"{a.op}: {err!r:.200}")

        try:
            for a in schedule:
                target = t0 + a.t * time_scale
                now = time.perf_counter()
                if target > now:
                    time.sleep(target - now)
                    now = time.perf_counter()
                if now - target > LATE_SUBMIT_S:
                    rep.late_n += 1
                rep.fired_n += 1
                # latency basis: the later of schedule and submit —
                # pool backlog is the server's problem, dispatcher
                # drift is ours (counted in late_n, not in latency)
                futs.append(pool.submit(fire, a, max(target, now)))

            done, not_done = concurrent.futures.wait(
                futs, timeout=self.drain_timeout)
            rep.abandoned_n = len(not_done)
            sealed.set()
            pool.shutdown(wait=not not_done, cancel_futures=True)
        finally:
            sealed.set()
            sys.setswitchinterval(prev_si)
        rep.hist_after = {op: h.snapshot()
                          for op, h in self._hists.items()}
        rep.wall_s = time.perf_counter() - t0
        return rep


class _NullCM:
    def __enter__(self):
        return None

    def __exit__(self, *a):
        return False


_NULL_CM = _NullCM()
