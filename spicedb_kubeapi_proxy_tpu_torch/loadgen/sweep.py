"""Offered-load sweeps: goodput/latency curves, knee, burst tails.

One sweep point = one open-loop run of the trace-shaped schedule at a
multiple of the base rate. Per point, the curve records offered vs
completed vs within-SLO goodput plus p50/p99/p99.9 per op class — the
percentiles come from ``loadgen_op_seconds`` histogram snapshot DELTAS
(utils/metrics.snapshot_delta_quantile), the same windowed machinery the
bench stage breakdowns use, so a sweep can run against a shared live
registry without resetting anyone's metrics.

On top of the curve:

- :func:`knee_estimate` — the offered load where goodput stops tracking
  offered load (the capacity number every subsequent engine-scaling PR
  is judged against);
- burst windows — p99/p99.9 per op class measured over each burst
  phase's time window only (raw per-arrival records: a burst is finer
  than a histogram window), answering "what does a watch storm do to
  the p99.9 of everyone else";
- per-stage tail attribution — the slowest burst window's kept traces
  (tail sampling keeps slow/shed traces unconditionally) aggregated by
  span name into "where did the tail spend its time".
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

from ..utils.metrics import snapshot_delta_quantile
from .driver import OUTCOME_OK, DriverReport, OpenLoopDriver
from .schedule import ScheduleConfig, build_schedule, burst_windows

# goodput tracks offered load until it doesn't: the knee is where the
# delivered fraction first drops below this
KNEE_GOOD_FRACTION = 0.85


@dataclass
class SweepPoint:
    multiplier: float
    offered_rps: float
    fired_n: int
    completed_n: int
    good_n: int  # completed within the op's SLO
    shed_n: int
    error_n: int
    late_n: int
    classes: dict = field(default_factory=dict)  # op -> quantiles/ms
    report: Optional[DriverReport] = None

    @property
    def completed_rps(self) -> float:
        d = self.report.duration_s if self.report else 0.0
        return self.completed_n / d if d else 0.0

    @property
    def goodput_rps(self) -> float:
        d = self.report.duration_s if self.report else 0.0
        return self.good_n / d if d else 0.0

    def to_dict(self) -> dict:
        return {
            "multiplier": self.multiplier,
            "offered_rps": round(self.offered_rps, 1),
            "completed_rps": round(self.completed_rps, 1),
            "goodput_rps": round(self.goodput_rps, 1),
            "shed": self.shed_n,
            "errors": self.error_n,
            "late": self.late_n,
            "classes": self.classes,
        }


@dataclass
class SweepResult:
    points: list  # [SweepPoint]
    knee_rps: Optional[float]
    knee_saturated: bool  # False = knee never reached (lower bound)
    bursts: dict = field(default_factory=dict)
    tail_attribution: dict = field(default_factory=dict)
    slo_attainment: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "curve": [p.to_dict() for p in self.points],
            "knee_rps": (None if self.knee_rps is None
                         else round(self.knee_rps, 1)),
            "knee_saturated": self.knee_saturated,
            "bursts": self.bursts,
            "tail_attribution": self.tail_attribution,
            "slo_attainment": self.slo_attainment,
        }


def _quantiles_ms(rep: DriverReport, op: str) -> dict:
    """p50/p99/p99.9 for one op class over this run's histogram window
    (snapshot deltas; None keys omitted — an op the mix never drew has
    no percentiles, not zero ones)."""
    b, a = rep.hist_before.get(op), rep.hist_after.get(op)
    out = {}
    for label, q in (("p50_ms", 0.5), ("p99_ms", 0.99),
                     ("p999_ms", 0.999)):
        v = snapshot_delta_quantile(b, a, q)
        if v is not None:
            out[label] = round(v * 1e3, 3)
    return out


def knee_estimate(points: list) -> tuple[Optional[float], bool]:
    """(knee offered-load rps, saturated?) from the curve: the first
    point whose goodput/offered drops below :data:`KNEE_GOOD_FRACTION`,
    linearly interpolated from the last healthy point. When every point
    is healthy the knee was never reached — the largest offered load is
    returned as a LOWER BOUND with ``saturated=False``."""
    healthy_frac = []
    for p in points:
        if p.offered_rps <= 0:
            continue
        healthy_frac.append((p.offered_rps,
                             p.goodput_rps / p.offered_rps))
    if not healthy_frac:
        return None, False
    healthy_frac.sort()
    prev = None
    for off, frac in healthy_frac:
        if frac < KNEE_GOOD_FRACTION:
            if prev is None:
                return off, True
            poff, pfrac = prev
            # interpolate the crossing between the two points
            t = (pfrac - KNEE_GOOD_FRACTION) / max(1e-9, pfrac - frac)
            return poff + t * (off - poff), True
        prev = (off, frac)
    return healthy_frac[-1][0], False


def _burst_stats(rep: DriverReport, cfg: ScheduleConfig) -> dict:
    """Per burst phase: p50/p99/p99.9 per op class over the window's
    completed arrivals (raw records — exact, not bucketized), plus
    shed/error counts and the window's epoch bounds (trace
    correlation)."""
    out = {}
    for name, w0, w1 in burst_windows(cfg):
        in_window = [r for r in rep.records
                     if w0 <= r.arrival.t < w1]
        by_op: dict = {}
        shed = err = 0
        for r in in_window:
            if r.outcome == OUTCOME_OK:
                by_op.setdefault(r.arrival.op, []).append(r.latency_s)
            elif r.outcome == "shed":
                shed += 1
            else:
                err += 1
        classes = {}
        for op, lats in sorted(by_op.items()):
            arr = np.asarray(lats)
            classes[op] = {
                "n": len(lats),
                "p50_ms": round(float(np.percentile(arr, 50)) * 1e3, 3),
                "p99_ms": round(float(np.percentile(arr, 99)) * 1e3, 3),
                "p999_ms": round(
                    float(np.percentile(arr, 99.9)) * 1e3, 3),
            }
        out[name] = {
            "n": len(in_window), "shed": shed, "errors": err,
            "window_epoch": [rep.start_epoch + w0, rep.start_epoch + w1],
            "window_rel": [w0, w1],
            "classes": classes,
        }
    return out


def _worst_burst(bursts: dict) -> Optional[str]:
    """The burst phase with the largest completed-op p99.9 across its
    op classes. A window whose arrivals were ALL shed/errored has no
    completions to rank by — and is the worst case by definition, so it
    outranks every completed window by its rejection count."""
    worst, worst_key = None, None
    for name, b in bursts.items():
        starved = b["n"] > 0 and not b["classes"]
        p999 = max((st["p999_ms"] for st in b["classes"].values()),
                   default=-1.0)
        key = (1, b["shed"] + b["errors"]) if starved else (0, p999)
        if worst_key is None or key > worst_key:
            worst, worst_key = name, key
    return worst


def tail_attribution(window_rel: list, limit: int = 1024,
                     point: Optional[float] = None) -> dict:
    """Aggregate the trace ring's kept traces whose arrival was
    SCHEDULED inside the window (the driver stamps the root ``macro_op``
    span with its schedule-relative ``sched`` attr — execution time is
    useless here, a backlogged op runs long after its burst) into
    per-stage totals. ``point`` restricts to traces stamped with that
    sweep point's ``point`` attr — every point replays the same seeded
    schedule, so without it a healthy 0.5x run's traces would fall
    inside the 3.5x run's burst windows and dilute the overload
    evidence. Tail sampling keeps slow/shed/error traces
    unconditionally, so what's in the ring for a burst window IS the
    tail evidence: the share of stage time answers "the p99.9 lives in
    which stage"."""
    from ..obs.trace import tracer

    t0, t1 = window_rel
    stages: dict = {}
    n = 0
    for t in tracer.recent(limit):
        root = next((s for s in t["spans"] if s["name"] == "macro_op"),
                    None)
        if root is None:
            continue
        if point is not None and root["attrs"].get("point") != point:
            continue
        sched = root["attrs"].get("sched")
        if sched is None or not (t0 <= sched < t1):
            continue
        if not (t["flags"].get("slow_slo") or t["flags"].get("shed")
                or t["flags"].get("error")):
            continue
        n += 1
        # the open-loop backlog (arrival -> execution) rides as a root
        # attr — a span can't time the past — and is folded in as a
        # first-class stage: under overload it IS the tail
        stages["driver_backlog"] = stages.get("driver_backlog", 0) \
            + int(root["attrs"].get("backlog_us", 0))
        for s in t["spans"]:
            if s["name"] == "macro_op":
                continue  # the root envelope, not a stage
            stages[s["name"]] = stages.get(s["name"], 0) \
                + s["duration_us"]
    total = sum(stages.values())
    return {
        "traces": n,
        "stages_us": dict(sorted(stages.items(),
                                 key=lambda kv: -kv[1])),
        "stage_share": {k: round(v / total, 3)
                        for k, v in sorted(stages.items(),
                                           key=lambda kv: -kv[1])}
        if total else {},
    }


def run_sweep(make_config: Callable[[float], ScheduleConfig],
              ops: dict, multipliers, slo_s: dict,
              max_workers: int = 32,
              trace_ops: bool = True,
              drain_timeout: float = 30.0,
              on_point: Optional[Callable] = None) -> SweepResult:
    """Run one open-loop point per multiplier and assemble the curves.

    ``make_config(multiplier)`` returns that point's schedule config
    (same seed across points ⇒ the same trace shape, scaled); burst and
    attribution stats come from the HIGHEST multiplier's run — the tail
    under the worst offered load is the one the capacity claims are
    judged on."""
    points: list[SweepPoint] = []
    last_cfg = None
    for m in sorted(multipliers):
        cfg = make_config(m)
        last_cfg = cfg
        schedule = build_schedule(cfg)
        driver = OpenLoopDriver(ops, max_workers=max_workers,
                                slo_s=slo_s, trace_ops=trace_ops,
                                drain_timeout=drain_timeout,
                                trace_attrs={"point": m})
        rep = driver.run(schedule, duration=cfg.duration)
        good = shed = err = comp = 0
        for r in rep.records:
            if r.outcome == OUTCOME_OK:
                comp += 1
                slo = slo_s.get(r.arrival.op)
                if slo is None or r.latency_s <= slo:
                    good += 1
            elif r.outcome == "shed":
                shed += 1
            else:
                err += 1
        pt = SweepPoint(
            multiplier=m, offered_rps=rep.offered_rps,
            fired_n=rep.fired_n, completed_n=comp, good_n=good,
            shed_n=shed, error_n=err, late_n=rep.late_n,
            classes={op: q for op in sorted(driver.ops)
                     if (q := _quantiles_ms(rep, op))},
            report=rep)
        points.append(pt)
        if on_point is not None:
            on_point(pt)
    knee, saturated = knee_estimate(points)
    result = SweepResult(points=points, knee_rps=knee,
                         knee_saturated=saturated)
    if points and last_cfg is not None:
        top = points[-1]
        result.bursts = _burst_stats(top.report, last_cfg)
        worst = _worst_burst(result.bursts)
        if worst is not None:
            result.tail_attribution = {
                "burst": worst,
                **tail_attribution(
                    result.bursts[worst]["window_rel"],
                    point=top.multiplier),
            }
        # end-of-sweep SLO attainment per op class at the top point
        att = {}
        per: dict = {}
        for r in top.report.records:
            c = per.setdefault(r.arrival.op, [0, 0])
            c[0] += 1
            if r.outcome == OUTCOME_OK:
                slo = slo_s.get(r.arrival.op)
                if slo is None or r.latency_s <= slo:
                    c[1] += 1
        for op, (n, g) in sorted(per.items()):
            att[op] = round(g / n, 4) if n else None
        result.slo_attainment = att
    return result
