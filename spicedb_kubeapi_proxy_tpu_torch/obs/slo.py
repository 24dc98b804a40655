"""Live SLO monitor: declared objectives + multi-window burn rates.

An :class:`Objective` declares what "good" means for one operation class:
a latency threshold (observations at or under it are good) and a target
good fraction (e.g. 0.999 = "99.9% of checks complete within 25ms").
Badness has two sources, both read from the EXISTING instrumentation —
no new hot-path hooks:

- latency: the objective's histogram family (``utils/metrics.py``
  windowed snapshots — the same machinery bench.py stage breakdowns
  use), counting observations above the threshold;
- availability: optional counter families (shed / error totals) whose
  window delta is added to the bad count AND the event total — a shed
  request never completed, so it can't hide in the latency histogram.

The monitor samples every registered source on a fixed tick into a
bounded ring, and computes, per objective and per window (default
1m/5m/1h), the **burn rate**: ``bad_fraction / (1 - target)``. Burn 1.0
means the error budget is being spent exactly at the rate that exhausts
it by the end of the SLO period; >1 burns faster (the standard
multi-window multi-burn alerting input). Exposed three ways:

- ``slo_burn_rate{objective=..,window=..}`` / ``slo_attainment{..}``
  gauges in the shared registry (scraped at ``/metrics``),
- :meth:`SLOMonitor.status` — the JSON document ``/debug/slo`` serves,
- the bench macro phase, which reports end-of-sweep attainment per class.

Latency goodness is bucket-resolution: "good" counts observations in
buckets whose upper bound is <= the threshold (+epsilon so a threshold
equal to a bound includes its own bucket). Declare thresholds on or near
bucket bounds — the default bucket ladder covers 0.5ms..10s.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Optional

from ..utils.metrics import metrics

DEFAULT_WINDOWS = (60.0, 300.0, 3600.0)

# objective -> (histogram family, label filter, bad-counter families).
# These are the op classes the macrobench drives and the admission
# controller classifies; the latency sources are the histograms those
# code paths already observe.
_CLASS_SOURCES = {
    "check": ("engine_check_seconds", {},
              (("admission_shed_total", {"class": "check"}),
               ("admission_shed_total", {"class": "bulk-check"}))),
    "lookup": ("engine_lookup_seconds", {},
               (("admission_shed_total", {"class": "lookup-prefilter"}),)),
    "watch": ("watchhub_recompute_seconds", {},
              (("admission_shed_total", {"class": "watch-recompute"}),)),
    "request": ("proxy_request_seconds", {}, ()),
}


class SLOError(Exception):
    pass


@dataclass(frozen=True)
class Objective:
    """One declared objective: ``target`` fraction of ``name``-class
    events must be good (complete, at or under ``latency_ms``)."""

    name: str
    latency_ms: float
    target: float  # good fraction, e.g. 0.999
    histogram: str = ""  # metric family holding the class's latencies
    hist_labels: dict = field(default_factory=dict)
    # counter families whose window delta counts as bad AND as events
    # (sheds/errors never reach the latency histogram)
    bad_counters: tuple = ()


def parse_objectives(spec: str) -> list[Objective]:
    """``"check=25:99.9,lookup=100:99"`` -> objectives (latency ms :
    target percent). Classes must be known (the latency source is wired
    per class); raises :class:`SLOError` on anything malformed."""
    out = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, eq, rest = part.partition("=")
        name = name.strip()
        if not eq or name not in _CLASS_SOURCES:
            raise SLOError(
                f"unknown SLO class {name!r} (known: "
                f"{', '.join(sorted(_CLASS_SOURCES))}; format "
                "class=latency_ms:target_pct)")
        lat, colon, pct = rest.partition(":")
        try:
            latency_ms = float(lat)
            target = float(pct) / 100.0 if colon else 0.99
        except ValueError:
            raise SLOError(
                f"bad SLO spec {part!r} (format class=latency_ms"
                ":target_pct)") from None
        if latency_ms <= 0 or not 0.0 < target < 1.0:
            raise SLOError(
                f"bad SLO spec {part!r}: latency must be > 0 ms and "
                "target in (0, 100) percent")
        hist, labels, bad = _CLASS_SOURCES[name]
        out.append(Objective(name, latency_ms, target, hist,
                             dict(labels), bad))
    if not out:
        raise SLOError("empty SLO objective spec")
    return out


def default_objectives() -> list[Objective]:
    return parse_objectives("check=25:99.9,lookup=100:99,request=250:99")


class SLOMonitor:
    """Samples objective sources on a tick; answers burn-rate queries.

    The ring holds ``(ts, {objective: (events, bad)})`` cumulative
    samples; a window's burn rate is the delta between the newest sample
    and the oldest one inside the window. Ticking is either driven by
    the owned daemon thread (:meth:`start`) or called directly
    (:meth:`tick`) — tests and the bench sweep inject their own clock
    and cadence."""

    def __init__(self, objectives, windows=DEFAULT_WINDOWS,
                 tick_seconds: float = 5.0, clock=time.monotonic,
                 registry=metrics):
        if not objectives:
            raise SLOError("SLOMonitor needs at least one objective")
        self.objectives = list(objectives)
        self.windows = tuple(sorted(float(w) for w in windows))
        if not self.windows or self.windows[0] <= 0:
            raise SLOError("SLO windows must be > 0 seconds")
        self.tick_seconds = float(tick_seconds)
        self._clock = clock
        self._registry = registry
        self._lock = threading.Lock()
        # samples are pruned by AGE (older than the longest window plus
        # slack), not by count: every /debug/slo read also appends a
        # sample, and a count-sized ring would silently shrink the span
        # the long windows actually measure under frequent reads. The
        # count cap is only a memory backstop.
        self._ring: list = []  # [(ts, {name: (events, bad)})]
        self._max_samples = 50_000
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        for o in self.objectives:
            registry.gauge("slo_objective_latency_ms",
                           objective=o.name).set(o.latency_ms)
            registry.gauge("slo_objective_target",
                           objective=o.name).set(o.target)
        self.tick()  # the baseline sample: burn rates read 0 until traffic

    # -- sampling -------------------------------------------------------------

    def _sample_objective(self, o: Objective) -> tuple[float, float]:
        """Cumulative (events, bad) for one objective right now."""
        events = bad = 0.0
        snap = self._registry.hist_snapshot(o.histogram, **o.hist_labels)
        if snap is not None:
            events += snap["n"]
            thresh = o.latency_ms / 1e3 * (1 + 1e-9)
            good = sum(c for b, c in zip(snap["buckets"], snap["counts"])
                       if b <= thresh)
            bad += snap["n"] - good
        for cname, clabels in o.bad_counters:
            v = self._registry.counter(cname, **clabels).value
            events += v
            bad += v
        return events, bad

    def tick(self, now: Optional[float] = None) -> None:
        """Take one cumulative sample and refresh the ``slo_*`` gauges."""
        ts = self._clock() if now is None else now
        sample = {o.name: self._sample_objective(o)
                  for o in self.objectives}
        with self._lock:
            self._ring.append((ts, sample))
            cutoff = ts - self.windows[-1] - 2 * self.tick_seconds
            drop = 0
            while drop < len(self._ring) - 2 \
                    and self._ring[drop][0] < cutoff:
                drop += 1
            if drop:
                del self._ring[:drop]
            if len(self._ring) > self._max_samples:
                del self._ring[:len(self._ring) - self._max_samples]
        for o in self.objectives:
            for w, st in self._window_stats(o.name, ts).items():
                wl = _wlabel(w)
                self._registry.gauge("slo_burn_rate", objective=o.name,
                                     window=wl).set(st["burn_rate"])
                self._registry.gauge(
                    "slo_attainment", objective=o.name,
                    window=wl).set(
                        st["attainment"] if st["attainment"] is not None
                        else 1.0)

    # -- queries --------------------------------------------------------------

    def _window_stats(self, name: str, now: Optional[float] = None
                      ) -> dict:
        o = next(ob for ob in self.objectives if ob.name == name)
        ts = self._clock() if now is None else now
        with self._lock:
            ring = list(self._ring)
        if not ring:
            return {w: {"events": 0, "bad": 0, "attainment": None,
                        "burn_rate": 0.0} for w in self.windows}
        newest_ts, newest = ring[-1]
        out = {}
        for w in self.windows:
            cutoff = ts - w
            # base = the NEWEST sample at or before the cutoff (the
            # boundary sample just outside the window) so the delta
            # always spans at least the window — a window shorter than
            # the sampling cadence must measure a slightly longer span,
            # never read empty (burn 0 during an outage). Fall back to
            # the first sample ever: a young process's 1h window is its
            # whole lifetime.
            base = ring[0]
            for entry in ring:
                if entry[0] <= cutoff:
                    base = entry
                else:
                    break
            ev = newest.get(name, (0, 0))[0] - base[1].get(name, (0, 0))[0]
            bd = newest.get(name, (0, 0))[1] - base[1].get(name, (0, 0))[1]
            if ev <= 0:
                out[w] = {"events": 0, "bad": 0, "attainment": None,
                          "burn_rate": 0.0}
                continue
            frac_bad = max(0.0, min(1.0, bd / ev))
            out[w] = {
                "events": int(ev),
                "bad": int(bd),
                "attainment": 1.0 - frac_bad,
                "burn_rate": frac_bad / max(1e-9, 1.0 - o.target),
            }
        return out

    def worst_burn(self, window: Optional[float] = None) -> float:
        """The hottest burn rate across every objective at one window
        (default: the SHORTEST — the fast-burn signal the autoscaler
        folds into its grow/never-shrink decisions). 0.0 when no
        traffic has flowed."""
        w = self.windows[0] if window is None else float(window)
        ts = self._clock()
        worst = 0.0
        for o in self.objectives:
            st = self._window_stats(o.name, ts).get(w)
            if st is not None:
                worst = max(worst, float(st["burn_rate"]))
        return worst

    def status(self) -> dict:
        """The ``/debug/slo`` document: every declared objective with its
        per-window burn rates and attainment."""
        ts = self._clock()
        return {
            "windows_seconds": list(self.windows),
            "tick_seconds": self.tick_seconds,
            "objectives": [
                {
                    "name": o.name,
                    "latency_ms": o.latency_ms,
                    "target": o.target,
                    "histogram": o.histogram,
                    "windows": {_wlabel(w): st for w, st in
                                self._window_stats(o.name, ts).items()},
                }
                for o in self.objectives
            ],
        }

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> None:
        """Start the owned sampling thread (idempotent)."""
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.tick_seconds):
                try:
                    self.tick()
                except Exception:  # noqa: BLE001 - monitor must not die
                    metrics.counter("slo_tick_errors_total").inc()

        self._thread = threading.Thread(target=loop, name="slo-monitor",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=2 * self.tick_seconds + 1)


def _wlabel(w: float) -> str:
    return f"{int(w)}s"
