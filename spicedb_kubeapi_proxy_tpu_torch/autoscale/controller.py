"""The autoscale controller: signal collection + (optionally) acting.

A background tick loop around :class:`~.policy.AutoscalePolicy`:

- **collect** — SLO burn from the shared :class:`~..obs.slo.SLOMonitor`
  (worst short-window burn across objectives), per-group admission
  occupancy and mean engine check latency over the ``load_status``
  wire probe (in-process engines in tests have no probe and read 0 —
  tests inject ``signal_fn``), and the planner's transition state;
- **decide** — one ``policy.observe`` per tick; every proposal counts
  in ``autoscale_proposals_total{action=...}`` whether or not it acts;
- **act** — dry-run (the default) stops there, surfacing the latest
  proposal on ``/readyz``; ``mode="apply"`` drives the REAL transition
  through the existing coordinator: a grow appends one group (built by
  the injected ``grow_group_source`` — flag-configured endpoints in
  the proxy, loopback servers in tests), a shrink retires the tail via
  :func:`~..scaleout.rebalance.shrink_map`. Apply outcomes count in
  ``autoscale_transitions_total{action=...,outcome=...}``.

Failure posture: a tick that cannot collect or act logs + counts and
leaves the fleet EXACTLY as it was — the autoscaler is an optimizer,
never a single point of failure; actual transition safety (fail-closed
routing, crash recovery, GC ordering) lives entirely in the rebalance
protocol it drives.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Optional

from ..scaleout.rebalance import shrink_map
from ..scaleout.shardmap import ShardMap
from ..utils.metrics import metrics
from .policy import AutoscalePolicy, Proposal, Signals

log = logging.getLogger("sdbkp.torch.autoscale")


class AutoscaleController:
    """Owns the tick loop; one per planner. ``mode`` is ``"dry-run"``
    or ``"apply"``; ``grow_group_source(index)`` returns
    ``(endpoints, client)`` for a to-be-added group (apply-mode grows
    are refused without one); ``signal_fn()`` overrides collection."""

    def __init__(self, planner, policy: AutoscalePolicy,
                 mode: str = "dry-run",
                 slo_monitor=None, signal_fn=None,
                 grow_group_source=None,
                 tick_seconds: float = 15.0,
                 clock=time.monotonic,
                 coordinator_cfg: Optional[dict] = None):
        if mode not in ("dry-run", "apply"):
            raise ValueError(
                f"autoscale mode must be dry-run or apply, got {mode!r}")
        self.planner = planner
        self.policy = policy
        self.mode = mode
        self.slo_monitor = slo_monitor
        self._signal_fn = signal_fn
        self._grow_source = grow_group_source
        self.tick_seconds = float(tick_seconds)
        self._clock = clock
        self._coordinator_cfg = dict(coordinator_cfg or {})
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._last_proposal: Optional[dict] = None
        self._transitions = 0

    # -- signal collection ---------------------------------------------------

    def collect_signals(self) -> Signals:
        if self._signal_fn is not None:
            return self._signal_fn()
        p = self.planner
        occupancy = 0.0
        latency_ms = 0.0
        for c in list(p.groups):
            if not hasattr(c, "load_status"):
                continue  # in-process engine: no probe, reads 0
            try:
                st = c.load_status() or {}
            except Exception:  # noqa: BLE001 - probe is best-effort
                # an unreachable group is a failover/readiness problem,
                # not a scaling signal — the probe must not turn one
                # flaky host into a fleet-wide grow
                continue
            occupancy = max(occupancy, float(st.get("occupancy") or 0))
            latency_ms = max(latency_ms, float(st.get("check_ms") or 0))
        burn = 0.0
        if self.slo_monitor is not None:
            burn = float(self.slo_monitor.worst_burn())
        return Signals(
            n_groups=len(p.groups),
            occupancy=occupancy,
            burn_rate=burn,
            latency_ms=latency_ms,
            rebalance_active=p.rebalance_status() is not None,
            gc_pending=any(not t.gc_complete
                           for t in p._archived_transitions),
        )

    # -- decide / act --------------------------------------------------------

    def tick(self, now: Optional[float] = None) -> Optional[Proposal]:
        """One observe-decide-act cycle; returns the proposal (if any)
        so tests drive ticks synchronously."""
        ts = self._clock() if now is None else now
        try:
            signals = self.collect_signals()
        except Exception as e:  # noqa: BLE001 - collection best-effort
            log.warning("autoscale signal collection failed: %s", e)
            metrics.counter("autoscale_tick_errors_total").inc()
            return None
        proposal = self.policy.observe(signals, now=ts)
        if proposal is None:
            return None
        metrics.counter("autoscale_proposals_total",
                        action=proposal.action).inc()
        with self._lock:
            self._last_proposal = {
                "action": proposal.action,
                "target_groups": proposal.target_groups,
                "reason": proposal.reason,
                "mode": self.mode,
            }
        log.warning("autoscale proposal (%s): %s -> %d groups (%s)",
                    self.mode, proposal.action,
                    proposal.target_groups, proposal.reason)
        if self.mode == "apply":
            self._apply(proposal)
        return proposal

    def _apply(self, p: Proposal) -> None:
        try:
            if p.action == "grow":
                gi = len(self.planner.groups)
                if self._grow_source is None:
                    raise RuntimeError(
                        "autoscale apply-mode grow needs a "
                        "grow_group_source (no spare group endpoints "
                        "configured)")
                endpoints, client = self._grow_source(gi)
                old = self.planner.map
                new_map = ShardMap(
                    version=old.version + 1,
                    groups=tuple(old.groups) + (tuple(endpoints),),
                    virtual_nodes=old.virtual_nodes)
                new_clients = {gi: client} if client is not None else None
                self.planner.begin_rebalance(
                    new_map, new_clients=new_clients,
                    **self._coordinator_cfg)
            else:
                new_map = shrink_map(self.planner.map)
                self.planner.begin_rebalance(
                    new_map, **self._coordinator_cfg)
        except Exception as e:  # noqa: BLE001 - act must not kill loop
            metrics.counter("autoscale_transitions_total",
                            action=p.action, outcome="failed").inc()
            log.error("autoscale %s to %d groups failed to start: %s",
                      p.action, p.target_groups, e)
            return
        with self._lock:
            self._transitions += 1
        metrics.counter("autoscale_transitions_total",
                        action=p.action, outcome="started").inc()

    # -- lifecycle / status --------------------------------------------------

    def start(self) -> "AutoscaleController":
        if self._thread is not None:
            return self
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.tick_seconds):
                try:
                    self.tick()
                except Exception:  # noqa: BLE001 - loop must not die
                    metrics.counter("autoscale_tick_errors_total").inc()

        self._thread = threading.Thread(target=loop, name="autoscale",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=2 * self.tick_seconds + 1)

    def status(self) -> dict:
        """The ``/readyz`` ``autoscale:`` info-line document."""
        with self._lock:
            return {
                "mode": self.mode,
                "groups": len(self.planner.groups),
                "transitions": self._transitions,
                "last_proposal": (dict(self._last_proposal)
                                  if self._last_proposal else None),
            }


__all__ = ["AutoscaleController"]
