"""Open-loop, trace-shaped load generation: a copy of the JAX package's
``loadgen/`` over the port's metrics registry and tracer. The same
``ScheduleConfig`` gives the same arrivals in both packages, byte for
byte.

Every earlier bench phase is closed-loop: each worker waits for its
response before issuing the next request, so the offered load collapses
to whatever the server can absorb and the tail you measure is the tail
of a system that is never actually behind. Production traffic is
open-loop — watch storms, fleet-wide ``kubectl get`` waves, operator
reconcile loops fire on their own schedule whether or not the proxy is
keeping up — and that is the regime where p99.9 and goodput-vs-offered-
load curves mean something.

- :mod:`.schedule` — arrival-time schedules: Poisson baseline modulated
  by named burst phases, Zipf-skewed tenants, one seeded RNG (identical
  seed ⇒ identical schedule, byte for byte).
- :mod:`.driver` — the open-loop driver: fires each arrival at its
  scheduled time and NEVER waits for a response before the next one;
  sheds/errors/lateness are recorded, not absorbed.
- :mod:`.sweep` — offered-load sweeps producing goodput and latency
  curves (p50/p99/p99.9 from windowed histogram snapshots), a knee
  estimate, burst-window tails, and per-stage tail attribution from the
  trace ring's always-kept slow/shed traces.
"""

from .driver import DriverReport, OpenLoopDriver, OpOutcome
from .schedule import (
    Arrival,
    BurstPhase,
    ScheduleConfig,
    build_schedule,
    trace_shaped_config,
)
from .sweep import SweepResult, knee_estimate, run_sweep

__all__ = [
    "Arrival",
    "BurstPhase",
    "DriverReport",
    "OpenLoopDriver",
    "OpOutcome",
    "ScheduleConfig",
    "SweepResult",
    "build_schedule",
    "knee_estimate",
    "run_sweep",
    "trace_shaped_config",
]
