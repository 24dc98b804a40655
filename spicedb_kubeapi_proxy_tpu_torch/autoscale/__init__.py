"""SLO-driven elastic scale-out: grow/shrink proposals + controller.

A copy of the JAX package's ``autoscale/`` over the port's planner.

``policy.py`` is the pure decision kernel — signals in, proposal out,
with hysteresis, cooldown, and the never-shrink-while-burning guard;
``controller.py`` is the background loop that collects the signals
(SLO burn from obs/slo.py, per-group admission occupancy and check
latency over the ``load_status`` wire probe) and, in apply mode,
drives real map transitions through the existing rebalance
coordinator (scaleout/rebalance.py) — a grow appends a group, a
shrink retires the tail through ``shrink_map``. Dry-run is the
default: proposals are counted and surfaced on ``/readyz``, nothing
moves.
"""

from .policy import (
    AutoscaleError,
    AutoscalePolicy,
    PolicyConfig,
    Proposal,
    Signals,
    parse_policy,
)
from .controller import AutoscaleController

__all__ = [
    "AutoscaleController", "AutoscaleError", "AutoscalePolicy",
    "PolicyConfig", "Proposal", "Signals", "parse_policy",
]
