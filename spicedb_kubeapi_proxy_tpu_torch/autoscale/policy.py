"""The autoscaler's pure decision kernel.

One call per controller tick: :meth:`AutoscalePolicy.observe` folds the
tick's :class:`Signals` into a direction (grow / shrink / hold) and
returns a :class:`Proposal` only when the direction has held for
``hysteresis_ticks`` CONSECUTIVE ticks and the cooldown since the last
fired proposal has elapsed. Everything here is deterministic and
clock-injected — the controller (and the tests) own time.

Guards, in decision order:

- **in-flight transition**: no proposal while a rebalance is active or
  an archived transition still owes GC (``begin_rebalance`` would
  refuse the shrink anyway — the policy never proposes what the
  planner must reject); the streak RESETS, so post-transition signals
  must re-earn the hysteresis from scratch;
- **grow** (capacity first): occupancy at/above ``grow_occupancy``, OR
  short-window SLO burn at/above ``grow_burn``, OR mean check latency
  at/above ``grow_latency_ms`` (0 disables the latency trigger) —
  bounded by ``max_groups``;
- **never-shrink-while-burning**: a shrink needs occupancy at/below
  ``shrink_occupancy`` AND burn strictly below ``burning_burn`` — an
  error budget burning at or past rate 1.0 means the fleet is already
  failing its objective, and removing capacity would be the controller
  amplifying an outage it exists to prevent — bounded by
  ``min_groups``.

Hysteresis is per-direction: a grow tick followed by a shrink tick
restarts the streak, so signal flapping around a threshold proposes
nothing (the classic thrash the cooldown alone would only slow down).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional


class AutoscaleError(ValueError):
    pass


@dataclass(frozen=True)
class PolicyConfig:
    """Operator knobs (``--autoscale-policy`` key=value CSV)."""

    min_groups: int = 1
    max_groups: int = 8
    grow_occupancy: float = 0.8
    shrink_occupancy: float = 0.3
    grow_burn: float = 2.0
    burning_burn: float = 1.0
    grow_latency_ms: float = 0.0  # 0 disables the latency trigger
    hysteresis_ticks: int = 3
    cooldown_seconds: float = 300.0

    def validate(self) -> "PolicyConfig":
        if not 1 <= self.min_groups <= self.max_groups:
            raise AutoscaleError(
                f"autoscale bounds must satisfy 1 <= min_groups "
                f"({self.min_groups}) <= max_groups "
                f"({self.max_groups})")
        if not 0.0 < self.grow_occupancy <= 1.0:
            raise AutoscaleError(
                f"grow_occupancy {self.grow_occupancy} must be in "
                "(0, 1]")
        if not 0.0 <= self.shrink_occupancy < self.grow_occupancy:
            raise AutoscaleError(
                f"shrink_occupancy {self.shrink_occupancy} must be in "
                f"[0, grow_occupancy={self.grow_occupancy}) — "
                "overlapping bands would thrash")
        if self.grow_burn <= 0 or self.burning_burn <= 0:
            raise AutoscaleError("burn thresholds must be > 0")
        if self.grow_latency_ms < 0:
            raise AutoscaleError("grow_latency_ms must be >= 0")
        if self.hysteresis_ticks < 1:
            raise AutoscaleError("hysteresis_ticks must be >= 1")
        if self.cooldown_seconds < 0:
            raise AutoscaleError("cooldown_seconds must be >= 0")
        return self


_POLICY_FIELDS = {
    "min_groups": int, "max_groups": int,
    "grow_occupancy": float, "shrink_occupancy": float,
    "grow_burn": float, "burning_burn": float,
    "grow_latency_ms": float,
    "hysteresis_ticks": int, "cooldown_seconds": float,
}


def parse_policy(spec: str) -> PolicyConfig:
    """``"max_groups=6,grow_occupancy=0.7"`` -> a validated config
    (unnamed knobs keep their defaults)."""
    kwargs = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        key, eq, val = part.partition("=")
        key = key.strip()
        conv = _POLICY_FIELDS.get(key)
        if not eq or conv is None:
            raise AutoscaleError(
                f"unknown autoscale policy knob {key!r} (known: "
                f"{', '.join(sorted(_POLICY_FIELDS))})")
        try:
            kwargs[key] = conv(val.strip())
        except ValueError:
            raise AutoscaleError(
                f"bad autoscale policy value {part!r}") from None
    return PolicyConfig(**kwargs).validate()


@dataclass(frozen=True)
class Signals:
    """One tick's observed state (controller-collected or injected)."""

    n_groups: int
    occupancy: float = 0.0     # max over groups, [0, 1]
    burn_rate: float = 0.0     # worst short-window SLO burn
    latency_ms: float = 0.0    # max mean engine check latency
    rebalance_active: bool = False
    gc_pending: bool = False   # an archived transition still owes GC


@dataclass(frozen=True)
class Proposal:
    action: str         # "grow" | "shrink"
    target_groups: int
    reason: str


class AutoscalePolicy:
    """Stateful hysteresis/cooldown wrapper around the pure direction
    function; one instance per controller."""

    def __init__(self, config: PolicyConfig, clock=time.monotonic):
        self.config = config.validate()
        self._clock = clock
        self._streak_action: Optional[str] = None
        self._streak = 0
        self._last_fired: Optional[float] = None

    def _direction(self, s: Signals) -> Optional[tuple]:
        c = self.config
        if s.occupancy >= c.grow_occupancy and s.n_groups < c.max_groups:
            return ("grow", f"occupancy {s.occupancy:.2f} >= "
                            f"{c.grow_occupancy:.2f}")
        if s.burn_rate >= c.grow_burn and s.n_groups < c.max_groups:
            return ("grow", f"SLO burn {s.burn_rate:.2f} >= "
                            f"{c.grow_burn:.2f}")
        if c.grow_latency_ms > 0 and s.latency_ms >= c.grow_latency_ms \
                and s.n_groups < c.max_groups:
            return ("grow", f"check latency {s.latency_ms:.1f}ms >= "
                            f"{c.grow_latency_ms:.1f}ms")
        if s.occupancy <= c.shrink_occupancy \
                and s.burn_rate < c.burning_burn \
                and s.n_groups > c.min_groups:
            return ("shrink", f"occupancy {s.occupancy:.2f} <= "
                              f"{c.shrink_occupancy:.2f}, burn "
                              f"{s.burn_rate:.2f} < "
                              f"{c.burning_burn:.2f}")
        return None

    def observe(self, s: Signals,
                now: Optional[float] = None) -> Optional[Proposal]:
        """Fold one tick; returns a proposal when the hysteresis streak
        completes outside the cooldown, else None."""
        ts = self._clock() if now is None else now
        if s.rebalance_active or s.gc_pending:
            # a transition in flight (or owed GC) owns the group space:
            # post-transition signals must re-earn the streak
            self._streak_action, self._streak = None, 0
            return None
        want = self._direction(s)
        if want is None:
            self._streak_action, self._streak = None, 0
            return None
        action, reason = want
        if action == self._streak_action:
            self._streak += 1
        else:
            self._streak_action, self._streak = action, 1
        if self._streak < self.config.hysteresis_ticks:
            return None
        if self._last_fired is not None \
                and ts - self._last_fired < self.config.cooldown_seconds:
            return None
        self._last_fired = ts
        self._streak_action, self._streak = None, 0
        target = s.n_groups + (1 if action == "grow" else -1)
        return Proposal(action, target, reason)


__all__ = ["AutoscaleError", "AutoscalePolicy", "PolicyConfig",
           "Proposal", "Signals", "parse_policy"]
