"""Seeded, deterministic fault schedules over the named fault space.

A :class:`FaultSchedule` is to faults what loadgen/schedule.py is to
arrivals: every random decision is PRE-DRAWN from one seeded derivation
at construction time, so identical seeds produce identical fault
histories — across processes (the wire-armed engine hosts rebuild the
same decision tables from the same ``(seed, site, p)``) and across
re-runs (the campaign reproducibility pin). Nothing draws randomness at
hit time.

The fault space is the registry of named sites the production code
already carries (utils/failpoints.py): client-side transport sites
(``upstream.connect``/``upstream.read``, ``engine.connect``/
``engine.read``), server-side dispatch/response sites
(``engine.dispatch``, ``engine.respond``), and the mirror-stream sites
(``mirror.partition``, ``mirror.heartbeat``). Each :class:`FaultSpec`
names a site, an action — ``error`` | ``drop`` | ``delay:<ms>`` |
``crash`` — a per-hit probability, and a trigger budget.

Schedules are armable locally (:meth:`FaultSchedule.arm`) or over the
wire on subprocess engine hosts via the flag-gated ``chaos_arm`` op
(engine/remote.py, ``--enable-chaos-ops``): the host reconstructs the
schedule from its wire form and arms byte-identical decision tables —
:meth:`digest` fingerprints them, so the campaign can assert that every
process in a topology is executing the same fault plan.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass
from typing import Optional

from ..utils.failpoints import (
    ACTION_CRASH,
    ACTION_DELAY,
    ACTION_DROP,
    ACTION_ERROR,
    ACTIONS,
    DECISION_HORIZON,
    FaultRule,
    decision_sequence,
    failpoints,
)


class ChaosScheduleError(ValueError):
    pass


def parse_action(spec: str) -> tuple[str, float]:
    """``"error" | "drop" | "crash" | "delay:<ms>"`` -> (action,
    delay_seconds)."""
    if spec.startswith("delay:"):
        try:
            ms = float(spec.split(":", 1)[1])
        except ValueError:
            raise ChaosScheduleError(
                f"malformed delay action {spec!r} (want delay:<ms>)"
            ) from None
        if ms < 0:
            raise ChaosScheduleError("delay must be >= 0 ms")
        return ACTION_DELAY, ms / 1000.0
    if spec not in ACTIONS or spec == ACTION_DELAY:
        raise ChaosScheduleError(
            f"unknown fault action {spec!r} "
            f"(want error | drop | delay:<ms> | crash)")
    return spec, 0.0


def format_action(action: str, delay_s: float) -> str:
    if action == ACTION_DELAY:
        return f"delay:{delay_s * 1000.0:g}"
    return action


@dataclass(frozen=True)
class FaultSpec:
    """One site's plan: fire ``action`` with probability ``p`` on each
    hit, at most ``budget`` times total."""

    site: str
    action: str = "error"  # error | drop | delay:<ms> | crash
    p: float = 1.0
    budget: int = DECISION_HORIZON

    def __post_init__(self):
        act, delay_s = parse_action(self.action)  # validates
        if not 0.0 < self.p <= 1.0:
            raise ChaosScheduleError("fault probability must be in (0, 1]")
        if self.budget < 1:
            raise ChaosScheduleError("fault budget must be >= 1")
        object.__setattr__(self, "_act", act)
        object.__setattr__(self, "_delay_s", delay_s)

    @property
    def kind(self) -> str:
        return self._act  # type: ignore[attr-defined]

    @property
    def delay_s(self) -> float:
        return self._delay_s  # type: ignore[attr-defined]


class FaultSchedule:
    """A seeded plan over one or more sites (see module docstring)."""

    def __init__(self, seed: int, specs: list[FaultSpec]):
        self.seed = int(seed)
        self.specs = [s if isinstance(s, FaultSpec) else FaultSpec(**s)
                      for s in specs]
        seen = set()
        for s in self.specs:
            if s.site in seen:
                raise ChaosScheduleError(
                    f"site {s.site!r} appears twice in one schedule")
            seen.add(s.site)

    # -- determinism ---------------------------------------------------------

    def decisions(self, spec: FaultSpec) -> Optional[list[bool]]:
        """The pre-drawn decision table a host will arm for ``spec``
        (None for p=1 always-fire rules) — exposed so tests can pin that
        re-deriving from the same seed is byte-identical."""
        if spec.p >= 1.0:
            return None
        return decision_sequence(self.seed, spec.site, spec.p)

    def digest(self) -> str:
        """SHA-256 over the canonical JSON of every site's action,
        budget, and FULL decision table: two schedules with equal
        digests will perform identical fault decisions at every hit
        index, in any process."""
        doc = {
            "seed": self.seed,
            "sites": [
                {"site": s.site,
                 "action": format_action(s.kind, s.delay_s),
                 "p": round(s.p, 6), "budget": s.budget,
                 "decisions": self.decisions(s)}
                for s in sorted(self.specs, key=lambda s: s.site)
            ],
        }
        return hashlib.sha256(
            json.dumps(doc, separators=(",", ":"),
                       sort_keys=True).encode()).hexdigest()

    # -- arming --------------------------------------------------------------

    def rules(self) -> list[FaultRule]:
        return [
            FaultRule(s.site, s.kind, budget=s.budget, p=s.p,
                      seed=self.seed, delay_s=s.delay_s)
            for s in self.specs
        ]

    def arm(self, registry=failpoints) -> None:
        """Install every site's rule into ``registry`` (the process-
        global failpoint registry by default — the same one the
        production fault sites consult)."""
        for r in self.rules():
            registry.arm(r)

    def disarm(self, registry=failpoints) -> None:
        for s in self.specs:
            registry.disable(s.site)

    # -- wire form -----------------------------------------------------------

    def encode(self) -> dict:
        """JSON-able wire form for the ``chaos_arm`` op. Decision tables
        do NOT ride the wire: the receiving host re-derives them from
        ``(seed, site, p)`` — same derivation, same bytes — which keeps
        the frame tiny and makes tampering with the tables impossible
        without changing the digest."""
        return {
            "seed": self.seed,
            "faults": [
                {"site": s.site,
                 "action": format_action(s.kind, s.delay_s),
                 "p": s.p, "budget": s.budget}
                for s in self.specs
            ],
        }

    @classmethod
    def parse(cls, doc: dict) -> "FaultSchedule":
        if not isinstance(doc, dict):
            raise ChaosScheduleError("fault schedule must be an object")
        try:
            seed = int(doc["seed"])
            faults = doc["faults"]
        except (KeyError, TypeError, ValueError):
            raise ChaosScheduleError(
                "fault schedule needs {seed, faults: [...]}") from None
        specs = []
        for f in faults:
            try:
                specs.append(FaultSpec(
                    site=str(f["site"]),
                    action=str(f.get("action", ACTION_ERROR)),
                    p=float(f.get("p", 1.0)),
                    budget=int(f.get("budget", DECISION_HORIZON))))
            except (KeyError, TypeError, ValueError) as e:
                raise ChaosScheduleError(
                    f"malformed fault spec {f!r}: {e}") from None
        return cls(seed, specs)


def brownout_schedule(seed: int, delay_ms: float = 40.0,
                      delay_p: float = 0.5, error_p: float = 0.15,
                      budget: int = DECISION_HORIZON) -> FaultSchedule:
    """The stock single-shard brownout: dispatches slowed with
    probability ``delay_p`` plus a smaller rate of responses dropped on
    the floor — the mixed degradation mode that exercises retry
    amplification (delays time out, drops look like transport deaths,
    both trigger client retries at every layer)."""
    return FaultSchedule(seed, [
        FaultSpec("engine.dispatch", f"delay:{delay_ms:g}", p=delay_p,
                  budget=budget),
        FaultSpec("engine.respond", "drop", p=error_p, budget=budget),
    ])


__all__ = [
    "ACTION_CRASH", "ACTION_DELAY", "ACTION_DROP", "ACTION_ERROR",
    "ChaosScheduleError", "FaultSchedule", "FaultSpec",
    "brownout_schedule", "format_action", "parse_action",
]
