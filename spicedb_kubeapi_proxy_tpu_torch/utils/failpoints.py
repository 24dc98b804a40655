"""Fault-injection failpoints.

Mirrors the reference's pkg/failpoints/failpoints_on.go:19-48: named panic
sites armed with per-name call budgets. The reference compiles them in via a
build tag; here they are armed at runtime (API or
``FAILPOINTS=name:count,name2`` env) and are a no-op when not armed, so they
stay in production code paths like the reference's activity hooks
(activity.go:48,61,153,155,176,213).

The chaos campaign (chaos/) extends the raise-N-times model to seeded,
deterministic FAULT SCHEDULES over the same named sites: each armed rule
carries an ACTION (``error`` raise, ``drop`` a frame, ``delay`` the op,
``crash`` the process), a trigger budget, and — for probabilistic rules —
a decision sequence PRE-DRAWN from a seeded RNG keyed by ``(seed, site,
p)``, so the k-th hit of a site decides identically in every process and
every re-run of the same seed. Env arming accepts ``name:p=0.25`` backed
by the same derivation (seed from ``CHAOS_SEED``, default 0), so even
env-armed probabilistic sites stay byte-for-byte reproducible.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import random
import signal
import threading
import time
from typing import Optional

log = logging.getLogger("sdbkp.torch.failpoints")

# fault actions a rule can carry; ``hit`` sites surface error/drop as a
# raised FailPointError (the transport-failure classification chaos tests
# drive), ``branch`` sites surface them as True (the frame/heartbeat is
# dropped); delay sleeps and lets the op proceed; crash SIGKILLs the
# process — the hard-death the persistence/failover recovery paths are
# specified against
ACTION_ERROR = "error"
ACTION_DROP = "drop"
ACTION_DELAY = "delay"
ACTION_CRASH = "crash"

ACTIONS = (ACTION_ERROR, ACTION_DROP, ACTION_DELAY, ACTION_CRASH)

# how many decisions a probabilistic rule pre-draws: past this many hits
# the rule stops firing (deterministically) rather than drawing fresh
# randomness at hit time
DECISION_HORIZON = 4096


class FailPointError(RuntimeError):
    """Raised at an armed failpoint (the reference panics; activities catch
    this to simulate side-effect-edge crashes)."""

    def __init__(self, name: str):
        super().__init__(f"failpoint {name!r} triggered")
        self.name = name


def decision_sequence(seed, name: str, p: float,
                      horizon: int = DECISION_HORIZON) -> list[bool]:
    """The pre-drawn Bernoulli decisions for a probabilistic rule: the
    ONE derivation shared by env arming, API arming, and the wire-armed
    chaos schedules — identical ``(seed, site, p)`` means identical
    decisions in every process, which is what makes a multi-process
    fault history reproducible from one seed."""
    rng = random.Random(f"{seed}:{name}:{p:.6f}")
    return [rng.random() < p for _ in range(horizon)]


class FaultRule:
    """One armed site: action + budget + (optional) pre-drawn decisions.

    ``budget`` counts TRIGGERS, not hits — a probabilistic rule stays
    armed through declined hits. The legacy ``enable(name, n)`` is the
    special case (error action, p=1, budget=n)."""

    __slots__ = ("name", "action", "budget", "delay_s", "p", "seed",
                 "decisions", "hits", "fired")

    def __init__(self, name: str, action: str = ACTION_ERROR,
                 budget: int = 1, p: float = 1.0, seed=None,
                 delay_s: float = 0.0):
        if action not in ACTIONS:
            raise ValueError(f"unknown fault action {action!r}")
        if budget < 1:
            raise ValueError("fault budget must be >= 1")
        if not 0.0 < p <= 1.0:
            raise ValueError("fault probability must be in (0, 1]")
        self.name = name
        self.action = action
        self.budget = budget
        self.delay_s = max(0.0, float(delay_s))
        self.p = p
        self.seed = seed
        self.decisions = (None if p >= 1.0
                          else decision_sequence(seed, name, p))
        self.hits = 0
        self.fired = 0

    def decide(self) -> Optional[str]:
        """One hit's verdict (called under the registry lock): the action
        to perform, or None. Deterministic: the k-th hit always lands on
        decision ``k`` of the pre-drawn sequence."""
        i = self.hits
        self.hits += 1
        if self.fired >= self.budget:
            return None
        if self.decisions is not None:
            if i >= len(self.decisions) or not self.decisions[i]:
                return None
        self.fired += 1
        return self.action

    def exhausted(self) -> bool:
        return self.fired >= self.budget

    def status(self) -> dict:
        return {"name": self.name, "action": self.action,
                "budget": self.budget, "p": self.p,
                "delay_ms": self.delay_s * 1000.0,
                "hits": self.hits, "fired": self.fired}


class _Registry:
    def __init__(self):
        self._lock = threading.Lock()
        self._armed: dict[str, FaultRule] = {}
        # one (site, hit-index, action) record per trigger: the process's
        # fault history; history_digest() fingerprints it so two runs of
        # the same seed can be compared byte-for-byte
        self._history: list[tuple[str, int, str]] = []
        try:
            self._seed = int(os.environ.get("CHAOS_SEED", "0") or 0)
        except ValueError:
            log.warning("ignoring malformed CHAOS_SEED %r",
                        os.environ.get("CHAOS_SEED"))
            self._seed = 0
        env = os.environ.get("FAILPOINTS", "")
        for part in env.split(","):
            part = part.strip()
            if not part:
                continue
            if ":" not in part:
                self.enable(part, 1)
                continue
            name, spec = part.split(":", 1)
            if spec.startswith("p="):
                try:
                    p = float(spec[2:])
                    if not 0.0 < p <= 1.0:
                        raise ValueError(p)
                except ValueError:
                    log.warning("ignoring malformed FAILPOINTS entry %r "
                                "(want name:p=<0..1])", part)
                    continue
                # probabilistic arming stays reproducible: decisions come
                # from the seeded chaos RNG (CHAOS_SEED), never from hit-
                # time randomness. Unbudgeted: the sequence horizon bounds
                # total triggers instead.
                self.enable_probabilistic(name, p, seed=self._seed,
                                          budget=DECISION_HORIZON)
                continue
            try:
                budget = int(spec)
            except ValueError:
                # a malformed entry must not take down every process
                # importing the package (this runs at import time)
                log.warning("ignoring malformed FAILPOINTS entry %r "
                            "(want name:count or name:p=<prob>)", part)
                continue
            if budget <= 0:
                # `name:-3` used to arm and then pop on the first hit —
                # an operator typo silently became a one-shot fault
                log.warning("ignoring FAILPOINTS entry %r: budget must "
                            "be a positive count", part)
                continue
            self.enable(name, budget)

    @property
    def seed(self) -> int:
        return self._seed

    def enable(self, name: str, budget: int = 1) -> None:
        self.arm(FaultRule(name, ACTION_ERROR, budget=budget))

    def enable_probabilistic(self, name: str, p: float, seed=None,
                             budget: int = DECISION_HORIZON,
                             action: str = ACTION_ERROR,
                             delay_s: float = 0.0) -> None:
        self.arm(FaultRule(name, action, budget=budget, p=p,
                           seed=self._seed if seed is None else seed,
                           delay_s=delay_s))

    def arm(self, rule: FaultRule) -> None:
        with self._lock:
            self._armed[rule.name] = rule

    def disable(self, name: str) -> None:
        with self._lock:
            self._armed.pop(name, None)

    def disable_all(self) -> None:
        with self._lock:
            self._armed.clear()
            self._history.clear()

    def _decide(self, name: str) -> tuple[Optional[str], float]:
        with self._lock:
            rule = self._armed.get(name)
            if rule is None:
                return None, 0.0
            act = rule.decide()
            if act is not None:
                self._history.append((name, rule.hits - 1, act))
            if rule.exhausted() and rule.decisions is None:
                # legacy raise-N-times semantics: an exhausted
                # deterministic rule disarms (tests assert `armed()`
                # flips); probabilistic rules stay visible for status
                self._armed.pop(name, None)
            return act, rule.delay_s

    def _perform(self, name: str, act: str, delay_s: float) -> bool:
        """Execute a decided action OUTSIDE the lock; returns True when
        the site should treat the hit as a fault (raise/drop)."""
        if act == ACTION_DELAY:
            if delay_s > 0:
                import asyncio

                try:
                    asyncio.get_running_loop()
                except RuntimeError:
                    time.sleep(delay_s)
                else:
                    # this site runs ON an event-loop thread (upstream
                    # transport, engine.respond): a blocking sleep here
                    # would stall EVERY in-flight request and every
                    # heartbeat on the loop — far more than the one op
                    # the schedule targeted (spurious elections, not a
                    # brownout). The decision is already recorded in
                    # the fault history; the latency effect is simply
                    # not applied at loop-side sites. Arm delays at
                    # worker-side sites (engine.dispatch) instead.
                    log.warning(
                        "failpoint %s: skipping delay action on an "
                        "event-loop thread (use a worker-side site "
                        "like engine.dispatch for delays)", name)
            return False
        if act == ACTION_CRASH:
            log.warning("failpoint %s: crashing the process (SIGKILL)",
                        name)
            os.kill(os.getpid(), signal.SIGKILL)
            return False  # unreachable
        return True  # error | drop

    def hit(self, name: str) -> None:
        """Call at a potential fault site; raises while the budget lasts.
        ``delay`` actions sleep and let the op proceed; ``crash`` kills
        the process; ``error``/``drop`` raise."""
        act, delay_s = self._decide(name)
        if act is None:
            return
        if self._perform(name, act, delay_s):
            raise FailPointError(name)

    def branch(self, name: str) -> bool:
        """Like :meth:`hit` but RETURNS True (consuming one budget unit)
        instead of raising — for sites that model dropped or suppressed
        work rather than a surfaced error: ``mirror.partition`` drops a
        mirror frame on the floor, ``mirror.heartbeat`` suppresses a
        liveness heartbeat (engine/remote.py `_push_mirror`), so election
        paths are testable without real network chaos."""
        act, delay_s = self._decide(name)
        if act is None:
            return False
        return self._perform(name, act, delay_s)

    def armed(self, name: str) -> bool:
        with self._lock:
            return name in self._armed

    def status(self) -> list[dict]:
        """Per-site arming state + trigger counts (the chaos_status wire
        op and the campaign's episode reports read this)."""
        with self._lock:
            return [r.status() for r in self._armed.values()]

    def history(self) -> list[tuple[str, int, str]]:
        with self._lock:
            return list(self._history)

    def history_digest(self) -> str:
        """Fingerprint of every fault this process actually performed,
        in order — two runs of the same seed over the same request
        sequence produce the same digest."""
        with self._lock:
            doc = json.dumps(self._history, separators=(",", ":"))
        return hashlib.sha256(doc.encode()).hexdigest()


failpoints = _Registry()
