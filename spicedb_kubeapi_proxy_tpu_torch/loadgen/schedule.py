"""Arrival-schedule generation: Poisson baseline + trace-shaped bursts.

A schedule is a flat, time-ordered list of :class:`Arrival` records
computed ENTIRELY up front from one seeded RNG: the driver replays it,
it never draws randomness at fire time, so identical seeds produce
identical schedules (the reproducibility pin in the bench acceptance)
and two sweeps at different concurrency compare the same traffic.

The arrival process is piecewise-Poisson: a baseline rate, overridden
inside each :class:`BurstPhase` window by ``rate_multiplier`` and an
op-mix override. The three stock phases model the production shapes the
ROADMAP names:

- ``watch-storm`` — a controller restart: thousands of watch streams
  (re)open at once while normal traffic continues;
- ``get-wave`` — a fleet-wide ``kubectl get`` sweep: list-prefilter and
  Table-response traffic spikes several-fold;
- ``reconcile`` — an operator reconcile loop: interleaved checks,
  LookupSubjects sweeps, and write churn.

Tenant identity is Zipf-skewed (``p(rank r) ∝ 1/(r+1)^s``): a few noisy
tenants dominate, the long tail trickles — the distribution per-tenant
fair queueing exists to survive.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

# the op classes the mixed workload drives; driver op tables are keyed
# by these names
OP_CHECK = "check"
OP_BULK_CHECK = "bulk-check"
OP_LIST_PREFILTER = "list-prefilter"
OP_TABLE = "table-filter"
OP_LOOKUP_SUBJECTS = "lookup-subjects"
OP_WILDCARD = "wildcard-check"
OP_WRITE = "write"
OP_WATCH_OPEN = "watch-open"

DEFAULT_MIX = {
    OP_CHECK: 0.40,
    OP_BULK_CHECK: 0.12,
    OP_LIST_PREFILTER: 0.14,
    OP_TABLE: 0.08,
    OP_LOOKUP_SUBJECTS: 0.06,
    OP_WILDCARD: 0.08,
    OP_WRITE: 0.07,
    OP_WATCH_OPEN: 0.05,
}


@dataclass(frozen=True)
class Arrival:
    """One scheduled request: fire at ``t`` seconds after schedule
    start, no matter what happened to every arrival before it."""

    t: float
    op: str
    tenant: str
    key: int  # op-local variety selector (which resource/subject)
    phase: str  # "baseline" or the burst phase's name
    burst: bool
    # shard-aware namespace selector: each tenant owns a SMALL cluster
    # of namespaces (``ns_per_tenant`` of them), so the Zipf tenant skew
    # translates into namespace — and therefore SHARD — skew: the
    # macrobench's hot tenant hammers a hot shard instead of uniformly
    # spreading its storm across the keyspace. Derived from the tenant
    # rank and ``key`` (no extra RNG draws: identical seeds still
    # produce identical schedules).
    ns_key: int = 0


@dataclass(frozen=True)
class BurstPhase:
    """A named window where the arrival rate and mix change."""

    name: str
    start: float  # seconds from schedule start
    duration: float
    rate_multiplier: float
    mix: Optional[dict] = None  # None = keep the baseline mix


@dataclass
class ScheduleConfig:
    duration: float  # seconds
    rate: float  # baseline arrivals/second
    tenants: int = 8
    zipf_s: float = 1.1  # tenant-skew exponent (higher = more skew)
    seed: int = 0
    mix: dict = field(default_factory=lambda: dict(DEFAULT_MIX))
    bursts: tuple = ()
    key_space: int = 1 << 16  # op-local key variety
    # namespaces per tenant: the tenant -> namespace mapping honored by
    # the Zipf skew (Arrival.ns_key). Small on purpose — a hot tenant
    # should concentrate on a few namespaces (one or two shards), which
    # is the hot-shard shape per-shard admission exists to survive
    ns_per_tenant: int = 4


def trace_shaped_config(duration: float, rate: float, tenants: int = 8,
                        seed: int = 0,
                        burst_multiplier: float = 4.0) -> ScheduleConfig:
    """The stock trace shape: baseline Poisson with the three production
    burst phases at fixed fractions of the run (watch storm at 15%,
    get wave at 45%, reconcile loop at 70%)."""
    storm_mix = dict(DEFAULT_MIX)
    storm_mix[OP_WATCH_OPEN] = 0.45
    storm_mix[OP_CHECK] = 0.30
    wave_mix = dict(DEFAULT_MIX)
    wave_mix[OP_LIST_PREFILTER] = 0.40
    wave_mix[OP_TABLE] = 0.25
    # write churn is the reconcile loop's defining trait (operators
    # re-assert ownership tuples on every pass): the write share leads
    # the mix, so this burst is the phase that finds write-path
    # regressions — with the delta overlay each write is an O(write)
    # append; without it every write forces a graph re-encode before the
    # next fully-consistent read can dispatch
    reconcile_mix = dict(DEFAULT_MIX)
    reconcile_mix[OP_CHECK] = 0.25
    reconcile_mix[OP_LOOKUP_SUBJECTS] = 0.12
    reconcile_mix[OP_WRITE] = 0.35
    return ScheduleConfig(
        duration=duration, rate=rate, tenants=tenants, seed=seed,
        bursts=(
            BurstPhase("watch-storm", 0.15 * duration, 0.12 * duration,
                       burst_multiplier, storm_mix),
            BurstPhase("get-wave", 0.45 * duration, 0.10 * duration,
                       burst_multiplier, wave_mix),
            BurstPhase("reconcile", 0.70 * duration, 0.15 * duration,
                       0.6 * burst_multiplier, reconcile_mix),
        ))


def _zipf_weights(n: int, s: float) -> np.ndarray:
    w = 1.0 / np.power(np.arange(1, n + 1, dtype=np.float64), s)
    return w / w.sum()


def _segments(cfg: ScheduleConfig):
    """[(t0, t1, rate, mix)] covering [0, duration) — bursts override
    the baseline inside their window; overlapping bursts are applied in
    declaration order (the later one wins from its own start)."""
    cuts = {0.0, cfg.duration}
    for b in cfg.bursts:
        cuts.add(max(0.0, min(b.start, cfg.duration)))
        cuts.add(max(0.0, min(b.start + b.duration, cfg.duration)))
    edges = sorted(cuts)
    segs = []
    for t0, t1 in zip(edges, edges[1:]):
        if t1 <= t0:
            continue
        rate, mix, phase, burst = cfg.rate, cfg.mix, "baseline", False
        mid = (t0 + t1) / 2
        for b in cfg.bursts:
            if b.start <= mid < b.start + b.duration:
                rate = cfg.rate * b.rate_multiplier
                mix = b.mix or cfg.mix
                phase, burst = b.name, True
        segs.append((t0, t1, rate, mix, phase, burst))
    return segs


def build_schedule(cfg: ScheduleConfig) -> list[Arrival]:
    """Materialize the whole arrival list. Deterministic in ``seed``:
    every random draw comes from one generator consumed in a fixed
    order (per-segment counts, then vectorized gap/op/tenant/key draws
    per segment)."""
    rng = np.random.default_rng(cfg.seed)
    tenant_p = _zipf_weights(cfg.tenants, cfg.zipf_s)
    tenant_names = [f"tenant{i}" for i in range(cfg.tenants)]
    out: list[Arrival] = []
    for t0, t1, rate, mix, phase, burst in _segments(cfg):
        span = t1 - t0
        n = rng.poisson(rate * span)
        if n <= 0:
            continue
        # conditioned on the count, Poisson arrival times are iid
        # uniform over the segment — one sort instead of a gap walk
        ts = np.sort(rng.uniform(t0, t1, size=n))
        ops = list(mix.keys())
        p = np.asarray(list(mix.values()), dtype=np.float64)
        p = p / p.sum()
        op_idx = rng.choice(len(ops), size=n, p=p)
        tn_idx = rng.choice(cfg.tenants, size=n, p=tenant_p)
        keys = rng.integers(0, cfg.key_space, size=n)
        npt = max(1, cfg.ns_per_tenant)
        out.extend(
            Arrival(float(ts[i]), ops[int(op_idx[i])],
                    tenant_names[int(tn_idx[i])], int(keys[i]),
                    phase, burst,
                    int(tn_idx[i]) * npt + int(keys[i]) % npt)
            for i in range(n))
    out.sort(key=lambda a: a.t)
    return out


def burst_windows(cfg: ScheduleConfig) -> list[tuple[str, float, float]]:
    """[(name, start, end)] of the config's burst phases, clamped to the
    schedule span — the sweep uses these to window burst-tail stats."""
    return [(b.name, max(0.0, min(b.start, cfg.duration)),
             max(0.0, min(b.start + b.duration, cfg.duration)))
            for b in cfg.bursts]
