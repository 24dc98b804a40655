"""The chaos campaign runner: seeded fault schedules × live topology ×
safety invariants.

One campaign = N seeds; one seed = three EPISODES against a full
topology (2 shard groups × 2-peer failover sets × the proxy-side client
stack — ShardedEngine planner → FailoverEngine → RemoteEngine, the same
four-deep stack the authz middleware consumes):

1. **baseline** — the loadgen open-loop schedule (mixed op classes:
   checks, bulk checks, scatter lookups, LookupSubjects, writes incl.
   journaled cross-shard splits, watch reads) with no faults armed —
   the control every degradation bound compares against;
2. **brownout** — a delay+drop fault schedule wire-armed on ONE shard
   group's hosts (``chaos_arm``, flag-gated server-side): the episode
   verifies fail-closed behavior under partial degradation, that total
   retries against the faulted group stay within the RetryBudget bound
   (counter-verified), and that the healthy group's goodput holds;
3. **crash** — the same load with a SIGKILL of group 0's leader
   mid-schedule, failover, restart of the victim, and split-journal
   recovery.

After every episode the invariant suite (chaos/invariants.py) runs over
the episode's op records plus a post-recovery read-back of every acked
write. ANY violation fails the campaign (exit 1 from ``main``).

Determinism: the arrival schedule and the fault schedule both derive
every decision from the seed up front (loadgen/schedule.py,
chaos/schedule.py), so one seed names one reproducible run —
``--seeds`` reports each seed's fault-schedule digest, and re-running a
seed re-arms byte-identical decision tables on every host.

``python -m spicedb_kubeapi_proxy_tpu_torch.chaos.campaign`` runs the
bounded sweep; ``--inproc`` swaps the subprocess hosts for in-process
engines behind per-group fault sites (no crash episode — nothing to
SIGKILL) for the fast tier-1 smoke.

A copy of the JAX package's campaign over the port. Its hosts are the
port's engine host CLI (``python -m
spicedb_kubeapi_proxy_tpu_torch.engine.remote``) and its in-process
engines the port's ``Engine``, all on ``--device`` (``cuda`` unless the
caller asks for the CPU; asking for ``cuda`` without a card raises). The
episodes, schedules, fault sites and bounds are the reference's.
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import subprocess
import sys
import tempfile
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

from ..engine.engine import CheckItem
from ..engine.store import RelationshipFilter, WriteOp
from ..models.tuples import Relationship
from ..utils.failpoints import failpoints
from ..utils.metrics import metrics
from ..utils.resilience import RetryBudget
from ..admission import AdmissionRejected
from ..loadgen.driver import OpenLoopDriver
from ..loadgen.schedule import (
    OP_BULK_CHECK,
    OP_CHECK,
    OP_LIST_PREFILTER,
    OP_LOOKUP_SUBJECTS,
    OP_TABLE,
    OP_WATCH_OPEN,
    OP_WILDCARD,
    OP_WRITE,
    build_schedule,
    trace_shaped_config,
)
from .invariants import (
    EpisodeEvidence,
    InvariantViolation,
    KIND_CHECK,
    KIND_DELETE,
    KIND_LOOKUP,
    KIND_MIGRATION_PROBE,
    KIND_WRITE,
    OUTCOME_ERROR,
    OUTCOME_OK,
    OUTCOME_SHED,
    OpRecord,
    check_all,
)
from .schedule import FaultSchedule, FaultSpec, brownout_schedule

log = logging.getLogger("sdbkp.torch.chaos")

# the schema every topology bootstraps (the test suite's 2-shard shape:
# namespaces are GLOBAL tuples that replicate, pods are namespaced)
SCHEMA_YAML = """\
schema: |-
  definition user {}

  definition namespace {
    relation creator: user
    relation viewer: user
    permission admin = creator
    permission view = viewer + creator
  }

  definition pod {
    relation namespace: namespace
    relation creator: user
    relation viewer: user
    permission edit = creator
    permission view = viewer + creator + namespace->view
  }
relationships: ""
"""

NS_COUNT = 8  # static namespaces the load spreads over
FAULT_GROUP = 1  # the browned-out group; group 0 takes the SIGKILL

# the live-migration episode's REWRITING target: the same schema with a
# caveat trait attached to pod.viewer (an allowed-subject gain on a live
# relation — the exact change class that forces dual-compile + backfill
# instead of a metadata-only flip). The affected closure is
# pod#viewer/pod#view; namespace#view and pod#edit stay outside it and
# carry the no-verdict-flap obligation through the cut.
MIGRATED_SCHEMA = """\
caveat probation(level int) {
  level < 3
}

definition user {}

definition namespace {
  relation creator: user
  relation viewer: user
  permission admin = creator
  permission view = viewer + creator
}

definition pod {
  relation namespace: namespace
  relation creator: user
  relation viewer: user | user with probation
  permission edit = creator
  permission view = viewer + creator + namespace->view
}
"""


def _migration_target_text() -> str:
    """The bootstrap path auto-appends the workflow definitions to every
    engine's schema (models/bootstrap.py); the migration target needs
    the same three or the diff would classify them as removed."""
    from ..models.bootstrap import WORKFLOW_DEFS

    return "\n".join([MIGRATED_SCHEMA]
                     + [WORKFLOW_DEFS[n]
                        for n in ("lock", "workflow", "activity")])

# episode shapes: (schedule seconds, baseline arrivals/second)
EPISODE_SHAPES = {"short": (1.2, 80.0), "standard": (4.0, 150.0)}


def rel(rt, rid, rl, st, sid) -> Relationship:
    return Relationship(rt, rid, rl, st, sid, None)


def _rel_key(r: Relationship) -> str:
    return f"{r.resource_type}:{r.resource_id}#{r.relation}" \
           f"@{r.subject_type}:{r.subject_id}"


# -- topologies ---------------------------------------------------------------


def _host_argv(bootstrap: str, peer_id: int, ports: list, data_dir: str,
               device: str) -> list:
    """The port's engine host CLI as one peer of a 2-peer failover set."""
    argv = [
        sys.executable, "-m", "spicedb_kubeapi_proxy_tpu_torch.engine.remote",
        "--bootstrap", bootstrap,
        "--peers", "127.0.0.1:%d,127.0.0.1:%d" % tuple(ports),
        "--peer-id", str(peer_id),
        "--bind-port", str(ports[peer_id]),
        "--token", "chaos-tok", "--engine-insecure",
        "--data-dir", data_dir, "--wal-fsync", "always",
        # the DURABLE configuration the zero-acked-write-loss row of the
        # loss table is stated for: an ack requires the follower to hold
        # (and journal) the bytes, so no resurrection-era re-election can
        # rebase an acked write away. min-sync-replicas 0 (the availability
        # default) acks unreplicated while the peer is down — a documented
        # loss mode this campaign reproduced before pinning the floor.
        "--min-sync-replicas", "1",
        "--mirror-heartbeat-seconds", "0.3",
        "--failover-boot-grace", "30",
        "--enable-chaos-ops",
    ]
    if device != "cuda":
        argv += ["--device", device]
    return argv


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class SubprocessTopology:
    """2 shard groups × 2-peer failover sets, each peer a real
    subprocess engine host with persistence, replication, and the
    flag-gated chaos plane. The planner in THIS process is the proxy
    tier under test."""

    n_groups = 2
    supports_crash = True

    def __init__(self, workdir: Optional[str] = None,
                 device: str = "cuda"):
        from ..scaleout import ShardMap, SplitJournal

        self._tmp = None
        if workdir is None:
            self._tmp = tempfile.TemporaryDirectory(prefix="chaos-")
            workdir = self._tmp.name
        self.dir = workdir
        self.device = str(device)
        self.repo = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        self.bootstrap = os.path.join(workdir, "bootstrap.yaml")
        with open(self.bootstrap, "w") as f:
            f.write(SCHEMA_YAML)
        # group g, peer p listens on self.ports[g][p]
        self.ports = [[_free_port(), _free_port()] for _ in range(2)]
        self.procs: dict[tuple[int, int], subprocess.Popen] = {}
        self.env = dict(os.environ)
        self.env.pop("FAILPOINTS", None)
        for g in range(2):
            for p in range(2):
                self.procs[(g, p)] = self._boot(g, p)
        self.map = ShardMap(version=1, groups=tuple(
            tuple(("127.0.0.1", port) for port in self.ports[g])
            for g in range(2)))
        self.journal_path = os.path.join(workdir, "split-journal.sqlite")
        self._journal_cls = SplitJournal
        self.retry_budget = RetryBudget("engine-stack", ratio=0.1,
                                        burst=20.0)
        self.planner = None

    def _host_log(self, g: int, p: int) -> str:
        return os.path.join(self.dir, f"host-g{g}p{p}.log")

    def _boot(self, g: int, p: int) -> subprocess.Popen:
        # logs go to a FILE, never a pipe: failover churn logs freely
        # (reconnects, elections), and an undrained 64KiB pipe would
        # eventually block the host inside a log write — a wedged
        # topology indistinguishable from the hangs the campaign hunts
        logf = open(self._host_log(g, p), "ab")
        try:
            return subprocess.Popen(
                _host_argv(self.bootstrap, p, self.ports[g],
                           os.path.join(self.dir, f"data-g{g}p{p}"),
                           self.device),
                stdout=logf, stderr=subprocess.STDOUT,
                env=self.env, cwd=self.repo)
        finally:
            logf.close()  # the child holds its own descriptor

    def _probe(self, port: int):
        from ..engine.remote import RemoteEngine

        return RemoteEngine("127.0.0.1", port, token="chaos-tok",
                            timeout=2.0, connect_timeout=2.0, retries=0)

    def group_leader(self, g: int) -> Optional[int]:
        """The peer index currently leading group ``g`` (None while
        electing)."""
        for p, port in enumerate(self.ports[g]):
            probe = self._probe(port)
            try:
                if probe.failover_state().get("role") == "leader":
                    return p
            except Exception:  # noqa: BLE001 - a dead peer is expected
                pass
            finally:
                probe.close()
        return None

    def wait_ready(self, budget: float = 120.0) -> None:
        deadline = time.monotonic() + budget
        while time.monotonic() < deadline:
            for key, proc in self.procs.items():
                if proc.poll() is not None:
                    try:
                        with open(self._host_log(*key), "rb") as f:
                            out = f.read()[-3000:].decode(
                                "utf-8", "replace")
                    except OSError:
                        out = "<no log>"
                    raise RuntimeError(
                        f"engine host {key} died at boot:\n{out}")
            if all(self.group_leader(g) is not None for g in range(2)):
                return
            time.sleep(0.3)
        raise RuntimeError("topology never became ready")

    def make_planner(self):
        from ..engine.remote import FailoverEngine
        from ..scaleout import ShardedEngine

        groups = [
            FailoverEngine(
                [("127.0.0.1", port) for port in self.ports[g]],
                token="chaos-tok", probe_timeout=2.0,
                resolve_deadline=15.0, connect_timeout=2.0, timeout=8.0,
                retries=2, retry_budget=self.retry_budget)
            for g in range(2)
        ]
        self.planner = ShardedEngine(
            self.map, groups,
            journal=self._journal_cls(self.journal_path),
            retry_budget=self.retry_budget)
        return self.planner

    # -- chaos plane ---------------------------------------------------------

    def arm(self, group: int, sched: FaultSchedule,
            budget: float = 15.0) -> dict:
        """Arm ``sched`` on EVERY host of the group and VERIFY each
        endpoint echoed the schedule's digest (byte-identical decision
        tables). A transiently unreachable peer retries within the
        budget; a persistent failure raises — an un-armed brownout
        episode would verify nothing and pass vacuously."""
        want = sched.digest()
        deadline = time.monotonic() + budget
        while True:
            got = self.planner.groups[group].chaos_arm(sched.encode())
            bad = {ep: r for ep, r in got.items()
                   if r.get("digest") != want}
            if not bad:
                return got
            if time.monotonic() >= deadline:
                raise RuntimeError(
                    f"fault schedule never armed on group {group}: "
                    f"{bad}")
            time.sleep(0.5)

    def reset_faults(self) -> None:
        for g in self.planner.groups:
            g.chaos_reset()

    # -- elastic topology (grow/shrink episode) ------------------------------

    def add_group(self):
        """Boot a fresh 2-peer failover group (new ports, new data
        dirs) and return ``(endpoints, client)`` for a grow
        transition. The new hosts join ``procs``/``ports`` so the
        crash plane (kill/restart/wait) and teardown cover them."""
        from ..engine.remote import FailoverEngine

        g = len(self.ports)
        self.ports.append([_free_port(), _free_port()])
        for p in range(2):
            self.procs[(g, p)] = self._boot(g, p)
        self.wait_group_leader(g, budget=120.0)
        client = FailoverEngine(
            [("127.0.0.1", port) for port in self.ports[g]],
            token="chaos-tok", probe_timeout=2.0,
            resolve_deadline=15.0, connect_timeout=2.0, timeout=8.0,
            retries=2, retry_budget=self.retry_budget)
        return (tuple(("127.0.0.1", port)
                      for port in self.ports[g]), client)

    # -- crash/restart -------------------------------------------------------

    def kill_group_leader(self, g: int) -> tuple[int, int]:
        p = self.group_leader(g)
        if p is None:
            raise RuntimeError(f"group {g} has no leader to kill")
        proc = self.procs[(g, p)]
        proc.kill()
        proc.wait(timeout=15)
        log.info("SIGKILLed group %d leader (peer %d)", g, p)
        return g, p

    def group_index(self, endpoints) -> int:
        """The topology's index of the group serving ``endpoints`` (one
        entry of a shard map). Once a shrink has retired a group, a
        planner's group index and the topology's no longer agree: a
        later seed's grow appends at a planner index one below the
        topology's."""
        want = [tuple(ep) for ep in endpoints]
        for g, ports in enumerate(self.ports):
            if [("127.0.0.1", port) for port in ports] == want:
                return g
        raise KeyError(f"no group of this topology serves {want}")

    def restart(self, g: int, p: int) -> None:
        old = self.procs[(g, p)]
        if old.poll() is None:
            old.kill()
            old.wait(timeout=15)
        self.procs[(g, p)] = self._boot(g, p)

    def wait_group_leader(self, g: int, budget: float = 60.0) -> None:
        deadline = time.monotonic() + budget
        while time.monotonic() < deadline:
            if self.group_leader(g) is not None:
                return
            time.sleep(0.3)
        raise RuntimeError(f"group {g} never re-elected a leader")

    def faulted_dependencies(self) -> list[str]:
        return [f"engine:127.0.0.1:{port}"
                for port in self.ports[FAULT_GROUP]]

    def close(self) -> None:
        if self.planner is not None:
            self.planner.close()
        for proc in self.procs.values():
            if proc.poll() is None:
                proc.terminate()
        for proc in self.procs.values():
            try:
                proc.wait(timeout=20)
            except subprocess.TimeoutExpired:
                proc.kill()
        if self._tmp is not None:
            self._tmp.cleanup()


class _FaultableEngine:
    """In-process group engine behind NAMED per-group fault sites:
    ``engine.g<N>.dispatch`` hits BEFORE the op (delay browns it out,
    error fails it pre-application) and ``engine.g<N>.respond`` hits
    AFTER it (a drop there discards an already-applied result — the
    same caller-side ambiguity a dropped response frame produces on the
    wire). Together they model the full remote brownout schedule
    in-process."""

    def __init__(self, inner, gi: int):
        self._inner = inner
        self.site = f"engine.g{gi}.dispatch"
        self.respond_site = f"engine.g{gi}.respond"

    def __getattr__(self, name):
        val = getattr(self._inner, name)
        if name in ("check_bulk", "lookup_resources", "lookup_subjects",
                    "read_relationships", "watch_since",
                    "write_relationships", "delete_relationships"):
            def hooked(*a, _fn=val, **kw):
                failpoints.hit(self.site)
                out = _fn(*a, **kw)
                failpoints.hit(self.respond_site)
                return out

            return hooked
        return val

    @property
    def revision(self):
        return self._inner.revision

    @property
    def store(self):
        return self._inner.store


class InprocTopology:
    """2 in-process engine groups behind per-group fault sites — the
    fast smoke shape (tier-1): same schedules, same invariants, no
    subprocesses, so no crash episode."""

    n_groups = 2
    supports_crash = False

    def __init__(self, workdir: Optional[str] = None,
                 device: str = "cuda"):
        from ..engine import Engine
        from ..scaleout import ShardMap

        self.device = device
        self.engines = [Engine(bootstrap=SCHEMA_YAML, device=device)
                        for _ in range(2)]
        self.map = ShardMap(version=1, groups=(
            (("127.0.0.1", 1),), (("127.0.0.1", 2),)))
        self.retry_budget = None
        self.planner = None

    def wait_ready(self) -> None:
        pass

    def make_planner(self):
        from ..scaleout import ShardedEngine

        self.planner = ShardedEngine(
            self.map,
            [_FaultableEngine(e, gi)
             for gi, e in enumerate(self.engines)])
        return self.planner

    # remote site -> the per-group local site _FaultableEngine hits
    _SITE_MAP = {"engine.dispatch": "dispatch", "engine.respond": "respond"}

    def arm(self, group: int, sched: FaultSchedule) -> dict:
        """Re-target EVERY spec at the group's local sites; a spec this
        topology cannot model raises instead of silently thinning the
        schedule (a delays-only 'brownout' would no longer exercise the
        error-path fail-closed handling the smoke claims to cover)."""
        specs = []
        for s in sched.specs:
            suffix = self._SITE_MAP.get(s.site)
            if suffix is None:
                raise RuntimeError(
                    f"inproc topology cannot arm site {s.site!r}")
            specs.append(FaultSpec(f"engine.g{group}.{suffix}",
                                   s.action, p=s.p, budget=s.budget))
        retargeted = FaultSchedule(sched.seed, specs)
        retargeted.arm()
        return {"armed": [s.site for s in specs],
                "digest": retargeted.digest()}

    def add_group(self):
        """A fresh in-process engine group for a grow transition; the
        placeholder endpoint only has to be unique within the map."""
        from ..engine import Engine

        gi = len(self.engines)
        e = Engine(bootstrap=SCHEMA_YAML, device=self.device)
        self.engines.append(e)
        return ((("127.0.0.1", gi + 1),), _FaultableEngine(e, gi))

    def reset_faults(self) -> None:
        failpoints.disable_all()

    def faulted_dependencies(self) -> list[str]:
        return []

    def close(self) -> None:
        if self.planner is not None:
            self.planner.close()


# -- the campaign -------------------------------------------------------------


@dataclass
class CampaignConfig:
    seeds: tuple = (0, 1, 2)
    episodes: str = "short"  # short | standard
    inproc: bool = False
    workdir: Optional[str] = None
    json_out: Optional[str] = None
    # where every engine runs: the in-process topology's engines and
    # each subprocess host's --device
    device: str = "cuda"


@dataclass
class _SeedState:
    """Carried across a seed's episodes: everything acked so far is a
    durability obligation for EVERY later recovery point."""

    acked: dict = field(default_factory=dict)  # rel key -> Relationship
    seq: itertools.count = field(default_factory=itertools.count)


class Campaign:
    def __init__(self, cfg: CampaignConfig):
        self.cfg = cfg
        if cfg.episodes not in EPISODE_SHAPES:
            raise ValueError(f"unknown episode shape {cfg.episodes!r}")
        self.duration, self.rate = EPISODE_SHAPES[cfg.episodes]
        from ..device import resolve_device

        resolve_device(cfg.device)  # cuda without a card raises here
        self.topology = (InprocTopology(cfg.workdir, cfg.device)
                         if cfg.inproc
                         else SubprocessTopology(cfg.workdir, cfg.device))
        self.violations: list[InvariantViolation] = []
        self.result: dict = {"episodes": [], "seeds": {},
                             "violations": []}

    # -- op plumbing ---------------------------------------------------------

    def _ns(self, ns_key: int) -> str:
        return f"ns{ns_key % NS_COUNT}"

    def _write_acked(self, writes: list, budget: float = 45.0) -> bool:
        """Issue a write, retrying through fail-closed windows (election
        in progress, durability floor below min-sync while a follower
        rejoins) — the windows are the system refusing to lie, not an
        error. True iff acked within the budget."""
        planner = self.topology.planner
        deadline = time.monotonic() + budget
        while True:
            try:
                planner.write_relationships(list(writes))
                return True
            except Exception as e:  # noqa: BLE001 - bounded retry
                if time.monotonic() >= deadline:
                    log.warning("write never acked within %.0fs: %s",
                                budget, e)
                    return False
                time.sleep(0.4)

    def _seed_static(self) -> None:
        """The static grant set every oracle expectation derives from:
        per namespace, one owner with view on its pod via the namespace
        arrow and one direct pod viewer. ``intruder*`` subjects are
        NEVER granted anything, by any episode — an allow for one is
        fail-open, full stop."""
        writes = []
        for i in range(NS_COUNT):
            ns = f"ns{i}"
            writes.append(WriteOp("touch", rel(
                "namespace", ns, "viewer", "user", f"owner{i}")))
            writes.append(WriteOp("touch", rel(
                "pod", f"{ns}/p0", "namespace", "namespace", ns)))
            writes.append(WriteOp("touch", rel(
                "pod", f"{ns}/p0", "viewer", "user", f"direct{i}")))
        if not self._write_acked(writes):
            raise RuntimeError("static seed writes never acked")

    def _record(self, records, lock, rec: OpRecord) -> None:
        with lock:
            records.append(rec)

    def _ops(self, seed: int, episode: str, state: _SeedState,
             records: list, lock: threading.Lock) -> dict:
        """Loadgen op table: every callable records an OpRecord and
        re-raises sheds/errors so the driver's outcome accounting
        agrees with ours."""
        planner = self.topology.planner
        wseq = itertools.count()

        def classify(fn, shards_of=None):
            """``shards_of(a)`` names the shard(s) an arrival targets so
            FAILED ops still carry routing info — without it the
            healthy-shard goodput ratio would only ever see successes
            (ok == total by construction) and the <10%-degradation
            bound could never fail."""
            def run(a):
                seq = next(state.seq)
                shards = tuple(shards_of(a)) if shards_of else ()
                try:
                    fn(a, seq)
                except AdmissionRejected as e:
                    self._record(records, lock, OpRecord(
                        KIND_CHECK, OUTCOME_SHED, seq=seq,
                        shards=shards, retry_after=e.retry_after))
                    raise
                except Exception as e:  # noqa: BLE001 - accounted
                    ra = getattr(e, "retry_after", None)
                    self._record(records, lock, OpRecord(
                        KIND_CHECK, OUTCOME_ERROR, seq=seq,
                        shards=shards, retry_after=ra,
                        error=repr(e)[:200]))
                    raise
            return run

        def check_shard(a):
            ns_i = a.ns_key % NS_COUNT
            return (self.topology.map.anchor_shard("pod",
                                                   f"ns{ns_i}/p0"),)

        def probe_item(a) -> tuple[CheckItem, Optional[bool], str]:
            ns_i = a.ns_key % NS_COUNT
            ns = f"ns{ns_i}"
            if a.key % 2:
                # negative probe: intruders are never granted anything
                subject = f"intruder{a.key % 16}"
                expected = False
            else:
                subject = f"owner{ns_i}"
                expected = True
            item = CheckItem("pod", f"{ns}/p0", "view", "user", subject)
            key = f"pod:{ns}/p0#view@user:{subject}"
            return item, expected, key

        def do_check(a, seq):
            item, expected, key = probe_item(a)
            verdict = planner.check(item)
            gi = self.topology.map.anchor_shard("pod", item.resource_id)
            self._record(records, lock, OpRecord(
                KIND_CHECK, OUTCOME_OK, seq=seq, key=key,
                verdict=bool(verdict), expected=expected,
                shards=(gi,)))

        def do_bulk(a, seq):
            items, metas = [], []
            for j in range(3):
                shifted = type(a)(a.t, a.op, a.tenant, a.key + j,
                                  a.phase, a.burst, a.ns_key + j)
                item, expected, key = probe_item(shifted)
                items.append(item)
                metas.append((expected, key))
            verdicts = planner.check_bulk(items)
            for (expected, key), v in zip(metas, verdicts):
                self._record(records, lock, OpRecord(
                    KIND_CHECK, OUTCOME_OK, seq=seq, key=key,
                    verdict=bool(v), expected=expected))

        def do_lookup(a, seq):
            subject = f"intruder{a.key % 16}" if a.key % 2 \
                else f"owner{a.ns_key % NS_COUNT}"
            ids = planner.lookup_resources("pod", "view", "user",
                                           subject)
            if a.key % 2:
                self._record(records, lock, OpRecord(
                    KIND_LOOKUP, OUTCOME_OK, seq=seq,
                    key=f"pod#view@user:{subject}",
                    verdict=bool(ids), expected=False))

        def do_lookup_subjects(a, seq):
            ns = self._ns(a.ns_key)
            subs = planner.lookup_subjects("pod", f"{ns}/p0", "view",
                                           "user")
            leaked = [s for s in subs if s.startswith("intruder")]
            self._record(records, lock, OpRecord(
                KIND_LOOKUP, OUTCOME_OK, seq=seq,
                key=f"pod:{ns}/p0#view@user:*",
                verdict=bool(leaked), expected=False))

        def do_write(a, seq):
            i = next(wseq)
            ns_a = self._ns(a.ns_key)
            rels = [rel("pod", f"{ns_a}/cw-{seed}-{episode}-{i}",
                        "viewer", "user", f"w{i}")]
            if i % 5 == 4:
                # cross-shard split: a second namespaced leg in the
                # OTHER half of the namespace space (journal path when
                # the two land on different groups) — plus, every few,
                # a global tuple that replicates to every group
                ns_b = self._ns(a.ns_key + NS_COUNT // 2)
                rels.append(rel("pod", f"{ns_b}/cw-{seed}-{episode}-{i}",
                                "viewer", "user", f"w{i}"))
            if i % 11 == 10:
                rels.append(rel("namespace", f"gns-{seed}-{i}",
                                "viewer", "user", f"w{i}"))
            shards = tuple(sorted({
                self.topology.map.anchor_shard(r.resource_type,
                                               r.resource_id)
                for r in rels}))
            planner.write_relationships(
                [WriteOp("create", r) for r in rels])
            with lock:
                # one record PER relationship: the read-back is keyed by
                # rel, and every leg of a split carries the obligation
                for r in rels:
                    state.acked[_rel_key(r)] = r
                    records.append(OpRecord(
                        KIND_WRITE, OUTCOME_OK, seq=seq,
                        rel=_rel_key(r), shards=shards))

        def do_watch(a, seq):
            planner.watch_since(planner.vector)

        return {
            OP_CHECK: classify(do_check, check_shard),
            OP_WILDCARD: classify(do_check, check_shard),
            OP_TABLE: classify(do_check, check_shard),
            OP_BULK_CHECK: classify(do_bulk),
            OP_LIST_PREFILTER: classify(do_lookup),
            OP_LOOKUP_SUBJECTS: classify(do_lookup_subjects),
            OP_WRITE: classify(do_write),
            OP_WATCH_OPEN: classify(do_watch),
        }

    # -- episode machinery ---------------------------------------------------

    def _drive(self, seed: int, episode: str, state: _SeedState,
               records: list, mid_run=None) -> dict:
        lock = threading.Lock()
        cfg = trace_shaped_config(self.duration, self.rate, tenants=6,
                                  seed=seed)
        schedule = build_schedule(cfg)
        driver = OpenLoopDriver(
            self._ops(seed, episode, state, records, lock),
            max_workers=16, drain_timeout=60.0)
        killer = None
        if mid_run is not None:
            killer = threading.Timer(0.35 * self.duration, mid_run)
            killer.start()
        try:
            rep = driver.run(schedule, cfg.duration)
        finally:
            if killer is not None:
                killer.join()
        return {"scheduled": rep.scheduled_n, "fired": rep.fired_n,
                "outcomes": {k: dict(v) for k, v in
                             rep.per_class().items()}}

    def _probe_until(self, item: CheckItem, want: bool,
                     budget: float = 20.0) -> bool:
        """True iff the check settles at ``want`` within the budget
        (transport noise retries; a definitive opposite answer keeps
        retrying until the budget — replication/replay may lag)."""
        planner = self.topology.planner
        deadline = time.monotonic() + budget
        while True:
            try:
                if bool(planner.check(item)) == want:
                    return True
            except Exception:  # noqa: BLE001 - recovery window noise
                pass
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.25)

    def _drain_pending_splits(self, budget: float = 30.0) -> Optional[int]:
        """Run split-write recovery to completion (bounded): the
        invariant judges the state AFTER recovery — an ambiguous leg
        parked pending mid-episode is the journal working as specified,
        a pending entry that recovery cannot drain is the violation."""
        planner = self.topology.planner
        if planner.journal is None:
            return None
        deadline = time.monotonic() + budget
        while planner.journal.pending_count():
            try:
                planner.recover_splits()
            except Exception:  # noqa: BLE001 - a shard mid-election
                pass
            if not planner.journal.pending_count() \
                    or time.monotonic() >= deadline:
                break
            time.sleep(0.5)
        return planner.journal.pending_count()

    def _readback(self, state: _SeedState) -> dict:
        """Post-recovery presence of EVERY acked write so far (the
        zero-acked-write-loss evidence)."""
        out: dict = {}
        for key, r in state.acked.items():
            # campaign writes grant "viewer" on pods AND namespaces;
            # both types expose it through their "view" permission
            item = CheckItem(r.resource_type, r.resource_id, "view",
                             r.subject_type, r.subject_id)
            out[key] = self._probe_until(item, True, budget=25.0)
        return out

    def _revocation_probe(self, seed: int, episode: str,
                          state: _SeedState, records: list) -> None:
        """The no-stale-verdict sequence: grant → observe allow →
        revoke → observe deny → re-probe; a later allow is a stale
        verdict (invariants.check_no_stale_verdict orders by seq)."""
        planner = self.topology.planner
        ns = "ns0"
        subject = f"rev-{seed}-{episode}"
        r = rel("pod", f"{ns}/p0", "viewer", "user", subject)
        item = CheckItem("pod", f"{ns}/p0", "view", "user", subject)
        key = f"pod:{ns}/p0#view@user:{subject}"
        if not self._write_acked([WriteOp("touch", r)]):
            records.append(OpRecord(
                KIND_CHECK, OUTCOME_ERROR, seq=next(state.seq), key=key,
                error="revocation-probe grant never acked"))
            return
        if not self._probe_until(item, True):
            records.append(OpRecord(
                KIND_CHECK, OUTCOME_ERROR, seq=next(state.seq), key=key,
                error="grant never became visible"))
            return
        f = RelationshipFilter(
            resource_type="pod", resource_id=f"{ns}/p0",
            relation="viewer", subject_type="user", subject_id=subject)
        deadline = time.monotonic() + 30.0
        while True:
            try:
                planner.delete_relationships(f)
                break
            except Exception:  # noqa: BLE001 - idempotent, bounded
                if time.monotonic() >= deadline:
                    return  # revocation never acked: no obligation
                time.sleep(0.4)
        records.append(OpRecord(KIND_DELETE, OUTCOME_OK,
                                seq=next(state.seq), key=key))
        if not self._probe_until(item, False):
            # the deny never became visible within the budget
            # (replication/replay lag): the stale-verdict invariant is
            # defined as allow-AFTER-a-deny, so recording expected=False
            # allows here would misreport lag as fail-open — no deny
            # observed, no obligation this round
            return
        records.append(OpRecord(
            KIND_CHECK, OUTCOME_OK, seq=next(state.seq), key=key,
            verdict=False, expected=False))
        for _ in range(10):
            try:
                v = bool(planner.check(item))
            except Exception:  # noqa: BLE001 - noise tolerated
                continue
            records.append(OpRecord(
                KIND_CHECK, OUTCOME_OK, seq=next(state.seq), key=key,
                verdict=v, expected=False))

    def _healthy_goodput(self, records: list) -> tuple[int, int]:
        """(ok, total) over single-shard probes routed to HEALTHY
        groups (everything but FAULT_GROUP)."""
        ok = total = 0
        for r in records:
            if r.kind != KIND_CHECK or not r.shards:
                continue
            if FAULT_GROUP in r.shards:
                continue
            total += 1
            if r.outcome == OUTCOME_OK:
                ok += 1
        return ok, total

    def _retries_delta(self, before: dict) -> float:
        total = 0.0
        for dep in self.topology.faulted_dependencies():
            total += metrics.counter("proxy_dependency_retries_total",
                                     dependency=dep).value \
                - before.get(dep, 0.0)
        return total

    def _retries_snapshot(self) -> dict:
        return {dep: metrics.counter("proxy_dependency_retries_total",
                                     dependency=dep).value
                for dep in self.topology.faulted_dependencies()}

    def _finish_episode(self, ev: EpisodeEvidence, extra: dict) -> None:
        got = check_all(ev)
        self.violations.extend(got)
        self.result["episodes"].append({
            "episode": ev.name,
            "records": len(ev.records),
            "violations": [str(v) for v in got],
            **extra,
        })
        log.info("episode %s: %d records, %d violations", ev.name,
                 len(ev.records), len(got))

    # -- episodes ------------------------------------------------------------

    def run_seed(self, seed: int) -> None:
        topo = self.topology
        state = _SeedState()
        self._seed_static()
        sched = brownout_schedule(seed)
        self.result["seeds"][str(seed)] = {
            "fault_digest": sched.digest(),
        }

        # episode 1: baseline (no faults) — the control
        records: list = []
        stats = self._drive(seed, "baseline", state, records)
        self._revocation_probe(seed, "baseline", state, records)
        ev = EpisodeEvidence(
            name=f"seed{seed}/baseline", records=records,
            readback=self._readback(state),
            pending_splits=self._drain_pending_splits())
        base_ok, base_total = self._healthy_goodput(records)
        self._finish_episode(ev, {"load": stats})

        # episode 2: single-shard brownout, wire-armed, budget-verified
        armed = topo.arm(FAULT_GROUP, sched)
        budget = topo.retry_budget
        retries_before = self._retries_snapshot()
        # attempts are counted at the BUDGET (one deposit per transport
        # call, incl. one per scatter leg) — the exact denominator of
        # the bound, not the logical-op count, which undercounts
        # scatter deposits and would flag a correctly-behaving budget
        attempts_before = budget.attempts if budget is not None else 0
        records = []
        stats = self._drive(seed, "brownout", state, records)
        topo.reset_faults()
        pending = self._drain_pending_splits()
        ev = EpisodeEvidence(
            name=f"seed{seed}/brownout", records=records,
            readback=self._readback(state),
            pending_splits=pending,
            retries_observed=self._retries_delta(retries_before),
            budget_ratio=(budget.ratio if budget is not None else None),
            budget_burst=(budget.burst if budget is not None else None),
            attempts=(budget.attempts - attempts_before
                      if budget is not None else None))
        ok, total = self._healthy_goodput(records)
        goodput_ratio = None
        if base_total >= 20 and total >= 20 and base_ok:
            goodput_ratio = (ok / total) / (base_ok / base_total)
            if goodput_ratio < 0.9:
                self.violations.append(InvariantViolation(
                    "brownout-goodput",
                    f"healthy-shard goodput fell to {goodput_ratio:.2f}x"
                    " of the fault-free baseline (bound: 0.90)"))
        self._finish_episode(ev, {
            "load": stats, "armed": armed,
            "retries_at_faulted_group": ev.retries_observed,
            "healthy_goodput_ratio": goodput_ratio,
        })

        # episode 3: SIGKILL group 0's leader mid-schedule, failover,
        # restart, split-journal recovery
        if not topo.supports_crash:
            # the elastic + migration episodes still run (episodes 4-5
            # below) — their in-process shapes just have no
            # SIGKILL-mid-drain / SIGKILL-mid-backfill legs
            self.elastic_episode(seed, state)
            self.migration_episode(seed, state)
            return
        victim: list = []

        def kill():
            try:
                victim.append(topo.kill_group_leader(0))
            except Exception as e:  # noqa: BLE001 - surfaced below
                log.warning("mid-run kill failed: %s", e)

        records = []
        stats = self._drive(seed, "crash", state, records, mid_run=kill)
        topo.wait_group_leader(0)
        if victim:
            topo.restart(*victim[0])
        pending = self._drain_pending_splits()
        self._revocation_probe(seed, "crash", state, records)
        ev = EpisodeEvidence(
            name=f"seed{seed}/crash", records=records,
            readback=self._readback(state),
            pending_splits=pending)
        self._finish_episode(ev, {
            "load": stats,
            "killed": (f"group{victim[0][0]}/peer{victim[0][1]}"
                       if victim else None),
        })

        # episode 4: elastic grow -> shrink -> grow under load, SIGKILL
        # of the retiring group's leader mid-drain (BEFORE the
        # migration episode: a freshly booted group bootstraps the
        # original schema, so growing after a live migration would
        # split the fleet's schema)
        self.elastic_episode(seed, state)

        # episode 5: live schema migration under load, SIGKILL
        # mid-backfill, re-begin after the boot-abort
        self.migration_episode(seed, state)

    # -- elastic scale-out episode -------------------------------------------

    def elastic_episode(self, seed: int, state: _SeedState) -> None:
        """Grow -> shrink -> grow, each map transition begun MID-load
        through the same coordinator the autoscaler's apply mode
        drives. On crash-capable topologies the shrink is paced and
        the RETIRING group's leader takes a SIGKILL mid-drain: the
        drain must fail over to the group's surviving peer and
        converge. Every write acked anywhere in the cycle is a
        read-back obligation at the end, no probe may flip open, and a
        transition that never converges (including its GC) is itself a
        violation (``rebalance-converged``)."""
        from ..scaleout import ShardMap
        from ..scaleout.rebalance import shrink_map

        topo = self.topology
        planner = topo.planner
        crash = topo.supports_crash
        records: list = []
        transitions: list = []
        victim: list = []

        def _converged(want_version: int, want_groups: int,
                       budget: float = 120.0) -> bool:
            # converged = transition cleared, target map live, target
            # group count routing, AND no archived transition owing GC
            # (a shrink begun over pending GC would be refused, so an
            # unconverged GC stalls the elastic cycle for real)
            deadline = time.monotonic() + budget
            while time.monotonic() < deadline:
                if planner.rebalance_status() is None \
                        and planner.map.version >= want_version \
                        and len(planner.groups) == want_groups \
                        and all(t.gc_complete
                                for t in planner._archived_transitions):
                    return True
                time.sleep(0.1)
            return False

        def run_phase(name, mid_run, want_version, want_groups):
            stats = self._drive(seed, f"elastic-{name}", state, records,
                                mid_run=mid_run)
            ok = _converged(want_version, want_groups)
            if not ok:
                self.violations.append(InvariantViolation(
                    "rebalance-converged",
                    f"elastic {name} transition never converged: "
                    f"status={planner.rebalance_status()}, map "
                    f"v{planner.map.version} (want >= {want_version}), "
                    f"{len(planner.groups)} groups "
                    f"(want {want_groups})"))
            transitions.append({"phase": name, "converged": ok,
                                "map_version": planner.map.version,
                                "groups": len(planner.groups),
                                "load": stats})
            return ok

        # phase 1: grow — append a freshly booted group mid-load
        eps, client = topo.add_group()
        base = planner.map
        gi = len(base.groups)
        grown = ShardMap(version=base.version + 1,
                         groups=tuple(base.groups) + (tuple(eps),),
                         virtual_nodes=base.virtual_nodes)

        def begin_grow():
            try:
                planner.begin_rebalance(grown, new_clients={gi: client})
            except Exception as e:  # noqa: BLE001 - judged by converge
                log.warning("elastic grow begin failed: %s", e)

        ok = run_phase("grow", begin_grow, grown.version, gi + 1)

        # phase 2: shrink the group straight back out; crash shapes
        # pace the drain and SIGKILL the retiring group's leader in
        # the middle of it
        if ok:
            shrunk = shrink_map(planner.map)
            retiring = len(planner.groups) - 1
            retiring_eps = planner.map.groups[retiring]

            def begin_shrink():
                try:
                    planner.begin_rebalance(
                        shrunk,
                        **({"batch_rows": 4, "pace_seconds": 0.15}
                           if crash else {}))
                except Exception as e:  # noqa: BLE001 - judged below
                    log.warning("elastic shrink begin failed: %s", e)
                    return
                if crash:
                    time.sleep(0.4)  # let the drain actually start
                    try:
                        # by endpoints: the planner's index of the
                        # retiring group names another topology group
                        # from the second seed on
                        victim.append(topo.kill_group_leader(
                            topo.group_index(retiring_eps)))
                    except Exception as e:  # noqa: BLE001 - surfaced
                        log.warning("mid-drain kill failed: %s", e)

            ok = run_phase("shrink", begin_shrink, shrunk.version,
                           retiring)

        # phase 3: grow again — the cycle must be repeatable (stale
        # archived owner filters from the first cycle are the
        # regression this phase pins at the campaign level)
        if ok:
            eps2, client2 = topo.add_group()
            base2 = planner.map
            gi2 = len(base2.groups)
            regrown = ShardMap(version=base2.version + 1,
                               groups=tuple(base2.groups)
                               + (tuple(eps2),),
                               virtual_nodes=base2.virtual_nodes)

            def begin_regrow():
                try:
                    planner.begin_rebalance(regrown,
                                            new_clients={gi2: client2})
                except Exception as e:  # noqa: BLE001 - judged above
                    log.warning("elastic re-grow begin failed: %s", e)

            run_phase("regrow", begin_regrow, regrown.version, gi2 + 1)

        self._revocation_probe(seed, "elastic", state, records)
        ev = EpisodeEvidence(
            name=f"seed{seed}/elastic", records=records,
            readback=self._readback(state),
            pending_splits=self._drain_pending_splits())
        self._finish_episode(ev, {
            "transitions": transitions,
            "killed": (f"group{victim[0][0]}/peer{victim[0][1]}"
                       if victim else None),
        })

    # -- live schema migration episode ---------------------------------------

    # (probe key, CheckItem, inside the migration's affected closure?)
    _MIGRATION_PROBES = (
        ("namespace:ns0#view@user:owner0",
         ("namespace", "ns0", "view", "user", "owner0"), False),
        ("namespace:ns1#view@user:intruder-mig",
         ("namespace", "ns1", "view", "user", "intruder-mig"), False),
        ("pod:ns2/p0#edit@user:direct2",
         ("pod", "ns2/p0", "edit", "user", "direct2"), False),
        ("pod:ns0/p0#view@user:direct0",
         ("pod", "ns0/p0", "view", "user", "direct0"), True),
    )

    def _migration_terminal(self, budget: float = 60.0) -> Optional[dict]:
        """Poll the planner's aggregate status to a terminal phase."""
        planner = self.topology.planner
        deadline = time.monotonic() + budget
        while True:
            st = planner.migration_status()
            if st is None or st.get("phase") in ("done", "failed",
                                                 "aborted"):
                return st
            if time.monotonic() >= deadline:
                return st
            time.sleep(0.1)

    def migration_episode(self, seed: int, state: _SeedState) -> None:
        """Episode 4: a REWRITING schema migration (caveat attached to
        the live pod.viewer relation) begun mid-load, with steady
        verdict probes running before/during/after the coordinated cut.
        On crash-capable topologies, group 0's leader takes a SIGKILL
        mid-backfill; the interrupted attempt must resolve by the crash
        matrix (boot-abort, no cut persisted) and a re-begin must then
        complete — with zero verdict flaps outside the affected closure
        across the WHOLE window, both attempts included."""
        topo = self.topology
        planner = topo.planner
        records: list = []
        lock = threading.Lock()
        stop = threading.Event()
        target = _migration_target_text()

        def probe_loop():
            while not stop.is_set():
                for key, args, _aff in self._MIGRATION_PROBES:
                    try:
                        v = bool(planner.check(CheckItem(*args)))
                        self._record(records, lock, OpRecord(
                            KIND_MIGRATION_PROBE, OUTCOME_OK,
                            seq=next(state.seq), key=key, verdict=v))
                    except Exception as e:  # noqa: BLE001 - availability
                        self._record(records, lock, OpRecord(
                            KIND_MIGRATION_PROBE, OUTCOME_ERROR,
                            seq=next(state.seq), key=key, error=str(e)))
                time.sleep(0.03)

        crash = topo.supports_crash
        victim: list = []

        def begin():
            try:
                # a paced backfill on crash topologies keeps the window
                # open long enough for the SIGKILL to land MID-backfill
                planner.begin_schema_migration(
                    target,
                    **({"batch": 4, "backfill_pause": 0.15}
                       if crash else {}))
            except Exception as e:  # noqa: BLE001 - judged below
                log.warning("migration begin failed: %s", e)
            if crash:
                try:
                    victim.append(topo.kill_group_leader(0))
                except Exception as e:  # noqa: BLE001 - surfaced below
                    log.warning("mid-backfill kill failed: %s", e)

        prober = threading.Thread(target=probe_loop, daemon=True)
        prober.start()
        try:
            stats = self._drive(seed, "migration", state, records,
                                mid_run=begin)
            st = self._migration_terminal()
            attempts = 1
            if crash:
                topo.wait_group_leader(0)
                if victim:
                    topo.restart(*victim[0])
                st = self._migration_terminal()
                if st is None or st.get("phase") != "done":
                    # the interrupted attempt boot-aborted by the crash
                    # matrix; the operator's re-begin must complete
                    attempts += 1
                    planner.begin_schema_migration(target, wait=True,
                                                   timeout=90.0)
                    st = self._migration_terminal()
        finally:
            stop.set()
            prober.join(timeout=10.0)
        pending = self._drain_pending_splits()
        affected = frozenset(k for k, _a, aff in self._MIGRATION_PROBES
                             if aff)
        ev = EpisodeEvidence(
            name=f"seed{seed}/migration", records=records,
            readback=self._readback(state),
            pending_splits=pending,
            migration_affected=affected,
            migration_status=st)
        self._finish_episode(ev, {
            "load": stats,
            "migration_phase": (st or {}).get("phase"),
            "migration_attempts": attempts,
            "killed": (f"group{victim[0][0]}/peer{victim[0][1]}"
                       if victim else None),
        })

    def run(self) -> dict:
        t0 = time.monotonic()
        try:
            self.topology.wait_ready()
            self.topology.make_planner()
            for seed in self.cfg.seeds:
                log.info("=== seed %d ===", seed)
                self.run_seed(seed)
        finally:
            self.topology.close()
        self.result["violations"] = [str(v) for v in self.violations]
        self.result["ok"] = not self.violations
        self.result["wall_s"] = round(time.monotonic() - t0, 2)
        self.result["seeds_run"] = list(self.cfg.seeds)
        self.result["episode_shape"] = self.cfg.episodes
        return self.result


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="chaos-campaign",
        description="seeded chaos campaign over the full proxy topology")
    ap.add_argument("--seeds", type=int, default=3,
                    help="how many seeds to sweep (0..N-1)")
    ap.add_argument("--episodes", default="short",
                    choices=sorted(EPISODE_SHAPES),
                    help="episode shape (schedule length × rate)")
    ap.add_argument("--inproc", action="store_true",
                    help="in-process topology (fast smoke: no "
                         "subprocesses, no crash episode)")
    ap.add_argument("--json", dest="json_out",
                    help="write the full result JSON here")
    ap.add_argument("--device", default="cuda",
                    help="torch device every engine runs on (default "
                         "cuda; cpu only when asked)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    cfg = CampaignConfig(seeds=tuple(range(args.seeds)),
                         episodes=args.episodes, inproc=args.inproc,
                         json_out=args.json_out, device=args.device)
    result = Campaign(cfg).run()
    if cfg.json_out:
        with open(cfg.json_out, "w") as f:
            json.dump(result, f, indent=2, sort_keys=True)
    print(json.dumps({k: v for k, v in result.items()
                      if k != "episodes"}, indent=2, sort_keys=True))
    if not result["ok"]:
        print("CHAOS CAMPAIGN FAILED: invariant violations:",
              file=sys.stderr)
        for v in result["violations"]:
            print(f"  {v}", file=sys.stderr)
        return 1
    print(f"chaos campaign OK: {len(result['episodes'])} episodes, "
          f"0 violations, {result['wall_s']}s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
