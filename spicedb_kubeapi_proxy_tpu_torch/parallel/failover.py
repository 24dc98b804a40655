"""Automatic leader failover for the mirrored (primary/replica) engine.

The PyTorch port's copy of the JAX package's ``parallel/failover.py``,
over the port's mirror (parallel/multihost.py), engine host and client
(engine/remote.py) and term files (persistence/manager.py). Each peer is
an engine-host process with its own device; several may share one GPU.

The multi-host serving story used to die with its leader: ONE TCP-serving
process mirrored writes to followers (`multihost.py`), and the
mirror's catch-up only helped a *follower* rejoin. This module closes the loop —
the RedisGraph/Samyama deployment shape from PAPERS.md, where a
hardware-accelerated graph engine rides a replicated store tier with
real failover — while keeping the paper's proxy semantics: during a
control change the system fails *closed* (503s), never *wrong*.

Three cooperating mechanisms:

- **Fenced terms**: a monotonically increasing integer, persisted per
  data dir (`persistence/manager.py` ``load_term``/``store_term``),
  stamped on every mirror frame, heartbeat, catch-up cut, and follower
  ack. A deposed leader's late output carries an old term and is
  rejected (`multihost.fence_term`, counted by
  ``mirror_frames_rejected_stale_term_total``); a subscriber resuming
  from a deposed term past the promotion baseline gets a forced full
  state transfer (the general form of the catch-up's "follower ahead of
  leader" rule) and rebases its local WAL onto the new lineage.
- **Election & promotion** (:class:`FailoverCoordinator`): the leader
  heartbeats over the existing mirror transport; on heartbeat loss each
  follower probes every peer's ``failover_state`` and the best
  reachable candidate promotes — Raft-ordered: highest TERM first (a
  deposed lineage's inflated revision count never outranks the
  canonical lineage), then highest revision, then LOWEST peer id —
  bumps + persists the term, wraps its engine in a sync-replicating
  :class:`~.multihost.MirroredEngine`, and starts answering. Sets of
  3+ additionally require MAJORITY visibility to elect (a minority
  partition keeps electing, fail closed). Losers wait for the winner
  and re-subscribe with catch-up. A returning old leader finds the
  higher term at boot (or on its lease probe), demotes, and converges
  as a follower.
- **Role gating**: a follower's `EngineServer` rejects every op except
  ``failover_state`` with kind ``not_leader`` — clients re-resolve
  (`engine/remote.py` ``FailoverEngine``) instead of reading stale
  state; the proxy's authz middleware turns the same rejection into a
  fail-closed kube 503 + Retry-After.

Durability contract (why "no acked write lost" holds): the leader's
mutations are SYNC-replicated — the client ack waits until every live
follower has applied AND journaled the frame under its own
``--wal-fsync`` policy. With ``always`` on both sides, a SIGKILLed
leader's every acknowledged write is already fsynced on the follower
that promotes. Writes accepted while NO follower is subscribed (the
window after a follower crash) are exactly as durable as the leader's
own WAL — the availability-over-redundancy trade a two-node set makes.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Optional

from ..utils.metrics import metrics
from .multihost import (
    LeaderLost,
    MirroredEngine,
    MultiHostError,
    StaleTermError,
    follower_loop,
)

log = logging.getLogger("sdbkp.torch.failover")

ROLE_FOLLOWER = "follower"
ROLE_LEADER = "leader"
ROLE_ELECTING = "electing"
# terminal: the coordinator thread died on an unexpected error — the
# host answers failover_state truthfully (never leads, never follows)
# so peers and orchestrators can see the replica is lost, instead of a
# silently-wedged not_leader-forever process
ROLE_FAILED = "failed"

# engine_role gauge encoding (the ordering is arbitrary — dashboards
# key on the labels, not the sum)
ROLE_GAUGE = {ROLE_FOLLOWER: 0.0, ROLE_LEADER: 1.0, ROLE_ELECTING: 2.0,
              ROLE_FAILED: 3.0}


class FailoverError(MultiHostError):
    pass


def parse_peers(spec: str) -> list[tuple[str, int]]:
    """``host:port,host:port,...`` -> [(host, port)] in PEER-ID ORDER
    (the list index IS the peer id everywhere: tie-breaks, --peer-id,
    failover_state). The ONE owner of the flag format."""
    peers = []
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        host, _, port = part.rpartition(":")
        if host.startswith("[") and host.endswith("]"):
            host = host[1:-1]
        if not host or not port.isdigit() or not 0 < int(port) < 65536:
            raise FailoverError(
                f"--peers entry {part!r}: expected host:port")
        peers.append((host, int(port)))
    if not peers:
        raise FailoverError("--peers: at least one host:port required")
    return peers


def choose_candidate(states: dict) -> Optional[int]:
    """Deterministic election over ``peer_id -> {"term", "revision"}``
    candidate states, Raft-ordered: the HIGHEST TERM wins first — a
    deposed lineage's inflated revision count must never beat the
    canonical newer lineage (its extra revisions are exactly the fenced-
    off writes a rebase discards) — then the highest revision within
    that term (most acked history survives), then the LOWEST peer id.
    Every voter computing over the same reachable set picks the same
    winner."""
    best = None
    for pid, st in states.items():
        key = (-int(st.get("term", 0) or 0),
               -int(st.get("revision", 0) or 0), int(pid))
        if best is None or key < best[0]:
            best = (key, int(pid))
    return None if best is None else best[1]


class FailoverCoordinator:
    """Runs ONE engine-host process's role in a replicated set.

    Owns the role state machine (follower -> electing -> leader ->
    deposed -> follower), the persisted term, and the role/term/lag the
    server's ``failover_state`` op and gauges report. The asyncio
    `EngineServer` keeps serving throughout; this object swaps what it
    serves (the bare engine vs a term-stamped MirroredEngine wrapper)
    and gates which ops it answers."""

    def __init__(self, engine, server, peers: list, self_id: int,
                 token: Optional[str] = None,
                 data_dir: Optional[str] = None,
                 heartbeat_interval: float = 2.0,
                 heartbeat_timeout: Optional[float] = None,
                 replication_timeout: float = 10.0,
                 min_sync_replicas: int = 0,
                 client_ssl=None,
                 probe_timeout: float = 2.0,
                 boot_grace: float = 20.0):
        if not 0 <= self_id < len(peers):
            raise FailoverError(
                f"peer id {self_id} out of range for {len(peers)} peers")
        self.engine = engine  # the INNER engine, never the wrapper
        self.server = server
        self.peers = list(peers)
        self.self_id = int(self_id)
        self.token = token
        self.data_dir = data_dir
        self.heartbeat_interval = heartbeat_interval
        self.heartbeat_timeout = (heartbeat_timeout
                                  or heartbeat_interval * 3 + 1.0)
        self.replication_timeout = replication_timeout
        self.min_sync_replicas = int(min_sync_replicas)
        self.client_ssl = client_ssl
        self.probe_timeout = probe_timeout
        self.boot_grace = boot_grace
        self.role = ROLE_ELECTING
        self.lag = 0
        self.term = 0
        if data_dir:
            from ..persistence.manager import load_term

            self.term = load_term(data_dir)
        self._mirrored: Optional[MirroredEngine] = None
        # set when this node lost an EQUAL-TERM leader conflict (a
        # crashed promotion's persisted term was reused by another
        # peer): its own history under that term is suspect, so every
        # rejoin demands a full state transfer until it next promotes
        self._rejoin_full = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # probe clients: one per OTHER peer, single-attempt, short
        # budgets, breaker that never opens (election must keep asking)
        from ..engine.remote import RemoteEngine
        from ..utils.resilience import CircuitBreaker

        self._probes = {
            pid: RemoteEngine(
                h, p, token=token, ssl_context=client_ssl,
                timeout=probe_timeout, connect_timeout=probe_timeout,
                retries=0,
                breaker=CircuitBreaker(f"peer:{h}:{p}",
                                       failure_threshold=1 << 30))
            for pid, (h, p) in enumerate(self.peers) if pid != self.self_id
        }
        server.failover_status = self.status
        server.mirror_heartbeat = heartbeat_interval
        self._set_role(ROLE_ELECTING)
        metrics.gauge("engine_term").set(self.term)

    # -- observability --------------------------------------------------------

    def status(self) -> dict:
        return {"role": self.role, "term": self.term,
                "revision": self.engine.revision,
                "peer_id": self.self_id, "lag": self.lag}

    def _set_role(self, role: str) -> None:
        if role != self.role:
            log.info("role: %s -> %s (term %d)", self.role, role,
                     self.term)
        self.role = role
        metrics.gauge("engine_role").set(ROLE_GAUGE[role])

    def _adopt_term(self, term: int) -> None:
        term = int(term)
        if term <= self.term:
            return
        self.term = term
        if self.data_dir:
            from ..persistence.manager import store_term

            store_term(self.data_dir, term)
        metrics.gauge("engine_term").set(term)

    def _set_lag(self, lag: int) -> None:
        self.lag = int(lag)

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(target=self.run, daemon=True,
                                        name="failover-coordinator")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    # -- probing --------------------------------------------------------------

    def _probe_all(self) -> dict:
        """peer_id -> failover_state for every OTHER reachable peer."""
        states = {}
        for pid, probe in self._probes.items():
            try:
                states[pid] = probe.failover_state()
            except Exception as e:  # noqa: BLE001 - unreachable peer
                log.debug("probe peer %d failed: %s", pid, e)
        return states

    def _leader_among(self, states: dict) -> Optional[int]:
        """The reachable peer claiming leadership with the highest term
        not BELOW ours (an old-term 'leader' is a deposed straggler we
        must not follow)."""
        best = None
        for pid, st in states.items():
            if st.get("role") != ROLE_LEADER:
                continue
            t = int(st.get("term", 0) or 0)
            if t < self.term:
                continue
            if best is None or t > best[1]:
                best = (pid, t)
        return None if best is None else best[0]

    # -- the state machine ----------------------------------------------------

    def run(self) -> None:
        """Blocking role loop (the CLI runs it on a daemon thread next
        to the asyncio server)."""
        try:
            leader_id = self._boot()
            while not self._stop.is_set():
                if leader_id is None:
                    leader_id = self._elect()
                elif leader_id == self.self_id:
                    self._lead()
                    leader_id = None  # deposed (or stopping)
                else:
                    self._follow(leader_id)
                    leader_id = None  # leader lost: elect
        except Exception:
            # terminal and OBSERVABLE: the host keeps answering
            # failover_state with role=failed (peers elect around it,
            # orchestrators see a replica that needs a restart) instead
            # of a dead thread behind a healthy-looking process
            log.exception("failover coordinator died; this replica is "
                          "lost until the process restarts")
            self._set_role(ROLE_FAILED)
            metrics.counter("failover_coordinator_failures_total").inc()
            raise

    def _boot(self) -> Optional[int]:
        """Find the current leader at process start, giving the rest of
        the set ``boot_grace`` to come up: electing from partial
        visibility could crown a candidate with LESS acked history than
        an unreachable-but-booting peer (whose superseded writes a later
        full-state rebase would then discard). An incumbent leader ends
        the wait instantly; so does hearing from EVERY peer — with full
        visibility the revision-ordered election is safe immediately. A
        RESTARTED old leader takes this same path, finds its successor's
        higher term, and demotes instead of split-braining."""
        deadline = time.monotonic() + self.boot_grace
        while not self._stop.is_set():
            states = self._probe_all()
            lid = self._leader_among(states)
            if lid is not None:
                return lid
            if len(states) == len(self._probes):
                return None  # everyone answered, nobody leads: elect
            if time.monotonic() >= deadline:
                log.warning(
                    "boot grace (%.0fs) expired with %d/%d peers "
                    "unreachable; electing from partial visibility",
                    self.boot_grace, len(self._probes) - len(states),
                    len(self._probes))
                return None
            self._stop.wait(min(0.5, self.heartbeat_interval))
        return None

    def _elect(self) -> Optional[int]:
        """One election round: probe, defer to any live leader, else
        promote self iff self is the deterministic winner; otherwise
        wait for the winner to take over."""
        self._set_role(ROLE_ELECTING)
        t0 = time.monotonic()
        while not self._stop.is_set():
            states = self._probe_all()
            lid = self._leader_among(states)
            if lid is not None:
                return lid
            # majority visibility for sets of 3+: a minority partition
            # must keep electing (fail closed) rather than crown a
            # leader the majority side can't see — two live leaders
            # would split the clients by term. A 2-node set has no
            # usable majority once its peer is DEAD (the whole point of
            # failover), so it elects from whatever is visible and
            # leans on --min-sync-replicas/fencing for partition
            # safety (docs/operations.md "Leader failover").
            visible = len(states) + 1
            if len(self.peers) >= 3 and visible <= len(self.peers) // 2:
                log.warning(
                    "election stalled: only %d/%d peers visible (no "
                    "majority); retrying", visible, len(self.peers))
                self._stop.wait(min(0.5, self.heartbeat_interval))
                continue
            candidates = {self.self_id: self.status()}
            for pid, st in states.items():
                if st.get("role") in (ROLE_FOLLOWER, ROLE_ELECTING):
                    candidates[pid] = st
            winner = choose_candidate(candidates)
            if winner == self.self_id:
                self._promote(states)
                metrics.histogram("failover_duration_seconds").observe(
                    time.monotonic() - t0)
                return self.self_id
            # the winner is another peer: give it a beat to promote,
            # then re-probe (it may have died too — the loop converges
            # on whoever remains)
            self._stop.wait(min(0.5, self.heartbeat_interval))
        return None

    def _promote(self, states: dict) -> None:
        """Become leader: bump the term past everything observed,
        persist it FIRST (fencing must survive a crash between promotion
        and the first frame), then serve a sync-replicating mirror."""
        highest = max([self.term] + [int(s.get("term", 0) or 0)
                                     for s in states.values()])
        self._adopt_term(highest + 1)
        self._mirrored = MirroredEngine(
            self.engine, term=self.term, mirror_queries=False,
            sync_replication=True,
            replication_timeout=self.replication_timeout,
            min_sync_replicas=self.min_sync_replicas)
        self.server.engine = self._mirrored
        self.lag = 0
        self._rejoin_full = False  # this node's lineage is canonical now
        self._set_role(ROLE_LEADER)
        metrics.counter("failover_total").inc()
        log.warning("promoted to leader (term %d, revision %d)",
                    self.term, self.engine.revision)

    def _lead(self) -> None:
        """Serve until deposed: a lease-style watch probes peers each
        heartbeat interval; any peer with a HIGHER term means a newer
        lineage exists — stop serving immediately (fail closed), unwrap,
        and rejoin as a follower. Two leaders at the SAME term (a
        crashed promotion persisted a term no peer ever saw, and the
        election reused it) resolve deterministically: the LOWER peer id
        keeps the term and bumps past it so fencing can reject the other
        lineage; the loser demotes with its term-local history marked
        suspect (forced full-state rejoin)."""
        while not self._stop.is_set():
            self._stop.wait(self.heartbeat_interval)
            if self._stop.is_set():
                return
            for pid, st in self._probe_all().items():
                t = int(st.get("term", 0) or 0)
                if t > self.term:
                    log.warning(
                        "deposed: peer %d reports term %d > own %d; "
                        "demoting", pid, t, self.term)
                    self._demote()
                    return
                if st.get("role") == ROLE_LEADER and t == self.term:
                    if self.self_id < pid:
                        log.warning(
                            "equal-term leader conflict with peer %d at "
                            "term %d; keeping leadership and bumping the "
                            "term so fencing can reject its lineage",
                            pid, t)
                        self._adopt_term(self.term + 1)
                        if self._mirrored is not None:
                            self._mirrored.term = self.term
                    else:
                        log.warning(
                            "equal-term leader conflict with peer %d at "
                            "term %d; demoting (lower id wins) with a "
                            "forced full-state rejoin", pid, t)
                        self._rejoin_full = True
                        self._demote()
                        return

    def _demote(self) -> None:
        # role FIRST, engine swap second: the server's in-worker gate
        # re-check reads role then engine, so this order guarantees a
        # request that still sees role=leader also sees the (pinned)
        # mirrored wrapper — never a bare engine on a deposed leader
        self._set_role(ROLE_FOLLOWER)
        self.server.engine = self.engine  # stop serving the wrapper
        if self._mirrored is not None:
            # terminate the deposed wrapper's mirror streams: followers
            # still subscribed would otherwise keep eating its old-term
            # heartbeats (equal terms pass the fence) and never learn a
            # newer lineage exists
            self._mirrored.close_subscribers()
        self._mirrored = None

    def _follow(self, leader_id: int) -> None:
        """Replay the leader's mirror stream until it is lost (-> elect)
        or proves stale (-> elect). Resumes from the local revision with
        our term attached, so a deposed-lineage history triggers the
        leader's forced full-state transfer + local WAL rebase."""
        self._set_role(ROLE_FOLLOWER)
        self.server.engine = self.engine
        host, port = self.peers[leader_id]
        # a node that lost an equal-term conflict cannot trust ANY of
        # its history under that term: from_revision=-1 is below every
        # real revision, so the leader's catch-up decision tree bottoms
        # out in a full state transfer (and the local WAL rebases)
        from_rev = -1 if self._rejoin_full else self.engine.revision
        try:
            follower_loop(
                self.engine, host, port, token=self.token,
                ssl_context=self.client_ssl,
                from_revision=from_rev,
                current_term=self.term,
                heartbeat_timeout=self.heartbeat_timeout,
                ack=True, fail_on_loss=True,
                on_term=self._adopt_term,
                on_progress=self._set_lag,
                connect_deadline=self.heartbeat_timeout)
        except StaleTermError as e:
            log.warning("leader %d is stale: %s", leader_id, e)
        except (LeaderLost, MultiHostError, OSError) as e:
            metrics.counter("mirror_leader_losses_total").inc()
            log.warning("lost leader %d (%s: %s)", leader_id,
                        type(e).__name__, e)
        except Exception:  # noqa: BLE001 - replay/rebase faults
            # a store/persistence error mid-replay (disk full during a
            # rebase, a corrupt frame) must not kill the coordinator
            # thread: log it loudly and fall back to election — the
            # retry either heals (transient) or keeps the failure
            # visible in the logs (persistent), instead of wedging the
            # process as a silent not_leader-forever replica
            metrics.counter("mirror_follow_errors_total").inc()
            log.exception("follower replay failed against leader %d; "
                          "re-electing", leader_id)
