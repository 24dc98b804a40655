"""The engine mirror: one leader's actions replayed on follower hosts.

The PyTorch port's counterpart of the JAX package's
``parallel/multihost.py``. The mirror is the ordinary engine protocol
(engine/remote.py) between engine-host processes; the device collectives
of a mesh spanning processes (parallel/sharded.py) ride the
``torch.distributed`` world that :func:`init_distributed` joins (``nccl``
on the card, ``gloo`` on the CPU).

A leader wraps its engine in :class:`MirroredEngine`, which SERIALIZES
every state mutation (and, in lockstep mode, every device dispatch),
publishes each action to subscribed followers over the engine protocol
(``mirror_subscribe``, a server-push stream like watches), resolves wall
clocks to concrete values before publishing, and only then executes
locally; followers replay the stream 1:1 (:func:`follower_loop`). A
follower that resumes from its own recovered revision is caught up first
(:func:`apply_catchup`: an effects replay from the leader's watch
history, or a full state transfer that goes through the port engine's
restore path).

Two modes:

- **lockstep** (``mirror_queries=True``, ``--distributed``): queries
  are mirrored too, so every process runs the same dispatch sequence and
  so enters the same collectives of a mesh that spans the processes. The
  set is all-or-nothing: with a dead follower the leader's next
  collective fails (gloo) or blocks (nccl) and never answers; the
  process set restarts as a unit;
- **failover** (``mirror_queries=False``, ``sync_replication=True``, the
  ``--peers`` primary/replica set of parallel/failover.py): queries serve
  leader-locally, a write's ack waits for every live follower to apply
  AND journal its frame, every frame/heartbeat/catch-up/ack carries a
  fenced ``term``, and a dead LEADER is survivable: a follower promotes
  and clients re-resolve.
"""

from __future__ import annotations

import logging
import queue
import threading
from typing import Optional

from ..utils.metrics import metrics

log = logging.getLogger("sdbkp.torch.multihost")


class MultiHostError(RuntimeError):
    pass


class StaleTermError(MultiHostError):
    """A mirror frame (or subscription ack) carried a term OLDER than the
    one this process has already adopted: a deposed leader's late output.
    Fencing rejects it — applying it would fork the store lineages."""


class LeaderLost(MultiHostError):
    """The mirror stream's leader stopped heartbeating (or the connection
    died) while the follower was configured to treat that as a failover
    trigger rather than an orchestrator-restart event."""


def fence_term(frame_term, current_term: int) -> int:
    """The ONE fencing check: given the term stamped on an incoming
    mirror artifact (frame, heartbeat, catch-up cut, subscription ack;
    ``None`` = a pre-term peer) and the highest term this process has
    adopted, return the possibly-advanced current term — or raise
    :class:`StaleTermError` (counting it) when the artifact belongs to a
    deposed lineage."""
    if frame_term is None:
        return current_term
    frame_term = int(frame_term)
    if frame_term < current_term:
        metrics.counter("mirror_frames_rejected_stale_term_total").inc()
        raise StaleTermError(
            f"rejecting mirror frame from deposed term {frame_term} "
            f"(current term {current_term})")
    return frame_term


def parse_distributed_spec(spec: str) -> tuple[str, int, int]:
    """``coordinator_host:port,num_processes,process_id`` -> parsed
    triple. The ONE owner of this format — the engine-host CLI also
    consults it (follower detection) before initializing anything."""
    parts = spec.split(",")
    if len(parts) != 3:
        raise MultiHostError(
            f"--distributed {spec!r}: expected "
            "coordinator_host:port,num_processes,process_id")
    coordinator, num, pid = parts
    try:
        n, p = int(num), int(pid)
    except ValueError:
        raise MultiHostError(
            f"--distributed {spec!r}: num_processes and process_id "
            "must be integers") from None
    if not (0 <= p < n):
        raise MultiHostError(
            f"--distributed {spec!r}: process_id must be in [0, {n})")
    return coordinator, n, p


# how long a rank waits for the others at init and in a collective
DISTRIBUTED_TIMEOUT_S = 300.0


def init_distributed(spec: str, device=None) -> None:
    """Join the ``torch.distributed`` world named by ``spec`` (format:
    :func:`parse_distributed_spec`; the engine-host CLI's
    ``--distributed``): ``init_method`` ``tcp://coordinator``, the world
    size and this process's rank from the spec. The backend follows the
    engine's device: ``nccl`` on ``cuda`` (the default; one rank a card),
    ``gloo`` when the caller asked for the CPU. A failed init raises
    :class:`MultiHostError`; nothing carries on without the group."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    from ..device import resolve_device

    coordinator, n, p = parse_distributed_spec(spec)
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    try:
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator}", world_size=n,
            rank=p, timeout=timedelta(seconds=DISTRIBUTED_TIMEOUT_S))
    except (RuntimeError, ValueError, OSError) as e:
        raise MultiHostError(
            f"--distributed {spec!r}: {backend} init failed: {e}") from e


class MirroredEngine:
    """Leader-side engine wrapper for multi-host serving.

    Every state mutation and device-dispatching query is (a) serialized
    under one lock — lockstep processes must execute identical dispatch
    sequences, so concurrent request handlers are ordered here — and
    (b) published to follower subscribers BEFORE executing locally, with
    wall clocks resolved to concrete values (``now=None`` would read a
    different clock on every process). Device-free reads, and every op
    this class does not define (the ``slice_*``, ``frontier_*`` and
    ``migrate_*`` engine methods among them, unmirrored as in the JAX
    package), pass straight through to the inner engine.

    The proxy-facing surface matches :class:`~..engine.engine.Engine`
    closely enough for EngineServer and the authz layers (check_bulk,
    lookup_resources[_mask], write/delete/read, watch, store, gate)."""

    def __init__(self, engine, min_subscribers: int = 0,
                 join_timeout: float = 300.0, term: int = 0,
                 mirror_queries: bool = True,
                 sync_replication: bool = False,
                 replication_timeout: float = 10.0,
                 min_sync_replicas: int = 0):
        self.engine = engine
        self._lock = threading.Lock()
        self._subs: list[queue.Queue] = []
        self._subs_lock = threading.Lock()
        self._seq = 0
        # fenced term (leader failover, parallel/failover.py): stamped
        # into every published frame, heartbeat, and catch-up cut so a
        # deposed leader's late output is rejectable. 0 = the lockstep
        # deployment, which never changes leaders.
        self.term = int(term)
        # revision at promotion: shared history ends here. A subscriber
        # resuming from a REVISION past this point with a TERM before
        # ours lived through writes this lineage fenced off — the
        # general form of the catch-up's "follower ahead of leader"
        # rule (subscribe_with_catchup).
        self.baseline_revision = int(engine.revision)
        # failover (primary/replica) mode mirrors only MUTATIONS: there
        # is no lockstep to keep, so queries serve leader-locally
        # (decision cache and batching stay effective)
        self._mirror_queries = mirror_queries
        # sync replication: a mutation does not return to the caller
        # until every live subscriber has ACKED its frame (having
        # journaled it under the follower's own fsync policy) — the
        # no-acked-write-lost guarantee leader SIGKILL failover needs
        self._sync_replication = sync_replication
        self._replication_timeout = replication_timeout
        # durability floor: with fewer live subscribers than this, writes
        # FAIL CLOSED instead of acking unreplicated (the window a
        # partitioned leader would otherwise silently lose on demotion).
        # 0 = availability over redundancy (a 1-of-2 set keeps serving).
        self._min_sync_replicas = int(min_sync_replicas)
        self._ack_cond = threading.Condition(self._subs_lock)
        self._acked: dict[int, int] = {}  # id(queue) -> highest acked seq
        # id(queue) -> catch-up cut seq: frames at or before the cut are
        # NOT this subscriber's responsibility (the transfer covers
        # them) — but that is responsibility accounting, not durability:
        # only a real ack (the follower applied AND journaled) counts
        # toward the min-sync floor
        self._join_cut: dict[int, int] = {}
        # JOIN BARRIER: a leader must not execute (or drop!) any action
        # before every follower is subscribed — writes never touch the
        # device, so nothing else would stop an early client write from
        # silently missing a follower and desyncing the stores. _publish
        # blocks until the expected follower count has joined.
        self._min_subs = min_subscribers
        self._join_timeout = join_timeout
        self._joined = threading.Event()
        if min_subscribers <= 0:
            self._joined.set()

    # -- follower stream -----------------------------------------------------

    @property
    def mirror_seq(self) -> int:
        with self._subs_lock:
            return self._seq

    def subscribe(self) -> "queue.Queue[dict]":
        q: queue.Queue = queue.Queue()
        with self._subs_lock:
            self._subs.append(q)
            # frames sequenced before this join are not the new
            # subscriber's RESPONSIBILITY (they were never sent to it;
            # a catch-up cut supersedes this with its own seq) — but
            # responsibility is not durability: _acked starts at 0 and
            # only real acks ever satisfy the min-sync floor
            self._acked[id(q)] = 0
            self._join_cut[id(q)] = self._seq
            if len(self._subs) >= self._min_subs:
                self._joined.set()
        return q

    def subscribe_with_catchup(self, from_revision: int,
                               subscriber_term: Optional[int] = None):
        """(queue, catch-up meta, optional state payload) for a RESUMING
        follower (``mirror_subscribe`` with ``from_revision``).

        The queue registers FIRST — a plain :meth:`subscribe`, so the
        join barrier counts this follower immediately and a leader
        parked in ``_publish`` waiting for it can proceed (taking the
        mirror lock before subscribing would deadlock that barrier).
        The consistent cut then happens under the mirror lock, which
        excludes in-flight publish+execute pairs: the catch-up state
        reflects every action sequenced at or before ``meta["seq"]``,
        and the follower SKIPS queued frames with ``seq <=`` that value
        (they are already inside the catch-up) — nothing double-applies,
        nothing is missed.

        Catch-up forms, cheapest first: already-current (nothing),
        effects replay from the leader's retained watch history, or a
        full compacted state transfer (the follower's revision predates
        retained history or a bulk load)."""
        from dataclasses import asdict

        from ..engine.store import OP_DELETE, StoreError

        q = self.subscribe()
        with self._lock:
            with self._subs_lock:
                seq = self._seq
                # the catch-up cut covers every frame at or before it,
                # and the follower rightly never acks frames it skips —
                # record the cut so a sync-replicated write racing this
                # join neither stalls a full replication timeout nor
                # kicks the freshly joined follower. This is NOT an ack:
                # the transfer hasn't reached the follower yet, so it
                # must not count toward the min-sync durability floor
                # (the follower acks the cut itself once the catch-up
                # is applied and journaled — follower_loop).
                self._join_cut[id(q)] = seq
                self._ack_cond.notify_all()
            store = self.engine.store
            rev = store.revision
            # the general fencing form of the "follower ahead of leader"
            # rule below: a subscriber from a DEPOSED term whose revision
            # runs past our promotion baseline lived through writes this
            # lineage fenced off — its revision NUMBERS overlap ours but
            # name different history, so neither "already current" nor an
            # effects replay is sound. Full state, unconditionally.
            deposed = (subscriber_term is not None and self.term
                       and int(subscriber_term) < self.term
                       and from_revision > self.baseline_revision)
            if deposed:
                log.warning(
                    "subscriber resumes from deposed term %s at revision "
                    "%d past promotion baseline %d (term %d); sending "
                    "full state", subscriber_term, from_revision,
                    self.baseline_revision, self.term)
            if not deposed and from_revision == rev:
                return q, {"revision": rev, "seq": seq,
                           "term": self.term}, None
            if not deposed and from_revision > rev:
                # the follower claims MORE history than the leader has:
                # a lost leader disk or a rolled-back fsync window — the
                # lineages diverged, and "already current" would freeze
                # the divergence. Force a full state transfer onto the
                # leader's lineage (the source of truth for serving).
                log.warning(
                    "follower resume revision %d is ahead of leader "
                    "revision %d (diverged lineage); sending full state",
                    from_revision, rev)
            elif not deposed and from_revision >= store.unlogged_revision:
                try:
                    records = store.watch_since(from_revision)
                except StoreError:
                    records = None
                if records is not None:
                    effects = [
                        {"op": "delete" if r.op == OP_DELETE else "touch",
                         "rel": asdict(r.rel)}
                        for r in records
                    ]
                    return q, {"revision": rev, "seq": seq,
                               "term": self.term,
                               "effects": effects}, None
            # full state transfer: COLLECT under the lock (the arrays are
            # immutable copies cut consistently with `seq`)...
            cols, meta = store._collect_state()
        # ...but compress OUTSIDE it — savez_compressed over a multi-GB
        # store must not stall every leader write and mirrored query
        payload = store.encode_state(cols, meta)
        return q, {"revision": int(meta["revision"]), "seq": seq,
                   "term": self.term, "state": True}, payload

    def unsubscribe(self, q) -> None:
        with self._subs_lock:
            if q in self._subs:
                self._subs.remove(q)
            self._acked.pop(id(q), None)
            self._join_cut.pop(id(q), None)
            # a write parked in _wait_replicated stops waiting for a
            # subscriber that no longer exists
            self._ack_cond.notify_all()

    def close_subscribers(self) -> None:
        """Terminate every mirror stream (deposed-leader demotion,
        parallel/failover.py): a follower still subscribed here would
        otherwise keep receiving valid old-term heartbeats from the
        frozen wrapper and never notice the leadership change. The None
        sentinel makes each connection handler close its stream; the
        follower sees LeaderLost and re-elects toward the new lineage."""
        with self._subs_lock:
            for q in self._subs:
                q.put(None)
            self._subs.clear()
            self._acked.clear()
            self._join_cut.clear()
            self._ack_cond.notify_all()

    def record_ack(self, q, seq: int, term: Optional[int] = None) -> None:
        """A follower acknowledged every frame up to ``seq`` (having
        applied AND journaled them). Cross-subscription confusion is
        impossible by construction (``q`` is the connection's own queue
        object, not a wire-carried id), so only a FUTURE-term ack is
        rejected as nonsensical — an older-term ack is legitimate
        lineage continuity when an equal-term conflict bumped this
        wrapper's term mid-flight, and dropping it would stall the
        write and kick a healthy follower."""
        if term is not None and self.term and int(term) > self.term:
            return
        with self._subs_lock:
            if id(q) in self._acked:
                self._acked[id(q)] = max(self._acked[id(q)], int(seq))
                self._ack_cond.notify_all()

    def _wait_replicated(self, seq: int) -> None:
        """Block until every LIVE subscriber has acked ``seq``. A
        subscriber that dies mid-wait stops being waited on when its
        connection handler unsubscribes it; one that stalls past the
        replication timeout is dropped (it rejoins through catch-up) so a
        wedged follower bounds, not wedges, the leader's write path.
        When dropping laggards leaves fewer acked replicas than the
        ``min_sync_replicas`` floor, the write FAILS instead of acking —
        the mutation is applied locally (outcome: unknown to the
        caller, exactly like a write whose response connection died),
        never acknowledged as durable when it is not."""
        import time as _time

        from ..obs.trace import tracer
        from ..utils.metrics import metrics

        t_wait0 = _time.perf_counter()
        ack_span = tracer.begin("replication_ack_wait", seq=seq)
        try:
            self._wait_replicated_inner(seq)
        finally:
            metrics.histogram("engine_replication_ack_seconds").observe(
                _time.perf_counter() - t_wait0)
            if ack_span is not None:
                ack_span.finish()

    def _wait_replicated_inner(self, seq: int) -> None:
        import time as _time

        deadline = _time.monotonic() + self._replication_timeout
        # ids observed acking >= seq at ANY point — an ack is a durable
        # journal entry on that replica, so it still counts toward the
        # floor if the follower then rotates away; a follower that
        # UNSUBSCRIBES WITHOUT acking (connection died mid-frame) never
        # enters this set, so the floor check below catches it even
        # though the no-laggards exit fires the moment it departs
        satisfied: set[int] = set()
        with self._subs_lock:
            while True:
                laggards = []
                for q in self._subs:
                    if self._acked.get(id(q), 0) >= seq:
                        satisfied.add(id(q))
                    elif self._join_cut.get(id(q), -1) >= seq:
                        # the frame is inside this joiner's catch-up cut:
                        # not a laggard (don't stall or kick it), but not
                        # durably acked either — it joins `satisfied`
                        # only via its real post-catch-up cut ack
                        pass
                    else:
                        laggards.append(q)
                # done only when nobody is behind AND the durability
                # floor is met — a joiner mid-catch-up is not a laggard
                # but hasn't journaled yet, so a floored write keeps
                # waiting (bounded) for its post-catch-up ack
                if not laggards \
                        and len(satisfied) >= self._min_sync_replicas:
                    break
                left = deadline - _time.monotonic()
                if left <= 0:
                    for q in laggards:
                        log.warning(
                            "dropping mirror subscriber %d frames behind "
                            "after %.1fs replication timeout (it can "
                            "rejoin via catch-up)",
                            seq - self._acked.get(id(q), 0),
                            self._replication_timeout)
                        self._subs.remove(q)
                        self._acked.pop(id(q), None)
                        # a None sentinel makes the connection handler
                        # close the stream — the follower must SEE the
                        # drop (a silently unfed queue would heartbeat
                        # forever while diverging)
                        q.put(None)
                    self._ack_cond.notify_all()
                    break
                self._ack_cond.wait(left)
        if len(satisfied) < self._min_sync_replicas:
            from ..engine.store import StoreError

            raise StoreError(
                f"write replicated to only {len(satisfied)} replica(s) "
                f"within {self._replication_timeout:.1f}s, below the "
                f"min-sync-replicas floor of {self._min_sync_replicas}; "
                "treating the outcome as unknown (applied locally, not "
                "acknowledged as durable)")

    def _publish(self, method: str, payload: dict,
                 blob: Optional[bytes] = None) -> Optional[int]:
        """Serialize the action ONCE into wire bytes and fan the same
        bytes object out to every subscriber queue — at N followers the
        leader must not pay N JSON encodes per action. ``blob`` rides a
        binary
        frame (meta + payload) for the hot check_bulk item batches.
        Returns the frame's sequence number, or None when nobody was
        subscribed (nothing to wait replicated on)."""
        from ..engine.remote import BinaryResult, _pack, _pack_binary

        if not self._joined.wait(self._join_timeout):
            raise MultiHostError(
                f"{self._min_subs} follower(s) did not subscribe within "
                f"{self._join_timeout:.0f}s; refusing to serve (an "
                "unmirrored action would silently desync the stores)")
        with self._subs_lock:
            subs = list(self._subs)
            self._seq += 1
            seq = self._seq
            if not subs:
                # nobody mirroring (single-host MirroredEngine, or every
                # follower already gone): skip serialization entirely —
                # seq still advances; a later joiner baselines on the
                # first frame it receives (and must join before traffic
                # to share store state, per the join-barrier contract)
                return None
        # serialize OUTSIDE _subs_lock: a multi-MB check_bulk encode must
        # not block subscribe()/unsubscribe() (a rejoining follower's join
        # barrier would wait out encode time per batch). Frame ordering is
        # unaffected — every _publish call site already serializes on the
        # engine-level self._lock.
        frame = {"seq": seq, "method": method, **payload}
        if self.term:
            frame["term"] = self.term
        if blob is None:
            wire = _pack({"ok": True, "frame": frame})
        else:
            blob = blob() if callable(blob) else blob
            wire = _pack_binary(
                BinaryResult({"ok": True, "frame": frame}, blob))
        for q in subs:
            q.put(wire)
        return seq

    # -- mirrored mutations --------------------------------------------------

    def _require_replicas(self) -> None:
        """Fail a mutation CLOSED when the live subscriber count is below
        the configured durability floor — an ack the leader could not
        replicate is an ack a failover may silently discard."""
        if not self._sync_replication or self._min_sync_replicas <= 0:
            return
        from ..engine.store import StoreError

        with self._subs_lock:
            n = len(self._subs)
        if n < self._min_sync_replicas:
            raise StoreError(
                f"only {n} live replica(s), below the min-sync-replicas "
                f"floor of {self._min_sync_replicas}: refusing the write "
                "(an unreplicated ack would not survive leader failover)")

    def _write_headroom(self, n_records: int) -> None:
        """Overlay back-pressure must run BEFORE the frame is published:
        a shed after publish would leave followers holding a write the
        leader never applied (a silent lineage fork). The local apply —
        and every follower's replay (apply_mirror_frame) — then runs
        with the headroom gate off: once published, the mutation is
        committed to the replication stream and MUST land everywhere,
        even if the overlay overflows into a counted fallback recompile."""
        hr = getattr(self.engine, "_write_headroom", None)
        if hr is not None:
            hr(n_records)

    def write_relationships(self, ops, preconditions=(), *,
                            _headroom: bool = True):
        from ..engine.remote import _rel_to_dict
        from dataclasses import asdict

        if _headroom:
            self._write_headroom(len(ops))
        self._require_replicas()
        with self._lock:
            seq = self._publish("write_relationships", {
                "ops": [{"op": o.op, "rel": _rel_to_dict(o.rel)}
                        for o in ops],
                "preconditions": [
                    {"filter": asdict(p.filter),
                     "must_exist": p.must_exist}
                    for p in preconditions],
            })
            result = self.engine.write_relationships(
                list(ops), list(preconditions), _headroom=False)
        self._maybe_wait(seq)
        return result

    def delete_relationships(self, f, preconditions=(), *,
                             _headroom: bool = True):
        from dataclasses import asdict

        if _headroom:
            self._write_headroom(1)
        self._require_replicas()
        with self._lock:
            seq = self._publish("delete_relationships", {
                "filter": asdict(f),
                "preconditions": [
                    {"filter": asdict(p.filter),
                     "must_exist": p.must_exist}
                    for p in preconditions],
            })
            result = self.engine.delete_relationships(
                f, list(preconditions), _headroom=False)
        self._maybe_wait(seq)
        return result

    def bulk_load(self, rels_cols):
        # columnar payloads are huge: ride the binary-payload frame (the
        # npz columnar codec, persistence/codec.py) like the hot
        # check_bulk batches do, instead of serializing one JSON string
        # per cell — built LAZILY so a subscriber-less leader pays
        # nothing
        from ..persistence.codec import encode_bulk_cols

        self._require_replicas()
        with self._lock:
            seq = self._publish("bulk_load", {},
                                blob=lambda: encode_bulk_cols(rels_cols))
            result = self.engine.bulk_load(rels_cols)
        self._maybe_wait(seq)
        return result

    def _maybe_wait(self, seq: Optional[int]) -> None:
        # outside the mirror lock on purpose: waiting for follower acks
        # must not serialize every other mirrored op behind one write's
        # replication round trip
        if not self._sync_replication:
            return
        if seq is None:
            # nobody was subscribed at publish time. _require_replicas
            # ran before the mirror lock, so the last follower can
            # vanish in between — the floor must hold on the PUBLISH
            # outcome too, or that race acks an unreplicated write
            if self._min_sync_replicas > 0:
                from ..engine.store import StoreError

                raise StoreError(
                    "write published to 0 replicas (the last follower "
                    "left mid-write), below the min-sync-replicas floor "
                    f"of {self._min_sync_replicas}; treating the outcome "
                    "as unknown (applied locally, not acknowledged as "
                    "durable)")
            return
        self._wait_replicated(seq)

    # -- mirrored queries ----------------------------------------------------

    def check_bulk(self, items, now=None, context=None):
        return self.check_bulk_async(items, now=now,
                                     context=context).result()

    def check_bulk_async(self, items, now=None, context=None):
        import time as _time

        if not self._mirror_queries:
            # failover (primary/replica) mode: no lockstep to keep —
            # queries serve leader-locally (cache/batching stay live)
            return self.engine.check_bulk_async(items, now=now,
                                                context=context)
        if now is None:
            now = _time.time()  # concrete BEFORE publishing
        # normalize ONCE and execute the normalized items locally too —
        # publishing a str-coerced copy while executing the raw items
        # would let a non-str field produce different dispatch groups on
        # leader and follower
        items = [normalize_check_item(it) for it in items]
        with self._lock:
            # the firehose path: items ride a flat binary payload built
            # LAZILY — _publish only materializes it when subscribers
            # exist (the encode is the dominant publish cost)
            self._publish("check_bulk", {"now": now, "ctx": context},
                          blob=lambda: encode_check_items(items))
            # dispatch inside the lock (ordering), result read outside
            return self.engine.check_bulk_async(items, now=now,
                                                context=context)

    def check(self, item, now=None, context=None):
        return self.check_bulk([item], now=now, context=context)[0]

    def lookup_resources(self, resource_type, permission, subject_type,
                         subject_id, subject_relation=None, now=None,
                         context=None):
        from ..engine.engine import mask_to_ids

        mask, interner = self.lookup_resources_mask(
            resource_type, permission, subject_type, subject_id,
            subject_relation, now=now, context=context)
        return mask_to_ids(mask, interner)

    def lookup_resources_mask(self, resource_type, permission,
                              subject_type, subject_id,
                              subject_relation=None, now=None,
                              context=None):
        return self.lookup_resources_mask_async(
            resource_type, permission, subject_type, subject_id,
            subject_relation, now=now, context=context).result()

    def lookup_resources_mask_async(self, resource_type, permission,
                                    subject_type, subject_id,
                                    subject_relation=None, now=None,
                                    context=None):
        import time as _time

        if not self._mirror_queries:
            return self.engine.lookup_resources_mask_async(
                resource_type, permission, subject_type, subject_id,
                subject_relation, now=now, context=context)
        if now is None:
            now = _time.time()
        with self._lock:
            self._publish("lookup_mask", {
                "resource_type": resource_type, "permission": permission,
                "subject_type": subject_type, "subject_id": subject_id,
                "subject_relation": subject_relation, "now": now,
                "ctx": context,
            })
            return self.engine.lookup_resources_mask_async(
                resource_type, permission, subject_type, subject_id,
                subject_relation, now=now)

    # -- device-free passthrough ---------------------------------------------

    def __getattr__(self, name):
        return getattr(self.engine, name)


def normalize_check_item(it):
    """Leader-side trust boundary: field values arrive from client JSON
    with no type guarantee. Coerce to str (None stays None for the
    subject relation) and use the SAME normalized item for publishing
    and local execution — leader and follower then cannot diverge on a
    field the codec or the interner would treat differently. Fast path:
    items that are already all-str (the normal case) pass through
    untouched."""
    from ..engine import CheckItem

    sr = it.subject_relation
    if type(it.resource_type) is str and type(it.resource_id) is str \
            and type(it.permission) is str \
            and type(it.subject_type) is str \
            and type(it.subject_id) is str \
            and (sr is None or type(sr) is str):
        return it
    return CheckItem(
        str(it.resource_type), str(it.resource_id), str(it.permission),
        str(it.subject_type), str(it.subject_id),
        None if sr is None else str(sr))


def encode_check_items(items) -> bytes:
    """CheckItems -> one FLAT JSON array of 6N fields (None for a missing
    subject relation), utf-8. One C-speed ``json.dumps`` per batch —
    injective for ANY string content (JSON escapes control characters,
    so client-controlled ids round-trip exactly and "" stays distinct
    from None; both matter — the engine groups device dispatches by
    subject key, so a lossy codec would desync the dispatch sequence).
    The same bytes as the JAX package's codec, so either package's
    follower replays the other's leader."""
    import json as _json

    flat = []
    for it in items:
        flat += (it.resource_type, it.resource_id, it.permission,
                 it.subject_type, it.subject_id, it.subject_relation)
    return _json.dumps(flat, ensure_ascii=False,
                       separators=(",", ":")).encode()


def decode_check_items(blob: bytes) -> list:
    import json as _json

    from ..engine import CheckItem

    try:
        flat = _json.loads(blob)
    except ValueError:
        raise MultiHostError("malformed check-item payload") from None
    if not isinstance(flat, list) or len(flat) % 6:
        raise MultiHostError("malformed check-item payload")
    return [CheckItem(*flat[i:i + 6]) for i in range(0, len(flat), 6)]


def apply_mirror_frame(engine, frame: dict,
                       blob: Optional[bytes] = None) -> None:
    """Execute one published action on a follower's local engine. The
    caller guarantees in-order delivery (TCP stream). ``blob`` carries
    the compact binary payload for check_bulk frames."""
    from ..engine.engine import SchemaViolation
    from ..engine.store import StoreError

    m = frame["method"]
    try:
        _apply_one(engine, frame, m, blob)
    except (StoreError, SchemaViolation) as e:
        # deterministic engine-level failures (precondition conflicts,
        # schema violations, AlreadyExists) happen IDENTICALLY on the
        # leader — its execution runs after publishing — so the stores
        # stay in sync; a follower must keep replaying, not die and
        # fall out of step with the leader
        log.debug("mirror frame %s failed identically to leader: %s",
                  m, e)


def _apply_one(engine, frame: dict, m: str,
               blob: Optional[bytes] = None) -> None:
    from ..engine import CheckItem
    from ..engine.remote import _filter_from_dict, _rel_from_dict
    from ..engine.store import Precondition, WriteOp

    if m == "write_relationships":
        # _headroom=False: a replicated frame is already committed to
        # the stream — a follower shedding it on overlay back-pressure
        # would silently fork the store lineages. The overlay still
        # absorbs it when it fits; overflow falls back to a counted
        # recompile (and the follower's own compactor, when enabled,
        # folds in the background).
        engine.write_relationships(
            [WriteOp(o["op"], _rel_from_dict(o["rel"]))
             for o in frame["ops"]],
            [Precondition(_filter_from_dict(p["filter"]), p["must_exist"])
             for p in frame.get("preconditions", [])],
            _headroom=False)
    elif m == "delete_relationships":
        engine.delete_relationships(
            _filter_from_dict(frame["filter"]),
            [Precondition(_filter_from_dict(p["filter"]), p["must_exist"])
             for p in frame.get("preconditions", [])],
            _headroom=False)
    elif m == "bulk_load":
        if blob is not None:
            from ..persistence.codec import decode_bulk_cols

            engine.bulk_load(decode_bulk_cols(blob))
        else:
            # legacy JSON-list frame from an older leader
            import numpy as np

            cols = {}
            for k, v in frame["cols"].items():
                if k == "expiration":
                    cols[k] = np.asarray(
                        [np.nan if x is None else x for x in v],
                        dtype=np.float64)
                else:
                    cols[k] = np.asarray(v, dtype=object)
            engine.bulk_load(cols)
    elif m == "check_bulk":
        items = decode_check_items(blob) if blob is not None \
            else [CheckItem(*it) for it in frame["items"]]
        engine.check_bulk(items, now=frame["now"],
                          context=frame.get("ctx") or None)
    elif m == "lookup_mask":
        engine.lookup_resources_mask(
            frame["resource_type"], frame["permission"],
            frame["subject_type"], frame["subject_id"],
            frame.get("subject_relation"), now=frame["now"],
            context=frame.get("ctx") or None)
    else:
        raise MultiHostError(f"unknown mirror method {m!r}")


def apply_catchup(engine, meta: dict, blob: Optional[bytes]) -> None:
    """Apply a leader catch-up frame on the follower: a full compacted
    state transfer (binary payload) or a concrete effects replay, both
    landing the store exactly at the leader's revision. No-op when the
    follower was already current.

    A full transfer is a restore, so it runs the port engine's restore
    path under the engine lock, as ``load_snapshot`` does: the lookup
    batcher's open window is dispatched first, then the store is
    replaced, then ``Engine._restored`` drops the published and head
    views, frees the old base's device state and replaces the decision
    cache. (The JAX package only clears ``_compiled``; in the port that
    would leave the head view, the resident device state and the cache
    on the old lineage.) An effects replay goes through the store alone,
    and the engine's next read brings its view current from the store's
    newer revision, by an overlay update or a counted recompile."""
    import time as _time

    t0 = _time.perf_counter()
    if blob is not None:
        with engine._lock:
            engine._flush_batcher()
            persistence = engine.persistence
            try:
                if persistence is not None:
                    # a full-state transfer is a NEW LINEAGE BASELINE: the
                    # local WAL + snapshots describe superseded (possibly
                    # fenced-off) history whose revision numbers may
                    # overlap the incoming ones — keeping them would make
                    # the next boot's replay see revisions go backwards.
                    # Rebase: wipe, install, re-journal the baseline as
                    # the fresh log's first record.
                    persistence.rebase(blob)
                else:
                    engine.store.load_state_bytes(blob)
            finally:
                # a diverged-lineage transfer can land on the SAME
                # revision number with different rows — the revision
                # check alone would keep serving the old lineage's graph
                # (and its decision-cache verdicts under colliding
                # revisions); a transfer that failed part way also
                # replaced what the views were compiled from
                engine._restored()
        log.info("catch-up: installed leader state at revision %d "
                 "(%d bytes) in %.3f s", engine.store.revision, len(blob),
                 _time.perf_counter() - t0)
        return
    effects = meta.get("effects")
    if effects:
        with engine._lock:
            engine.store.apply_effects(effects, int(meta["revision"]))
        log.info("catch-up: applied %d effects to revision %d in %.3f s",
                 len(effects), engine.store.revision,
                 _time.perf_counter() - t0)


# mirror frames that mutate store state (and therefore get follower
# acks under sync replication — query frames advance nothing durable)
MUTATION_METHODS = frozenset(
    {"write_relationships", "delete_relationships", "bulk_load"})


def follower_loop(engine, leader_host: str, leader_port: int,
                  token: Optional[str] = None,
                  ssl_context=None,
                  server_hostname: Optional[str] = None,
                  from_revision: Optional[int] = None,
                  current_term: int = 0,
                  heartbeat_timeout: Optional[float] = None,
                  ack: bool = False,
                  fail_on_loss: bool = False,
                  on_term=None,
                  on_progress=None,
                  connect_deadline: float = 120.0) -> None:
    """Blocking follower: subscribe to the leader's mirror stream and
    replay every action on the local engine. Returns when the leader
    closes the connection; raises on protocol errors.
    ``ssl_context`` wraps the subscription in TLS (the leader serves the
    ordinary engine endpoint, which is TLS unless --engine-insecure).

    ``from_revision`` (a restarting follower's own recovered revision —
    ``engine.revision`` after ``enable_persistence``) asks the leader for
    catch-up: the delta since that revision arrives as the stream's first
    frame (effects replay or a full state transfer) before live mirror
    frames, so rejoining needs no manual bulk_load and no unbroken
    process-lifetime stream.

    Failover-mode knobs (parallel/failover.py is the one caller):
    ``current_term`` fences every term-stamped artifact on the stream
    (:func:`fence_term`; ``on_term`` fires when a HIGHER term is adopted
    so the caller can persist it); ``heartbeat_timeout`` shrinks the
    dead-leader detection window and surfaces it as :class:`LeaderLost`
    (as does a dropped connection, when ``fail_on_loss``); ``ack`` sends
    per-mutation acknowledgements back up the stream (the leader's sync
    replication waits on them — the frame is applied AND journaled under
    this store's fsync policy before the ack leaves); ``on_progress``
    receives the follower's lag in frames behind the leader's heartbeat
    sequence."""
    import socket
    import struct
    import time as _time

    from ..engine.remote import EngineServer, _pack, _read_frame_sync

    # the leader may bind its port after the follower starts: retry
    # refusals briefly
    deadline = _time.monotonic() + connect_deadline
    while True:
        try:
            s = socket.create_connection((leader_host, leader_port),
                                         timeout=5)
            break
        except OSError:
            if _time.monotonic() > deadline:
                raise MultiHostError(
                    f"leader {leader_host}:{leader_port} never came up")
            _time.sleep(0.25)
    s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    if ssl_context is not None:
        try:
            s = ssl_context.wrap_socket(
                s, server_hostname=server_hostname or leader_host)
        except Exception:
            s.close()
            raise
    # heartbeats arrive every PUSH_HEARTBEAT on idle streams; anything
    # slower means a dead leader, not an idle one (a None timeout would
    # leave a partitioned follower blocked forever, invisible to its
    # supervisor)
    if heartbeat_timeout is None:
        heartbeat_timeout = EngineServer.PUSH_HEARTBEAT * 3 + 5.0
    s.settimeout(heartbeat_timeout)
    msg = {"op": "mirror_subscribe"}
    if from_revision is not None:
        msg["from_revision"] = int(from_revision)
    if current_term:
        msg["term"] = int(current_term)
    if token:
        msg["token"] = token

    def adopt(frame_term):
        nonlocal current_term
        new = fence_term(frame_term, current_term)
        if new > current_term:
            current_term = new
            if on_term is not None:
                on_term(new)

    try:
        t_sub = _time.perf_counter()
        s.sendall(_pack(msg))
        ack_frame = _read_frame_sync(s)
        if isinstance(ack_frame, tuple) or not ack_frame.get("ok"):
            raise MultiHostError(f"mirror subscribe rejected: {ack_frame}")
        adopt((ack_frame.get("result") or {}).get("term"))
        expect = None
        skip_upto = None
        applied_seq = 0
        while True:
            try:
                frame = _read_frame_sync(s)
            except TimeoutError:
                metrics.counter("mirror_heartbeat_misses_total").inc()
                raise LeaderLost(
                    f"leader {leader_host}:{leader_port} missed its "
                    f"heartbeat window ({heartbeat_timeout:.1f}s)"
                ) from None
            blob = None
            if isinstance(frame, tuple):
                # binary mirror frame: (meta, payload) — the hot
                # check_bulk batches ride a compact payload
                frame, blob = frame
            if not frame.get("ok"):
                raise MultiHostError(f"mirror stream error: {frame}")
            if frame.get("hb"):
                adopt(frame.get("term"))
                hb_seq = frame.get("seq")
                if on_progress is not None and hb_seq is not None:
                    on_progress(max(0, int(hb_seq) - applied_seq))
                continue  # idle-stream liveness heartbeat
            if "catchup" in frame:
                log.info("catch-up frame received %.3f s after the "
                         "subscribe (%d payload bytes)",
                         _time.perf_counter() - t_sub,
                         0 if blob is None else len(blob))
                adopt(frame["catchup"].get("term"))
                apply_catchup(engine, frame["catchup"], blob)
                # actions sequenced at or before the cut are inside the
                # catch-up state; queued frames up to it must be skipped
                skip_upto = frame["catchup"].get("seq")
                applied_seq = int(skip_upto or 0)
                if ack and applied_seq:
                    # the transfer is applied AND journaled (rebase /
                    # effects both run the store's journal hook): every
                    # frame the cut covers is now durable HERE — ack it
                    # so floored writes that raced the join get their
                    # durability credit
                    s.sendall(_pack({"ack": applied_seq,
                                     "term": current_term}))
                continue
            payload = frame["frame"]
            adopt(payload.get("term"))
            # first frame sets the baseline (a lockstep leader cannot have
            # served traffic before followers joined — its join barrier
            # holds it — so nothing real precedes it); after that the
            # stream must be gap-free
            expect = payload["seq"] if expect is None else expect + 1
            if payload["seq"] != expect:
                raise MultiHostError(
                    f"mirror gap: expected seq {expect}, "
                    f"got {payload['seq']}")
            if skip_upto is not None and payload["seq"] <= skip_upto:
                continue  # already covered by the catch-up cut
            apply_mirror_frame(engine, payload, blob)
            applied_seq = int(payload["seq"])
            if ack and payload["method"] in MUTATION_METHODS:
                # applied AND journaled (the store's journal hook runs
                # under its write lock inside the apply): safe to credit
                s.sendall(_pack({"ack": applied_seq,
                                 "term": current_term}))
    except (ConnectionResetError, struct.error):
        if fail_on_loss:
            raise LeaderLost(
                f"leader {leader_host}:{leader_port} closed the mirror "
                "stream") from None
        return  # leader went away: the process set restarts as a unit
    finally:
        s.close()
