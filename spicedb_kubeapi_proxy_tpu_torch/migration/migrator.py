"""SchemaMigrator: the engine's S -> S' state machine.

A copy of the JAX package's ``migration/migrator.py`` with the changes the
port's device state asks for. The phases:

1. **classify** — ``models/schema.py::diff_schemas`` splits the
   transition into additive (no tuple rewrites), rewriting (affected
   tuples re-validated + backfilled through the journaled write path),
   or incompatible (refused with a typed error before any state
   changes).
2. **dual-compile** — the new schema's graph is compiled beside the old
   from a store snapshot, off the engine lock, exactly like the
   compactor's fold (engine/compaction.py), and through the engine's own
   compile (``Engine._compile_fresh``): the engine's device, its overlay
   capacity and its tier budget. The serving graph keeps answering
   throughout. The new graph's device tensors are built by the first
   query after the cut (the reference's lazy build; patches queued
   before then are dropped, ``_Resident.flush``).
3. **journaled backfill** — every tuple on a rewriting relation is
   re-validated under S' and TOUCHed back through
   ``engine.write_relationships`` (WAL + watch log see it), with the echo
   revisions recorded so watch streams stay exactly-once.
4. **dual window** — the new graph catches up on live write traffic by
   replaying watch-log records (``incremental_update``); lag is the
   status signal.
5. **cut** — a write freeze (engine-global, because a schema spans every
   namespace), drain to lag zero, a machine-checked unaffected-verdict
   parity probe (oracle under S vs S' on keys OUTSIDE the diff — any
   mismatch fails the migration instead of cutting), persist CUT, then
   serve S' and its graph at an UNCHANGED revision
   (``Engine._install_schema``): decision-cache keys outside the diff
   survive (``decision_cache.retire_affected``), the old base's device
   state goes when its last view does, and a compaction fold begun under
   S never publishes.

Every phase transition persists to the migration record (JSON, atomic
rename) BEFORE it takes routing effect; ``recover`` is the boot-time
crash matrix: no cut persisted -> clean abort (the schema never
changed; backfill touches are idempotent), cut persisted -> resume and
finish (re-publish S'), done marker -> re-apply until the bootstrap
catches up.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import threading
import time
from typing import Optional

from ..models.schema import (
    REWRITING,
    Schema,
    SchemaError,
    parse_schema,
    require_compatible,
)
from ..utils.metrics import metrics

log = logging.getLogger("sdbkp.torch.migration")

# phase machine — persisted before every routing-effect change
PLANNED = "planned"
COMPILING = "compiling"
BACKFILL = "backfill"
DUAL = "dual"
CUT = "cut"
DONE = "done"
# terminal non-success states (never persisted as a resumable record)
ABORTED = "aborted"
FAILED = "failed"

_PHASE_ORDER = (PLANNED, COMPILING, BACKFILL, DUAL, CUT, DONE)
_PHASE_NUM = {p: i for i, p in enumerate(_PHASE_ORDER)}


def schema_digest(text: str) -> str:
    return hashlib.sha256(text.encode()).hexdigest()[:16]


def _atomic_write_json(path: str, doc: dict) -> None:
    """Persist-before-effect: the record hits disk (fsync + rename)
    before the phase it names takes routing effect."""
    tmp = f"{path}.tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(doc, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


class _WriteGate:
    """Writer/freezer gate for the cutover, engine-wide (a schema spans
    every namespace). A port write holds it across its device half too, so
    once :meth:`freeze` returns every admitted write has been
    acknowledged."""

    def __init__(self):
        self._cv = threading.Condition()
        self._writers = 0
        self._frozen = False

    def enter(self) -> None:
        with self._cv:
            while self._frozen:
                self._cv.wait()
            self._writers += 1

    def exit(self) -> None:
        with self._cv:
            self._writers -= 1
            self._cv.notify_all()

    def freeze(self) -> None:
        with self._cv:
            self._frozen = True
            while self._writers:
                self._cv.wait()

    def thaw(self) -> None:
        with self._cv:
            self._frozen = False
            self._cv.notify_all()


class SchemaMigrator:
    """One live S -> S' transition over one :class:`~..engine.Engine`.

    ``hold_at_dual=True`` parks the migration in the dual window (new
    graph caught up, lag tracked) until :meth:`request_cut` — the
    coordinated-cut hook so every shard group flips in the same step.
    ``batch`` bounds each backfill write (one journaled TOUCH batch = one
    suppressed watch revision).

    Beside :meth:`status` (the reference's fields), ``timeline`` holds the
    ``time.perf_counter()`` at which each phase was first entered (and
    ``freeze``, when the cut asked writers to stop), ``compile_seconds``
    the last dual compile's wall time and ``cut_split`` the cut's freeze
    split in seconds: ``drain`` (freeze + final catch-up),
    ``oracle_old`` / ``oracle_new`` (the parity probe's two host oracle
    builds), ``probe`` (its sampled checks), ``persist`` (the CUT record)
    and ``swap`` (serving S' under the engine lock, cache retirement
    included).
    """

    def __init__(self, engine, schema_text: str,
                 record_path: Optional[str] = None,
                 batch: int = 512,
                 hold_at_dual: bool = False,
                 parity_samples: int = 64,
                 backfill_pause: float = 0.0):
        self.engine = engine
        self.schema_text = schema_text
        self.record_path = record_path
        self.batch = max(1, int(batch))
        self.hold_at_dual = bool(hold_at_dual)
        self.parity_samples = max(0, int(parity_samples))
        # optional inter-batch pause: keeps backfill strictly below
        # serving traffic even without an admission queue in front
        self.backfill_pause = float(backfill_pause)
        self._lock = threading.Lock()
        self._cut_requested = threading.Event()
        self._abort_requested = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._phase = PLANNED
        self._error: Optional[str] = None
        self._classification: Optional[str] = None
        self._reasons: tuple = ()
        self._affected: frozenset = frozenset()
        self._backfilled = 0
        self._suppressed: list[int] = []
        self._lag = 0
        self._started = time.time()
        self._cut_at: Optional[float] = None
        self._done_at: Optional[float] = None
        self._freeze_seconds = 0.0
        self._to_digest = schema_digest(schema_text)
        self._from_digest: Optional[str] = None
        self._new_schema: Optional[Schema] = None
        self._diff = None
        self._new_cg = None
        self._gate: Optional[_WriteGate] = None
        self.timeline: dict = {}
        self.compile_seconds = 0.0
        self.cut_split: dict = {}

    # -- public surface ------------------------------------------------------

    @property
    def active(self) -> bool:
        return self._phase not in (DONE, ABORTED, FAILED)

    def start(self) -> None:
        """Plan synchronously (so incompatible schemas refuse on the
        caller's stack, before any state changes), then run the
        compile/backfill/dual/cut pipeline on a background thread."""
        self._plan()
        t = threading.Thread(target=self._run, name="schema-migrator",
                             daemon=True)
        self._thread = t
        t.start()

    def join(self, timeout: Optional[float] = None) -> None:
        t = self._thread
        if t is not None:
            t.join(timeout)

    def request_cut(self) -> None:
        self._cut_requested.set()

    def abort(self) -> dict:
        """Refuse once the cut persisted (the transition is one-way past
        that point); before it, stop the worker and clear the record — the
        serving schema never changed, and backfill touches were idempotent
        re-writes."""
        with self._lock:
            if _PHASE_NUM.get(self._phase, 0) >= _PHASE_NUM[CUT] \
                    and self._phase != FAILED:
                from ..engine.store import StoreError

                raise StoreError(
                    f"cannot abort: migration already {self._phase}")
            self._abort_requested.set()
            self._cut_requested.set()  # unpark a dual hold
        self.join(timeout=30.0)
        with self._lock:
            if self._phase not in (DONE, ABORTED, FAILED):
                self._finish(ABORTED, "operator abort")
        return self.status()

    def status(self) -> dict:
        with self._lock:
            ttc = None
            if self._cut_at is not None:
                ttc = round((self._cut_at - self._started) * 1e3, 3)
            return {
                "active": self.active,
                "phase": self._phase,
                "classification": self._classification,
                "to_digest": self._to_digest,
                "from_digest": self._from_digest,
                "reasons": list(self._reasons),
                "affected": len(self._affected),
                "backfilled": self._backfilled,
                "suppressed": len(self._suppressed),
                "lag": self._lag,
                "started": self._started,
                "time_to_cut_ms": ttc,
                "freeze_ms": round(self._freeze_seconds * 1e3, 3),
                "error": self._error,
            }

    # -- phase machine -------------------------------------------------------

    def _set_phase(self, phase: str) -> None:
        self.timeline.setdefault(phase, time.perf_counter())
        with self._lock:
            self._phase = phase
        metrics.gauge("engine_migration_phase").set(
            _PHASE_NUM.get(phase, -1))
        self._persist()
        log.info("migration %s -> %s", self._to_digest, phase)

    def _persist(self) -> None:
        if not self.record_path:
            return
        with self._lock:
            doc = {
                "phase": self._phase,
                "to_digest": self._to_digest,
                "from_digest": self._from_digest,
                "to_text": self.schema_text,
                "classification": self._classification,
                "suppressed_revisions": list(self._suppressed),
                "backfilled": self._backfilled,
                "affected": sorted(list(p) for p in self._affected),
                "started": self._started,
                "updated": time.time(),
            }
        _atomic_write_json(self.record_path, doc)

    def _clear_record(self) -> None:
        if self.record_path:
            try:
                os.remove(self.record_path)
            except FileNotFoundError:
                pass

    def _finish(self, phase: str, error: Optional[str] = None) -> None:
        self.timeline.setdefault(phase, time.perf_counter())
        with self._lock:
            self._phase = phase
            self._error = error
            self._done_at = time.time()
        metrics.gauge("engine_migration_phase").set(
            _PHASE_NUM.get(phase, -1))
        metrics.gauge("engine_migration_lag").set(0)
        # the new graph is either serving now or never will: drop the
        # migrator's own reference to it, and an abort's idle write gate
        # (the reference leaves it installed)
        self._new_cg = None
        gate = self._gate
        if gate is not None and self.engine._write_gate is gate:
            self.engine._write_gate = None
        if phase == DONE:
            metrics.counter("engine_migrations_total",
                            outcome="done").inc()
            self._persist()  # the done marker (stale-flag rule)
        else:
            metrics.counter("engine_migrations_total",
                            outcome=phase).inc()
            self._clear_record()

    # -- planning (synchronous: typed refusal before any state change) ------

    def _plan(self) -> None:
        e = self.engine
        new_schema = parse_schema(self.schema_text)  # SchemaError -> caller
        # raises IncompatibleSchemaChange before ANY state changes
        diff = require_compatible(e.schema, new_schema)
        from ..models.schema import ir_digest

        with self._lock:
            self._new_schema = new_schema
            self._diff = diff
            self._classification = diff.classification
            self._reasons = diff.reasons
            self._affected = diff.affected
            self._from_digest = ir_digest(e.schema)
            self._to_digest = ir_digest(new_schema)
        if diff.classification == REWRITING:
            # tuple-level compatibility: every stored tuple on a
            # rewriting relation must re-validate under S' — an invalid
            # one (e.g. S' now REQUIRES a caveat the tuple lacks) refuses
            # the whole migration up front, before the record is written
            # or a single byte moves
            self._validate_affected_tuples(new_schema, diff)
        self._set_phase(PLANNED)

    def _validate_affected_tuples(self, new_schema, diff) -> None:
        from ..engine.engine import SchemaViolation, validate_relationship
        from ..engine.store import RelationshipFilter

        for dname, rname in sorted(diff.rewrite_relations):
            for rel in self.engine.read_relationships(
                    RelationshipFilter(resource_type=dname,
                                       relation=rname)):
                try:
                    validate_relationship(new_schema, rel)
                except (SchemaError, SchemaViolation) as err:
                    from ..models.schema import IncompatibleSchemaChange

                    raise IncompatibleSchemaChange((
                        f"stored tuple {rel} does not validate under "
                        f"the new schema: {err}",)) from None

    # -- the worker ----------------------------------------------------------

    def _run(self) -> None:
        try:
            self._compile()
            if self._abort_requested.is_set():
                self._finish(ABORTED, "operator abort")
                return
            if self._diff.classification == REWRITING:
                self._backfill()
            if self._abort_requested.is_set():
                self._finish(ABORTED, "operator abort")
                return
            self._dual()
            if self._abort_requested.is_set():
                self._finish(ABORTED, "operator abort")
                return
            self._cut()
            self._finish(DONE)
        except BaseException as err:  # noqa: BLE001 - worker boundary:
            # the failure is disposed into status()/metrics and the
            # record is cleared so boot aborts cleanly, never resumes a
            # half-state; re-raising would kill a daemon thread silently
            log.exception("schema migration failed")
            self._finish(FAILED, f"{type(err).__name__}: {err}")

    def _compile(self) -> None:
        """Dual-compile: S''s graph beside the serving one, off the engine
        lock, through the engine's own compile (its device, overlay
        capacity and tier budget), so a CPU engine migrates on the CPU and
        a tiered engine serves a tiered graph after the cut."""
        self._set_phase(COMPILING)
        t0 = time.perf_counter()
        self._new_cg = self.engine._compile_fresh(schema=self._new_schema)
        self.compile_seconds = time.perf_counter() - t0
        metrics.histogram("engine_migration_compile_seconds").observe(
            self.compile_seconds)

    def _backfill(self) -> None:
        """Journaled backfill: TOUCH every tuple on a rewriting relation
        back through the ordinary write path — the WAL and the watch log
        see the re-derivation, so a crash at any point replays or aborts
        from durable state. Echo revisions are recorded and suppressed
        from watch streams (identical content: delivering it would
        duplicate events across the cut)."""
        self._set_phase(BACKFILL)
        e = self.engine
        from ..engine.store import RelationshipFilter, WriteOp

        for dname, rname in sorted(self._diff.rewrite_relations):
            rels = list(e.read_relationships(
                RelationshipFilter(resource_type=dname, relation=rname)))
            # bulk-loaded graphs can hold duplicate rows for one
            # relationship key; a TOUCH batch must carry each key once
            # (the store's atomic write plan rejects duplicate updates
            # within a single write, latest row wins here)
            uniq: dict = {}
            for r in rels:
                uniq[(r.resource_type, r.resource_id, r.relation,
                      r.subject_type, r.subject_id,
                      r.subject_relation or "")] = r
            rels = list(uniq.values())
            for s in range(0, len(rels), self.batch):
                if self._abort_requested.is_set():
                    return
                part = rels[s:s + self.batch]
                # arm the watch filter BEFORE any watcher can read the
                # echo: the store logs it inside the write, and a watch
                # read that fetched it waits on the echo lock until it is
                # armed
                with e._echo_lock:
                    rev = self._write_backfill_batch(
                        [WriteOp("touch", r) for r in part])
                    e._watch_suppress = e._watch_suppress | {rev}
                with self._lock:
                    self._backfilled += len(part)
                    self._suppressed.append(rev)
                metrics.counter(
                    "engine_migration_backfill_rows_total").inc(len(part))
                self._persist()
                if self.backfill_pause:
                    time.sleep(self.backfill_pause)

    def _write_backfill_batch(self, ops) -> int:
        """One journaled batch, shed-aware: overlay backpressure from the
        compactor is obeyed (bounded retry) — backfill rides BELOW serving
        traffic."""
        e = self.engine
        from ..engine.compaction import OverlayBackpressure

        for attempt in range(8):
            try:
                return e.write_relationships(list(ops))
            except OverlayBackpressure as bp:
                time.sleep(min(getattr(bp, "retry_after", 0.05) or 0.05,
                               0.5))
        return e.write_relationships(list(ops), _headroom=False)

    def _catch_up_once(self) -> int:
        """Replay watch-log records onto the new graph (the dual-apply:
        writes land in the store once, and BOTH graphs see them — the
        serving graph via the engine's own incremental path, the new one
        here, on its host state: its device state does not exist before
        the first query after the cut). Falls back to a fresh compile when
        the suffix cannot be replayed (trimmed history, bulk load,
        overflow). Returns lag."""
        e = self.engine
        from ..engine.store import OP_DELETE, StoreError
        from ..ops.reachability import MAX_DELTA_RECORDS, incremental_update

        cg = self._new_cg
        st = e.store
        with st._lock:
            rev = st.revision
            if cg.revision == rev:
                return 0
            records = None
            if cg.revision >= st.unlogged_revision:
                try:
                    records = st.watch_since(cg.revision)
                except StoreError:
                    records = None
        if records is None or len(records) > MAX_DELTA_RECORDS:
            self._compile()  # refold from a newer snapshot
            return max(e.store.revision - self._new_cg.revision, 0)
        if records:
            delta = [(r.op == OP_DELETE, r.rel) for r in records]
            new = incremental_update(cg, delta, rev, st)
            if new is None:
                self._compile()
            else:
                self._new_cg = new
        return max(e.store.revision - self._new_cg.revision, 0)

    def _dual(self) -> None:
        """The dual window: keep the new graph within one overlay append
        of the store while serving continues on the old one. Holds here
        when ``hold_at_dual`` until the coordinator releases the cut."""
        self._set_phase(DUAL)
        e = self.engine
        # install the cutover gate now: entering/exiting an unfrozen gate
        # is two condition-variable ops per write, and having it in place
        # means the cut never races a writer that read `None` just before
        # the freeze
        self._gate = _WriteGate()
        e._write_gate = self._gate
        while True:
            lag = self._catch_up_once()
            with self._lock:
                self._lag = lag
            metrics.gauge("engine_migration_lag").set(lag)
            if self._abort_requested.is_set():
                return
            if lag == 0 and (not self.hold_at_dual
                             or self._cut_requested.is_set()):
                return
            if lag == 0:
                # parked at dual: stay caught up at a gentle cadence
                self._cut_requested.wait(0.05)
            # lag > 0: immediately loop and keep replaying

    def _cut(self) -> None:
        """Cutover: freeze writers, drain to lag zero, machine-check
        unaffected-verdict parity, persist CUT (before the routing effect
        — the crash-matrix pivot), serve S' and its graph at the UNCHANGED
        revision, surgically retire affected cache keys, thaw."""
        e = self.engine
        gate = self._gate
        split = self.cut_split = {}
        t0 = self.timeline["freeze"] = time.perf_counter()
        gate.freeze()
        try:
            lag = self._catch_up_once()
            if lag != 0:  # unreachable while frozen; belt and braces
                raise RuntimeError(f"cut drain left lag {lag}")
            split["drain"] = time.perf_counter() - t0
            self._check_unaffected_parity()
            t1 = time.perf_counter()
            self._set_phase(CUT)
            with self._lock:
                self._cut_at = time.time()
            t2 = time.perf_counter()
            split["persist"] = t2 - t1
            with e._lock:
                e._install_schema(self._new_schema, self._new_cg,
                                  self._affected)
                # the mesh view of the old schema's graph goes with it
                e._sharded = None
            split["swap"] = time.perf_counter() - t2
        finally:
            gate.thaw()
            e._write_gate = None
            self._freeze_seconds = time.perf_counter() - t0
            metrics.histogram(
                "engine_migration_cut_freeze_seconds").observe(
                self._freeze_seconds)

    def _check_unaffected_parity(self) -> None:
        """The no-verdict-flap machine check, run INSIDE the freeze so
        both oracles see the identical frozen store: sample permissions
        OUTSIDE the diff's affected closure and require S and S' to agree
        on every sampled (resource, subject) verdict. A mismatch means the
        diff classifier under-approximated — fail the cut rather than flap
        verdicts the classifier promised were untouched."""
        split = self.cut_split
        if not self.parity_samples:
            return
        e = self.engine
        old_schema = e.schema
        new_schema = self._new_schema
        affected = self._affected
        probes = []
        for dname in sorted(new_schema.definitions):
            d = new_schema.definitions[dname]
            if dname not in old_schema.definitions:
                continue
            for pname in sorted(d.permissions):
                if (dname, pname) in affected:
                    continue
                if pname not in old_schema.definitions[dname].permissions:
                    continue
                probes.append((dname, pname))
        if not probes:
            return
        snap_now = time.time()
        t0 = time.perf_counter()
        old_oracle = e.oracle(now=snap_now)
        t1 = time.perf_counter()
        split["oracle_old"] = t1 - t0
        from ..engine.evaluator import OracleEvaluator

        new_oracle = OracleEvaluator(new_schema, e.store.snapshot(),
                                     now=snap_now)
        t2 = time.perf_counter()
        split["oracle_new"] = t2 - t1
        try:
            self._probe(probes, old_oracle, new_oracle)
        finally:
            split["probe"] = time.perf_counter() - t2

    def _probe(self, probes, old_oracle, new_oracle) -> None:
        # deterministic sample: first ids per type from the oracle's own
        # object universe, subjects from the densest subject type
        checked = 0
        for dname, pname in probes:
            rids = sorted(old_oracle.objects.get(dname, ()))[:4]
            subs = []
            for (rt, _rid, _rl), edges in old_oracle.adj.items():
                for st, sid, srl, _cav in edges:
                    if srl is None and sid != "*":
                        subs.append((st, sid))
                if len(subs) >= 4:
                    break
            for rid in rids:
                for st, sid in subs[:4]:
                    a = old_oracle.check(dname, rid, pname, st, sid)
                    b = new_oracle.check(dname, rid, pname, st, sid)
                    if a != b:
                        raise RuntimeError(
                            "unaffected-verdict parity violation at "
                            f"{dname}:{rid}#{pname}@{st}:{sid}: "
                            f"{a} under S vs {b} under S'")
                    checked += 1
                    if checked >= self.parity_samples:
                        return


# ---------------------------------------------------------------------------
# boot-time crash matrix
# ---------------------------------------------------------------------------


def recover(engine, record_path: Optional[str]) -> Optional[dict]:
    """Consult the persisted migration record and resolve it:

    ==================  =====================================================
    persisted phase     action
    ==================  =====================================================
    planned..dual       ABORT: the serving schema never changed; backfill
                        touches were idempotent re-writes of identical
                        content. Re-arm the watch-echo suppression set
                        (those revisions are in the replayed log), then
                        clear the record.
    cut                 RESUME: the cut was persisted before the swap took
                        routing effect — finish it by re-publishing S'
                        (schema + fresh compile at the recovered store),
                        then mark done.
    done                RE-APPLY: the done marker outlives the cut so a
                        boot whose bootstrap still carries S keeps serving
                        S'; cleared only when the booted schema already
                        matches.
    ==================  =====================================================
    """
    if not record_path or not os.path.exists(record_path):
        return None
    try:
        with open(record_path, encoding="utf-8") as f:
            doc = json.load(f)
    except (OSError, ValueError) as err:
        # an unreadable record is treated as phase<cut: fail toward the
        # schema the engine actually booted with, never guess a cut
        log.warning("unreadable migration record %s: %s", record_path,
                    err)
        os.replace(record_path, record_path + ".corrupt")
        return {"action": "aborted", "phase": None,
                "error": f"unreadable record: {err}"}
    phase = doc.get("phase")
    suppressed = frozenset(int(r) for r in
                           doc.get("suppressed_revisions", ()))
    if suppressed:
        engine._watch_suppress = engine._watch_suppress | suppressed
    if _PHASE_NUM.get(phase, 0) < _PHASE_NUM[CUT]:
        try:
            os.remove(record_path)
        except FileNotFoundError:
            pass
        metrics.counter("engine_migrations_total",
                        outcome="boot-aborted").inc()
        log.info("migration %s aborted at boot (crashed in %s)",
                 doc.get("to_digest"), phase)
        return {"action": "aborted", "phase": phase,
                "to_digest": doc.get("to_digest")}
    # cut or done: S' is the truth — finish/re-apply it
    from ..models.schema import ir_digest

    new_schema = parse_schema(doc["to_text"])
    if phase == DONE and ir_digest(engine.schema) == ir_digest(new_schema):
        # the bootstrap caught up: the marker has done its job
        try:
            os.remove(record_path)
        except FileNotFoundError:
            pass
        return {"action": "cleared", "phase": phase,
                "to_digest": doc.get("to_digest")}
    with engine._lock:
        # no graph handed over: the next read compiles under S'
        engine._install_schema(new_schema, None)
        engine._sharded = None
    if phase != DONE:
        doc["phase"] = DONE
        doc["updated"] = time.time()
        _atomic_write_json(record_path, doc)
    metrics.counter("engine_migrations_total",
                    outcome="boot-resumed").inc()
    log.info("migration %s resumed at boot (persisted phase %s)",
             doc.get("to_digest"), phase)
    return {"action": "resumed", "phase": phase,
            "to_digest": doc.get("to_digest")}
