"""Deterministic, durable workflow runner over a SQLite event log.

The durability contract of the reference's go-workflows engine
(the Go proxy's pkg/authz/distributedtx/client.go:32-62): every activity
result is event-sourced; a crash mid-workflow leaves the instance
incomplete, and a restarted worker replays the recorded events through the
workflow code (which must be deterministic) and continues from the first
unrecorded step. Activities therefore run at-least-once — exactly-once
effects come from idempotency keys (activity.py), like the reference
(activity.go:49-76).

Workflows are generator functions::

    def my_workflow(ctx, input):
        result = yield ctx.call("activity_name", arg1=..., arg2=...)
        yield ctx.sleep(0.1)
        return {"done": result}

Activity errors are re-raised into the generator as ActivityError so
workflow code can implement retry/rollback (the reference's pattern). A
WorkflowCrash escaping an activity abandons the instance without recording
— simulating a process kill at a side-effect edge (the failpoint e2e
matrix, reference proxy_test.go:650-860).
"""

from __future__ import annotations

import asyncio
import json
import sqlite3
import threading
import time
import uuid
from dataclasses import dataclass
from typing import Any, Callable, Optional

from ..utils.failpoints import FailPointError


class WorkflowTimeout(TimeoutError):
    pass


class WorkflowCrash(RuntimeError):
    """Simulated process death: abandon the instance (no event recorded)."""


class ActivityError(RuntimeError):
    def __init__(self, message: str):
        super().__init__(message)
        self.message = message


@dataclass
class _Call:
    kind: str  # "call" | "sleep"
    name: str
    args: dict


class WorkflowContext:
    def __init__(self, instance_id: str):
        self.instance_id = instance_id

    def call(self, name: str, **args) -> _Call:
        return _Call("call", name, args)

    def sleep(self, seconds: float) -> _Call:
        return _Call("sleep", "", {"seconds": seconds})


class WorkflowEngine:
    """Client + worker in one process (the reference's monoprocess backend,
    client.go:39)."""

    def __init__(self, db_path: str = ":memory:",
                 activities: Optional[dict[str, Callable]] = None,
                 workflows: Optional[dict[str, Callable]] = None):
        self.db_path = db_path
        self.activities = dict(activities or {})
        self.workflows = dict(workflows or {})
        self._db = sqlite3.connect(db_path, check_same_thread=False)
        self._db_lock = threading.Lock()
        self._done_events: dict[str, asyncio.Event] = {}
        self._tasks: set[asyncio.Task] = set()
        with self._db_lock:
            self._db.executescript("""
                CREATE TABLE IF NOT EXISTS instances (
                    id TEXT PRIMARY KEY,
                    workflow TEXT NOT NULL,
                    input TEXT NOT NULL,
                    status TEXT NOT NULL,
                    result TEXT,
                    error TEXT,
                    created REAL NOT NULL
                );
                CREATE TABLE IF NOT EXISTS events (
                    instance_id TEXT NOT NULL,
                    seq INTEGER NOT NULL,
                    kind TEXT NOT NULL,
                    name TEXT NOT NULL,
                    result TEXT,
                    error TEXT,
                    PRIMARY KEY (instance_id, seq)
                );
            """)
            self._db.commit()

    def register_activity(self, name: str, fn: Callable) -> None:
        self.activities[name] = fn

    def register_workflow(self, name: str, fn: Callable) -> None:
        self.workflows[name] = fn

    # -- client API ---------------------------------------------------------

    async def create_instance(self, workflow: str, input: Any,
                              instance_id: Optional[str] = None) -> str:
        if workflow not in self.workflows:
            raise KeyError(f"unknown workflow {workflow!r}")
        iid = instance_id or uuid.uuid4().hex
        # sqlite commit fsyncs when db_path is a real file (<data-dir>/
        # dtx.sqlite): keep it off the event loop, or every in-flight
        # request stalls behind this write's disk latency while
        # _db_lock is held (check_same_thread=False + _db_lock make the
        # connection safe to drive from a worker thread)
        await asyncio.to_thread(self._insert_instance, iid, workflow,
                                input)
        self._spawn(iid)
        return iid

    def _insert_instance(self, iid: str, workflow: str,
                         input: Any) -> None:
        with self._db_lock:
            self._db.execute(
                "INSERT INTO instances (id, workflow, input, status, created) "
                "VALUES (?, ?, ?, 'running', ?)",
                (iid, workflow, json.dumps(input), time.time()),
            )
            self._db.commit()

    async def get_result(self, instance_id: str, timeout: float = 30.0) -> Any:
        """Wait for completion (reference dualWrite waits ≤30s,
        update.go:146-195 / workflow.go:31)."""
        ev = self._done_events.setdefault(instance_id, asyncio.Event())
        row = await asyncio.to_thread(self._instance_row, instance_id)
        if row is None:
            raise KeyError(f"unknown workflow instance {instance_id}")
        if row["status"] in ("completed", "failed"):
            return self._result_of(row)
        try:
            await asyncio.wait_for(ev.wait(), timeout)
        except asyncio.TimeoutError:
            raise WorkflowTimeout(
                f"workflow {instance_id} did not complete in {timeout}s"
            ) from None
        finally:
            # bound _done_events: the result lives in the DB from here on
            self._done_events.pop(instance_id, None)
        return self._result_of(
            await asyncio.to_thread(self._instance_row, instance_id))

    async def resume_pending(self) -> list[str]:
        """Start every incomplete instance (crash recovery on boot)."""
        def select_running():
            with self._db_lock:
                return self._db.execute(
                    "SELECT id FROM instances WHERE status = 'running'"
                ).fetchall()
        rows = await asyncio.to_thread(select_running)
        ids = [r[0] for r in rows]
        for iid in ids:
            self._spawn(iid)
        return ids

    def pending_count(self) -> int:
        with self._db_lock:
            (n,) = self._db.execute(
                "SELECT COUNT(*) FROM instances WHERE status = 'running'"
            ).fetchone()
        return int(n)

    async def shutdown(self) -> None:
        for t in list(self._tasks):
            t.cancel()
        for t in list(self._tasks):
            try:
                await t
            except (asyncio.CancelledError, Exception):
                pass

        # close under _db_lock on a worker thread: client coroutines
        # (create_instance/get_result) run their DB ops via
        # asyncio.to_thread and are not in self._tasks — closing
        # unlocked could interleave mid-execute on the shared connection
        def close_db():
            with self._db_lock:
                self._db.close()
        await asyncio.to_thread(close_db)

    # -- internals ----------------------------------------------------------

    def _instance_row(self, iid: str) -> Optional[dict]:
        with self._db_lock:
            row = self._db.execute(
                "SELECT id, workflow, input, status, result, error "
                "FROM instances WHERE id = ?", (iid,)
            ).fetchone()
        if row is None:
            return None
        return dict(zip(("id", "workflow", "input", "status", "result",
                         "error"), row))

    @staticmethod
    def _result_of(row: dict) -> Any:
        if row["status"] == "failed":
            raise ActivityError(row["error"] or "workflow failed")
        return json.loads(row["result"]) if row["result"] else None

    def _spawn(self, iid: str) -> None:
        task = asyncio.get_running_loop().create_task(self._run_instance(iid))
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)

    def _events_for(self, iid: str) -> list[dict]:
        with self._db_lock:
            rows = self._db.execute(
                "SELECT seq, kind, name, result, error FROM events "
                "WHERE instance_id = ? ORDER BY seq", (iid,)
            ).fetchall()
        return [dict(zip(("seq", "kind", "name", "result", "error"), r))
                for r in rows]

    def _record_event(self, iid: str, seq: int, call: _Call,
                      result: Any = None, error: Optional[str] = None) -> None:
        with self._db_lock:
            self._db.execute(
                "INSERT INTO events (instance_id, seq, kind, name, result, error) "
                "VALUES (?, ?, ?, ?, ?, ?)",
                (iid, seq, call.kind, call.name,
                 json.dumps(result) if error is None else None, error),
            )
            self._db.commit()

    def _finish_db(self, iid: str, result: Any = None,
                   error: Optional[str] = None) -> None:
        with self._db_lock:
            self._db.execute(
                "UPDATE instances SET status = ?, result = ?, error = ? "
                "WHERE id = ?",
                ("failed" if error is not None else "completed",
                 json.dumps(result) if error is None else None, error, iid),
            )
            self._db.commit()

    async def _finish(self, iid: str, result: Any = None,
                      error: Optional[str] = None) -> None:
        # DB commit off-loop; the asyncio.Event is NOT thread-safe, so
        # signal waiters back on the loop after the write is durable
        await asyncio.to_thread(self._finish_db, iid, result, error)
        ev = self._done_events.setdefault(iid, asyncio.Event())
        ev.set()
        # waiters hold their own reference; drop ours so fire-and-forget
        # instances don't leak one Event each
        self._done_events.pop(iid, None)

    async def _run_instance(self, iid: str) -> None:
        # every event-log read/append goes through asyncio.to_thread:
        # sqlite commits fsync on real files, and a loop-side commit
        # under _db_lock would stall every concurrent request/workflow
        row = await asyncio.to_thread(self._instance_row, iid)
        if row is None or row["status"] != "running":
            return
        wf = self.workflows[row["workflow"]]
        ctx = WorkflowContext(iid)
        gen = wf(ctx, json.loads(row["input"]))
        events = await asyncio.to_thread(self._events_for, iid)
        seq = 0
        to_send: Any = None
        to_throw: Optional[BaseException] = None
        try:
            while True:
                try:
                    if to_throw is not None:
                        call = gen.throw(to_throw)
                        to_throw = None
                    else:
                        call = gen.send(to_send)
                except StopIteration as stop:
                    await self._finish(iid, result=stop.value)
                    return
                if not isinstance(call, _Call):
                    raise RuntimeError(
                        f"workflow yielded {type(call).__name__}, expected "
                        "ctx.call()/ctx.sleep()")
                if seq < len(events):
                    ev = events[seq]
                    if ev["kind"] != call.kind or ev["name"] != call.name:
                        raise RuntimeError(
                            f"non-deterministic workflow replay at seq {seq}: "
                            f"recorded {ev['kind']}:{ev['name']}, "
                            f"replayed {call.kind}:{call.name}")
                    if ev["error"] is not None:
                        to_send, to_throw = None, ActivityError(ev["error"])
                    else:
                        to_send = json.loads(ev["result"]) if ev["result"] else None
                    seq += 1
                    continue
                # live execution
                if call.kind == "sleep":
                    await asyncio.sleep(call.args["seconds"])
                    await asyncio.to_thread(self._record_event, iid, seq,
                                            call)
                    to_send = None
                    seq += 1
                    continue
                fn = self.activities.get(call.name)
                if fn is None:
                    raise RuntimeError(f"unknown activity {call.name!r}")
                try:
                    # activities do blocking I/O (engine sockets for a
                    # remote tcp:// engine, kube HTTP) — keep them off the
                    # event loop so concurrent workflows/requests proceed
                    out = await asyncio.to_thread(fn, ctx, **call.args)
                    if asyncio.iscoroutine(out):
                        out = await out
                except (WorkflowCrash, FailPointError):
                    # simulated process death (armed failpoint at a
                    # side-effect edge): nothing recorded; the instance
                    # stays 'running' for resume_pending()
                    return
                except asyncio.CancelledError:
                    raise
                except Exception as e:  # noqa: BLE001 - activity boundary
                    await asyncio.to_thread(self._record_event, iid, seq,
                                            call, None, str(e))
                    to_send, to_throw = None, ActivityError(str(e))
                    seq += 1
                    continue
                await asyncio.to_thread(self._record_event, iid, seq,
                                        call, out)
                to_send = out
                seq += 1
        except asyncio.CancelledError:
            raise
        except Exception as e:  # workflow-level failure
            await self._finish(iid, error=f"{type(e).__name__}: {e}")
