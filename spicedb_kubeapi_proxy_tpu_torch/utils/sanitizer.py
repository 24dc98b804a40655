"""Opt-in runtime concurrency sanitizer.

The static passes in ``tools/analysis/`` see one function at a time;
this module watches the *composition* at runtime, lockdep-style, so a
run under it doubles as a race detector:

- **lock-order graph**: every ``threading.Lock``/``RLock`` created from
  package code is keyed by its creation site (its "lock class"). Each
  blocking acquire while other classes are held adds held→acquiring
  edges; an edge that closes a cycle is a deadlock-in-waiting
  (``lock-order-cycle``) even if this run never interleaved badly.
- **hold-time ceiling**: a release (or Condition wait) after holding a
  lock longer than ``PROXY_SANITIZE_HOLD_MS`` (default 2000) records
  ``hold-time`` — the static lock-discipline pass's runtime twin.
- **loop-thread blocking**: ``time.sleep`` called from *package code*
  on a thread with a running asyncio event loop records
  ``loop-blocking-call`` (a loop-side sleep stalls
  every in-flight request and heartbeat). A blocking lock acquire that
  actually contends on a loop thread records ``loop-lock-contention``
  (informational — brief on-loop probes are a design choice, e.g. the
  middleware's decision-cache probe).

The PyTorch port's copy of the JAX package's ``utils/sanitizer.py``,
scoped to the port's own package directory by caller frame (a frame of
the JAX package is not the port's code). Call :func:`install` before the
port's modules import, so every lock they create is wrapped
(tests/test_torch_sanitizer.py does so in a fresh interpreter);
``report()``/``reset()`` read and clear the global violation list.
Instrumentation is scoped at creation time: locks created from
stdlib/third-party frames get the raw primitive.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

_PKG_MARKER = os.sep + "spicedb_kubeapi_proxy_tpu_torch" + os.sep

# raw primitives captured at import, BEFORE install() swaps the
# factories — the sanitizer's own state must never instrument itself
_real_lock = threading.Lock
_real_rlock = threading.RLock
_real_sleep = time.sleep

HOLD_MS_ENV = "PROXY_SANITIZE_HOLD_MS"


@dataclass(frozen=True)
class Violation:
    kind: str       # lock-order-cycle | hold-time | loop-blocking-call
    #                 | loop-lock-contention
    detail: str
    site: str       # creation/call site "file:line"

    def render(self) -> str:
        return f"{self.kind}: {self.site} {self.detail}"


class _State:
    def __init__(self):
        self.mu = _real_lock()
        self.violations: List[Violation] = []
        self.edges: Dict[str, Set[str]] = {}       # class -> classes
        self.edge_seen: Set[Tuple[str, str]] = set()
        self.cycle_seen: Set[Tuple[str, str]] = set()
        self.hold_ms = float(os.environ.get(HOLD_MS_ENV, "2000"))
        self.tls = threading.local()
        self.record_all = False  # tests: attribute non-package frames too

    def held(self) -> list:
        st = getattr(self.tls, "stack", None)
        if st is None:
            st = self.tls.stack = []
        return st

    def record(self, kind: str, detail: str, site: str) -> None:
        with self.mu:
            self.violations.append(Violation(kind, detail, site))


_state = _State()
_installed = False


def _caller_site(depth: int = 2) -> Optional[str]:
    try:
        f = sys._getframe(depth)
    except ValueError:
        return None
    fn = f.f_code.co_filename
    if _PKG_MARKER not in fn and not _state.record_all:
        return None
    short = fn.split(_PKG_MARKER)[-1] if _PKG_MARKER in fn else fn
    return f"{short}:{f.f_lineno}"


def _on_loop_thread() -> bool:
    try:
        import asyncio
        return asyncio._get_running_loop() is not None
    except Exception:  # noqa: BLE001 - detection is best-effort
        return False


def _path_exists(graph: Dict[str, Set[str]], src: str, dst: str) -> bool:
    seen = set()
    stack = [src]
    while stack:
        n = stack.pop()
        if n == dst:
            return True
        if n in seen:
            continue
        seen.add(n)
        stack.extend(graph.get(n, ()))
    return False


class SanitizedLock:
    """Wrapper around a real Lock/RLock carrying a creation-site lock
    class. Exposes the full lock protocol; Condition integration
    (``_release_save``/``_acquire_restore``/``_is_owned``) is forwarded
    only when the inner primitive has it (RLock), with held-stack
    bookkeeping so a waiting Condition doesn't read as a held lock."""

    __slots__ = ("_inner", "_site", "_reentrant")

    def __init__(self, inner, site: str, reentrant: bool):
        self._inner = inner
        self._site = site
        self._reentrant = reentrant

    # -- core protocol ---------------------------------------------------

    def acquire(self, blocking: bool = True, timeout: float = -1):
        st = _state
        stack = st.held()
        me = id(self)
        already_held = any(e[0] == me for e in stack)
        ok = None
        if blocking and not already_held:
            self._note_edges(stack)
            if _on_loop_thread():
                if self._inner.acquire(False):
                    ok = True  # uncontended fast path: done
                else:
                    st.record(
                        "loop-lock-contention",
                        "blocking acquire contended on an event-loop "
                        "thread", self._site)
        if ok is None:
            ok = self._inner.acquire(blocking, timeout)
        if ok:
            stack.append((me, self._site, time.monotonic()))
        return ok

    def release(self):
        st = _state
        stack = st.held()
        me = id(self)
        for i in range(len(stack) - 1, -1, -1):
            if stack[i][0] == me:
                _, site, t0 = stack.pop(i)
                if not any(e[0] == me for e in stack):
                    held_ms = (time.monotonic() - t0) * 1000.0
                    if held_ms > st.hold_ms:
                        st.record(
                            "hold-time",
                            f"held {held_ms:.0f}ms "
                            f"(ceiling {st.hold_ms:.0f}ms)", site)
                break
        return self._inner.release()

    def _note_edges(self, stack) -> None:
        st = _state
        mine = self._site
        for _, held_site, _t in stack:
            if held_site == mine:
                continue
            key = (held_site, mine)
            cycle = False
            with st.mu:
                if key in st.edge_seen:
                    continue
                st.edge_seen.add(key)
                # closing edge held->mine: a path mine->...->held means
                # somewhere else the opposite order exists
                if _path_exists(st.edges, mine, held_site) \
                        and (mine, held_site) not in st.cycle_seen:
                    st.cycle_seen.add((mine, held_site))
                    cycle = True
                st.edges.setdefault(held_site, set()).add(mine)
            if cycle:  # record() retakes st.mu — must be outside it
                st.record(
                    "lock-order-cycle",
                    f"acquiring while holding {held_site} closes an "
                    f"order cycle (reverse path exists)", mine)

    def locked(self):
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __repr__(self):
        return f"<SanitizedLock {self._site} of {self._inner!r}>"

    # -- Condition (RLock) protocol — present only when inner has it ----

    def _pop_all(self):
        stack = _state.held()
        me = id(self)
        t0 = None
        for i in range(len(stack) - 1, -1, -1):
            if stack[i][0] == me:
                t0 = stack.pop(i)[2]
        return t0

    def __getattr__(self, name):
        # Condition probes _release_save/_acquire_restore/_is_owned via
        # getattr at __init__; forward them (with bookkeeping) only when
        # the inner lock really has them, so a plain Lock keeps raising
        # AttributeError and Condition uses its portable fallback
        if name == "_release_save":
            inner_rs = self._inner._release_save  # may raise

            def _release_save():
                t0 = self._pop_all()
                if t0 is not None:
                    held_ms = (time.monotonic() - t0) * 1000.0
                    if held_ms > _state.hold_ms:
                        _state.record(
                            "hold-time",
                            f"held {held_ms:.0f}ms at Condition.wait "
                            f"(ceiling {_state.hold_ms:.0f}ms)",
                            self._site)
                return inner_rs()
            return _release_save
        if name == "_acquire_restore":
            inner_ar = self._inner._acquire_restore  # may raise

            def _acquire_restore(state):
                out = inner_ar(state)
                _state.held().append(
                    (id(self), self._site, time.monotonic()))
                return out
            return _acquire_restore
        if name == "_is_owned":
            return self._inner._is_owned  # may raise
        return getattr(self._inner, name)


def _make_factory(real, reentrant: bool):
    def factory():
        site = _caller_site(2)
        inner = real()
        if site is None:
            return inner
        return SanitizedLock(inner, site, reentrant)
    return factory


def _sanitized_sleep(seconds):
    if seconds and seconds > 0.001 and _on_loop_thread():
        site = _caller_site(2)
        if site is not None:
            _state.record(
                "loop-blocking-call",
                f"time.sleep({seconds!r}) on an event-loop thread",
                site)
    return _real_sleep(seconds)


def install() -> None:
    """Swap the lock factories and time.sleep. Idempotent."""
    global _installed
    if _installed:
        return
    threading.Lock = _make_factory(_real_lock, False)
    threading.RLock = _make_factory(_real_rlock, True)
    time.sleep = _sanitized_sleep
    _installed = True


def uninstall() -> None:
    global _installed
    if not _installed:
        return
    threading.Lock = _real_lock
    threading.RLock = _real_rlock
    time.sleep = _real_sleep
    _installed = False


def installed() -> bool:
    return _installed


def report() -> List[Violation]:
    with _state.mu:
        return list(_state.violations)


def reset() -> None:
    """Clear violations AND the order graph (test isolation)."""
    with _state.mu:
        _state.violations.clear()
        _state.edges.clear()
        _state.edge_seen.clear()
        _state.cycle_seen.clear()


ENFORCED_KINDS = ("lock-order-cycle", "loop-blocking-call")


def enforced_violations() -> List[Violation]:
    """The kinds a CI run fails on; hold-time and loop contention are
    reported but advisory (CPU CI machines make wall-clock ceilings
    flaky, and brief on-loop probes are a documented design choice)."""
    return [v for v in report() if v.kind in ENFORCED_KINDS]
