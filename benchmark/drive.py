"""The closed loop: ``depth`` requests kept in flight from one thread.

The driver submits each request through the program's asynchronous entry
(a call that returns a future), keeps ``depth`` of them outstanding, and
whenever the ``burst`` oldest have answered it submits ``burst`` more,
back to back, as a wave of clients relisting together would. One thread
offers all the load, so the load generator takes no share of the
interpreter from the program's own threads (the batcher's timer, the
compactor) beyond what its requests cost.

A request's latency runs from its submit to the moment its answer was
read back, so it counts the wait behind the requests ahead of it. The
window's rate counts the requests answered by its close. Requests still
outstanding at the close are answered after it (up to ``DRAIN_S``) and
checked all the same; one that never answers keeps ``t_end`` None.
An answer is kept as ``keep(answer)`` when ``keep`` is given: a compact
form that loses nothing the check reads, so that a window's answers do
not pile up in memory the program would otherwise reuse.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Optional

DRAIN_S = 60.0


@dataclass
class Request:
    key: Any
    t_start: float = 0.0
    t_end: Optional[float] = None
    output: Any = None
    error: Optional[str] = None
    future: Any = None

    def latency(self) -> float:
        """Submit to answered, in seconds; inf when it never answered."""
        if self.t_end is None or self.error is not None:
            return float("inf")
        return self.t_end - self.t_start


def _answer(r: Request, keep: Optional[Callable[[Any], Any]]) -> None:
    try:
        r.output = r.future.result()
        if keep is not None:
            r.output = keep(r.output)
    except Exception as e:  # noqa: BLE001 - a failed request
        r.error = f"{type(e).__name__}: {e}"
    r.t_end = time.perf_counter()
    r.future = None


def _submit(r: Request, send: Callable[[], Any]) -> None:
    r.t_start = time.perf_counter()
    try:
        r.future = send()
    except Exception as e:  # noqa: BLE001 - refused at submit
        r.error = f"{type(e).__name__}: {e}"
        r.t_end = time.perf_counter()


def run(stream, depth: int, burst: int, seconds: float,
        on_start: Optional[Callable[[], None]] = None,
        on_close: Optional[Callable[[], None]] = None,
        keep: Optional[Callable[[Any], Any]] = None) -> tuple:
    """Offer the requests of ``stream`` (an iterator of ``(key, send)``,
    ``send()`` returning a future) for ``seconds``, ``depth`` in flight,
    refilled ``burst`` at a time. ``on_start`` runs just before the window
    opens and ``on_close`` as soon as it closes; ``keep`` compacts each
answer as it is read. Returns ``(requests, t0,
    t_close)``: every request sent, in order, and the window's open and
    close (``time.perf_counter``)."""
    reqs: list = []
    flight: deque = deque()

    def fill() -> None:
        while len(flight) < depth:
            key, send = next(stream)
            r = Request(key)
            reqs.append(r)
            _submit(r, send)
            if r.future is not None:
                flight.append(r)

    if on_start is not None:
        on_start()
    t0 = time.perf_counter()
    t_stop = t0 + seconds
    fill()
    while time.perf_counter() < t_stop:
        for _ in range(min(burst, len(flight))):
            _answer(flight.popleft(), keep)
        fill()
    t_close = time.perf_counter()
    if on_close is not None:
        on_close()
    rest = list(flight)

    def drain() -> None:
        for r in rest:
            _answer(r, keep)

    t = threading.Thread(target=drain, daemon=True, name="bench-drain")
    t.start()
    t.join(DRAIN_S)
    return reqs, t0, t_close
