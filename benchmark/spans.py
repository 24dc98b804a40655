"""The program's own spans in a traced run: the named ranges the port's
tracer (obs/trace.py) opens while the profiler records, reduced per name
to their count, total and self time, and the device's idle time during
which no program span is open on any thread.

A span's self time is its duration less what its child spans (program
spans nested in it on the same thread) cover. Device busy time is taken
as ``tracing.reduce`` takes it: every device activity that is not a
host range's mirror on the device (a user annotation, named like a host
operation).

``run.py`` hands the readers the record alone. The stopped profiler is
the one a calling frame holds (``run_cell``'s, while it calls the
readers), found by what it is, not by its name; the first reader to ask
reduces its events once, and the others of the same record reuse that.
"""

from __future__ import annotations

import sys
import time
from typing import Optional

# the program's span names (obs/trace.py's tracer on the list and check
# paths of the engine, ops/reachability.py and engine/batcher.py)
PROGRAM = ("engine.lookup", "engine.dispatch", "engine.result",
           "engine.batch_wait", "engine.check", "engine.encode_checks",
           "fixpoint", "caveat_vm", "host_sync")

# (the traced record's trace, its reduction): the readers of one record
# share one pass over the profiler's events
_last: tuple = (None, None)


def of(rec: dict) -> Optional[dict]:
    """The record's program-span reduction; None when the run was not
    traced or no calling frame holds a stopped profiler."""
    global _last
    trace = rec.get("trace")
    if not trace:
        return None
    if _last[0] is trace:
        return _last[1]
    prof = _stopped_profiler()
    if prof is None:
        print("program spans: no stopped profiler in a calling frame",
              file=sys.stderr)
        return None
    t0 = time.perf_counter()
    got = reduce(prof, trace["window_s"])
    print(f"program spans: reduced in {time.perf_counter() - t0:.1f} s",
          file=sys.stderr)
    _last = (trace, got)
    return got


def _stopped_profiler():
    """The nearest calling frame's local that holds a profiler's raw
    events (``kineto_results``), whatever its name."""
    f = sys._getframe(1)
    while f is not None:
        for v in f.f_locals.values():
            try:
                if hasattr(getattr(v, "profiler", None), "kineto_results"):
                    return v
            except Exception:  # noqa: BLE001 - an attribute that raises
                continue
        f = f.f_back
    return None


def reduce(prof, window_s: float) -> dict:
    """Reduce the stopped ``prof``'s raw events (see ``summarize``)."""
    from torch.autograd import DeviceType

    names = set(PROGRAM)
    host_names: set = set()
    spans, dev = [], []
    for ev in prof.profiler.kineto_results.events():
        kind = ev.device_type()
        if kind == DeviceType.CUDA:
            dev.append((ev.start_ns(), ev.duration_ns(), ev.name()))
        elif kind == DeviceType.CPU:
            nm = ev.name()
            host_names.add(nm)
            if nm in names:
                t = ev.start_ns()
                spans.append((t, t + ev.duration_ns(), nm,
                              ev.start_thread_id()))
    busy = [(t, t + d) for t, d, nm in dev if nm not in host_names]
    return summarize(spans, busy, window_s)


def summarize(spans: list, busy: list, window_s: float) -> dict:
    """``spans``: (start_ns, end_ns, name, thread) of the program's
    ranges; ``busy``: (start_ns, end_ns) of the device's activities.
    Returns ``{"spans": {name: [count, total_s, self_s]},
    "idle_outside_s", "window_s", "n_device"}``: the window less the
    time in which the device ran or a program span was open."""
    out: dict = {}
    by_thread: dict = {}
    for s in spans:
        by_thread.setdefault(s[3], []).append(s)
    for rows in by_thread.values():
        # the enclosing span first among equal starts
        rows.sort(key=lambda s: (s[0], -s[1]))
        cover = [0] * len(rows)
        stack: list = []
        for i, (lo, hi, _, _) in enumerate(rows):
            while stack and rows[stack[-1]][1] <= lo:
                stack.pop()
            if stack:
                p = stack[-1]
                cover[p] += max(0, min(hi, rows[p][1]) - lo)
            stack.append(i)
        for (lo, hi, nm, _), c in zip(rows, cover):
            got = out.setdefault(nm, [0, 0.0, 0.0])
            got[0] += 1
            got[1] += (hi - lo) * 1e-9
            got[2] += (hi - lo - c) * 1e-9
    either = _measure([(s[0], s[1]) for s in spans] + list(busy))
    return {"spans": out, "idle_outside_s": window_s - either * 1e-9,
            "window_s": window_s, "n_device": len(busy)}


def _measure(intervals: list) -> int:
    """ns covered by the union of (start, end) intervals."""
    total, end = 0, None
    for lo, hi in sorted(intervals):
        if end is None or lo > end:
            total += hi - lo
            end = hi
        elif hi > end:
            total += hi - end
            end = hi
    return total


def per_list_ms(rec: dict, seconds: Optional[float]) -> Optional[float]:
    """``seconds`` of the traced window as ms a list answered."""
    if seconds is None or rec["op"] != "list" or not rec["answers_all"]:
        return None
    return seconds * 1e3 / rec["answers_all"]
