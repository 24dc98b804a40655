"""The traced run's device records: a ``torch.profiler`` trace of the
measured window, reduced to what the per-layer readers read.

Device busy time is the union of the traced device intervals; the idle
share is 1 - busy / window, both from the same traced window. The host
ranges the readers name (RANGES) get the device time of the kernels
launched inside them; each kernel name its device time and count. An idle
gap on the device is named by the innermost host operation (on any
thread) that spans its middle.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np


def start_profiler(torch):
    """A started profiler of the host and the card over all threads."""
    from torch.profiler import ProfilerActivity, profile

    kw = {}
    try:
        from torch._C._profiler import _ExperimentalConfig

        kw["experimental_config"] = _ExperimentalConfig(
            profile_all_threads=True)
    except (ImportError, TypeError):
        pass  # ranges of other threads then go unseen: their readers too
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   **kw)
    prof.start()
    return prof


# host ranges whose device time the readers take
RANGES = ("caveat_vm", "aten::index_add_")


def reduce(prof, window_s: float) -> dict:
    """Reduce the events of the stopped ``prof``; ``window_s`` is the
    length of the window it traced. Reads the profiler's raw events: the
    event tree it builds for ``events()`` takes minutes over a window of
    a million events."""
    from torch.autograd import DeviceType

    t0 = time.perf_counter()
    evs = prof.profiler.kineto_results.events()
    dev, host = [], []
    for ev in evs:
        kind = ev.device_type()
        if kind == DeviceType.CUDA:
            dev.append((ev.start_ns(), ev.duration_ns(), ev.name(),
                        ev.linked_correlation_id()))
        elif kind == DeviceType.CPU:
            host.append((ev.start_ns(), ev.duration_ns(), ev.name(),
                         ev.start_thread_id(), ev.correlation_id()))
    # a host range's mirror on the device spans its kernels and the gaps
    # between them: it is no device activity of its own (no kernel, copy
    # or fill is named like a host operation)
    host_names = {h[2] for h in host}
    dev = [d for d in dev if d[2] not in host_names]
    out = {"window_s": window_s, "busy_s": 0.0, "kernels": {},
           "ranges": {}, "idle_gaps": [], "n_device": len(dev),
           "n_host": len(host)}
    if not dev:
        out["reduce_s"] = time.perf_counter() - t0
        return out
    lo = np.asarray([d[0] for d in dev], dtype=np.int64)
    dur = np.asarray([d[1] for d in dev], dtype=np.int64)
    hi = lo + dur
    kernels: dict = {}
    for (_, _, nm, _), d in zip(dev, dur.tolist()):
        n, s = kernels.get(nm, (0, 0.0))
        kernels[nm] = (n + 1, s + d * 1e-9)
    out["kernels"] = kernels
    out["ranges"] = _range_device_s(dev, dur, host)
    order = np.argsort(lo, kind="stable")
    lo, hi = lo[order], hi[order]
    end = np.maximum.accumulate(hi)
    # a new busy stretch starts where an interval begins past every
    # earlier end
    starts = np.concatenate([[True], lo[1:] > end[:-1]])
    s_lo = lo[starts]
    s_hi = np.concatenate([end[np.flatnonzero(starts)[1:] - 1], [end[-1]]])
    out["busy_s"] = float((s_hi - s_lo).sum()) * 1e-9
    out["idle_gaps"] = _name_gaps(s_hi[:-1], s_lo[1:], host)
    out["reduce_s"] = time.perf_counter() - t0
    return out


def _range_device_s(dev: list, dur: np.ndarray, host: list) -> dict:
    """For each name of RANGES: (ranges, device seconds of the kernels
    launched inside them). A kernel is linked to the host operation that
    launched it; it counts for a range when that operation began inside
    the range on the same thread."""
    if not host:
        return {}
    h_start = np.asarray([h[0] for h in host], dtype=np.int64)
    h_tid = np.asarray([h[3] for h in host], dtype=np.int64)
    h_corr = np.asarray([h[4] for h in host], dtype=np.int64)
    by_corr = np.argsort(h_corr, kind="stable")
    link = np.asarray([d[3] for d in dev], dtype=np.int64)
    pos = np.clip(np.searchsorted(h_corr[by_corr], link), 0,
                  len(host) - 1)
    op = by_corr[pos]
    ok = h_corr[op] == link
    k_start, k_tid, k_dur = h_start[op[ok]], h_tid[op[ok]], dur[ok]
    out = {}
    for name in RANGES:
        rows = [h for h in host if h[2] == name]
        if not rows:
            continue
        total = 0
        for tid in {h[3] for h in rows}:
            r = sorted((h[0], h[0] + h[1]) for h in rows if h[3] == tid)
            r_lo = np.asarray([x[0] for x in r], dtype=np.int64)
            r_hi = np.asarray([x[1] for x in r], dtype=np.int64)
            mine = k_tid == tid
            ks = k_start[mine]
            j = np.searchsorted(r_lo, ks, side="right") - 1
            inside = (j >= 0) & (ks <= r_hi[np.maximum(j, 0)])
            total += int(k_dur[mine][inside].sum())
        out[name] = (len(rows), total * 1e-9)
    return out


def _name_gaps(g_lo: np.ndarray, g_hi: np.ndarray, host: list) -> list:
    """[(name, seconds)] of the device's idle gaps, each named by the
    innermost host operation that spans its middle (on any thread),
    summed by name, longest first."""
    if not len(g_lo):
        return []
    length = g_hi - g_lo
    mid = (g_lo + g_hi) // 2
    q_order = np.argsort(mid, kind="stable")
    q = mid[q_order]
    h_lo = np.asarray([h[0] for h in host], dtype=np.int64)
    h_len = np.asarray([h[1] for h in host], dtype=np.int64)
    a = np.searchsorted(q, h_lo, side="left")
    b = np.searchsorted(q, h_lo + h_len, side="right")
    covers = np.flatnonzero(b > a)
    # paint the gaps each operation spans, longest operation first, so
    # the shortest (innermost) one that spans a gap names it (of equal
    # ones, the first)
    covers = covers[np.lexsort((-covers, -h_len[covers]))]
    label = np.full(len(q), -1, dtype=np.int64)
    for i, lo_i, hi_i in zip(covers.tolist(), a[covers].tolist(),
                             b[covers].tolist()):
        label[lo_i:hi_i] = i
    names: dict = {}
    for i, n in zip(label.tolist(), length[q_order].tolist()):
        nm = host[i][2] if i >= 0 else "no host operation"
        names[nm] = names.get(nm, 0.0) + n * 1e-9
    return sorted(names.items(), key=lambda kv: -kv[1])


def kernel_seconds(trace: dict, fragments) -> Optional[float]:
    """Device seconds of the kernels whose name holds one of
    ``fragments``; None when the trace holds none."""
    hit = [s for nm, (n, s) in trace.get("kernels", {}).items()
           if any(f in nm for f in fragments)]
    return sum(hit) if hit else None


def breakdown(trace: dict) -> dict:
    ops = sorted(((nm, s) for nm, (n, s) in trace.get("kernels", {}).items()),
                 key=lambda kv: -kv[1])[:10]
    gaps = trace.get("idle_gaps", [])[:10]
    return {"device_ops": [[nm, s] for nm, s in ops],
            "idle_gaps": [[nm, s] for nm, s in gaps]}
