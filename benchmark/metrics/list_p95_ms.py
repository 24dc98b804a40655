"""95th percentile latency of the window's lists, each from its submit
to when its answer was read back (host clock), over every list sent in
the window; one that never answered counts as longer than any."""

import numpy as np


def read(rec):
    if rec["op"] != "list" or not rec["latencies_s"]:
        return None
    v = float(np.percentile(rec["latencies_s"], 95))
    return v * 1e3 if np.isfinite(v) else None
