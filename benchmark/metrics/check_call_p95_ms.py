"""95th percentile latency of the window's bulk-check calls, each from its
submit to when its verdicts were read back (host clock), over every call
sent in the window; one that never answered counts as longer than any."""

import numpy as np


def read(rec):
    if rec["op"] != "bulk_check" or not rec["latencies_s"]:
        return None
    v = float(np.percentile(rec["latencies_s"], 95))
    return v * 1e3 if np.isfinite(v) else None
