"""Blocking device-to-host reads a list: the change in
``engine_host_syncs_total`` (every site: a fixpoint iteration's flags,
an occupancy-gated level's count, a future's readback) from the window's
open until every request started in it has answered, over the lists
answered."""


def read(rec):
    n = rec["counters"].get("engine_host_syncs_total")
    if rec["op"] != "list" or n is None or not rec["answers_all"]:
        return None
    return n / rec["answers_all"]
