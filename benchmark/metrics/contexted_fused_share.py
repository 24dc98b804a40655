"""Contexted lists that shared their device dispatch, as a share of
those routed: the window's change in
``engine_lookups_contexted_fused_total`` (rows of fused dispatches of
more than one row whose context matters) over that of
``engine_lookups_contexted_total`` (every list the engine routed whose
context matters), times 100. Nothing to read where no such list was
routed, or where the program has neither counter."""


def read(rec):
    n = rec["counters"].get("engine_lookups_contexted_total")
    if rec["op"] != "list" or not n:
        return None
    return 100.0 * rec["counters"].get(
        "engine_lookups_contexted_fused_total", 0.0) / n
