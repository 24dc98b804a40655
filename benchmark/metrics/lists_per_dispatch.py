"""Lists answered per device dispatch: each dispatch, fused or direct,
observes ``engine_lookup_seconds`` once (counted from the window's open
until every request started in it has answered)."""


def read(rec):
    if rec["op"] != "list":
        return None
    n = rec["hists"].get("engine_lookup_seconds", (0.0, 0))[1]
    return rec["answers_all"] / n if n else None
