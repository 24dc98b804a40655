"""Share of the traced window, in %, in which the device ran nothing and
no program span was open on any thread, in a list cell: the idle time
the program's spans leave unnamed."""

from benchmark import spans


def read(rec):
    got = spans.of(rec)
    if rec["op"] != "list" or not got or not got["n_device"] \
            or "fixpoint" not in got["spans"]:
        return None
    return 100.0 * got["idle_outside_s"] / got["window_s"]
