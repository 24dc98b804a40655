"""Share of the traced window, in %, in which no operation ran on the
device, in a bulk-check cell."""


def read(rec):
    t = rec.get("trace")
    if rec["op"] != "bulk_check" or not t or not t["n_device"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
