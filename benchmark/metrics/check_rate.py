"""Bulk-check verdicts answered by the window's close, over the window's
length (host clock)."""


def read(rec):
    if rec["op"] != "bulk_check" or not rec["window_s"]:
        return None
    return rec["answers_in_window"] / rec["window_s"]
