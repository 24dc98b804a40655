"""``Engine.bulk_load`` of the generated rows (host clock)."""


def read(rec):
    return rec["setup"]["load_s"]
