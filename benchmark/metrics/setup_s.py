"""Process start to the first timed request (host clock)."""


def read(rec):
    return rec["setup"]["setup_s"]
