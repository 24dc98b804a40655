"""The first ``Engine.compiled()``: host compile and device build (host
clock)."""


def read(rec):
    return rec["setup"]["compile_s"]
