"""The push kernel's share of its roofline, in %: the least time its
launches' inputs need (benchmark/roofline.py ``bit_hop_bytes`` over the
memory's rate, summed over the traced window's launches) over the device
time of its kernels in the same window."""

from benchmark.tracing import kernel_seconds


def read(rec):
    t, got = rec.get("trace"), (rec.get("launches") or {}).get(
        "bit_or_matmul")
    if not t or not got or not got["n"]:
        return None
    dev = kernel_seconds(t, ("bit_or_matmul",))
    return 100.0 * got["bound_s"] / dev if dev else None
