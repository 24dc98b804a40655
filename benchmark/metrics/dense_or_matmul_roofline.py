"""The pull kernel's share of its roofline, in %: the least time its
launches' inputs need (benchmark/roofline.py ``dense_hop_bytes`` and
``dense_hop_ops``, summed over the traced window's launches) over the
device time of its two kernels (the live-column pre-pass and the
product) in the same window."""

from benchmark.tracing import kernel_seconds


def read(rec):
    t, got = rec.get("trace"), (rec.get("launches") or {}).get(
        "dense_or_matmul")
    if not t or not got or not got["n"]:
        return None
    dev = kernel_seconds(t, ("dense_live_tiles", "dense_or_matmul"))
    return 100.0 * got["bound_s"] / dev if dev else None
