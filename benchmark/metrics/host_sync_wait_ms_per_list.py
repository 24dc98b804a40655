"""Host ms a list blocked in device-to-host reads: the summed duration
of the program's ``host_sync`` spans in the traced window, over the
lists answered."""

from benchmark import spans


def read(rec):
    got = (spans.of(rec) or {}).get("spans", {}).get("host_sync")
    return spans.per_list_ms(rec, got[1] if got else None)
