"""Host ms a list in the fixpoint's own Python and launches: the self
time of the program's ``fixpoint`` spans (less their ``caveat_vm`` and
``host_sync`` children) in the traced window, over the lists
answered."""

from benchmark import spans


def read(rec):
    got = (spans.of(rec) or {}).get("spans", {}).get("fixpoint")
    return spans.per_list_ms(rec, got[2] if got else None)
