"""Host ms a list in the caveat VM: the summed duration of the
program's ``caveat_vm`` spans (once a caveated dispatch) in the traced
window, over the lists answered."""

from benchmark import spans


def read(rec):
    got = (spans.of(rec) or {}).get("spans", {}).get("caveat_vm")
    return spans.per_list_ms(rec, got[1] if got else None)
