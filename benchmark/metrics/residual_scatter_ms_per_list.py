"""Device ms a list of the residual scatter: the kernels launched under
``aten::index_add_`` (ops/semiring.py ``_scatter_or``) in the traced
window, over the lists answered."""


def read(rec):
    t = rec.get("trace")
    if rec["op"] != "list" or not t or not rec["answers_all"]:
        return None
    got = t["ranges"].get("aten::index_add_")
    return got[1] * 1e3 / rec["answers_all"] if got else None
