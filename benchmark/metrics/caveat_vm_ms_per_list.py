"""Device ms a list under the ``caveat_vm`` range (caveats/vm.py, once a
dispatch) in the traced window, over the lists answered."""


def read(rec):
    t = rec.get("trace")
    if rec["op"] != "list" or not t or not rec["answers_all"]:
        return None
    got = t["ranges"].get("caveat_vm")
    return got[1] * 1e3 / rec["answers_all"] if got else None
