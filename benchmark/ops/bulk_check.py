"""Bulk checks: ``Engine.check_bulk_async(items)``, its future read back
for the verdicts, each call
``subjects_per_call`` subjects x ``resources_per_subject`` resources.

Traffic keys: ``resource_type``, ``permission``, ``subject_type``,
``subjects_per_call``, ``resources_per_subject``, ``call_pool`` (distinct
calls drawn from the seed at set-up; the k-th request sends call
``k % call_pool``) and ``contexts`` (as for lists).
"""

from __future__ import annotations

import numpy as np

from ..streams import seeded_rng

LIMITS = {"verdicts_wrong": 0, "calls_wrong": 0}


def prepare(env) -> dict:
    from spicedb_kubeapi_proxy_tpu_torch.engine import CheckItem

    tr = env.traffic
    names = env.data["names"]
    rt, st_ = tr["resource_type"], tr["subject_type"]
    res = [nm.decode() for nm in names[rt]]
    subj = [nm.decode() for nm in names[st_]]
    rng = seeded_rng(env.seed, "call-pool")
    calls = []
    for _ in range(tr["call_pool"]):
        s = rng.integers(len(subj), size=tr["subjects_per_call"])
        r = rng.integers(len(res), size=(len(s), tr["resources_per_subject"]))
        su = np.repeat(s, r.shape[1])
        ri = r.reshape(-1)
        items = [CheckItem(rt, res[p], tr["permission"], st_, subj[u])
                 for p, u in zip(ri.tolist(), su.tolist())]
        calls.append((ri, su, items))
    return {"env": env, "calls": calls, "contexts": tr["contexts"]}


def _send(st: dict, j: int, ctx):
    return st["env"].engine.check_bulk_async(st["calls"][j][2],
                                             context=ctx)


def stream(st: dict, purpose: str):
    """The endless calls: ``((pool index, context index), send)``."""
    n, ctxs = len(st["calls"]), st["contexts"]
    k = 0
    while True:
        j = k % n
        c = k % len(ctxs)
        k += 1
        yield (j, c), (lambda j=j, x=ctxs[c]: _send(st, j, x))


def warm(st: dict) -> None:
    """One call under every context (every call has the same shape)."""
    for ctx in st["contexts"]:
        _send(st, 0, ctx).result()


def answers(st: dict, key) -> int:
    return len(st["calls"][key[0]][2])


def judge(st: dict, ref, requests: list) -> dict:
    """Every verdict against the reference's."""
    want: dict = {}
    wrong = calls_wrong = 0
    for r in requests:
        w = want.get(r.key)
        if w is None:
            j, c = r.key
            ri, su, _ = st["calls"][j]
            w = want[r.key] = ref.check(ri, su, st["contexts"][c])
        got = np.asarray(r.output, dtype=bool)
        bad = int((got != w).sum()) if got.shape == w.shape else len(w)
        wrong += bad
        calls_wrong += bool(bad)
    return {"verdicts_wrong": wrong, "calls_wrong": calls_wrong}
