"""List prefilters: ``Engine.lookup_resources_mask_async(...)`` for one
subject at a time, its future read back for the mask over every object
of the type.

Traffic keys: ``resource_type``, ``permission``, ``subject_type``,
``contexts`` (request contexts, ``null`` for none) and, optionally,
``context_run`` (default 1): runs of that many consecutive requests share
a context, the k-th request taking context ``(k // context_run) %
len(contexts)``, so each comes in an equal share.
Subjects are drawn uniformly from the seed.
"""

from __future__ import annotations

import numpy as np

from ..streams import seeded_rng

# each number the check compares, with its limit: exact answers
LIMITS = {"masks_wrong": 0, "bits_wrong": 0}

# rows a fused dispatch holds (the batcher's max_rows) are warmed up to
# this many concurrent submits
WARM_ROWS = 8


def prepare(env) -> dict:
    tr = env.traffic
    return {"env": env, "rt": tr["resource_type"], "perm": tr["permission"],
            "st": tr["subject_type"], "contexts": tr["contexts"],
            "context_run": tr.get("context_run", 1),
            "subjects": env.data["names"][tr["subject_type"]]}


def _send(st: dict, subject: int, ctx):
    e = st["env"].engine
    return e.lookup_resources_mask_async(
        st["rt"], st["perm"], st["st"], st["subjects"][subject].decode(),
        context=ctx)


def stream(st: dict, purpose: str):
    """The endless requests: ``((subject, context index), send)``."""
    rng = seeded_rng(st["env"].seed, purpose)
    n, ctxs = len(st["subjects"]), st["contexts"]
    run = st["context_run"]
    k = 0
    while True:
        subject = int(rng.integers(n))
        c = (k // run) % len(ctxs)
        k += 1
        yield (subject, c), (lambda s=subject, x=ctxs[c]: _send(st, s, x))


def warm(st: dict) -> None:
    """Every fused-dispatch size, 1 to WARM_ROWS, under every context."""
    e = st["env"].engine
    rng = seeded_rng(st["env"].seed, "warm-sizes")
    n = len(st["subjects"])
    for ctx in st["contexts"]:
        for rows in range(1, WARM_ROWS + 1):
            futs = [e.lookup_resources_mask_async(
                st["rt"], st["perm"], st["st"],
                st["subjects"][int(rng.integers(n))].decode(), context=ctx)
                for _ in range(rows)]
            for f in futs:
                f.result()


def keep(st: dict, out) -> tuple:
    """A read-back ``(mask, interner)`` as ``(bits, length, interner)``:
    the mask's nonzero entries packed eight to a byte."""
    mask, interner = out
    m = np.asarray(mask)
    return np.packbits(m), m.shape[0], interner


def answers(st: dict, key) -> int:
    return 1


def judge(st: dict, ref, requests: list) -> dict:
    """Every mask (as ``keep`` holds it) against the reference's:
    ``masks_wrong`` lists whose mask differs anywhere, ``bits_wrong``
    entries that differ (over the type's objects, and any set entry
    outside them, where the reference's mask is empty)."""
    names = st["env"].data["names"][st["rt"]]
    perm = None
    want: dict = {}
    masks_wrong = bits_wrong = 0
    for r in requests:
        bits, n, interner = r.output
        if perm is None:
            ids = interner.id_map()
            perm = np.asarray([ids[nm.decode()] for nm in names],
                              dtype=np.int64)
        key = r.key, n
        w = want.get(key)
        if w is None:
            subject, c = r.key
            full = np.zeros(n, dtype=bool)
            full[perm] = ref.lookup(subject, st["contexts"][c])
            w = want[key] = np.packbits(full)
        diff = np.bitwise_xor(bits, w)
        if diff.any():
            masks_wrong += 1
            bits_wrong += int(np.unpackbits(diff).sum())
    return {"masks_wrong": masks_wrong, "bits_wrong": bits_wrong}
