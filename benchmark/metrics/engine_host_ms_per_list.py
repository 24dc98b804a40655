"""Host ms a list in the engine around the fixpoint: the self time of
the program's ``engine.lookup`` (route, cache, batcher submit),
``engine.dispatch`` (encoding, seed upload, the call into the fixpoint)
and ``engine.result`` (mask copy and post-processing; its children, the
readback's ``host_sync`` and a fused lookup's ``engine.batch_wait``,
excluded) spans in the traced window, over the lists answered."""

from benchmark import spans

NAMES = ("engine.lookup", "engine.dispatch", "engine.result")


def read(rec):
    got = (spans.of(rec) or {}).get("spans", {})
    hit = [got[n][2] for n in NAMES if n in got]
    return spans.per_list_ms(rec, sum(hit) if hit else None)
