"""The control of a cell's check: the plain reference put in the program's
place with one of the configuration's guarantees broken, judged by the
cell's own comparison. Its numbers must come out over their limits, or
the comparison could not tell a broken answer from a right one.

    python3 benchmark/control.py --workload <name> --kind <kind> \
        --seeds <n> [<n> ...] [--requests <n>]

Kinds (each breaks "every answer exact at the store's revision"):

- ``stale``: answers at the revision before the last 1% of the load's
  flat grants, as a lagging replica or a cache missing one write batch
  would give them;
- ``caveat_open``: caveated grants count whatever the request's context
  (fail-open), an approximate answer where the exact one is conditional.

It draws the first ``--requests`` requests a run would offer, and needs
neither the card nor the program's engine.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STALE_SHARE = 0.01


def broken_reference(kind: str, cfg: dict, data: dict, ref_mod):
    """The reference of ``data`` with the guarantee ``kind`` broken."""
    if kind == "stale":
        rows = dict(data["rows"])
        r = rows["pod#viewer@user"]
        keep = len(r[0]) - max(1, int(len(r[0]) * STALE_SHARE))
        rows["pod#viewer@user"] = tuple(x[:keep] for x in r)
        return ref_mod.Reference(cfg, {**data, "rows": rows})
    if kind == "caveat_open":
        if not cfg.get("caveat"):
            raise ValueError("caveat_open needs a caveated configuration")
        rows = dict(data["rows"])
        r = rows["pod#viewer@user"]
        rows["pod#viewer@user"] = r[:2]
        return ref_mod.Reference({**cfg, "caveat": None},
                                 {**data, "rows": rows})
    raise ValueError(f"unknown control kind {kind!r}")


class _Interner:
    """Stands in for the engine's: object i at index i + 2, as the
    store's interners put theirs after the two pseudo objects."""

    def __init__(self, names):
        self._ids = {nm.decode(): i + 2 for i, nm in enumerate(names)}

    def id_map(self) -> dict:
        return self._ids


def control_outputs(op_name: str, st: dict, ctrl, keys: list) -> list:
    """What the broken reference answers to ``keys``, in the shapes the
    program's calls return."""
    import numpy as np

    from benchmark.drive import Request
    from benchmark.ops.list import keep

    out = []
    if op_name == "list":
        it = _Interner(st["env"].data["names"][st["rt"]])
        for key in keys:
            subject, c = key
            m = np.zeros(len(it.id_map()) + 2, dtype=np.uint8)
            m[2:] = ctrl.lookup(subject, st["contexts"][c])
            out.append(Request(key, output=keep(st, (m, it))))
    else:
        for key in keys:
            j, c = key
            ri, su, _ = st["calls"][j]
            out.append(Request(key, output=ctrl.check(
                ri, su, st["contexts"][c]).tolist()))
    return out


def run_control(spec: dict, workload: str, kind: str, seed: int,
                n_requests: int, adjust=None) -> dict:
    """The compared numbers of the control on ``seed``."""
    from benchmark import spec as S

    cell = S.cell(spec, workload)
    if adjust is not None:
        adjust(cell)
    cfg, traffic = cell["config"], cell["traffic"]
    seed = int(seed) % (1 << 64)
    data = S.generator(cfg["generator"]).generate(cfg, seed)
    data.pop("cols")
    env = SimpleNamespace(engine=None, data=data, traffic=traffic, seed=seed,
                          cfg=cfg)
    op = S.op(traffic["op"])
    st = op.prepare(env)
    stream = op.stream(st, "window")
    keys = [next(stream)[0] for _ in range(n_requests)]
    ref_mod = S.reference(cfg["generator"])
    ref = ref_mod.Reference(cfg, data)
    ctrl = broken_reference(kind, cfg, data, ref_mod)
    got = op.judge(st, ref, control_outputs(traffic["op"], st, ctrl, keys))
    correct = all(got[k] <= lim for k, lim in op.LIMITS.items())
    return {"workload": workload, "kind": kind, "seed": seed,
            "requests": n_requests, "correct": correct,
            "compared": {k: {"value": got[k], "limit": op.LIMITS[k]}
                         for k in op.LIMITS}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--kind", required=True,
                    choices=("stale", "caveat_open"))
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--requests", type=int, default=1000)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from benchmark import spec as S

    spec = S.load_spec()
    for seed in args.seeds:
        t = time.perf_counter()
        out = run_control(spec, args.workload, args.kind, seed,
                          args.requests)
        out["seconds"] = round(time.perf_counter() - t, 3)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
