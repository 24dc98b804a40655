"""Data of the pods schema family (BENCH_SCHEMA and MESH_SCHEMA).

A copy, frozen here, of the reference bench's columnar generator
(``build_engine``): about 20 users a group, two group viewer grants a
namespace, every pod in one namespace, and the rest flat
``pod#viewer@user`` grants. As in the chip smoke script's ``build_rows``,
every kind of row is deduplicated (the first draw of a pair is kept),
since a bulk load assumes distinct rows. With a caveat, a short chain of
nested groups (g1 in g0, g2 in g1, ...) makes the fixpoint iterate, and a
share of the flat grants carry the caveat under one of the stored
contexts, alternating.

Everything is drawn from one ``numpy`` generator seeded by the run's
seed, so a seed gives the same rows on every machine. The rows come
twice: as the byte-string columns the engine's bulk load takes, and as
integer columns over each type's index space for the plain reference.
"""

from __future__ import annotations

import numpy as np


def _names(prefix: str, n: int) -> np.ndarray:
    digits = np.arange(n).astype(f"S{len(str(max(n - 1, 0)))}")
    return np.char.add(prefix.encode(), digits)


def _first_draws(a: np.ndarray, b: np.ndarray, n_b: int):
    keep = np.sort(np.unique(a * n_b + b, return_index=True)[1])
    return a[keep], b[keep]


def generate(cfg: dict, seed: int) -> dict:
    """The configuration's rows for ``seed``.

    Returns ``cols`` (the bulk load's columns), ``names`` (each object
    type's names, index i naming object i of the reference's space) and
    ``rows`` (the same rows as integers: ``kind`` -> (resource indices,
    subject indices[, stored-context index per row, -1 for none]))."""
    s = cfg["sizes"]
    n_pods, n_users = s["n_pods"], s["n_users"]
    n_ns, n_groups = s["n_namespaces"], s["n_groups"]
    n_rels = s["n_relationships"]
    cav = cfg.get("caveat")
    chain = int(cfg.get("nested_group_chain", 0))
    rng = np.random.default_rng(seed)
    names = {"pod": _names("ns/p", n_pods), "user": _names("u", n_users),
             "group": _names("g", n_groups),
             "namespace": _names("ns", n_ns)}
    parts: list = []

    def add(rt, rl, st, srl, r_idx, s_idx, ctx_idx=None):
        parts.append((rt, rl, st, srl, r_idx, s_idx, ctx_idx))

    gm = min(s["members_per_group"] * n_groups, n_rels // 20)
    g, u = _first_draws(rng.integers(n_groups, size=gm),
                        rng.integers(n_users, size=gm), n_users)
    add("group", "member", "user", "", g, u)
    if chain:
        link = np.arange(min(chain, n_groups - 1))
        add("group", "member", "group", "member", link, link + 1)
    nv = s["viewer_groups_per_namespace"] * n_ns
    n, g = _first_draws(rng.integers(n_ns, size=nv),
                        rng.integers(n_groups, size=nv), n_groups)
    add("namespace", "viewer", "group", "member", n, g)
    pod_ns = rng.integers(n_ns, size=n_pods)
    add("pod", "namespace", "namespace", "", np.arange(n_pods), pod_ns)
    n_flat = n_rels - len(u) - len(n) - n_pods
    pair = rng.integers(0, n_pods * n_users, size=int(n_flat * 1.01),
                        dtype=np.int64)
    # sorted distinct pairs, as np.unique gives them (its hashing path
    # in newer NumPy takes seconds longer over 10M values)
    pair.sort()
    pair = pair[np.concatenate([[True], pair[1:] != pair[:-1]])][:n_flat]
    rng.shuffle(pair)
    ctx_idx = None
    if cav is not None:
        i = np.arange(len(pair))
        n_ctx = len(cav["stored_contexts"])
        ctx_idx = np.where(i < int(len(pair) * cav["share"]), i % n_ctx, -1)
    add("pod", "viewer", "user", "", pair // n_users, pair % n_users,
        ctx_idx)

    cols: dict = {k: [] for k in ("resource_type", "resource_id",
                                  "relation", "subject_type", "subject_id",
                                  "subject_relation")}
    if cav is not None:
        cols["caveat"], cols["caveat_context"] = [], []
        stored = np.asarray(cav["stored_contexts"] + [""])
    rows = {}
    for rt, rl, st, srl, r_idx, s_idx, c_idx in parts:
        k = len(r_idx)
        cols["resource_type"].append(np.full(k, rt.encode()))
        cols["resource_id"].append(names[rt][r_idx])
        cols["relation"].append(np.full(k, rl.encode()))
        cols["subject_type"].append(np.full(k, st.encode()))
        cols["subject_id"].append(names[st][s_idx])
        cols["subject_relation"].append(np.full(k, srl.encode()))
        if cav is not None:
            has = c_idx >= 0 if c_idx is not None else np.zeros(k, bool)
            cols["caveat"].append(np.where(has, cav["name"], ""))
            cols["caveat_context"].append(
                stored[c_idx] if c_idx is not None else np.full(k, ""))
        key = f"{rt}#{rl}@{st}" + (f"#{srl}" if srl else "")
        rows[key] = (r_idx, s_idx) + ((c_idx,) if c_idx is not None else ())
    return {"cols": {k: np.concatenate(v) for k, v in cols.items()},
            "names": names, "rows": rows,
            "n_relationships": sum(len(p[4]) for p in parts)}
