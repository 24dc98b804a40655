"""Shared helpers for the PyTorch port's parity tests (tests/test_torch_*).

Flattens a JAX ``CompiledGraph`` into the plain-array form that
``spicedb_kubeapi_proxy_tpu_torch.convert.from_reference_arrays`` takes,
so both packages run the very same compiled graph; generates random
graphs; and runs either package's engine host on an event loop of its
own (``serving``), so a test talks to it from plain threads.
"""

from __future__ import annotations

import asyncio
import contextlib
import threading

import numpy as np

from spicedb_kubeapi_proxy_tpu.models import schema as jschema


def expr_tuple(e):
    """A JAX-package ``Expr`` as the port's nested-tuple form."""
    if isinstance(e, jschema.Nil):
        return ("nil",)
    if isinstance(e, jschema.RelationRef):
        return ("rel", e.name)
    if isinstance(e, jschema.Arrow):
        return ("arrow", e.tupleset, e.target)
    if isinstance(e, jschema.Union):
        return ("or",) + tuple(expr_tuple(o) for o in e.operands)
    if isinstance(e, jschema.Intersect):
        return ("and",) + tuple(expr_tuple(o) for o in e.operands)
    if isinstance(e, jschema.Exclude):
        return ("sub", expr_tuple(e.base), expr_tuple(e.subtract))
    raise TypeError(e)


def flatten_caveats(c) -> dict:
    """Plain view of a JAX ``CompiledCaveats`` (copies), the form
    ``convert.caveats_from_arrays`` takes."""
    return {
        "metas": [dict(m.__dict__) for m in c.metas],
        "hosts": [{
            "program": {
                "name": h.program.name,
                "params": [(p.name, p.type.name, p.type.elem)
                           for p in h.program.params],
                "ops": np.array(h.program.ops),
                "imm": np.array(h.program.imm),
                "n_regs": h.program.n_regs, "out_reg": h.program.out_reg,
                "lists": [(ls.ranges, ls.param, ls.elem)
                          for ls in h.program.lists],
                "scalar_col": dict(h.program.scalar_col),
                "list_id": dict(h.program.list_id),
                "scalar_width": dict(h.program.scalar_width),
                "uses_now": h.program.uses_now,
                "time_arith": h.program.time_arith},
            **{k: np.array(getattr(h, k)) for k in (
                "ctx_e", "ctx_v", "ctx_k", "lo_e", "lo_v", "hi_e", "hi_v",
                "list_k", "real")}} for h in c.hosts],
        "interner": dict(c.interner._map),
        "n_rows": c.n_rows,
        "inst_row": np.array(c.inst_row),
        "key_row": list(c.key_row.items()),
        "n_inst": c.n_inst,
        "time_bounds": np.array(c.time_bounds),
        "time_exact": c.time_exact,
        "any_now": c.any_now,
    }


def flatten_graph(cg) -> dict:
    """Plain numpy/Python view of a JAX ``CompiledGraph``, its overlay
    writer state and lookup tables included (copies: the JAX package
    mutates its overlay in place)."""
    return {
        "M": cg.M,
        "revision": cg.revision,
        "slot_offset": dict(cg.slot_offset),
        "type_sizes": dict(cg.type_sizes),
        "base_time": cg.base_time,
        "src": np.asarray(cg.src), "dst": np.asarray(cg.dst),
        "exp_rel": np.asarray(cg.exp_rel), "n_edges": cg.n_edges,
        "res_idx": np.asarray(cg.res_idx),
        "res_src": np.asarray(cg.res_src), "res_dst": np.asarray(cg.res_dst),
        "res_exp": np.asarray(cg.res_exp),
        "res_cav": None if cg.res_cav is None else np.asarray(cg.res_cav),
        "res_level_bounds": cg.res_level_bounds,
        "range_offs": np.asarray(cg.range_offs),
        "range_levels": np.asarray(cg.range_levels),
        "n_levels": cg.n_levels,
        "blocks": [{"dst_off": b.dst_off, "n_dst": b.n_dst,
                    "src_off": b.src_off, "n_src": b.n_src,
                    "dst_local": np.asarray(b.dst_local),
                    "src_local": np.asarray(b.src_local),
                    "level": b.level, "closured": b.closured,
                    "base_dst_local": None if b.base_dst_local is None
                    else np.array(b.base_dst_local),
                    "base_src_local": None if b.base_src_local is None
                    else np.array(b.base_src_local)}
                   for b in cg.blocks],
        "programs": [{"dst_off": p.dst_off, "size": p.size,
                      "expr": expr_tuple(p.expr),
                      "leaf_off": [(expr_tuple(k), v)
                                   for k, v in p.leaf_off.items()],
                      "level": p.level}
                     for p in cg.programs],
        "delta_src": np.array(cg.delta_src),
        "delta_dst": np.array(cg.delta_dst),
        "delta_exp": np.array(cg.delta_exp),
        "delta_cav": np.array(cg.delta_cav),
        "n_delta": cg.n_delta,
        "dead_pairs": None if cg.dead_pairs is None
        else np.array(cg.dead_pairs),
        "delta_cap": cg.delta_cap,
        "dead_buf": None if cg.dead_buf is None else np.array(cg.dead_buf),
        "n_dead": cg.n_dead,
        "self_off": cg.self_off, "rel_off": cg.rel_off,
        "relperm_off": cg.relperm_off,
        "arrow_maps": [(a, r, o, np.array(t)) for a, r, o, t in
                       (cg.arrow_maps or ())],
        "caveats": None if cg.caveats is None
        else flatten_caveats(cg.caveats),
    }


def random_rels(rng, n_users=9, n_groups=4, n_ns=3, n_pods=12,
                nested=True, expiring="all", now=None):
    """Relationship strings over a group/namespace/pod graph: direct and
    userset grants, nested (cyclic) groups and, given ``now``, an expiring
    wildcard grant (``expiring="wildcard"``) or also expiring user grants
    (``"all"``), one hour on either side of ``now``."""
    rels = set()
    for _ in range(2 * n_groups):
        rels.add(f"group:g{rng.integers(n_groups)}#member"
                 f"@user:u{rng.integers(n_users)}")
    if nested:
        for g in range(n_groups):
            rels.add(f"group:g{g}#member@group:g{(g + 1) % n_groups}#member")
    for n in range(n_ns):
        rels.add(f"namespace:ns{n}#viewer@group:g{rng.integers(n_groups)}"
                 "#member")
        rels.add(f"namespace:ns{n}#creator@user:u{rng.integers(n_users)}")
    for p in range(n_pods):
        rels.add(f"pod:p{p}#namespace@namespace:ns{rng.integers(n_ns)}")
        for _ in range(2):
            rels.add(f"pod:p{p}#viewer@user:u{rng.integers(n_users)}")
    out = sorted(rels)
    if expiring and now is not None:
        from datetime import datetime, timezone

        def stamp(t):
            return datetime.fromtimestamp(t, timezone.utc).strftime(
                "%Y-%m-%dT%H:%M:%SZ")
        out.append(f"namespace:ns0#viewer@user:*[expiration:"
                   f"{stamp(now + 3600)}]")
        if expiring == "all":
            out.append(f"namespace:ns1#viewer@user:u1[expiration:"
                       f"{stamp(now - 3600)}]")
            out.append(f"namespace:ns2#viewer@user:u2[expiration:"
                       f"{stamp(now + 3600)}]")
    return out


@contextlib.contextmanager
def serving(server_cls, engine, **kw):
    """``server_cls(engine, **kw)`` (either package's ``EngineServer``)
    listening on loopback, driven by an event loop on a thread of its
    own; yields the started server (``.port`` bound) and stops it, its
    loop and its thread on exit."""
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()
    server = server_cls(engine, **kw)
    try:
        asyncio.run_coroutine_threadsafe(server.start(), loop).result(30)
        yield server
    finally:
        try:
            asyncio.run_coroutine_threadsafe(server.stop(),
                                             loop).result(60)
        finally:
            loop.call_soon_threadsafe(loop.stop)
            thread.join(30)
            loop.close()


def fake_kube_class(pkg: str):
    """``tests/fake_kube.FakeKube`` over ``pkg``'s own ``InMemoryKube``
    (that module subclasses the JAX package's; the port's tests need the
    port's): failure injection and request recording, the same code."""
    import importlib
    from typing import Optional

    base = importlib.import_module(pkg + ".proxy.inmemkube").InMemoryKube
    types = importlib.import_module(pkg + ".proxy.types")

    class FakeKube(base):
        def __init__(self):
            super().__init__()
            self._fail_next: list = []  # (method | None, status, exc)
            self.requests: list = []

        def fail_next(self, n: int = 1, status: int = 500,
                      exception: Optional[Exception] = None,
                      method: Optional[str] = None):
            for _ in range(n):
                self._fail_next.append((method, status, exception))

        async def __call__(self, req):
            self.requests.append(req)
            if self._fail_next:
                method, status, exc = self._fail_next[0]
                if method is None or method == req.method:
                    self._fail_next.pop(0)
                    if exc is not None:
                        raise exc
                    return types.kube_status(status, "injected failure")
            return await super().__call__(req)

    return FakeKube


def package(pkg: str):
    """Either package's scale-out surface as one namespace (``"jax"`` or
    ``"torch"``), so one test body runs on both and compares: the engine
    (``engine(bootstrap)``, on the CPU for the port), its types, the
    engine host and client, ``scaleout``, ``autoscale``, the admission
    classes, the proxy's options and in-memory client, and the package's
    own metrics registry."""
    import importlib
    import types as _types

    base = {"jax": "spicedb_kubeapi_proxy_tpu",
            "torch": "spicedb_kubeapi_proxy_tpu_torch"}[pkg]

    def mod(name):
        return importlib.import_module(f"{base}.{name}")

    ns = _types.SimpleNamespace(name=pkg, base=base)
    engine_mod = mod("engine.engine")
    store = mod("engine.store")
    remote = mod("engine.remote")
    for src, names in (
            (engine_mod, ("Engine", "CheckItem", "SchemaViolation",
                          "WatchEvent", "mask_to_ids")),
            (store, ("RelationshipFilter", "WriteOp", "Precondition",
                     "PreconditionFailed", "StoreError")),
            (remote, ("EngineServer", "RemoteEngine", "FailoverEngine")),
            (mod("models.tuples"), ("Relationship",)),
            (mod("admission"), ("AdmissionRejected", "CHECK", "CLASSES",
                                "LOOKUP_PREFILTER", "REBALANCE",
                                "WATCH_RECOMPUTE", "WRITE_DTX",
                                "classify_op")),
            (mod("utils.resilience"), ("DependencyUnavailable",)),
            (mod("utils.metrics"), ("metrics",)),
            (mod("scaleout"), ("FrontierConfig", "FrontierError",
                               "MapTransition", "RebalanceCoordinator",
                               "RebalanceError", "RevisionVector",
                               "ShardMap", "ShardMapError",
                               "ShardVectorCache", "ShardedEngine",
                               "SplitJournal", "abort_transition",
                               "decode_frontier", "encode_frontier",
                               "expand_local", "hash_key",
                               "load_shard_map", "map_to_doc",
                               "parse_shard_map", "plan_moves",
                               "reference_pairs", "shrink_map",
                               "split_resource")),
            (mod("autoscale"), ("AutoscaleController", "AutoscaleError",
                                "AutoscalePolicy", "PolicyConfig",
                                "Signals", "parse_policy")),
            (mod("proxy.options"), ("Options", "OptionsError")),
            (mod("proxy.inmemory"), ("InMemoryClient",))):
        for n in names:
            setattr(ns, n, getattr(src, n))
    ns.remote = remote
    ns.rebalance = mod("scaleout.rebalance")
    ns.FakeKube = fake_kube_class(base)

    def engine(bootstrap=None, **kw):
        if pkg == "torch":
            kw.setdefault("device", "cpu")
        return ns.Engine(bootstrap=bootstrap, **kw)

    ns.engine = engine
    return ns


def counter(P, name: str, **labels) -> float:
    """A counter's value in package ``P``'s own metrics registry."""
    return P.metrics.counter(name, **labels).value


def port_cases(filename: str, replacements=(), names=None) -> dict:
    """The test functions of the JAX package's ``tests/<filename>``, run
    on the port: its source with every ``spicedb_kubeapi_proxy_tpu.``
    import pointed at the port's package, then each ``(old, new)`` of
    ``replacements`` applied (each must occur: a drifted source fails
    loudly here instead of silently testing the reference), compiled
    under the original file name and executed as a module of its own.
    Returns ``{name: function}`` for the ``test_*`` functions (only those
    in ``names`` when given), for a port test module to re-export: the
    same bodies, parameters and marks, against the port."""
    import os
    import types as _types

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        filename)
    with open(path) as fh:
        src = fh.read()
    src = src.replace("spicedb_kubeapi_proxy_tpu.",
                      "spicedb_kubeapi_proxy_tpu_torch.")
    for old, new in replacements:
        if old not in src:
            raise AssertionError(f"{filename}: {old!r} not found")
        src = src.replace(old, new)
    mod = _types.ModuleType(f"port_cases_{filename[:-3]}")
    mod.__file__ = path
    exec(compile(src, path, "exec"), mod.__dict__)
    out = {}
    for name, fn in vars(mod).items():
        if name.startswith("test_") and callable(fn) \
                and (names is None or name in names):
            out[name] = fn
    if names is not None and set(names) - set(out):
        raise AssertionError(f"{filename}: missing {set(names) - set(out)}")
    return out
