"""``BENCHMARK.json`` and the files it names, found by name.

A configuration is ``configs/<name>.json`` (its ``generator`` names
``generators/<g>.py`` and the plain reference ``reference/<g>.py``); a
traffic mix is ``traffic/<name>.json`` (its ``op`` names ``ops/<op>.py``);
a metric is ``metrics/<name>.py``, whose ``read(rec)`` returns the
metric's value or None when the run gave it nothing to read.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_spec(path: str = os.path.join(ROOT, "BENCHMARK.json")) -> dict:
    with open(path) as fh:
        return json.load(fh)


def cell(spec: dict, workload: str) -> dict:
    """The workload's entry, its configuration and its traffic."""
    by_name = {w["name"]: w for w in spec["workloads"]}
    if workload not in by_name:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(has {sorted(by_name)})")
    w = by_name[workload]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    with open(os.path.join(ROOT, conf["file"])) as fh:
        config = json.load(fh)
    return {"workload": w, "config": config,
            "traffic": load_traffic(w["traffic"])}


def load_traffic(name: str) -> dict:
    with open(os.path.join(HERE, "traffic", f"{name}.json")) as fh:
        return json.load(fh)


def _module(kind: str, name: str):
    if not name.isidentifier():
        raise ValueError(f"{kind} name {name!r} is not a module name")
    return importlib.import_module(f"benchmark.{kind}.{name}")


def op(name: str):
    return _module("ops", name)


def generator(name: str):
    return _module("generators", name)


def reference(name: str):
    return _module("reference", name)


def metric_reader(name: str):
    """``metrics/<name>.py``'s ``read``; names may hold dots, so the file
    is loaded by its path."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(spec: dict, workload: str, traced: bool) -> list:
    """The metric entries a run of ``workload`` reports: its end-to-end
    metrics untraced, its per-layer metrics traced. A metric without a
    ``workloads`` list belongs to every cell that reports the metric it
    moves (end-to-end: every cell)."""
    e2e = [m for m in spec["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    if not traced:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if (workload in m["workloads"] if "workloads" in m
                else m["moves"] in names)]
