"""BENCHMARK.json against the contract's shape, and every file it names
found by name."""

import json
import os
import re

import pytest

from benchmark import spec as S

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_limits(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(spec["paths"]) <= 16
    assert all(re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p)
               for p in spec["paths"])
    assert len(spec["command"]) <= 32 and all(_line(w)
                                              for w in spec["command"])
    assert isinstance(spec["run_seconds"], int)
    assert 1 <= spec["run_seconds"] <= 51
    # a full check of 24 cells fits in 43,200 s
    runs = 2 + 14 * 24
    assert runs * (spec["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(spec)) <= 64 * 1024


def test_names_units_and_keys(any_spec):
    names = [c["name"] for c in any_spec["configs"]]
    names += [w["name"] for w in any_spec["workloads"]]
    metrics = any_spec["end_to_end"] + any_spec["per_layer"]
    names += [m["name"] for m in metrics]
    assert len(set(c["name"] for c in any_spec["configs"])) == len(
        any_spec["configs"])
    assert len(set(w["name"] for w in any_spec["workloads"])) == len(
        any_spec["workloads"])
    assert len(set(m["name"] for m in metrics)) == len(metrics)
    for n in names:
        assert NAME.match(n), n
    for c in any_spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16
    pairs = set()
    for w in any_spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    for m in any_spec["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in any_spec["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in SOURCES and _line(m["layer"])
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_every_cell_reports_setup_an_end_to_end_and_a_layer(any_spec):
    e2e = {m["name"] for m in any_spec["end_to_end"]}
    assert "setup_s" in e2e
    assert {m["name"]: m["bound"] for m in any_spec["end_to_end"]}[
        "setup_s"] <= 0.25
    for w in any_spec["workloads"]:
        got = {m["name"] for m in S.metrics_of(any_spec, w["name"], False)}
        assert "setup_s" in got and len(got) >= 2
        layer = S.metrics_of(any_spec, w["name"], True)
        assert layer
        for m in layer:
            assert m["moves"] in got, (w["name"], m["name"])
    for m in any_spec["per_layer"]:
        assert m["moves"] in e2e
        for w in m.get("workloads", []):
            assert w in {x["name"] for x in any_spec["workloads"]}


def test_layers_share_one_spelling(spec):
    layers = {m["layer"] for m in spec["per_layer"]}
    lowered = {}
    for la in layers:
        lowered.setdefault(la.lower().replace("-", " "), set()).add(la)
    assert all(len(v) == 1 for v in lowered.values())


def test_every_file_named_loads(any_spec):
    for c in any_spec["configs"]:
        assert c["file"].startswith("benchmark/")
        cell_cfg = json.load(open(os.path.join(S.ROOT, c["file"])))
        assert cell_cfg["name"] == c["name"]
        assert cell_cfg["source"] == c["source"]
        assert sorted(cell_cfg["reduced"]) == sorted(c["reduced"])
        assert callable(S.generator(cell_cfg["generator"]).generate)
        assert S.reference(cell_cfg["generator"]).Reference
    for w in any_spec["workloads"]:
        cell = S.cell(any_spec, w["name"])
        o = S.op(cell["traffic"]["op"])
        for fn in ("prepare", "stream", "warm", "answers", "judge"):
            assert callable(getattr(o, fn))
        assert o.LIMITS
    for m in any_spec["end_to_end"] + any_spec["per_layer"]:
        assert callable(S.metric_reader(m["name"]))


def test_paths_hold_only_the_benchmark(spec):
    assert spec["paths"] == ["benchmark"]
    assert spec["command"][1].startswith("benchmark/")


@pytest.mark.parametrize("name", ["caveated.list_ctx", "no.such_cell"])
def test_cell_lookup(spec, name):
    if name == "no.such_cell":
        with pytest.raises(KeyError):
            S.cell(spec, name)
    else:
        assert S.cell(spec, name)["workload"]["name"] == name
