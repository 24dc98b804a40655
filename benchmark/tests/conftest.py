"""The benchmark's tests: run here on the CPU at a tiny size; the one
test marked ``cuda`` decides inside itself whether a card is present.

    python -m pytest benchmark/tests -q
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# the cells' shapes at a size a test run holds: every width of the
# schema and every kind of row kept, the counts cut
TINY_SIZES = {"n_pods": 600, "n_users": 300, "n_namespaces": 20,
              "n_groups": 20, "n_relationships": 30000}


def tiny(cell: dict) -> None:
    cell["config"]["sizes"].update(TINY_SIZES)
    t = cell["traffic"]
    if t["op"] == "bulk_check":
        t.update(subjects_per_call=16, resources_per_subject=256,
                 call_pool=8)


# cells kept for later (PERF.md, Open questions), not in BENCHMARK.json:
# the headline list cell, whose rate spread too widely from run to run
# on the card, and the bulk-check cell. Their configuration, ops, traffic
# and readers stay, and the tests drive them through a copy of the spec
# that names them
HEADLINE_CONFIG = {
    "name": "headline-10m",
    "source": "BASELINE.json north star: filter a 100k-pod list against "
              "a 10M-relationship graph on one chip; widths of bench.py's "
              "headline, bench.py:34-54,97-194,672-673",
    "file": "benchmark/configs/headline-10m.json", "reduced": [],
    "why": "the north star: 100k pods against 10M relationships on one "
           "card; the store, compile, fixpoint, semiring hop and the bit "
           "kernel"}
HEADLINE_CELL = {
    "name": "headline.list_fanout", "config": "headline-10m",
    "traffic": "list_fanout", "chips": 1,
    "why": "256 lists in flight from one thread, uniform users, no "
           "context, refilled 8 at a time: the batcher fuses 8 rows a "
           "dispatch onto the push path (bit kernel); no caveat VM"}
# the metrics of BENCHMARK.json that the headline list cell reports too
HEADLINE_METRICS = ("list_rate", "list_p95_ms", "lists_per_dispatch",
                    "bit_or_matmul_roofline", "device_idle.list")
BULK_CELL = {"name": "headline.bulk_check", "config": "headline-10m",
             "traffic": "bulk_check", "chips": 1,
             "why": "2 bulk checks in flight: the per-item encode and the "
                    "pull path (dense kernel)"}
BULK_METRICS = {
    "end_to_end": [{"name": "check_rate", "unit": "checks/s",
                    "better": "higher", "bound": 0.25,
                    "source": "host_clock",
                    "workloads": ["headline.bulk_check"]}],
    "per_layer": [
        {"name": n, "unit": u, "better": b, "source": s, "layer": la,
         "moves": "check_rate", "workloads": ["headline.bulk_check"]}
        for n, u, b, s, la in (
            ("check_call_p95_ms", "ms", "lower", "host_clock", "engine"),
            ("dense_or_matmul_roofline", "%", "higher", "device_trace",
             "kernels"),
            ("device_idle.check", "%", "lower", "device_trace", "device"))],
}


@pytest.fixture(scope="session")
def spec():
    from benchmark import spec as S

    return S.load_spec()


@pytest.fixture(scope="session")
def spec_full(spec):
    """BENCHMARK.json with the cells kept for later, their configuration
    and their metrics added."""
    import copy

    out = copy.deepcopy(spec)
    out["configs"].append(copy.deepcopy(HEADLINE_CONFIG))
    out["workloads"] += [copy.deepcopy(HEADLINE_CELL), BULK_CELL]
    for m in out["end_to_end"] + out["per_layer"]:
        if m["name"] in HEADLINE_METRICS:
            m["workloads"].append(HEADLINE_CELL["name"])
    for k, v in BULK_METRICS.items():
        out[k].extend(copy.deepcopy(v))
    return out


@pytest.fixture(params=["spec", "spec_full"])
def any_spec(request):
    """BENCHMARK.json, and its copy with the cells kept for later."""
    return request.getfixturevalue(request.param)
