"""One run of one benchmark cell.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

In one process: generate the cell's configuration from the seed, build
the port's engine on the card as the proxy's options would, warm up the
cell's own shapes, keep the cell's requests in flight in a closed loop
for ``--seconds``, check every answer of the window against the plain
reference, and print one JSON line. ``--trace 1`` traces the window with
``torch.profiler`` and reports the cell's per-layer metrics instead of
its end-to-end ones.

A run needs as many CUDA cards as the cell asks for and exits 2 without
a result when they are missing; it never falls back to the CPU.
"""

import time

T_PROCESS = time.perf_counter()  # noqa: E402 - set-up is timed from here

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
from types import SimpleNamespace  # noqa: E402
from typing import Callable, Optional  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD = os.path.join(ROOT, "build")

# seconds of the cell's own traffic after the per-shape warm-up
WARM_S = 1.0
# modules that must not be loaded in the process that prints the result:
# the JAX package is the port's reference, never what is measured
FORBIDDEN = ("jax", "jaxlib", "flax", "spicedb_kubeapi_proxy_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is a forbidden one, compared
    whole (the port's package name begins with the JAX package's)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def _refuse_forbidden() -> None:
    """Exit without a result when a forbidden module is loaded."""
    found = forbidden_modules()
    if found:
        log(f"forbidden modules loaded: {found}")
        raise SystemExit(3)


def _join_store_prebuild() -> None:
    """The store indexes a bulk load on a background thread; let it end
    in set-up rather than in the window."""
    for t in threading.enumerate():
        if t.name == "store-index-prebuild":
            t.join()


def build_engine(cfg: dict, device: str):
    """The port's engine as ``Options.complete()`` makes it, with the
    configuration's engine settings."""
    from spicedb_kubeapi_proxy_tpu_torch.engine import Engine
    from spicedb_kubeapi_proxy_tpu_torch.models import parse_schema

    s = cfg["engine"]
    e = Engine(schema=parse_schema(cfg["schema"]), device=device,
               delta_capacity=s["delta_capacity"])
    if s["compact_threshold"] > 0:
        e.enable_compaction(s["compact_threshold"])
    if s["lookup_batch_window"] > 0:
        e.enable_lookup_batching(s["lookup_batch_window"], s["max_rows"])
    if s["authz_cache"]:
        e.enable_decision_cache()
    return e


def _registry() -> tuple:
    """The program's counters (by name, summed over labels) and its
    histograms' (sum, count) (by name), read from its metrics exposition."""
    from spicedb_kubeapi_proxy_tpu_torch.utils.metrics import metrics

    kinds: dict = {}
    counters: dict = {}
    hists: dict = {}
    for line in metrics.render().splitlines():
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(" ")
            kinds[name] = kind
            continue
        if not line or line.startswith("#"):
            continue
        series, value = line.rsplit(" ", 1)
        name = series.split("{", 1)[0]
        if kinds.get(name) == "counter":
            counters[name] = counters.get(name, 0.0) + float(value)
            continue
        for part, i in (("_sum", 0), ("_count", 1)):
            base = name[:-len(part)]
            if name.endswith(part) and kinds.get(base) == "histogram":
                got = hists.setdefault(base, [0.0, 0.0])
                got[i] += float(value)
    return counters, hists


def _delta(before: dict, after: dict) -> dict:
    """``after`` less ``before``, name by name (a histogram's sum and
    count each)."""
    out = {}
    for k, v in after.items():
        if isinstance(v, list):
            b = before.get(k, [0.0, 0.0])
            out[k] = (v[0] - b[0], v[1] - b[1])
        else:
            out[k] = v - before.get(k, 0.0)
    return out


def _power_limit() -> Optional[str]:
    try:
        p = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return p.stdout.strip().splitlines()[0] if p.stdout.strip() else None


def run_cell(spec: dict, workload: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda",
             t_process: float = T_PROCESS,
             adjust: Optional[Callable[[dict], None]] = None) -> dict:
    """One run; returns the result line as a dict (``correct`` ... last
    ``compared``). ``adjust(cell)`` may change the loaded configuration
    and traffic in place before anything is generated (the CPU tests
    shrink them)."""
    from benchmark import drive, spec as S, tracing

    cell = S.cell(spec, workload)
    if adjust is not None:
        adjust(cell)
    cfg, traffic = cell["config"], cell["traffic"]
    seed = int(seed) % (1 << 64)
    import torch

    from spicedb_kubeapi_proxy_tpu_torch.ops import bitprop

    cuda = device == "cuda"
    setup: dict = {}
    t = time.perf_counter()
    data = S.generator(cfg["generator"]).generate(cfg, seed)
    setup["gen_s"] = time.perf_counter() - t
    e = build_engine(cfg, device)
    t = time.perf_counter()
    e.bulk_load(data.pop("cols"))
    setup["load_s"] = time.perf_counter() - t
    t = time.perf_counter()
    e.compiled()
    setup["compile_s"] = time.perf_counter() - t
    _join_store_prebuild()
    env = SimpleNamespace(engine=e, data=data, traffic=traffic, seed=seed,
                          cfg=cfg)
    op = S.op(traffic["op"])
    st = op.prepare(env)
    t = time.perf_counter()
    op.warm(st)
    depth, burst = traffic["depth"], traffic["burst"]
    keep = getattr(op, "keep", None)
    if keep is not None:
        keep = (lambda k: lambda out: k(st, out))(keep)
    drive.run(op.stream(st, "warm"), depth, burst, WARM_S, keep=keep)
    if cuda:
        torch.cuda.synchronize()
    setup["warm_s"] = time.perf_counter() - t
    gc.collect()
    setup["setup_s"] = time.perf_counter() - t_process
    log(f"set-up {setup['setup_s']:.3f} s: " + ", ".join(
        f"{k} {v:.3f}" for k, v in setup.items() if k != "setup_s"))

    before = _registry()
    prof = spy = None
    box: dict = {}

    def on_start():
        nonlocal prof, spy
        if trace:
            from benchmark.launches import LaunchSpy

            # the profiler starts before the window: its start takes
            # seconds on the card
            prof = tracing.start_profiler(torch)
            spy = LaunchSpy(torch, bitprop)
            spy.install()
        box["t0"] = time.perf_counter()

    def on_close():
        box["t1"] = time.perf_counter()
        if trace:
            spy.remove()
            prof.stop()
            box["stop_s"] = time.perf_counter() - box["t1"]

    pauses: list = []

    def on_gc(phase, info):
        # full collections only: their pauses are what a window can feel
        if info["generation"] == 2:
            pauses.append(time.perf_counter())

    gc.callbacks.append(on_gc)
    reqs, t_open, t_close = drive.run(op.stream(st, "window"), depth,
                                      burst, seconds, on_start, on_close,
                                      keep)
    gc.callbacks.remove(on_gc)
    window_s = t_close - t_open
    if cuda:
        torch.cuda.synchronize()
        peak = int(torch.cuda.max_memory_allocated())
        kind = torch.cuda.get_device_name()
    else:
        peak, kind = 0, "cpu"
    after = _registry()
    _refuse_forbidden()

    answered = [r for r in reqs
                if r.t_end is not None and r.error is None]
    rec = {"op": traffic["op"], "seconds": float(seconds), "setup": setup,
           "window_s": window_s,
           "answers_all": sum(op.answers(st, r.key) for r in answered),
           "answers_in_window": sum(op.answers(st, r.key) for r in answered
                                    if r.t_end <= t_close),
           "latencies_s": [r.latency() for r in reqs],
           "counters": _delta(before[0], after[0]),
           "hists": _delta(before[1], after[1]),
           "trace": None, "launches": None}
    log(f"sent {len(reqs)} requests, {depth} in flight, refilled "
        f"{burst} at a time; {rec['answers_in_window']} answers by the "
        f"close of a {window_s:.3f} s window")
    per_s = [0] * max(1, int(window_s + 0.999))
    for r in answered:
        if r.t_end <= t_close:
            per_s[min(len(per_s) - 1, int(r.t_end - t_open))] += 1
    full = [b - a for a, b in zip(pauses[::2], pauses[1::2])
            if t_open <= a <= t_close]
    log(f"answers a second: {per_s}; full collections in the window: "
        f"{len(full)}, {sum(full):.3f} s")
    if trace:
        rec["trace"] = tracing.reduce(prof, box["t1"] - box["t0"])
        rec["launches"] = spy.totals()
        log(f"trace: stopped in {box['stop_s']:.1f} s, "
            f"{rec['trace']['n_host']} host events, "
            f"{rec['trace']['n_device']} device activities, busy "
            f"{rec['trace']['busy_s']:.6f} s of {rec['trace']['window_s']:.6f}"
            f" s, reduced in {rec['trace'].get('reduce_s', 0):.1f} s; "
            f"launches {rec['launches']}")
    metrics = {}
    for m in S.metrics_of(spec, workload, trace):
        v = S.metric_reader(m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": 1,
           "memory_peak_bytes": peak}
    if trace:
        dev["busy_s"] = rec["trace"]["busy_s"]
        dev["window_s"] = rec["trace"]["window_s"]
    if cuda:
        dev["power"] = _power_limit()

    # the program's state goes before the reference runs
    failed = [r for r in reqs if r.t_end is None or r.error]
    errors = sorted({r.error for r in failed if r.error})
    e.disable_lookup_batching()
    e.close_compaction()
    del env.engine, e
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    ref = S.reference(cfg["generator"]).Reference(cfg, data)
    compared = {"answers_missing": len(failed)}
    compared.update(op.judge(st, ref, answered))
    limits = {"answers_missing": 0, **op.LIMITS}
    log(f"reference and comparison: {time.perf_counter() - t:.3f} s over "
        f"{len(answered)} answered of {len(reqs)} offered")
    for msg in errors[:5]:
        log(f"error: {msg}")
    out = {"correct": all(compared[k] <= limits[k] for k in limits),
           "attempted": len(reqs), "failed": len(failed),
           "metrics": metrics, "device": dev}
    if trace:
        out["breakdown"] = tracing.breakdown(rec["trace"])
    out["compared"] = {k: {"value": compared[k], "limit": limits[k]}
                       for k in limits}
    for k in limits:
        log(f"compared {k}: {compared[k]} (limit {limits[k]})")
    # the reference and the metric readers are loaded by now
    _refuse_forbidden()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every build and kernel cache at a fixed place inside the checkout
    os.environ["TRITON_CACHE_DIR"] = os.path.join(BUILD, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(BUILD,
                                                      "torch_extensions")
    sys.path.insert(0, ROOT)
    from benchmark import spec as S

    spec = S.load_spec()
    chips = S.cell(spec, args.workload)["workload"]["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"{args.workload} needs {chips} CUDA card(s); this machine has "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            f": no result")
        return 2
    out = run_cell(spec, args.workload, args.seed, args.seconds,
                   bool(args.trace))
    line = json.dumps(out)
    _refuse_forbidden()
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
