#!/usr/bin/env python3
"""Time the port's two CUDA kernels across frontier densities, for one
checkout of the port.

Builds blocks of the headline pod#viewer shape on the card from a seed
(a [131,072 x 16,384] int8 block and its [131,072 x 512] int32 bit dual,
9,900,000 random pod-viewer edges over 100,000 pods and 10,000 users),
then runs chip_smoke.py's density sweep, its mid-size bit duals (1,024 to
32,768 rows), the ragged 4,064 x 4,000 n_b=8 5%-density bit case and the
B=64 one-hot dense case against the ``spicedb_kubeapi_proxy_tpu_torch``
package found under ``--root``, through the package's public wrappers.
Each case is checked byte-equal against the package's plain version and
timed three ways: the mean over eager launches, device time by CUDA-graph
replay and the host's time a call. The sweep helpers come from the
chip_smoke.py beside this tool, so one copy of the tool can time an older
checkout of the package (its public kernel signatures are the same)
beside this one:

    python3 tools/torch_kernel_sweep.py --root OLD --label parent
    python3 tools/torch_kernel_sweep.py --root . --label change

Prints one JSON object per case and writes them all to
``<out>/kernel_sweep_<label>.json`` (``--out``, default ``build/``).
Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_helpers", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout whose port package is timed")
    ap.add_argument("--label", default="change")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join(HERE, "build"),
                    help="directory for the JSON results")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_sweep: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from spicedb_kubeapi_proxy_tpu_torch.ops import bitprop

    if not os.path.abspath(bitprop.__file__).startswith(root + os.sep):
        print(f"torch_kernel_sweep: the package did not come from {root}",
              file=sys.stderr)
        return 2
    sm = _smoke()
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    sm.log(f"sweep {args.label}: package {root}; {smi}")

    n_dst, n_src, n_edges = 131_072, 16_384, 9_900_000
    g = torch.Generator(device=dev)
    g.manual_seed(args.seed)
    dst = torch.randint(0, 100_000, (n_edges,), generator=g, device=dev)
    src = torch.randint(0, 10_000, (n_edges,), generator=g, device=dev)
    A = torch.zeros((n_dst, n_src), dtype=torch.int8, device=dev)
    A[dst, src] = 1
    bits = bitprop.pack_block(dst, src, n_dst, n_src)
    del dst, src
    torch.cuda.synchronize()

    rows = [dict(r, label=args.label)
            for r in sm.sweep(torch, bitprop, bits, A, dev, args.seed + 11)]
    for n_rows, a, vb, nb, n_live in sm.mid_duals(
            torch, bitprop, dev, np.random.default_rng(args.seed + 13)):
        rows.append(dict(sm.time_bit(torch, bitprop, a, vb, nb,
                                     f"mid-size {n_live} live words",
                                     plain_reps=1),
                         kernel="bit_or_matmul",
                         case=f"mid {n_rows} rows, {n_live} words",
                         label=args.label))
    rng = np.random.default_rng(args.seed + 7)
    a, vb, nb = sm.ragged_bits(torch, bitprop, rng, dev, 4064, 4000, 8)
    rows.append(dict(sm.time_bit(torch, bitprop, a, vb, nb,
                                 "ragged 5% density"),
                     kernel="bit_or_matmul", case="ragged 4064x4000 n_b=8",
                     label=args.label))
    users = rng.choice(10_000, 64, replace=False)
    f64 = sm.one_hot_frontier(torch, users.tolist(), n_src, dev)
    rows.append(dict(sm.time_dense(torch, bitprop, A, f64, dev,
                                   "one-hot B=64", plain_reps=1),
                     kernel="dense_or_matmul", case="one-hot B=64",
                     label=args.label))
    for r in rows:
        print(json.dumps(r))
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"kernel_sweep_{args.label}.json"),
              "w") as fh:
        json.dump({"device": smi, "root": root, "rows": rows}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
