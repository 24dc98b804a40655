"""Self-contained demo: the proxy, an in-memory kube upstream, and the
sample rule set — zero external dependencies.

``python -m spicedb_kubeapi_proxy_tpu_torch.proxy.demo [--device cpu]``
serves on 127.0.0.1:8080 with header authentication, its engine on
``--device`` (``cuda`` by default: a missing card is an error, never a
fallback). This is the reference's ``mage dev:up`` + ``dev:run``
developer flow (magefiles/dev.go:43-101) with the kind cluster replaced
by an in-process upstream, so the authorize/filter/dual-write loop can be
exercised with nothing but curl:

    curl -s -H 'X-Remote-User: alice' \\
        http://127.0.0.1:8080/api/v1/namespaces        # sees: dev
    curl -s -H 'X-Remote-User: carol' \\
        http://127.0.0.1:8080/api/v1/namespaces        # sees: prod
    curl -s -X POST -H 'X-Remote-User: alice' \\
        -H 'Content-Type: application/json' \\
        -d '{"metadata": {"name": "mine"}}' \\
        http://127.0.0.1:8080/api/v1/namespaces        # dual-write

The counterpart of the JAX package's ``proxy/demo.py``.
"""

from __future__ import annotations

import asyncio
from typing import Optional

from .inmemkube import InMemoryKube


def build(port: int = 8080, device: Optional[str] = None):
    """Wire the demo stack: engine + rules + upstream + seeded state, the
    engine on ``device`` (None = cuda). Returns the completed config
    (``await cfg.run()`` to serve)."""
    import os

    from ..engine import CheckItem, WriteOp
    from ..models.tuples import parse_relationship
    from .options import Options

    root = os.path.join(os.path.dirname(__file__), "..", "..")
    upstream = InMemoryKube()
    opts = Options(
        rule_files=[os.path.join(root, "deploy", "rules.yaml")],
        bootstrap_files=[os.path.join(root, "deploy", "bootstrap.yaml")],
        upstream=upstream,
        device=device,
        bind_host="127.0.0.1",
        bind_port=port,
        workflow_database_path=":memory:",
    )
    cfg = opts.complete()

    # seed: two users with disjoint worlds, as if dual-written earlier
    for ns, user in (("dev", "alice"), ("prod", "carol")):
        upstream.put("namespaces", ns)
        upstream.put("pods", "api", ns=ns)
        cfg.engine.write_relationships([
            WriteOp("touch", parse_relationship(
                f"namespace:{ns}#creator@user:{user}")),
            WriteOp("touch", parse_relationship(
                f"pod:{ns}/api#namespace@namespace:{ns}")),
            WriteOp("touch", parse_relationship(
                f"pod:{ns}/api#creator@user:{user}")),
        ])
    # compile the graph (and build the kernels on a card) before serving:
    # the first list must not pay them inside the prefilter's window
    for rtype in ("namespace", "pod"):
        cfg.engine.lookup_resources_mask(rtype, "view", "user", "alice")
    cfg.engine.check_bulk([CheckItem("namespace", "dev", "view",
                                     "user", "alice")])
    return cfg


def main(argv=None) -> int:
    import argparse
    import logging
    import signal

    ap = argparse.ArgumentParser(
        prog="spicedb-kubeapi-proxy-torch-demo", description=__doc__)
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the demo's engine (default "
                         "cuda; pass cpu to run without a card)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    cfg = build(args.port, args.device)

    async def serve():
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(sig, stop.set)
        await cfg.run()
        print(__doc__.split("curl", 1)[0].strip())
        print(f"\nserving on http://127.0.0.1:{args.port} — try:\n")
        for user, what in (("alice", "sees dev"), ("carol", "sees prod")):
            print(f"  curl -s -H 'X-Remote-User: {user}' "
                  f"http://127.0.0.1:{args.port}/api/v1/namespaces"
                  f"   # {what}")
        print(f"  curl -s -X POST -H 'X-Remote-User: alice' "
              f"-H 'Content-Type: application/json' "
              f"-d '{{\"metadata\": {{\"name\": \"mine\"}}}}' "
              f"http://127.0.0.1:{args.port}/api/v1/namespaces"
              f"   # dual-write")
        await stop.wait()
        await cfg.server.stop()
        await cfg.workflow.shutdown()

    asyncio.run(serve())
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
