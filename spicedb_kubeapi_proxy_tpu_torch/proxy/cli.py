"""CLI entry point (the Go proxy's cmd/spicedb-kubeapi-proxy/main.go:20-64).

``python -m spicedb_kubeapi_proxy_tpu_torch.proxy.cli --rule-file
rules.yaml --upstream-url https://kube:6443 [--device cuda|cpu] ...`` —
signal-aware serve loop. The in-process engine runs on ``--device``
(``cuda`` by default); an option the port refuses, or ``cuda`` without a
card, exits 2 with the reason.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import signal
import sys

from .options import OptionsError, add_flags, options_from_args


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="spicedb-kubeapi-proxy-torch",
        description="authorizing kube-apiserver proxy on a CUDA engine",
    )
    add_flags(parser)
    parser.add_argument("-v", "--verbosity", type=int, default=1)
    args = parser.parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbosity >= 3 else logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )
    try:
        opts = options_from_args(args)
        cfg = opts.complete()
    except OptionsError as e:
        parser.error(str(e))

    async def serve():
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(sig, stop.set)
        await cfg.run()
        logging.info("serving on %s:%d", cfg.server.host, cfg.server.port)
        await stop.wait()
        await cfg.server.stop()
        await cfg.workflow.shutdown()
        if cfg.autoscale_controller is not None:
            cfg.autoscale_controller.stop()
        if hasattr(cfg.engine, "sharding_status"):
            # sharded planner: parks a live rebalance mover (its
            # persisted transition resumes or aborts at the next boot),
            # drains the scatter pool, closes the split journal
            await asyncio.get_running_loop().run_in_executor(
                None, cfg.engine.close)
        if cfg.slo_monitor is not None:
            cfg.slo_monitor.stop()
        if cfg.deps.audit is not None:
            # drain + close the audit writer queue: the decisions
            # nearest a shutdown (deny storms before a crash-loop) are
            # exactly the ones an auditor needs — never drop them on
            # SIGTERM, never leave a torn half-written tail line
            await asyncio.get_running_loop().run_in_executor(
                None, cfg.deps.audit.close)
        if hasattr(cfg.engine, "close_compaction"):
            # stop the overlay compactor before the final snapshot /
            # checkpoint so no fold races the state capture below
            await asyncio.get_running_loop().run_in_executor(
                None, cfg.engine.close_compaction)
        if opts.snapshot_path and hasattr(cfg.engine, "save_snapshot"):
            cfg.engine.save_snapshot(opts.snapshot_path)
            logging.info("saved snapshot to %s", opts.snapshot_path)
        if opts.data_dir and hasattr(cfg.engine, "close_persistence"):
            # final checkpoint + WAL fsync (persistence/manager.py) so
            # the next boot loads one snapshot and replays nothing
            await asyncio.get_running_loop().run_in_executor(
                None, cfg.engine.close_persistence)
            logging.info("persistence closed (checkpointed %s)",
                         opts.data_dir)

    asyncio.run(serve())
    return 0


if __name__ == "__main__":
    sys.exit(main())
