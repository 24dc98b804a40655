"""Shared networking helpers: the ``host:port`` list grammar and the
asyncio server shutdown discipline.

``parse_endpoints`` is the one owner of the endpoint-list grammar
(``host:port,host:port,...``, bracketed IPv6 hosts allowed): the proxy's
``tcp://`` engine endpoints and every shard-map group parse through it.


Idle streaming/pooled connections (a watch with no traffic, a client's
pooled engine socket blocked in a read) never write, so their handlers
only notice a dead peer on write — and ``Server.wait_closed()`` waits
for ALL connection handlers on Python 3.12+, hanging shutdown forever.
Used by both the proxy HTTP server (proxy/server.py) and the engine
host (engine/remote.py).
"""

from __future__ import annotations

import asyncio
import logging


class EndpointError(ValueError):
    """A malformed ``host:port`` list."""


def parse_endpoints(spec: str) -> list[tuple[str, int]]:
    """``host:port,host:port,...`` -> [(host, port)] in list order (the
    index is a failover set's peer id). The error messages keep the JAX
    package's ``parse_peers`` wording, which a shard map's group errors
    carry."""
    out = []
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        host, _, port = part.rpartition(":")
        if host.startswith("[") and host.endswith("]"):
            host = host[1:-1]
        if not host or not port.isdigit() or not 0 < int(port) < 65536:
            raise EndpointError(
                f"--peers entry {part!r}: expected host:port")
        out.append((host, int(port)))
    if not out:
        raise EndpointError("--peers: at least one host:port required")
    return out


async def drain_server(server: asyncio.AbstractServer, conns: set,
                       grace: float = 2.0) -> None:
    """Close ``server`` and drain its handler tasks (``conns`` is the
    live-task set each handler registers itself in).

    - yields once so just-accepted handler tasks can register before the
      emptiness check (the accept callback creates tasks that may not
      have run yet);
    - loops until the set is EMPTY — late registrants appear during the
      grace await, so one snapshot would miss them;
    - bounds ``wait_closed()`` with a cancel sweep rather than trusting
      emptiness: a handler can still register between loop exit and the
      wait.
    """
    server.close()
    await asyncio.sleep(0)
    while conns:
        _, pending = await asyncio.wait(list(conns), timeout=grace)
        for t in pending:
            t.cancel()
        if pending:
            await asyncio.gather(*pending, return_exceptions=True)
        grace = 0.1  # later rounds only sweep late registrants
    for sweep in range(10):
        try:
            await asyncio.wait_for(server.wait_closed(), timeout=1.0)
            return
        except asyncio.TimeoutError:
            for t in list(conns):
                t.cancel()
            if conns:
                await asyncio.gather(*list(conns), return_exceptions=True)
    # A handler wedged in non-cancellable work can defeat wait_closed()
    # forever; after the sweep budget, give up rather than hang stop().
    logging.getLogger(__name__).warning(
        "drain_server: wait_closed() unresolved after 10 cancel sweeps; "
        "abandoning drain with %d handler task(s) still live", len(conns))
