"""In-memory transport: invoke the proxy handler chain with zero network.

Mirrors the Go proxy's pkg/inmemory/transport.go:18-137: a client whose
"round trip" calls the handler directly. Used for embedded-mode clients
(reference README's "sub-microsecond" path) and benchmarks.
"""

from __future__ import annotations

import json
from typing import Optional

from .types import ProxyRequest, ProxyResponse


class InMemoryClient:
    """A minimal kube-ish client over a handler callable."""

    def __init__(self, handler, user: Optional[str] = None,
                 groups: Optional[list] = None):
        self.handler = handler  # async (ProxyRequest) -> ProxyResponse
        self.user = user
        self.groups = groups or []

    def _headers(self, extra: Optional[dict] = None) -> dict:
        h = {"Content-Type": "application/json"}
        if self.user:
            # embedded-mode identity headers (reference authn.go:78-119,
            # authHeaderTransport server.go:363-389)
            h["X-Remote-User"] = self.user
            if self.groups:
                h["X-Remote-Group"] = ",".join(self.groups)
        if extra:
            h.update(extra)
        return h

    async def request(self, method: str, path: str, body=None,
                      query: Optional[dict] = None,
                      headers: Optional[dict] = None) -> ProxyResponse:
        return await self.handler(ProxyRequest(
            method=method,
            path=path,
            query=query or {},
            headers=self._headers(headers),
            body=(json.dumps(body).encode() if isinstance(body, (dict, list))
                  else (body or b"")),
        ))

    async def get(self, path: str, **kw) -> ProxyResponse:
        return await self.request("GET", path, **kw)

    async def post(self, path: str, body, **kw) -> ProxyResponse:
        return await self.request("POST", path, body=body, **kw)

    async def put(self, path: str, body, **kw) -> ProxyResponse:
        return await self.request("PUT", path, body=body, **kw)

    async def delete(self, path: str, **kw) -> ProxyResponse:
        return await self.request("DELETE", path, **kw)
