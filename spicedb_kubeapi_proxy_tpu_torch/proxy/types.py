"""HTTP request/response abstractions shared by the authz middleware, the
asyncio server, the in-memory transport, and the fake upstream.

The reference plumbs net/http types end-to-end; here the middleware operates
on these small dataclasses so the same authorization/filtering logic runs
identically under the socket server, the in-memory embedded transport
(reference pkg/inmemory), and tests.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import AsyncIterator, Awaitable, Callable, Optional

from ..rules.input import RequestInfo, UserInfo


@dataclass
class ProxyRequest:
    method: str
    path: str  # path only, no query
    query: dict[str, list[str]] = field(default_factory=dict)
    headers: dict[str, str] = field(default_factory=dict)
    body: bytes = b""
    user: Optional[UserInfo] = None
    request_info: Optional[RequestInfo] = None

    def query_get(self, key: str, default: str = "") -> str:
        v = self.query.get(key)
        return v[0] if v else default

    @property
    def uri(self) -> str:
        if not self.query:
            return self.path
        parts = []
        for k, vs in self.query.items():
            for v in vs:
                parts.append(f"{k}={v}" if v != "" else k)
        return self.path + "?" + "&".join(parts)


@dataclass
class ProxyResponse:
    status: int = 200
    headers: dict[str, str] = field(default_factory=dict)
    body: bytes = b""
    # streaming responses (watch): async iterator of raw frame bytes; when
    # set, `body` is ignored and frames are written as they arrive
    stream: Optional[AsyncIterator[bytes]] = None

    @property
    def content_type(self) -> str:
        for k, v in self.headers.items():
            if k.lower() == "content-type":
                return v
        return ""


# An upstream is anything that can serve a ProxyRequest: the real
# kube-apiserver via the HTTP client, or the in-process fake used by tests
# (the envtest role in the reference e2e suite).
Upstream = Callable[[ProxyRequest], Awaitable[ProxyResponse]]


def json_response(status: int, obj) -> ProxyResponse:
    import json

    return ProxyResponse(
        status=status,
        headers={"Content-Type": "application/json"},
        body=json.dumps(obj).encode(),
    )


def kube_status(status: int, message: str, reason: str = "") -> ProxyResponse:
    """A kubernetes Status object response."""
    return json_response(status, {
        "kind": "Status",
        "apiVersion": "v1",
        "metadata": {},
        "status": "Failure" if status >= 400 else "Success",
        "message": message,
        "reason": reason,
        "code": status,
    })
