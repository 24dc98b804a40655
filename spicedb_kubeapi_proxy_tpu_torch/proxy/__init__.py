"""Proxy layer: HTTP types, request-info parsing, authn, server, transports.

Mirrors the reference's pkg/proxy (server/options/authn) plus the
kube-apiserver request plumbing it borrows (WithRequestInfo) and
pkg/inmemory's zero-network transport.

A copy of the JAX package's ``proxy/`` (it holds no JAX), kept here so the
port imports nothing of that package; "the reference" above is the Go
proxy. It runs in front of the port's engine.
"""

from .types import ProxyRequest, ProxyResponse, Upstream  # noqa: F401
from .requestinfo import parse_request_info  # noqa: F401
from .authn import HeaderAuthenticator, AuthenticationError  # noqa: F401
