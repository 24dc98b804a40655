"""Kube request-info parsing: URL path + method -> RequestInfo.

The reference mounts k8s.io/apiserver's WithRequestInfo filter
(the Go proxy's pkg/proxy/server.go:151); this is the same resolution
logic: api prefixes (/api core, /apis named groups), namespace scoping,
resource/name/subresource segments, and verb derivation from the HTTP
method (list vs get vs watch, deletecollection vs delete).
"""

from __future__ import annotations

from typing import Optional

from ..rules.input import RequestInfo

_METHOD_VERBS = {
    "GET": "get",
    "HEAD": "get",
    "POST": "create",
    "PUT": "update",
    "PATCH": "patch",
    "DELETE": "delete",
}

# paths that are never resource requests (discovery etc.)
NON_RESOURCE_PREFIXES = ("/openapi", "/version", "/healthz", "/livez",
                         "/readyz", "/metrics")


def parse_request_info(method: str, path: str,
                       query: Optional[dict] = None) -> RequestInfo:
    query = query or {}
    verb = _METHOD_VERBS.get(method.upper(), method.lower())
    info = RequestInfo(verb=verb, path=path, is_resource_request=False)
    info.label_selector = (query.get("labelSelector") or [""])[0]
    info.field_selector = (query.get("fieldSelector") or [""])[0]

    parts = [p for p in path.split("/") if p]
    if not parts:
        return info
    if path.startswith(NON_RESOURCE_PREFIXES):
        return info

    # /api/v1/... or /apis/<group>/<version>/...
    if parts[0] == "api":
        if len(parts) < 2:
            return info
        info.api_group = ""
        info.api_version = parts[1]
        rest = parts[2:]
    elif parts[0] == "apis":
        if len(parts) < 3:
            return info
        info.api_group = parts[1]
        info.api_version = parts[2]
        rest = parts[3:]
    else:
        return info

    if not rest:
        return info  # bare discovery (/api/v1)
    info.is_resource_request = True

    # namespaces/<ns>/<resource>/... except when namespaces IS the resource;
    # /namespaces/<name>/{status,finalize} are subresources OF a namespace
    # (k8s RequestInfo special case), not namespaced resources
    if rest[0] == "namespaces" and len(rest) == 3 and \
            rest[2] in ("status", "finalize"):
        info.resource = "namespaces"
        info.name = rest[1]
        info.subresource = rest[2]
        _finish_verb(info, query)
        return info
    if rest[0] == "namespaces" and len(rest) >= 3:
        info.namespace = rest[1]
        rest = rest[2:]
    elif rest[0] == "namespaces":
        # /api/v1/namespaces or /api/v1/namespaces/<name>
        info.resource = "namespaces"
        if len(rest) >= 2:
            info.name = rest[1]
        rest = rest[2:] if len(rest) >= 2 else []
        if rest:
            info.subresource = rest[0]
        _finish_verb(info, query)
        return info

    info.resource = rest[0]
    if len(rest) >= 2:
        info.name = rest[1]
    if len(rest) >= 3:
        info.subresource = rest[2]
    _finish_verb(info, query)
    return info


def _truthy_param(query: dict, key: str) -> bool:
    vals = query.get(key)
    if not vals:
        return False
    v = vals[0]
    return v in ("", "1", "true", "True")


def _finish_verb(info: RequestInfo, query: dict) -> None:
    if info.verb == "get" and not info.name:
        info.verb = "watch" if _truthy_param(query, "watch") else "list"
    elif info.verb == "get" and _truthy_param(query, "watch"):
        info.verb = "watch"
    elif info.verb == "delete" and not info.name:
        info.verb = "deletecollection"
