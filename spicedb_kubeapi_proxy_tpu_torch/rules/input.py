"""ResolveInput: the per-request data rules evaluate against.

Mirrors the reference's input model (rules.go:231-348): name/namespace
normalization (object metadata preferred, namespace cleared for the
``namespaces`` resource), and the two evaluation data shapes — the template
data map (Bloblang shape, rules.go:521-614: body merged with object
metadata, ``resourceId`` alias) and the condition data map (CEL shape,
rules.go:467-518: ``resourceNamespace`` instead of ``namespace``).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Optional


@dataclass
class RequestInfo:
    """Parsed kube request metadata (k8s.io/apiserver request.RequestInfo)."""

    verb: str = ""
    api_group: str = ""
    api_version: str = ""
    resource: str = ""
    subresource: str = ""
    name: str = ""
    namespace: str = ""
    path: str = ""
    is_resource_request: bool = True
    label_selector: str = ""
    field_selector: str = ""


@dataclass
class UserInfo:
    name: str = ""
    uid: str = ""
    groups: list[str] = field(default_factory=list)
    extra: dict[str, list[str]] = field(default_factory=dict)


@dataclass
class ResolveInput:
    name: str
    namespace: str
    namespaced_name: str
    request: RequestInfo
    user: UserInfo
    object: Optional[dict]  # parsed body object (with metadata), if any
    body: Optional[bytes]
    headers: dict[str, str]

    @staticmethod
    def create(request: RequestInfo, user: UserInfo,
               body: Optional[bytes] = None,
               headers: Optional[dict] = None) -> "ResolveInput":
        obj: Optional[dict] = None
        if body and request.verb in ("create", "update", "patch"):
            try:
                parsed = json.loads(body)
                if isinstance(parsed, dict):
                    obj = parsed
            except (ValueError, UnicodeDecodeError):
                obj = None
        meta = (obj or {}).get("metadata") or {}
        # object metadata preferred, request fields as fallback
        # (reference rules.go:312-338)
        name = meta.get("name") or request.name
        namespace = meta.get("namespace") or request.namespace
        if request.resource == "namespaces":
            # namespace requests carry the namespace name in both fields;
            # clear it so namespaces look like other cluster-scoped objects
            namespace = ""
        namespaced_name = f"{namespace}/{name}" if namespace else name
        return ResolveInput(
            name=name,
            namespace=namespace,
            namespaced_name=namespaced_name,
            request=request,
            user=user,
            object=obj,
            body=body,
            headers=dict(headers or {}),
        )

    # -- evaluation data shapes ---------------------------------------------

    def _request_map(self) -> dict:
        return {
            "verb": self.request.verb,
            "apiGroup": self.request.api_group,
            "apiVersion": self.request.api_version,
            "resource": self.request.resource,
            "name": self.request.name,
            "namespace": self.request.namespace,
            "path": self.request.path,
            "labelSelector": self.request.label_selector,
            "fieldSelector": self.request.field_selector,
        }

    def _user_map(self) -> dict:
        return {
            "name": self.user.name,
            "uid": self.user.uid,
            "groups": list(self.user.groups),
            "extra": {k: list(v) for k, v in self.user.extra.items()},
        }

    def template_data(self) -> dict[str, Any]:
        """Template/tupleSet evaluation shape (Bloblang input,
        rules.go:521-614)."""
        data: dict[str, Any] = {
            "name": self.name,
            "namespace": self.namespace,
            "namespacedName": self.namespaced_name,
            "resourceId": self.namespaced_name,
            "headers": dict(self.headers),
            "request": self._request_map(),
            "user": self._user_map(),
        }
        if self.object is not None:
            data["object"] = self.object
            if "metadata" in self.object:
                data["metadata"] = self.object["metadata"]
        if self.body:
            try:
                data["body"] = self.body.decode("utf-8")
            except UnicodeDecodeError:
                pass
        return data

    def condition_data(self) -> dict[str, Any]:
        """`if`-condition evaluation shape (CEL input, rules.go:467-518)."""
        data: dict[str, Any] = {
            "name": self.name,
            "resourceNamespace": self.namespace,
            "namespacedName": self.namespaced_name,
            "headers": dict(self.headers),
            "request": self._request_map(),
            "user": self._user_map(),
        }
        if self.object is not None:
            data["object"] = self.object
        if self.body:
            try:
                data["body"] = self.body.decode("utf-8")
            except UnicodeDecodeError:
                pass
        return data
