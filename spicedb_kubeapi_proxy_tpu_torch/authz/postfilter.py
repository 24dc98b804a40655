"""PostFilter: per-item bulk permission checks over list responses.

Mirrors the Go proxy's pkg/authz/postfilter.go:17-182: the recorded list
(or table) response is parsed, ONE CheckBulkPermissions request is built
covering every item x every postfilter rule, and items whose checks all
pass are kept. On the card the whole bulk is a single fixpoint pass
(engine.check_bulk), so cost is one device round trip regardless of list
size.
"""

from __future__ import annotations

import dataclasses
import json

from ..engine import CheckItem, Engine
from ..rules.compile import PostFilter
from ..rules.input import ResolveInput
from ..proxy.types import ProxyResponse, kube_status


def _item_input(input: ResolveInput, obj: dict) -> ResolveInput:
    """Per-item ResolveInput: the item's metadata drives name/namespace
    (reference postfilter.go builds per-object inputs)."""
    meta = obj.get("metadata") or {}
    name = meta.get("name") or ""
    ns = meta.get("namespace") or ""
    if input.request.resource == "namespaces":
        ns = ""
    nsname = f"{ns}/{name}" if ns else name
    return dataclasses.replace(
        input, name=name, namespace=ns, namespaced_name=nsname, object=obj,
    )


def filter_list_response(engine: Engine, post_filters: list[PostFilter],
                         input: ResolveInput,
                         resp: ProxyResponse,
                         context: dict = None) -> ProxyResponse:
    if resp.status != 200:
        return resp
    try:
        doc = json.loads(resp.body)
    except ValueError:
        return kube_status(401, "postfilter: response is not JSON")
    kind = doc.get("kind", "")
    if kind == "Table":
        entries = doc.get("rows") or []
        objs = [(row.get("object") or {}) for row in entries]
    elif kind.endswith("List"):
        entries = doc.get("items") or []
        objs = entries
    else:
        return kube_status(401, f"postfilter: unexpected kind {kind!r}")

    # one bulk check covering items x rules (postfilter.go:58-182)
    items: list[CheckItem] = []
    item_index: list[int] = []  # check index -> entry index
    for i, obj in enumerate(objs):
        per_item = _item_input(input, obj)
        for pf in post_filters:
            for rel in pf.rel.generate(per_item):
                items.append(CheckItem(
                    rel.resource_type, rel.resource_id, rel.resource_relation,
                    rel.subject_type, rel.subject_id,
                    rel.subject_relation or None,
                ))
                item_index.append(i)
    results = (engine.check_bulk(items, context=context) if context
               else engine.check_bulk(items))
    ok = [True] * len(objs)
    for ci, passed in enumerate(results):
        if not passed:
            ok[item_index[ci]] = False
    kept = [e for i, e in enumerate(entries) if ok[i]]
    if kind == "Table":
        doc["rows"] = kept
    else:
        doc["items"] = kept
    body = json.dumps(doc).encode()
    headers = dict(resp.headers)
    headers["Content-Length"] = str(len(body))
    return ProxyResponse(status=200, headers=headers, body=body)
