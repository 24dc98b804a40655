"""In-memory kube-apiserver implementing the Upstream interface.

One implementation, two consumers: the test suite's FakeKube (which adds
failure injection on top — the role envtest's real apiserver plays in
the reference e2e suite, e2e/util_test.go:65-102) and the self-contained
demo (`proxy/demo.py`, the reference's `mage dev:up` flow without a kind
cluster). CRUD + list + merge-patch + watch over JSON resources; content
shape follows kube conventions (kind lists, Status errors,
resourceVersion).

ownerReference garbage collection (reference e2e exercises a REAL kube
GC controller over cascading deletes, e2e/e2e_test.go:156-186): objects
get a uid at create; deleting an owner schedules a BACKGROUND cascade —
dependents whose ownerReferences all dangle are deleted (recursively,
honoring finalizers); ``propagationPolicy=Orphan`` strips the deleted
owner's references instead. Foreground propagation is approximated as
background (the fake has no blocking foreground finalizer).
"""

from __future__ import annotations

import asyncio
import json

from . import kubeproto
from .requestinfo import parse_request_info
from .types import ProxyRequest, ProxyResponse, json_response, kube_status


def kind_for(resource: str) -> str:
    singular = resource[:-1] if resource.endswith("s") else resource
    return "".join(p.capitalize() for p in singular.split("-"))


def _strip_directives(v):
    """Remove strategic-merge $patch directives from a value being
    stored verbatim (the replace fallback when a list isn't mergeable by
    name) — the real apiserver never persists directives."""
    if isinstance(v, dict):
        return {k: _strip_directives(x) for k, x in v.items()
                if k != "$patch"}
    if isinstance(v, list):
        return [_strip_directives(x) for x in v
                if not (isinstance(x, dict) and x.get("$patch") == "delete")]
    return v


class InMemoryKube:
    def __init__(self):
        # (resource, namespace, name) -> object dict
        self.objects: dict[tuple, dict] = {}
        self.rv = 0
        self._watchers: list[tuple[str, str, asyncio.Queue]] = []
        # deletion propagation intent remembered across a finalizer wait
        self._pending_gc_policy: dict[tuple, str] = {}

    # -- seeding -------------------------------------------------------------

    def put(self, resource: str, name: str, ns: str = "",
            obj: dict | None = None) -> dict:
        """Seed an object directly (demo/test setup), notifying watchers."""
        obj = dict(obj or {})
        obj.setdefault("apiVersion", "v1")
        obj.setdefault("kind", kind_for(resource))
        meta = obj.setdefault("metadata", {})
        meta["name"] = name
        if ns:
            meta["namespace"] = ns
        self.rv += 1
        meta["resourceVersion"] = str(self.rv)
        self.objects[(resource, ns, name)] = obj
        self._notify(resource, ns, {"type": "ADDED", "object": obj})
        return obj

    # -- upstream interface --------------------------------------------------

    async def __call__(self, req: ProxyRequest) -> ProxyResponse:
        # the dual-write workflow replays raw requests without a parsed
        # request_info (dtx/activity.py write_to_kube)
        info = req.request_info or parse_request_info(
            req.method, req.path, req.query)
        if not info.is_resource_request:
            if info.path.startswith(("/api", "/apis", "/openapi", "/version")):
                return json_response(200, {"kind": "APIVersions",
                                           "versions": ["v1"]})
            return kube_status(404, "not found")
        res, ns, name = info.resource, info.namespace, info.name
        if info.verb == "get":
            obj = self.objects.get((res, ns, name))
            if obj is None:
                return kube_status(404, f'{res} "{name}" not found', "NotFound")
            return json_response(200, obj)
        if info.verb == "list" or info.verb == "watch":
            if info.verb == "watch":
                bookmarks = (req.query.get("allowWatchBookmarks") or
                             ["false"])[0] in ("true", "1", "True")
                accept = next((v for k, v in req.headers.items()
                               if k.lower() == "accept"), "")
                return self._start_watch(
                    res, ns, bookmarks=bookmarks,
                    proto="protobuf" in accept.lower())
            items = [o for (r, n_, _), o in sorted(self.objects.items())
                     if r == res and (not ns or n_ == ns)]
            return json_response(200, {
                "kind": kind_for(res) + "List",
                "apiVersion": "v1",
                "metadata": {"resourceVersion": str(self.rv)},
                "items": items,
            })
        if info.verb == "create":
            try:
                obj = json.loads(req.body)
            except ValueError:
                return kube_status(400, "invalid body")
            if not isinstance(obj, dict):
                return kube_status(400, "body must be an object")
            name = (obj.get("metadata") or {}).get("name", "")
            if not name:
                return kube_status(400, "name required")
            key = (res, ns, name)
            if key in self.objects:
                return kube_status(409, f'{res} "{name}" already exists',
                                   "AlreadyExists")
            self.rv += 1
            if not isinstance(obj.get("metadata"), dict):
                obj["metadata"] = {"name": name}
            obj["metadata"]["resourceVersion"] = str(self.rv)
            # kube stamps a uid at create; the GC matches owner refs on it
            obj["metadata"].setdefault("uid", f"uid-{self.rv}")
            if ns:
                obj["metadata"]["namespace"] = ns
            obj.setdefault("kind", kind_for(res))
            self.objects[key] = obj
            self._notify(res, ns, {"type": "ADDED", "object": obj})
            return json_response(201, obj)
        if info.verb == "update":
            key = (res, ns, name)
            if key not in self.objects:
                return kube_status(404, f'{res} "{name}" not found', "NotFound")
            try:
                obj = json.loads(req.body)
            except ValueError:
                return kube_status(400, "invalid body")
            if not isinstance(obj, dict):
                return kube_status(400, "body must be an object")
            # optimistic concurrency: a stale resourceVersion in the body
            # is a genuine 409 Conflict (real apiserver semantics — the
            # dual-write path must cope with conflicts the FAKE detects,
            # not only injected ones)
            sent_rv = (obj.get("metadata") or {}).get("resourceVersion")
            cur_rv = (self.objects[key].get("metadata") or {}) \
                .get("resourceVersion")
            if sent_rv and cur_rv and sent_rv != cur_rv:
                return kube_status(
                    409,
                    f'Operation cannot be fulfilled on {res} "{name}": '
                    "the object has been modified; please apply your "
                    "changes to the latest version and try again",
                    "Conflict")
            self.rv += 1
            obj.setdefault("metadata", {})["resourceVersion"] = str(self.rv)
            self.objects[key] = obj
            self._notify(res, ns, {"type": "MODIFIED", "object": obj})
            return self._finalize_if_cleared(key, obj) \
                or json_response(200, obj)
        if info.verb == "patch":
            key = (res, ns, name)
            if key not in self.objects:
                return kube_status(404, f'{res} "{name}" not found', "NotFound")
            try:
                patch = json.loads(req.body)
            except ValueError:
                return kube_status(400, "invalid patch body", "BadRequest")
            if not isinstance(patch, dict):
                return kube_status(
                    415, "only merge/strategic-merge patch objects "
                         "supported", "BadRequest")
            ctype = next((v for k, v in req.headers.items()
                          if k.lower() == "content-type"), "")
            strategic = "strategic-merge-patch" in ctype
            obj = json.loads(json.dumps(self.objects[key]))

            def merge(dst, src):
                # JSON Merge Patch (RFC 7386): null deletes the key.
                # Strategic-merge additionally merges LISTS OF OBJECTS by
                # their "name" key (the dominant patchMergeKey in kube
                # schemas; the real apiserver consults the type's openapi
                # — this fake approximates the common convention) and
                # honors $patch: delete directives.
                for k, v in src.items():
                    if v is None:
                        dst.pop(k, None)
                    elif isinstance(v, dict) and isinstance(dst.get(k), dict):
                        merge(dst[k], v)
                    elif strategic and isinstance(v, list) \
                            and isinstance(dst.get(k), list) \
                            and all(isinstance(x, dict) and "name" in x
                                    for x in v + dst[k]):
                        by_name = {x["name"]: x for x in dst[k]}
                        for x in v:
                            if x.get("$patch") == "delete":
                                by_name.pop(x["name"], None)
                            elif x["name"] in by_name:
                                merge(by_name[x["name"]], x)
                            else:
                                by_name[x["name"]] = x
                        dst[k] = list(by_name.values())
                    else:
                        dst[k] = _strip_directives(v) if strategic else v

            merge(obj, patch)
            self.rv += 1
            obj.setdefault("metadata", {})["resourceVersion"] = str(self.rv)
            self.objects[key] = obj
            self._notify(res, ns, {"type": "MODIFIED", "object": obj})
            return self._finalize_if_cleared(key, obj) \
                or json_response(200, obj)
        if info.verb == "delete":
            key = (res, ns, name)
            obj = self.objects.get(key)
            if obj is None:
                return kube_status(404, f'{res} "{name}" not found', "NotFound")
            meta = obj.setdefault("metadata", {})
            if meta.get("finalizers"):
                # kube finalizer semantics: the object is not removed —
                # it gains deletionTimestamp and waits for controllers to
                # clear the finalizers; DELETE returns the terminating
                # object, not a Status
                if not meta.get("deletionTimestamp"):
                    import datetime

                    meta["deletionTimestamp"] = datetime.datetime.now(
                        datetime.timezone.utc).strftime(
                            "%Y-%m-%dT%H:%M:%SZ")
                    # remember the propagation intent across the
                    # finalizer wait (kube records it as an orphan/
                    # foreground finalizer) so the eventual GC honors it
                    self._pending_gc_policy[key] = \
                        self._propagation_policy(req)
                    self.rv += 1
                    meta["resourceVersion"] = str(self.rv)
                    self._notify(res, ns,
                                 {"type": "MODIFIED", "object": obj})
                return json_response(200, obj)
            self.objects.pop(key, None)
            self.rv += 1
            self._notify(res, ns, {"type": "DELETED", "object": obj})
            self._schedule_gc(obj, self._propagation_policy(req))
            return json_response(200, {"kind": "Status", "status": "Success",
                                       "code": 200})
        return kube_status(405, f"verb {info.verb} not supported")

    def _finalize_if_cleared(self, key: tuple, obj: dict):
        """A terminating object whose last finalizer was just removed is
        deleted for real (what the apiserver does when a controller
        clears its finalizer)."""
        meta = obj.get("metadata") or {}
        if meta.get("deletionTimestamp") and not meta.get("finalizers"):
            res, ns, _ = key
            self.objects.pop(key, None)
            self.rv += 1
            self._notify(res, ns, {"type": "DELETED", "object": obj})
            self._schedule_gc(obj,
                              self._pending_gc_policy.pop(key, "Background"))
            return json_response(200, obj)
        return None

    # -- ownerReference garbage collection -----------------------------------

    @staticmethod
    def _propagation_policy(req: ProxyRequest) -> str:
        """DeleteOptions propagationPolicy, from the query or the DELETE
        body (both places kube accepts it); default Background."""
        q = (req.query.get("propagationPolicy") or [None])[0]
        if q:
            return q
        if req.body:
            try:
                opts = json.loads(req.body)
                if isinstance(opts, dict) and opts.get("propagationPolicy"):
                    return opts["propagationPolicy"]
            except ValueError:
                pass
        return "Background"

    def _schedule_gc(self, owner: dict, policy: str = "Background") -> None:
        """Run the GC pass for a just-removed owner in the BACKGROUND
        (kube's GC is a controller, not part of the DELETE request);
        without a running loop (direct sync use) it runs inline."""
        try:
            asyncio.get_running_loop().create_task(
                self._gc_cascade(owner, policy))
        except RuntimeError:
            # no event loop: degenerate to synchronous collection
            for step in self._gc_steps(owner, policy):
                step()

    async def _gc_cascade(self, owner: dict, policy: str) -> None:
        await asyncio.sleep(0)  # after the DELETE response is written
        for step in self._gc_steps(owner, policy):
            step()
            await asyncio.sleep(0)  # one watch-visible step at a time

    def _gc_steps(self, owner: dict, policy: str):
        """Yield thunks, one per dependent action. A dependent is
        collected only when ALL of its ownerReferences dangle (kube GC
        semantics); Orphan strips the deleted owner's reference
        instead of deleting."""
        okind = owner.get("kind") or ""
        ometa = owner.get("metadata") or {}
        oname, ouid = ometa.get("name") or "", ometa.get("uid")
        ons = ometa.get("namespace") or ""
        for key, obj in list(self.objects.items()):
            if self.objects.get(key) is not obj:
                continue  # already collected by a recursive step
            res, ns, name = key
            meta = obj.get("metadata") or {}
            refs = meta.get("ownerReferences") or []
            mine = [r for r in refs
                    if r.get("kind") == okind and r.get("name") == oname
                    and (not r.get("uid") or not ouid
                         or r.get("uid") == ouid)
                    # namespaced dependents reference same-namespace or
                    # cluster-scoped owners (kube invariant)
                    and (not ons or ns == ons)]
            if not mine:
                continue
            if policy == "Orphan":
                yield self._gc_orphan_step(key, obj, mine)
                continue
            others = [r for r in refs if r not in mine]
            if any(self._owner_exists(r, ns) for r in others):
                continue  # a living owner still holds it
            yield self._gc_delete_step(key, obj)

    def _owner_exists(self, ref: dict, dependent_ns: str) -> bool:
        kind, name = ref.get("kind") or "", ref.get("name") or ""
        for (res, ns, n), o in self.objects.items():
            if n == name and o.get("kind") == kind \
                    and ns in ("", dependent_ns):
                if ref.get("uid") and (o.get("metadata") or {}).get("uid") \
                        and ref["uid"] != o["metadata"]["uid"]:
                    continue
                return True
        return False

    def _gc_orphan_step(self, key, obj, refs_to_strip):
        def step():
            if self.objects.get(key) is not obj:
                return
            meta = obj.setdefault("metadata", {})
            meta["ownerReferences"] = [
                r for r in meta.get("ownerReferences") or []
                if r not in refs_to_strip]
            if not meta["ownerReferences"]:
                del meta["ownerReferences"]
            self.rv += 1
            meta["resourceVersion"] = str(self.rv)
            self._notify(key[0], key[1], {"type": "MODIFIED", "object": obj})
        return step

    def _gc_delete_step(self, key, obj):
        def step():
            if self.objects.get(key) is not obj:
                return
            res, ns, _ = key
            meta = obj.setdefault("metadata", {})
            if meta.get("finalizers"):
                # finalized dependents terminate, they don't vanish
                if not meta.get("deletionTimestamp"):
                    import datetime

                    meta["deletionTimestamp"] = datetime.datetime.now(
                        datetime.timezone.utc).strftime(
                            "%Y-%m-%dT%H:%M:%SZ")
                    self.rv += 1
                    meta["resourceVersion"] = str(self.rv)
                    self._notify(res, ns,
                                 {"type": "MODIFIED", "object": obj})
                return
            self.objects.pop(key, None)
            self.rv += 1
            self._notify(res, ns, {"type": "DELETED", "object": obj})
            self._schedule_gc(obj)  # recurse: grandchildren
        return step

    # -- watch ---------------------------------------------------------------

    def _notify(self, res: str, ns: str, event: dict) -> None:
        for r, n_, q in self._watchers:
            if r == res and (not n_ or n_ == ns):
                q.put_nowait(event)

    def _start_watch(self, res: str, ns: str, bookmarks: bool = False,
                     proto: bool = False) -> ProxyResponse:
        q: asyncio.Queue = asyncio.Queue()
        # emit existing objects as initial ADDED events (kube semantics with
        # resourceVersion=0 watches)
        for (r, n_, _), o in sorted(self.objects.items()):
            if r == res and (not ns or n_ == ns):
                q.put_nowait({"type": "ADDED", "object": o})
        if bookmarks:
            # kube sends an initial-events-end bookmark carrying only a
            # resourceVersion; clients use it to mark their sync point
            q.put_nowait({"type": "BOOKMARK", "object": {
                "kind": kind_for(res), "apiVersion": "v1",
                "metadata": {"resourceVersion": str(self.rv)}}})
        entry = (res, ns, q)
        self._watchers.append(entry)

        def encode(ev: dict) -> bytes:
            if not proto:
                return (json.dumps(ev) + "\n").encode()
            # protobuf negotiation: length-prefixed raw WatchEvent whose
            # object rides a magic-prefixed Unknown (what a real apiserver
            # sends for Accept: application/vnd.kubernetes.protobuf);
            # the fake's object payload carries the ObjectMeta shape every
            # keying path reads (proxy/kubeproto.py)
            obj = ev.get("object") or {}
            meta = obj.get("metadata") or {}
            body = kubeproto.encode_object_meta_only(
                meta.get("name", ""), meta.get("namespace", ""))
            env = kubeproto.encode_unknown(
                obj.get("apiVersion", "v1"), obj.get("kind", ""), body)
            return kubeproto.encode_watch_frame(ev["type"], env)

        async def frames():
            try:
                while True:
                    ev = await q.get()
                    if ev is None:
                        return
                    yield encode(ev)
            finally:
                # client disconnect / generator close: stop fanning events
                # into a dead queue (long-running demos would leak)
                if entry in self._watchers:
                    self._watchers.remove(entry)

        return ProxyResponse(
            status=200,
            headers={"Content-Type": kubeproto.WATCH_CONTENT_TYPE if proto
                     else "application/json",
                     "Transfer-Encoding": "chunked"},
            stream=frames(),
        )

    def emit_watch_event(self, res: str, event_type: str, name: str,
                         ns: str = "") -> None:
        """Emit a synthetic watch event for an (existing or ad-hoc) object
        — lets tests inject upstream events without a write round trip."""
        obj = self.objects.get((res, ns, name))
        if obj is None:
            obj = {"kind": kind_for(res), "metadata": {"name": name}}
            if ns:
                obj["metadata"]["namespace"] = ns
        obj = json.loads(json.dumps(obj))  # private copy
        self.rv += 1
        obj.setdefault("metadata", {})["resourceVersion"] = str(self.rv)
        self._notify(res, ns, {"type": event_type, "object": obj})

    def emit_bookmark(self, res: str, ns: str = "") -> None:
        """Emit a BOOKMARK event to watchers (kube sends these
        periodically; tests use this to exercise the passthrough)."""
        self._notify(res, ns, {"type": "BOOKMARK", "object": {
            "kind": kind_for(res), "apiVersion": "v1",
            "metadata": {"resourceVersion": str(self.rv)}}})

    def stop_watches(self):
        for _, _, q in list(self._watchers):
            q.put_nowait(None)
        self._watchers.clear()
