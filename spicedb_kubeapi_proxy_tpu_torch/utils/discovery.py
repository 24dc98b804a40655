"""Discovery response cache: TTL + disk-backed, stale-on-error.

Mirrors the reference's disk-cached discovery RESTMapper
(the Go proxy's pkg/proxy/server.go:228-243, client-go's cached
discovery with its 10-minute default TTL): API discovery documents
(/api, /apis, /openapi, /version — the always-allowed metadata paths,
authz.go:205-207) change rarely, are requested constantly by clients, and
must not each cost an upstream round trip. Entries persist to an optional
cache directory so a restarted proxy serves discovery before its first
upstream contact; on upstream failure a stale entry is served rather than
an error (discovery staleness is benign, matching client-go semantics).
"""

from __future__ import annotations

import base64
import hashlib
import json
import os
import threading
import time
from typing import Optional

from ..proxy.types import ProxyRequest, ProxyResponse

DEFAULT_TTL = 600.0  # client-go cached discovery default (10 minutes)

# key cardinality is client-controlled (Accept values, query strings), so
# the cache is bounded: beyond this many entries the nearest-to-expiry is
# evicted (memory and disk)
MAX_ENTRIES = 128


class DiscoveryCache:
    def __init__(self, ttl: float = DEFAULT_TTL,
                 cache_dir: Optional[str] = None,
                 max_entries: int = MAX_ENTRIES):
        self.ttl = ttl
        self.cache_dir = cache_dir
        self.max_entries = max_entries
        self._lock = threading.Lock()
        # key -> (expiry unix seconds, status, headers, body)
        self._mem: dict[str, tuple[float, int, dict, bytes]] = {}
        if cache_dir:
            os.makedirs(cache_dir, exist_ok=True)

    @staticmethod
    def _key(req: ProxyRequest) -> str:
        accept = next((v for k, v in req.headers.items()
                       if k.lower() == "accept"), "")
        return hashlib.blake2s(
            f"{req.path}?{sorted(req.query.items())}|{accept}".encode()
        ).hexdigest()[:32]

    def _disk_path(self, key: str) -> Optional[str]:
        if not self.cache_dir:
            return None
        return os.path.join(self.cache_dir, f"{key}.json")

    def _load(self, key: str):
        with self._lock:
            ent = self._mem.get(key)
        if ent is not None:
            return ent
        path = self._disk_path(key)
        if path and os.path.exists(path):
            try:
                with open(path) as f:
                    d = json.load(f)
                ent = (d["expiry"], d["status"], d["headers"],
                       base64.b64decode(d["body_b64"]))
                with self._lock:
                    self._mem[key] = ent
                return ent
            except (OSError, ValueError, KeyError):
                return None
        return None

    def _store(self, key: str, status: int, headers: dict,
               body: bytes) -> None:
        ent = (time.time() + self.ttl, status, headers, body)
        evicted: list[str] = []
        with self._lock:
            self._mem[key] = ent
            while len(self._mem) > self.max_entries:
                victim = min(self._mem, key=lambda k: self._mem[k][0])
                del self._mem[victim]
                evicted.append(victim)
        for v in evicted:
            p = self._disk_path(v)
            if p:
                try:
                    os.unlink(p)
                except OSError:
                    pass
        path = self._disk_path(key)
        if path:
            tmp = f"{path}.tmp.{os.getpid()}"
            try:
                with open(tmp, "w") as f:
                    json.dump({
                        "expiry": ent[0], "status": status,
                        "headers": headers,
                        "body_b64": base64.b64encode(body).decode(),
                    }, f)
                os.replace(tmp, path)
            except OSError:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass

    @staticmethod
    def _replay(ent) -> ProxyResponse:
        _, status, headers, body = ent
        return ProxyResponse(status=status, headers=dict(headers), body=body)

    async def serve(self, req: ProxyRequest, upstream) -> ProxyResponse:
        """Fresh cache hit -> cached response; miss/expired -> upstream
        (2xx responses cached); upstream failure -> stale entry if any."""
        key = self._key(req)
        ent = self._load(key)
        now = time.time()
        if ent is not None and ent[0] > now:
            return self._replay(ent)
        # request identity encoding: a cached body is replayed to clients
        # with arbitrary Accept-Encoding, so it must never be compressed
        req.headers = {k: v for k, v in req.headers.items()
                       if k.lower() != "accept-encoding"}
        try:
            resp = await upstream(req)
        except Exception:
            if ent is not None:  # serve stale over failing hard
                return self._replay(ent)
            raise
        if 200 <= resp.status < 300 and resp.stream is None:
            self._store(key, resp.status, dict(resp.headers), resp.body)
        elif ent is not None and resp.status >= 500:
            return self._replay(ent)
        return resp
