"""The shard map: consistent-hash partitioning of the relationship space.

A copy of the JAX package's ``scaleout/shardmap.py``: the consistent
hash is byte-identical, so both packages route every tuple to the same
group. Scale-out partitions TUPLES, not replicas: each engine *group*
(its own failover set of engine hosts, in the ``host:port`` list
grammar of utils/net.py) owns a slice of the relationship space, so
capacity grows by adding shards instead of mirrors. The partition key
is
``(namespace, resource-type)``:

- **namespaced** tuples — resource ids of the kube ``ns/name`` shape —
  hash by the namespace portion plus the resource type onto exactly one
  group (the blocked decomposition RedisGraph/GraphBLAS applies to
  matrix tiles, applied here at the cluster level);
- **global** tuples — bare resource ids with no ``/`` (namespaces
  themselves, groups, dtx lock tuples, workflow markers) — REPLICATE to
  every group. They are the reference data cross-namespace reachability
  walks through (``pod -> namespace -> viewer``, ``viewer ->
  group#member``); replicating them keeps every query's closure inside
  one shard, which is what makes single-shard checks exact and
  scatter-gather a plain union.

The map is an EXPLICIT, versioned artifact the proxy loads from a flag
or file — routing is deterministic and testable, never discovered. A
rebalance is a new map version; the version rides ``/readyz`` and the
split-write journal so a mixed-version fleet is visible.

``RevisionVector`` is the consistency token of a sharded deployment: one
revision per group, totally ordered along any one planner's history
(components only advance). Decision-cache keys and watch resumption
carry the vector, never a scalar.
"""

from __future__ import annotations

import hashlib
import json
import os
from bisect import bisect_right
from dataclasses import dataclass
from typing import Optional


class ShardMapError(ValueError):
    pass


class RevisionVector(tuple):
    """One store revision per shard group. A plain-tuple subclass so it
    JSON-serializes (as a list), hashes (cache keys), and totally orders
    lexicographically — which agrees with the causal partial order along
    any monotone stream (components never go backward, so of two vectors
    observed on one stream the later one is component-wise >=)."""

    __slots__ = ()

    @classmethod
    def zero(cls, n: int) -> "RevisionVector":
        return cls((0,) * n)

    def bump(self, shard: int, revision: int) -> "RevisionVector":
        """This vector with ``shard``'s component advanced to
        ``revision`` (never regressed)."""
        return RevisionVector(
            max(int(revision), c) if i == shard else c
            for i, c in enumerate(self))

    def join(self, other) -> "RevisionVector":
        """Component-wise max — the merge point of two observations."""
        return RevisionVector(max(a, b) for a, b in zip(self, other))

    def dominates(self, other) -> bool:
        """True iff every component is >= ``other``'s."""
        return all(a >= b for a, b in zip(self, other))

    def extend(self, n: int) -> "RevisionVector":
        """This vector padded with zero components up to length ``n`` —
        the grow-transition translation: a brand-new group's history
        starts empty, so a token minted before the group existed resumes
        it from revision 0 (the rebalance event filter suppresses the
        copy/catch-up records below the cutover watermark)."""
        if n <= len(self):
            return self
        return RevisionVector(tuple(self) + (0,) * (n - len(self)))

    def drop_component(self, shard: int) -> "RevisionVector":
        """This vector with ``shard``'s component REMOVED — the
        shrink-transition translation, dual to :meth:`extend`: once a
        retiring group's slices have all cut over and its copies are
        GC'd, the group's history is closed and surviving components
        renumber down by one past the gap. Only valid when the dropped
        component's consumer has already observed everything the
        retiring group will ever produce (the planner checks the token
        against the transition's cut watermark before translating)."""
        if not 0 <= shard < len(self):
            raise ShardMapError(
                f"cannot drop component {shard} from a "
                f"{len(self)}-component revision vector")
        return RevisionVector(tuple(self)[:shard]
                              + tuple(self)[shard + 1:])

    def encode(self, map_version: Optional[int] = None) -> str:
        """``v1.2.3`` — or ``v1.2.3@m4`` when ``map_version`` is given:
        the shard-map version the component INDICES were minted under.
        Component *i* only names a group under one map; a token resumed
        against a different map must be translated (rebalance) or
        rejected, never silently re-bound to whatever group now sits at
        index *i*."""
        body = "v" + ".".join(str(int(c)) for c in self)
        if map_version is not None:
            return f"{body}@m{int(map_version)}"
        return body

    @classmethod
    def parse_versioned(cls, s) -> tuple["RevisionVector", Optional[int]]:
        """``(vector, minted_map_version-or-None)`` — the version a
        string token carries (``@m<V>`` suffix); sequences and untagged
        strings parse with version ``None`` (provenance unknown)."""
        if isinstance(s, RevisionVector):
            return s, None
        if isinstance(s, int):
            raise ShardMapError(
                "a scalar revision needs a shard count; use "
                "RevisionVector.zero(n).bump(...) or pass a vector")
        if isinstance(s, (list, tuple)):
            return cls(int(c) for c in s), None
        t = str(s).strip()
        ver = None
        if "@m" in t:
            t, _, vtext = t.partition("@m")
            try:
                ver = int(vtext)
            except ValueError:
                raise ShardMapError(
                    f"invalid revision vector {s!r}") from None
        if not t.startswith("v"):
            raise ShardMapError(f"invalid revision vector {s!r}")
        try:
            return cls(int(c) for c in t[1:].split(".")), ver
        except ValueError:
            raise ShardMapError(
                f"invalid revision vector {s!r}") from None

    @classmethod
    def parse(cls, s, map_version: Optional[int] = None
              ) -> "RevisionVector":
        """Accepts an ``encode()`` string, a sequence, or a plain int
        (a scalar resumption token: every component starts there).
        ``map_version`` is the consumer's CURRENT shard-map version:
        a token tagged with a different version is REJECTED instead of
        silently binding components to the wrong group index (a 2-group
        vector resumed against a 3-group map would misindex — re-list,
        or let the planner translate it through a known transition)."""
        vec, ver = cls.parse_versioned(s)
        if map_version is not None and ver is not None \
                and ver != int(map_version):
            raise ShardMapError(
                f"revision vector {s!r} was minted under shard-map "
                f"version {ver}, not the current version "
                f"{int(map_version)}; its components would bind to the "
                "wrong groups — re-list and re-watch")
        return vec


def split_resource(resource_id: str) -> tuple[str, bool]:
    """``(namespace, namespaced?)`` of a resource id: the kube
    ``ns/name`` convention carries the namespace before the first slash;
    a bare id is a GLOBAL object (cluster-scoped — replicated to every
    group)."""
    if "/" in resource_id:
        return resource_id.split("/", 1)[0], True
    return "", False


def _hash32(key: str) -> int:
    return int.from_bytes(
        hashlib.blake2s(key.encode("utf-8"), digest_size=4).digest(),
        "big")


HASH_SPACE = 1 << 32


def hash_key(namespace: str, resource_type: str) -> int:
    """The partition-key hash the ring routes by — exported so the
    rebalance planner and the engine-host slice ops agree byte-for-byte
    on slice membership."""
    return _hash32(f"{namespace}\x00{resource_type}")


@dataclass(frozen=True)
class ShardMap:
    """Versioned, deterministic tuple-space partition.

    ``groups`` is a tuple of endpoint lists — one list per engine group,
    each list the group's failover set in peer-id order (the same grammar
    as ``--engine-endpoint tcp://h1:p1,h2:p2``). ``virtual_nodes`` sets
    the ring granularity: more points smooth the key distribution at the
    cost of a bigger (still tiny) ring.
    """

    version: int
    groups: tuple  # tuple[tuple[(host, port), ...], ...]
    virtual_nodes: int = 64

    def __post_init__(self):
        if self.version < 1:
            raise ShardMapError("shard map version must be >= 1")
        if not self.groups:
            raise ShardMapError("shard map needs >= 1 group")
        if self.virtual_nodes < 1:
            raise ShardMapError("virtual_nodes must be >= 1")
        # the ring: virtual_nodes points per group, keyed by GROUP INDEX
        # (not endpoints) so replacing a dead host inside a group never
        # moves any data — only adding/removing whole groups does
        points = []
        for gi in range(len(self.groups)):
            for r in range(self.virtual_nodes):
                points.append((_hash32(f"group{gi}:vn{r}"), gi))
        points.sort()
        object.__setattr__(self, "_ring_keys",
                           tuple(p[0] for p in points))
        object.__setattr__(self, "_ring_groups",
                           tuple(p[1] for p in points))

    @property
    def n_groups(self) -> int:
        return len(self.groups)

    def shard_for(self, namespace: str, resource_type: str) -> int:
        """The owning group of a ``(namespace, resource-type)`` key —
        clockwise successor on the hash ring."""
        return self.owner_of_hash(hash_key(namespace, resource_type))

    def owner_of_hash(self, h: int) -> int:
        """Owning group of a raw partition-key hash (the rebalance
        planner diffs two maps' assignments segment-by-segment)."""
        keys = self._ring_keys
        i = bisect_right(keys, h)
        if i == len(keys):
            i = 0
        return self._ring_groups[i]

    def ring_points(self) -> tuple:
        """The sorted ring-point hashes (segment boundaries for the
        rebalance plan diff)."""
        return self._ring_keys

    def shard_of(self, resource_type: str, resource_id: str):
        """Owning group index for one tuple/query anchor, or ``None``
        when the object is GLOBAL (replicated to every group)."""
        ns, namespaced = split_resource(resource_id)
        if not namespaced:
            return None
        return self.shard_for(ns, resource_type)

    def anchor_shard(self, resource_type: str, resource_id: str) -> int:
        """A deterministic SINGLE group to answer a read anchored at one
        object: the owning shard for namespaced objects; for global
        objects (replicated everywhere) the hash of the bare id — so
        repeated reads of one object land on one group (warm caches)
        while distinct global objects spread the load."""
        owner = self.shard_of(resource_type, resource_id)
        if owner is not None:
            return owner
        return self.shard_for(resource_id, resource_type)

    def zero_vector(self) -> RevisionVector:
        return RevisionVector.zero(self.n_groups)

    def describe(self) -> str:
        return (f"version={self.version} groups={self.n_groups} "
                + " ".join(
                    f"g{i}={len(eps)}ep" for i, eps in
                    enumerate(self.groups)))


def map_to_doc(m: ShardMap) -> dict:
    """The JSON document form of a map (``map_from_doc`` is the exact
    inverse) — the rebalance transition persists its target map this
    way so a restarted planner reconstructs the same ring. Endpoints
    round-trip as raw ``[host, port]`` pairs, NOT the CLI ``host:port``
    grammar: the record is internal, and in-process test topologies
    legitimately carry port-0 placeholders the grammar rejects."""
    return {"version": m.version,
            "groups": [[[h, p] for h, p in g] for g in m.groups],
            "virtual_nodes": m.virtual_nodes}


def map_from_doc(doc: dict) -> ShardMap:
    """Inverse of :func:`map_to_doc` (internal round-trip; see there)."""
    try:
        return ShardMap(
            version=int(doc["version"]),
            groups=tuple(tuple((str(h), int(p)) for h, p in g)
                         for g in doc["groups"]),
            virtual_nodes=int(doc.get("virtual_nodes", 64)))
    except (KeyError, TypeError, ValueError):
        raise ShardMapError(
            f"malformed internal shard-map document: {doc!r}") from None


def parse_shard_map(text: str) -> ShardMap:
    """Parse the JSON shard-map document::

        {"version": 1,
         "groups": [["127.0.0.1:7001", "127.0.0.1:7002"],
                    ["127.0.0.1:7011"]],
         "virtual_nodes": 64}
    """
    try:
        doc = json.loads(text)
    except ValueError as e:
        raise ShardMapError(f"shard map is not valid JSON: {e}") from None
    return parse_shard_map_doc(doc)


def parse_shard_map_doc(doc) -> ShardMap:
    if not isinstance(doc, dict):
        raise ShardMapError("shard map must be a JSON object")
    try:
        version = int(doc["version"])
        raw_groups = doc["groups"]
    except (KeyError, TypeError, ValueError):
        raise ShardMapError(
            "shard map needs integer 'version' and list 'groups'"
        ) from None
    if not isinstance(raw_groups, list) or not raw_groups:
        raise ShardMapError("shard map 'groups' must be a non-empty list")
    from ..utils.net import EndpointError, parse_endpoints

    groups = []
    for gi, eps in enumerate(raw_groups):
        if isinstance(eps, str):
            eps = [eps]
        if not isinstance(eps, list) or not eps:
            raise ShardMapError(
                f"shard map group {gi} must be a non-empty endpoint list")
        try:
            # one owner for the host:port grammar (utils/net.py; the
            # proxy's tcp:// --engine-endpoint parses through it too)
            groups.append(tuple(parse_endpoints(",".join(
                str(e) for e in eps))))
        except EndpointError as e:
            raise ShardMapError(
                f"shard map group {gi}: {e}") from None
    try:
        vnodes = int(doc.get("virtual_nodes", 64))
    except (TypeError, ValueError):
        raise ShardMapError(
            "shard map 'virtual_nodes' must be an integer") from None
    return ShardMap(version=version, groups=tuple(groups),
                    virtual_nodes=vnodes)


def load_shard_map(spec: str) -> ShardMap:
    """``--shard-map`` value: inline JSON (starts with ``{``) or a path
    to a JSON file."""
    spec = spec.strip()
    if spec.startswith("{"):
        return parse_shard_map(spec)
    if not os.path.exists(spec):
        raise ShardMapError(f"shard map file not found: {spec}")
    with open(spec) as f:
        return parse_shard_map(f.read())
