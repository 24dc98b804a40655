"""Scale-out: hash-partitioned engine shards + scatter-gather planner.

A copy of the JAX package's ``scaleout/`` over the port's engine, engine
host and clients. Replication scales reads of ONE graph and the delta
overlay scales one graph's write path, but every engine group still holds
every tuple; this subsystem partitions the relationship space itself, so
a deployment whose graph outgrows one engine's memory or write rate
spreads it over several groups (several may share one card):

- ``shardmap.py`` — the explicit, versioned :class:`ShardMap`:
  consistent-hash partitioning of tuples by ``(namespace,
  resource-type)`` onto N engine groups (each group its own failover
  set), global (cluster-scoped) tuples replicated to every group so
  query closures stay shard-local; plus :class:`RevisionVector`, the
  one-revision-per-shard consistency token.
- ``planner.py`` — :class:`ShardedEngine`, the proxy-side planner:
  single-shard checks/writes route directly, LookupResources /
  list-prefilters / LookupSubjects / watch streams scatter to every
  group and gather client-side at a revision vector; partial sheds
  fail closed with Retry-After = max over shards.
- ``journal.py`` — the dtx-style :class:`SplitJournal`: cross-shard
  writes are journaled durably before the first shard applies, so a
  mid-split crash replays to completion instead of leaving a silent
  half-write; also the durable home of the live-rebalance transition
  record.
- ``rebalance.py`` — the online tuple mover: map V -> V+1 without a
  drain, via plan / copy / catch-up / dual-write / per-slice cutover /
  GC (:class:`RebalanceCoordinator`), with read-owner-only watch
  delivery keeping merged streams exact across the flip — in BOTH
  directions: a shrink (:func:`shrink_map`) empties the retiring tail
  group through the same machinery, GCs it BEFORE commit, and drops
  its revision-vector component at commit.
- ``frontier.py`` — the cross-shard frontier exchange: iterative
  membership-closure joins where only boundary tuples ride the wire,
  lifting the cluster-scoped-only restriction on cross-namespace
  reference types (monotone schemas; fail-closed round budget).
"""

from .frontier import (  # noqa: F401
    FrontierConfig,
    FrontierError,
    decode_frontier,
    encode_frontier,
    expand_local,
    reference_pairs,
)
from .journal import SplitJournal  # noqa: F401
from .planner import (  # noqa: F401
    ShardedEngine,
    ShardedWatchStream,
    ShardVectorCache,
)
from .rebalance import (  # noqa: F401
    MapTransition,
    MovingSlice,
    RebalanceCoordinator,
    RebalanceError,
    abort_transition,
    plan_moves,
    shrink_map,
)
from .shardmap import (  # noqa: F401
    RevisionVector,
    ShardMap,
    ShardMapError,
    hash_key,
    load_shard_map,
    map_to_doc,
    parse_shard_map,
    split_resource,
)
