#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU at the headline deployment.

The deployment is the repo's north-star configuration: BENCH_SCHEMA (the
kube pod/namespace/group schema of bench.py) with 100,000 pods, 10,000
users, 1,000 namespaces, 1,000 groups and 10,000,000 relationships,
rows generated from ``--seed``. Phases:

1. device: the card's name and power limit;
2. kernel build: nvcc of csrc/bitprop.cu into build/torch_kernels/;
3. bulk load, graph compile and device build of the headline store;
4. each CUDA kernel against its plain PyTorch version on the card, at
   the inputs the main path feeds the headline block, at ragged shapes,
   across a density sweep (live frontier words for the bit kernel, live
   64-byte src tiles for the dense one) and on mid-size bit duals with
   each of its paths forced (the small-dual cutoff): byte-equal, with
   kernel times (eager launches, device time by CUDA-graph replay, host
   time a call), plain and library times, the data bound and the sector
   bound;
5. the list filter: ``lookup_resources_mask("pod", "view", "user", u)``
   for 31 subjects (B=1, push: the bit kernel);
6. the bulk check: 64 subjects x 1,024 items (pull: the dense kernel);
7. the same list filters under forced pull: identical masks; then a
   torch.profiler trace of both paths (device busy time, idle share,
   each kernel's device time a call, and the kernels that take the most
   device time);
8. random checks and full masks against the host OracleEvaluator;
G. the device mesh (parallel/mesh.py, parallel/sharded.py): (a) right
   after 8, the headline engine's compiled graph at phase 5-6's state
   served through ``Engine(mesh=...)``'s ``ShardedGraph`` at three meshes
   of cells on this card, (data=1, graph=1), (1, 2) and (2, 1) (the last
   two put two cells on the one card): each build's seconds and device
   bytes, phase 5's 31 lists (p50/p99, iterations, convergence windows)
   and phase 6's 64 x 1,024 bulk check (checks/s), every mask and
   verdict byte-equal to phase 5-6's single-device answers, the
   ``dense_or_matmul`` launches (every block hop on the mesh is a pull;
   the bit kernel must not run), and the dense kernel at one cell's shard
   input (the pod#viewer shard [131,072 x 8,192] at the bulk check's
   B=16) byte-equal to its plain version with its times, bounds and
   ``torch._int_mm > 0`` beside it; (b) after R, the engine-host CLI
   with ``--distributed 127.0.0.1:<port>,1,0 --engine-mesh auto`` (a
   real NCCL world of 1 on the card, serving through
   ``Engine._backend``) on a copy of phase P's data dir: spawn -> first
   list, 10 lists over tcp:// exact against the writer's masks, 20
   write -> read-after-write pairs (``ShardedGraph.updated``), each list
   exact against the writer's mask plus the grants written, the host's
   mesh counters (one sharded build, updates, no fallback) and kernel
   launches from its log, and a clean SIGTERM shutdown;
9. the write path: (a) the first write after the bulk load and the list
   after it; (b) one warm write->read pair, then ``--writes`` pairs, each
   a write folded into the delta overlay (new pod#viewer grants,
   re-touches of base grants with an expiration, deletes of base
   pod#viewer, namespace#viewer and group#member edges) and a list
   filter: write and read-after-write p50/p99, the per-write split
   (journal, overlay append, dispatch), zero recompiles, one incremental
   update a write; (c) every touched subject's mask under auto (push) and
   forced pull, byte-equal to each other and to a columnar host reference
   (itself held against OracleEvaluator on a few subjects), and a 64 x
   1,024 bulk check over the touched pods; (d) one compaction fold
   (enable_compaction + compact) with the masks unchanged across the
   swap; (e) an overlay grant that expires 2 s ahead, visible before and
   gone after, with no write in between; (f) three write->read pairs
   with the overlay off (a recompile each, the path before the overlay),
   for comparison in the same run; (g) mixed traffic, one thread each: a
   lister and a 64 x 1,024 bulk checker, then the same with a writer
   every 10 ms as well (the proxy's dual-write load), list and write
   p50/p99 beside 9b's single-thread numbers, zero recompiles, and the
   writer's grants exact afterwards;
S. the serving front (engine/batcher.py, engine/decision_cache.py) on
   the same engine: (a) BASELINE.json's multi-tenant shape, 256 list
   filters for 256 distinct users from 32 threads, with batching off,
   on (window 2 ms, max_rows 8) and on with the decision cache, and one
   thread in turn as a yardstick: lists/s,
   p50/p99 a list, fused dispatches a list, iterations, the submit time
   of the fillers (the thread whose submit fills a batch runs the fused
   fixpoint), the bit kernel's calls by n_b; every mask byte-equal to
   the unbatched one and those to the columnar host reference; (c) 31
   users x 10 lists at one revision, cache on: hit ratio, hit and miss
   p50, no launch and no dispatch over the all-hit rounds; a 64 x 1,024
   bulk check twice (misses, then all hits), checks/s of each; (d)
   singleflight: 16 threads, one uncached list: one dispatch and 15
   piggybacks; (e) invalidation: the list after a write misses and
   matches the host reference, a grant expiring 2 s ahead served from
   the cache before its deadline and gone after it, a compaction fold
   retiring the entries below its revision; (f) the serving path's
   launches; (b) the bit kernel at a fused batch's captured inputs
   (n_b = 8 and 4), byte-equal to its plain version, with its times,
   bounds and the live words of the union against the sparse path's
   limit; (g) a trace of one fused dispatch of 8 lists;
P. durability on the same engine (persistence/): (0) the size one WAL
   frame of the headline's bulk load would take, against MAX_WAL_FRAME;
   (1) ``save_snapshot`` of the 10M store, bytes and seconds; (2)
   ``enable_persistence`` on an empty data dir and ``--writes`` journaled
   write->read pairs under ``wal_fsync="always"`` (append cost only, no
   checkpoint), then on a second data dir a checkpoint of the 10M store
   and ``--writes`` pairs under the default ``interval:100``, write and
   read-after-write p50/p99, no recompile; (3) a fresh ``Engine`` on the
   card, built with ``device_graph_budget_bytes`` at twice the writer's
   block bytes, recovering from the second dir (snapshot + WAL tail):
   recovery seconds, records replayed, time to the first list (its
   compile tiers the graph; its first list builds the device state with
   every block cold and streams the demanded ones); (4) every touched
   subject's mask byte-equal to the writer's;
T. tiered block residency (storage/) on the recovered engine, held
   against the untiered writer: (a) its own budget, twice the blocks'
   bytes: no block bytes on the device before the first list (P.3), that
   list's miss stall, then 30 lists with no miss; (b) the budget changed
   to half the bytes of the largest block a pod list demands, so that
   block can never stay hot: 30 lists, each streaming it (wall and miss
   stall p50/p99, COO bytes streamed a list, and each stream-in step's
   time, which the prefetch workers record: host clocks for the arena
   decode, the dead-cell cut and the pinned staging, CUDA events on the
   worker's stream for the copy and the build), a 64 x 1,024 bulk check,
   a torch.profiler trace of one list (busy time and idle share, stated
   as not measured when the trace misses the worker stream's copy), 20
   writes re-touching base grants (their blocks pinned), the compactor's
   placement sweep bringing the pinned block hot (over the budget: pins
   may overshoot), and the lists after it; every mask and verdict equal
   to the untiered engine's;
R. the engine host (engine/remote.py) on the headline engine, after T:
   (a) an in-process ``EngineServer`` on a loop thread of its own,
   plaintext on loopback, and the port's ``RemoteEngine``: phase 5's 31
   list filters over the wire (p50/p99 beside phase 5's in-process p50,
   every mask byte-equal to the in-process one), the mask frame's
   payload bytes, the first ``object_ids`` sync of the 100k pod ids
   (bytes, ms) and the incremental one after a write that adds a pod
   (only the new id rides); (b) phase 6's 64 x 1,024 bulk check over the
   wire (checks/s beside phase 6's, verdicts equal, the frames' bytes and
   the JSON encode and parse cost on one host); (c) 20 write->read pairs
   over the wire (write and read-after-write p50/p99, 0 recompiles) with
   a ``watch_push_stream`` subscribed first that must receive every
   write's events (p50 from the write's ack to the event's arrival); (d)
   256 lists for distinct users from 32 client threads, one
   ``RemoteEngine`` each, with the host's lookup batching off and on
   (window 2 ms): lists/s beside S.a's, every batched mask equal to the
   unbatched one and those to the in-process engine's; then the host
   stops (its workers joined); (e) the engine-host CLI, ``python -m
   spicedb_kubeapi_proxy_tpu_torch.engine.remote --engine-insecure
   --bind-port P --bootstrap <BENCH_SCHEMA> --data-dir <copy>`` with its
   default flags (the card, the decision cache, the compactor), on a
   copy of phase P's data dir taken after its last owner (T's engine)
   closed it: seconds from spawn to the first answered ``lookup_mask``,
   its pid among nvidia-smi's compute apps, P's subjects' masks
   byte-equal to the writer's, and SIGTERM: exit code 0 and the seconds
   its shutdown took (the final checkpoint);
M. live schema migration (migration/), after R, on a store of its own:
   the headline's widths and seed with an eighth of its relationships
   (``reduced``: each freeze's parity probe builds two OracleEvaluators
   over the whole store, which at 10M took 68-91 s a freeze). (a) an
   additive migration in process (pod gains ``relation auditor``
   and ``permission audit = auditor + namespace->admin``), durable (a
   fresh data dir, so the record is ``<dir>/migration.json``), the
   decision cache on and warm, a lister (phase 5's subjects, each list
   dispatched) and a writer (a new pod#viewer grant every 10 ms) on
   threads of their own throughout, held at dual: the plan time, the dual
   compile (off the lock), the lists' p50/p99 during the compile, the
   dual window and the freeze beside phase 5's, ``freeze_ms`` split into
   drain, the two oracle builds, the probe, the CUT record and the swap,
   the writer's largest stall (its writes carry a failing precondition
   once the cut is near, so the revision stays put), ``time_to_cut_ms``,
   the lists after the cut, device memory before, in the dual window,
   at its peak across the cut and after the old base's last view; after
   the cut pod#view lists are cache hits with no launch and equal the
   columnar reference, and pod#audit masks equal their columnar
   reference and, on two subjects, OracleEvaluator; (b) a rewriting
   migration over the wire (an in-process ``EngineServer``, the port's
   ``RemoteEngine``, the compactor and a fresh data dir on):
   ``migrate_begin`` of a target that strands namespace#viewer's group
   rows refused with nothing changed, a held begin aborted at dual (no
   cut, the record cleared), then namespace#viewer gains ``user with
   probation``, held at dual and cut by ``migrate_cut``: the backfill's
   rows/s (the ~2,000 namespace#viewer rows in batches of 512), overlay
   occupancy, compactor folds, the freeze's split; a push stream opened
   before the begin receives the post-cut write and no backfill echo;
   pod#view cache entries retired, pod#edit and namespace#admin ones
   answering; a caveated namespace#viewer grant's masks under two request
   contexts equal to OracleEvaluator, and a 64 x 1,024 bulk check over
   the wire equal to the columnar reference; (c) the engine-host CLI on a
   copy of R.e's data dir holding a ``migration.json`` at phase ``cut``
   (M.a's target), booted under the old schema with no write: its log
   says ``resumed (phase cut)``, pod#audit answers, the record is
   ``done``, P's subjects' masks equal the writer's, and SIGTERM exits
   0; (d) the headline engine takes M.b's final schema (the workflow
   definitions and the probation caveat, which K's dual writes and
   references need) in one migration with its parity probe off (M.a and
   M.b ran it), timed, its schema equal to M's;
K. the proxy itself (the port's rules/, authz/, dtx/ and proxy/) on the
   headline engine after M, a port ``Server`` over loopback HTTP with
   deploy/rules.yaml's pod rules (the list rule is the reference's
   proxy-path rule: split_name/split_namespace over pod ids ``ns/p{i}``):
   (a) ``GET /api/v1/pods`` for phase 5's 31 subjects over a fixed
   100k-item PodList the upstream returns (built once): wall p50/p99,
   the server's share, the upstream's, the write-out, and each stage
   alone (the engine's call, the prefilter with its id mapping, the
   native body filter; the Python filter beside it on 3 users); each
   user's kept names equal the columnar reference's, the kept items are
   the upstream's bytes, and a spy shows the native scanner served every
   list; (b) single-pod gets through pod-get's check, allow and deny
   against the reference; (c) creates through the dual write
   (pod-create, pessimistic lock) into a port ``InMemoryKube``: p50, the
   creator's next list showing each, both relationships in the store, a
   delete removing both halves; (d) a filtered watch for one user while
   grants are written: the buffered events released in grant order,
   against the reference, write -> delivery latency; (e) 256 namespaced
   lists from 32 client threads, batching off and on: lists/s; (f) the
   proxy CLI as a subprocess with no ``--device`` (cuda) over a port
   ``InMemoryKube`` this script serves: alice creates and lists a
   namespace, mallory gets [] and a 403, SIGTERM -> exit 0; (g) the
   proxy behind OIDC: the same ``Server`` with an ``OIDCAuthenticator``
   (proxy/oidc.py, the ``--oidc-*`` options validated) whose issuer is a
   loopback HTTP server this script runs (discovery and JWKS; one
   2048-bit RSA key made from ``--seed``, RS256 tokens signed here with
   proxy/jose.py): (a)'s 31 lists with a bearer JWT and no
   X-Remote-User, wall p50/p99 beside (a)'s, each list byte for byte as
   in (a), the token's verification alone, and an expired token, an
   unknown ``kid`` and a wrong audience answering 401;
C.a the open-loop sweep (loadgen/) on the headline engine after K.g:
   a 1.5 s closed-loop capacity probe of the mix from 8 threads
   (bench.py's shape), then the port's ``run_sweep`` over
   ``trace_shaped_config(d, 0.25 x capacity, tenants=8, seed)`` at
   0.5, 1, 2 and 3.5x with 32 workers and bench.py's SLOs, the compactor
   on; each point's ``d`` is at least 4 s and long enough for the
   schedule to hold 400 arrivals from 1x up, so every point draws the
   same mix (``reduced``: the 0.5x point is as long as the 1x one, ~200
   arrivals, saving ~30 s). Each trace op class maps onto the port: a check is a 1-item
   pod#view ``check_bulk``, a bulk check 64 items (16 subjects x 4
   pods), the list prefilter ``lookup_resources_mask``, a Table the
   port's ``filter_body`` over a 5,000-row pod Table, ``lookup_subjects``
   the engine's, a write a new pod#viewer grant to one of 64 subjects
   (never the same tuple twice), and a watch open and a wildcard check a
   check (the headline schema has no user:* grant). Offered, completed
   and goodput a point; each class's completions, p50 and max, its p99
   over at least 100 completions and its p99.9 over at least 1,000
   (exact, from the driver's records); the knee and whether it
   saturated, each burst window, the worst one's tail attribution, SLO
   attainment; no op errs, and afterwards every written subject's mask
   equals the columnar reference; then, unloaded, how long a
   ``lookup_subjects`` takes on 6 pods and how that divides between its
   candidate walk over the store's columns and its bulk checks;
D. the demo (proxy/demo.py ``build`` on the card) and its two users'
   lists: alice sees dev, carol prod;
F. the ``--peers`` failover set (parallel/failover.py, parallel/
   multihost.py) after K: two engine-host CLIs on loopback sharing the
   card, ``python -m spicedb_kubeapi_proxy_tpu_torch.engine.remote
   --peers A,B --peer-id i --data-dir <copy of P's data dir>
   --wal-fsync always --mirror-heartbeat-seconds 0.5
   --min-sync-replicas 1`` (no ``--device``: the card), the port's
   ``FailoverEngine`` the client, and OracleEvaluator's lists of phase
   6's 64 subjects over P's recovered store (one evaluator a user, built
   while the peers boot) the reference. (a) spawn to election, the
   leader's first list (its 10M compile), the 64 lists and the 64 x
   1,024 bulk check through the leader exact against the oracle, 100
   sync-replicated writes (each ack waits for the follower's fsynced
   journal) p50/p99 beside R.c's unreplicated wire write, each peer's
   device memory (nvidia-smi); (b) SIGKILL of the leader under a stream
   of acknowledged writes: kill -> promotion and kill -> the first list
   the new leader serves (its 10M compile), every acknowledged write read
   back from it, the lists and the bulk check exact again, and the
   survivor, alone, failing writes closed (``--min-sync-replicas 1``);
   (c) the killed peer restarted on its data dir rejoins as a follower
   (an effects catch-up or, across the term change, a full state
   transfer; timed), writes are acknowledged again, then it restarts on
   an EMPTY data dir and takes a full 10M state transfer (the leader's
   cut and encode, the frame's bytes and arrival, the follower's
   install, from both logs); SIGTERM of both, exit 0, the new leader
   logging its kernel launches;
10. the caveated mix, with phase 3-9's engine released first: bench.py's
    caveated mesh configuration (MESH_SCHEMA, 30% of the flat
    pod#viewer grants carrying an IP allowlist in one of two stored
    contexts, a nested chain of 6 groups, seed 2) at the same widths and
    a quarter of the relationships (reduced: PRs 4-10 ran all of them,
    PRs 11-12 half, so the run keeps room for phases F and G). (a) bulk load, compile and device build, with the
    residual, the caveat rows and the tape length; (b) phase 5's list
    filters under three request contexts (one both stored contexts
    allow, one only the first allows, none): p50/p99, the caveat VM's
    device activities and host time a dispatch, the masks nested
    (allow-both >= allow-first >= none, strictly in total) and the
    missing-context counter rising by exactly 2 a no-context call; (c)
    phase 6's bulk check under the second context; (d) forced pull: the
    same masks; (e) the caveated OracleEvaluator on 2 full masks and a
    sample of checks a context and on (c)'s verdicts; (f) 52 caveated
    write->read pairs (stored contexts reused, new contexts on the 6
    spare instance rows, a caveat attached to a base grant, then one new
    context past the bucket): write and read-after-write p50/p99, exactly
    one recompile, counted as a ``caveat`` fallback; (g) a trace of 10
    caveated lists with the VM's share of the device time. (h), run
    between (e) and (f): the decision cache and the batcher on this
    cell: one subject's masks under the three contexts cached as three
    entries equal to (b)'s, contexted lists bypassing the batcher, a
    context differing only in undeclared keys hitting the declared
    entry, and 8 context-free lists fused into one dispatch counting
    their missing-context denials once. (i), run after (d): phase 5's
    lists through the port's proxy under two ``X-Forwarded-For`` chains
    whose last hops are (b)'s allow-both and allow-first addresses, the
    kept names equal to (b)'s masks under those contexts.
X. scale-out (scaleout/, autoscale/), after phase 10's engine is released:
   phase 3's rows with pod i re-keyed ``{its namespace}/p{i}`` (the shard
   map partitions by an id's namespace part) over G engine groups, each
   an ``Engine`` on the card behind an in-process ``EngineServer`` on
   loopback, reached through ``RemoteEngine`` clients, with a
   ``ShardedEngine`` and a ``SplitJournal`` in front. (a) G=2: phase
   5's 31 subjects and 33 more listed through ``lookup_resources_mask``
   (the gathered ids, mapped back, equal to their masks at phase 5's
   state), 256 routed single checks (the scatter counter still;
   ``reduced`` from 1,024, ~14 s over G=2 and G=4) and
   phase 6's 64 x 1,024 bulk check scatter-gathered (its verdicts),
   device bytes a group; (b) on the reference bench's 10x shard point
   with a sixteenth of its namespaces (1,250 x 12 pods, 512 users; the
   compactor and the 4,096-slot overlay of the engine host's defaults on
   each group), a live 2 -> 4 rebalance under a lister
   (every list exact) and a writer every 10 ms (pod grants and
   namespace grants, the latter journaled splits to every group): time
   to commit, rows copied and GC'd, folds and recompiles by reason,
   lists during the move, every acknowledged write read back from its
   owning group; then (a) again at G=4 over the 10M store; (e) the
   port's proxy from ``Options(shard_map=..., shard_journal_path=...)``
   over those four hosts: 11 ``GET /api/v1/pods`` over the 100k-item
   body re-keyed like the pods, each the planner's ids' items byte for
   byte, and /readyz's sharding line; (c) groups re-keyed
   ``gh{j}/g{j}`` so group#member partitions, the planner's frontier
   exchange (max_rounds 8): the 64 lists equal to phase 5's, rounds,
   boundary tuples and wire bytes; (d), run after (b) on its fleet: the
   ``AutoscaleController`` in apply mode (max_groups=3, hysteresis 2,
   no cooldown) proposing and driving 4 -> 3 under the lister and the
   writer, list goodput with the mover paused and running, no
   acknowledged write lost.
C.b one seed of the chaos campaign (chaos/), after phase X: the port's
   ``Campaign`` with no device given (the card) over its subprocess
   topology, 2 shard groups x 2-peer failover sets of engine-host CLIs
   sharing the card (``--wal-fsync always --min-sync-replicas 1
   --enable-chaos-ops``), the planner, ``FailoverEngine`` and
   ``RemoteEngine`` in this process: the baseline, brownout (wire-armed
   on group 1), crash (group 0's leader SIGKILLed), elastic (grow ->
   shrink -> regrow, the retiring leader SIGKILLed mid-drain) and
   migration episodes; ok with zero violations, the seed's fault digest
   (the pinned one at seed 0), the retries at the faulted group against
   the budget's bound, the healthy-goodput ratio, each host's spawn ->
   ready, each kill -> promotion, each episode's wall, the card's memory
   (nvidia-smi) with every host up, and every host's log saying it ran
   on the card.

Launch counts are zeroed just before phase 5 and read just after phase 6
(the kernels JSON's ``launches``), and again around phases 9b-9c
(``write_path_launches``), S.a-S.e (``serving_path_launches``) and
10b-10c (``caveat_path_launches``); in P and T they are summed over the
calls of the path's own engine only, never the reference engine's
(``persistence_path_launches``: the journaled writer's reads in P.2 and
the recovered engine's lists in P.3-P.4; ``tiered_path_launches``: the
tiered engine's calls in T; ``remote_path_launches``: the in-process
host's engine calls in R.a-R.d, the reference answers computed outside
the tally; R.e's subprocess proves its device through nvidia-smi and its
answers; ``migration_path_launches``: the migrated engine's calls in
M.a-M.b, its lister's and the host's included; ``proxy_path_launches``:
the proxy's requests in K.a-K.e, K.g and 10i, the stages timed alone
outside them; ``demo_path_launches``: the demo's two lists (its small
graph may form no dense block, so 0 is allowed there);
``failover_path_launches``: what F's surviving leader logged at its
exit, its lists and bulk checks after the promotion (the subprocess's
own counts; the killed leader's die with it); ``scaleout_path_launches``: every group engine's calls in
X.a-X.e; ``loadgen_path_launches``: C.a's sweep alone;
``chaos_path_launches``: what C.b's surviving hosts logged at their
shutdown, which may be 0, as the demo's: the campaign's graph of 8
namespaces may form no dense block; ``mesh_path_launches``: G.a's mesh
calls and what G.b's host logged, 0 for the bit kernel, since mesh
blocks carry no bit dual). Both kernels must have run on
every other path (the persistence path runs lists only, and a check of the proxy path
takes the engine's push or pull choice: their bit kernel). The bit kernel's row also carries its readings at the fused
batch's inputs (``fused_inputs``). Any
mismatch or error exits non-zero. The last line is the run's JSON
verdict.

Usage: python3 chip_smoke.py [--seed N] [--n-rels N] [--writes N]
(from the repository root; kernels build at first use).
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import shutil
import subprocess
import sys
import threading
import time
from typing import Optional

import numpy as np

# the headline deployment's widths (never cut; only --n-rels may be)
N_PODS, N_USERS, N_NS, N_GROUPS = 100_000, 10_000, 1_000, 1_000
HEADLINE_RELS = 10_000_000
N_SUBJECTS = 31  # list-filter subjects timed and checked

# bench.py's BENCH_SCHEMA, with pod#viewer also admitting expiring grants
# (phase 9 writes some); the trait gates write admission only, so the
# compiled graph of the headline rows is the same
BENCH_SCHEMA = """
use expiration

definition user {}
definition group {
  relation member: user
}
definition namespace {
  relation creator: user
  relation viewer: user | group#member
  permission admin = creator
  permission view = viewer + creator
}
definition pod {
  relation namespace: namespace
  relation creator: user
  relation viewer: user | user with expiration
  permission edit = creator
  permission view = viewer + creator + namespace->view
}
"""

# bench.py's MESH_SCHEMA: BENCH_SCHEMA with nested groups and an IP
# allowlist caveat on flat pod#viewer grants (the caveated mix of phase 10)
MESH_SCHEMA = """
use expiration

caveat ip_allowlist(ip ipaddress, allowed list<ipaddress>) {
  ip in allowed
}

definition user {}
definition group {
  relation member: user | group#member
}
definition namespace {
  relation creator: user
  relation viewer: user | group#member
  permission admin = creator
  permission view = viewer + creator
}
definition pod {
  relation namespace: namespace
  relation creator: user
  relation viewer: user | user with ip_allowlist
  permission edit = creator
  permission view = viewer + creator + namespace->view
}
"""

# the two stored contexts the caveated mix alternates (bench.py's
# MESH_CTXS): two instances, an 8-row bucket with 6 spare rows
MESH_CTXS = ('{"allowed":["10.0.0.0/8","192.168.0.0/16"]}',
             '{"allowed":["10.0.0.0/8"]}')

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15

SECTOR_BYTES = 32  # the card's memory access grain (one L2 sector)

KERNEL_SOURCE = "spicedb_kubeapi_proxy_tpu_torch/csrc/bitprop.cu"
REPLACES = {
    "bit_or_matmul": "spicedb_kubeapi_proxy_tpu/ops/bitprop.py:151",
    "dense_or_matmul": "spicedb_kubeapi_proxy_tpu/ops/bitprop.py:258",
}


# numbers a later phase prints beside its own: R.c's wire write p50/p99
# ("r_write") and K.a's proxy list p50/p99 ("k_a"), in ms
MEASURED: dict = {}


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def build_rows(n_pods: int, n_users: int, n_ns: int, n_groups: int,
               n_rels: int, seed: int, cav_share: float = 0.0,
               part_out: Optional[dict] = None) -> dict:
    """The headline rows, generated as bench.py's build_engine does:
    ~20 users per group, 2 group viewer grants per namespace, every pod
    in a namespace, and the rest flat pod#viewer@user. Unlike
    build_engine, every kind is deduplicated (the first draw of a pair
    kept), as Store.bulk_load requires: a duplicated row outlives the
    delete of its tuple in the store, while the compiled graph drops the
    edge. ``cav_share`` > 0 is build_engine's caveated mesh mix (for
    MESH_SCHEMA): a nested chain of 6 groups (g1 in g0, ...) and that
    share of the flat grants carrying ``ip_allowlist``, alternating the
    two MESH_CTXS stored contexts.

    ``part_out`` (a dict) receives what phase X re-keys the rows by
    (``x_rows``, ``x_rekey_groups``): the pods' namespace indices
    (``pod_ns``), each row's partition key (``key``: -1 for a global row,
    k < n_ns for ``("ns{k}", "pod")``), the counts of the leading
    group#member and namespace#viewer rows (``n_gm``, ``n_nv``) and the
    pod index of each pod row after them (``pod_row``)."""
    rng = np.random.default_rng(seed)
    pods = np.char.add("ns/p", np.arange(n_pods).astype(str))
    users = np.char.add("u", np.arange(n_users).astype(str))
    groups = np.char.add("g", np.arange(n_groups).astype(str))
    nss = np.char.add("ns", np.arange(n_ns).astype(str))
    part: list = []
    keys = ["resource_type", "resource_id", "relation",
            "subject_type", "subject_id", "subject_relation"]
    if cav_share > 0:
        keys += ["caveat", "caveat_context"]
    cols = {k: [] for k in keys}

    def add(rt, rid, rl, st, sid, srl=None, cav=None, ctx=None):
        n = len(rid)
        cols["resource_type"].append(np.full(n, rt))
        cols["resource_id"].append(rid)
        cols["relation"].append(np.full(n, rl))
        cols["subject_type"].append(np.full(n, st))
        cols["subject_id"].append(sid)
        cols["subject_relation"].append(
            np.full(n, srl if srl is not None else ""))
        if cav_share > 0:
            cols["caveat"].append(cav if cav is not None else np.full(n, ""))
            cols["caveat_context"].append(
                ctx if ctx is not None else np.full(n, ""))

    def first_draws(a, b, n_b):
        keep = np.sort(np.unique(a * n_b + b, return_index=True)[1])
        return a[keep], b[keep]

    gm = min(20 * n_groups, n_rels // 20)
    g, u = first_draws(rng.integers(n_groups, size=gm),
                       rng.integers(n_users, size=gm), n_users)
    add("group", groups[g], "member", "user", users[u])
    part.append(np.full(len(g), -1))
    if cav_share > 0:
        # a short nested-group chain: a cyclic-core range too sparse for
        # the dense-closure peel, so the fixpoint iterates a few hops
        chain = int(min(6, n_groups - 1))
        add("group", groups[np.arange(chain)], "member", "group",
            groups[np.arange(1, chain + 1)], "member")
    nv = 2 * n_ns
    n, g = first_draws(rng.integers(n_ns, size=nv),
                       rng.integers(n_groups, size=nv), n_groups)
    add("namespace", nss[n], "viewer", "group", groups[g], "member")
    part.append(np.full(len(n), -1))
    gm, nv = len(u), len(n)
    pod_ns_idx = rng.integers(n_ns, size=n_pods)
    pod_ns = np.char.add("ns", pod_ns_idx.astype(str))
    add("pod", pods, "namespace", "namespace", pod_ns)
    part.append(pod_ns_idx)
    n_flat = n_rels - gm - nv - n_pods
    pair = rng.integers(0, n_pods * n_users, size=int(n_flat * 1.01),
                        dtype=np.int64)
    pair = np.unique(pair)[:n_flat]
    rng.shuffle(pair)
    cav = ctx = None
    if cav_share > 0:
        idx = np.arange(len(pair))
        is_cav = idx < int(len(pair) * cav_share)
        cav = np.where(is_cav, "ip_allowlist", "")
        ctx = np.where(is_cav, np.asarray(MESH_CTXS)[idx % len(MESH_CTXS)],
                       "")
    add("pod", pods[pair // n_users], "viewer", "user",
        users[pair % n_users], cav=cav, ctx=ctx)
    part.append(pod_ns_idx[pair // n_users])
    if part_out is not None:
        check(cav_share == 0, "partition keys of the uncaveated rows only")
        part_out["pod_ns"] = pod_ns_idx
        part_out["key"] = np.concatenate(part).astype(np.int64)
        part_out["n_gm"], part_out["n_nv"] = gm, nv
        part_out["pod_row"] = np.concatenate([np.arange(n_pods),
                                              pair // n_users])
    return {k: np.concatenate(v) for k, v in cols.items()}


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean time of ``fn`` over ``reps`` back-to-back eager calls (CUDA
    events), after one warm-up call: the device time, or the host's launch
    time where that is longer."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(torch, fn, reps: int) -> float:
    """Host time of one ``fn`` call: ``reps`` calls enqueued back to back
    with no synchronize between them (the wrapper's Python, its checks,
    the output allocation and the launch calls), after one warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t * 1e3 / reps


def graph_ms(torch, fn, reps: int = 50) -> float:
    """Device time of one ``fn`` call: ``reps`` calls captured in a CUDA
    graph and replayed, so no host launch cost sits between them; the
    median of five replays. A kernel of a few microseconds is otherwise
    timed at the host's launch rate."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up off the capture
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(5):
        start.record()
        g.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))


def bound_ms(n_bytes: float, n_ops: float = 0.0) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / INT8_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def one_hot_frontier(torch, idx_rows, n_src: int, dev):
    """A block's frontier as the fixpoint feeds it: row b holds its
    subject's slot and the wildcard slot (object index 1)."""
    f = torch.zeros((len(idx_rows), n_src), dtype=torch.uint8, device=dev)
    for b, i in enumerate(idx_rows):
        f[b, i] = 1
        f[b, 1] = 1
    return f


def capture_inputs(bitprop, bits, A, run) -> dict:
    """Run ``run`` (main-path calls) with both kernel wrappers wrapped to
    keep a copy of the first inputs each gets for the headline block
    (``bits`` / ``A``): exactly the shapes and frontiers the main path
    launches. The dense frontier arrives as a row-strided slice of the
    fixpoint's state; its copy keeps that row stride. The wrapped calls
    still launch the kernels."""
    got = {}
    bit, dense = bitprop.bit_or_matmul, bitprop.dense_or_matmul

    def bit_spy(a, vb, nb):
        if a is bits:
            got.setdefault("bit", (a, vb.clone(), nb))
        return bit(a, vb, nb)

    def dense_spy(a, f):
        if a is A and "dense" not in got:
            buf = strided_like(f)
            buf.copy_(f)
            got["dense"] = (a, buf)
        return dense(a, f)

    # the wrappers count through their module-level names, now the spies
    bit_spy.launches = dense_spy.launches = 0
    bitprop.bit_or_matmul, bitprop.dense_or_matmul = bit_spy, dense_spy
    try:
        run()
    finally:
        bitprop.bit_or_matmul, bitprop.dense_or_matmul = bit, dense
    check(set(got) == {"bit", "dense"},
          f"the main path gave the headline block only {sorted(got)}")
    return got


def strided_like(f):
    """A zeroed [B, n] view with ``f``'s row stride (a slice of a wider
    buffer, as the fixpoint's state slice is)."""
    buf = f.new_zeros((f.shape[0], max(f.stride(0), f.shape[1])))
    return buf[:, :f.shape[1]]


def bit_frontier(torch, k: int, n_live: int, dev, rng):
    """A packed B=1 frontier [8, k] with ``n_live`` live words: word 0
    (the wildcard's slot 1) and the rest at random; the last live word
    also holds bit 31, a negative int32."""
    vals = np.zeros(k, dtype=np.int64)
    if n_live:
        words = np.concatenate([[0], rng.choice(np.arange(1, k), n_live - 1,
                                                replace=False)])
        vals[words] = np.int64(1) << rng.integers(0, 31, size=n_live)
        vals[0] |= 2
        vals[words[-1]] |= np.int64(1) << 31
    v = torch.zeros((8, k), dtype=torch.int32)
    v[0] = torch.from_numpy((vals - ((vals >> 31) << 32)).astype(np.int32))
    return v.to(dev)


def bit_sector_bound(vb, nb: int, n_dst: int) -> tuple[float, int]:
    """What the card must read for one bit hop with the reference's
    row-major dual: the 32-byte sectors of each row that hold a live word
    (8 words a sector), the packed frontier once and the output once."""
    live = (vb[:nb] != 0).any(dim=0).nonzero().flatten()
    sectors = int((live // 8).unique().numel())
    return bound_ms(n_dst * 32 * sectors + vb.numel() * 4 + nb * n_dst)[0], \
        sectors


def time_bit(torch, bitprop, a, vb, nb: int, label: str,
             plain_reps: int = 5) -> dict:
    """Times of ``bit_or_matmul`` on (a, vb, nb) after a byte-equality
    check against its plain version, with the data bound (live words) and
    the sector bound. ``ms`` is the mean over eager launches (CUDA events),
    ``device_ms`` the CUDA-graph replay, ``host_ms`` the host's time a
    call."""
    n_dst, k = a.shape
    got = bitprop.bit_or_matmul(a, vb, nb)
    want = bitprop.bit_or_matmul_plain(a, vb, nb)
    torch.cuda.synchronize()
    check(torch.equal(got, want),
          f"bit_or_matmul != plain at {tuple(a.shape)} n_b={nb} ({label})")

    def fn():
        return bitprop.bit_or_matmul(a, vb, nb)

    eager = cuda_ms(torch, fn, 50)
    device = graph_ms(torch, fn)
    host = host_ms(torch, fn, 50)
    plain = cuda_ms(torch, lambda: bitprop.bit_or_matmul_plain(a, vb, nb),
                    plain_reps)
    live_words = int((vb[:nb] != 0).any(dim=0).sum())
    b_ms, b_by = bound_ms(n_dst * live_words * 4 + vb.numel() * 4
                          + nb * n_dst)
    s_ms, sectors = bit_sector_bound(vb, nb, n_dst)
    log(f"  bit_or_matmul {label} [{n_dst} x {k}] n_b={nb}: byte-equal, "
        f"{live_words} live words ({sectors} sectors a row): kernel "
        f"{eager:.4f} ms eager (device {device:.4f} ms by graph replay, "
        f"host {host:.4f} ms a call), plain {plain:.4f} ms, bound "
        f"{b_ms:.6f} ms, sector bound {s_ms:.6f} ms, whole-dual stream "
        f"{bound_ms(a.numel() * 4)[0]:.4f} ms")
    return dict(ms=eager, device_ms=device, host_ms=host, plain_ms=plain,
                bound_ms=b_ms, bound_by=b_by, sector_bound_ms=s_ms,
                live=live_words)


def dense_frontier(torch, n_src: int, n_tiles: int, batch: int, dev, rng):
    """A [batch, n_src] frontier whose rows share no columns: ``n_tiles``
    64-byte src tiles at random, tile i given to row i % batch, with one
    set byte in each of its two 32-byte halves."""
    f = np.zeros((batch, n_src), dtype=np.uint8)
    tiles = rng.choice(n_src // 64, n_tiles, replace=False)
    for i, t in enumerate(tiles.tolist()):
        f[i % batch, t * 64 + rng.integers(32)] = 1
        f[i % batch, t * 64 + 32 + rng.integers(32)] = 1
    return torch.from_numpy(f).to(dev)


def time_dense(torch, bitprop, A, f, dev, label: str,
               plain_reps: int = 2) -> dict:
    """Times of ``dense_or_matmul`` on (A, f) after a byte-equality check
    against its plain version and the library yardstick: kernel, plain
    version and library, with the data bound (live src columns) and the
    sector bound (live 32-byte columns, which is what the kernel reads).
    ``ms`` and ``library_ms`` are means over eager launches (CUDA events),
    ``device_ms`` and ``library_device_ms`` CUDA-graph replays, ``host_ms``
    the host's time a call."""
    nb, (nd, ns) = f.shape[0], A.shape
    got = bitprop.dense_or_matmul(A, f)
    want = bitprop.dense_or_matmul_plain(A, f)
    torch.cuda.synchronize()
    check(torch.equal(got, want), f"dense_or_matmul != plain at "
          f"{tuple(A.shape)} B={nb} ({label})")

    def fn():
        return bitprop.dense_or_matmul(A, f)

    eager = cuda_ms(torch, fn, 20)
    device = graph_ms(torch, fn, 20)
    host = host_ms(torch, fn, 20)
    plain = cuda_ms(torch, lambda: bitprop.dense_or_matmul_plain(A, f),
                    plain_reps)
    nzc = (f != 0).any(dim=0)
    live_cols = int(nzc.sum())
    need = nd * live_cols + f.shape[0] * ns + nb * nd
    b_ms, b_by = bound_ms(need, 2.0 * nb * nd * live_cols)
    grain = SECTOR_BYTES
    pad = (-ns) % grain
    live32 = int(torch.nn.functional.pad(nzc, (0, pad)).view(-1, grain)
                 .any(dim=1).sum())
    sector = nd * grain * live32 + f.shape[0] * ns + nb * nd
    s_ms = bound_ms(sector, 2.0 * nb * nd * live32 * grain)[0]
    # the library yardstick: timed here only, the port never calls it;
    # torch._int_mm wants more than 16 rows, so zero rows pad it to 32
    fi8, at = torch.zeros((max(32, nb), ns), dtype=torch.int8,
                          device=dev), A.t()
    fi8[:nb] = f

    def lib_fn():
        return torch._int_mm(fi8, at).gt(0)

    library = cuda_ms(torch, lib_fn, 20)
    library_dev = graph_ms(torch, lib_fn, 20)
    check(torch.equal(torch._int_mm(fi8, at)[:nb].gt(0).to(torch.uint8),
                      got), "torch._int_mm yardstick disagrees with "
          f"dense_or_matmul ({label})")
    log(f"  dense_or_matmul {label} [{nd} x {ns}] B={nb}: byte-equal, "
        f"{live_cols} live src columns, {live32} of {-(-ns // grain)} live "
        f"32-byte columns: kernel {eager:.4f} ms eager (device "
        f"{device:.4f} ms by graph replay, host {host:.4f} ms a call), "
        f"plain {plain:.4f} ms, bound {b_ms:.6f} ms, sector bound "
        f"{s_ms:.4f} ms ({sector} B, achieved {sector / device / 1e6:.1f} "
        f"GB/s on device time); library torch._int_mm>0 {library:.4f} ms "
        f"eager, {library_dev:.4f} ms device (B padded to {fi8.shape[0]})")
    return dict(ms=eager, device_ms=device, host_ms=host, plain_ms=plain,
                bound_ms=b_ms, bound_by=b_by, sector_bound_ms=s_ms,
                library_ms=library, library_device_ms=library_dev,
                live=live32)


# density sweeps: live packed words (bit, B=1) and live 64-byte src
# tiles (dense, B=16 rows sharing no column)
BIT_SWEEP = (0, 1, 2, 16, 32, 64, 512)
DENSE_SWEEP = (0, 1, 16, 64, 256)


def sweep(torch, bitprop, bits, A, dev, seed: int) -> list[dict]:
    """Both kernels across frontier densities on the headline blocks
    (``bits`` [n_dst, K] int32, ``A`` [n_dst, n_src] int8): each case
    byte-equal to the plain version, timed, with its sector bound."""
    rng = np.random.default_rng(seed)
    out = []
    k = bits.shape[1]
    for n_live in BIT_SWEEP:
        n_live = min(n_live, k)
        r = time_bit(torch, bitprop, bits, bit_frontier(
            torch, k, n_live, dev, rng), 1, f"sweep {n_live} live words",
            plain_reps=2)
        out.append(dict(r, kernel="bit_or_matmul", case=f"{n_live} words"))
    n_src = A.shape[1]
    for n_tiles in DENSE_SWEEP:
        n_tiles = min(n_tiles, n_src // 64)
        r = time_dense(torch, bitprop, A, dense_frontier(
            torch, n_src, n_tiles, 16, dev, rng), dev,
            f"sweep {n_tiles} live 64-byte tiles", plain_reps=1)
        out.append(dict(r, kernel="dense_or_matmul",
                        case=f"{n_tiles} tiles"))
    return out


# mid-size bit duals: the headline's row width (16,384 src, K=512 words,
# 2 KiB a row) and edge density (75 a row over 10,000 users) at 1,024 to
# 32,768 rows (2 to 64 MiB), where the small-dual cutoff falls
MID_ROWS = (1024, 2048, 4096, 8192, 16384, 32768)


def mid_duals(torch, bitprop, dev, rng) -> list:
    """(rows, a, vb, nb, n_live) for each mid-size dual with a B=1
    frontier of 2 live words (the list filter's) and of K / 16."""
    out = []
    n_src = 16_384
    for rows in MID_ROWS:
        dst = torch.from_numpy(rng.integers(rows, size=75 * rows)).to(dev)
        src = torch.from_numpy(rng.integers(10_000, size=75 * rows)).to(dev)
        a = bitprop.pack_block(dst, src, rows, n_src)
        k = a.shape[1]
        for n_live in (2, k // 16):
            out.append((rows, a, bit_frontier(torch, k, n_live, dev, rng), 1,
                        n_live))
    return out


def bit_cutoff(torch, bitprop, kernels, dev, seed: int) -> list[dict]:
    """The bit kernel's small-dual cutoff: on each mid-size dual, its
    device time (graph replay) with the path forced, by calling the C
    entry point with ``max_live`` -1 (stream whole rows) and with the
    shared list's capacity (sparse), each byte-equal to the plain
    version; beside what ``bit_sparse_max_live`` picks."""
    lib = bitprop._lib()
    out = []
    for rows, a, vb, nb, n_live in mid_duals(
            torch, bitprop, dev, np.random.default_rng(seed)):
        k = a.shape[1]
        want = bitprop.bit_or_matmul_plain(a, vb, nb)
        times = {}
        for path, max_live in (("stream", -1),
                               ("sparse", bitprop.BIT_SPARSE_CAP)):
            got = torch.empty((nb, rows), dtype=torch.uint8, device=dev)

            def fn(got=got, max_live=max_live):
                kernels.check(lib.bitprop_bit_or_matmul(
                    a.data_ptr(), vb.data_ptr(), got.data_ptr(), rows, k, nb,
                    max_live, bitprop._stream(dev)), "bit_or_matmul launch")

            fn()
            torch.cuda.synchronize()
            check(torch.equal(got, want), f"bit_or_matmul ({path} path "
                  f"forced) != plain at [{rows} x {k}], {n_live} live words")
            times[path] = graph_ms(torch, fn)
        picks = ("sparse" if n_live <= bitprop.bit_sparse_max_live(rows, k)
                 else "stream")
        log(f"  bit cutoff [{rows} x {k}] ({rows * k * 4 / 2 ** 20:.0f} MiB), "
            f"{n_live} live words: stream {times['stream']:.5f} ms, sparse "
            f"{times['sparse']:.5f} ms device; the rule picks {picks}")
        out.append(dict(rows=rows, k=k, live=n_live, picks=picks, **times))
    return out


def ragged_bits(torch, bitprop, rng, dev, nd: int, ns: int, nb: int):
    """A random bit dual [nd, K] and a 5%-density packed frontier."""
    dst = torch.from_numpy(rng.integers(nd, size=8 * nd)).to(dev)
    src = torch.from_numpy(rng.integers(ns, size=8 * nd)).to(dev)
    a = bitprop.pack_block(dst, src, nd, ns)
    f = torch.from_numpy(
        (rng.random((nb, ns)) < 0.05).astype(np.uint8)).to(dev)
    return a, bitprop.pack_frontier(f, ns), nb


def kernel_phase(torch, bitprop, kernels, cap, f64, dev):
    """Phase 4: both kernels against their plain versions on the card, at
    the inputs the main path gave the headline block (``cap``), at extra
    shapes, across a density sweep and on mid-size bit duals with each
    path forced; times at every one of them."""
    rng = np.random.default_rng(7)
    rows = {}

    # -- bit_or_matmul: the list filter's pod#viewer hop, two ragged --
    err = 0
    cases = [cap["bit"], ragged_bits(torch, bitprop, rng, dev, 288, 96, 3),
             ragged_bits(torch, bitprop, rng, dev, 4064, 4000, 8)]
    for a, vb, nb in cases:
        got = bitprop.bit_or_matmul(a, vb, nb)
        want = bitprop.bit_or_matmul_plain(a, vb, nb)
        torch.cuda.synchronize()
        check(torch.equal(got, want),
              f"bit_or_matmul != plain at {tuple(a.shape)} n_b={nb}")
        err = max(err, int((got.int() - want.int()).abs().max()))
        log(f"  bit_or_matmul {tuple(a.shape)} n_b={nb}: byte-equal "
            f"(hits {int(got.sum())})")
    a, vb, nb = cases[0]
    rows["bit_or_matmul"] = dict(
        time_bit(torch, bitprop, a, vb, nb, "main-path input"),
        library_ms=None, max_abs_err=err)
    time_bit(torch, bitprop, *cases[2], "ragged 5% density")

    # -- dense_or_matmul: the bulk check's pod#viewer hop (a strided
    # slice, as launched), B=64 one-hot on the same block, two ragged --
    err = 0
    A, f = cap["dense"]
    check(torch.equal(bitprop.dense_or_matmul(A, f),
                      bitprop.dense_or_matmul(A, f.contiguous())),
          "dense_or_matmul differs on a strided frontier and its copy")
    dcases = [(A, f), (A, f64)]
    for nd, ns, b in ((384, 128, 33), (1000, 4000, 200), (1000, 4016, 16)):
        dcases.append((
            torch.from_numpy((rng.random((nd, ns)) < 0.05).astype(
                np.int8)).to(dev),
            torch.from_numpy((rng.random((b, ns)) < 0.02).astype(
                np.uint8)).to(dev)))
    for a, fr in dcases:
        got = bitprop.dense_or_matmul(a, fr)
        want = bitprop.dense_or_matmul_plain(a, fr)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"dense_or_matmul != plain at "
              f"{tuple(a.shape)} B={fr.shape[0]}")
        err = max(err, int((got.int() - want.int()).abs().max()))
        log(f"  dense_or_matmul {tuple(a.shape)} B={fr.shape[0]}: byte-equal "
            f"(hits {int(got.sum())})")
    rows["dense_or_matmul"] = dict(
        time_dense(torch, bitprop, A, f, dev,
                   f"main-path input (row stride {f.stride(0)})"),
        max_abs_err=err)
    # the same block at B=64 (one subject a row); printed only
    time_dense(torch, bitprop, A, f64, dev, "one-hot B=64")

    log("  density sweep (headline blocks):")
    sweep(torch, bitprop, cap["bit"][0], A, dev, 11)
    log("  small-dual cutoff (mid-size bit duals, each path forced):")
    bit_cutoff(torch, bitprop, kernels, dev, 13)
    return rows


def _n_kernels(ev) -> int:
    """Device activities launched under a profiler event, children's
    included."""
    return len(ev.kernels) + sum(_n_kernels(c) for c in ev.cpu_children)


def trace_phase(torch, label: str, fn, n_calls: int,
                kernels: dict, annotations: tuple = ()) -> Optional[dict]:
    """Where the time goes: a torch.profiler trace of ``fn`` (``n_calls``
    main-path calls, warmed up first). Device busy time is the union of the
    traced device activity intervals; the idle share is the rest of the
    wall time of the same window run untraced (the profiler slows the
    host), each window ending in a synchronize. ``kernels`` maps a label
    to name fragments whose device time is reported per call;
    ``annotations`` names ``record_function`` ranges (the caveat VM's)
    whose device time, share of the busy time and launches are reported
    per call (the ranges themselves are not device activity). Returns the
    busy ms, the idle share and each ``kernels`` label's device ms a call,
    or None when the profiler recorded no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    plain_us = (time.perf_counter() - t0) * 1e6
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans, per_name = [], {}
    notes = {a: [0.0, 0] for a in annotations}
    for ev in prof.events():
        if ev.name in notes:
            if ev.device_type == DeviceType.CPU:
                notes[ev.name][0] += ev.device_time_total
                notes[ev.name][1] += _n_kernels(ev)
            continue
        if ev.device_type != DeviceType.CUDA:
            continue
        lo, hi = ev.time_range.start, ev.time_range.end
        spans.append((lo, hi))
        n, t = per_name.get(ev.name, (0, 0.0))
        per_name[ev.name] = (n + 1, t + (hi - lo))
    if not spans:
        log(f"  trace {label}: device time not measured (the profiler "
            f"recorded no device activity); wall {wall_us / 1e3:.3f} ms "
            f"for {n_calls} calls")
        return None
    busy, end = 0.0, float("-inf")
    for lo, hi in sorted(spans):
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    idle = max(0.0, 1 - busy / plain_us)
    log(f"  trace {label}: {n_calls} calls, wall {plain_us / 1e3:.3f} ms "
        f"untraced ({wall_us / 1e3:.3f} ms traced), device busy "
        f"{busy / 1e3:.3f} ms, idle share {idle:.4f}, {len(spans)} device "
        f"activities")
    labels = {}
    for what, frags in kernels.items():
        hit = [(n, t) for nm, (n, t) in per_name.items()
               if any(fr in nm for fr in frags)]
        n, t = sum(h[0] for h in hit), sum(h[1] for h in hit)
        labels[what] = t / 1e3 / n_calls
        log(f"    {what}: {t / 1e3 / n_calls:.4f} ms device time a call "
            f"({n} activities over {n_calls} calls"
            + (f", {t / 1e3 / n:.4f} ms an activity)" if n else ")"))
    for what, (t, n) in notes.items():
        log(f"    {what} (range): {t / 1e3 / n_calls:.4f} ms device time a "
            f"call, {t / busy:.4f} of the busy time, {n / n_calls:.1f} "
            f"launches a call" if n else f"    {what} (range): device time "
            "not measured (no activity attributed to the range)")
    top = sorted(per_name.items(), key=lambda kv: -kv[1][1])[:6]
    for nm, (n, t) in top:
        log(f"    {t / 1e3:9.3f} ms  x{n:<5d} {nm[:90]}")
    return {"busy_ms": busy / 1e3, "idle": idle, "labels": labels}


def base_samples(rows: dict, n_pods: int, n_ns: int, n_groups: int,
                 n_rels: int, seed: int) -> dict:
    """Existing edges of the generated rows for phase 9 to re-touch and
    delete, by build_rows' layout (group#member rows, then
    namespace#viewer@group#member, then pod#namespace, then the flat
    pod#viewer@user rows): distinct pairs of each kind."""
    rng = np.random.default_rng(seed + 9)
    # the deduplicated group#member and namespace#viewer row counts
    head = rows["resource_type"][:min(20 * n_groups, n_rels // 20)
                                 + 2 * n_ns]
    gm = int((head == "group").sum())
    nv = int((head == "namespace").sum())
    pv0 = gm + nv + n_pods

    def pick(lo, hi, k):
        idx = lo + rng.choice(hi - lo, size=k, replace=False)
        return [(str(rows["resource_id"][i]), str(rows["subject_id"][i]))
                for i in idx.tolist()]

    return {"pod_viewer": pick(pv0, len(rows["resource_id"]), 64),
            "group_member": pick(0, gm, 8),
            "ns_viewer": list(dict.fromkeys(pick(gm, gm + nv, 8)))}


def view_masks(store, users, now: float, n: int) -> dict:
    """pod#view of BENCH_SCHEMA for each user, computed plainly with numpy
    over the store's live rows (viewer + creator + namespace->view, a
    namespace's view being its viewer users, the members of its viewer
    groups and its creator): {user: bool mask over pod object indices,
    ``n`` wide}. The phase-9 reference; it is held against
    OracleEvaluator on a few subjects."""
    snap = store.snapshot()
    c = snap.cols
    T, R = snap.types.lookup, snap.relations.lookup
    t_user, t_group, t_ns, t_pod = (T(x) for x in
                                    ("user", "group", "namespace", "pod"))
    live = c.exp > now

    def rows(rt, rl, st, srl=""):
        rl_id, srl_id = R(rl), R(srl)
        if None in (rt, rl_id, st, srl_id):
            return np.empty(0, np.int32), np.empty(0, np.int32)
        m = np.flatnonzero(live & (c.rt == rt) & (c.rl == rl_id)
                           & (c.st == st) & (c.srl == srl_id))
        return c.rid[m], c.sid[m]

    pv, pc, pn = (rows(t_pod, "viewer", t_user), rows(t_pod, "creator",
                                                      t_user),
                  rows(t_pod, "namespace", t_ns))
    nvu, nvg, nc = (rows(t_ns, "viewer", t_user),
                    rows(t_ns, "viewer", t_group, "member"),
                    rows(t_ns, "creator", t_user))
    gm = rows(t_group, "member", t_user)
    uid = snap.objects[t_user].id_map()
    out = {}
    for u in users:
        ui = uid[u]

        def mine(r):  # the user's own rows (and wildcard ones, index 1)
            return r[0][(r[1] == ui) | (r[1] == 1)]

        groups = mine(gm)
        ns_vis = np.concatenate([mine(nvu), mine(nc),
                                 nvg[0][np.isin(nvg[1], groups)]])
        pods = np.concatenate([mine(pv), mine(pc),
                               pn[0][np.isin(pn[1], ns_vis)]])
        mask = np.zeros(n, dtype=bool)
        mask[pods] = True
        mask[:2] = False  # void and wildcard are not objects
        out[u] = mask
    return out


def subset_oracle(snap, schema, OracleEvaluator, Snapshot, users,
                  now: float, context=None):
    """ONE OracleEvaluator (under the caveat ``context``) over the rows
    that can reach any of ``users``: every row whose subject is not a
    user, and their own and wildcard rows. Rows of other users never
    match these subjects, so for them it answers as the full oracle
    does, for a fraction of its build time (the whole 10M store took ~30
    s to build)."""
    c = snap.cols
    t_user = snap.types.lookup("user")
    uid = snap.objects[t_user].id_map()
    mine = np.array(sorted({uid[u] for u in users if u in uid}))
    keep = np.flatnonzero((c.st != t_user) | np.isin(c.sid, mine)
                          | (c.sid == 1))
    return OracleEvaluator(schema, Snapshot(
        snap.revision, c.take(keep), snap.types, snap.relations,
        snap.objects, snap.caveat_instances), now=now, context=context)


def user_oracles(snap, schema, OracleEvaluator, Snapshot, users,
                 now: float, context=None) -> dict:
    """A subset_oracle for each user."""
    return {u: subset_oracle(snap, schema, OracleEvaluator, Snapshot, [u],
                             now, context) for u in users}


def oracle_ids(store, schema, OracleEvaluator, Snapshot, users,
               now: float) -> dict:
    """OracleEvaluator's pod#view ids for each user (see user_oracles)."""
    return {u: o.lookup_resources("pod", "view", "user", u)
            for u, o in user_oracles(store.snapshot(), schema,
                                     OracleEvaluator, Snapshot, users,
                                     now).items()}


def pct(xs, q: float) -> float:
    return float(np.percentile(xs, q))


def write_phase(torch, e, samples: dict, subjects: list, n_writes: int,
                seed: int, stall_s: float) -> dict:
    """Phase 9: the write path at the headline deployment (see the module
    docstring). ``stall_s`` is what a write cost before the overlay: phase
    3's compile and device build. Returns the launches of both kernels
    over 9b-9c."""
    from spicedb_kubeapi_proxy_tpu_torch.engine.evaluator import \
        OracleEvaluator
    from spicedb_kubeapi_proxy_tpu_torch.engine.store import \
        RelationshipFilter, Snapshot, WriteOp
    from spicedb_kubeapi_proxy_tpu_torch.models.tuples import Relationship
    from spicedb_kubeapi_proxy_tpu_torch.engine import CheckItem
    from spicedb_kubeapi_proxy_tpu_torch.ops import bitprop, semiring
    from spicedb_kubeapi_proxy_tpu_torch.utils.features import features
    from spicedb_kubeapi_proxy_tpu_torch.utils.metrics import metrics

    rng = np.random.default_rng(seed + 90)

    def counter(name, **kw):
        return metrics.counter(name, **kw).value

    def hist_total(name):
        return metrics.histogram(name).total

    def pv_rel(pod, user, exp=None):
        return Relationship("pod", pod, "viewer", "user", user, None, exp)

    def rand_pv():
        return pv_rel(f"ns/p{rng.integers(N_PODS)}",
                      f"u{rng.integers(N_USERS)}")

    def list_mask(u, now=None):
        return e.lookup_resources_mask("pod", "view", "user", u, now=now)[0]

    # -- 9a: the first write after the bulk load --
    c0, i0 = counter("engine_graph_compiles_total"), counter(
        "engine_graph_incremental_updates_total")
    unl0 = counter("engine_graph_incremental_fallback_total",
                   reason="unlogged")
    rel = rand_pv()
    t0 = time.perf_counter()
    e.write_relationships([WriteOp("touch", rel)])
    first_w = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    m = list_mask(rel.subject_id)
    first_r = (time.perf_counter() - t0) * 1e3
    pods = e._objects_by_name()["pod"]
    check(bool(m[pods.lookup(rel.resource_id)]),
          "9a: the first write's grant is not visible")
    dc = counter("engine_graph_compiles_total") - c0
    di = counter("engine_graph_incremental_updates_total") - i0
    du = counter("engine_graph_incremental_fallback_total",
                 reason="unlogged") - unl0
    log(f"phase 9a first write after the bulk load: write {first_w:.3f} ms "
        f"(store index build included), list after it {first_r:.3f} ms; "
        f"recompiles {dc:.0f}, incremental updates {di:.0f}, unlogged "
        f"fallbacks {du:.0f}")
    # the compile followed the load (phase 3), so the load's revision is
    # the compiled one and the write folds into the overlay, as in the
    # reference; `unlogged` fires only for a graph compiled before a load
    check(dc == 0 and di == 1 and du == 0,
          "9a: the first write after load+compile must fold incrementally")

    # -- 9b: one warm pair, then n_writes write->read pairs --
    e.write_relationships([WriteOp("touch", rand_pv())])
    list_mask(subjects[0])
    pv_base = list(samples["pod_viewer"])
    rng.shuffle(pv_base)
    n_ret, n_del = 12, 12
    plan = [("retouch", p) for p in pv_base[:n_ret]]
    plan += [("delete", p) for p in pv_base[n_ret:n_ret + n_del]]
    plan += [("delete-gm", g) for g in samples["group_member"][:3]]
    plan += [("delete-nv", v) for v in samples["ns_viewer"][:3]]
    plan += [("touch", None)] * max(0, n_writes - len(plan))
    order = rng.permutation(len(plan))
    plan = [plan[i] for i in order]
    touched_users, touched_pods, touched_groups = set(), set(), set()
    w_ms, r_ms, j_ms, o_ms, p_ms = [], [], [], [], []
    c0, i0 = counter("engine_graph_compiles_total"), counter(
        "engine_graph_incremental_updates_total")
    torch.cuda.synchronize()
    bitprop.reset_launch_counts()
    for k, (kind, arg) in enumerate(plan):
        if kind == "touch":
            op = WriteOp("touch", rand_pv())
        elif kind == "retouch":
            op = WriteOp("touch", pv_rel(*arg, exp=time.time() + 600))
        elif kind == "delete":
            op = WriteOp("delete", pv_rel(*arg))
        elif kind == "delete-gm":
            op = WriteOp("delete", Relationship("group", arg[0], "member",
                                                "user", arg[1]))
            touched_groups.add(arg[0])
        else:
            op = WriteOp("delete", Relationship(
                "namespace", arg[0], "viewer", "group", arg[1], "member"))
            touched_groups.add(arg[1])
        r = op.rel
        u = r.subject_id if r.subject_type == "user" else \
            subjects[k % len(subjects)]
        if r.resource_type == "pod":
            touched_pods.add(r.resource_id)
        if r.subject_type == "user":
            touched_users.add(r.subject_id)
        jt = hist_total("store_write_seconds")
        ot = hist_total("engine_graph_incremental_seconds")
        pt = hist_total("engine_overlay_patch_seconds")
        t0 = time.perf_counter()
        e.write_relationships([op])
        w_ms.append((time.perf_counter() - t0) * 1e3)
        j_ms.append((hist_total("store_write_seconds") - jt) * 1e3)
        o_ms.append((hist_total("engine_graph_incremental_seconds") - ot)
                    * 1e3)
        p_ms.append((hist_total("engine_overlay_patch_seconds") - pt) * 1e3)
        t0 = time.perf_counter()
        list_mask(u)
        r_ms.append((time.perf_counter() - t0) * 1e3)
    dc = counter("engine_graph_compiles_total") - c0
    di = counter("engine_graph_incremental_updates_total") - i0
    cg = e.compiled()
    kinds = {k: sum(1 for kk, _ in plan if kk == k) for k in
             ("touch", "retouch", "delete", "delete-gm", "delete-nv")}
    log(f"phase 9b write->read: {len(plan)} pairs {kinds}; write p50 "
        f"{pct(w_ms, 50):.3f} ms p99 {pct(w_ms, 99):.3f} ms, "
        f"read-after-write p50 {pct(r_ms, 50):.3f} ms p99 "
        f"{pct(r_ms, 99):.3f} ms")
    log(f"  per-write split p50 (p99): journal {pct(j_ms, 50):.3f} "
        f"({pct(j_ms, 99):.3f}) ms, overlay append: host commit "
        f"{pct(o_ms, 50):.3f} ({pct(o_ms, 99):.3f}) ms + device patch "
        f"{pct(p_ms, 50):.3f} ({pct(p_ms, 99):.3f}) ms, dispatch "
        f"{pct(r_ms, 50):.3f} ({pct(r_ms, 99):.3f}) ms")
    log(f"  recompiles {dc:.0f}, incremental updates {di:.0f}; n_delta "
        f"{cg.n_delta}, n_dead {cg.n_dead} (capacity {cg.delta_cap}); "
        f"a write's stall before the overlay: compile_graph + device build "
        f"{stall_s:.2f} s (phase 3)")
    check(dc == 0, f"9b: {dc:.0f} recompiles during write churn")
    check(di == len(plan), f"9b: {di:.0f} incremental updates for "
          f"{len(plan)} writes")

    # -- 9c: correctness at full scale --
    snap_users = e._objects_by_name()["user"]
    members = set()
    if touched_groups:
        for g in touched_groups:  # every member of a touched group
            members |= {r.subject_id for r in e.read_relationships(
                RelationshipFilter(resource_type="group", resource_id=g,
                                   relation="member"))}
    check_users = sorted(touched_users | members
                         | {f"u{i}" for i in rng.choice(N_USERS, 10,
                                                        replace=False)})
    check_users = [u for u in check_users if snap_users.lookup(u) is not None]
    now = time.time()
    n = cg.type_sizes["pod"]
    t0 = time.perf_counter()
    want = view_masks(e.store, check_users, now, n)
    ref_s = time.perf_counter() - t0
    auto, pull = {}, {}
    for u in check_users:
        auto[u] = list_mask(u, now=now)
    with semiring.force_mode("pull"):
        for u in check_users:
            pull[u] = list_mask(u, now=now)
    for u in check_users:
        check(np.array_equal(auto[u], pull[u]),
              f"9c: push and pull masks differ for {u}")
        check(np.array_equal(auto[u], want[u]),
              f"9c: the mask for {u} disagrees with the host reference "
              f"({int(auto[u].sum())} vs {int(want[u].sum())} pods)")
    anchor = sorted(set(check_users[:: max(1, len(check_users) // 5)][:5])
                    | ({sorted(members)[0]} if members else set()))
    t0 = time.perf_counter()
    oids = oracle_ids(e.store, e.schema, OracleEvaluator, Snapshot, anchor,
                      now)
    oracle_s = time.perf_counter() - t0
    for u in anchor:
        ids = {pods.string(i) for i in np.flatnonzero(want[u])}
        check(ids == oids[u], f"9c: the host reference disagrees with "
              f"OracleEvaluator for {u}")
    bulk_users = (sorted(touched_users) + [f"u{i}" for i in range(64)])[:64]
    bulk_users = list(dict.fromkeys(bulk_users))
    while len(bulk_users) < 64:
        bulk_users.append(f"u{rng.integers(N_USERS)}")
        bulk_users = list(dict.fromkeys(bulk_users))
    tp = sorted(touched_pods)
    items = [CheckItem("pod", tp[rng.integers(len(tp))] if j % 2 else
                       f"ns/p{rng.integers(N_PODS)}", "view", "user", u)
             for u in bulk_users for j in range(1024)]
    bmask = view_masks(e.store, bulk_users, now, n)
    verdicts = e.check_bulk(items, now=now)
    expect = [bool(bmask[it.subject_id][pods.lookup(it.resource_id)])
              for it in items]
    check(verdicts == expect, f"9c: {sum(a != b for a, b in zip(verdicts, expect))}"
          f" of {len(items)} bulk verdicts disagree with the reference")
    launches = {"bit_or_matmul": bitprop.bit_or_matmul.launches,
                "dense_or_matmul": bitprop.dense_or_matmul.launches}
    log(f"phase 9c correctness: {len(check_users)} subjects' masks "
        f"(auto and forced pull) byte-equal to each other and to the host "
        f"reference ({ref_s:.1f} s), which matched OracleEvaluator on "
        f"{len(anchor)} subjects ({oracle_s:.1f} s); bulk check "
        f"{len(items)} items ({sum(verdicts)} allowed) exact")
    log(f"  launches over 9b-9c: {launches}")
    for kname, cnt in launches.items():
        check(cnt > 0, f"{kname} was not launched on the write path")

    # -- 9d: one compaction fold --
    comp = e.enable_compaction()
    occ0 = e.compiled().n_delta
    t0 = time.perf_counter()
    check(comp.compact(), "9d: the compaction fold did not publish")
    fold_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    after = {u: list_mask(u, now=now) for u in check_users}
    rebuild_s = time.perf_counter() - t0
    e.close_compaction()
    for u in check_users:
        check(np.array_equal(after[u], auto[u]),
              f"9d: the mask for {u} changed across the compaction swap")
    check(e.compiled().n_delta == 0 and e.compiled().n_dead == 0,
          "9d: the fold left overlay occupancy")
    log(f"phase 9d compaction: fold {fold_s:.2f} s (compile_graph of the "
        f"churned store), occupancy {occ0} -> 0, first lists after the "
        f"swap {rebuild_s:.2f} s for {len(check_users)} subjects (device "
        f"build included); masks unchanged")

    # -- 9e: an overlay grant that expires --
    u = subjects[0]
    m0 = list_mask(u)
    hidden = np.flatnonzero(~m0[2:len(pods)]) + 2
    p = int(hidden[rng.integers(len(hidden))])
    exp_at = time.time() + 2.0
    e.write_relationships([WriteOp("touch", pv_rel(pods.string(p), u,
                                                   exp=exp_at))])
    m1 = list_mask(u)
    check(time.time() < exp_at and bool(m1[p]),
          "9e: the expiring grant is not visible before its expiry")
    rev = e.revision
    time.sleep(max(0.0, exp_at + 0.05 - time.time()))
    m2 = list_mask(u)
    check(e.revision == rev and not m2[p] and np.array_equal(m2, m0),
          "9e: the expired grant is still visible")
    log(f"phase 9e expiry: pod {pods.string(p)} visible to {u} before its "
        f"2 s expiry and gone after it, with no write in between")

    # -- 9f: the same write->read pairs on the recompile path --
    c0 = counter("engine_graph_compiles_total")
    fw, fr = [], []
    features.set("IncrementalGraphUpdates", False)
    try:
        for _ in range(3):
            op = WriteOp("touch", rand_pv())
            t0 = time.perf_counter()
            e.write_relationships([op])
            fw.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            check(bool(list_mask(op.rel.subject_id)[
                pods.lookup(op.rel.resource_id)]), "9f: a grant is missing")
            fr.append((time.perf_counter() - t0) * 1e3)
    finally:
        features.reset()
    dc = counter("engine_graph_compiles_total") - c0
    check(dc == 3, f"9f: {dc:.0f} recompiles for 3 writes with the overlay "
          "off")
    log(f"phase 9f overlay off (IncrementalGraphUpdates=false, the path "
        f"before this slice): 3 write->read pairs, write p50 "
        f"{pct(fw, 50):.3f} ms, read-after-write p50 {pct(fr, 50):.3f} ms "
        f"(max {max(fr):.3f}): one recompile and device build each")

    # -- 9g: mixed traffic, one thread each --
    mixed_items = [CheckItem("pod", f"ns/p{rng.integers(N_PODS)}", "view",
                             "user", u) for u in bulk_users
                   for _ in range(1024)]
    list_mask(subjects[0])  # the device build after 9f's last recompile

    def mixed(with_writer: bool, n_bulk: int = 8):
        stop = threading.Event()
        lists, writes, bulks, wrote, errors = [], [], [], [], []
        wrng = np.random.default_rng(seed + 97)

        def guard(fn):
            def run():
                try:
                    fn()
                except BaseException as ex:  # reported after the join
                    errors.append(ex)
                    stop.set()
            return run

        def lister():
            k = 0
            while not stop.is_set():
                t0 = time.perf_counter()
                list_mask(subjects[k % len(subjects)])
                lists.append((time.perf_counter() - t0) * 1e3)
                k += 1

        def bulker():
            for _ in range(n_bulk):
                t0 = time.perf_counter()
                e.check_bulk(mixed_items)
                bulks.append((time.perf_counter() - t0) * 1e3)
            stop.set()

        def writer():
            while not stop.is_set():
                rel = pv_rel(f"ns/p{wrng.integers(N_PODS)}",
                             f"u{wrng.integers(N_USERS)}")
                t0 = time.perf_counter()
                e.write_relationships([WriteOp("touch", rel)])
                writes.append((time.perf_counter() - t0) * 1e3)
                wrote.append(rel)
                stop.wait(0.01)

        fns = (lister, bulker) + ((writer,) if with_writer else ())
        threads = [threading.Thread(target=guard(f)) for f in fns]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        check(not any(t.is_alive() for t in threads),
              "9g: a traffic thread did not finish")
        check(not errors, f"9g: a traffic thread raised {errors[:1]!r}")
        return lists, writes, bulks, wrote

    c0, i0 = counter("engine_graph_compiles_total"), counter(
        "engine_graph_incremental_updates_total")
    base_l, _, base_b, _ = mixed(False)
    mix_l, mix_w, mix_b, wrote = mixed(True)
    dc = counter("engine_graph_compiles_total") - c0
    di = counter("engine_graph_incremental_updates_total") - i0
    check(dc == 0, f"9g: {dc:.0f} recompiles under mixed traffic")
    check(di == len(wrote), f"9g: {di:.0f} incremental updates for "
          f"{len(wrote)} writes")
    now = time.time()
    users = sorted({r.subject_id for r in wrote})[:16]
    want = view_masks(e.store, users, now, e.compiled().type_sizes["pod"])
    for u in users:
        check(np.array_equal(list_mask(u, now=now), want[u]),
              f"9g: the mask for {u} disagrees with the host reference "
              "after mixed traffic")
    log(f"phase 9g mixed traffic, one thread each: lists beside a bulk "
        f"checker p50 {pct(base_l, 50):.3f} ms p99 {pct(base_l, 99):.3f} ms "
        f"({len(base_l)} lists, bulk checks p50 {pct(base_b, 50):.1f} ms); "
        f"with a writer every 10 ms too: lists p50 {pct(mix_l, 50):.3f} ms "
        f"p99 {pct(mix_l, 99):.3f} ms max {max(mix_l):.3f} ms "
        f"({len(mix_l)} lists), writes p50 {pct(mix_w, 50):.3f} ms p99 "
        f"{pct(mix_w, 99):.3f} ms ({len(mix_w)} writes), bulk checks p50 "
        f"{pct(mix_b, 50):.1f} ms")
    log(f"  recompiles {dc:.0f}, incremental updates {di:.0f}; "
        f"{len(users)} of the writer's subjects exact against the host "
        "reference")
    return launches


# the serving front's multi-tenant shape (BASELINE.json config 5): 256
# concurrent list requests for distinct users, from 32 threads
N_TENANT_LISTS, N_TENANT_THREADS = 256, 32
# BIG_CACHE is the decision cache's size for the serving phase: an
# --authz-cache-size that holds one 64 x 1,024 bulk check's verdicts (the
# default 65,536 entries, split over 16 shards, would evict some of them)
BIG_CACHE = 1 << 20


class NbSpy:
    """Swap in a ``bit_or_matmul`` that records each call's ``n_b`` and
    still launches the kernel; on exit the launches it took (counted on
    the spy, the wrapper counting through the module-level name) are
    added back to the real wrapper's count."""

    def __init__(self, bitprop):
        self.bitprop, self.n_b = bitprop, {}

    def __enter__(self):
        real = self.real = self.bitprop.bit_or_matmul

        def spy(a, vb, nb):
            self.n_b[nb] = self.n_b.get(nb, 0) + 1
            return real(a, vb, nb)

        spy.launches = 0
        self.spy = spy
        self.bitprop.bit_or_matmul = spy
        return self

    def __exit__(self, *exc):
        self.bitprop.bit_or_matmul = self.real
        self.real.launches += self.spy.launches
        return False


def fused_batch(e, users: list) -> list:
    """One fused dispatch of ``users``' list filters: a batcher that
    flushes at exactly ``len(users)`` rows (the last submit runs it);
    returns the masks."""
    e.enable_lookup_batching(window=60.0, max_rows=len(users))
    try:
        futs = [e.lookup_resources_mask_async("pod", "view", "user", u)
                for u in users]
        return [f.result()[0] for f in futs]
    finally:
        e.disable_lookup_batching()


def serving_phase(torch, e, subjects: list, items: list,
                  seed: int) -> tuple:
    """Phase S: the serving front on the headline engine (see the module
    docstring). Returns (both kernels' launches over S.a and S.c-S.e, the
    bit kernel's readings at the fused batch's inputs, S.a's lists/s with
    batching off and on)."""
    from spicedb_kubeapi_proxy_tpu_torch.engine.store import WriteOp
    from spicedb_kubeapi_proxy_tpu_torch.models.tuples import Relationship
    from spicedb_kubeapi_proxy_tpu_torch.ops import bitprop
    from spicedb_kubeapi_proxy_tpu_torch.utils.metrics import metrics

    rng = np.random.default_rng(seed + 110)

    def counter(name, **kw):
        return metrics.counter(name, **kw).value

    def launches():
        return {"bit_or_matmul": bitprop.bit_or_matmul.launches,
                "dense_or_matmul": bitprop.dense_or_matmul.launches}

    def list_mask(u):
        return e.lookup_resources_mask("pod", "view", "user", u)[0]

    objs = e._objects_by_name()
    pods, n = objs["pod"], e.compiled().type_sizes["pod"]
    picks = rng.choice(N_USERS, N_TENANT_LISTS + 24, replace=False)
    users = [f"u{i}" for i in picks[:N_TENANT_LISTS]]
    spare = [f"u{i}" for i in picks[N_TENANT_LISTS:]]  # never listed in S.a
    check(e._batcher is None and e._decision_cache is None,
          "S: the engine starts with the serving front off")
    fused_batch(e, spare[:8])  # warm-up: the B=8 state's first allocation

    def tenant_lists(label: str) -> tuple:
        """256 list filters from 32 threads (8 each, released together):
        {user: mask} and the readings."""
        out, lat, sub, iters, errors = {}, [], [], [], []
        lock = threading.Lock()
        barrier = threading.Barrier(N_TENANT_THREADS)

        def worker(k):
            try:
                barrier.wait(60)
                for u in users[k::N_TENANT_THREADS]:
                    t0 = time.perf_counter()
                    fut = e.lookup_resources_mask_async("pod", "view",
                                                        "user", u)
                    t1 = time.perf_counter()
                    m, _ = fut.result()
                    t2 = time.perf_counter()
                    with lock:
                        out[u] = m
                        lat.append((t2 - t0) * 1e3)
                        sub.append((t1 - t0) * 1e3)
                        iters.append(fut.iterations())
            except BaseException as ex:  # reported after the join
                errors.append(ex)

        l0 = counter("engine_lookups_total")
        b0 = counter("engine_lookup_batches_total")
        threads = [threading.Thread(target=worker, args=(k,), daemon=True)
                   for k in range(N_TENANT_THREADS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        wall = time.perf_counter() - t0
        check(not any(t.is_alive() for t in threads),
              f"S.a {label}: a list thread did not finish")
        check(not errors, f"S.a {label}: a list thread raised {errors[:1]!r}")
        check(len(out) == N_TENANT_LISTS, f"S.a {label}: {len(out)} masks")
        dl = counter("engine_lookups_total") - l0
        db = counter("engine_lookup_batches_total") - b0
        r = dict(rate=N_TENANT_LISTS / wall, p50=pct(lat, 50),
                 p99=pct(lat, 99), per_list=db / max(dl, 1), batches=db,
                 lookups=dl, iters=sorted(set(iters)), sub50=pct(sub, 50),
                 sub_max=max(sub), slow_sub=sum(s > 1.0 for s in sub))
        log(f"phase S.a {label}: {N_TENANT_LISTS} lists from "
            f"{N_TENANT_THREADS} threads in {wall * 1e3:.1f} ms: "
            f"{r['rate']:.1f} lists/s, p50 {r['p50']:.3f} ms p99 "
            f"{r['p99']:.3f} ms a list; {db:.0f} fused dispatches for "
            f"{dl:.0f} dispatched lookups ({r['per_list']:.4f} a list); "
            f"iterations {r['iters']}; submit p50 {r['sub50']:.3f} ms, max "
            f"{r['sub_max']:.3f} ms, {r['slow_sub']} submits over 1 ms "
            "(the fillers, which run the fused fixpoint)")
        return out, r

    # -- S.a: 256 concurrent lists, three ways; launches counted from here
    torch.cuda.synchronize()
    bitprop.reset_launch_counts()
    plain, r_off = tenant_lists("batching off")
    # the yardstick: the same 256 lists from one thread, one at a time
    t0 = time.perf_counter()
    for u in users:
        check(np.array_equal(list_mask(u), plain[u]),
              f"S.a: the sequential mask for {u} differs")
    seq = time.perf_counter() - t0
    log(f"  the same {N_TENANT_LISTS} lists from one thread in turn: "
        f"{seq * 1e3:.1f} ms, {N_TENANT_LISTS / seq:.1f} lists/s")
    now = time.time()
    want = view_masks(e.store, users, now, n)
    for u in users:
        check(np.array_equal(plain[u], want[u]), f"S.a: the unbatched mask "
              f"for {u} disagrees with the host reference")
    e.enable_lookup_batching()  # the reference's defaults: 2 ms, 8 rows
    with NbSpy(bitprop) as spy:
        fused, r_on = tenant_lists("batching on (window 2 ms, max_rows 8)")
    e.enable_decision_cache(max_entries=BIG_CACHE)
    cached, r_cache = tenant_lists("batching and decision cache on")
    e.disable_lookup_batching()
    for u in users:
        check(np.array_equal(fused[u], plain[u]) and
              np.array_equal(cached[u], plain[u]),
              f"S.a: a batched mask for {u} differs from the unbatched one")
    log(f"  every batched mask byte-equal to the unbatched one, and those "
        f"to the host reference; bit_or_matmul calls by n_b with batching "
        f"on: {dict(sorted(spy.n_b.items()))}")
    check(r_on["batches"] > 0 and max(spy.n_b) > 1,
          "S.a: batching on ran no fused batch of more than one row")

    # -- S.c: repeat traffic at one revision, cache on (batching off: one
    # thread in turn, so a window would only add its wait to each miss)
    e.disable_decision_cache()
    e.enable_decision_cache(max_entries=BIG_CACHE)
    subjects = list(dict.fromkeys(subjects))
    h0, m0 = (counter("engine_decision_cache_hits_total", kind="lookup"),
              counter("engine_decision_cache_misses_total", kind="lookup"))
    rev0 = e.revision
    miss_ms, hit_ms, first = [], [], {}
    for u in subjects:
        t0 = time.perf_counter()
        first[u] = list_mask(u)
        miss_ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    k0, l0 = launches(), counter("engine_lookups_total")
    for _ in range(9):
        for u in subjects:
            t0 = time.perf_counter()
            m = list_mask(u)
            hit_ms.append((time.perf_counter() - t0) * 1e3)
            check(np.array_equal(m, first[u]),
                  f"S.c: a cached mask for {u} differs from its miss")
    dh = counter("engine_decision_cache_hits_total", kind="lookup") - h0
    dm = counter("engine_decision_cache_misses_total", kind="lookup") - m0
    check(launches() == k0 and counter("engine_lookups_total") == l0
          and e.revision == rev0,
          f"S.c: all-hit rounds launched {launches()} (from {k0}) or "
          "dispatched")
    check(dh == 9 * len(subjects) and dm == len(subjects),
          f"S.c: {dh:.0f} hits and {dm:.0f} misses")
    log(f"phase S.c repeat lists, {len(subjects)} users x 10 at one "
        f"revision: hit ratio {dh / (dh + dm):.4f}; hit p50 "
        f"{pct(hit_ms, 50):.4f} ms p99 {pct(hit_ms, 99):.4f} ms, miss p50 "
        f"{pct(miss_ms, 50):.3f} ms p99 {pct(miss_ms, 99):.3f} ms; 0 kernel "
        f"launches and 0 dispatches over the {len(hit_ms)} hits")
    rates = []
    for k in range(2):
        if k:
            k0 = launches()
        t0 = time.perf_counter()
        verdicts = e.check_bulk(items)
        rates.append(len(items) / (time.perf_counter() - t0))
        if not k:
            cold = verdicts
    check(launches() == k0, "S.c: the all-hit bulk check launched a kernel")
    check(verdicts == cold and cold == e.check_bulk(items, now=time.time()),
          "S.c: cached bulk verdicts differ from a dispatch")
    log(f"  bulk check {len(items)} items (64 x 1,024): first call (misses) "
        f"{rates[0]:,.0f} checks/s, second call (all hits, 0 launches) "
        f"{rates[1]:,.0f} checks/s; {sum(verdicts)} allowed")

    # -- S.d: singleflight (batching on with a 50 ms window, so all 16
    # reach the flight while the leader's batch waits)
    e.enable_lookup_batching(window=0.05)
    u = spare[8]
    res, errors = [None] * 16, []
    barrier = threading.Barrier(16)

    def asker(k):
        try:
            barrier.wait(60)
            res[k] = list_mask(u)
        except BaseException as ex:  # reported after the join
            errors.append(ex)

    l0, p0 = (counter("engine_lookups_total"),
              counter("engine_decision_cache_piggybacks_total"))
    b0 = counter("engine_lookup_batches_total")
    threads = [threading.Thread(target=asker, args=(k,), daemon=True)
               for k in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    e.disable_lookup_batching()
    check(not any(t.is_alive() for t in threads) and not errors,
          f"S.d: an asker hung or raised {errors[:1]!r}")
    dl = counter("engine_lookups_total") - l0
    dp = counter("engine_decision_cache_piggybacks_total") - p0
    db = counter("engine_lookup_batches_total") - b0
    ref = view_masks(e.store, [u], time.time(), n)[u]
    check(dl == 1 and db == 1 and dp == 15,
          f"S.d: {dl:.0f} dispatches, {db:.0f} batches, {dp:.0f} piggybacks"
          " (want 1, 1, 15)")
    check(all(np.array_equal(m, ref) for m in res),
          "S.d: an asker's mask differs from the host reference")
    log(f"phase S.d singleflight: 16 threads, one uncached list: {dl:.0f} "
        f"dispatch, {dp:.0f} piggybacks, every mask equal to the host "
        "reference")

    # -- S.e: invalidation
    u = subjects[0]
    m0 = list_mask(u)  # a hit at this revision
    hidden = np.flatnonzero(~m0[2:n]) + 2
    p = int(hidden[rng.integers(len(hidden))])
    mk0 = counter("engine_decision_cache_misses_total", kind="lookup")
    e.write_relationships([WriteOp("touch", Relationship(
        "pod", pods.string(p), "viewer", "user", u))])
    m1 = list_mask(u)
    check(counter("engine_decision_cache_misses_total", kind="lookup")
          - mk0 == 1, "S.e: the list after a write did not miss")
    check(bool(m1[p]) and np.array_equal(
        m1, view_masks(e.store, [u], time.time(), n)[u]),
        "S.e: the list after a write disagrees with the host reference")
    q = int(hidden[(np.searchsorted(hidden, p) + 1) % len(hidden)])
    exp_at = time.time() + 2.0
    e.write_relationships([WriteOp("touch", Relationship(
        "pod", pods.string(q), "viewer", "user", u, None, exp_at))])
    rev = e.revision
    hk0 = counter("engine_decision_cache_hits_total", kind="lookup")
    ma, mb = list_mask(u), list_mask(u)
    check(time.time() < exp_at and bool(ma[q]) and np.array_equal(ma, mb)
          and counter("engine_decision_cache_hits_total", kind="lookup")
          - hk0 == 1, "S.e: the expiring grant is not served from the "
          "cache before its deadline")
    time.sleep(max(0.0, exp_at + 0.05 - time.time()))
    mk0 = counter("engine_decision_cache_misses_total", kind="lookup")
    mc = list_mask(u)
    check(e.revision == rev and not mc[q] and np.array_equal(mc, m1)
          and counter("engine_decision_cache_misses_total", kind="lookup")
          - mk0 == 1, "S.e: the expired grant is still served")
    cache = e._decision_cache
    before = cache.stats()
    r0 = counter("engine_decision_cache_retired_total")
    comp = e.enable_compaction(1.0)
    try:
        check(comp.compact(), "S.e: the compaction fold did not publish")
    finally:
        e.close_compaction()
    after = cache.stats()
    dr = counter("engine_decision_cache_retired_total") - r0
    l0 = counter("engine_lookups_total")
    check(np.array_equal(list_mask(u), mc)
          and counter("engine_lookups_total") == l0,
          "S.e: the entry at the fold revision did not survive the fold")
    check(e.compiled().revision == rev and after["entries"] >= 1
          and dr == before["entries"] - after["entries"] > 0,
          f"S.e: the fold retired {dr:.0f} entries, {before} -> {after}")
    log(f"phase S.e invalidation: the list after a write missed and matched "
        f"the host reference; a grant expiring 2 s ahead served from the "
        f"cache before its deadline and gone after it, no write between; a "
        f"compaction fold at revision {rev} retired {dr:.0f} entries below "
        f"it ({before['entries']} entries, {before['mask_bytes']} mask "
        f"bytes -> {after['entries']}, {after['mask_bytes']}); the entry at "
        f"the fold revision still served")
    e.disable_decision_cache()

    # -- S.f: the serving path's launches
    torch.cuda.synchronize()
    served = launches()
    log(f"phase S.f serving-path launches over S.a and S.c-S.e: {served}")
    for kname, cnt in served.items():
        check(cnt > 0, f"{kname} was not launched on the serving path")

    # -- S.b: the bit kernel at the fused batch's inputs (launches for the
    # comparison are not counted)
    pv = next(i for i, b in enumerate(e.compiled().blocks)
              if b.dst_off == e.compiled().offset_of("pod", "viewer"))
    bits = e.compiled()._dev()["blocks_bits"][pv]
    fused_rows = {}
    for nb in (8, 4):
        got = {}
        real = bitprop.bit_or_matmul

        def cap(a, vb, k):
            if a is bits and k == nb:
                got.setdefault("bit", (a, vb.clone(), k))
            return real(a, vb, k)

        cap.launches = 0
        bitprop.bit_or_matmul = cap
        try:
            fused_batch(e, spare[9:9 + nb])
        finally:
            bitprop.bit_or_matmul = real
        check("bit" in got, f"S.b: the fused {nb}-row batch gave the "
              "pod#viewer block no bit hop at n_b={nb}")
        a, vb, k = got["bit"]
        row = time_bit(torch, bitprop, a, vb, k,
                       f"fused batch of {nb} lists")
        row["sparse_max_live"] = bitprop.bit_sparse_max_live(*a.shape)
        row["n_b"] = k
        fused_rows[nb] = row
        log(f"    {row['live']} live words in the union over {nb} rows "
            f"against the sparse path's limit {row['sparse_max_live']} "
            f"({'sparse' if row['live'] <= row['sparse_max_live'] else 'whole-row stream'})")

    # -- S.g: where the time goes in one fused dispatch
    trace_phase(torch, "fused list batch (8 lists, one dispatch, n_b=8)",
                lambda: fused_batch(e, spare[:8]), 8,
                {"bit_or_matmul_kernel": ("bit_or_matmul_kernel",),
                 "its small-dual stream kernel": (
                     "bit_or_matmul_stream_kernel",)})
    return served, fused_rows, {"off": r_off["rate"], "on": r_on["rate"]}


def list_masks(e, users) -> dict:
    """pod#view masks of ``users`` (the list filter, one call each)."""
    return {u: e.lookup_resources_mask("pod", "view", "user", u)[0]
            for u in users}


def same_masks(got: dict, want: dict, what: str) -> None:
    for u, m in want.items():
        check(np.array_equal(got[u], m), f"{what}: {u}'s mask differs")


class Launches:
    """Both kernels' launches over the calls made inside its ``with``
    blocks only: each block sets the counts to 0 and adds them up at its
    end, so the reference engine's calls between blocks count for no
    path."""

    def __init__(self, bitprop):
        self.bitprop = bitprop
        self.n = {"bit_or_matmul": 0, "dense_or_matmul": 0}

    def __enter__(self):
        self.bitprop.reset_launch_counts()
        return self

    def __exit__(self, *exc):
        self.n["bit_or_matmul"] += self.bitprop.bit_or_matmul.launches
        self.n["dense_or_matmul"] += self.bitprop.dense_or_matmul.launches
        return False


def timed_list(e, u) -> tuple:
    """One pod#view list of ``u`` on the tiered engine ``e``: (mask, wall
    ms, miss stall ms, blocks streamed, COO bytes streamed)."""
    from spicedb_kubeapi_proxy_tpu_torch.utils.metrics import metrics

    stall_h = metrics.histogram("engine_tier_miss_stall_seconds")
    misses = metrics.counter("engine_tier_misses_total")
    streamed = metrics.counter("engine_tier_streamed_bytes_total")
    s0, m0, b0 = stall_h.total, misses.value, streamed.value
    t0 = time.perf_counter()
    m = e.lookup_resources_mask("pod", "view", "user", u)[0]
    ms = (time.perf_counter() - t0) * 1e3
    return (m, ms, (stall_h.total - s0) * 1e3, misses.value - m0,
            streamed.value - b0)


def persistence_phase(torch, e, root: str, subjects: list, n_writes: int,
                      seed: int, frame_bytes: int) -> tuple:
    """Phase P: durability on the headline engine (see the module
    docstring). The recovered engine is tiered at twice the writer's block
    bytes. Returns (the recovered engine, both kernels' launches over the
    journaled writer's reads and the recovered engine's lists, its cold
    start for T.a, the subjects whose masks P.4 held)."""
    from spicedb_kubeapi_proxy_tpu_torch.engine import Engine
    from spicedb_kubeapi_proxy_tpu_torch.engine.store import WriteOp
    from spicedb_kubeapi_proxy_tpu_torch.models.tuples import Relationship
    from spicedb_kubeapi_proxy_tpu_torch.ops import bitprop
    from spicedb_kubeapi_proxy_tpu_torch.ops.reachability import block_nbytes
    from spicedb_kubeapi_proxy_tpu_torch.persistence import wal as walmod
    from spicedb_kubeapi_proxy_tpu_torch.utils.metrics import metrics

    rng = np.random.default_rng(seed + 70)
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)

    # -- P.0: the reckoning of a journaled headline load --
    log(f"phase P.0 a journaled bulk load of the headline rows would be one "
        f"WAL frame of {frame_bytes} bytes (fixed-width string columns), "
        f"{frame_bytes / walmod.MAX_WAL_FRAME:.4f} of MAX_WAL_FRAME "
        f"({walmod.MAX_WAL_FRAME}); the store is already loaded, so P takes "
        "the operator's path: enable persistence on an empty data dir, then "
        "checkpoint")

    # -- P.1: save_snapshot of the 10M store --
    path = os.path.join(root, "headline.npz")
    t0 = time.perf_counter()
    e.save_snapshot(path)
    save_s = time.perf_counter() - t0
    log(f"phase P.1 save_snapshot: {len(e.store)} live rows, revision "
        f"{e.revision}, {os.path.getsize(path)} bytes in {save_s:.2f} s")
    os.unlink(path)

    touched: set = set()
    mine: list = []  # grants written in P, some deleted again

    def one_write():
        if mine and rng.random() < 0.3:
            rel = mine.pop(int(rng.integers(len(mine))))
            op = WriteOp("delete", rel)
        else:
            rel = Relationship("pod", f"ns/p{rng.integers(N_PODS)}",
                               "viewer", "user", f"u{rng.integers(N_USERS)}")
            mine.append(rel)
            op = WriteOp("touch", rel)
        touched.add(rel.subject_id)
        t0 = time.perf_counter()
        e.write_relationships([op])
        w = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        e.lookup_resources_mask("pod", "view", "user", rel.subject_id)
        return w, (time.perf_counter() - t0) * 1e3

    def pairs(policy: str, data_dir: str, checkpoint: bool) -> dict:
        p = e.enable_persistence(data_dir, wal_fsync=policy)
        check(p.recovery.snapshot_path is None
              and p.recovery.replayed_records == 0,
              "P: an empty data dir restored something")
        cp_s = None
        if checkpoint:
            t0 = time.perf_counter()
            check(p.checkpoint_now() == e.revision, "P: checkpoint revision")
            cp_s = time.perf_counter() - t0
        c0 = metrics.counter("engine_graph_compiles_total").value
        one_write()  # warm
        w_ms, r_ms = [], []
        for _ in range(n_writes):
            w, r = one_write()
            w_ms.append(w)
            r_ms.append(r)
        dc = metrics.counter("engine_graph_compiles_total").value - c0
        wal_bytes = p.wal.appended_bytes
        e.close_persistence(final_checkpoint=False)
        check(dc == 0, f"P: {dc:.0f} recompiles under journaled writes")
        log(f"  {policy}: {n_writes} write->read pairs, write p50 "
            f"{pct(w_ms, 50):.3f} ms p99 {pct(w_ms, 99):.3f} ms, "
            f"read-after-write p50 {pct(r_ms, 50):.3f} ms p99 "
            f"{pct(r_ms, 99):.3f} ms; {wal_bytes} WAL bytes appended"
            + (f"; checkpoint of the {len(e.store)}-row store {cp_s:.2f} s"
               if checkpoint
               else "; no checkpoint (the append cost only)"))
        return {"w_ms": w_ms, "r_ms": r_ms, "checkpoint_s": cp_s}

    # -- P.2: journaled write->read pairs under two fsync policies --
    launches = Launches(bitprop)
    log("phase P.2 journaled writes (one engine, two data dirs):")
    with launches:
        pairs("always", os.path.join(root, "always"), False)
        data_dir = os.path.join(root, "data")
        pairs("interval:100", data_dir, True)

    # -- P.3: a fresh engine, tiered, recovers from the data dir --
    budget = 2 * sum(block_nbytes(b) for b in e.compiled().blocks)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    e2 = Engine(schema=e.schema, device=e.device,
                device_graph_budget_bytes=budget)
    p2 = e2.enable_persistence(data_dir)
    rec_s = time.perf_counter() - t0
    res = p2.recovery
    check(res.snapshot_path is not None, "P.3: no snapshot recovered")
    check(res.replayed_records == n_writes + 1,
          f"P.3: {res.replayed_records} records replayed, "
          f"{n_writes + 1} journaled after the checkpoint")
    check(e2.revision == e.revision and len(e2.store) == len(e.store),
          "P.3: the recovered store is not the writer's")
    t0 = time.perf_counter()
    cg2 = e2.compiled()
    compile_s = time.perf_counter() - t0
    tier = cg2.tier
    check(tier is not None and tier.budget_bytes == budget,
          "P.3: the recovered engine is not tiered at its budget")
    check(tier.hot_bytes() == 0 and not cg2.resident.tensors,
          "T.a: device block bytes before the first list")
    alloc0 = torch.cuda.memory_allocated()
    with launches:
        m, ms, stall, miss, nb = timed_list(e2, subjects[0])
    torch.cuda.synchronize()
    d = cg2.resident.tensors
    check(all(x is None for x in d["blocks"]),
          "T.a: the cold device state holds block tensors")
    cold = dict(budget=budget, compile_s=compile_s, list_ms=ms,
                stall_ms=stall, misses=miss, coo_bytes=nb, alloc0=alloc0,
                alloc1=torch.cuda.memory_allocated(),
                hot_bytes=tier.hot_bytes(),
                hot_blocks=tier.stats()["hot_blocks"], mask=m)
    log(f"phase P.3 recovery: {rec_s:.2f} s wall (recover() "
        f"{res.duration_s:.2f} s: snapshot at revision "
        f"{res.snapshot_revision} + {res.replayed_records} WAL records) "
        f"into an engine with device_graph_budget_bytes {budget}; first "
        f"list {compile_s + ms / 1e3:.2f} s after it (compile "
        f"{compile_s:.2f} s, then the list {ms:.3f} ms with its stream-in)")

    # -- P.4: every touched subject's mask byte-equal to the writer's --
    users = sorted(touched | set(subjects))
    want = list_masks(e, users)
    with launches:
        got = list_masks(e2, users)
    same_masks(got, want, "P.4 recovered vs writer")
    same_masks({subjects[0]: m}, {subjects[0]: want[subjects[0]]},
               "P.3 first list")
    log(f"phase P.4 {len(users)} masks of the recovered engine byte-equal "
        f"to the writer's; persistence-path launches {launches.n} (the "
        "journaled writer's reads and the recovered engine's lists)")
    check(launches.n["bit_or_matmul"] > 0,
          "bit_or_matmul was not launched on the persistence path")
    return e2, launches.n, cold, users


STREAM_STEPS = (("decode", "arena decode"), ("cut", "dead-cell cut"),
                ("stage", "pinned staging + upload enqueue"),
                ("copy", "host -> device copy (device)"),
                ("build", "block build (device)"))


def tiered_phase(torch, e, e2, subjects: list, items: list,
                 cold: dict) -> dict:
    """Phase T: tiered block residency on the recovered engine ``e2``,
    built tiered by P.3 (``cold``: its cold start), held against the
    untiered writer ``e`` (see the module docstring). Returns both
    kernels' launches over ``e2``'s calls in T."""
    from spicedb_kubeapi_proxy_tpu_torch.engine.store import \
        RelationshipFilter, WriteOp
    from spicedb_kubeapi_proxy_tpu_torch.models.tuples import Relationship
    from spicedb_kubeapi_proxy_tpu_torch.ops import bitprop
    from spicedb_kubeapi_proxy_tpu_torch.ops.reachability import \
        block_nbytes, tier_stream_timings
    from spicedb_kubeapi_proxy_tpu_torch.utils.metrics import metrics

    def counter(name):
        return metrics.counter(name).value

    def step_totals() -> dict:
        tier_stream_timings()  # the device steps' events, read
        return {k: metrics.histogram(f"engine_tier_stream_{k}_seconds").total
                for k, _ in STREAM_STEPS}

    launches = Launches(bitprop)
    cg = e2.compiled()
    tier = cg.tier
    want = list_masks(e, subjects)

    # -- T.a: the recovered engine's budget, twice the block bytes --
    total = sum(block_nbytes(b) for b in cg.blocks)
    log(f"phase T.a budget {cold['budget']} bytes (device_graph_budget_"
        f"bytes; {len(cg.blocks)} blocks of {total} bytes): 0 "
        f"hot block bytes before the first list (P.3); device memory "
        f"{cold['alloc0']} -> {cold['alloc1']} bytes allocated over it")
    log(f"  first list: {cold['list_ms']:.3f} ms wall, miss stall "
        f"{cold['stall_ms']:.3f} ms, {cold['misses']:.0f} blocks streamed "
        f"({cold['coo_bytes']:.0f} COO bytes); hot {cold['hot_bytes']} "
        f"bytes in {cold['hot_blocks']} blocks")
    lat, misses = [], 0
    with launches:
        for u in subjects[1:31]:
            m, ms, _, miss, _ = timed_list(e2, u)
            same_masks({u: m}, {u: want[u]}, "T.a")
            lat.append(ms)
            misses += miss
    check(misses == 0, f"T.a: {misses:.0f} misses after the first list")
    log(f"  {len(lat)} lists after it: 0 misses, p50 {pct(lat, 50):.3f} ms "
        f"p99 {pct(lat, 99):.3f} ms, masks equal the untiered engine's")

    # -- T.b: half of the largest block a pod list demands --
    demanded = [i for i, a in tier.stats()["accesses"].items() if a]
    big = max(demanded, key=lambda i: block_nbytes(cg.blocks[i]))
    bb = cg.blocks[big]
    budget = block_nbytes(bb) // 2
    tier = cg.enable_tiering(budget)
    gc.collect()
    log(f"phase T.b budget {budget} bytes, half of the largest demanded "
        f"block (dst@{bb.dst_off} [{bb.n_dst} x {bb.n_src}], "
        f"{block_nbytes(bb)} bytes); {len(demanded)} blocks demanded")
    lat, stalls, streamed = [], [], []
    steps = {k: [] for k, _ in STREAM_STEPS}
    with launches:
        for u in subjects[:30]:
            t0 = step_totals()
            m, ms, stall, miss, nb = timed_list(e2, u)
            t1 = step_totals()
            same_masks({u: m}, {u: want[u]}, "T.b")
            check(miss >= 1 and not tier.entry_resident(big),
                  f"T.b: the list for {u} did not stream the largest block")
            lat.append(ms)
            stalls.append(stall)
            streamed.append(nb)
            for k in steps:
                steps[k].append((t1[k] - t0[k]) * 1e3)
    log(f"  {len(lat)} lists, each streaming: p50 {pct(lat, 50):.3f} ms p99 "
        f"{pct(lat, 99):.3f} ms; miss stall p50 {pct(stalls, 50):.3f} ms "
        f"p99 {pct(stalls, 99):.3f} ms; {np.mean(streamed):.0f} COO bytes "
        f"streamed a list; hot {tier.hot_bytes()} bytes; masks equal the "
        f"untiered engine's")
    log("  a list's stream-ins by step (p50 / p99 over the lists, ms; host "
        "clocks on the prefetch workers, CUDA events on their streams): "
        + "; ".join(f"{what} {pct(steps[k], 50):.3f} / "
                    f"{pct(steps[k], 99):.3f}" for k, what in STREAM_STEPS))
    now = time.time()
    want_bulk = e.check_bulk(items, now=now)
    with launches:
        t0 = time.perf_counter()
        got = e2.check_bulk(items, now=now)
        bulk_s = time.perf_counter() - t0
    check(got == want_bulk,
          "T.b: the tiered bulk check differs from the untiered one")
    log(f"  64 x 1,024 bulk check: {len(items) / bulk_s:,.0f} checks/s, "
        f"{sum(got)} allowed, verdicts equal the untiered engine's")
    c0 = step_totals()["copy"]
    with launches:
        tr = trace_phase(
            torch, "tiered list (T.b, streams the largest block)",
            lambda: e2.lookup_resources_mask("pod", "view", "user",
                                             subjects[0]), 1,
            {"bit_or_matmul_kernel": ("bit_or_matmul_kernel",),
             "host -> device copies": ("Memcpy HtoD",)})
    # the trace runs the list three times (warm, untraced, traced)
    copy_ms = (step_totals()["copy"] - c0) * 1e3 / 3
    traced = (tr or {}).get("labels", {}).get("host -> device copies", 0.0)
    if traced < 0.5 * copy_ms:
        log(f"  the trace's device busy time and idle share: not measured "
            f"(it holds {traced:.4f} ms of host -> device copies against "
            f"the {copy_ms:.4f} ms the worker stream's events give one "
            "list's stream-in copy)")
    else:
        log(f"  the trace holds the stream-in's copy ({traced:.4f} ms; the "
            f"worker stream's events: {copy_ms:.4f} ms)")

    # -- T.b: 20 writes that pin blocks (re-touches of base grants) --
    c0 = counter("engine_graph_compiles_total")
    for u in subjects[:20]:
        base = e.store.read(RelationshipFilter(
            resource_type="pod", relation="viewer", subject_type="user",
            subject_id=u))
        check(bool(base), f"T.b: {u} holds no pod#viewer grant")
        op = WriteOp("touch", Relationship(
            "pod", base[0].resource_id, "viewer", "user", u, None,
            time.time() + 3600))
        e.write_relationships([op])
        with launches:
            e2.write_relationships([op])
    check(counter("engine_graph_compiles_total") == c0,
          "T.b: a pinning write recompiled")
    st = tier.stats()
    log(f"  20 writes re-touching base grants: {st['pinned_blocks']} "
        f"blocks pinned, hot {st['hot_bytes']} bytes")
    check(st["pinned_blocks"] >= 1, "T.b: no block pinned by the writes")
    check(not tier.entry_resident(big), "T.b: the largest block went hot "
          "before the sweep")

    # the compactor's placement sweep (threshold 1: no fold)
    comp = e2.enable_compaction(1.0)
    t0 = time.perf_counter()
    with launches:
        comp.request_placement()
        while not tier.entry_resident(big):
            check(time.perf_counter() - t0 < 60, "T.b: the compactor's "
                  "sweep left the pinned block cold for 60 s")
            time.sleep(0.001)
        torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    e2.close_compaction()
    st = tier.stats()
    want = list_masks(e, subjects)
    misses = counter("engine_tier_misses_total")
    with launches:
        got = list_masks(e2, subjects)
    same_masks(got, want, "T.b after the sweep")
    log(f"  the compactor's placement sweep: {sweep_s * 1e3:.3f} ms from "
        f"its request to the pinned block hot on the card; "
        f"{st['hot_blocks']} blocks hot, {st['hot_bytes']} bytes (budget "
        f"{budget}: pins may overshoot), {st['pinned_blocks']} pinned; "
        f"{counter('engine_tier_misses_total') - misses:.0f} misses over "
        f"{len(subjects)} lists after it, masks equal the untiered engine's")
    log(f"  tiered-path launches over T (the tiered engine's calls only): "
        f"{launches.n}")
    for kname, n in launches.n.items():
        check(n > 0, f"{kname} was not launched on the tiered path")
    return launches.n


class LoopThread:
    """An asyncio loop on a thread of its own, for an in-process engine
    host: ``run(coro)`` runs a coroutine there and returns its result."""

    def __init__(self):
        import asyncio

        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True)
        self.thread.start()

    def run(self, coro, timeout: float = 120.0):
        import asyncio

        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(
            timeout)

    def close(self) -> None:
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(30)
        check(not self.thread.is_alive(), "R: the host's loop did not stop")
        self.loop.close()


class EngineTimes:
    """Host clocks around ``e.<name>`` inside its ``with`` block: the
    engine's share of a wire call (the host's op handlers call the
    engine's methods through the instance)."""

    def __init__(self, e, name: str):
        self.e, self.name, self.ms = e, name, []

    def __enter__(self):
        real = getattr(self.e, self.name)

        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return real(*a, **kw)
            finally:
                self.ms.append((time.perf_counter() - t0) * 1e3)

        setattr(self.e, self.name, timed)
        return self

    def __exit__(self, *exc):
        delattr(self.e, self.name)
        return False


def frame_bytes(remote, result) -> int:
    """Bytes of the JSON response frame that carried ``result`` (the host
    packs ``{"ok": true, "result": ...}`` with the same encoder)."""
    return len(remote._pack({"ok": True, "result": result}))


def remote_phase(torch, e, subjects: list, items: list, now: float,
                 inproc: dict, seed: int) -> dict:
    """Phase R.a-R.d: the engine host (engine/remote.py) in process on the
    headline engine, the port's RemoteEngine on loopback TCP (see the
    module docstring). ``inproc``: phase 5's list p50, phase 6's checks/s
    and S.a's lists/s from this run. Returns both kernels' launches over
    the host's engine calls in R.a-R.d."""
    from spicedb_kubeapi_proxy_tpu_torch.engine import CheckItem, remote
    from spicedb_kubeapi_proxy_tpu_torch.engine.store import WriteOp
    from spicedb_kubeapi_proxy_tpu_torch.models.tuples import Relationship
    from spicedb_kubeapi_proxy_tpu_torch.ops import bitprop
    from spicedb_kubeapi_proxy_tpu_torch.utils.metrics import metrics

    rng = np.random.default_rng(seed + 120)
    compiles = metrics.counter("engine_graph_compiles_total")
    check(e._batcher is None and e._decision_cache is None,
          "R: the engine starts with the serving front off")
    launches = Launches(bitprop)

    def inproc_lists() -> tuple:
        out, ms = {}, []
        for u in subjects:
            t0 = time.perf_counter()
            out[u] = e.lookup_resources_mask("pod", "view", "user", u)[0]
            ms.append((time.perf_counter() - t0) * 1e3)
        return out, ms

    # the in-process answers (untallied), timed at this engine state on
    # this thread and on a worker thread of its own
    want, main_ms = inproc_lists()
    box: dict = {}
    worker = threading.Thread(target=lambda: box.update(r=inproc_lists()))
    worker.start()
    worker.join(300)
    check("r" in box, "R: the in-process lists on a worker thread")
    worker_ms = box["r"][1]
    lt = LoopThread()
    server = remote.EngineServer(e)
    lt.run(server.start())
    c = remote.RemoteEngine("127.0.0.1", server.port)
    try:
        # -- R.a: the headline list over the wire --
        args = dict(resource_type="pod", permission="view",
                    subject_type="user", subject_relation=None, now=None,
                    ctx=None)
        with launches:
            meta, payload = c._call_any("lookup_mask",
                                        subject_id=subjects[0], **args)
            check(meta["n"] == len(want[subjects[0]])
                  and len(payload) == (meta["n"] + 7) // 8,
                  f"R.a: mask frame meta {meta}, {len(payload)} bytes")
            t0 = time.perf_counter()
            ids = c._sync_ids("pod", meta["gen"], meta["epoch"])
            sync_ms = (time.perf_counter() - t0) * 1e3
        check(ids is not None and len(ids) == meta["gen"],
              "R.a: the first id sync")
        sync_bytes = frame_bytes(remote, c._call(
            "object_ids", type="pod", **{"from": 0}))
        mask_frame = len(remote._pack_binary(remote.BinaryResult(
            meta, payload)))

        def wire_lists() -> tuple:
            lat = []
            with EngineTimes(e, "lookup_resources_mask") as host:
                for u in subjects:
                    t0 = time.perf_counter()
                    m, _ = c.lookup_resources_mask("pod", "view", "user", u)
                    lat.append((time.perf_counter() - t0) * 1e3)
                    check(np.array_equal(m, want[u]),
                          f"R.a: the wire mask for {u} differs from the "
                          "in-process one")
            return lat, host.ms

        with launches:
            c.lookup_resources_mask("pod", "view", "user", subjects[1])
            lat, host_ms = wire_lists()
            # the same lists with the interpreter's thread switch interval
            # at 0.5 ms instead of 5: how much of the wire's cost is threads
            # waiting for the GIL (a diagnostic; the host keeps the default)
            swi = sys.getswitchinterval()
            sys.setswitchinterval(0.0005)
            try:
                lat_sw, host_sw = wire_lists()
            finally:
                sys.setswitchinterval(swi)
        log(f"phase R.a list over the wire (in-process EngineServer, port "
            f"RemoteEngine, loopback TCP): {len(lat)} subjects, p50 "
            f"{pct(lat, 50):.3f} ms p99 {pct(lat, 99):.3f} ms wall; the "
            f"engine's call inside the host p50 {pct(host_ms, 50):.3f} ms; "
            f"in process at this engine state: p50 {pct(main_ms, 50):.3f} "
            f"ms on the main thread, {pct(worker_ms, 50):.3f} ms on a "
            f"thread of its own (phase 5: {inproc['list_p50']:.3f} ms); "
            "every mask byte-equal to the in-process engine's")
        log(f"  with the switch interval at 0.5 ms (default {swi * 1e3:.1f} "
            f"ms): wire p50 {pct(lat_sw, 50):.3f} ms p99 "
            f"{pct(lat_sw, 99):.3f} ms, the engine's call p50 "
            f"{pct(host_sw, 50):.3f} ms")
        log(f"  mask frame: {len(payload)} payload bytes ({meta['n']} "
            f"slots packed), {mask_frame} bytes on the wire; first id "
            f"sync: {meta['gen']} pod ids, {sync_bytes} bytes, "
            f"{sync_ms:.3f} ms")
        # a write that adds a pod: the next list syncs only the new id
        spy = []
        orig = type(c)._call_any

        def spying(this, op, **kw):
            r = orig(this, op, **kw)
            spy.append((op, kw, r))
            return r

        c._call_any = spying.__get__(c)
        c0 = compiles.value
        with launches:
            c.write_relationships([WriteOp("touch", Relationship(
                "pod", "ns/p-wire-new", "viewer", "user", subjects[0]))])
            t0 = time.perf_counter()
            m, it = c.lookup_resources_mask("pod", "view", "user",
                                            subjects[0])
            inc_ms = (time.perf_counter() - t0) * 1e3
        del c._call_any
        syncs = [(kw, r) for op, kw, r in spy if op == "object_ids"]
        check(len(syncs) == 1 and syncs[0][0]["from"] == meta["gen"]
              and syncs[0][1]["ids"] == ["ns/p-wire-new"],
              f"R.a: the incremental sync fetched {syncs!r:.300}")
        check("ns/p-wire-new" in {it.string(i) for i in
                                   np.flatnonzero(m).tolist()},
              "R.a: the new pod is not in its grantee's list")
        want[subjects[0]] = list_masks(e, subjects[:1])[subjects[0]]
        check(np.array_equal(m, want[subjects[0]]),
              "R.a: the list after the write differs from the in-process one")
        log(f"  incremental sync after a write adding a pod: from "
            f"{syncs[0][0]['from']}, 1 id, "
            f"{frame_bytes(remote, syncs[0][1])} bytes; that list "
            f"{inc_ms:.3f} ms; {compiles.value - c0:.0f} recompiles")

        # -- R.b: the 64 x 1,024 bulk check over the wire --
        verdicts = e.check_bulk(items, now=now)  # untallied reference
        rates = []
        with launches, EngineTimes(e, "check_bulk") as host:
            for _ in range(5):
                t0 = time.perf_counter()
                got = c.check_bulk(items, now=now)
                rates.append(len(items) / (time.perf_counter() - t0))
                check(got == verdicts, "R.b: wire verdicts differ from "
                      "the in-process ones")
        # a wire bulk check's host-side stages, each timed alone on this
        # thread at the same inputs (the engine's from inside the host)
        st, t0 = {}, time.perf_counter()
        rows = [[it.resource_type, it.resource_id, it.permission,
                 it.subject_type, it.subject_id, it.subject_relation]
                for it in items]
        st["client: items to rows"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        body = remote._pack({"op": "check_bulk", "now": now, "ctx": None,
                             "items": rows})
        st["client: request JSON"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        req = json.loads(body[4:])
        st["host: request parse"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        [CheckItem(*it) for it in req["items"]]
        st["host: rows to CheckItems"] = time.perf_counter() - t0
        st["host: the engine's check_bulk"] = pct(host.ms, 50) / 1e3
        t0 = time.perf_counter()
        resp = remote._pack({"ok": True, "result": verdicts})
        st["host: response JSON"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        json.loads(resp[4:])
        st["client: response parse"] = time.perf_counter() - t0
        call_ms = len(items) / np.median(rates) * 1e3
        staged = sum(st.values()) * 1e3
        log(f"phase R.b bulk check over the wire: {len(items)} checks, p50 "
            f"{np.median(rates):,.0f} checks/s over 5 trials (min "
            f"{min(rates):,.0f}, max {max(rates):,.0f}; phase 6 in process: "
            f"{inproc['checks_per_s']:,.0f}); verdicts equal the in-process "
            f"ones ({sum(verdicts)} allowed); request frame {len(body)} "
            f"bytes, response {len(resp)}")
        log(f"  a {call_ms:.3f} ms call's stages, each alone: "
            + ", ".join(f"{k} {v * 1e3:.3f} ms" for k, v in st.items())
            + f"; their sum {staged:.3f} ms, the rest (the transfer and "
            f"the threads' handoffs) {call_ms - staged:.3f} ms")

        # -- R.c: writes over the wire, a push stream subscribed first --
        arrivals, errors = {}, []
        stream = c.watch_push_stream(c.revision)
        done = threading.Event()

        def pump():
            try:
                while not done.is_set():
                    for ev in stream.next_batch():
                        arrivals.setdefault(ev.revision,
                                            time.perf_counter())
            except BaseException as ex:  # reported after the join
                if not done.is_set():
                    errors.append(ex)

        reader = threading.Thread(target=pump, daemon=True)
        reader.start()
        mine, acks, touched = [], {}, set()

        def pairs(write, read, n: int, wire: bool) -> tuple:
            """``n`` write->read pairs (new pod#viewer grants, every third
            a delete of an earlier one), after one warm pair: the write
            and read-after-write ms."""
            w_ms, r_ms = [], []
            for k in range(n + 1):
                if mine and k % 3 == 2:
                    op = WriteOp("delete", mine.pop(0))
                else:
                    op = WriteOp("touch", Relationship(
                        "pod", f"ns/p{rng.integers(N_PODS)}", "viewer",
                        "user", f"u{rng.integers(N_USERS)}"))
                    mine.append(op.rel)
                u = op.rel.subject_id
                touched.add(u)
                t0 = time.perf_counter()
                rev = write([op])
                t1 = time.perf_counter()
                if wire:
                    acks[rev] = t1
                read("pod", "view", "user", u)
                t2 = time.perf_counter()
                if k:
                    w_ms.append((t1 - t0) * 1e3)
                    r_ms.append((t2 - t1) * 1e3)
            return w_ms, r_ms

        c0 = compiles.value
        # in process at this engine state first, the stream subscribed
        # (untallied: the in-process engine's calls are no wire calls)
        w_in, r_in = pairs(e.write_relationships, e.lookup_resources_mask,
                           10, False)
        with launches, EngineTimes(e, "write_relationships") as host:
            w_ms, r_ms = pairs(c.write_relationships,
                               c.lookup_resources_mask, 20, True)
        deadline = time.perf_counter() + 30
        while not set(acks) <= set(arrivals):
            check(time.perf_counter() < deadline and not errors,
                  f"R.c: events of {sorted(set(acks) - set(arrivals))} "
                  f"never arrived ({errors[:1]!r})")
            time.sleep(0.001)
        done.set()
        stream.close()
        reader.join(30)
        ev_ms = [(arrivals[r] - t) * 1e3 for r, t in acks.items()]
        dc = compiles.value - c0
        check(dc == 0, f"R.c: {dc:.0f} recompiles under wire writes")
        wire = {u: c.lookup_resources_mask("pod", "view", "user", u)[0]
                for u in sorted(touched)}
        same_masks(wire, list_masks(e, sorted(touched)), "R.c")
        MEASURED["r_write"] = {"p50": pct(w_ms, 50), "p99": pct(w_ms, 99)}
        log(f"phase R.c writes over the wire: {len(w_ms)} write->read pairs "
            f"(after one warm pair), write p50 {pct(w_ms, 50):.3f} ms p99 "
            f"{pct(w_ms, 99):.3f} ms (the engine's write inside the host "
            f"p50 {pct(host.ms[1:], 50):.3f} ms; in process at this state, "
            f"10 pairs: write p50 {pct(w_in, 50):.3f} ms, read-after-write "
            f"p50 {pct(r_in, 50):.3f} ms), read-after-write p50 "
            f"{pct(r_ms, 50):.3f} ms p99 {pct(r_ms, 99):.3f} ms; 0 "
            f"recompiles; the push stream got all {len(acks)} writes' "
            f"events, ack -> arrival p50 {pct(ev_ms, 50):.3f} ms, max "
            f"{max(ev_ms):.3f} ms; {len(touched)} touched subjects' masks "
            "equal the in-process ones")

        # -- R.d: 256 lists from 32 client threads, one RemoteEngine each
        picks = rng.choice(N_USERS, N_TENANT_LISTS, replace=False)
        users = [f"u{i}" for i in picks]
        clients = [remote.RemoteEngine("127.0.0.1", server.port)
                   for _ in range(N_TENANT_THREADS)]
        ref = list_masks(e, users)  # untallied
        try:
            with launches:
                for cl in clients:  # each proxy's first id sync
                    cl.lookup_resources_mask("pod", "view", "user",
                                             subjects[2])

            def tenant_lists(label: str) -> tuple:
                out, lat, errs = {}, [], []
                lock = threading.Lock()
                barrier = threading.Barrier(N_TENANT_THREADS)

                def worker(k):
                    try:
                        barrier.wait(60)
                        for u in users[k::N_TENANT_THREADS]:
                            t0 = time.perf_counter()
                            m, _ = clients[k].lookup_resources_mask(
                                "pod", "view", "user", u)
                            with lock:
                                out[u] = m
                                lat.append((time.perf_counter() - t0) * 1e3)
                    except BaseException as ex:  # reported after the join
                        errs.append(ex)

                threads = [threading.Thread(target=worker, args=(k,),
                                            daemon=True)
                           for k in range(N_TENANT_THREADS)]
                t0 = time.perf_counter()
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(300)
                wall = time.perf_counter() - t0
                check(not any(t.is_alive() for t in threads) and not errs,
                      f"R.d {label}: a client thread failed {errs[:1]!r}")
                check(len(out) == N_TENANT_LISTS, f"R.d {label}: "
                      f"{len(out)} masks")
                rate = N_TENANT_LISTS / wall
                log(f"phase R.d {label}: {N_TENANT_LISTS} lists from "
                    f"{N_TENANT_THREADS} client threads over the wire in "
                    f"{wall * 1e3:.1f} ms: {rate:.1f} lists/s, p50 "
                    f"{pct(lat, 50):.3f} ms p99 {pct(lat, 99):.3f} ms a list")
                return out, rate

            b0 = metrics.counter("engine_lookup_batches_total").value
            with launches:
                plain, off = tenant_lists("host batching off")
                e.enable_lookup_batching(window=0.002, max_rows=8)
                try:
                    fused, on = tenant_lists("host batching on (window "
                                             "2 ms, max_rows 8)")
                finally:
                    e.disable_lookup_batching()
            batches = metrics.counter("engine_lookup_batches_total").value \
                - b0
        finally:
            for cl in clients:
                cl.close()
        same_masks(plain, ref, "R.d unbatched wire vs in process")
        same_masks(fused, plain, "R.d batched vs unbatched")
        check(batches > 0, "R.d: batching on fused no dispatch")
        log(f"  every batched mask byte-equal to the unbatched one, and "
            f"those to the in-process engine's; {batches:.0f} fused "
            f"dispatches; S.a in process from this run: "
            f"{inproc['tenant']['off']:.1f} lists/s off, "
            f"{inproc['tenant']['on']:.1f} batched (R.d: {off:.1f} / "
            f"{on:.1f})")
    finally:
        c.close()
        # drain the connections and join the host's workers: no worker may
        # still dispatch on this engine once phase 10 releases it
        lt.run(server.stop())
        lt.close()
    torch.cuda.synchronize()
    log(f"  remote-path launches over R.a-R.d (the host's engine calls "
        f"only): {launches.n}")
    for kname, n in launches.n.items():
        check(n > 0, f"{kname} was not launched on the remote path")
    return launches.n


def smi_apps() -> str:
    """nvidia-smi's compute apps, ``pid, used_memory`` a line."""
    return subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def host_cli_phase(torch, here: str, data_src: str, schema: str,
                   users: list, want: dict) -> str:
    """Phase R.e: ``python -m spicedb_kubeapi_proxy_tpu_torch.engine.remote``
    as an operator starts it (default flags: the card, the decision cache
    and the compactor on) on a copy of phase P's data dir, which its owner
    has closed, under ``schema`` (a data dir holds no schema; the host
    takes it from ``--bootstrap``): the time to the first answered list,
    the process on the card, its masks against the writer's, and a
    SIGTERM shutdown. Returns the host's data dir (M.c boots a copy)."""
    import signal
    import socket

    from spicedb_kubeapi_proxy_tpu_torch.engine import remote
    from spicedb_kubeapi_proxy_tpu_torch.engine.store import WriteOp
    from spicedb_kubeapi_proxy_tpu_torch.models.tuples import Relationship
    from spicedb_kubeapi_proxy_tpu_torch.ops import kernels

    root = os.path.dirname(data_src)
    d = os.path.join(root, "r_host")
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(data_src, d)
    boot = os.path.join(root, "r_host_bootstrap.yaml")
    with open(boot, "w") as fh:
        fh.write("schema: |\n" + "".join(
            f"  {ln}\n" for ln in schema.strip("\n").splitlines()))
    so = kernels.library_path("bitprop")
    so_mtime = os.stat(so).st_mtime_ns
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    log_path = os.path.join(root, "r_host.log")

    def tail() -> str:
        with open(log_path, errors="replace") as fh:
            return fh.read()[-3000:]

    free0 = torch.cuda.mem_get_info()[0]
    apps0 = smi_apps().splitlines()
    with open(log_path, "w") as logf:
        t0 = time.perf_counter()
        p = subprocess.Popen(
            [sys.executable, "-m",
             "spicedb_kubeapi_proxy_tpu_torch.engine.remote",
             "--engine-insecure", "--bind-port", str(port),
             "--bootstrap", boot, "--data-dir", d], cwd=here, stdout=logf,
            stderr=subprocess.STDOUT)
    seen: dict = {}  # child log line -> seconds after spawn it appeared

    def note_lines() -> None:
        for ln in tail().splitlines():
            for key in ("starting", "engine on", "persistence:",
                        "engine listening"):
                if key in ln and key not in seen:
                    seen[key] = time.perf_counter() - t0

    try:
        while True:
            check(p.poll() is None, f"R.e: the engine host exited during "
                  f"boot ({p.returncode}):\n{tail()}")
            check(time.perf_counter() - t0 < 300, "R.e: no bind in 300 s")
            note_lines()
            try:
                socket.create_connection(("127.0.0.1", port),
                                         timeout=1).close()
                break
            except OSError:
                time.sleep(0.05)
        bind_s = time.perf_counter() - t0
        note_lines()
        c = remote.RemoteEngine("127.0.0.1", port)
        try:
            m, _ = c.lookup_resources_mask("pod", "view", "user", users[0])
            first_s = time.perf_counter() - t0
            apps = smi_apps()
            used = free0 - torch.cuda.mem_get_info()[0]
            pids = [ln.split(",")[0].strip() for ln in apps.splitlines()]
            on_card = "engine on cuda" in tail()
            log(f"phase R.e the engine-host CLI on a copy of phase P's data "
                f"dir: log lines at (s after spawn) "
                + ", ".join(f"{k!r} {v:.2f}" for k, v in seen.items())
                + f"; bound {bind_s:.2f} s after spawn, first lookup_mask "
                f"answered {first_s:.2f} s after spawn; nvidia-smi compute "
                f"apps before the spawn: {'; '.join(apps0)}, with the host "
                f"up: {apps.replace(chr(10), '; ')} (child pid {p.pid}, "
                f"this process {os.getpid()}); device memory the card lost "
                f"meanwhile: {used} bytes; child log says it runs on cuda: "
                f"{on_card}")
            # nvidia-smi may report pids of another pid namespace than
            # this process's: then the compute-app count must rise by the
            # child (and fall back once it exits, checked below)
            check(str(p.pid) in pids
                  or len(apps.splitlines()) == len(apps0) + 1,
                  f"R.e: the engine host (pid {p.pid}) is not among the "
                  f"card's compute apps: {apps!r} (before: {apps0!r})")
            check(on_card, f"R.e: the host did not report a CUDA device:\n"
                  f"{tail()}")
            check(np.array_equal(m, want[users[0]]),
                  f"R.e: {users[0]}'s mask differs from the writer's")
            got = {u: c.lookup_resources_mask("pod", "view", "user", u)[0]
                   for u in users}
            same_masks(got, want, "R.e CLI host vs writer")
            # one write, so the shutdown has a journal tail to checkpoint
            t1 = time.perf_counter()
            rev = c.write_relationships([WriteOp("touch", Relationship(
                "pod", "ns/p-cli-new", "viewer", "user", users[0]))])
            w_ms = (time.perf_counter() - t1) * 1e3
            check("ns/p-cli-new" in c.lookup_resources(
                "pod", "view", "user", users[0]),
                "R.e: the host's write does not read back")
        finally:
            c.close()
        t1 = time.perf_counter()
        p.send_signal(signal.SIGTERM)
        rc = p.wait(timeout=300)
        shut_s = time.perf_counter() - t1
        check(rc == 0, f"R.e: the host exited {rc} on SIGTERM:\n{tail()}")
        check("persistence closed" in tail() and os.path.exists(
            os.path.join(d, "snapshots", f"snapshot-{rev:020d}.npz")),
            f"R.e: no final checkpoint at revision {rev}:\n{tail()}")
        check(os.stat(so).st_mtime_ns == so_mtime,
              "R.e: the child rebuilt the kernel library")
        t1 = time.perf_counter()
        apps1 = smi_apps().splitlines()
        while len(apps1) != len(apps0) and time.perf_counter() - t1 < 20:
            time.sleep(0.2)
            apps1 = smi_apps().splitlines()
        check(len(apps1) == len(apps0), f"R.e: compute apps after the "
              f"host exited: {apps1!r} (before it: {apps0!r})")
        log(f"  {len(users)} subjects' masks byte-equal to the writer's; "
            f"a write {w_ms:.3f} ms, read back; SIGTERM -> exit {rc} in "
            f"{shut_s:.2f} s (drain, compactor stop, final checkpoint at "
            f"revision {rev}); compute apps back to "
            f"{len(apps1)}; the child loaded {os.path.basename(so)} as the "
            "parent built it (no rebuild)")
        log("  the host's log: " + " | ".join(
            ln.strip() for ln in tail().splitlines()[-8:]))
    finally:
        if p.poll() is None:
            p.kill()
            p.wait(30)
    return d


# M.a's target: pod gains an auditor relation and an audit permission
# (additive: nothing stored is rewritten)
MIG_A_SCHEMA = BENCH_SCHEMA.replace(
    "  relation viewer: user | user with expiration\n",
    "  relation viewer: user | user with expiration\n"
    "  relation auditor: user\n").replace(
    "  permission edit = creator\n",
    "  permission edit = creator\n"
    "  permission audit = auditor + namespace->admin\n")
# M.b's target: a caveat on the live namespace#viewer relation (rewriting:
# its ~2,000 stored rows are re-validated and backfilled)
MIG_B_SCHEMA = MIG_A_SCHEMA.replace(
    "definition user {}",
    "caveat probation(level int) {\n  level < 3\n}\n\ndefinition user {}"
).replace(
    "  relation viewer: user | group#member\n",
    "  relation viewer: user | group#member | user with probation\n")
# refused: namespace#viewer drops its group#member subjects, stranding rows
MIG_BAD_SCHEMA = MIG_A_SCHEMA.replace(
    "  relation viewer: user | group#member\n",
    "  relation viewer: user\n")
MIG_CTXS = (("level 1", {"level": 1}), ("level 5", {"level": 5}))


def audit_masks(store, users, n: int) -> dict:
    """pod#audit of MIG_A_SCHEMA for each user, plainly with numpy over
    the store's rows (auditor + namespace->admin, a namespace's admin
    being its creator): {user: bool mask over pod object indices}."""
    snap = store.snapshot()
    c = snap.cols
    T, R = snap.types.lookup, snap.relations.lookup
    t_user, t_ns, t_pod = (T(x) for x in ("user", "namespace", "pod"))

    def rows(rt, rl, st):
        m = np.flatnonzero((c.rt == rt) & (c.rl == R(rl)) & (c.st == st)
                           & (c.srl == R("")))
        return c.rid[m], c.sid[m]

    pa, pn, nc = (rows(t_pod, "auditor", t_user),
                  rows(t_pod, "namespace", t_ns),
                  rows(t_ns, "creator", t_user))
    uid = snap.objects[t_user].id_map()
    out = {}
    for u in users:
        ui = uid[u]
        pods = np.concatenate([pa[0][pa[1] == ui],
                               pn[0][np.isin(pn[1], nc[0][nc[1] == ui])]])
        mask = np.zeros(n, dtype=bool)
        mask[pods] = True
        mask[:2] = False
        out[u] = mask
    return out


def migration_phase(torch, e, here: str, subjects: list, items: list,
                    bulk_users: list, r_dir: str, r_users: list,
                    r_want: dict, list_p50: float, seed: int) -> dict:
    """Phase M (see the module docstring): M.a an additive migration in
    process under a lister and a writer, M.b a rewriting one over the
    wire, M.c the CLI's boot resolution of a record at its cut. Returns
    both kernels' launches over M.a and M.b (the migrated engine's calls
    only; the host references run outside the tally). The targets carry
    the workflow definitions, as a proxy sends them (the headline engine
    was built without them), so phase K's dual writes have their lock
    and idempotency-key types."""
    from spicedb_kubeapi_proxy_tpu_torch.engine import remote
    from spicedb_kubeapi_proxy_tpu_torch.engine.evaluator import \
        OracleEvaluator
    from spicedb_kubeapi_proxy_tpu_torch.models.bootstrap import \
        WORKFLOW_SCHEMA
    from spicedb_kubeapi_proxy_tpu_torch.engine.store import (
        Precondition,
        PreconditionFailed,
        RelationshipFilter,
        Snapshot,
        WriteOp,
    )
    from spicedb_kubeapi_proxy_tpu_torch.models.tuples import Relationship
    from spicedb_kubeapi_proxy_tpu_torch.ops import bitprop
    from spicedb_kubeapi_proxy_tpu_torch.utils.metrics import metrics

    rng = np.random.default_rng(seed + 130)
    launches = Launches(bitprop)
    root = os.path.join(here, "build", "persist", "migration")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    check(e._decision_cache is None and e._compactor is None
          and e._persistence is None,
          "M: the engine starts with the cache, compactor and WAL off")
    hits = metrics.counter("engine_decision_cache_hits_total", kind="lookup")
    retired = metrics.counter("engine_decision_cache_retired_total")
    mib = 1 << 20

    # -- M.a: additive, in process, under a lister and a writer --
    e.enable_decision_cache(max_entries=BIG_CACHE)
    # durable as a deployment is: the record goes to <data dir>/
    # migration.json and the writes (the backfill's too) are journaled
    e.enable_persistence(os.path.join(root, "a"),
                         wal_fsync="interval:100", auto_checkpoint=False)
    with launches:
        list_masks(e, subjects)  # the cache warm with pod#view
    lat: list = []  # (start, ms) of the lister's lists
    w_ms: list = []  # (start, ms) of the writer's writes
    stop, hold = threading.Event(), threading.Event()
    held = threading.Event()
    errors: list = []
    no_such = Precondition(RelationshipFilter(
        resource_type="pod", resource_id="ns/p-none", relation="viewer"),
        must_exist=True)

    def lister():
        # an explicit clock: every list dispatches on the serving graph
        # (the cache would answer the repeats), so its time compares with
        # phase 5's
        k = 0
        try:
            while not stop.is_set():
                t0 = time.perf_counter()
                e.lookup_resources_mask("pod", "view", "user",
                                        subjects[k % len(subjects)],
                                        now=time.time())
                lat.append((t0, (time.perf_counter() - t0) * 1e3))
                k += 1
        except BaseException as ex:  # reported after the join
            errors.append(ex)

    def writer():
        # a new pod#viewer grant every 10 ms; once ``hold`` is set, the
        # same write under a precondition that fails on purpose, so the
        # revision stays put (the cut's cache check below) while the
        # writes still meet the freeze
        try:
            while not stop.is_set():
                if hold.is_set():
                    held.set()
                op = WriteOp("touch", Relationship(
                    "pod", f"ns/p{rng.integers(N_PODS)}", "viewer", "user",
                    f"u{rng.integers(N_USERS)}"))
                t0 = time.perf_counter()
                try:
                    e.write_relationships(
                        [op], [no_such] if held.is_set() else [])
                except PreconditionFailed:
                    pass
                w_ms.append((t0, (time.perf_counter() - t0) * 1e3))
                time.sleep(0.01)
        except BaseException as ex:
            errors.append(ex)

    threads = [threading.Thread(target=lister, daemon=True),
               threading.Thread(target=writer, daemon=True)]
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    rec_a = os.path.join(root, "a", "migration.json")
    with launches:
        for t in threads:
            t.start()
        time.sleep(1.0)  # the window's traffic before the begin
        t0 = time.perf_counter()
        e.begin_schema_migration(MIG_A_SCHEMA + "\n" + WORKFLOW_SCHEMA,
                                 hold_at_dual=True)
        plan_ms = (time.perf_counter() - t0) * 1e3
        m = e._migrator
        st = _wait_phase(m.status, "dual", 300)
        time.sleep(2.0)  # the dual window under load
        mem_dual = torch.cuda.memory_allocated()
        with open(rec_a) as fh:
            check(json.load(fh)["phase"] == "dual",
                  "M.a: the record is not at dual")
        hold.set()
        while not held.is_set():
            time.sleep(0.001)
        time.sleep(0.05)  # the last real write returned
        rev = e.revision
        list_masks(e, subjects)  # the cache warm at this revision
        torch.cuda.reset_peak_memory_stats()
        st = e.cut_schema_migration(wait=True)
        time.sleep(0.3)
        stop.set()
        for t in threads:
            t.join(60)
    check(not errors and not any(t.is_alive() for t in threads),
          f"M.a: a traffic thread failed {errors[:1]!r}")
    check(st["phase"] == "done" and st["classification"] == "additive",
          f"M.a: {st}")
    check(e.revision == rev, "M.a: the cut moved the revision")
    tl, split = m.timeline, m.cut_split
    mem_peak = torch.cuda.max_memory_allocated()
    mem_cut = torch.cuda.memory_allocated()

    def window(a, b):
        return [ms for t, ms in lat if a <= t < b]

    in_compile = window(tl["compiling"], tl["dual"])
    in_dual = window(tl["dual"], tl["freeze"])
    in_freeze = window(tl["freeze"], tl["done"])
    # the lists that started in the 2 s after the CUT record: the first
    # one on the new base builds its device state (lazily, as the
    # reference's first query after a compile does)
    after_cut = [ms for t, ms in lat if tl["cut"] <= t < tl["cut"] + 2.0]
    stall = max(ms for _, ms in w_ms)
    n_writes = sum(1 for t, _ in w_ms if t < tl["done"])
    # after the cut: pod#view lies outside the diff, so its entries at the
    # unchanged revision answer, with no device work
    h0 = hits.value
    with Launches(bitprop) as quiet:
        after = list_masks(e, subjects)
    check(hits.value - h0 == len(subjects)
          and not any(quiet.n.values()),
          f"M.a: pod#view after the cut: {hits.value - h0:.0f} hits, "
          f"launches {quiet.n}")
    pods = e._objects_by_name()["pod"]
    same_masks(after, view_masks(e.store, subjects, time.time(),
                                 len(after[subjects[0]])),
               "M.a pod#view after the cut vs the columnar reference")
    # the first list that dispatches after the cut (pod#audit misses):
    # it builds the new base's device state
    cg = e.compiled()
    check(cg.schema is e.schema, "M.a: the published graph is not S''s")
    unbuilt = not cg.resident.tensors
    with launches:
        t0 = time.perf_counter()
        e.lookup_resources_mask("pod", "audit", "user", subjects[0])
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
    gc.collect()
    torch.cuda.synchronize()
    mem_after = torch.cuda.memory_allocated()
    check(mem_after <= mem0 + 512 * mib,
          f"M.a: {mem_after} device bytes after the cut, {mem0} before: "
          "the old base's bytes did not come back")
    # pod#audit answers under S': grants for a few subjects, then their
    # masks against the columnar reference and two against the oracle
    aud, cre = subjects[:3], subjects[3:6]
    pods_of = [f"ns/p{rng.integers(N_PODS)}" for _ in range(6)]
    e.write_relationships(
        [WriteOp("touch", Relationship("pod", p, "auditor", "user", u))
         for p, u in zip(pods_of, aud + aud)]
        + [WriteOp("touch", Relationship(
            "namespace", f"ns{rng.integers(N_NS)}", "creator", "user", u))
           for u in cre])
    users = aud + cre + subjects[6:8]
    with launches:
        got = {u: e.lookup_resources_mask("pod", "audit", "user", u)[0]
               for u in users}
    n = len(next(iter(got.values())))
    same_masks(got, audit_masks(e.store, users, n), "M.a pod#audit")
    now = time.time()
    for u, ids in ((u, o.lookup_resources("pod", "audit", "user", u))
                   for u, o in user_oracles(
                       e.store.snapshot(), e.schema, OracleEvaluator,
                       Snapshot, [aud[0], cre[0]], now).items()):
        check({pods.string(i) for i in np.flatnonzero(got[u])} == ids,
              f"M.a: {u}'s pod#audit disagrees with the oracle")
    log(f"phase M.a additive migration in process (pod gains auditor and "
        f"audit = auditor + namespace->admin), a lister ({len(lat)} lists "
        f"of phase 5's subjects) and a writer (a grant every 10 ms, "
        f"{n_writes} writes) throughout: plan {plan_ms:.2f} ms; dual "
        f"compile {m.compile_seconds:.2f} s off the lock; time_to_cut_ms "
        f"{st['time_to_cut_ms']:.1f}; freeze_ms {st['freeze_ms']:.1f} = "
        + ", ".join(f"{k} {v * 1e3:.1f}" for k, v in split.items())
        + f" ms; the writer's largest stall {stall:.1f} ms")
    def spread(xs) -> str:
        return (f"{len(xs)}, p50 {pct(xs, 50):.3f} ms p99 {pct(xs, 99):.3f} "
                "ms" if xs else "none")

    log(f"  lists (each dispatched: an explicit clock): during the compile "
        f"{spread(in_compile)}; during the dual window {spread(in_dual)}; "
        f"during the freeze {spread(in_freeze)} (phase 5 p50 "
        f"{list_p50:.3f} ms)")
    log(f"  after the cut: {len(subjects)} pod#view lists all cache hits, "
        f"0 launches, masks equal to the columnar reference; the lister's "
        f"slowest list of the 2 s after the cut "
        f"{max(after_cut, default=0.0):.1f} ms ({len(after_cut)} lists; "
        f"the first on the new base builds its device state); the first "
        f"pod#audit list {first_ms:.1f} ms (the device state "
        f"{'built by it' if unbuilt else 'built before it'}); device "
        f"memory allocated before "
        f"{mem0 / mib:.1f} MiB, in the dual window {mem_dual / mib:.1f} "
        f"MiB, peak across the cut {mem_peak / mib:.1f} MiB, right after "
        f"it {mem_cut / mib:.1f} MiB, after the first list and the old "
        f"base's last view {mem_after / mib:.1f} MiB; {len(users)} pod#audit "
        "masks equal the columnar reference, 2 the oracle")
    with open(rec_a) as fh:
        check(json.load(fh)["phase"] == "done", "M.a: no done marker")
    e.close_persistence(final_checkpoint=False)
    e.disable_decision_cache()

    # -- M.b: rewriting, over the wire (in-process host) --
    ns_rows = len(e.read_relationships(RelationshipFilter(
        resource_type="namespace", relation="viewer")))
    lt = LoopThread()
    server = remote.EngineServer(e)
    lt.run(server.start())
    c = remote.RemoteEngine("127.0.0.1", server.port)
    rec_b = os.path.join(root, "b", "migration.json")
    e.enable_persistence(os.path.join(root, "b"),
                         wal_fsync="interval:100", auto_checkpoint=False)
    e.enable_decision_cache(max_entries=BIG_CACHE)
    e.enable_compaction()
    folds = metrics.counter("engine_compactions_total")
    try:
        rev0, schema0 = e.revision, e.schema
        try:
            c.migrate_begin(MIG_BAD_SCHEMA + "\n" + WORKFLOW_SCHEMA)
            check(False, "M.b: an incompatible target was not refused")
        except remote.SchemaViolation as ex:
            check("incompatible" in str(ex), f"M.b: refusal {ex}")
        check(e.revision == rev0 and e.schema is schema0
              and c.migrate_status()["phase"] == "done",
              "M.b: the refused begin changed something")
        # a held begin, then abort: no cut, the record cleared
        c.migrate_begin(MIG_B_SCHEMA + "\n" + WORKFLOW_SCHEMA,
                        hold_at_dual=True)
        _wait_phase(c.migrate_status, "dual", 300)
        check(os.path.exists(rec_b), "M.b: no record at dual")
        st = c.migrate_abort()
        check(st["phase"] == "aborted" and e.schema is schema0
              and not os.path.exists(rec_b) and e.revision > rev0,
              f"M.b: abort {st}")
        log(f"phase M.b over the wire: an incompatible begin refused "
            f"(SchemaViolation, nothing changed); a held begin aborted at "
            f"dual (no cut, record cleared, schema unchanged, its "
            f"{st['backfilled']} backfilled rows idempotent re-writes)")
        events, stream_errs = [], []
        stream = c.watch_push_stream(e.revision)
        done = threading.Event()

        def read():
            try:
                while not done.is_set():
                    events.extend(stream.next_batch())
            except BaseException as ex:
                if not done.is_set():
                    stream_errs.append(ex)

        reader = threading.Thread(target=read, daemon=True)
        reader.start()
        f0 = folds.value
        begin_rev = e.revision
        c.migrate_begin(MIG_B_SCHEMA + "\n" + WORKFLOW_SCHEMA,
                        hold_at_dual=True)
        m = e._migrator
        st = _wait_phase(c.migrate_status, "dual", 300)
        occ_old = e._head.n_delta
        # entries at the cut's revision, on both sides of the diff
        with launches:
            for u in subjects[:4]:
                for rt, perm in (("pod", "view"), ("pod", "edit"),
                                 ("namespace", "admin")):
                    c.lookup_resources_mask(rt, perm, "user", u)
        r0 = retired.value
        st = c.migrate_cut(wait=True)
        check(st["phase"] == "done" and st["classification"] == "rewriting"
              and st["backfilled"] == ns_rows, f"M.b: {st}")
        with open(rec_b) as fh:
            check(json.load(fh)["phase"] == "done", "M.b: no done marker")
        tl, split = m.timeline, m.cut_split
        bf_s = tl["dual"] - tl["backfill"]
        occ_new = e._head.n_delta
        h0 = hits.value
        with launches:
            for u in subjects[:4]:
                for rt, perm in (("pod", "edit"), ("namespace", "admin")):
                    c.lookup_resources_mask(rt, perm, "user", u)
            survived = hits.value - h0
            for u in subjects[:4]:
                c.lookup_resources_mask("pod", "view", "user", u)
        check(survived == 8 and hits.value - h0 == 8,
              f"M.b: {survived:.0f} of 8 unaffected hits, "
              f"{hits.value - h0 - survived:.0f} pod#view hits after the "
              "cut")
        # the caveat VM on the migrated graph: a caveated grant, its masks
        # under two request contexts against the host reference
        u = next(f"u{i}" for i in rng.integers(N_USERS, size=64)
                 if f"u{i}" not in set(subjects) | set(bulk_users))
        nsid = f"ns{rng.integers(N_NS)}"
        wrev = c.write_relationships([WriteOp("touch", Relationship(
            "namespace", nsid, "viewer", "user", u, caveat="probation"))])
        orc = {}
        for label, ctx in MIG_CTXS:
            orc[label] = user_oracles(e.store.snapshot(), e.schema,
                                      OracleEvaluator, Snapshot, [u],
                                      time.time(), context=ctx)[u]
        pods = e._objects_by_name()["pod"]
        vis = {}
        with launches:
            for label, ctx in MIG_CTXS:
                mask, _ = c.lookup_resources_mask("pod", "view", "user", u,
                                                  context=ctx)
                vis[label] = {pods.string(i) for i in np.flatnonzero(mask)}
                check(vis[label] == orc[label].lookup_resources(
                    "pod", "view", "user", u),
                    f"M.b: {u}'s caveated masks under {ctx} differ from "
                    "the oracle")
        check(len(vis["level 1"]) > len(vis["level 5"]),
              f"M.b: the caveated grant moved nothing {vis}")
        deadline = time.perf_counter() + 30
        while not any(ev.revision == wrev for ev in events):
            check(time.perf_counter() < deadline and not stream_errs,
                  f"M.b: the write's event never arrived {stream_errs[:1]}")
            time.sleep(0.01)
        done.set()
        stream.close()
        reader.join(30)
        echoes = set(e._watch_suppress) & {ev.revision for ev in events}
        check(not echoes and [ev.revision for ev in events] == [wrev],
              f"M.b: the push stream got {sorted(ev.revision for ev in events)}"
              f" (echoes {sorted(echoes)}, the write {wrev})")
        # the dense kernel on the migrated graph, against the columnar
        # reference of pod#view
        with launches:
            verdicts = c.check_bulk(items)
        ref = view_masks(e.store, bulk_users, time.time(), len(pods))
        pid = pods.id_map()
        bad = sum(v != bool(ref[it.subject_id][pid[it.resource_id]])
                  for v, it in zip(verdicts, items))
        check(bad == 0, f"M.b: {bad} of {len(items)} bulk verdicts differ "
              "from the reference")
        torch.cuda.synchronize()
        log(f"phase M.b rewriting migration over the wire (namespace#viewer "
            f"gains `user with probation`), hold_at_dual, migrate_cut: "
            f"dual compile {m.compile_seconds:.2f} s; backfill "
            f"{st['backfilled']} rows in {st['suppressed']} batches of 512 "
            f"in {bf_s * 1e3:.1f} ms ({st['backfilled'] / bf_s:,.0f} "
            f"rows/s); overlay occupancy at dual {occ_old} of "
            f"{e._delta_capacity} (serving base), {occ_new} on the new base "
            f"after the cut; compactor folds {folds.value - f0:.0f}; "
            f"time_to_cut_ms {st['time_to_cut_ms']:.1f}; freeze_ms "
            f"{st['freeze_ms']:.1f} = "
            + ", ".join(f"{k} {v * 1e3:.1f}" for k, v in split.items())
            + " ms")
        log(f"  cache: {retired.value - r0:.0f} entries retired at the cut "
            f"(pod#view; and any fold's), pod#edit and namespace#admin entries answered "
            f"(8 hits), pod#view missed; the push stream opened at revision "
            f"{begin_rev} got only the post-cut write (no echo of "
            f"{st['suppressed']} backfill revisions); {u}'s caveated "
            f"namespace#viewer grant: pod#view masks under level 1 "
            f"({len(vis['level 1'])} pods) and level 5 "
            f"({len(vis['level 5'])}) equal the oracle; the 64 x 1,024 "
            f"bulk check over the wire equals the columnar reference "
            f"({sum(verdicts)} allowed)")
    finally:
        c.close()
        lt.run(server.stop())
        lt.close()
        e.close_compaction()
        e.disable_decision_cache()
        e.close_persistence(final_checkpoint=False)
    torch.cuda.synchronize()
    log(f"  migration-path launches over M.a and M.b (the migrated engine's "
        f"calls only): {launches.n}")
    for kname, nl in launches.n.items():
        check(nl > 0, f"{kname} was not launched on the migration path")

    # -- M.c: the CLI resolves a record at its cut at boot --
    migration_boot(torch, here, r_dir, r_users, r_want)
    shutil.rmtree(root, ignore_errors=True)
    return launches.n


def _wait_phase(status, phase: str, budget: float) -> dict:
    deadline = time.perf_counter() + budget
    while True:
        st = status()
        if st is not None and st["phase"] == phase:
            return st
        check(st is None or st["phase"] not in ("failed", "aborted"),
              f"M: the migration ended {st}")
        check(time.perf_counter() < deadline, f"M: no {phase} in "
              f"{budget} s: {st}")
        time.sleep(0.005)


def migration_boot(torch, here: str, r_dir: str, users: list,
                   want: dict) -> None:
    """Phase M.c: a copy of R.e's data dir with a migration record at
    phase cut holding M.a's target; the engine-host CLI boots on it under
    the old schema (no write, so no final checkpoint) and must finish the
    cut: its log says ``resumed (phase cut)``, pod#audit answers, the
    record is ``done``, and SIGTERM exits 0."""
    import signal
    import socket

    from spicedb_kubeapi_proxy_tpu_torch.engine import remote
    from spicedb_kubeapi_proxy_tpu_torch.migration import schema_digest
    from spicedb_kubeapi_proxy_tpu_torch.models.bootstrap import \
        WORKFLOW_SCHEMA

    root = os.path.dirname(r_dir)
    d = os.path.join(root, "m_host")
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(r_dir, d)
    rec = os.path.join(d, "migration.json")
    # the target as the proxy sends it: with the workflow definitions
    # every booted schema carries
    target = MIG_A_SCHEMA + "\n" + WORKFLOW_SCHEMA
    with open(rec, "w") as fh:
        json.dump({"phase": "cut", "to_text": target,
                   "to_digest": schema_digest(target),
                   "suppressed_revisions": []}, fh)
    boot = os.path.join(root, "r_host_bootstrap.yaml")
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    log_path = os.path.join(root, "m_host.log")

    def tail() -> str:
        with open(log_path, errors="replace") as fh:
            return fh.read()[-3000:]

    with open(log_path, "w") as logf:
        t0 = time.perf_counter()
        p = subprocess.Popen(
            [sys.executable, "-m",
             "spicedb_kubeapi_proxy_tpu_torch.engine.remote",
             "--engine-insecure", "--bind-port", str(port),
             "--bootstrap", boot, "--data-dir", d], cwd=here, stdout=logf,
            stderr=subprocess.STDOUT)
    try:
        while True:
            check(p.poll() is None, f"M.c: the engine host exited during "
                  f"boot ({p.returncode}):\n{tail()}")
            check(time.perf_counter() - t0 < 300, "M.c: no bind in 300 s")
            try:
                socket.create_connection(("127.0.0.1", port),
                                         timeout=1).close()
                break
            except OSError:
                time.sleep(0.05)
        bind_s = time.perf_counter() - t0
        check("schema migration record recovered: resumed (phase cut)"
              in tail(), f"M.c: no resume in the host's log:\n{tail()}")
        c = remote.RemoteEngine("127.0.0.1", port)
        try:
            t1 = time.perf_counter()
            mask, _ = c.lookup_resources_mask("pod", "audit", "user",
                                              users[0])
            first_s = time.perf_counter() - t1
            check(mask is not None and not mask.any(),
                  "M.c: pod#audit does not answer under the new schema "
                  "(no auditor or creator rows: an empty mask)")
            # R.e's write (a grant to its first subject) is in this dir
            check("ns/p-cli-new" in c.lookup_resources(
                "pod", "view", "user", users[0]), "M.c: R.e's write")
            got = {u: c.lookup_resources_mask("pod", "view", "user", u)[0]
                   for u in users[1:]}
            same_masks(got, {u: want[u] for u in users[1:]},
                       "M.c migrated CLI host vs the writer")
        finally:
            c.close()
        with open(rec) as fh:
            phase = json.load(fh)["phase"]
        check(phase == "done", f"M.c: the record is at {phase}")
        t1 = time.perf_counter()
        p.send_signal(signal.SIGTERM)
        rc = p.wait(timeout=300)
        check(rc == 0, f"M.c: the host exited {rc} on SIGTERM:\n{tail()}")
        log(f"phase M.c the engine-host CLI on a copy of R.e's data dir with "
            f"a record at phase cut (M.a's target), booted under the old "
            f"schema: bound {bind_s:.2f} s after spawn, its log says "
            f"'resumed (phase cut)'; the first pod#audit list (compile "
            f"under S' and device build) {first_s:.2f} s, answered; "
            f"{len(users) - 1} pod#view masks equal the writer's; the record "
            f"is done; SIGTERM -> exit 0 in {time.perf_counter() - t1:.2f} s")
    finally:
        if p.poll() is None:
            p.kill()
            p.wait(30)
    shutil.rmtree(d, ignore_errors=True)


# -- phase K: the proxy itself on the card ------------------------------------

# K.c's creates through the dual write: each costs the next read a
# recompile of the 10M graph (the overlay declines a dual write's lock
# and idempotency-key rows, in both packages), so two suffice
N_CREATES = 2


def k_rules(here: str) -> str:
    """deploy/rules.yaml's pod rules (pod-create, pod-get, pod-list-watch,
    pod-delete)."""
    with open(os.path.join(here, "deploy", "rules.yaml")) as fh:
        docs = fh.read().split("\n---\n")
    return "\n---\n".join(d for d in docs if "resource: pods" in d)


def pod_list_body(n_pods: int) -> tuple:
    """The upstream's all-namespaces PodList (pods ``ns/p{i}``), built
    once as the reference's proxy-path bench builds it: (body, head, the
    items' bytes, tail), the body being head + ", ".join(items) + tail."""
    head = (b'{"kind": "PodList", "apiVersion": "v1", "metadata": '
            b'{"resourceVersion": "1"}, "items": [')
    items = [json.dumps({"apiVersion": "v1", "kind": "Pod", "metadata": {
        "name": f"p{i}", "namespace": "ns"}}).encode()
        for i in range(n_pods)]
    tail = b"]}"
    return head + b", ".join(items) + tail, head, items, tail


class KUpstream:
    """Phase K's upstream: ``GET /api/v1/pods`` answers the fixed PodList
    (the apiserver's own serialization is out of scope); every other
    request (single pods, namespaced lists, creates, deletes, watches)
    goes to a port ``InMemoryKube``."""

    def __init__(self, kube, body: bytes):
        from spicedb_kubeapi_proxy_tpu_torch.proxy.types import \
            ProxyResponse

        self.kube, self.body, self.resp = kube, body, ProxyResponse

    async def __call__(self, req):
        if (req.method == "GET" and req.path == "/api/v1/pods"
                and "watch" not in req.query):
            return self.resp(status=200, headers={
                "Content-Type": "application/json"}, body=self.body)
        return await self.kube(req)


class KStack:
    """A port proxy ``Server`` over ``e`` on loopback (a loop thread of
    its own), wired as ``Options.complete()`` wires it, around an engine
    that exists already."""

    def __init__(self, e, rules: str, upstream, db: Optional[str] = None,
                 token_authenticator=None):
        from spicedb_kubeapi_proxy_tpu_torch.authz import AuthzDeps
        from spicedb_kubeapi_proxy_tpu_torch.dtx import (
            ActivityHandler,
            WorkflowEngine,
            register_workflows,
        )
        from spicedb_kubeapi_proxy_tpu_torch.proxy.authn import \
            HeaderAuthenticator
        from spicedb_kubeapi_proxy_tpu_torch.proxy.server import Server
        from spicedb_kubeapi_proxy_tpu_torch.rules.matcher import MapMatcher

        self.workflow = None
        if db is not None:
            for f in (db, db + "-wal", db + "-shm"):
                if os.path.exists(f):
                    os.unlink(f)
            self.workflow = WorkflowEngine(db_path=db)
            register_workflows(self.workflow)
            ActivityHandler(e, upstream).register(self.workflow)
        self.deps = AuthzDeps(matcher=MapMatcher.from_yaml(rules), engine=e,
                              upstream=upstream, workflow=self.workflow)
        self.server = Server(self.deps, HeaderAuthenticator(), port=0,
                             token_authenticator=token_authenticator)
        self.lt = LoopThread()
        if self.workflow is not None:
            self.lt.run(self.workflow.resume_pending())
        self.port = self.lt.run(self.server.start())

    def conn(self):
        import http.client

        return http.client.HTTPConnection("127.0.0.1", self.port,
                                          timeout=120)

    def close(self) -> None:
        self.lt.run(self.server.stop(grace=1.0))
        if self.workflow is not None:
            self.lt.run(self.workflow.shutdown())
        self.lt.close()


def k_call(conn, method: str, path: str, user: str, body=None,
           headers=None) -> tuple:
    """One request on a kept-alive connection: (status, body bytes)."""
    h = {"X-Remote-User": user}
    if body is not None:
        h["Content-Type"] = "application/json"
    h.update(headers or {})
    conn.request(method, path, headers=h, body=None if body is None
                 else json.dumps(body).encode())
    r = conn.getresponse()
    return r.status, r.read()


def names_of(body: bytes) -> list:
    return [i["metadata"]["name"] for i in json.loads(body)["items"]]


def uncaveated_view_masks(store, users, now: float, n: int,
                          pods: Optional[list] = None) -> dict:
    """view_masks over the store's rows without a caveat: what a request
    whose context lacks a caveat's parameters is granted (a caveated
    grant fails closed; the proxy's requests carry no ``level``, the
    parameter of M.b's probation caveat). ``pods`` (object ids) keeps
    only those pods' rows: their bits are exact, the rest are 0."""
    from spicedb_kubeapi_proxy_tpu_torch.engine.store import Snapshot

    snap = store.snapshot()
    c = snap.cols
    keep = c.cav == 0
    if pods is not None:
        pid = snap.objects[snap.types.lookup("pod")].id_map()
        keep &= ((c.rt != snap.types.lookup("pod"))
                 | np.isin(c.rid, [pid[p] for p in pods if p in pid]))
    keep = np.flatnonzero(keep)
    plain = Snapshot(snap.revision, snap.cols.take(keep), snap.types,
                     snap.relations, snap.objects, snap.caveat_instances)

    class _Store:
        def snapshot(self):
            return plain

    return view_masks(_Store(), users, now, n)


def kept_from(mask, pods, n_list: int) -> list:
    """Indices into the upstream PodList (``ns/p{i}``) a mask keeps."""
    pid = pods.id_map()
    idx = np.array([pid.get(f"ns/p{i}", 0) for i in range(n_list)])
    return np.flatnonzero(mask[idx] & (idx > 1)).tolist()


class ScanSpy:
    """The port's native list scans and their bails, and the filter's
    Python-path fallbacks, inside its ``with`` block."""

    def __init__(self):
        from spicedb_kubeapi_proxy_tpu_torch import native
        from spicedb_kubeapi_proxy_tpu_torch.utils.metrics import metrics

        self.native = native
        self.py = metrics.counter("proxy_filter_python_path_total",
                                  format="json")
        self.scans = self.bails = 0
        self.fallbacks = 0.0

    def __enter__(self):
        real = self.real = self.native.json_list_spans

        def spy(*a, **kw):
            out = real(*a, **kw)
            self.scans += 1
            self.bails += out is None
            return out

        self.native.json_list_spans = spy
        self.py0 = self.py.value
        return self

    def __exit__(self, *exc):
        self.native.json_list_spans = self.real
        self.fallbacks += self.py.value - self.py0
        return False


def proxy_phase(torch, e, here: str, subjects: list, seed: int) -> dict:
    """Phase K: the port's proxy (rules, authz middleware, dual write,
    native list filter, HTTP server) in front of the headline engine
    (see the module docstring). Returns both kernels' launches over the
    proxy's requests in K.a-K.e."""
    import socket

    from spicedb_kubeapi_proxy_tpu_torch import native
    from spicedb_kubeapi_proxy_tpu_torch.authz import filterer
    from spicedb_kubeapi_proxy_tpu_torch.authz.lookups import \
        run_prefilter_sync
    from spicedb_kubeapi_proxy_tpu_torch.engine import RelationshipFilter
    from spicedb_kubeapi_proxy_tpu_torch.engine.store import WriteOp
    from spicedb_kubeapi_proxy_tpu_torch.models.tuples import Relationship
    from spicedb_kubeapi_proxy_tpu_torch.ops import bitprop
    from spicedb_kubeapi_proxy_tpu_torch.proxy.inmemkube import InMemoryKube
    from spicedb_kubeapi_proxy_tpu_torch.proxy.requestinfo import \
        parse_request_info
    from spicedb_kubeapi_proxy_tpu_torch.rules.input import (
        ResolveInput,
        UserInfo,
    )
    from spicedb_kubeapi_proxy_tpu_torch.rules.matcher import RequestMeta
    from spicedb_kubeapi_proxy_tpu_torch.utils.metrics import metrics

    check(native.available(), "K: the native list scanner did not build")
    rng = np.random.default_rng(seed + 11)
    n_type = e.compiled().type_sizes["pod"]
    n_list = min(n_type - 2, N_PODS)
    t0 = time.perf_counter()
    body, head, item_b, tail = pod_list_body(n_list)
    body_s = time.perf_counter() - t0
    kube = InMemoryKube()
    up = KUpstream(kube, body)
    root = os.path.join(here, "build", "proxy")
    os.makedirs(root, exist_ok=True)
    stack = KStack(e, k_rules(here), up, os.path.join(root, "dtx.sqlite"))
    launches = Launches(bitprop)
    pods = e._objects_by_name()["pod"]
    pf = [p for r in stack.deps.matcher.match(RequestMeta(
        "list", "", "v1", "pods")) for p in r.pre_filters][0]
    try:
        conn = stack.conn()
        k_call(conn, "GET", "/api/v1/pods", subjects[0])  # warm-up

        # -- K.a: GET /api/v1/pods over the 100k-item body --
        want = uncaveated_view_masks(e.store, subjects, time.time(), n_type)
        h_req = metrics.histogram("proxy_request_seconds")
        h_up = metrics.histogram("proxy_upstream_seconds")
        wall, handle, upst, kept_n = [], [], [], []
        with ScanSpy() as spy:
            for u in subjects:
                r0, u0 = h_req.total, h_up.total
                with launches:
                    t0 = time.perf_counter()
                    st, out = k_call(conn, "GET", "/api/v1/pods", u)
                    wall.append((time.perf_counter() - t0) * 1e3)
                handle.append((h_req.total - r0) * 1e3)
                upst.append((h_up.total - u0) * 1e3)
                check(st == 200, f"K.a: {u}'s list answered {st}")
                keep = kept_from(want[u], pods, n_list)
                exp = (head + b",".join(item_b[i] for i in keep) + tail
                       if len(keep) < n_list else body)
                check(out == exp, f"K.a: {u}'s list is not the upstream's "
                      f"{len(keep)} kept items byte for byte")
                kept_n.append(len(keep))
        check(spy.scans == len(subjects) and spy.bails == 0
              and spy.fallbacks == 0,
              f"K.a: native scans {spy.scans}, bails {spy.bails}, Python "
              f"path {spy.fallbacks} for {len(subjects)} lists")
        # where a list's time goes: each stage alone, outside the request
        eng_ms, pre_ms, filt_ms = [], [], []
        info = parse_request_info("GET", "/api/v1/pods", {})
        for u in subjects:
            inp = ResolveInput.create(info, UserInfo(name=u))
            t0 = time.perf_counter()
            e.lookup_resources_mask("pod", "view", "user", u)
            eng_ms.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            allowed = run_prefilter_sync(e, pf, inp)
            pre_ms.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            filterer.filter_body(body, allowed, inp)
            filt_ms.append((time.perf_counter() - t0) * 1e3)
        py_ms = []
        wire = filterer._filter_list_wire
        filterer._filter_list_wire = lambda *a: None
        try:
            for u in subjects[:3]:
                inp = ResolveInput.create(info, UserInfo(name=u))
                allowed = run_prefilter_sync(e, pf, inp)
                t0 = time.perf_counter()
                _, py_out = filterer.filter_body(body, allowed, inp)
                py_ms.append((time.perf_counter() - t0) * 1e3)
                check(names_of(py_out) == [f"p{i}" for i in kept_from(
                    want[u], pods, n_list)],
                      f"K.a: the Python filter keeps other items for {u}")
        finally:
            filterer._filter_list_wire = wire
        wo = [w - h for w, h in zip(wall, handle)]
        MEASURED["k_a"] = {"p50": pct(wall, 50), "p99": pct(wall, 99)}
        log(f"phase K.a GET /api/v1/pods through the port's proxy over "
            f"loopback HTTP (pod-list-watch's prefilter; an upstream "
            f"PodList of {n_list} items, {len(body)} bytes, built once in "
            f"{body_s:.2f} s): {len(subjects)} users, wall p50 "
            f"{pct(wall, 50):.3f} ms, p99 {pct(wall, 99):.3f} ms; in the "
            f"server p50 {pct(handle, 50):.3f} ms (upstream p50 "
            f"{pct(upst, 50):.4f} ms), write-out and client read p50 "
            f"{pct(wo, 50):.3f} ms; each stage alone, p50: the engine's "
            f"call {pct(eng_ms, 50):.3f} ms, the prefilter (the engine's "
            f"call + id mapping) {pct(pre_ms, 50):.3f} ms, the native body "
            f"filter {pct(filt_ms, 50):.3f} ms, the Python filter "
            f"{pct(py_ms, 50):.3f} ms ({len(py_ms)} users); kept "
            f"{min(kept_n)}-{max(kept_n)} items a user, each list the "
            f"upstream's items byte for byte and the columnar reference's "
            f"names; native scans {spy.scans}, bails 0, Python path 0")

        # -- K.b: single pods through pod-get's check --
        pairs = []
        for u in subjects[:16]:
            keep = set(kept_from(want[u], pods, n_list))
            no = next(i for i in rng.integers(n_list, size=64).tolist()
                      if i not in keep)
            pairs += [(u, min(keep), True), (u, no, False)]
        for _, i, _ in pairs:
            kube.put("pods", f"p{i}", "ns")
        get_ms = []
        with launches:
            for u, i, allow in pairs:
                t0 = time.perf_counter()
                st, _ = k_call(conn, "GET",
                               f"/api/v1/namespaces/ns/pods/p{i}", u)
                get_ms.append((time.perf_counter() - t0) * 1e3)
                check(st == (200 if allow else 403),
                      f"K.b: {u} GET ns/p{i} answered {st}; the reference "
                      f"says {'allow' if allow else 'deny'}")
        log(f"phase K.b GET of single pods (pod-get's check): {len(pairs)} "
            f"gets, p50 {pct(get_ms, 50):.3f} ms, p99 {pct(get_ms, 99):.3f} "
            f"ms; {len(pairs) // 2} allowed and {len(pairs) // 2} denied, "
            f"as the columnar reference says")

        # -- K.c: creates through the dual write --
        cu = c_ns = None
        for u in subjects:
            nss = sorted(e.lookup_resources("namespace", "view", "user", u))
            if nss:
                cu, c_ns = u, nss[0]
                break
        check(cu is not None, "K.c: no subject views a namespace")
        st, _ = k_call(conn, "POST", f"/api/v1/namespaces/{c_ns}/pods",
                       "u-nobody", {"apiVersion": "v1", "kind": "Pod",
                                    "metadata": {"name": "x"}})
        check(st == 403, f"K.c: a user without view of {c_ns} created a "
              f"pod ({st})")
        c_ms, raw_ms = [], []
        compiles = metrics.counter("engine_graph_compiles_total")

        def declines() -> dict:  # overlay fallbacks by reason
            return {k[1][1]: c.value for k, c in metrics._counters.items()
                    if k[0] == "engine_graph_incremental_fallback_total"}

        n0, d0 = compiles.value, declines()
        with launches:
            for i in range(N_CREATES):
                t0 = time.perf_counter()
                st, out = k_call(
                    conn, "POST", f"/api/v1/namespaces/{c_ns}/pods", cu,
                    {"apiVersion": "v1", "kind": "Pod",
                     "metadata": {"name": f"k{i}"}})
                c_ms.append((time.perf_counter() - t0) * 1e3)
                check(st == 201, f"K.c: create k{i} answered {st}: {out!r}")
                t0 = time.perf_counter()
                st, out = k_call(conn, "GET",
                                 f"/api/v1/namespaces/{c_ns}/pods", cu)
                raw_ms.append((time.perf_counter() - t0) * 1e3)
                check(st == 200 and f"k{i}" in names_of(out),
                      f"K.c: the creator's list after create k{i} lacks it")
        for i in range(N_CREATES):
            pid = f"{c_ns}/k{i}"
            check(e.store.exists(RelationshipFilter(
                "pod", pid, "creator", "user", cu)) and e.store.exists(
                RelationshipFilter("pod", pid, "namespace", "namespace",
                                   c_ns)),
                  f"K.c: {pid}'s relationships are not in the store")
        check(not e.store.exists(RelationshipFilter(resource_type="lock")),
              "K.c: a dual-write lock was left behind")
        with launches:
            t0 = time.perf_counter()
            st, _ = k_call(conn, "DELETE",
                           f"/api/v1/namespaces/{c_ns}/pods/k0", cu)
            del_ms = (time.perf_counter() - t0) * 1e3
            check(st == 200, f"K.c: the delete answered {st}")
            st, out = k_call(conn, "GET", f"/api/v1/namespaces/{c_ns}/pods",
                             cu)
        check("k0" not in names_of(out), "K.c: the deleted pod is listed")
        check(not e.store.exists(RelationshipFilter("pod", f"{c_ns}/k0")),
              "K.c: the delete left a relationship")
        declined = {r: v - d0.get(r, 0.0) for r, v in declines().items()
                    if v > d0.get(r, 0.0)}
        log(f"phase K.c creates through the dual write (pod-create, "
            f"pessimistic lock) into the port's InMemoryKube: {N_CREATES} "
            f"creates by {cu} in {c_ns}, p50 {pct(c_ms, 50):.3f} ms, max "
            f"{max(c_ms):.3f} ms; the creator's next list shows each (p50 "
            f"{pct(raw_ms, 50):.3f} ms: {compiles.value - n0:.0f} graph "
            f"compiles over K.c, overlay declines {declined}); both "
            f"relationships of each in the engine's store, no lock left; a "
            f"delete ({del_ms:.3f} ms) removed both halves; a user without "
            f"view of the namespace refused (403)")

        # -- K.d: a filtered watch while grants are written --
        w = subjects[1]
        for i in range(7):
            kube.put("pods", f"a{i}", "kw")
        s = socket.create_connection(("127.0.0.1", stack.port), timeout=60)
        s.sendall(f"GET /api/v1/namespaces/kw/pods?watch=true HTTP/1.1\r\n"
                  f"Host: x\r\nX-Remote-User: {w}\r\n\r\n".encode())
        rf = s.makefile("rb")
        check(b" 200 " in rf.readline(), "K.d: the watch was refused")
        while rf.readline() not in (b"\r\n", b""):
            pass
        frames, arrived = [], []

        def reader():
            try:
                while True:
                    size = int(rf.readline().strip() or b"0", 16)
                    if size == 0:
                        return
                    frames.append(json.loads(rf.read(size)))
                    arrived.append(time.perf_counter())
                    rf.readline()
            except (OSError, ValueError):
                return

        th = threading.Thread(target=reader, daemon=True)
        th.start()
        time.sleep(0.5)
        check(not frames, f"K.d: {w} got {len(frames)} frames before any "
              "grant")
        lat = []
        with launches:
            for i in range(5):
                t0 = time.perf_counter()
                e.write_relationships([WriteOp("touch", Relationship(
                    "pod", f"kw/a{i}", "viewer", "user", w))])
                while len(frames) <= i and time.perf_counter() < t0 + 30:
                    time.sleep(0.0005)
                check(len(frames) > i, f"K.d: no frame for kw/a{i} within "
                      "30 s of its grant")
                lat.append((arrived[i] - t0) * 1e3)
            time.sleep(0.5)
        s.close()
        th.join(10)
        got = [(f["type"], f["object"]["metadata"]["name"]) for f in frames]
        ref = uncaveated_view_masks(
            e.store, [w], time.time(), e.compiled().type_sizes["pod"],
            pods=[f"kw/a{i}" for i in range(7)])[w]
        pid = e._objects_by_name()["pod"].id_map()
        vis = [f"a{i}" for i in range(7)
               if pid.get(f"kw/a{i}", 0) > 1 and ref[pid[f"kw/a{i}"]]]
        check(vis == [f"a{i}" for i in range(5)]
              and got == [("ADDED", n) for n in vis],
              f"K.d: delivered {got}, the reference allows {vis}")
        log(f"phase K.d filtered watch on the pods of kw for {w} while 5 "
            f"grants are written: frames {[n for _, n in got]} (each "
            f"buffered ADDED event released by its grant, in grant order; "
            f"the 2 ungranted pods never), as the columnar reference "
            f"allows; write -> delivery p50 {pct(lat, 50):.3f} ms, max "
            f"{max(lat):.3f} ms")

        # -- K.e: 256 namespaced lists from 32 client threads --
        pool = [f"u{x}" for x in rng.choice(N_USERS, N_TENANT_LISTS,
                                              replace=False)]
        seeded = sorted(n for (r, ns_, n) in kube.objects
                        if r == "pods" and ns_ == "ns")
        ref = uncaveated_view_masks(
            e.store, pool, time.time(), e.compiled().type_sizes["pod"],
            pods=[f"ns/{n}" for n in seeded])
        exp = {u: sorted(n for n in seeded if ref[u][pid[f"ns/{n}"]])
               for u in pool}

        def burst(label):
            res, lat2 = {}, []
            lock = threading.Lock()

            def worker(chunk):
                c2 = stack.conn()
                for u in chunk:
                    t1 = time.perf_counter()
                    r = k_call(c2, "GET", "/api/v1/namespaces/ns/pods", u)
                    with lock:
                        lat2.append((time.perf_counter() - t1) * 1e3)
                        res[u] = r
                c2.close()

            ths = [threading.Thread(target=worker, args=(pool[i::32],))
                   for i in range(32)]
            with launches:
                t1 = time.perf_counter()
                for t in ths:
                    t.start()
                for t in ths:
                    t.join(300)
                el = time.perf_counter() - t1
            for u in pool:
                st, out = res[u]
                check(st == 200 and sorted(names_of(out)) == exp[u],
                      f"K.e {label}: {u}'s namespaced list differs")
            log(f"phase K.e {label}: {len(pool)} namespaced pod lists "
                f"(GET /api/v1/namespaces/ns/pods, distinct users) from 32 "
                f"client threads over HTTP: {len(pool) / el:.1f} lists/s, "
                f"p50 {pct(lat2, 50):.3f} ms, p99 {pct(lat2, 99):.3f} ms; "
                f"every list equal to the columnar reference")

        burst("batching off")
        e.enable_lookup_batching(window=0.002, max_rows=8)
        try:
            burst("batching on (window 2 ms, max_rows 8)")
        finally:
            e.disable_lookup_batching()
        conn.close()
    finally:
        stack.close()
    torch.cuda.synchronize()
    log(f"  proxy-path launches over K.a-K.e (the requests only): "
        f"{launches.n}")
    check(launches.n["bit_or_matmul"] > 0,
          "bit_or_matmul was not launched on the proxy path")
    return launches.n


def proxy_cli_phase(torch, here: str) -> None:
    """Phase K.f: ``python -m spicedb_kubeapi_proxy_tpu_torch.proxy.cli``
    with no ``--device`` (so cuda), the repo's bootstrap and rules, and
    ``--upstream-url`` at a port ``InMemoryKube`` this script serves on
    loopback: alice creates a namespace and lists it, mallory gets []
    and a 403, and SIGTERM ends it with exit 0."""
    import asyncio
    import http.client
    import signal
    import socket

    from spicedb_kubeapi_proxy_tpu_torch.proxy.inmemkube import InMemoryKube
    from spicedb_kubeapi_proxy_tpu_torch.proxy.server import (
        _read_request,
        _write_response,
    )

    kube = InMemoryKube()

    async def conn_handler(reader, writer):
        try:
            while True:
                req = await _read_request(reader)
                if req is None:
                    return
                await _write_response(writer, await kube(req))
        except (asyncio.IncompleteReadError, ConnectionResetError):
            pass
        finally:
            writer.close()

    lt = LoopThread()
    srv = lt.run(asyncio.start_server(conn_handler, "127.0.0.1", 0))
    up_port = srv.sockets[0].getsockname()[1]
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    root = os.path.join(here, "build", "proxy")
    os.makedirs(root, exist_ok=True)
    db = os.path.join(root, "cli-dtx.sqlite")
    for f in (db, db + "-wal", db + "-shm"):
        if os.path.exists(f):
            os.unlink(f)
    log_path = os.path.join(root, "cli.log")

    def tail() -> str:
        with open(log_path, errors="replace") as fh:
            return fh.read()[-3000:]

    with open(log_path, "w") as logf:
        t0 = time.perf_counter()
        p = subprocess.Popen(
            [sys.executable, "-m", "spicedb_kubeapi_proxy_tpu_torch.proxy.cli",
             "--rule-file", os.path.join(here, "deploy", "rules.yaml"),
             "--bootstrap", os.path.join(here, "deploy", "bootstrap.yaml"),
             "--upstream-url", f"http://127.0.0.1:{up_port}",
             "--bind-port", str(port), "--workflow-database-path", db],
            cwd=here, stdout=logf, stderr=subprocess.STDOUT)
    try:
        while True:
            check(p.poll() is None, f"K.f: the proxy CLI exited during boot "
                  f"({p.returncode}):\n{tail()}")
            check(time.perf_counter() - t0 < 300, "K.f: no bind in 300 s")
            try:
                socket.create_connection(("127.0.0.1", port),
                                         timeout=1).close()
                break
            except OSError:
                time.sleep(0.05)
        bind_s = time.perf_counter() - t0
        c = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        t1 = time.perf_counter()
        st, out = k_call(c, "POST", "/api/v1/namespaces", "alice", {
            "apiVersion": "v1", "kind": "Namespace",
            "metadata": {"name": "k-team"}})
        create_ms = (time.perf_counter() - t1) * 1e3
        check(st == 201, f"K.f: alice's create answered {st}: {out!r}")
        t1 = time.perf_counter()
        st, out = k_call(c, "GET", "/api/v1/namespaces", "alice")
        list_ms = (time.perf_counter() - t1) * 1e3
        check(st == 200 and names_of(out) == ["k-team"],
              f"K.f: alice's list {st} {out!r}")
        st, out = k_call(c, "GET", "/api/v1/namespaces", "mallory")
        check(st == 200 and names_of(out) == [],
              f"K.f: mallory's list {st} {out!r}")
        st, _ = k_call(c, "GET", "/api/v1/namespaces/k-team", "mallory")
        check(st == 403, f"K.f: mallory's get answered {st}")
        c.close()
        check("engine on cuda" in tail(),
              f"K.f: the CLI's engine is not on the card:\n{tail()}")
        t1 = time.perf_counter()
        p.send_signal(signal.SIGTERM)
        rc = p.wait(120)
        check(rc == 0, f"K.f: SIGTERM -> exit {rc}:\n{tail()}")
        log(f"phase K.f the proxy CLI (no --device, so cuda; its log says "
            f"engine on cuda) over a port InMemoryKube served on loopback: "
            f"bind {bind_s:.2f} s after spawn; alice's namespace create "
            f"{create_ms:.1f} ms and her first list {list_ms:.3f} ms (the "
            f"graph's first compile and device build); mallory's list [] "
            f"and get 403; SIGTERM -> exit 0 in "
            f"{time.perf_counter() - t1:.2f} s")
    finally:
        if p.poll() is None:
            p.kill()
            p.wait(30)
        srv.close()
        lt.close()


def proxy_caveat_lists(torch, e, here: str, subjects: list,
                       masks: dict) -> dict:
    """Phase 10i: phase 5's lists through the port's proxy on the
    caveated cell under two ``X-Forwarded-For`` chains whose last hops
    are 10b's allow-both and allow-first addresses; the kept names equal
    10b's masks under the matching contexts. Returns both kernels'
    launches over the requests."""
    from spicedb_kubeapi_proxy_tpu_torch.ops import bitprop
    from spicedb_kubeapi_proxy_tpu_torch.proxy.inmemkube import InMemoryKube

    pods = e._objects_by_name()["pod"]
    n_list = min(e.compiled().type_sizes["pod"] - 2, N_PODS)
    body = pod_list_body(n_list)[0]
    stack = KStack(e, k_rules(here), KUpstream(InMemoryKube(), body))
    launches = Launches(bitprop)
    hops = (("allow-both", "203.0.113.9, 10.1.2.3"),
            ("allow-first", "10.1.2.3, 192.168.1.1"))
    try:
        conn = stack.conn()
        k_call(conn, "GET", "/api/v1/pods", subjects[0])  # warm-up
        for label, xff in hops:
            ms = []
            with ScanSpy() as spy, launches:
                for u in subjects:
                    t0 = time.perf_counter()
                    st, out = k_call(conn, "GET", "/api/v1/pods", u,
                                     headers={"X-Forwarded-For": xff})
                    ms.append((time.perf_counter() - t0) * 1e3)
                    check(st == 200, f"10i: {u}'s list answered {st}")
                    want = [f"p{i}" for i in kept_from(masks[(label, u)],
                                                       pods, n_list)]
                    check(names_of(out) == want, f"10i: {u}'s list under "
                          f"X-Forwarded-For {xff!r} differs from 10b's "
                          f"{label} mask")
            check(spy.scans == len(subjects) and spy.bails == 0
                  and spy.fallbacks == 0, f"10i: native scans {spy.scans}, "
                  f"bails {spy.bails}, Python path {spy.fallbacks}")
            log(f"phase 10i caveated lists through the port's proxy, "
                f"X-Forwarded-For {xff!r} (its last hop is 10b's {label} "
                f"address): {len(subjects)} users, wall p50 "
                f"{pct(ms, 50):.3f} ms, p99 {pct(ms, 99):.3f} ms; the kept "
                f"names equal 10b's {label} masks; native scans "
                f"{spy.scans}")
        conn.close()
    finally:
        stack.close()
    torch.cuda.synchronize()
    check(launches.n["bit_or_matmul"] > 0,
          "bit_or_matmul was not launched on 10i's proxy path")
    return launches.n


# phase 10's request contexts: the first both stored contexts allow, the
# second only the first allows, and without one every caveated grant
# fails closed (two instances, so two missing-context denials a call)
CAV_CONTEXTS = (("allow-both", {"ip": "10.1.2.3"}),
                ("allow-first", {"ip": "192.168.1.1"}),
                ("none", None))
MISSING = "engine_caveat_denied_missing_context_total"


def vm_cost(torch, cg, context) -> dict:
    """The caveat VM alone, once, on the graph's device tables and one
    request: the device activities of one evaluation (torch.profiler:
    kernels and the request's two copies), host ms a call (enqueue, no
    synchronize between calls) and ms a call (CUDA events)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from spicedb_kubeapi_proxy_tpu_torch.caveats.vm import eval_caveats

    cav = cg.caveats
    stat = cg._dev()["cav_static"]
    req, _ = cav.encode_request(context, time.time())

    def fn():
        return eval_caveats(cav.metas, stat, req, cav.n_rows)

    host = host_ms(torch, fn, 50)
    ms = cuda_ms(torch, fn, 50)
    counts = []
    for _ in range(2):  # a process's first profile may record none
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        counts.append(sum(ev.device_type == DeviceType.CUDA
                          for ev in prof.events()))
    return dict(launches=counts[-1] or None, host_ms=host, ms=ms,
                tape=sum(m.T for m in cav.metas))


def caveat_phase(torch, dev, n_rels: int, subjects: list, items: list,
                 bulk_users: list, here: str) -> tuple:
    """Phase 10: the caveated mix at full width (see the module
    docstring). Returns both kernels' launches over 10b-10c, and over
    10i's proxy requests."""
    from spicedb_kubeapi_proxy_tpu_torch.engine import CheckItem, Engine
    from spicedb_kubeapi_proxy_tpu_torch.engine.evaluator import \
        OracleEvaluator
    from spicedb_kubeapi_proxy_tpu_torch.engine.store import Snapshot, \
        WriteOp
    from spicedb_kubeapi_proxy_tpu_torch.models import parse_schema
    from spicedb_kubeapi_proxy_tpu_torch.models.tuples import \
        Relationship, canonical_context
    from spicedb_kubeapi_proxy_tpu_torch.ops import bitprop, semiring
    from spicedb_kubeapi_proxy_tpu_torch.utils.metrics import metrics

    def counter(name, **kw):
        return metrics.counter(name, **kw).value

    def hist_total(name):
        return metrics.histogram(name).total

    def list_mask(u, ctx, now=None):
        return e.lookup_resources_mask("pod", "view", "user", u, now=now,
                                       context=ctx)[0]

    rng = np.random.default_rng(10)

    # -- 10a: build --
    t0 = time.perf_counter()
    rows = build_rows(N_PODS, N_USERS, N_NS, N_GROUPS, n_rels, 2,
                      cav_share=0.3)
    gen_s = time.perf_counter() - t0
    total = len(rows["resource_id"])
    n_cav = int((rows["caveat"] != "").sum())
    plain = np.flatnonzero((rows["resource_type"] == "pod")
                           & (rows["relation"] == "viewer")
                           & (rows["caveat"] == ""))
    i = int(plain[rng.integers(len(plain))])
    base_grant = (str(rows["resource_id"][i]), str(rows["subject_id"][i]))
    del plain
    e = Engine(schema=parse_schema(MESH_SCHEMA), device=dev)
    t0 = time.perf_counter()
    e.bulk_load(rows)
    load_s = time.perf_counter() - t0
    del rows
    t0 = time.perf_counter()
    cg = e.compiled()
    compile_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    d = cg._dev()
    torch.cuda.synchronize()
    dev_s = time.perf_counter() - t0
    cav, rm = cg.caveats, cg.run_meta()
    n_res = int((cg.res_src != cg.M).sum())
    res_cav = int(np.count_nonzero(cg.res_cav))
    log(f"phase 10a caveated store: {total} relationships, {n_cav} of them "
        f"caveated (gen {gen_s:.2f} s), bulk_load {load_s:.2f} s, "
        f"compile_graph {compile_s:.2f} s, device build {dev_s:.2f} s")
    log(f"  residual {n_res} edges ({res_cav} caveated; {len(cg.res_src)} "
        f"padded), {len(cg.blocks)} dense blocks, {cg.n_levels} levels; "
        f"cav_rows {rm.cav_rows}, {cav.n_inst} instances, tape length "
        f"{[m.T for m in cav.metas]} ops, {cav.metas[0].K} list slots")
    check(cav.n_inst == 2 and rm.cav_rows == 9,
          f"10a: {cav.n_inst} instances, {rm.cav_rows} rows (want 2, 9)")
    check(res_cav == n_cav, f"10a: {res_cav} caveated residual edges for "
          f"{n_cav} caveated grants")
    pv = next(i for i, b in enumerate(cg.blocks)
              if b.dst_off == cg.offset_of("pod", "viewer"))
    check(d["blocks_bits"][pv] is not None,
          "10a: the pod#viewer block has no bit dual")
    pods = e._objects_by_name()["pod"]
    for _, ctx in CAV_CONTEXTS:  # warm-up of each path
        list_mask(subjects[0], ctx)

    # -- 10b: list filters under three contexts, launches counted --
    torch.cuda.synchronize()
    bitprop.reset_launch_counts()
    masks = {}
    for label, ctx in CAV_CONTEXTS:
        lat, miss, iters = [], [], set()
        for u in subjects:
            m0 = counter(MISSING)
            t0 = time.perf_counter()
            fut = e.lookup_resources_mask_async("pod", "view", "user", u,
                                                context=ctx)
            masks[(label, u)] = fut.result()[0]
            lat.append((time.perf_counter() - t0) * 1e3)
            miss.append(counter(MISSING) - m0)
            iters.add(fut.iterations())
        vm = vm_cost(torch, cg, ctx)
        log(f"phase 10b list filter, context {label} {ctx}: {len(lat)} "
            f"subjects, B=1, p50 {pct(lat, 50):.3f} ms, p99 "
            f"{pct(lat, 99):.3f} ms wall; iterations {sorted(iters)}; "
            f"missing-context denials a call "
            f"{sorted(set(miss))}; caveat VM a dispatch: {vm['launches']} "
            f"device activities for a {vm['tape']}-op tape, host "
            f"{vm['host_ms']:.4f} ms, {vm['ms']:.4f} ms by CUDA events")
        want = 2 if ctx is None else 0
        check(all(x == want for x in miss),
              f"10b: missing-context counter rose by {sorted(set(miss))} a "
              f"call under {label} (want {want})")
    both, first, none = (sum(int(masks[(lab, u)].sum()) for u in subjects)
                         for lab, _ in CAV_CONTEXTS)
    for u in subjects:
        check(not (masks[("allow-first", u)]
                   & ~masks[("allow-both", u)]).any(),
              f"10b: allow-first grants what allow-both denies for {u}")
        check(not (masks[("none", u)] & ~masks[("allow-first", u)]).any(),
              f"10b: no context grants what allow-first denies for {u}")
    check(both > first > none, f"10b: visible pods {both} / {first} / "
          f"{none}: the caveat does not bite")
    log(f"  visible pods over {len(subjects)} subjects: allow-both {both} "
        f">= allow-first {first} >= none {none}")

    # -- 10c: bulk check under the second context --
    ctx2 = CAV_CONTEXTS[1][1]
    rates, now_c = [], time.time()
    for _ in range(5):
        t0 = time.perf_counter()
        verdicts = e.check_bulk(items, now=now_c, context=ctx2)
        rates.append(len(items) / (time.perf_counter() - t0))
    launches = {"bit_or_matmul": bitprop.bit_or_matmul.launches,
                "dense_or_matmul": bitprop.dense_or_matmul.launches}
    log(f"phase 10c bulk check under {ctx2}: {len(items)} checks, p50 "
        f"{np.median(rates):,.0f} checks/s over 5 trials (min "
        f"{min(rates):,.0f}, max {max(rates):,.0f}); {sum(verdicts)} "
        f"allowed; launches over 10b-10c {launches}")
    for kname, cnt in launches.items():
        check(cnt > 0, f"{kname} was not launched on the caveated path")

    # -- 10d: forced pull --
    with semiring.force_mode("pull"):
        for label, ctx in CAV_CONTEXTS:
            for u in subjects:
                check(np.array_equal(list_mask(u, ctx), masks[(label, u)]),
                      f"10d: forced pull differs for {u} under {label}")
    log(f"phase 10d forced pull: {3 * len(subjects)} masks identical to "
        "10b")

    # -- 10i: the same lists through the port's proxy --
    proxy_launches = proxy_caveat_lists(torch, e, here, subjects, masks)

    # -- 10e: the caveated oracle --
    t0 = time.perf_counter()
    snap = e.store.snapshot()
    now = time.time()
    sample = subjects[:6]
    n_checks = 0
    for label, ctx in CAV_CONTEXTS:
        orc = user_oracles(snap, e.schema, OracleEvaluator, Snapshot,
                           sample, now, ctx)
        for u in sample[:2]:
            ids = {pods.string(i) for i in
                   np.flatnonzero(list_mask(u, ctx, now=now))}
            check(ids == orc[u].lookup_resources("pod", "view", "user", u),
                  f"10e: the mask for {u} under {label} disagrees with "
                  "the oracle")
        chk = []
        for u in sample:
            vis = np.flatnonzero(masks[(label, u)])
            chk += [CheckItem("pod", pods.string(i), "view", "user", u)
                    for i in vis[:10].tolist()]
            chk += [CheckItem("pod", f"ns/p{rng.integers(N_PODS)}", "view",
                              "user", u) for _ in range(30)]
        got = e.check_bulk(chk, now=now, context=ctx)
        want = [orc[c.subject_id].check("pod", c.resource_id, "view", "user",
                                        c.subject_id) for c in chk]
        check(got == want, f"10e: {sum(a != b for a, b in zip(got, want))} "
              f"of {len(chk)} checks under {label} disagree with the oracle")
        n_checks += len(chk)
    orc = user_oracles(snap, e.schema, OracleEvaluator, Snapshot,
                       bulk_users[:2], now_c, ctx2)
    own = [(c, v) for c, v in zip(items, verdicts)
           if c.subject_id in orc][::8]
    check(all(v == orc[c.subject_id].check("pod", c.resource_id, "view",
                                           "user", c.subject_id)
              for c, v in own), "10e: 10c's verdicts disagree with the oracle")
    del snap, orc
    log(f"phase 10e oracle: 2 full masks and {n_checks // 3} checks a "
        f"context exact under all three, and {len(own)} of 10c's verdicts "
        f"({time.perf_counter() - t0:.1f} s)")

    # -- 10h: the decision cache and the batcher on the caveated cell --
    e.enable_decision_cache()
    e.enable_lookup_batching()  # the reference's defaults: 2 ms, 8 rows
    cache = e._decision_cache
    u = next((u for u in subjects if masks[("allow-both", u)].sum()
              > masks[("allow-first", u)].sum() > masks[("none", u)].sum()),
             None)
    check(u is not None, "10h: no subject whose three masks all differ")
    n0 = cache.stats()["entries"]
    b0 = counter("engine_lookup_batches_total")
    for label, ctx in CAV_CONTEXTS[:2]:
        check(np.array_equal(list_mask(u, ctx), masks[(label, u)]),
              f"10h: the cached path's mask for {u} under {label} differs "
              "from 10b's")
    check(counter("engine_lookup_batches_total") == b0,
          "10h: a contexted list went through the batcher")
    m0 = counter(MISSING)
    check(np.array_equal(list_mask(u, None), masks[("none", u)]),
          f"10h: the cached path's mask for {u} without a context differs "
          "from 10b's")
    check(counter("engine_lookup_batches_total") == b0 + 1
          and counter(MISSING) - m0 == 2,
          "10h: the context-free list did not fuse or miscounted its "
          "missing-context denials")
    check(cache.stats()["entries"] == n0 + 3,
          f"10h: {cache.stats()['entries'] - n0} entries for 3 contexts")
    l0 = counter("engine_lookups_total")
    h0 = counter("engine_decision_cache_hits_total", kind="lookup")
    for label, ctx in CAV_CONTEXTS:
        check(np.array_equal(list_mask(u, ctx), masks[(label, u)]),
              f"10h: the cached mask for {u} under {label} differs")
    undeclared = dict(CAV_CONTEXTS[0][1], verb="list", user="alice")
    check(np.array_equal(list_mask(u, undeclared),
                         masks[("allow-both", u)]),
          "10h: an undeclared key changed the mask")
    dh = counter("engine_decision_cache_hits_total", kind="lookup") - h0
    check(counter("engine_lookups_total") == l0 and dh == 4,
          f"10h: {dh:.0f} hits of 4, an undeclared key split the entry or "
          "a repeat dispatched")
    # eight context-free lists in one fused dispatch (a window long enough
    # that the eighth submit flushes): the missing-context denials count
    # once a dispatch, not once a row
    e.enable_lookup_batching(window=60.0)
    rows8 = list(dict.fromkeys(s for s in subjects if s != u))[:8]
    m0, b0 = counter(MISSING), counter("engine_lookup_batches_total")
    futs = [e.lookup_resources_mask_async("pod", "view", "user", s)
            for s in rows8]
    for s, f in zip(rows8, futs):
        check(np.array_equal(f.result()[0], masks[("none", s)]),
              f"10h: the fused context-free mask for {s} differs from 10b's")
    check(counter("engine_lookup_batches_total") - b0 == 1
          and counter(MISSING) - m0 == 2,
          f"10h: {counter('engine_lookup_batches_total') - b0:.0f} batches, "
          f"{counter(MISSING) - m0:.0f} missing-context denials for 8 fused "
          "rows (want 1, 2)")
    e.disable_lookup_batching()
    e.disable_decision_cache()
    log(f"phase 10h decision cache on the caveated cell: {u}'s masks under "
        f"the three contexts cached as three entries, each byte-equal to "
        f"10b's (visible pods {int(masks[('allow-both', u)].sum())} > "
        f"{int(masks[('allow-first', u)].sum())} > "
        f"{int(masks[('none', u)].sum())}); the contexted lists bypassed "
        f"the batcher; a context differing only in undeclared keys hit the "
        f"declared entry; 8 context-free lists fused into one dispatch "
        f"counting 2 missing-context denials")

    # -- 10f: caveated writes --
    new_ctx = [canonical_context({"allowed": [f"172.16.{k}.0/24"]})
               for k in range(7)]
    plan = [("reuse", k) for k in range(44)] \
        + [("new", k) for k in range(6)] + [("attach", 0)]
    plan = [plan[i] for i in rng.permutation(len(plan))] + [("overflow", 6)]
    # one warm pair first: the first write after a load builds the
    # store's row index (phase 9a)
    e.write_relationships([WriteOp("touch", Relationship(
        "pod", f"ns/p{rng.integers(N_PODS)}", "viewer", "user",
        subjects[0], None, None, "ip_allowlist", MESH_CTXS[0]))])
    list_mask(subjects[0], CAV_CONTEXTS[0][1])
    c0, i0 = counter("engine_graph_compiles_total"), counter(
        "engine_graph_incremental_updates_total")
    fb0 = counter("engine_graph_incremental_fallback_total", reason="caveat")
    w_ms, r_ms, j_ms, o_ms, p_ms, kinds = [], [], [], [], [], []
    touched = {}
    for kind, k in plan:
        if kind == "reuse":
            pod, u = f"ns/p{rng.integers(N_PODS)}", f"u{rng.integers(N_USERS)}"
            ctx_json, read = MESH_CTXS[k % 2], CAV_CONTEXTS[0][1]
        elif kind == "attach":
            (pod, u), ctx_json = base_grant, MESH_CTXS[1]
            read = CAV_CONTEXTS[0][1]
        else:
            pod, u = f"ns/p{rng.integers(N_PODS)}", f"u{rng.integers(N_USERS)}"
            ctx_json, read = new_ctx[k], {"ip": f"172.16.{k}.9"}
        rel = Relationship("pod", pod, "viewer", "user", u, None, None,
                           "ip_allowlist", ctx_json)
        jt = hist_total("store_write_seconds")
        ot = hist_total("engine_graph_incremental_seconds")
        pt = hist_total("engine_overlay_patch_seconds")
        t0 = time.perf_counter()
        e.write_relationships([WriteOp("touch", rel)])
        w_ms.append((time.perf_counter() - t0) * 1e3)
        j_ms.append((hist_total("store_write_seconds") - jt) * 1e3)
        o_ms.append((hist_total("engine_graph_incremental_seconds") - ot)
                    * 1e3)
        p_ms.append((hist_total("engine_overlay_patch_seconds") - pt) * 1e3)
        t0 = time.perf_counter()
        m = list_mask(u, read)
        r_ms.append((time.perf_counter() - t0) * 1e3)
        kinds.append(kind)
        check(bool(m[pods.lookup(pod)]),
              f"10f: the {kind} grant {pod}@{u} is not visible under {read}")
        if kind != "reuse":
            touched[u] = read
    dc = counter("engine_graph_compiles_total") - c0
    di = counter("engine_graph_incremental_updates_total") - i0
    dfb = counter("engine_graph_incremental_fallback_total",
                  reason="caveat") - fb0

    def split(sel, xs):
        v = [x for x, kd in zip(xs, kinds) if kd in sel]
        return f"{pct(v, 50):.3f} ({pct(v, 99):.3f})"

    log(f"phase 10f caveated writes: {len(plan)} write->read pairs (44 "
        "reusing a stored context, 6 new contexts on spare rows, 1 caveat "
        "attached to a base grant, 1 new context past the bucket); write "
        f"p50 {pct(w_ms, 50):.3f} ms p99 {pct(w_ms, 99):.3f} ms, "
        f"read-after-write p50 {pct(r_ms, 50):.3f} ms p99 "
        f"{pct(r_ms, 99):.3f} ms")
    for name, sel in (("reuse", ("reuse",)),
                      ("new context (instance columns too)", ("new",))):
        log(f"  {name}: write p50 (p99) {split(sel, w_ms)} ms = journal "
            f"{split(sel, j_ms)} + host commit {split(sel, o_ms)} + device "
            f"patch {split(sel, p_ms)} ms")
    log(f"  the overflow write {w_ms[-1]:.3f} ms and its read (the "
        f"recompile) {r_ms[-1]:.3f} ms")
    log(f"  recompiles {dc:.0f}, incremental updates {di:.0f}, caveat "
        f"fallbacks {dfb:.0f}; instances now {e.compiled().caveats.n_inst}")
    check(dc == 1 and dfb == 1 and di == len(plan) - 1,
          f"10f: {dc:.0f} recompiles, {dfb:.0f} caveat fallbacks, {di:.0f} "
          f"incremental updates for {len(plan)} writes (want 1, 1, "
          f"{len(plan) - 1})")
    snap, now = e.store.snapshot(), time.time()
    for u, read in touched.items():
        o = user_oracles(snap, e.schema, OracleEvaluator, Snapshot, [u], now,
                         read)[u]
        ids = {pods.string(i) for i in
               np.flatnonzero(list_mask(u, read, now=now))}
        check(ids == o.lookup_resources("pod", "view", "user", u),
              f"10f: the mask for {u} disagrees with the oracle")
    del snap
    log(f"  {len(touched)} written subjects' masks exact against the oracle")

    # -- 10g: where the time goes --
    trace_phase(torch, "caveated list filter (B=1, allow-both)", lambda: [
        list_mask(u, CAV_CONTEXTS[0][1]) for u in subjects[:10]], 10,
        {"bit_or_matmul_kernel": ("bit_or_matmul_kernel",),
         "its small-dual stream kernel": ("bit_or_matmul_stream_kernel",)},
        annotations=("caveat_vm",))
    return launches, proxy_launches


# -- phase X: scale-out on the card -------------------------------------------

# X.b and X.d's store: the reference bench's 10x shard point
# (bench.py:2428-2433: 20,000 namespaces x 12 pods, 512 users, generated
# as _shard_phase_at_scale does) with a sixteenth of its namespaces:
# moving the whole point took X.b and X.d 195-238 s on the H100 (700 W),
# past the ~150 s phase X is given in all; a quarter left the run too
# little room for phase F, an eighth (PRs 11-12) for phase G
X10_NS, X10_PODS_PER_NS, X10_USERS = 1_250, 12, 512
X_VNODES = 64
X_SUBJECTS = 64  # X.a and X.c's list subjects (phase 5's 31 and 33 more)
X_ROUTED = 256  # X.a's routed single checks, phase 6's first items
X_PROXY_LISTS = 11  # X.e's GET /api/v1/pods
X_LIST_GAP = 0.05  # X.b and X.d's lister: one list, then 50 ms


def x_key_name(k: int) -> tuple:
    """A partition key id of ``build_rows(part_out=...)`` as the shard
    map's ``(namespace, resource type)``."""
    return (f"ns{k}", "pod") if k < N_NS else (f"gh{k - N_NS}", "group")


def pod_index(pid: str) -> int:
    return int(pid.rsplit("/p", 1)[1])


class Fleet:
    """G engine groups on the card, each an ``Engine`` behind its own
    in-process ``EngineServer`` on loopback (one loop thread for all),
    reached through the port's ``RemoteEngine`` clients, and a port
    ``ShardedEngine`` over them with a ``SplitJournal`` in ``root``.
    ``cols`` holds each group's rows (a group with none starts empty)."""

    def __init__(self, torch, dev, cols: list, schema: str, root: str,
                 frontier=None, compaction: bool = False, spare: int = 0):
        from concurrent.futures import ThreadPoolExecutor

        from spicedb_kubeapi_proxy_tpu_torch.engine import Engine, remote
        from spicedb_kubeapi_proxy_tpu_torch.models import parse_schema
        from spicedb_kubeapi_proxy_tpu_torch.scaleout import (
            ShardedEngine,
            ShardMap,
            SplitJournal,
        )

        torch.cuda.synchronize()
        self.mem0 = torch.cuda.memory_allocated()
        t0 = time.perf_counter()

        def build(c):
            e = Engine(schema=parse_schema(schema), device=dev)
            if c is not None and len(c["resource_id"]):
                e.bulk_load(c)
                e.compiled()._dev()
            if compaction:
                e.enable_compaction()
            return e

        # the groups' loads and compiles overlap (numpy releases the GIL)
        with ThreadPoolExecutor(max_workers=len(cols)) as pool:
            self.engines = list(pool.map(build, cols))
        torch.cuda.synchronize()
        self.build_s = time.perf_counter() - t0
        self.mem1 = torch.cuda.memory_allocated()
        self.lt = LoopThread()
        self.servers, self.clients = [], []
        for e in self.engines:
            srv = remote.EngineServer(e)
            self.lt.run(srv.start())
            self.servers.append(srv)
            self.clients.append(remote.RemoteEngine(
                "127.0.0.1", srv.port, timeout=600))
        n = len(cols) - spare
        self.map = ShardMap(version=1, groups=tuple(
            (("127.0.0.1", s.port),) for s in self.servers[:n]),
            virtual_nodes=X_VNODES)
        if os.path.isdir(root):
            shutil.rmtree(root)
        os.makedirs(root)
        self.journal = SplitJournal(os.path.join(root, "sj.sqlite"))
        self.planner = ShardedEngine(self.map, self.clients[:n],
                                     journal=self.journal,
                                     frontier=frontier)

    def endpoints(self, n: int) -> tuple:
        return tuple((("127.0.0.1", s.port),) for s in self.servers[:n])

    def device_bytes(self) -> list:
        return [e.compiled().device_bytes() for e in self.engines]

    def close(self, torch) -> None:
        self.planner.close()
        for c in self.clients:
            c.close()
        for s in self.servers:
            self.lt.run(s.stop())
        self.lt.close()
        for e in self.engines:
            if e.compactor is not None:
                e.close_compaction()
        self.engines.clear()
        self.servers.clear()
        self.clients.clear()
        self.planner = self.journal = None
        gc.collect()
        torch.cuda.empty_cache()


def x_partition(rows: dict, key: np.ndarray, smap) -> list:
    """Each group's rows under ``smap``: the global rows (key -1) on
    every group, the rest on their key's owner."""
    owner = np.array([smap.shard_for(*x_key_name(k))
                      for k in range(N_NS + N_GROUPS)], dtype=np.int64)
    row_owner = np.where(key < 0, -1, owner[np.maximum(key, 0)])
    out = []
    for gi in range(smap.n_groups):
        sel = np.flatnonzero((row_owner == -1) | (row_owner == gi))
        out.append({k: v[sel] for k, v in rows.items()})
    return out


def x_rows(rows: dict, part: dict) -> dict:
    """Phase 3's rows with pod i re-keyed ``ns{k}/p{i}`` (its namespace
    k; the shard map partitions by an id's namespace part): the same
    graph under a bijection of ids."""
    pods = np.char.add(np.char.add(np.char.add(
        "ns", part["pod_ns"].astype(str)), "/p"),
        np.arange(len(part["pod_ns"])).astype(str))
    start = part["n_gm"] + part["n_nv"]
    rid = rows["resource_id"].astype(
        f"U{max(16, rows['resource_id'].dtype.itemsize // 4)}")
    rid[start:] = pods[part["pod_row"]]
    return dict(rows, resource_id=rid)


def x_rekey_groups(rows: dict, part: dict) -> tuple:
    """``rows`` with group j named ``gh{j}/g{j}`` (group#member rows and
    the namespace#viewer rows' subjects; a namespaced id, so group#member
    partitions instead of replicating), and the partition keys that go
    with it (n_ns + j for ``("gh{j}", "group")``)."""
    n_gm, n_nv = part["n_gm"], part["n_nv"]
    out = dict(rows)
    rid = rows["resource_id"].copy()
    width = max(10, rows["subject_id"].dtype.itemsize // 4)
    sid = rows["subject_id"].astype(f"U{width}")
    g_member = np.array([int(x[1:]) for x in rid[:n_gm]], dtype=np.int64)
    g_viewer = np.array([int(x[1:]) for x in sid[n_gm:n_gm + n_nv]],
                        dtype=np.int64)

    def named(j):
        return np.char.add(np.char.add(np.char.add("gh", j.astype(str)),
                                       "/g"), j.astype(str))

    rid[:n_gm] = named(g_member)
    sid[n_gm:n_gm + n_nv] = named(g_viewer)
    out["resource_id"], out["subject_id"] = rid, sid
    key = part["key"].copy()
    key[:n_gm] = N_NS + g_member
    return out, key


def x_headline_fleet(torch, dev, here: str, rows: dict, key: np.ndarray,
                     n_groups: int, frontier=None, tag: str = "") -> tuple:
    """The re-keyed headline rows partitioned over ``n_groups`` groups:
    (fleet, rows a group)."""
    from spicedb_kubeapi_proxy_tpu_torch.scaleout import ShardMap

    t0 = time.perf_counter()
    probe = ShardMap(version=1, groups=tuple(
        (("127.0.0.1", 1 + gi),) for gi in range(n_groups)),
        virtual_nodes=X_VNODES)  # ring points are keyed by group index
    cols = x_partition(rows, key, probe)
    part_s = time.perf_counter() - t0
    fleet = Fleet(torch, dev, cols, BENCH_SCHEMA,
                  os.path.join(here, "build", "scaleout", tag),
                  frontier=frontier)
    per_group = [len(c["resource_id"]) for c in cols]
    del cols
    gc.collect()
    log(f"  {tag}: {n_groups} groups, rows {per_group} (the global rows "
        f"on every group), partition {part_s:.2f} s, bulk_load + compile "
        f"+ device build {fleet.build_s:.2f} s (the groups in parallel); "
        f"device bytes held by the graphs {fleet.device_bytes()}, "
        f"allocated {fleet.mem0} -> {fleet.mem1}")
    return fleet, per_group


def x_ops(metrics, op: str, mode: str) -> float:
    return sum(metrics.counter("scaleout_ops_total", group=str(gi), op=op,
                               mode=mode).value for gi in range(8))


def x_mix(torch, fleet, label: str, ref: dict, pod_ns, launches) -> dict:
    """X.a's mix on a fleet: the list filters of ``ref``'s 64 subjects
    (gathered ids mapped back to pod indices, equal to phase 5's masks),
    ``X_ROUTED`` routed single checks (no scatter) and the 64 x 1,024 bulk
    check scatter-gathered (equal to phase 6's verdicts)."""
    from spicedb_kubeapi_proxy_tpu_torch.engine import CheckItem
    from spicedb_kubeapi_proxy_tpu_torch.utils.metrics import metrics

    p = fleet.planner

    def rekey(it):
        i = pod_index(it.resource_id)
        return CheckItem("pod", f"ns{pod_ns[i]}/p{i}", it.permission,
                         it.subject_type, it.subject_id)

    items = [rekey(it) for it in ref["items"]]
    p.lookup_resources_mask("pod", "view", "user", ref["subjects"][0])
    p.check_bulk(items[:64])
    lat = []
    with launches:
        for u in ref["subjects"]:
            t0 = time.perf_counter()
            mask, ids = p.lookup_resources_mask("pod", "view", "user", u)
            lat.append((time.perf_counter() - t0) * 1e3)
            got = np.sort(np.array([pod_index(ids.string(i))
                                    for i in np.flatnonzero(mask)],
                                   dtype=np.int64))
            check(np.array_equal(got, ref["masks"][u]),
                  f"{label}: {u}'s gathered list differs from phase 5's "
                  f"mask ({len(got)} ids, {len(ref['masks'][u])} wanted)")
    sc0 = x_ops(metrics, "check_bulk", "scatter")
    single = []
    with launches:
        for k, it in enumerate(items[:X_ROUTED]):
            t0 = time.perf_counter()
            v = p.check(it)
            single.append((time.perf_counter() - t0) * 1e3)
            check(v == ref["verdicts"][k],
                  f"{label}: routed check {k} disagrees with phase 6")
    check(x_ops(metrics, "check_bulk", "scatter") == sc0,
          f"{label}: a routed single check scattered")
    rates = []
    with launches:
        for _ in range(3):
            t0 = time.perf_counter()
            got = p.check_bulk(items)
            rates.append(len(items) / (time.perf_counter() - t0))
            check(got == ref["verdicts"],
                  f"{label}: the scatter-gathered bulk check differs from "
                  "phase 6's verdicts")
    out = {"list_p50": pct(lat, 50), "list_p99": pct(lat, 99),
           "check_p50": pct(single, 50), "checks_per_s": float(
               np.median(rates))}
    log(f"  {label} lists: {len(lat)} subjects, "
        f"lookup_resources_mask scatter-gathered over "
        f"{len(p.groups)} groups: p50 {out['list_p50']:.3f} ms, p99 "
        f"{out['list_p99']:.3f} ms; every list equal to phase 5's mask "
        f"under the re-key; {len(single)} routed single checks p50 "
        f"{out['check_p50']:.3f} ms (scatter counter unchanged, verdicts "
        f"equal phase 6's); bulk 64 x 1,024 scatter-gathered "
        f"{out['checks_per_s']:,.0f} checks/s (median of 3, min "
        f"{min(rates):,.0f}), equal to phase 6's verdicts")
    return out


def x10_rows() -> tuple:
    """The reference bench's 10x shard point: ``(ns_viewer, pod_rows)``,
    drawn as bench.py's _shard_phase_at_scale draws them (seed 7)."""
    rng = np.random.default_rng(7)
    ns_viewer = [(f"ns{i}", f"u{int(rng.integers(X10_USERS))}")
                 for i in range(X10_NS)]
    pod_rows = []
    for i in range(X10_NS):
        for p in range(X10_PODS_PER_NS):
            pod_rows.append((f"ns{i}/p{p}", f"ns{i}",
                             f"u{int(rng.integers(X10_USERS))}"))
    return ns_viewer, pod_rows


def x10_cols(ns_viewer, pod_rows, smap, gi) -> dict:
    cols = {k: [] for k in ("resource_type", "resource_id", "relation",
                            "subject_type", "subject_id",
                            "subject_relation")}

    def add(rt, rid, rl, st, sid):
        for k, v in zip(cols, (rt, rid, rl, st, sid, "")):
            cols[k].append(v)

    for ns, u in ns_viewer:
        add("namespace", ns, "viewer", "user", u)
    for pid, ns, u in pod_rows:
        if smap.shard_of("pod", pid) == gi:
            add("pod", pid, "namespace", "namespace", ns)
            add("pod", pid, "viewer", "user", u)
    return {k: np.asarray(v) for k, v in cols.items()}


class XTraffic:
    """X.b and X.d's load: a lister (its subjects' lists held exact
    against the reference on every call, latencies kept; 50 ms between
    lists) and a writer
    that writes every 10 ms, alternating a pod grant (one group) and a
    namespace grant (every group: a journaled split), for fresh subjects
    ``xw{n}``; acknowledged writes are kept, a write shed by the overlay's
    back-pressure is retried, and one that raised a type in ``race_ok``
    (X.d: the IndexError of a split write whose later leg a shrink's
    commit took out of the planner's groups) is kept as never
    acknowledged, for ``verify`` to hold all-or-none; any other error
    fails the phase."""

    def __init__(self, planner, want: dict, ns_pods: dict, tag: str,
                 seed: int, race_ok: tuple = ()):
        from spicedb_kubeapi_proxy_tpu_torch.engine.store import WriteOp
        from spicedb_kubeapi_proxy_tpu_torch.models.tuples import \
            Relationship

        self.p, self.want, self.ns_pods, self.tag = (planner, want,
                                                     ns_pods, tag)
        self.WriteOp, self.Rel = WriteOp, Relationship
        self.rng = np.random.default_rng(seed)
        self.stop = threading.Event()
        self.lat: list = []
        self.lists = 0
        self.bad: list = []
        self.acked: list = []  # (kind, namespace, pod id or None, subject)
        self.rejected = 0
        self.race_ok = race_ok
        self.failed: list = []  # as ``acked``, and the error
        self.errors: list = []
        self.n = 0
        self.threads = [threading.Thread(target=self._guard, args=(f,),
                                         daemon=True)
                        for f in (self._lister, self._writer)]

    def start(self) -> "XTraffic":
        for t in self.threads:
            t.start()
        return self

    def _guard(self, fn) -> None:
        try:
            fn()
        except BaseException as ex:  # noqa: BLE001 - surfaced by finish
            self.errors.append(repr(ex))

    def _lister(self) -> None:
        users = sorted(self.want)
        k = 0
        while not self.stop.is_set():
            u = users[k % len(users)]
            t0 = time.perf_counter()
            got = self.p.lookup_resources("pod", "view", "user", u)
            self.lat.append((time.perf_counter() - t0) * 1e3)
            if sorted(got) != self.want[u]:
                g, w = set(got), set(self.want[u])
                self.bad.append((u, sorted(g - w)[:3], sorted(w - g)[:3]))
            self.lists += 1
            k += 1
            self.stop.wait(X_LIST_GAP)

    def _writer(self) -> None:
        from spicedb_kubeapi_proxy_tpu_torch.admission import \
            AdmissionRejected

        nss = sorted(self.ns_pods)
        while not self.stop.is_set():
            n = self.n
            ns = nss[int(self.rng.integers(len(nss)))]
            subj = f"xw{self.tag}{n}"
            if n % 2 == 0:
                pid = self.ns_pods[ns][int(self.rng.integers(
                    len(self.ns_pods[ns])))]
                rel = self.Rel("pod", pid, "viewer", "user", subj)
            else:
                pid = None
                rel = self.Rel("namespace", ns, "viewer", "user", subj)
            try:
                self.p.write_relationships([self.WriteOp("touch", rel)])
            except AdmissionRejected as ex:
                # the overlay's back-pressure (the compactor folds): not
                # acknowledged, retried as the next write
                self.rejected += 1
                self.stop.wait(min(1.0, ex.retry_after or 0.05))
                continue
            except self.race_ok as ex:
                self.failed.append(("pod" if pid else "namespace", ns, pid,
                                    subj, repr(ex)))
                self.n += 1
                continue
            self.acked.append(("pod" if pid else "namespace", ns, pid,
                               subj))
            self.n += 1
            self.stop.wait(0.01)

    def finish(self) -> None:
        self.stop.set()
        for t in self.threads:
            t.join(300)
            check(not t.is_alive(), f"X.{self.tag}: a traffic thread hung")
        check(not self.errors, f"X.{self.tag}: traffic failed: "
              f"{self.errors[:2]}")
        check(not self.bad, f"X.{self.tag}: {len(self.bad)} of "
              f"{self.lists} lists were not exact (first {self.bad[:3]})")

    def held(self, kind: str, ns: str, pid, subj: str) -> list:
        """Whether each owning group (every group for a namespace grant)
        holds the write."""
        from spicedb_kubeapi_proxy_tpu_torch.engine import \
            RelationshipFilter

        p = self.p
        if kind == "pod":
            f = RelationshipFilter(resource_type="pod", resource_id=pid,
                                   relation="viewer", subject_id=subj)
            owners = [p.map.shard_for(ns, "pod")]
        else:
            f = RelationshipFilter(resource_type="namespace",
                                   resource_id=ns, relation="viewer",
                                   subject_id=subj)
            owners = range(len(p.groups))
        return [bool(p.groups[gi].read_relationships(f)) for gi in owners]

    def verify(self) -> None:
        """Every acknowledged write read back from its owning group (a
        namespace grant from every group), and its subject's list exact;
        after the journal's replay of any split left pending, each
        unacknowledged write on all of its owners or on none."""
        p = self.p
        replayed = p.recover_splits() if self.failed else 0
        check(not p.journal.pending_count(),
              f"X.{self.tag}: {p.journal.pending_count()} splits still "
              "pending after the journal's replay")
        for kind, ns, pid, subj in self.acked:
            held = self.held(kind, ns, pid, subj)
            check(all(held), f"X.{self.tag}: acknowledged write {kind} "
                  f"{ns} {subj} is missing on groups "
                  f"{[gi for gi, h in enumerate(held) if not h]}")
        for kind, ns, pid, subj, err in self.failed:
            held = self.held(kind, ns, pid, subj)
            check(all(held) or not any(held), f"X.{self.tag}: the "
                  f"unacknowledged write {kind} {ns} {subj} ({err}) is on "
                  f"groups {held} after {replayed} replays: half applied")
        for kind, ns, pid, subj in self.acked[-24:]:
            want = [pid] if kind == "pod" else sorted(self.ns_pods[ns])
            check(sorted(p.lookup_resources("pod", "view", "user", subj))
                  == sorted(want), f"X.{self.tag}: {subj}'s list after "
                  "the commit is not exact")


def x_engine_counts(metrics) -> dict:
    reasons = ("overflow", "stratification-inversion", "closured-expiry",
               "closured-caveat", "caveat", "history-trimmed", "unlogged",
               "layout", "unstratified")
    return {"compiles": metrics.counter("engine_graph_compiles_total").value,
            "folds": metrics.counter("engine_compactions_total").value,
            "incremental": metrics.counter(
                "engine_graph_incremental_updates_total").value,
            **{f"fallback:{r}": metrics.counter(
                "engine_graph_incremental_fallback_total",
                reason=r).value for r in reasons}}


def x_delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after
            if after[k] - before[k]}


def x_rebalance(torch, dev, here: str, seed: int, launches) -> None:
    """X.b (a live 2 -> 4 grow) and X.d (the autoscaler's 4 -> 3 shrink)
    on the 10x shard point, under a lister and a writer."""
    from spicedb_kubeapi_proxy_tpu_torch.autoscale import (
        AutoscaleController,
        AutoscalePolicy,
        parse_policy,
    )
    from spicedb_kubeapi_proxy_tpu_torch.engine import remote
    from spicedb_kubeapi_proxy_tpu_torch.scaleout import ShardMap
    from spicedb_kubeapi_proxy_tpu_torch.utils.metrics import metrics

    t0 = time.perf_counter()
    ns_viewer, pod_rows = x10_rows()
    want_sets: dict = {}
    ns_pods: dict = {}
    for pid, ns, u in pod_rows:
        ns_pods.setdefault(ns, []).append(pid)
        want_sets.setdefault(u, set()).add(pid)
    for ns, u in ns_viewer:
        want_sets.setdefault(u, set()).update(ns_pods[ns])
    lister_users = [f"u{k}" for k in range(16)]
    want = {u: sorted(want_sets.get(u, ())) for u in lister_users}
    probe = ShardMap(version=1, groups=tuple(
        (("127.0.0.1", 1 + gi),) for gi in range(2)),
        virtual_nodes=X_VNODES)
    cols = [x10_cols(ns_viewer, pod_rows, probe, gi) for gi in range(2)]
    cols += [None, None]  # groups 2 and 3 start empty
    gen_s = time.perf_counter() - t0
    fleet = Fleet(torch, dev, cols, BENCH_SCHEMA,
                  os.path.join(here, "build", "scaleout", "x10"),
                  compaction=True, spare=2)
    p = fleet.planner
    n_rows = len(ns_viewer) + 2 * len(pod_rows)
    log(f"phase X.b the 10x shard point (bench.py:2428-2433) with "
        f"{X10_NS / 20_000:g} of its namespaces: {X10_NS} "
        f"namespaces x {X10_PODS_PER_NS} pods, {X10_USERS} users, "
        f"{n_rows} relationships), groups 0-1 loaded (rows "
        f"{[len(c['resource_id']) for c in cols[:2]]}), groups 2-3 empty, "
        f"the compactor on each and overlays of "
        f"{fleet.engines[0]._delta_capacity} slots (the engine host's "
        f"defaults: the mover writes at most "
        f"{remote.mover_chunk_cap(fleet.engines[0])} rows at a time "
        f"into a compiled group); rows "
        f"{gen_s:.2f} s, build {fleet.build_s:.2f} s")
    del cols
    for u in lister_users[:2]:
        check(sorted(p.lookup_resources("pod", "view", "user", u))
              == want[u], f"X.b: {u}'s list before the move")
    target = ShardMap(version=2, groups=fleet.endpoints(4),
                      virtual_nodes=X_VNODES)
    c0 = x_engine_counts(metrics)
    m0 = {k: metrics.counter(k).value for k in (
        "scaleout_rebalance_copied_rows_total",
        "scaleout_rebalance_gc_rows_total",
        "scaleout_rebalance_replayed_events_total",
        "scaleout_rebalance_dual_writes_total",
        "scaleout_rebalance_shed_backoff_total",
        "scaleout_split_writes_total")}
    traffic = XTraffic(p, want, ns_pods, "b", seed + 700).start()
    time.sleep(0.5)  # the traffic's baseline before the move
    base_lists = traffic.lists
    with launches:
        t1 = time.perf_counter()
        coord = p.begin_rebalance(target, new_clients={
            2: fleet.clients[2], 3: fleet.clients[3]})
        lat0 = len(traffic.lat)
        check(coord.wait(900), "X.b: the move did not finish")
        commit_s = time.perf_counter() - t1
        move_lat = traffic.lat[lat0:]
        traffic.finish()
    check(coord.error is None, f"X.b: the mover failed: {coord.error}")
    check(not traffic.failed, f"X.b: writes failed during the grow: "
          f"{traffic.failed[:2]}")
    check(p.map.version == 2 and len(p.groups) == 4,
          "X.b: the planner did not commit the 4-group map")
    moved = {k: metrics.counter(k).value - v for k, v in m0.items()}
    counts = x_delta(x_engine_counts(metrics), c0)
    traffic.verify()
    doc = fleet.journal.load_transition()
    check(doc is not None and doc["phase"] == "done",
          f"X.b: the journal's transition is {doc and doc['phase']}")
    log(f"  X.b online rebalance 2 -> 4 (map v1 -> v2, "
        f"{len(p._archived_transitions[-1].slices)} slices): commit "
        f"{commit_s:.2f} s after begin_rebalance, rows copied "
        f"{moved['scaleout_rebalance_copied_rows_total']:.0f}, GC'd "
        f"{moved['scaleout_rebalance_gc_rows_total']:.0f}, catch-up "
        f"events {moved['scaleout_rebalance_replayed_events_total']:.0f}, "
        f"dual writes {moved['scaleout_rebalance_dual_writes_total']:.0f}, "
        f"mover back-offs "
        f"{moved['scaleout_rebalance_shed_backoff_total']:.0f}; engine "
        f"counts over the move (all groups) {counts}")
    log(f"  X.b traffic during the move: {len(move_lat)} lists p50 "
        f"{pct(move_lat, 50):.3f} ms p99 {pct(move_lat, 99):.3f} ms (before "
        f"it: {base_lists} lists in 0.5 s), every list exact; the writer: "
        f"{len(traffic.acked)} acknowledged writes "
        f"({sum(a[0] == 'namespace' for a in traffic.acked)} namespace "
        f"grants as journaled splits, "
        f"{moved['scaleout_split_writes_total']:.0f} splits journaled), "
        f"{traffic.rejected} shed by the overlay's back-pressure and "
        f"retried, 0 failed; every "
        f"acknowledged write read back from its owning "
        f"group(s) after the commit, the last 24 writers' lists exact; "
        f"journal phase {doc['phase']}")

    # -- X.d: the autoscaler shrinks 4 -> 3 under load --
    ctl = AutoscaleController(p, AutoscalePolicy(parse_policy(
        "max_groups=3,hysteresis_ticks=2,cooldown_seconds=0")),
        mode="apply", coordinator_cfg={"pace_seconds": 0.02})
    c0 = x_engine_counts(metrics)
    traffic = XTraffic(p, want, ns_pods, "d", seed + 701,
                       race_ok=(IndexError,)).start()
    time.sleep(0.3)
    paused, running = [], []
    with launches:
        sig = ctl.collect_signals()
        check(ctl.tick(now=0.0) is None, "X.d: a proposal on the first tick "
              "(hysteresis 2)")
        prop = ctl.tick(now=1.0)
        check(prop is not None and (prop.action, prop.target_groups)
              == ("shrink", 3), f"X.d: the proposal was {prop}")
        coord = p._coordinator
        t1 = time.perf_counter()

        def window(sec=2.0) -> float:
            n0, w0 = traffic.lists, time.perf_counter()
            time.sleep(sec)
            return (traffic.lists - n0) / (time.perf_counter() - w0)

        for _ in range(3):
            if coord._done.is_set():
                break
            coord.pause()
            time.sleep(0.1)
            paused.append(window())
            coord.resume()
            if coord._done.is_set():
                break
            running.append(window())
        coord.resume()
        check(coord.wait(900), "X.d: the shrink did not finish")
        shrink_s = time.perf_counter() - t1
        traffic.finish()
    check(coord.error is None, f"X.d: the shrink failed: {coord.error}")
    check(p.map.version == 3 and len(p.groups) == 3,
          "X.d: the planner did not commit the 3-group map")
    traffic.verify()
    st = ctl.status()
    counts = x_delta(x_engine_counts(metrics), c0)
    log(f"phase X.d the autoscaler, apply mode, policy max_groups=3,"
        f"hysteresis_ticks=2,cooldown_seconds=0: signals {sig}; tick 1 "
        f"nothing, tick 2 proposed {prop.action} -> {prop.target_groups} "
        f"({prop.reason}); the transition committed map v3 with 3 groups "
        f"{shrink_s:.2f} s later (status {st}); list goodput paused "
        f"{[round(x, 1) for x in paused]} vs running "
        f"{[round(x, 1) for x in running]} lists/s; "
        f"{len(traffic.acked)} acknowledged writes, none lost "
        f"({traffic.rejected} shed and retried, {len(traffic.failed)} "
        f"split writes caught by the commit, each on all of its groups "
        f"or none after the journal's replay {traffic.failed[:2]}); "
        f"every list exact; "
        f"engine counts {counts}")
    fleet.close(torch)


def x_frontier(torch, dev, here: str, rows: dict, part: dict, ref: dict,
               launches) -> None:
    """X.c: groups re-keyed ``gh{j}/g{j}`` so group#member partitions;
    the planner's frontier exchange (max_rounds 8) closes each subject's
    memberships across the groups."""
    from spicedb_kubeapi_proxy_tpu_torch.scaleout import FrontierConfig
    from spicedb_kubeapi_proxy_tpu_torch.utils.metrics import metrics

    t0 = time.perf_counter()
    rows_c, key_c = x_rekey_groups(rows, part)
    log(f"  X.c: groups re-keyed in {time.perf_counter() - t0:.2f} s")
    fleet, _ = x_headline_fleet(
        torch, dev, here, rows_c, key_c, 2,
        frontier=FrontierConfig(max_rounds=8), tag="X.c")
    del rows_c, key_c
    p = fleet.planner
    p.lookup_resources("pod", "view", "user", ref["subjects"][0])

    def counters():
        h = metrics.hist_snapshot("scaleout_frontier_rounds") or {}
        return {"rounds": h.get("total", 0.0), "exchanges": h.get("n", 0),
                "boundary": metrics.counter(
                    "scaleout_frontier_boundary_tuples_total").value,
                "scatter_bytes": metrics.counter(
                    "scaleout_frontier_wire_bytes_total",
                    direction="scatter").value,
                "gather_bytes": metrics.counter(
                    "scaleout_frontier_wire_bytes_total",
                    direction="gather").value,
                "exhausted": metrics.counter(
                    "scaleout_frontier_exchanges_total",
                    outcome="budget-exhausted").value}

    c0 = counters()
    lat = []
    with launches:
        for u in ref["subjects"]:
            t0 = time.perf_counter()
            mask, ids = p.lookup_resources_mask("pod", "view", "user", u)
            lat.append((time.perf_counter() - t0) * 1e3)
            got = np.sort(np.array([pod_index(ids.string(i))
                                    for i in np.flatnonzero(mask)],
                                   dtype=np.int64))
            check(np.array_equal(got, ref["masks"][u]),
                  f"X.c: {u}'s list through the frontier exchange differs "
                  f"from phase 5's mask ({len(got)} ids, "
                  f"{len(ref['masks'][u])} wanted)")
    d = {k: v - c0[k] for k, v in counters().items()}
    check(d["exhausted"] == 0 and d["exchanges"] >= len(ref["subjects"]),
          f"X.c: frontier counters {d}")
    log(f"phase X.c frontier exchange (groups as gh{{j}}/g{{j}}: "
        f"group#member on one group each; FrontierConfig(max_rounds=8)): "
        f"{len(lat)} lists p50 {pct(lat, 50):.3f} ms p99 "
        f"{pct(lat, 99):.3f} ms, every list equal to phase 5's mask; "
        f"{d['exchanges']} exchanges, {d['rounds']:.0f} rounds "
        f"({d['rounds'] / max(1, d['exchanges']):.2f} an exchange), "
        f"{d['boundary']:.0f} boundary tuples, wire bytes scatter "
        f"{d['scatter_bytes']:.0f} / gather {d['gather_bytes']:.0f}, 0 "
        f"budget-exhausted")
    fleet.close(torch)


def x_proxy(torch, here: str, fleet, pod_ns, ref: dict, launches) -> None:
    """X.e: the port's proxy built by ``Options.complete()`` with
    ``shard_map`` and ``shard_journal_path`` over the four hosts,
    ``GET /api/v1/pods`` over a 100k-item body re-keyed like the pods."""
    from spicedb_kubeapi_proxy_tpu_torch.proxy.inmemkube import InMemoryKube
    from spicedb_kubeapi_proxy_tpu_torch.proxy.options import Options

    head = (b'{"kind": "PodList", "apiVersion": "v1", "metadata": '
            b'{"resourceVersion": "1"}, "items": [')
    items = [json.dumps({"apiVersion": "v1", "kind": "Pod", "metadata": {
        "name": f"p{i}", "namespace": f"ns{pod_ns[i]}"}}).encode()
        for i in range(N_PODS)]
    tail = b"]}"
    body = head + b", ".join(items) + tail
    root = os.path.join(here, "build", "scaleout", "X.e")
    smap = json.dumps({"version": 1, "groups": [
        [f"{h}:{pt}" for h, pt in g] for g in fleet.map.groups],
        "virtual_nodes": X_VNODES})
    cfg = Options(shard_map=smap,
                  shard_journal_path=os.path.join(root, "sj.sqlite"),
                  engine_insecure=True, rule_content=k_rules(here),
                  upstream=KUpstream(InMemoryKube(), body),
                  workflow_database_path=os.path.join(root, "dtx.sqlite"),
                  bind_port=0).complete()
    lt = LoopThread()
    try:
        lt.run(cfg.run())
        import http.client

        conn = http.client.HTTPConnection("127.0.0.1", cfg.server.port,
                                          timeout=300)
        st, ready = k_call(conn, "GET", "/readyz?verbose=1", "x")
        line = next((ln for ln in ready.decode().splitlines()
                     if "sharding:" in ln), None)
        check(st == 200 and line is not None
              and "groups=4 map_version=1" in line,
              f"X.e: /readyz answered {st} without the sharding line")
        k_call(conn, "GET", "/api/v1/pods", ref["subjects"][0])  # warm-up
        wall = []
        for u in ref["subjects"][:X_PROXY_LISTS]:
            with launches:
                t0 = time.perf_counter()
                st, out = k_call(conn, "GET", "/api/v1/pods", u)
                wall.append((time.perf_counter() - t0) * 1e3)
            check(st == 200, f"X.e: {u}'s list answered {st}")
            ids = fleet.planner.lookup_resources("pod", "view", "user", u)
            keep = sorted(pod_index(x) for x in ids)
            check(keep == ref["masks"][u].tolist(),
                  f"X.e: the planner's ids for {u} are not phase 5's")
            exp = head + b",".join(items[i] for i in keep) + tail
            check(out == exp, f"X.e: {u}'s list is not the upstream's "
                  f"{len(keep)} kept items byte for byte")
        conn.close()
        log(f"phase X.e the port's proxy with --shard-map over the 4 hosts "
            f"(Options.complete(): a ShardedEngine of RemoteEngine clients "
            f"and a SplitJournal): {X_PROXY_LISTS} GET /api/v1/pods over "
            f"a {len(body)}-byte {N_PODS}-item body re-keyed like the "
            f"pods, wall p50 {pct(wall, 50):.3f} ms p99 "
            f"{pct(wall, 99):.3f} ms; each list the planner's ids' items "
            f"byte for byte; /readyz: {line.strip()}")
    finally:
        lt.run(cfg.server.stop(grace=1.0))
        lt.run(cfg.workflow.shutdown())
        cfg.engine.close()
        lt.close()


def scaleout_phase(torch, dev, here: str, seed: int, base: tuple,
                   ref: dict) -> dict:
    """Phase X: scale-out on the card (see the module docstring).
    ``base``: phase 3's rows and their ``build_rows`` partition keys;
    ``ref``: the 64 subjects, their phase-5 masks as pod indices, phase
    6's items and verdicts. Returns both kernels' launches over X's
    calls."""
    from spicedb_kubeapi_proxy_tpu_torch.ops import bitprop

    part = base[1]
    launches = Launches(bitprop)
    t_all = time.perf_counter()
    t0 = time.perf_counter()
    log(f"phase X scale-out: device bytes allocated before it "
        f"{torch.cuda.memory_allocated()}")
    rows = x_rows(*base)
    pod_ns = part["pod_ns"]
    log(f"  the re-keyed headline rows ({len(rows['resource_id'])}) in "
        f"{time.perf_counter() - t0:.2f} s")
    fleet, _ = x_headline_fleet(torch, dev, here, rows, part["key"], 2,
                                tag="X.a")
    x_mix(torch, fleet, "X.a (G=2)", ref, pod_ns, launches)
    fleet.close(torch)
    log(f"  X.a took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    x_rebalance(torch, dev, here, seed, launches)
    log(f"  X.b + X.d took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    fleet, _ = x_headline_fleet(torch, dev, here, rows, part["key"], 4,
                                tag="X.a4")
    x_mix(torch, fleet, "X.a (G=4)", ref, pod_ns, launches)
    log(f"  X.a at G=4 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    x_proxy(torch, here, fleet, pod_ns, ref, launches)
    fleet.close(torch)
    log(f"  X.e took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    x_frontier(torch, dev, here, rows, part, ref, launches)
    del rows
    log(f"  X.c took {time.perf_counter() - t0:.1f} s")
    log(f"  scale-out path launches (X.a-X.e): {launches.n}")
    for kname, n in launches.n.items():
        check(n > 0, f"{kname} was not launched on the scale-out path")
    log(f"phase X took {time.perf_counter() - t_all:.1f} s; device bytes "
        f"allocated after it {torch.cuda.memory_allocated()}")
    return launches.n


F_HEARTBEAT = 0.5  # --mirror-heartbeat-seconds of phase F's peers
F_WRITES = 100  # F.a's sync-replicated writes, one after another


def launch_line(text: str) -> dict:
    """The kernel launches an engine-host CLI logs at its shutdown."""
    out = {}
    key = "kernel launches in this process:"
    for ln in text.splitlines():
        if key in ln:
            for part in ln.split(key, 1)[1].split():
                k, _, v = part.partition("=")
                out[k] = int(v)
    return out


class Peer:
    """One ``--peers`` engine-host CLI of phase F (no ``--device``: the
    card), logging to a file of its own."""

    def __init__(self, here: str, pid: int, ports: list, data_dir: str,
                 boot: str, log_path: str):
        self.here, self.id, self.ports = here, pid, ports
        self.port = ports[pid]
        self.data_dir, self.boot, self.log_path = data_dir, boot, log_path
        self.p = None

    def spawn(self) -> float:
        with open(self.log_path, "a") as logf:
            t0 = time.perf_counter()
            self.p = subprocess.Popen(
                [sys.executable, "-m",
                 "spicedb_kubeapi_proxy_tpu_torch.engine.remote",
                 "--engine-insecure", "--bind-port", str(self.port),
                 "--bootstrap", self.boot, "--data-dir", self.data_dir,
                 "--peers", ",".join(f"127.0.0.1:{p}" for p in self.ports),
                 "--peer-id", str(self.id), "--wal-fsync", "always",
                 "--mirror-heartbeat-seconds", str(F_HEARTBEAT),
                 "--failover-boot-grace", "60",
                 "--min-sync-replicas", "1", "--replication-timeout", "20"],
                cwd=self.here, stdout=logf, stderr=subprocess.STDOUT)
        return t0

    def log(self) -> str:
        with open(self.log_path, errors="replace") as fh:
            return fh.read()

    def tail(self) -> str:
        return self.log()[-3000:]

    def alive(self) -> bool:
        return self.p is not None and self.p.poll() is None

    def state(self) -> Optional[dict]:
        from spicedb_kubeapi_proxy_tpu_torch.engine import remote

        c = remote.RemoteEngine("127.0.0.1", self.port, timeout=2.0,
                                connect_timeout=1.0, retries=0)
        try:
            return c.failover_state()
        except Exception:  # noqa: BLE001 - not up (yet), or dead
            return None
        finally:
            c.close()

    def kill(self) -> None:
        if self.alive():
            self.p.kill()
        if self.p is not None:
            self.p.wait(60)


def wait_for(what: str, fn, budget: float, peers=()):
    """Poll ``fn`` every 50 ms until it returns a truthy value; fail the
    run after ``budget`` seconds or when a peer process dies."""
    t0 = time.perf_counter()
    while True:
        got = fn()
        if got:
            return got
        for p in peers:
            check(p.alive(), f"F: peer {p.id} exited while waiting for "
                  f"{what} ({p.p.returncode}):\n{p.tail()}")
        check(time.perf_counter() - t0 < budget,
              f"F: no {what} within {budget:.0f} s")
        time.sleep(0.05)


F_ORACLE_USERS = 2  # F's users held against OracleEvaluator itself


def f_reference(here: str, schema: str, users: list, now: float) -> tuple:
    """(revision, pod#view ids of ``users`` at ``now``, seconds) over
    phase P's data dir, the state both peers recover: a plain store
    recovered from it, the columnar reference (view_masks) for every
    user, itself equal to OracleEvaluator's ids on the first
    F_ORACLE_USERS (subset_oracle; a lookup takes ~2 s a user at 10M)."""
    from spicedb_kubeapi_proxy_tpu_torch.engine.evaluator import \
        OracleEvaluator
    from spicedb_kubeapi_proxy_tpu_torch.engine.store import Snapshot, Store
    from spicedb_kubeapi_proxy_tpu_torch.models import parse_schema
    from spicedb_kubeapi_proxy_tpu_torch.persistence.recovery import recover

    st = Store()
    recover(st, os.path.join(here, "build", "persist", "data"))
    t_pod = st.types.lookup("pod")
    pods = st.objects[t_pod]
    masks = view_masks(st, users, now, len(pods))
    got = {u: {pods.string(int(i)) for i in np.flatnonzero(m)}
           for u, m in masks.items()}
    t0 = time.perf_counter()
    o = subset_oracle(st.snapshot(), parse_schema(schema), OracleEvaluator,
                      Snapshot, users[:F_ORACLE_USERS], now)
    want = {u: o.lookup_resources("pod", "view", "user", u)
            for u in users[:F_ORACLE_USERS]}
    for u, ids in want.items():
        check(got[u] == ids, f"F: the columnar reference of {u} differs "
              f"from OracleEvaluator ({len(got[u])} vs {len(ids)} pods)")
    return st.revision, got, time.perf_counter() - t0


def failover_phase(torch, here: str, schema: str, users: list,
                   items: list, r_write: dict) -> dict:
    """Phase F: the ``--peers`` failover set of two engine-host CLIs on
    the one card (see the module docstring). Returns both kernels'
    launches in the set's surviving leader."""
    import signal
    import socket

    from spicedb_kubeapi_proxy_tpu_torch.engine import CheckItem, remote
    from spicedb_kubeapi_proxy_tpu_torch.engine.store import (
        StoreError,
        WriteOp,
    )
    from spicedb_kubeapi_proxy_tpu_torch.models.tuples import Relationship
    from spicedb_kubeapi_proxy_tpu_torch.utils.resilience import \
        DependencyUnavailable

    root = os.path.join(here, "build", "persist")
    boot = os.path.join(root, "f_bootstrap.yaml")
    with open(boot, "w") as fh:
        fh.write("schema: |\n" + "".join(
            f"  {ln}\n" for ln in schema.strip("\n").splitlines()))
    ports = []
    for _ in range(2):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        ports.append(s.getsockname()[1])
        s.close()
    peers = []
    for i in range(2):
        d = os.path.join(root, f"f_peer{i}")
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(os.path.join(root, "data"), d)
        lp = os.path.join(root, f"f_peer{i}.log")
        if os.path.exists(lp):
            os.unlink(lp)
        peers.append(Peer(here, i, ports, d, boot, lp))
    apps0 = smi_apps()
    fe = None
    try:
        # -- F.a: boot to election, then the steady set --
        t0 = min(p.spawn() for p in peers)
        seen: dict = {}  # the election, watched while the oracle builds

        def leader():
            for p in peers:
                st = p.state()
                if st and st["role"] == "leader":
                    return p, st
            return None

        def watch():
            while "leader" not in seen and time.perf_counter() - t0 < 240 \
                    and all(p.alive() for p in peers):
                got = leader()
                if got:
                    seen["leader"] = (time.perf_counter() - t0, got)
                time.sleep(0.05)

        wt = threading.Thread(target=watch, daemon=True)
        wt.start()
        now = time.time()
        t1 = time.perf_counter()
        p_rev, want, oracle_s = f_reference(here, schema, users, now)
        ref_s = time.perf_counter() - t1
        wt.join(300)
        check("leader" in seen, "F.a: no election within 240 s:\n"
              + "\n".join(p.tail() for p in peers))
        elect_s, (lead, st) = seen["leader"]
        fol = peers[1 - lead.id]
        fst = wait_for("a follower", lambda: (
            lambda s: s if s and s["role"] == "follower" and s["lag"] == 0
            and s["revision"] == st["revision"] else None)(fol.state()),
            120, peers)
        check(st["revision"] == p_rev == fst["revision"],
              f"F.a: revisions leader {st['revision']}, follower "
              f"{fst['revision']}, P's data dir {p_rev}")
        for p in peers:
            check("engine on cuda" in p.log(),
                  f"F.a: peer {p.id} is not on the card:\n{p.tail()}")
        fe = remote.FailoverEngine(
            [("127.0.0.1", p) for p in ports], timeout=120.0,
            connect_timeout=2.0, retries=0, probe_timeout=2.0,
            resolve_deadline=60.0)
        t1 = time.perf_counter()
        m, ids = fe.lookup_resources_mask("pod", "view", "user", users[0],
                                          now=now)
        first_s = time.perf_counter() - t1
        apps_a = smi_apps()

        def exact(label: str) -> tuple:
            # every query at the oracle's clock: phase 9's grants that
            # expire 600 s after it lapse around this phase
            lat = []
            for u in users:
                t = time.perf_counter()
                m, ids = fe.lookup_resources_mask("pod", "view", "user", u,
                                                  now=now)
                lat.append((time.perf_counter() - t) * 1e3)
                got = {ids.string(int(i)) for i in np.flatnonzero(m)}
                check(got == want[u], f"{label}: {u}'s list differs from "
                      f"the reference ({len(got)} vs {len(want[u])} pods)")
            t = time.perf_counter()
            verdicts = fe.check_bulk(items, now=now)
            bulk_s = time.perf_counter() - t
            exp = [it.resource_id in want[it.subject_id] for it in items]
            check(list(verdicts) == exp, f"{label}: "
                  f"{sum(a != b for a, b in zip(verdicts, exp))} bulk "
                  f"verdicts differ from the reference")
            return lat, len(items) / bulk_s, sum(exp)

        lat_a, cps_a, n_allowed = exact("F.a")

        def fw(i):
            return WriteOp("touch", Relationship(
                "pod", f"ns/f{i}", "viewer", "user", "fw"))

        w_ms = []
        for i in range(F_WRITES):
            t = time.perf_counter()
            fe.write_relationships([fw(i)])
            w_ms.append((time.perf_counter() - t) * 1e3)
        acked = list(range(F_WRITES))
        fst = wait_for("the follower's revision", lambda: (
            lambda s: s if s and s["revision"] == lead.state()["revision"]
            else None)(fol.state()), 30, peers)
        log(f"phase F.a a --peers set of two engine-host CLIs on the card "
            f"(no --device; --wal-fsync always, heartbeat {F_HEARTBEAT} s, "
            f"--min-sync-replicas 1), each on a copy of phase P's data dir "
            f"(revision {p_rev}): spawn -> peer {lead.id} elected leader "
            f"(term {st['term']}) {elect_s:.2f} s, follower at lag 0; the "
            f"leader's first list (its 10M compile) {first_s:.2f} s; "
            f"{len(users)} lists through the port's FailoverEngine p50 "
            f"{pct(lat_a, 50):.3f} ms p99 {pct(lat_a, 99):.3f} ms, the 64 "
            f"x 1,024 bulk check {cps_a:,.0f} checks/s ({n_allowed} "
            f"allowed), every list and verdict equal at one clock to the "
            f"columnar reference over P's recovered store, itself equal to "
            f"OracleEvaluator on {F_ORACLE_USERS} users ({ref_s:.1f} s, "
            f"{oracle_s:.1f} s of it the oracles, while the peers booted); "
            f"{F_WRITES} "
            f"sync-replicated writes (the ack waits for the follower's "
            f"fsynced journal) p50 {pct(w_ms, 50):.3f} ms p99 "
            f"{pct(w_ms, 99):.3f} ms, beside R.c's unreplicated wire write "
            f"p50 {r_write.get('p50', float('nan')):.3f} ms p99 "
            f"{r_write.get('p99', float('nan')):.3f} ms; follower at "
            f"revision {fst['revision']}")
        log(f"  device memory by compute app (pid, used): before the set "
            f"{apps0.replace(chr(10), '; ')}; leader serving, follower "
            f"idle: {apps_a.replace(chr(10), '; ')} (peers' pids "
            f"{[p.p.pid for p in peers]}, this process {os.getpid()})")

        # -- F.b: SIGKILL the leader under a stream of acknowledged writes
        stop = threading.Event()
        fails: list = []
        base = F_WRITES

        def writer():
            i = base
            while not stop.is_set():
                try:
                    fe.write_relationships([fw(i)])
                    acked.append(i)
                except (StoreError, DependencyUnavailable, OSError) as ex:
                    fails.append((time.perf_counter(), type(ex).__name__,
                                  str(ex)[:200]))
                i += 1
                time.sleep(0.02)

        wt = threading.Thread(target=writer, daemon=True)
        wt.start()
        wait_for("acked writes before the kill",
                 lambda: len(acked) >= F_WRITES + 20, 60, peers)
        n_before = len(acked)
        t_kill = time.perf_counter()
        lead.kill()
        new = wait_for("a promotion", lambda: (
            lambda s: s if s and s["role"] == "leader" else None)(
                fol.state()), 120, [fol])
        promote_s = time.perf_counter() - t_kill
        probe = remote.FailoverEngine(
            [("127.0.0.1", p) for p in ports], timeout=120.0,
            connect_timeout=1.0, retries=0, probe_timeout=1.0,
            resolve_deadline=5.0)
        try:
            def first_list():
                try:
                    return probe.lookup_resources_mask(
                        "pod", "view", "user", users[0], now=now)
                except (DependencyUnavailable, OSError):
                    return None
            wait_for("the new leader's first list", first_list, 240, [fol])
        finally:
            probe.close()
        served_s = time.perf_counter() - t_kill
        wait_for("writes failing closed while alone", lambda: any(
            t > t_kill + promote_s and "min-sync-replicas" in msg
            for t, _, msg in fails), 60, [fol])
        stop.set()
        wt.join(60)
        after_kill = acked[n_before:]
        closed = [msg for t, _, msg in fails
                  if t > t_kill + promote_s and "min-sync-replicas" in msg]
        verdicts = fe.check_bulk([CheckItem("pod", f"ns/f{i}", "view",
                                             "user", "fw") for i in acked])
        lost = [i for i, ok in zip(acked, verdicts) if not ok]
        check(not lost, f"F.b: acknowledged writes lost in the failover: "
              f"{lost[:10]}")
        lat_b, cps_b, _ = exact("F.b")
        apps_b = smi_apps()
        log(f"phase F.b SIGKILL of leader peer {lead.id} after "
            f"{n_before} acknowledged writes, mid-stream: peer {fol.id} "
            f"promoted (term {new['term']}) {promote_s:.2f} s after the "
            f"kill, its first list served {served_s:.2f} s after it (the "
            f"re-resolve and its 10M compile); {len(after_kill)} writes "
            f"acknowledged after the kill, {len(fails)} failed closed "
            f"({sorted(set(n for _, n, _ in fails))}; alone, "
            f"--min-sync-replicas 1 refuses every write: "
            f"{closed[0][:90]!r}); all {len(acked)} acknowledged writes "
            f"read back from the new leader; {len(users)} lists p50 "
            f"{pct(lat_b, 50):.3f} ms and the bulk check "
            f"{cps_b:,.0f} checks/s, every answer equal to the reference")
        log(f"  device memory by compute app after the promotion: "
            f"{apps_b.replace(chr(10), '; ')}")

        # -- F.c: the killed peer rejoins; then an empty data dir --
        t1 = lead.spawn()
        rej = wait_for("the rejoin", lambda: (
            lambda s, l: s if s and l and s["role"] == "follower"
            and s["lag"] == 0 and s["revision"] == l["revision"]
            and s["term"] == l["term"] else None)(lead.state(),
                                                   fol.state()),
            240, [lead, fol])
        rejoin_s = time.perf_counter() - t1
        form = [ln.split("catch-up:", 1)[1].strip()
                for ln in lead.log().splitlines() if "catch-up:" in ln]
        t = time.perf_counter()
        fe.write_relationships([fw(10_000)])
        w_again = (time.perf_counter() - t) * 1e3
        acked.append(10_000)
        lead.kill()  # its data dir is wiped next: no checkpoint needed
        shutil.rmtree(lead.data_dir)
        t1 = lead.spawn()
        full = wait_for("the full state transfer", lambda: (
            lambda s, l: s if s and l and s["role"] == "follower"
            and s["lag"] == 0 and s["revision"] == l["revision"]
            else None)(lead.state(), fol.state()), 300, [lead, fol])
        full_s = time.perf_counter() - t1
        sent = [ln.split("mirror catch-up", 1)[1].strip()
                for ln in fol.log().splitlines() if "mirror catch-up" in ln]
        got = [ln.split("catch-up", 1)[1].strip(" :")
               for ln in lead.log().splitlines()
               if "catch-up frame received" in ln
               or "installed leader state" in ln]
        check(sent and "full state" in sent[-1],
              f"F.c: the leader sent no full state:\n{fol.tail()}")
        verdicts = fe.check_bulk([CheckItem("pod", f"ns/f{i}", "view",
                                             "user", "fw") for i in acked])
        check(all(verdicts), "F.c: an acknowledged write is missing")
        t = time.perf_counter()
        fe.write_relationships([fw(10_001)])
        w_full = (time.perf_counter() - t) * 1e3
        log(f"phase F.c the killed peer restarted on its data dir: a "
            f"follower again at the leader's term and revision "
            f"{rej['revision']} {rejoin_s:.2f} s after its spawn "
            f"({form[-1] if form else 'already current'}); a write acked "
            f"again ({w_again:.3f} ms); then restarted on an EMPTY data "
            f"dir: caught up {full_s:.2f} s after its spawn through a full "
            f"state transfer (leader: {sent[-1]}; follower: "
            f"{'; '.join(got[-2:])}); the next write {w_full:.3f} ms; "
            f"every acknowledged write still reads back")
        apps_c = smi_apps()
        log(f"  device memory by compute app at the end: "
            f"{apps_c.replace(chr(10), '; ')}")
        fe.close()
        fe = None
        # SIGTERM: each host drains, logs its launches, then checkpoints
        # 10M rows (~17 s); these dirs are thrown away, so once both
        # lines are out the processes are killed instead
        n_lines = [p.log().count("kernel launches in this process") for p
                   in peers]
        for p in peers:
            p.p.send_signal(signal.SIGTERM)
        wait_for("the hosts' launch lines", lambda: all(
            p.log().count("kernel launches in this process") > k
            for p, k in zip(peers, n_lines)), 120)
        n = launch_line(fol.log())
        log(f"  SIGTERM -> both drained and logged their kernel launches "
            f"(then killed: no final checkpoint of dirs thrown away); the "
            f"new leader's: {n} (the killed leader's were lost with it; "
            f"the empty-dir follower's: {launch_line(lead.log())})")
        return {"bit_or_matmul": n.get("bit_or_matmul", 0),
                "dense_or_matmul": n.get("dense_or_matmul", 0)}
    finally:
        if fe is not None:
            fe.close()
        for p in peers:
            if p.alive():
                p.kill()


def rsa_key(seed: int, bits: int = 2048) -> tuple:
    """A deterministic RSA key (n, e, d) from ``seed``: two probable
    primes by Miller-Rabin over ``random.Random(seed)``. A test issuer's
    key, made here so the script needs no crypto package."""
    import random

    rng = random.Random(seed)
    small = [p for p in range(3, 2000, 2)
             if all(p % q for q in range(3, int(p ** 0.5) + 1, 2))]

    def prime(nbits):
        while True:
            c = rng.getrandbits(nbits) | (1 << (nbits - 1)) | 1
            if any(c % q == 0 for q in small):
                continue
            d, r = c - 1, 0
            while d % 2 == 0:
                d, r = d // 2, r + 1
            for _ in range(24):
                x = pow(rng.randrange(2, c - 1), d, c)
                if x in (1, c - 1):
                    continue
                for _ in range(r - 1):
                    x = pow(x, 2, c)
                    if x == c - 1:
                        break
                else:
                    break
            else:
                return c

    e = 65537
    while True:
        p, q = prime(bits // 2), prime(bits // 2)
        phi = (p - 1) * (q - 1)
        if p != q and phi % e:
            return p * q, e, pow(e, -1, phi)


class Issuer:
    """An OIDC issuer on loopback: the discovery document and a JWKS of
    one RS256 key (kid ``k1``), served over HTTP on a thread of its own;
    ``token(claims, kid)`` signs a JWT with the key."""

    def __init__(self, seed: int):
        from http.server import BaseHTTPRequestHandler, HTTPServer

        from spicedb_kubeapi_proxy_tpu_torch.proxy import jose

        self.jose = jose
        self.n, self.e, self.d = rsa_key(seed)
        self.fetches = 0
        me = self

        def b64(i: int) -> str:
            return jose.b64url_encode(i.to_bytes((i.bit_length() + 7) // 8,
                                                 "big"))

        jwks = json.dumps({"keys": [{"kty": "RSA", "kid": "k1",
                                     "alg": "RS256", "use": "sig",
                                     "n": b64(self.n), "e": b64(self.e)}]})

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                if self.path == "/.well-known/openid-configuration":
                    body = json.dumps({"issuer": me.url,
                                       "jwks_uri": me.url + "/keys"})
                elif self.path == "/keys":
                    me.fetches += 1
                    body = jwks
                else:
                    self.send_error(404)
                    return
                raw = body.encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(raw)))
                self.end_headers()
                self.wfile.write(raw)

            def log_message(self, *a):
                pass

        self.srv = HTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.srv.server_port}"
        self.thread = threading.Thread(target=self.srv.serve_forever,
                                       daemon=True)
        self.thread.start()

    def token(self, claims: dict, kid: str = "k1") -> str:
        jose = self.jose
        si = (jose.b64url_encode(json.dumps(
            {"alg": "RS256", "typ": "JWT", "kid": kid}).encode()) + "."
            + jose.b64url_encode(json.dumps(claims).encode()))
        sig = jose.rsa_pkcs1v15_sign(self.n, self.d, si.encode(), "sha256")
        return si + "." + jose.b64url_encode(sig)

    def close(self) -> None:
        self.srv.shutdown()
        self.srv.server_close()
        self.thread.join(10)


OIDC_CLIENT = "kube-proxy"


def oidc_phase(torch, e, here: str, subjects: list, k_a: dict,
               seed: int) -> dict:
    """Phase K.g: the port's proxy authenticating bearer JWTs against a
    loopback OIDC issuer (see the module docstring). Returns both
    kernels' launches over its requests."""
    import http.client

    from spicedb_kubeapi_proxy_tpu_torch.ops import bitprop
    from spicedb_kubeapi_proxy_tpu_torch.proxy.inmemkube import InMemoryKube
    from spicedb_kubeapi_proxy_tpu_torch.proxy.oidc import OIDCAuthenticator
    from spicedb_kubeapi_proxy_tpu_torch.proxy.options import Options

    t0 = time.perf_counter()
    iss = Issuer(seed)
    key_s = time.perf_counter() - t0
    launches = Launches(bitprop)
    stack = None
    try:
        opts = Options(rule_content=k_rules(here), upstream=object(),
                       device="cuda", oidc_issuer_url=iss.url,
                       oidc_client_id=OIDC_CLIENT, oidc_username_prefix="-")
        opts.validate()  # the --oidc-* options the proxy used to refuse
        auth = OIDCAuthenticator(
            issuer_url=opts.oidc_issuer_url, client_id=opts.oidc_client_id,
            username_prefix=opts.oidc_username_prefix)
        n_type = e.compiled().type_sizes["pod"]
        n_list = min(n_type - 2, N_PODS)
        body, head, item_b, tail = pod_list_body(n_list)
        stack = KStack(e, k_rules(here), KUpstream(InMemoryKube(), body),
                       token_authenticator=auth)
        pods = e._objects_by_name()["pod"]
        want = uncaveated_view_masks(e.store, subjects, time.time(), n_type)
        exp_at = time.time() + 3600
        toks = {u: iss.token({"iss": iss.url, "aud": OIDC_CLIENT, "sub": u,
                              "exp": exp_at}) for u in subjects}
        conn = http.client.HTTPConnection("127.0.0.1", stack.port,
                                          timeout=120)

        def get(tok):
            conn.request("GET", "/api/v1/pods",
                         headers={"Authorization": f"Bearer {tok}"})
            r = conn.getresponse()
            return r.status, r.read()

        st, _ = get(toks[subjects[0]])  # warm-up: the JWKS fetch
        check(st == 200, f"K.g: the first bearer list answered {st}")
        wall = []
        for u in subjects:
            with launches:
                t1 = time.perf_counter()
                st, out = get(toks[u])
                wall.append((time.perf_counter() - t1) * 1e3)
            check(st == 200, f"K.g: {u}'s bearer list answered {st}")
            keep = kept_from(want[u], pods, n_list)
            exp = (head + b",".join(item_b[i] for i in keep) + tail
                   if len(keep) < n_list else body)
            check(out == exp, f"K.g: {u}'s list is not the upstream's "
                  f"{len(keep)} kept items byte for byte")
        verify = []
        for u in subjects:
            t1 = time.perf_counter()
            who = auth.authenticate_token(toks[u])
            verify.append((time.perf_counter() - t1) * 1e3)
            check(who is not None and who.name == u,
                  f"K.g: {u}'s token maps to {who}")
        bad = {"expired": iss.token({"iss": iss.url, "aud": OIDC_CLIENT,
                                     "sub": subjects[0],
                                     "exp": time.time() - 600}),
               "unknown kid": iss.token({"iss": iss.url, "aud": OIDC_CLIENT,
                                         "sub": subjects[0],
                                         "exp": exp_at}, kid="k9"),
               "wrong audience": iss.token({"iss": iss.url, "aud": "other",
                                            "sub": subjects[0],
                                            "exp": exp_at})}
        codes = {k: get(t)[0] for k, t in bad.items()}
        check(all(c == 401 for c in codes.values()),
              f"K.g: rejected tokens answered {codes}")
        conn.close()
        log(f"phase K.g GET /api/v1/pods through the port's proxy with "
            f"--oidc-issuer-url at a loopback issuer (discovery + JWKS "
            f"over HTTP, one 2048-bit RS256 key made from the seed in "
            f"{key_s:.2f} s, {iss.fetches} JWKS fetch), a bearer JWT a "
            f"user and no X-Remote-User: {len(subjects)} users, wall p50 "
            f"{pct(wall, 50):.3f} ms p99 {pct(wall, 99):.3f} ms beside "
            f"K.a's {k_a['p50']:.3f} / {k_a['p99']:.3f} ms; the token's "
            f"verification alone (pure-Python RS256 against the cached "
            f"JWKS, claims, identity) p50 {pct(verify, 50):.3f} ms p99 "
            f"{pct(verify, 99):.3f} ms; every list the upstream's kept "
            f"items byte for byte; {codes} (401 each)")
        return dict(launches.n)
    finally:
        if stack is not None:
            stack.close()
        iss.close()


def demo_phase(torch) -> dict:
    """The demo's stack (proxy/demo.py ``build``) on the card, and its
    two users' lists: alice sees dev, carol prod."""
    import asyncio

    from spicedb_kubeapi_proxy_tpu_torch.ops import bitprop
    from spicedb_kubeapi_proxy_tpu_torch.proxy import demo
    from spicedb_kubeapi_proxy_tpu_torch.proxy.inmemory import InMemoryClient

    t0 = time.perf_counter()
    cfg = demo.build(port=0, device="cuda")
    build_s = time.perf_counter() - t0
    check(cfg.engine.device.type == "cuda", "demo: the engine is not on "
          "the card")
    launches = Launches(bitprop)

    async def go():
        await cfg.workflow.resume_pending()
        seen, ms = {}, []
        for user in ("alice", "carol"):
            with launches:
                t1 = time.perf_counter()
                r = await InMemoryClient(cfg.server.handle, user=user).get(
                    "/api/v1/namespaces")
                ms.append((time.perf_counter() - t1) * 1e3)
            check(r.status == 200, f"demo: {user}'s list answered "
                  f"{r.status}")
            seen[user] = [i["metadata"]["name"]
                          for i in json.loads(r.body)["items"]]
        await cfg.workflow.shutdown()
        return seen, ms

    try:
        seen, ms = asyncio.run(go())
    finally:
        cfg.engine.close_compaction()
    check(seen == {"alice": ["dev"], "carol": ["prod"]},
          f"demo: the lists were {seen}")
    log(f"phase D the demo (proxy/demo.py) built on the card in "
        f"{build_s:.2f} s (its graph compiled and first queries run): "
        f"alice sees {seen['alice']}, carol {seen['carol']} "
        f"({ms[0]:.3f} / {ms[1]:.3f} ms); launches {launches.n}")
    return dict(launches.n)


# -- phase M's cell: the migrations at an eighth of the headline's depth ------

M_DEPTH = 8  # phase M's store: the headline's rows over this, same widths


def migration_cell(torch, e, here: str, subjects: list, items: list,
                   bulk_users: list, r_dir: str, r_users: list,
                   r_want: dict, n_rels: int, seed: int) -> dict:
    """Phase M at a reduced depth: M.a and M.b run on a store of their own
    with the headline's widths and an eighth of its relationships (each
    freeze's probe builds two OracleEvaluators over the whole store; at
    10M the two freezes took 137-183 s of the run), M.c on R.e's 10M data
    dir as before. Then M.d: the headline engine takes M.b's final schema
    (the workflow definitions and the probation caveat phase K's dual
    writes and references need) in one migration whose parity probe is
    off, since M.a and M.b ran it. Returns the launches of M.a and M.b."""
    from spicedb_kubeapi_proxy_tpu_torch.engine import Engine
    from spicedb_kubeapi_proxy_tpu_torch.models import parse_schema
    from spicedb_kubeapi_proxy_tpu_torch.models.bootstrap import \
        WORKFLOW_SCHEMA

    t0 = time.perf_counter()
    rows = build_rows(N_PODS, N_USERS, N_NS, N_GROUPS, n_rels // M_DEPTH,
                      seed)
    n = len(rows["resource_id"])
    em = Engine(schema=parse_schema(BENCH_SCHEMA), device=e.device)
    em.bulk_load(rows)
    del rows
    em.compiled()
    build_s = time.perf_counter() - t0
    lat = []
    for u in subjects:
        t1 = time.perf_counter()
        em.lookup_resources_mask("pod", "view", "user", u)
        lat.append((time.perf_counter() - t1) * 1e3)
    log(f"phase M store: {n} relationships (the headline's widths, an "
        f"eighth of its relationships), built and compiled in "
        f"{build_s:.2f} s; {len(subjects)} lists p50 {pct(lat, 50):.3f} ms "
        f"(M's yardstick below)")
    launches = migration_phase(torch, em, here, subjects, items, bulk_users,
                               r_dir, r_users, r_want, pct(lat, 50), seed)
    final = em.schema
    del em
    gc.collect()
    torch.cuda.empty_cache()

    # -- M.d: the headline engine takes M's final schema, for phase K --
    t0 = time.perf_counter()
    st = e.begin_schema_migration(MIG_B_SCHEMA + "\n" + WORKFLOW_SCHEMA,
                                  wait=True, parity_samples=0)
    check(st["phase"] == "done", f"M.d: the headline migration ended {st}")
    check(e.schema == final, "M.d: the headline engine's schema is not "
          "M.b's final one")
    log(f"phase M.d the headline engine migrated to M.b's target in one "
        f"step ({st['classification']}, {st['backfilled']} rows "
        f"backfilled, time_to_cut_ms {st['time_to_cut_ms']:.1f}, "
        f"freeze_ms {st['freeze_ms']:.1f}) in "
        f"{time.perf_counter() - t0:.2f} s: the schema phase K needs; its "
        f"parity probe is off (M.a and M.b ran it above)")
    return launches


# -- phase C: open-loop load and the chaos campaign on the card ---------------

C_DURATION = 4.0  # the shortest sweep point's schedule, seconds
# each point's schedule is stretched until it holds this many arrivals
# (the 0.5x point: as long as the 1x one, so half of them): the same
# seeded trace at every point, so the same mix of classes
C_POINT_ARRIVALS = 400
# the fewest completions a class's p99 and p99.9 are printed over
C_MIN_P99, C_MIN_P999 = 100, 1_000
C_SPLIT_PODS = 6  # the lookup_subjects whose time is divided
C_MULTIPLIERS = (0.5, 1.0, 2.0, 3.5)
C_TABLE_ROWS = 5_000
C_WRITERS = 64  # the subjects the sweep's writes grant pods to
C_PROBE_S = 1.5  # the closed-loop capacity probe
# bench.py's SLOs for the mix (bench.py:3530-3533), seconds
C_SLO = {"check": 0.05, "wildcard-check": 0.05, "bulk-check": 0.15,
         "list-prefilter": 0.15, "table-filter": 0.25,
         "lookup-subjects": 0.5, "write": 0.25, "watch-open": 0.5}
# the stock brownout schedule's digest at seed 0, pinned by the JAX
# package's test_chaos_campaign.py
CHAOS_SEED0_DIGEST = \
    "0f050b3ea4cbcfb8c308607124ed4f16f523960e42d3686a0130f30de51042ad"
CHAOS_EPISODES = ("baseline", "brownout", "crash", "elastic", "migration")


def loadgen_phase(torch, e, subjects: list, seed: int) -> dict:
    """Phase C.a (see the module docstring): the port's open-loop sweep
    over the headline engine. Returns both kernels' launches over the
    sweep alone."""
    import types

    from spicedb_kubeapi_proxy_tpu_torch.authz import filterer
    from spicedb_kubeapi_proxy_tpu_torch.authz.lookups import AllowedSet
    from spicedb_kubeapi_proxy_tpu_torch.engine import CheckItem
    from spicedb_kubeapi_proxy_tpu_torch.engine.engine import \
        subject_candidates
    from spicedb_kubeapi_proxy_tpu_torch.engine.store import WriteOp
    from spicedb_kubeapi_proxy_tpu_torch.loadgen import (
        build_schedule,
        run_sweep,
        trace_shaped_config,
    )
    from spicedb_kubeapi_proxy_tpu_torch.loadgen import schedule as ls
    from spicedb_kubeapi_proxy_tpu_torch.models.tuples import Relationship
    from spicedb_kubeapi_proxy_tpu_torch.ops import bitprop
    from spicedb_kubeapi_proxy_tpu_torch.proxy.requestinfo import \
        parse_request_info
    from spicedb_kubeapi_proxy_tpu_torch.rules.input import (
        ResolveInput,
        UserInfo,
    )
    from spicedb_kubeapi_proxy_tpu_torch.utils.metrics import metrics

    rng = np.random.default_rng(seed + 150)
    table = json.dumps({
        "kind": "Table", "apiVersion": "meta.k8s.io/v1",
        "columnDefinitions": [{"name": "Name", "type": "string"}],
        "rows": [{"cells": [f"p{i}"], "object": {"metadata": {
            "name": f"p{i}", "namespace": "ns"}}}
            for i in range(C_TABLE_ROWS)]}).encode()
    t_info = parse_request_info("GET", "/api/v1/namespaces/ns/pods", {})
    writers = [f"u{u}" for u in rng.choice(N_USERS, C_WRITERS,
                                           replace=False)]
    wlock = threading.Lock()
    written: set = set()
    touched: set = set()
    table_kept: list = []

    def user(a) -> str:
        return f"u{a.key % N_USERS}"

    def pod(a, j: int = 0) -> str:
        return f"ns/p{(a.key * 7 + a.ns_key * 131 + j) % N_PODS}"

    def op_check(a):
        e.check_bulk([CheckItem("pod", pod(a), "view", "user", user(a))])

    def op_bulk(a):
        # 16 subjects x 4 pods, grouped by subject as phase 6's items: the
        # pull hop at B=16
        e.check_bulk([CheckItem("pod", pod(a, 97 * j + i), "view", "user",
                                f"u{(a.key + 613 * j) % N_USERS}")
                      for j in range(16) for i in range(4)])

    def op_list(a):
        e.lookup_resources_mask("pod", "view", "user", user(a))

    def op_table(a):
        allowed = AllowedSet()
        for pid in e.lookup_resources("pod", "view", "user", user(a)):
            ns, _, name = pid.partition("/")
            allowed.add(ns, name)
        st, out = filterer.filter_body(table, allowed, ResolveInput.create(
            t_info, UserInfo(name=user(a))))
        check(st == 200, f"C.a: the Table filter answered {st}")
        table_kept.append(len(json.loads(out)["rows"]))

    def op_subjects(a):
        e.lookup_subjects("pod", pod(a), "view", "user")

    def op_write(a):
        with wlock:
            k = a.key
            while True:
                pair = (f"ns/p{k % N_PODS}",
                        writers[(k // 7 + a.ns_key) % C_WRITERS])
                if pair not in written:
                    break
                k += 1
            written.add(pair)
            touched.add(pair[1])
        e.write_relationships([WriteOp("touch", Relationship(
            "pod", pair[0], "viewer", "user", pair[1]))])

    ops = {ls.OP_CHECK: op_check, ls.OP_BULK_CHECK: op_bulk,
           ls.OP_LIST_PREFILTER: op_list, ls.OP_TABLE: op_table,
           ls.OP_LOOKUP_SUBJECTS: op_subjects, ls.OP_WRITE: op_write,
           # as bench.py's probe maps it
           ls.OP_WATCH_OPEN: op_check,
           # the headline schema has no user:* grant to probe
           ls.OP_WILDCARD: op_check}
    # ops the driver abandoned at a point's drain deadline run on: the
    # answers are read only once none is left
    busy = threading.Condition()
    inflight = [0]

    def tracked(fn):
        def run(a):
            with busy:
                inflight[0] += 1
            try:
                fn(a)
            finally:
                with busy:
                    inflight[0] -= 1
                    busy.notify_all()
        return run

    ops = {name: tracked(fn) for name, fn in ops.items()}
    e.enable_compaction()
    launches = Launches(bitprop)
    try:
        probe_ops = [ops[name] for name, w in ls.DEFAULT_MIX.items()
                     for _ in range(max(1, round(w * 100)))]

        def closed_probe(dur_s: float, nthreads: int = 8) -> float:
            stop = time.perf_counter() + dur_s
            done = [0] * nthreads

            def w(i):
                k = i
                while time.perf_counter() < stop:
                    a = types.SimpleNamespace(key=k, ns_key=k)
                    probe_ops[(k * 131) % len(probe_ops)](a)
                    done[i] += 1
                    k += nthreads

            ts = [threading.Thread(target=w, args=(i,))
                  for i in range(nthreads)]
            for t in ts:
                t.start()
            for t in ts:
                t.join()
            return sum(done) / dur_s

        closed_probe(0.3)  # every op's path warm
        cap_rps = closed_probe(C_PROBE_S)
        base = max(5.0, 0.25 * cap_rps)
        span = {}  # multiplier -> the point's schedule, seconds

        def point_config(m: float):
            want = C_POINT_ARRIVALS * min(m, 1.0)
            d = max(C_DURATION, want / (2.0 * base * m))
            while True:
                cfg = trace_shaped_config(d, base * m, tenants=8,
                                          seed=seed)
                if len(build_schedule(cfg)) >= want:
                    span[m] = d
                    return cfg
                d *= 1.05

        log(f"phase C.a open-loop sweep (loadgen/) on the headline engine "
            f"after K.g: closed-loop capacity of the mix {cap_rps:.1f} op/s "
            f"from 8 threads over {C_PROBE_S} s; base offered rate "
            f"{base:.1f}/s (0.25x), trace-shaped schedules (watch storm, "
            f"get wave, reconcile) of at least {C_POINT_ARRIVALS} arrivals "
            f"from 1x up (0.5x as long as 1x) and {C_DURATION} s at "
            f"{C_MULTIPLIERS}, 32 workers, seed "
            f"{seed}; watch-open and wildcard-check run as checks (the "
            f"headline schema has no user:* grant)")
        folds0 = metrics.counter("engine_compactions_total").value
        t0 = time.perf_counter()
        with launches:
            res = run_sweep(point_config, ops, C_MULTIPLIERS, C_SLO,
                            max_workers=32, drain_timeout=30.0)
            sweep_s = time.perf_counter() - t0
            with busy:
                check(busy.wait_for(lambda: inflight[0] == 0, 300),
                      f"C.a: {inflight[0]} ops still running 300 s after "
                      f"the sweep")
            settle_s = time.perf_counter() - t0 - sweep_s
    finally:
        e.close_compaction()
    d = res.to_dict()

    def class_line(lats: list) -> str:
        # exact quantiles of the completions, each only over enough of them
        a = np.asarray(lats) * 1e3
        out = f"{len(a)}: p50 {np.percentile(a, 50):.3f}"
        if len(a) >= C_MIN_P99:
            out += f", p99 {np.percentile(a, 99):.3f}"
        if len(a) >= C_MIN_P999:
            out += f", p99.9 {np.percentile(a, 99.9):.3f}"
        return out + f", max {a.max():.3f}"

    fracs = []
    for p in res.points:
        check(p.error_n == 0, f"C.a: {p.error_n} errors at "
              f"{p.multiplier}x: {p.report.error_samples}")
        fracs.append(p.goodput_rps / p.offered_rps)
        log(f"  C.a {p.multiplier}x over {span[p.multiplier]:.1f} s: offered "
            f"{p.offered_rps:.1f}/s ({p.fired_n} fired, {p.late_n} late), "
            f"completed {p.completed_rps:.1f}/s, goodput "
            f"{p.goodput_rps:.1f}/s ({fracs[-1]:.3f} of offered), shed "
            f"{p.shed_n}, errors 0, abandoned {p.report.abandoned_n}")
        log(f"    ms, each class's completions (p99 over >= {C_MIN_P99}, "
            f"p99.9 over >= {C_MIN_P999}): " + "; ".join(
                f"{op} {class_line(p.report.latencies(op))}"
                for op in sorted(p.report.per_class())
                if p.report.latencies(op)))
    if fracs[0] < 0.85:
        knee = (f"at or below the lowest point's offered "
                f"{res.points[0].offered_rps:.1f} op/s (every point's goodput "
                f"under 0.85 of offered)" if max(fracs) < 0.85 else
                f"at or below the lowest point's offered "
                f"{res.points[0].offered_rps:.1f} op/s (its goodput under "
                f"0.85 of offered)")
    else:
        knee = (f"{d['knee_rps']} op/s offered ("
                f"{'saturated' if d['knee_saturated'] else 'not reached: a lower bound'})")
    log(f"  C.a knee {knee}; SLO attainment at {C_MULTIPLIERS[-1]}x: "
        f"{d['slo_attainment']}")
    top = res.points[-1].report
    for name, b in d["bursts"].items():
        w0, w1 = b["window_rel"]
        by_op: dict = {}
        for r in top.records:
            if w0 <= r.arrival.t < w1 and r.outcome == "ok":
                by_op.setdefault(r.arrival.op, []).append(r.latency_s)
        worst = max(by_op.items(), key=lambda kv: max(kv[1]),
                    default=(None, [0.0]))
        log(f"  C.a burst {name} at {C_MULTIPLIERS[-1]}x: {b['n']} arrivals, "
            f"shed {b['shed']}, errors {b['errors']}, the slowest class "
            f"{worst[0]}: max {max(worst[1]) * 1e3:.3f} ms over "
            f"{len(worst[1])} completions")
    ta = d["tail_attribution"]
    log(f"  C.a worst burst {ta.get('burst')}: {ta.get('traces')} kept "
        f"traces, stage shares {ta.get('stage_share')}")
    # the answers: every subject the sweep's writes granted, exact
    now = time.time()
    users = sorted(touched)
    n_type = e.compiled().type_sizes["pod"]
    got = {u: e.lookup_resources_mask("pod", "view", "user", u,
                                      now=now)[0] for u in users}
    same_masks(got, uncaveated_view_masks(e.store, users, now, n_type),
               "C.a: a written subject's list after the sweep")
    log(f"  C.a the sweep took {sweep_s:.1f} s (and {settle_s:.1f} s more "
        f"for the ops it abandoned): {len(written)} distinct "
        f"pod#viewer grants to {len(users)} subjects, each subject's mask "
        f"after it equal to the columnar reference; Table filters kept "
        f"{min(table_kept, default=0)}-{max(table_kept, default=0)} of "
        f"{C_TABLE_ROWS} rows; compactor folds "
        f"{metrics.counter('engine_compactions_total').value - folds0:.0f}; "
        f"loadgen-path launches {launches.n}")
    for kname, nl in launches.n.items():
        check(nl > 0, f"C.a: {kname} was not launched by the sweep")
    # unloaded: a lookup_subjects's candidate walk against its bulk checks
    walk, whole, ncand, nans = [], [], [], []
    for j in range(C_SPLIT_PODS):
        rid = pod(types.SimpleNamespace(key=int(rng.integers(1 << 16)),
                                        ns_key=j))
        t1 = time.perf_counter()
        cands = subject_candidates(e.schema, e.store, "pod", rid, "view",
                                   "user")
        t2 = time.perf_counter()
        got = e.lookup_subjects("pod", rid, "view", "user")
        t3 = time.perf_counter()
        check(set(got) <= cands, f"C.a: lookup_subjects on {rid} answered "
              f"a subject its candidate walk did not find")
        walk.append((t2 - t1) * 1e3)
        whole.append((t3 - t2) * 1e3)
        ncand.append(len(cands))
        nans.append(len(got))
    log(f"  C.a lookup_subjects on {C_SPLIT_PODS} pods, unloaded: "
        f"{[round(x, 3) for x in whole]} ms each, of which the candidate "
        f"walk over the store's columns {[round(x, 3) for x in walk]} ms "
        f"and the rest its bulk checks over {ncand} candidates "
        f"({nans} subjects hold pod#view); the walk's share of the whole "
        f"{sum(walk) / sum(whole):.3f}")
    return dict(launches.n)


def chaos_phase(torch, here: str, seed: int) -> dict:
    """Phase C.b (see the module docstring): one seed of the port's chaos
    campaign over engine-host CLIs sharing the card. Returns the kernel
    launches the surviving hosts logged at their shutdown."""
    from spicedb_kubeapi_proxy_tpu_torch.chaos import campaign as cc
    from spicedb_kubeapi_proxy_tpu_torch.chaos.invariants import \
        retry_amplification_bound
    from spicedb_kubeapi_proxy_tpu_torch.chaos.schedule import \
        brownout_schedule

    work = os.path.join(here, "build", "chaos")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    spawn, ready, kills, mem, walls, budget = {}, {}, [], [], [], {}
    lock = threading.Lock()

    def smi_used() -> str:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=memory.used",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()

    class Topology(cc.SubprocessTopology):
        def _boot(self, g, p):
            key = (g, p, sum(1 for k in spawn if k[:2] == (g, p)))
            t0 = time.perf_counter()
            proc = super()._boot(g, p)
            spawn[key] = t0
            port = self.ports[g][p]

            def await_ready():
                while time.perf_counter() - t0 < 180 and proc.poll() is None:
                    probe = self._probe(port)
                    try:
                        probe.failover_state()
                        with lock:
                            ready[key] = time.perf_counter() - t0
                        return
                    except Exception:  # noqa: BLE001 - not up yet
                        time.sleep(0.05)
                    finally:
                        probe.close()

            threading.Thread(target=await_ready, daemon=True).start()
            return proc

        def kill_group_leader(self, g):
            gp = super().kill_group_leader(g)
            t0 = time.perf_counter()
            rec = {"group": g, "peer": gp[1], "promoted_s": None}
            kills.append(rec)

            def await_promotion():
                while time.perf_counter() - t0 < 60:
                    if self.group_leader(g) not in (None, gp[1]):
                        rec["promoted_s"] = time.perf_counter() - t0
                        return
                    time.sleep(0.02)

            threading.Thread(target=await_promotion, daemon=True).start()
            return gp

        def make_planner(self):
            mem.append(("4 hosts up", smi_used()))
            return super().make_planner()

        def add_group(self):
            out = super().add_group()
            mem.append((f"{len(self.ports)} groups booted", smi_used()))
            return out

    class Campaign(cc.Campaign):
        def run_seed(self, s):
            walls.append(("seed start", time.perf_counter()))
            return super().run_seed(s)

        def _finish_episode(self, ev, extra):
            walls.append((ev.name, time.perf_counter()))
            if ev.attempts is not None:
                budget.update(retries=ev.retries_observed,
                              bound=retry_amplification_bound(
                                  ev.budget_ratio, ev.budget_burst,
                                  ev.attempts), attempts=ev.attempts)
            return super()._finish_episode(ev, extra)

    orig = cc.SubprocessTopology
    cc.SubprocessTopology = Topology
    try:
        t0 = time.perf_counter()
        camp = Campaign(cc.CampaignConfig(seeds=(seed,), episodes="short",
                                          workdir=work))
    finally:
        cc.SubprocessTopology = orig
    check(camp.cfg.device == "cuda", "C.b: the campaign is not on the card")

    def host_logs() -> dict:
        out = {}
        for f in sorted(os.listdir(work)):
            if f.startswith("host-") and f.endswith(".log"):
                with open(os.path.join(work, f), errors="replace") as fh:
                    out[f] = fh.read()
        return out

    try:
        result = camp.run()
    except BaseException:
        # the hosts' own account of the failure, ahead of the traceback
        for f, text in host_logs().items():
            print(f"--- C.b {f}, its last 1500 bytes:\n{text[-1500:]}",
                  file=sys.stderr, flush=True)
        raise
    wall_s = time.perf_counter() - t0
    logs = host_logs()
    check(result["ok"] and result["violations"] == [],
          f"C.b: the campaign found violations: {result['violations']}")
    names = [ev["episode"] for ev in result["episodes"]]
    check(names == [f"seed{seed}/{n}" for n in CHAOS_EPISODES],
          f"C.b: the episodes were {names}")
    by = {n.split("/", 1)[1]: ev for n, ev in zip(names, result["episodes"])}
    check(by["crash"]["killed"] is not None, "C.b: no leader was killed")
    check(by["elastic"]["killed"] is not None
          and [(t["phase"], t["converged"])
               for t in by["elastic"]["transitions"]]
          == [("grow", True), ("shrink", True), ("regrow", True)],
          f"C.b: the elastic episode {by['elastic'].get('transitions')}")
    check(by["migration"]["migration_phase"] == "done",
          f"C.b: the migration ended {by['migration']['migration_phase']}")
    digest = result["seeds"][str(seed)]["fault_digest"]
    want = CHAOS_SEED0_DIGEST if seed == 0 else \
        brownout_schedule(seed).digest()
    check(digest == want, f"C.b: the fault digest {digest} is not {want}")
    for f, text in logs.items():
        check("engine on cuda" in text, f"C.b: {f} did not run on the "
              f"card:\n{text[-2000:]}")
    check(budget and budget["retries"] <= budget["bound"],
          f"C.b: retries at the faulted group {budget}")
    counts = {"bit_or_matmul": 0, "dense_or_matmul": 0}
    for text in logs.values():
        for part in text.split("kernel launches in this process:")[1:]:
            got = launch_line("kernel launches in this process:"
                              + part.split("\n", 1)[0])
            for k in counts:
                counts[k] += got.get(k, 0)
    log(f"phase C.b one chaos campaign seed (chaos/) over engine-host CLIs "
        f"sharing the card (2 groups x 2 peers, --wal-fsync always, "
        f"--min-sync-replicas 1, --enable-chaos-ops, no --device): ok, 0 "
        f"violations, {len(names)} episodes {list(by)} in {wall_s:.1f} s "
        f"(the campaign's own clock {result['wall_s']} s); fault digest "
        f"{digest[:16]}... (the pinned seed-0 one: {digest == CHAOS_SEED0_DIGEST})")
    log(f"  C.b brownout: retries at the faulted group "
        f"{budget['retries']:.0f} against the budget's bound "
        f"{budget['bound']:.0f} ({budget['attempts']} attempts); "
        f"healthy-goodput ratio {by['brownout']['healthy_goodput_ratio']}")
    prev = None
    for name, t in walls:
        if prev is not None:
            log(f"  C.b episode {name}: {t - prev:.2f} s wall")
        prev = t
    for key in sorted(spawn):
        r = ready.get(key)
        log(f"  C.b host g{key[0]}p{key[1]} (boot {key[2]}): spawn -> ready "
            + (f"{r:.2f} s" if r is not None else "not seen"))
    for k in kills:
        ps = k["promoted_s"]
        log(f"  C.b SIGKILL of group {k['group']}'s leader (peer "
            f"{k['peer']}) -> its survivor promoted "
            + (f"{ps:.2f} s" if ps is not None else "not seen"))
    log(f"  C.b device memory (nvidia-smi): {mem}; elastic "
        f"{[(t['phase'], t['groups']) for t in by['elastic']['transitions']]}; "
        f"migration attempts {by['migration']['migration_attempts']}; "
        f"chaos-path launches (the hosts' own logged counts) {counts}")
    shutil.rmtree(work, ignore_errors=True)
    return counts


# the meshes of phase G.a: (data, graph); the last two put two cells on
# the one card
G_MESHES = ((1, 1), (1, 2), (2, 1))
G_BULK_TRIALS = 2  # G.a's 64 x 1,024 bulk checks a mesh
G_HOST_LISTS = 10  # G.b's lists over tcp://
G_HOST_WRITES = 20  # G.b's write -> read-after-write pairs


def mesh_phase(torch, e, dev, subjects: list, masks: dict, items: list,
               verdicts: list, now: float) -> tuple:
    """Phase G.a: the headline engine's compiled graph at phase 5-6's
    state served through a ``ShardedGraph`` (``Engine.mesh``) at each of
    ``G_MESHES``, its cells all on this card: build seconds and device
    bytes, phase 5's lists (p50/p99, iterations and convergence windows)
    and phase 6's bulk check (checks/s), every mask and verdict byte-equal
    to phase 5-6's single-device answers; the dense kernel held against
    its plain version at one cell's shard input and timed there. Returns
    (both kernels' launches over the mesh calls, the kernel's times at
    the shard input)."""
    from spicedb_kubeapi_proxy_tpu_torch.ops import bitprop
    from spicedb_kubeapi_proxy_tpu_torch.parallel import make_mesh
    from spicedb_kubeapi_proxy_tpu_torch.parallel.mesh import mesh_topology
    from spicedb_kubeapi_proxy_tpu_torch.utils.metrics import metrics

    launches = Launches(bitprop)
    cg = e.compiled()
    pv_off = cg.offset_of("pod", "viewer")
    krow = None
    builds0 = metrics.counter("engine_sharded_builds_total").value
    t_all = time.perf_counter()
    try:
        for data, graph in G_MESHES:
            n = data * graph
            e.mesh = make_mesh(n, data=data, graph=graph, devices=[dev] * n)
            e._sharded = None
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            alloc0 = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            sg = e._backend(cg)
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
            check(type(sg).__name__ == "ShardedGraph",
                  f"G.a: the mesh engine did not build a ShardedGraph "
                  f"({type(sg).__name__})")
            nbytes = sg.device_bytes()
            alloc = torch.cuda.memory_allocated() - alloc0
            pv = [i for i, b in enumerate(sg._block_meta)
                  if b.dst_off == pv_off]
            check(len(pv) == 1, "G.a: the pod#viewer block is not kept")
            e.lookup_resources_mask("pod", "view", "user", subjects[0])
            lat, iters, windows = [], [], []
            before = dict(launches.n)
            with launches:
                for u in subjects:
                    t0 = time.perf_counter()
                    fut = e.lookup_resources_mask_async("pod", "view",
                                                        "user", u)
                    mask, _ = fut.result()
                    lat.append((time.perf_counter() - t0) * 1e3)
                    check(np.array_equal(mask, masks[u]),
                          f"G.a {data}x{graph}: {u}'s mask differs from "
                          "phase 5's")
                    iters.append(fut.iterations())
                    windows.append(fut._fut.conv_checks())
                rates = []
                for _ in range(G_BULK_TRIALS):
                    t0 = time.perf_counter()
                    got = e.check_bulk(items, now=now)
                    rates.append(len(items) / (time.perf_counter() - t0))
                    check(got == verdicts, f"G.a {data}x{graph}: "
                          f"{sum(a != b for a, b in zip(got, verdicts))} "
                          "verdicts differ from phase 6's")
            dense = launches.n["dense_or_matmul"] - before["dense_or_matmul"]
            bit = launches.n["bit_or_matmul"] - before["bit_or_matmul"]
            check(dense > 0, f"G.a {data}x{graph}: dense_or_matmul was "
                  "not launched on the mesh path")
            check(bit == 0, f"G.a {data}x{graph}: the bit kernel ran on "
                  "the mesh (mesh blocks carry no bit dual)")
            log(f"phase G.a mesh {mesh_topology(e.mesh)} (data={data}, "
                f"graph={graph}, {n} cell(s) on {dev}): build "
                f"{build_s:.2f} s, {nbytes} device bytes held "
                f"({alloc} allocated), {len(sg._block_meta)} kept block(s), "
                f"pod#viewer shard [{sg._block_meta[pv[0]].n_dst} x "
                f"{sg._block_meta[pv[0]].n_src // graph}]; {len(subjects)} "
                f"lists p50 {np.percentile(lat, 50):.3f} ms, p99 "
                f"{np.percentile(lat, 99):.3f} ms, iterations "
                f"{sorted(set(iters))}, convergence windows "
                f"{sorted(set(windows))} (K={sg.k_steps}); bulk "
                f"{len(items)} checks p50 {np.median(rates):,.0f} checks/s "
                f"over {G_BULK_TRIALS} trials; every mask and verdict "
                f"byte-equal to phase 5-6's; dense_or_matmul launches "
                f"{dense}, bit_or_matmul {bit}")
            if graph == 2:
                shard = next(A for bm, g, A in sg.block_shards()
                             if g == 0 and bm.dst_off == pv_off)
                got_in = {}
                real = bitprop.dense_or_matmul

                def spy(A, f):
                    if A is shard and "f" not in got_in:
                        buf = strided_like(f)
                        buf.copy_(f)
                        got_in["f"] = buf
                    return real(A, f)

                spy.launches = 0
                bitprop.dense_or_matmul = spy
                try:
                    e.check_bulk(items[:16384], now=now)
                finally:
                    bitprop.dense_or_matmul = real
                check("f" in got_in, "G.a: no shard input captured")
                krow = time_dense(torch, bitprop, shard, got_in["f"], dev,
                                  "G.a one cell's shard (1x2)")
                krow["max_abs_err"] = 0
                krow["shape"] = [int(x) for x in shard.shape]
                krow["batch"] = int(got_in["f"].shape[0])
                del got_in, shard
            del sg
    finally:
        e.mesh, e._sharded = None, None
        gc.collect()
        torch.cuda.empty_cache()
    builds = metrics.counter("engine_sharded_builds_total").value - builds0
    check(builds == len(G_MESHES), f"G.a: {builds} sharded builds for "
          f"{len(G_MESHES)} meshes")
    log(f"phase G.a took {time.perf_counter() - t_all:.1f} s; mesh path "
        f"launches {launches.n}")
    return launches.n, krow


def mesh_host_phase(torch, here: str, users: list, want: dict) -> dict:
    """Phase G.b: the engine-host CLI as a multi-host set of one process,
    ``--distributed 127.0.0.1:<port>,1,0 --engine-mesh auto`` (a real
    NCCL world of 1 on the card) on a copy of phase P's data dir: spawn
    -> first list, ``G_HOST_LISTS`` lists over tcp:// exact against the
    writer's masks, ``G_HOST_WRITES`` write -> read-after-write pairs
    (``ShardedGraph.updated`` syncing the mesh state) each exact against
    the writer's mask plus the grants written, the host's mesh counters
    and kernel launches from its log, and a clean SIGTERM shutdown.
    Returns the host's kernel launches."""
    import signal
    import socket

    from spicedb_kubeapi_proxy_tpu_torch.engine import remote
    from spicedb_kubeapi_proxy_tpu_torch.engine.store import WriteOp
    from spicedb_kubeapi_proxy_tpu_torch.models.tuples import Relationship

    root = os.path.join(here, "build", "persist")
    d = os.path.join(root, "g_host")
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(os.path.join(root, "data"), d)
    boot = os.path.join(root, "r_host_bootstrap.yaml")
    ports = []
    for _ in range(2):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        ports.append(s)
    port, coord = (s.getsockname()[1] for s in ports)
    for s in ports:
        s.close()
    log_path = os.path.join(root, "g_host.log")

    def tail() -> str:
        with open(log_path, errors="replace") as fh:
            return fh.read()

    t_all = time.perf_counter()
    with open(log_path, "w") as logf:
        t0 = time.perf_counter()
        p = subprocess.Popen(
            [sys.executable, "-m",
             "spicedb_kubeapi_proxy_tpu_torch.engine.remote",
             "--engine-insecure", "--bind-port", str(port),
             "--bootstrap", boot, "--data-dir", d,
             "--distributed", f"127.0.0.1:{coord},1,0",
             "--engine-mesh", "auto"], cwd=here, stdout=logf,
            stderr=subprocess.STDOUT)
    c = None
    try:
        while True:
            check(p.poll() is None, f"G.b: the host exited during boot "
                  f"({p.returncode}):\n{tail()[-3000:]}")
            check(time.perf_counter() - t0 < 300, "G.b: no bind in 300 s")
            try:
                socket.create_connection(("127.0.0.1", port),
                                         timeout=1).close()
                break
            except OSError:
                time.sleep(0.05)
        bind_s = time.perf_counter() - t0
        c = remote.RemoteEngine("127.0.0.1", port)
        m, it = c.lookup_resources_mask("pod", "view", "user", users[0])
        first_s = time.perf_counter() - t0
        check(np.array_equal(m, want[users[0]]),
              f"G.b: {users[0]}'s first mask differs from the writer's")
        lat = []
        for u in (users * G_HOST_LISTS)[:G_HOST_LISTS]:
            t1 = time.perf_counter()
            m, it = c.lookup_resources_mask("pod", "view", "user", u)
            lat.append((time.perf_counter() - t1) * 1e3)
            check(np.array_equal(m, want[u]),
                  f"G.b: {u}'s mask over tcp:// differs from the writer's")
        names = {u: {it.string(i) for i in np.flatnonzero(want[u]).tolist()}
                 for u in users}
        w_ms, r_ms = [], []
        for i in range(G_HOST_WRITES):
            u = users[i % len(users)]
            pod = f"ns/p-g{i}"
            t1 = time.perf_counter()
            c.write_relationships([WriteOp("touch", Relationship(
                "pod", pod, "viewer", "user", u))])
            t2 = time.perf_counter()
            got = set(c.lookup_resources("pod", "view", "user", u))
            t3 = time.perf_counter()
            w_ms.append((t2 - t1) * 1e3)
            r_ms.append((t3 - t2) * 1e3)
            names[u].add(pod)
            check(got == names[u], f"G.b: after write {i}, {u}'s list "
                  f"differs from the writer's plus the grants written "
                  f"({len(got ^ names[u])} names)")
        c.close()
        c = None
        t1 = time.perf_counter()
        p.send_signal(signal.SIGTERM)
        rc = p.wait(timeout=120)
        shut_s = time.perf_counter() - t1
        text = tail()
        check(rc == 0, f"G.b: the host exited {rc} on SIGTERM:\n"
              f"{text[-3000:]}")
        check("distributed: process 0 of 1 (nccl)" in text,
              f"G.b: no NCCL world of 1 in the host's log:\n{text[-3000:]}")
        check("engine mesh: {'devices': 1, 'data': 1, 'graph': 1, "
              "'platform': 'cuda'}" in text and "engine on cuda" in text,
              f"G.b: the host's mesh is not on the card:\n{text[-3000:]}")
        counters = {}
        for ln in text.splitlines():
            if "mesh counters:" in ln:
                for part in ln.split("mesh counters:", 1)[1].split():
                    k, _, v = part.partition("=")
                    counters[k] = int(v)
        check(counters.get("engine_sharded_builds_total") == 1
              and counters.get("engine_sharded_updates_total", 0) >= 1
              and counters.get("engine_tier_mesh_fallback_total") == 0
              and counters.get("engine_caveat_mesh_fallback_total") == 0,
              f"G.b: the host's mesh counters {counters}")
        kl = launch_line(text)
        check(kl.get("dense_or_matmul", 0) > 0 and
              kl.get("bit_or_matmul", -1) == 0,
              f"G.b: the host's kernel launches {kl}")
        log(f"phase G.b the engine-host CLI with --distributed "
            f"127.0.0.1:{coord},1,0 --engine-mesh auto on a copy of phase "
            f"P's data dir: bound {bind_s:.2f} s after spawn, first list "
            f"{first_s:.2f} s after spawn; {G_HOST_LISTS} lists over "
            f"tcp:// p50 {np.percentile(lat, 50):.3f} ms, p99 "
            f"{np.percentile(lat, 99):.3f} ms, exact against the writer's "
            f"masks; {G_HOST_WRITES} write -> read-after-write pairs: "
            f"write p50 {np.percentile(w_ms, 50):.3f} ms, read-after-write "
            f"p50 {np.percentile(r_ms, 50):.3f} ms, p99 "
            f"{np.percentile(r_ms, 99):.3f} ms, each list exact; host "
            f"counters {counters}, kernel launches {kl}; SIGTERM -> exit "
            f"{rc} in {shut_s:.2f} s; G.b took "
            f"{time.perf_counter() - t_all:.1f} s")
        log("  the host's log: " + " | ".join(
            ln.strip() for ln in text.splitlines()
            if "distributed:" in ln or "engine mesh" in ln
            or "mesh counters" in ln))
        return kl
    finally:
        if c is not None:
            c.close()
        if p.poll() is None:
            p.kill()
            p.wait(30)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-rels", type=int, default=HEADLINE_RELS,
                    help="relationship count (the only dimension that may "
                         "be cut; widths stay at the headline)")
    ap.add_argument("--writes", type=int, default=120,
                    help="phase 9b write->read pairs (at least 50)")
    args = ap.parse_args(argv)
    if args.writes < 50:
        ap.error("--writes must be at least 50")

    t_run = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script measures the GPU port only",
              file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        import spicedb_kubeapi_proxy_tpu_torch as port
    except ImportError as ex:
        print(f"chip_smoke: the port package is missing next to the script "
              f"({ex}); run it from the repository root", file=sys.stderr)
        return 2
    check(os.path.dirname(os.path.dirname(os.path.abspath(port.__file__)))
          == here, "the port package must come from this checkout")
    from spicedb_kubeapi_proxy_tpu_torch.engine import CheckItem, Engine
    from spicedb_kubeapi_proxy_tpu_torch.engine.evaluator import \
        OracleEvaluator
    from spicedb_kubeapi_proxy_tpu_torch.engine.store import Snapshot
    from spicedb_kubeapi_proxy_tpu_torch.models import parse_schema
    from spicedb_kubeapi_proxy_tpu_torch.ops import bitprop, kernels, \
        semiring

    # -- phase 1: device --
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    smi_line = smi[0] if smi else "nvidia-smi: no output"
    log(f"phase 1 device: {name} (count {torch.cuda.device_count()}); "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"  nvidia-smi: {smi_line}")

    # -- phase 2: kernel build --
    t0 = time.perf_counter()
    kernels.build("bitprop")
    log(f"phase 2 kernel build: {time.perf_counter() - t0:.2f} s "
        f"(nvcc {kernels.build_seconds.get('bitprop', 0.0):.2f} s)")

    # -- phase 3: store build --
    if args.n_rels != HEADLINE_RELS:
        log(f"  n_rels cut: {args.n_rels} of the headline {HEADLINE_RELS}")
    t0 = time.perf_counter()
    x_part: dict = {}
    rows = build_rows(N_PODS, N_USERS, N_NS, N_GROUPS, args.n_rels,
                      args.seed, part_out=x_part)
    total = len(rows["resource_id"])
    gen_s = time.perf_counter() - t0
    e = Engine(schema=parse_schema(BENCH_SCHEMA), device=dev)
    t0 = time.perf_counter()
    e.bulk_load(rows)
    load_s = time.perf_counter() - t0
    # what journaling this load would take: one WAL frame of the columns
    frame_bytes = sum(v.nbytes for v in rows.values())
    samples = base_samples(rows, N_PODS, N_NS, N_GROUPS, args.n_rels,
                           args.seed)
    x_base = (rows, x_part)  # phase X re-keys these rows
    del rows
    t0 = time.perf_counter()
    cg = e.compiled()
    compile_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    d = cg._dev()
    torch.cuda.synchronize()
    dev_s = time.perf_counter() - t0
    n_bits = sum(b is not None for b in d["blocks_bits"])
    log(f"phase 3 store: {total} relationships (gen {gen_s:.2f} s), "
        f"bulk_load {load_s:.2f} s, compile_graph {compile_s:.2f} s, "
        f"device build {dev_s:.2f} s")
    log(f"  M={cg.M} slots, E={cg.n_edges} edges, {len(cg.blocks)} dense "
        f"blocks ({n_bits} with bit duals), {cg.n_levels} levels, "
        f"residual {len(cg.res_src)} padded edges")
    for b, A, bits in zip(cg.blocks, d["blocks"], d["blocks_bits"]):
        log(f"    block dst@{b.dst_off} [{b.n_dst} x {b.n_src}] level "
            f"{b.level} edges {len(b.dst_local)}"
            + (f" bits {tuple(bits.shape)}" if bits is not None else ""))
    log(f"  device bytes held: graph {cg.device_bytes()}, allocated "
        f"{torch.cuda.memory_allocated()}")

    # -- phase 4: kernels vs plain, at the main path's own inputs --
    objs = e._objects_by_name()
    rng = np.random.default_rng(args.seed + 1)
    subjects = [f"u{rng.integers(N_USERS)}" for _ in range(N_SUBJECTS)]
    bulk_users = [f"u{u}" for u in rng.choice(N_USERS, 64, replace=False)]
    # grouped by subject as bench.py builds them: each 16,384-item chunk
    # holds 16 subjects, so the bulk check's pull hops run at B=16
    items = [CheckItem("pod", f"ns/p{rng.integers(N_PODS)}", "view",
                       "user", u) for u in bulk_users for _ in range(1024)]
    pv = next(i for i, b in enumerate(cg.blocks)
              if b.dst_off == cg.offset_of("pod", "viewer"))
    check(d["blocks_bits"][pv] is not None,
          "the pod#viewer block has no bit dual")
    cap = capture_inputs(  # doubles as the main path's warm-up
        bitprop, d["blocks_bits"][pv], d["blocks"][pv], lambda: (
            e.lookup_resources_mask("pod", "view", "user", subjects[0]),
            e.check_bulk(items)))
    user_idx = objs["user"].id_map()
    log("phase 4 kernels vs plain on the card:")
    krows = kernel_phase(torch, bitprop, kernels, cap, one_hot_frontier(
        torch, [user_idx[u] for u in bulk_users], d["blocks"][pv].shape[1],
        dev), dev)
    del cap

    # -- phases 5 + 6: the main path, launches counted --
    torch.cuda.synchronize()
    bitprop.reset_launch_counts()
    lat, masks, iters, pushes = [], {}, [], []
    for u in subjects:
        t0 = time.perf_counter()
        fut = e.lookup_resources_mask_async("pod", "view", "user", u)
        mask, _ = fut.result()
        lat.append((time.perf_counter() - t0) * 1e3)
        masks[u] = mask
        iters.append(fut.iterations())
        pushes.append(fut._fut.push_steps())
    p50, p99 = np.percentile(lat, 50), np.percentile(lat, 99)
    log(f"phase 5 list filter: {len(lat)} subjects, B=1, p50 {p50:.3f} ms, "
        f"p99 {p99:.3f} ms wall; iterations {sorted(set(iters))}, push "
        f"steps {sorted(set(pushes))}; visible pods "
        f"{[int(m.sum()) for m in list(masks.values())[:5]]}...")
    rates, now = [], time.time()  # one clock for phases 6 and 8
    for _ in range(5):
        t0 = time.perf_counter()
        verdicts = e.check_bulk(items, now=now)
        rates.append(len(items) / (time.perf_counter() - t0))
    log(f"phase 6 bulk check: {len(items)} checks (64 subjects x 1024, "
        f"4 chunks of 16 subjects), p50 {np.median(rates):,.0f} checks/s "
        f"over 5 trials (min {min(rates):,.0f}, max {max(rates):,.0f}); "
        f"{sum(verdicts)} allowed")
    launches = {"bit_or_matmul": bitprop.bit_or_matmul.launches,
                "dense_or_matmul": bitprop.dense_or_matmul.launches}
    log(f"  main-path launches: {launches}")
    for kname, n in launches.items():
        check(n > 0, f"{kname} was not launched on the main path")
    # phase X's reference (outside the count): 64 subjects' lists at the
    # base state as pod indices, and phase 6's items and verdicts
    pod_num = np.full(cg.type_sizes["pod"], -1, dtype=np.int64)
    for pid, i in objs["pod"].id_map().items():
        if pid.startswith("ns/p"):
            pod_num[i] = int(pid[4:])
    x_subjects = list(dict.fromkeys(subjects))
    for u in rng.permutation(N_USERS).tolist():
        if len(x_subjects) == X_SUBJECTS:
            break
        if f"u{u}" not in x_subjects:
            x_subjects.append(f"u{u}")
    x_ref = {"subjects": x_subjects, "masks": {}, "items": items,
             "verdicts": verdicts}
    for u in x_subjects:
        m = masks[u] if u in masks else e.lookup_resources_mask(
            "pod", "view", "user", u)[0]
        got = np.sort(pod_num[np.flatnonzero(m)])
        check(len(got) == 0 or got[0] >= 0, "X: a visible slot without a pod")
        x_ref["masks"][u] = got

    # -- phase 7: forced pull, same subjects --
    with semiring.force_mode("pull"):
        for u in subjects:
            mask, _ = e.lookup_resources_mask("pod", "view", "user", u)
            check(np.array_equal(mask, masks[u]),
                  f"forced-pull mask differs from push for {u}")
    log(f"phase 7 forced pull: {len(subjects)} masks identical to phase 5")

    # -- phase 7b: where the time goes (device trace of both paths) --
    trace_phase(torch, "list filter (B=1)", lambda: [
        e.lookup_resources_mask("pod", "view", "user", u)
        for u in subjects[:10]], 10,
        {"bit_or_matmul_kernel": ("bit_or_matmul_kernel",),
         "its small-dual stream kernel": ("bit_or_matmul_stream_kernel",)})
    trace_phase(torch, "bulk check (64x1024)", lambda: e.check_bulk(items),
                1, {
                    "dense_or_matmul_kernel": ("dense_or_matmul_kernel",),
                    "its pre-pass": ("dense_live_tiles_kernel",)})

    # -- phase 8: the host oracle --
    # a sample of phase 6's own verdicts (all of its allowed ones)
    sample = sorted(set(rng.choice(len(items), 2000, replace=False).tolist())
                    | {i for i, v in enumerate(verdicts) if v})
    pods = objs["pod"]
    checks = []
    for u in subjects[:10]:
        vis = np.flatnonzero(masks[u])
        for i in vis[:10].tolist():
            checks.append(CheckItem("pod", pods.string(i), "view", "user", u))
    while len(checks) < 240:
        checks.append(CheckItem(
            "pod", f"ns/p{rng.integers(N_PODS)}", "view", "user",
            f"u{rng.integers(N_USERS)}"))
    checks += [CheckItem("namespace", f"ns{rng.integers(N_NS)}", "view",
                         "user", f"u{rng.integers(N_USERS)}")
               for _ in range(40)]
    users8 = {items[i].subject_id for i in sample} | set(subjects[:10]) \
        | {c.subject_id for c in checks}
    t0 = time.perf_counter()
    oracle = subset_oracle(e.store.snapshot(), e.schema, OracleEvaluator,
                           Snapshot, users8, now)
    oracle_s = time.perf_counter() - t0
    bad = sum(verdicts[i] != oracle.check(
        "pod", items[i].resource_id, "view", "user", items[i].subject_id)
        for i in sample)
    check(bad == 0, f"{bad} of {len(sample)} phase-6 verdicts disagree "
          f"with the oracle")
    got = e.check_bulk(checks, now=now)
    want = [oracle.check(c.resource_type, c.resource_id, c.permission,
                         c.subject_type, c.subject_id) for c in checks]
    check(got == want, f"{sum(a != b for a, b in zip(got, want))} of "
          f"{len(checks)} checks disagree with the oracle")
    for u in subjects[:2]:
        ids = {pods.string(i) for i in np.flatnonzero(masks[u])}
        check(ids == oracle.lookup_resources("pod", "view", "user", u),
              f"full mask for {u} disagrees with the oracle")
    log(f"phase 8 oracle: {len(sample)} phase-6 verdicts "
        f"({sum(verdicts[i] for i in sample)} allowed), {len(checks)} checks "
        f"({sum(want)} allowed) and 2 full masks exact (the oracle over "
        f"the rows that reach the {len(users8)} users checked, built in "
        f"{oracle_s:.1f} s)")
    del oracle

    # -- phase G.a: the device mesh (parallel/) at phase 5-6's state --
    t0 = time.perf_counter()
    mesh_launches, mesh_krow = mesh_phase(torch, e, dev, subjects, masks,
                                          items, verdicts, now)
    log(f"phase G.a took {time.perf_counter() - t0:.1f} s (the run at "
        f"{time.perf_counter() - t_run:.0f} s)")

    # -- phase 9: the write path --
    t0 = time.perf_counter()
    write_launches = write_phase(torch, e, samples, subjects, args.writes,
                                 args.seed, compile_s + dev_s)
    log(f"phase 9 took {time.perf_counter() - t0:.1f} s (the run at "
        f"{time.perf_counter() - t_run:.0f} s)")

    # -- phase S: the serving front, on the same engine --
    t0 = time.perf_counter()
    serving_launches, fused_rows, tenant = serving_phase(
        torch, e, subjects, items, args.seed)
    log(f"phase S took {time.perf_counter() - t0:.1f} s (the run at "
        f"{time.perf_counter() - t_run:.0f} s)")

    # -- phase P: snapshots, the WAL and crash recovery, on the same engine
    t0 = time.perf_counter()
    e2, persist_launches, cold, p_users = persistence_phase(
        torch, e, os.path.join(here, "build", "persist"), subjects,
        args.writes, args.seed, frame_bytes)
    log(f"phase P took {time.perf_counter() - t0:.1f} s (the run at "
        f"{time.perf_counter() - t_run:.0f} s)")

    # -- phase T: tiered residency on the recovered engine --
    t0 = time.perf_counter()
    tiered_launches = tiered_phase(torch, e, e2, subjects, items, cold)
    log(f"phase T took {time.perf_counter() - t0:.1f} s")
    # the recovered engine journals into P's data dir: close it before R.e
    # copies the dir
    e2.close_persistence(final_checkpoint=False)
    del e2

    # -- phase R: the engine host, on the headline engine and as the CLI --
    t0 = time.perf_counter()
    p_want = list_masks(e, p_users)  # the writer's masks for R.e
    remote_launches = remote_phase(
        torch, e, subjects, items, now,
        {"list_p50": p50, "checks_per_s": float(np.median(rates)),
         "tenant": tenant}, args.seed)
    r_dir = host_cli_phase(torch, here, os.path.join(
        here, "build", "persist", "data"), BENCH_SCHEMA, p_users, p_want)
    log(f"phase R took {time.perf_counter() - t0:.1f} s (the run at "
        f"{time.perf_counter() - t_run:.0f} s)")

    # -- phase G.b: the host CLI as a --distributed world of 1 over a mesh
    t0 = time.perf_counter()
    mesh_host_launches = mesh_host_phase(torch, here, p_users, p_want)
    log(f"phase G.b took {time.perf_counter() - t0:.1f} s (the run at "
        f"{time.perf_counter() - t_run:.0f} s)")

    # -- phase M: live schema migration at a reduced depth and the CLI; the
    # headline engine then takes M's final schema (M.d)
    t0 = time.perf_counter()
    migration_launches = migration_cell(
        torch, e, here, subjects, items, bulk_users, r_dir, p_users, p_want,
        args.n_rels, args.seed)
    log(f"phase M took {time.perf_counter() - t0:.1f} s (the run at "
        f"{time.perf_counter() - t_run:.0f} s)")

    # -- phase K: the proxy itself, on the headline engine and as the CLI
    t0 = time.perf_counter()
    proxy_launches = proxy_phase(torch, e, here, subjects, args.seed)
    proxy_cli_phase(torch, here)
    oidc_launches = oidc_phase(torch, e, here, subjects, MEASURED["k_a"],
                               args.seed)
    log(f"phase K took {time.perf_counter() - t0:.1f} s (the run at "
        f"{time.perf_counter() - t_run:.0f} s)")

    # -- phase C.a: the open-loop sweep on the headline engine --
    t0 = time.perf_counter()
    loadgen_launches = loadgen_phase(torch, e, subjects, args.seed)
    log(f"phase C.a took {time.perf_counter() - t0:.1f} s (the run at "
        f"{time.perf_counter() - t_run:.0f} s)")
    t0 = time.perf_counter()
    demo_launches = demo_phase(torch)
    log(f"phase D took {time.perf_counter() - t0:.1f} s (the run at "
        f"{time.perf_counter() - t_run:.0f} s)")

    # -- phase F: the --peers failover set, two host CLIs on the card --
    t0 = time.perf_counter()
    failover_launches = failover_phase(torch, here, BENCH_SCHEMA,
                                       bulk_users, items,
                                       MEASURED["r_write"])
    for kname, n in failover_launches.items():
        check(n > 0, f"F: {kname} was not launched by the new leader")
    log(f"phase F took {time.perf_counter() - t0:.1f} s (the run at "
        f"{time.perf_counter() - t_run:.0f} s)")

    # -- phase 10: the caveated mix, on a store of its own --
    del e, cg, d, objs, pods, fut, A, bits
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  phase 3-9's engine released: {torch.cuda.memory_allocated()} "
        "device bytes still allocated")
    t0 = time.perf_counter()
    # reduced: a quarter of the relationships (the run's 1,000 s has no
    # room for phases F and G with the whole caveated store)
    caveat_launches, proxy_cav_launches = caveat_phase(
        torch, dev, args.n_rels // 4, subjects, items, bulk_users, here)
    log(f"phase 10 took {time.perf_counter() - t0:.1f} s (the run at "
        f"{time.perf_counter() - t_run:.0f} s)")

    # -- phase X: scale-out, with phase 10's engine released --
    gc.collect()
    torch.cuda.empty_cache()
    scaleout_launches = scaleout_phase(torch, dev, here, args.seed,
                                       x_base, x_ref)
    del x_base

    # -- phase C.b: one chaos campaign seed over host CLIs on the card --
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    chaos_launches = chaos_phase(torch, here, args.seed)
    log(f"phase C.b took {time.perf_counter() - t0:.1f} s (the run at "
        f"{time.perf_counter() - t_run:.0f} s)")

    out = []
    for kname in ("bit_or_matmul", "dense_or_matmul"):
        r = krows[kname]
        out.append({"name": kname, "route": "cuda", "source": KERNEL_SOURCE,
                    "replaces": REPLACES[kname],
                    "launches": launches[kname],
                    "write_path_launches": write_launches[kname],
                    "caveat_path_launches": caveat_launches[kname],
                    "serving_path_launches": serving_launches[kname],
                    "persistence_path_launches": persist_launches[kname],
                    "tiered_path_launches": tiered_launches[kname],
                    "remote_path_launches": remote_launches[kname],
                    "migration_path_launches": migration_launches[kname],
                    "proxy_path_launches": proxy_launches[kname]
                    + proxy_cav_launches[kname] + oidc_launches[kname],
                    "failover_path_launches": failover_launches[kname],
                    "demo_path_launches": demo_launches[kname],
                    "scaleout_path_launches": scaleout_launches[kname],
                    "loadgen_path_launches": loadgen_launches[kname],
                    "chaos_path_launches": chaos_launches[kname],
                    # G.a's in-process meshes and G.b's host; 0 for the
                    # bit kernel: mesh blocks carry no bit dual, every
                    # block hop on the mesh is a pull
                    "mesh_path_launches": mesh_launches[kname]
                    + mesh_host_launches.get(kname, 0),
                    "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                    "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                    "device_ms": r["device_ms"], "host_ms": r["host_ms"],
                    "library_device_ms": r.get("library_device_ms"),
                    "sector_bound_ms": r["sector_bound_ms"],
                    "mesh_shard_input": {k: mesh_krow[k] for k in (
                        "shape", "batch", "ms", "device_ms", "host_ms",
                        "plain_ms", "bound_ms", "sector_bound_ms",
                        "library_ms", "library_device_ms", "max_abs_err")}
                    if kname == "dense_or_matmul" else None,
                    "fused_inputs": {
                        f"n_b{nb}": {k: fr[k] for k in (
                            "ms", "device_ms", "host_ms", "plain_ms",
                            "bound_ms", "sector_bound_ms", "live",
                            "sparse_max_live")}
                        for nb, fr in fused_rows.items()}
                    if kname == "bit_or_matmul" else None})
    log(f"the whole run took {time.perf_counter() - t_run:.1f} s")
    log("kernels: " + ", ".join(
        f"{k['name']} launches={k['launches']} matched_plain="
        f"{k['max_abs_err'] == 0}" for k in out))
    print(json.dumps({"kernels": out}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as ex:
        print(f"chip_smoke FAILED: {ex}", file=sys.stderr)
        sys.exit(1)
