"""Options: configuration, completion, validation.

A copy of the JAX package's ``proxy/options.py`` (the Go proxy's
pkg/proxy/options.go:49-449): rule-file parsing into a matcher, engine
endpoint selection, workflow database path, upstream kube connection,
authentication mode, and functional options for embedding.

``embedded://`` and ``tpu://`` (the reference's names, kept so operators'
flags carry over) both build the port's :class:`~..engine.Engine` in
process on ``device``: ``cuda`` unless the caller asks for ``cpu``, and a
missing card is an :class:`OptionsError` carrying
:func:`~..device.resolve_device`'s message, never a CPU fallback.
``tcp://`` builds the port's ``RemoteEngine`` / ``FailoverEngine``.
``--shard-map`` builds the port's scale-out planner (scaleout/
``ShardedEngine``) over one such client per engine group, with its
split-write journal, the optional vector cache, frontier exchange,
``--rebalance-to`` and the autoscaler (autoscale/); each group's host
owns its device, so ``--device`` is refused beside it.

Bearer tokens authenticate through a static token file and OIDC
(``--oidc-*``, proxy/oidc.py: the issuer's JWKS verifies the token's
signature), chained when both are set.

``--engine-mesh`` spreads the in-process engine over a device mesh
(parallel/mesh.py): the cards of this host, or with ``device="cpu"`` CPU
cells, ``data=D,graph=G`` of them (``auto``: one).
"""

from __future__ import annotations

import argparse
import logging
from dataclasses import dataclass, field
from typing import Optional

from ..authz import AuthzDeps
from ..device import resolve_device
from ..dtx import ActivityHandler, WorkflowEngine, register_workflows
from ..dtx.workflow import LOCK_MODE_OPTIMISTIC, LOCK_MODE_PESSIMISTIC
from ..engine import Engine
from ..rules.matcher import MapMatcher
from ..utils.net import EndpointError, parse_endpoints
from .authn import HeaderAuthenticator
from .server import Server
from .upstream import HttpUpstream

EMBEDDED_ENDPOINT = "embedded://"
TPU_ENDPOINT = "tpu://"
REMOTE_ENDPOINT_PREFIX = "tcp://"  # remote engine host (engine/remote.py)

DEFAULT_WORKFLOW_DB = "/tmp/dtx.sqlite"  # reference options.go:41


class OptionsError(ValueError):
    pass


def parse_bool_flag(v) -> bool:
    """argparse type for ``--flag``, ``--flag=true`` and ``--flag=false``
    (kube-style boolean flags; used by --authz-cache, default on)."""
    if isinstance(v, bool):
        return v
    s = str(v).strip().lower()
    if s in ("1", "true", "t", "yes", "y", "on"):
        return True
    if s in ("0", "false", "f", "no", "n", "off"):
        return False
    raise argparse.ArgumentTypeError(f"expected a boolean, got {v!r}")


def _parse_mesh_spec(spec: str) -> dict:
    """Mesh spec parsing (parallel/mesh.py), re-raised as OptionsError."""
    from ..parallel.mesh import MeshSpecError, parse_mesh_spec

    try:
        return parse_mesh_spec(spec)
    except MeshSpecError as e:
        raise OptionsError(str(e)) from None


@dataclass
class Options:
    # engine backend: embedded:// | tpu:// (both the in-process engine on
    # `device`; tpu:// is the default) | tcp://host:port (a remote engine
    # host, engine/remote.py — the reference's remote-SpiceDB deployment
    # shape, options.go:325-369)
    engine_endpoint: str = TPU_ENDPOINT
    # torch device of the in-process engine: None = cuda (a missing card
    # fails validation); "cpu" only when asked for
    device: Optional[str] = None
    # device mesh of the in-process engine: "auto" (every card; with
    # device="cpu", one CPU cell) or "data=D,graph=G"; None = one device.
    # A tcp:// engine host owns its own mesh.
    engine_mesh: Optional[str] = None
    engine_token: Optional[str] = None  # bearer token for tcp:// endpoints
    # tcp:// transport security (reference remote-endpoint flag shape:
    # --spicedb-insecure / --spicedb-skip-verify-ca / --spicedb-ca-path,
    # options.go:325-369): TLS with full verification is the DEFAULT;
    # plaintext requires the explicit opt-out
    engine_insecure: bool = False
    engine_ca_file: Optional[str] = None  # custom CA (default: system)
    engine_skip_verify_ca: bool = False
    engine_client_cert_file: Optional[str] = None  # mutual-TLS client pair
    engine_client_key_file: Optional[str] = None
    # verification/SNI name when dialing an address that isn't the cert's
    # name (e.g. tcp://10.0.0.5:50051 with a DNS-named certificate)
    engine_server_name: Optional[str] = None
    bootstrap_files: list = field(default_factory=list)
    bootstrap_content: Optional[str] = None  # yaml text
    rule_files: list = field(default_factory=list)
    rule_content: Optional[str] = None
    # upstream kube-apiserver — three resolution modes, first match wins
    # (reference RestConfigFunc, options.go:223-263): explicit URL flags,
    # a kubeconfig file (honoring current-context / --kubeconfig-context),
    # or the in-cluster service-account environment
    upstream_url: Optional[str] = None
    upstream_token: Optional[str] = None
    upstream_ca_file: Optional[str] = None
    upstream_client_cert: Optional[str] = None
    upstream_client_key: Optional[str] = None
    upstream_insecure: bool = False
    kubeconfig: Optional[str] = None
    kubeconfig_context: Optional[str] = None
    # an injected upstream callable overrides the URL (embedding/tests)
    upstream: Optional[object] = None
    # serving
    bind_host: str = "127.0.0.1"
    bind_port: int = 8443
    # TLS serving (reference secure-serving, server.go:164-202): cert+key
    # enable HTTPS; a client CA additionally enables client-certificate
    # authentication (CN -> user, O -> groups, authn.go:40-47) and makes
    # X-Remote-* identity headers trusted ONLY from cert-bearing peers
    tls_cert_file: Optional[str] = None
    tls_key_file: Optional[str] = None
    tls_client_ca_file: Optional[str] = None
    # CNs of cert-authenticated FRONT PROXIES allowed to assert end-user
    # identity via X-Remote-* headers (kube --requestheader-allowed-names)
    tls_requestheader_allowed_names: list = field(default_factory=list)
    # kube static token file (token,user,uid[,groups]) for Bearer authn
    token_auth_file: Optional[str] = None
    # OIDC bearer authentication (kube --oidc-* option names; the last of
    # the reference's four built-in authn modes, authn.go:40-47)
    oidc_issuer_url: Optional[str] = None
    oidc_client_id: Optional[str] = None
    oidc_username_claim: str = "sub"
    oidc_username_prefix: Optional[str] = None  # "-" disables prefixing
    oidc_groups_claim: Optional[str] = None
    oidc_groups_prefix: str = ""
    oidc_ca_file: Optional[str] = None
    oidc_signing_algs: str = "RS256"  # comma-separated
    # repeatable key=value pairs every token must carry verbatim
    oidc_required_claims: list = field(default_factory=list)
    # dual-write. None resolves to <data_dir>/dtx.sqlite when a data dir
    # is configured (durable dual-writes live WITH the durable store),
    # else the historical default — an explicit path always wins
    workflow_database_path: Optional[str] = None
    lock_mode: str = LOCK_MODE_PESSIMISTIC
    # relationship-store snapshot: loaded at boot when the file exists,
    # saved on graceful shutdown (in-process engines only)
    snapshot_path: Optional[str] = None
    # durable persistence (persistence/): write-ahead log + snapshot
    # checkpoints + crash recovery under this directory. Unset = the
    # in-memory store (today's behavior; every existing test).
    # In-process engines only — a tcp:// engine host owns its own disk.
    data_dir: Optional[str] = None
    wal_fsync: str = "interval:100"  # always | interval:<ms> | off
    checkpoint_wal_bytes: int = 64 << 20
    checkpoint_wal_records: int = 50_000
    checkpoint_keep: int = 2
    # >0 coalesces concurrent list prefilters into fused device dispatches
    # (seconds of added latency traded for per-dispatch amortization)
    lookup_batch_window: float = 0.0
    # revision-keyed decision cache + singleflight on the authorization
    # hot path (engine/decision_cache.py): repeats at an unchanged store
    # revision serve host-side with zero device dispatches. In-process
    # engines only (a tcp:// engine host caches on the host; pass the
    # same flags there). Default ON; --authz-cache=false restores the
    # byte-identical uncached behavior.
    authz_cache: bool = True
    authz_cache_size: int = 65536  # max cached decisions (LRU entries)
    authz_cache_mask_bytes: int = 256 << 20  # resident lookup-mask budget
    # device-resident delta overlay (ops/reachability.py): fixed overlay
    # capacity per compiled graph (fixed at compile — appends
    # never re-specialize) and the occupancy fraction that wakes the
    # background compactor (engine/compaction.py). 0 threshold disables
    # compaction: overlay overflow then falls back to a synchronous
    # recompile on the next fully-consistent read. In-process engines
    # only — a tcp:// engine host owns its own overlay (same flags there).
    delta_capacity: int = 4096
    compact_threshold: float = 0.75
    # tiered graph storage (storage/, docs/operations.md "Tiered graph
    # storage"): device byte budget for resident dense blocks. 0 =
    # classic all-resident placement; > 0 keeps hot blocks on device
    # under the cap, parks cold ones in host arenas, and streams them
    # into dispatches on demand. Emulatable on CPU (the budget gates
    # the same placement bookkeeping). In-process engines only.
    device_graph_budget_bytes: int = 0
    # request caveat context (caveats/, docs/operations.md "Caveats &
    # conditional grants"): forward caller attributes (client IP from
    # the trusted header below — last XFF hop — user, verb/resource) to the engine so
    # conditional grants resolve per request; off = request-dependent
    # caveats fail closed (tuple-context-only caveats still evaluate)
    caveat_context: bool = True
    caveat_ip_header: str = "x-forwarded-for"
    # live schema migration (migration/): a schema-DSL file to migrate
    # the serving engine(s) to at boot, with no downtime — diff
    # classification (a typed refusal for incompatible changes),
    # dual-compile, journaled backfill of affected tuples, and an
    # atomic cutover at a revision. Sharded deployments coordinate the
    # cut across every group; progress rides /readyz as
    # `migration: phase=... lag=...`.
    migrate_schema: Optional[str] = None
    # /debug/config stays 404 unless explicitly enabled — even a sanitized
    # topology dump is opt-in, not default-on
    enable_debug_config: bool = False
    # "Name=true,Other=false" over utils/features.py gates
    feature_gates: Optional[str] = None
    # API discovery caching (reference disk-cached RESTMapper discovery,
    # server.go:228-243): TTL in seconds; a directory makes it survive
    # restarts. 0 disables caching.
    discovery_cache_ttl: float = 600.0
    discovery_cache_dir: Optional[str] = None
    # -- dependency resilience (utils/resilience.py) -------------------------
    # per-attempt connect budget and per-request total deadline for the
    # upstream kube-apiserver (deadline 0 = unlimited; it covers watch
    # ESTABLISHMENT only, never the long-lived frame stream)
    upstream_connect_timeout: float = 5.0
    upstream_request_deadline: float = 30.0
    # transport retries for idempotent upstream requests (GET/HEAD) that
    # failed before a status line arrived; writes are never retried
    upstream_retries: int = 1
    # tcp:// engine endpoints: per-attempt connect budget, TOTAL
    # response budget per call (shared across retries, so a stalled host
    # stalls a handler for at most this long), and transport retries for
    # read ops (check/lookup/revision — never relationship writes)
    engine_connect_timeout: float = 10.0
    engine_read_timeout: float = 300.0
    engine_retries: int = 2
    # circuit breakers (one for the upstream, one per engine endpoint):
    # consecutive transport failures to open, and how long an open
    # circuit waits before admitting a half-open probe
    breaker_failure_threshold: int = 5
    breaker_reset_seconds: float = 10.0
    # layered retry budgets (utils/resilience.RetryBudget): ONE token
    # bucket per dependency stack — the upstream gets its own, and a
    # single shared bucket spans the whole engine client stack
    # (RemoteEngine transport retries, FailoverEngine re-aims, planner
    # scatter re-issues), so a shard brownout is bounded to
    # burst + ratio × attempts total retries instead of
    # N_layers × N_retries × attempts (metastable-failure guard).
    # ratio = tokens deposited per first attempt; burst = bucket cap.
    # ratio 0 with a huge burst approximates unbudgeted retries.
    retry_budget_ratio: float = 0.1
    retry_budget_burst: float = 20.0
    # -- admission control (admission/) --------------------------------------
    # cost-classed, per-tenant (= authenticated user) fair queueing with
    # an adaptive concurrency limit and priority load shedding in front
    # of every engine-bound request; shed requests get the fail-closed
    # kube 503 + Retry-After. Off by default (today's behavior).
    admission: bool = False
    admission_initial_concurrency: float = 32.0
    admission_min_concurrency: float = 4.0
    admission_max_concurrency: float = 512.0
    admission_tenant_rate: float = 50.0  # fair-share refill, cost units/s
    admission_tenant_burst: float = 100.0  # per-tenant debt cap
    admission_tenant_queue_depth: int = 32
    admission_queue_depth: int = 256  # global bound; lowest priority sheds
    admission_queue_timeout: float = 1.0  # max queue wait before shedding
    # -- observability (obs/) ------------------------------------------------
    # request tracing (obs/trace.py): tail-sampling keep probability for
    # ordinary traces — error/shed/slow traces are ALWAYS kept. 0
    # disables tracing entirely (no spans recorded, /debug/traces 404s).
    trace_sample: float = 0.1
    # traces at or above this request duration are always kept, and a
    # slow-request log line is emitted
    trace_slow_ms: float = 250.0
    # recent-trace ring capacity served by /debug/traces
    trace_ring: int = 256
    # /debug/traces stays 404 unless explicitly enabled (same posture as
    # /debug/config: traces name other subjects' requests and timings)
    enable_debug_traces: bool = False
    # decision audit log (obs/audit.py): file path or "stderr"; None =
    # no audit. One JSON line per authorization decision — denies
    # always, allows rate-capped at audit_allow_rps lines/second.
    audit_log: Optional[str] = None
    audit_allow_rps: float = 10.0
    # live SLO monitor (obs/slo.py): "class=latency_ms:target_pct" list
    # ("check=25:99.9,lookup=100:99"); None = monitor off unless
    # enable_debug_slo turns it on with the default objective set.
    # Burn rates are computed over slo_windows (seconds), sampled every
    # slo_tick_seconds, exposed as slo_* metrics and (flag-gated,
    # authenticated) at /debug/slo.
    slo_objectives: Optional[str] = None
    slo_windows: str = "60,300,3600"
    slo_tick_seconds: float = 5.0
    enable_debug_slo: bool = False
    # -- scale-out sharding (scaleout/) --------------------------------------
    # explicit versioned shard map: inline JSON or a path to a JSON file
    # ({"version": 1, "groups": [["h:p", "h:p"], ["h:p"]]}). When set,
    # the proxy builds a scatter-gather planner over the named engine
    # groups (each group an endpoint list = its own failover set) and
    # --engine-endpoint must stay at its in-process default (the planner
    # IS the engine client). Tuples partition by (namespace, resource-
    # type) consistent hashing; global (cluster-scoped) tuples replicate
    # to every group. Each group's host owns its device, so --device is
    # refused beside --shard-map.
    shard_map: Optional[str] = None
    # durable cross-shard split-write journal (dtx-style); None lands it
    # beside the workflow DB. A mid-split crash replays to completion on
    # the next boot.
    shard_journal_path: Optional[str] = None
    # vector-keyed client-side decision cache: entries key by the full
    # per-shard revision vector, never serve after ANY component
    # advances, and are TTL-bounded (the planner cannot see the
    # engine-side expiration/caveat verdict-flip watermarks). Off by
    # default — it only helps when every write flows through THIS
    # proxy replica (the per-group host-side caches stay exact
    # regardless).
    shard_cache: bool = False
    # online rebalance (scaleout/rebalance.py): a TARGET shard map
    # (inline JSON or path, same grammar as --shard-map) with a HIGHER
    # version. On boot the planner starts the live tuple mover — plan /
    # copy / catch-up / dual-write / per-slice cutover / GC — taking
    # the fleet from the current map to this one with no drain;
    # progress rides /readyz as `rebalance: moving=K copied=J lag=...`.
    rebalance_to: Optional[str] = None
    # -- elastic scale-out (autoscale/, scaleout/frontier.py) ----------------
    # SLO-driven autoscaler: "off" (default), "dry-run" (proposals are
    # counted and surfaced on /readyz, nothing moves), or "apply"
    # (proposals drive REAL grow/shrink map transitions through the
    # rebalance coordinator). Requires --shard-map.
    autoscale: str = "off"
    # policy knobs as key=value CSV (autoscale/policy.py parse_policy),
    # e.g. "max_groups=6,grow_occupancy=0.7"; None = all defaults
    autoscale_policy: Optional[str] = None
    autoscale_tick_seconds: float = 15.0
    # cross-shard frontier exchange (scaleout/frontier.py): lifts the
    # cluster-scoped-only restriction on cross-namespace reference
    # types by iterating boundary-frontier rounds instead of
    # replicating tuples; fail-closed after frontier_max_rounds
    frontier_exchange: bool = False
    frontier_max_rounds: int = 8

    def _parse_remote(self) -> Optional[list[tuple[str, int]]]:
        """[(host, port), ...] for tcp:// endpoints, None otherwise;
        raises on a malformed endpoint. A COMMA-SEPARATED list
        (``tcp://h1:p1,h2:p2`` — repeating the tcp:// prefix is
        tolerated) names a replicated engine set with automatic
        client-side leader failover (engine/remote.py FailoverEngine)."""
        if not self.engine_endpoint.startswith(REMOTE_ENDPOINT_PREFIX):
            return None
        stripped = ",".join(
            p.strip()[len(REMOTE_ENDPOINT_PREFIX):]
            if p.strip().startswith(REMOTE_ENDPOINT_PREFIX) else p.strip()
            for p in self.engine_endpoint.split(","))
        try:
            return parse_endpoints(stripped)
        except EndpointError:
            raise OptionsError(
                f"invalid engine endpoint {self.engine_endpoint!r} "
                "(expected tcp://host:port[,host2:port2,...])") from None

    def validate(self) -> None:
        remote = self._parse_remote()
        if self.shard_map:
            if remote is not None:
                raise OptionsError(
                    "shard-map and a tcp:// engine-endpoint are mutually "
                    "exclusive: the shard map names every group's "
                    "endpoints itself")
            for bad, why in (
                    (self.bootstrap_files or self.bootstrap_content,
                     "bootstrap"),
                    (self.snapshot_path, "snapshot-path"),
                    (self.data_dir, "data-dir"),
                    (self.lookup_batch_window > 0, "lookup-batch-window"),
                    (self.device is not None, "device"),
                    (self.engine_mesh, "engine-mesh")):
                if bad:
                    raise OptionsError(
                        f"{why} applies to in-process engines; with "
                        "--shard-map each engine group owns its own")
            from ..scaleout import ShardMapError, load_shard_map

            try:
                smap = load_shard_map(self.shard_map)
            except ShardMapError as e:
                raise OptionsError(str(e)) from None
            if self.rebalance_to:
                try:
                    target = load_shard_map(self.rebalance_to)
                except ShardMapError as e:
                    raise OptionsError(
                        f"rebalance-to: {e}") from None
                if target.version <= smap.version:
                    raise OptionsError(
                        f"rebalance-to map version {target.version} "
                        f"must exceed the current shard-map version "
                        f"{smap.version}")
                if target.n_groups < smap.n_groups - 1:
                    raise OptionsError(
                        "rebalance-to can retire at most ONE group per "
                        "map version: group indices are identity across "
                        "a transition, and a shrink drains + GCs the "
                        "retiring tail group before commit — chain "
                        "single-group shrinks to go further")
                if target.n_groups == smap.n_groups - 1 \
                        and target.groups != smap.groups[:-1]:
                    raise OptionsError(
                        "a shrink map must keep the surviving groups' "
                        "endpoints byte-identical and retire only the "
                        "LAST group (ring points are keyed by group "
                        "index; reordering would silently remap "
                        "untouched slices)")
        elif self.rebalance_to:
            raise OptionsError(
                "rebalance-to requires --shard-map (it is a transition "
                "between two shard maps)")
        if self.autoscale not in ("off", "dry-run", "apply"):
            raise OptionsError(
                f"autoscale must be off, dry-run, or apply "
                f"(got {self.autoscale!r})")
        if self.autoscale != "off" and not self.shard_map:
            raise OptionsError(
                "autoscale requires --shard-map (it proposes and "
                "drives shard-map transitions)")
        if self.autoscale_policy is not None:
            from ..autoscale import AutoscaleError, parse_policy

            try:
                parse_policy(self.autoscale_policy)
            except AutoscaleError as e:
                raise OptionsError(f"autoscale-policy: {e}") from None
        if self.frontier_exchange and not self.shard_map:
            raise OptionsError(
                "frontier-exchange requires --shard-map (it is a "
                "cross-shard join protocol)")
        if self.frontier_max_rounds < 1:
            raise OptionsError("frontier-max-rounds must be >= 1")
        if remote is None:
            if self.engine_endpoint not in (EMBEDDED_ENDPOINT, TPU_ENDPOINT):
                raise OptionsError(
                    f"unsupported engine endpoint {self.engine_endpoint!r} "
                    f"(supported: {EMBEDDED_ENDPOINT}, {TPU_ENDPOINT}, "
                    f"{REMOTE_ENDPOINT_PREFIX}host:port)")
            if not self.shard_map:
                try:
                    resolve_device(self.device)
                except (RuntimeError, ValueError) as e:
                    raise OptionsError(f"device: {e}") from None
        if self.migrate_schema:
            # parse NOW: an unreadable or syntactically-broken target
            # schema must fail option validation, not surface later as
            # a failed migration against a serving engine
            from ..models.schema import SchemaError, parse_schema

            try:
                with open(self.migrate_schema) as f:
                    parse_schema(f.read())
            except OSError as e:
                raise OptionsError(f"migrate-schema: {e}") from None
            except SchemaError as e:
                raise OptionsError(f"migrate-schema: {e}") from None
        if remote and (self.bootstrap_files or self.bootstrap_content):
            raise OptionsError(
                "bootstrap applies to in-process engines; a tcp:// engine "
                "host owns its own bootstrap")
        if remote and self.snapshot_path:
            raise OptionsError(
                "snapshot-path applies to in-process engines; pass it to "
                "the tcp:// engine host instead")
        if remote and self.data_dir:
            raise OptionsError(
                "data-dir applies to in-process engines; pass it to "
                "the tcp:// engine host instead")
        if self.data_dir and self.snapshot_path:
            raise OptionsError(
                "data-dir and snapshot-path are mutually exclusive (the "
                "data dir owns snapshots AND the write-ahead log)")
        if self.data_dir:
            from ..persistence.wal import WalError, parse_fsync_policy

            try:
                parse_fsync_policy(self.wal_fsync)
            except WalError as e:
                raise OptionsError(str(e)) from None
            if self.checkpoint_wal_bytes < 1 \
                    or self.checkpoint_wal_records < 1:
                raise OptionsError(
                    "checkpoint-wal-bytes/records must be >= 1")
            if self.checkpoint_keep < 1:
                raise OptionsError("checkpoint-keep must be >= 1")
        if remote and self.lookup_batch_window > 0:
            raise OptionsError(
                "lookup-batch-window applies to in-process engines; batch "
                "on the tcp:// engine host instead")
        if remote and self.device is not None:
            raise OptionsError(
                "device applies to in-process engines; pass it to the "
                "tcp:// engine host instead")
        if remote and self.engine_mesh:
            raise OptionsError(
                "engine-mesh applies to in-process engines; configure the "
                "mesh on the tcp:// engine host instead")
        if remote is None and not self.shard_map and (
                self.engine_insecure or self.engine_ca_file or
                self.engine_skip_verify_ca or self.engine_client_cert_file
                or self.engine_server_name):
            raise OptionsError(
                "engine-insecure/ca-file/skip-verify-ca/client-cert/"
                "server-name apply only to tcp:// engine endpoints "
                "(or shard-map groups)")
        if self.engine_insecure and (
                self.engine_ca_file or self.engine_skip_verify_ca or
                self.engine_client_cert_file or self.engine_server_name):
            raise OptionsError(
                "engine-insecure (plaintext) excludes the TLS options "
                "(engine-ca-file/skip-verify-ca/client-cert/server-name)")
        if bool(self.engine_client_cert_file) != \
                bool(self.engine_client_key_file):
            raise OptionsError(
                "engine-client-cert-file and engine-client-key-file "
                "must be set together")
        if self.engine_mesh:
            _parse_mesh_spec(self.engine_mesh)  # raises OptionsError
        if self.feature_gates:
            from ..utils.features import FeatureGateError, features

            try:
                features.validate_spec(self.feature_gates)
            except FeatureGateError as e:
                raise OptionsError(str(e)) from None
        if self.lock_mode not in (LOCK_MODE_PESSIMISTIC, LOCK_MODE_OPTIMISTIC):
            raise OptionsError(f"invalid lock mode {self.lock_mode!r}")
        if self.upstream_retries < 0 or self.engine_retries < 0:
            raise OptionsError("retry counts must be >= 0")
        if self.upstream_connect_timeout <= 0 \
                or self.engine_connect_timeout <= 0 \
                or self.engine_read_timeout <= 0:
            raise OptionsError("connect/read timeouts must be > 0")
        if self.upstream_request_deadline < 0:
            raise OptionsError(
                "upstream-request-deadline must be >= 0 (0 = unlimited)")
        if self.breaker_failure_threshold < 1:
            raise OptionsError("breaker-failure-threshold must be >= 1")
        if self.breaker_reset_seconds < 0:
            raise OptionsError("breaker-reset-seconds must be >= 0")
        if self.retry_budget_ratio < 0:
            raise OptionsError("retry-budget-ratio must be >= 0")
        if self.retry_budget_burst < 1:
            raise OptionsError("retry-budget-burst must be >= 1")
        if self.admission:
            from ..admission import validate_config

            try:
                # ONE owner for the bounds, shared with the engine-host
                # CLI so the two flag surfaces can never drift
                validate_config(
                    self.admission_initial_concurrency,
                    self.admission_min_concurrency,
                    self.admission_max_concurrency,
                    self.admission_tenant_rate,
                    self.admission_tenant_burst,
                    self.admission_tenant_queue_depth,
                    self.admission_queue_depth,
                    self.admission_queue_timeout)
            except ValueError as e:
                raise OptionsError(str(e)) from None
        if not 0.0 <= self.trace_sample <= 1.0:
            raise OptionsError("trace-sample must be in [0, 1]")
        if self.trace_slow_ms < 0:
            raise OptionsError("trace-slow-ms must be >= 0")
        if self.trace_ring < 1:
            raise OptionsError("trace-ring must be >= 1")
        if self.audit_allow_rps <= 0:
            raise OptionsError("audit-allow-rps must be > 0")
        if self.slo_objectives:
            from ..obs.slo import SLOError, parse_objectives

            try:
                parse_objectives(self.slo_objectives)
            except SLOError as e:
                raise OptionsError(str(e)) from None
        if self.slo_objectives or self.enable_debug_slo:
            try:
                windows = [float(w) for w in
                           self.slo_windows.split(",") if w.strip()]
            except ValueError:
                windows = []
            if not windows or any(w <= 0 for w in windows):
                raise OptionsError(
                    "slo-windows must be a comma list of seconds > 0")
            if self.slo_tick_seconds <= 0:
                raise OptionsError("slo-tick-seconds must be > 0")
            if self.slo_tick_seconds > min(windows):
                raise OptionsError(
                    "slo-tick-seconds must not exceed the shortest "
                    "slo-window (a window sampled less than once per "
                    "span would be blind)")
        if self.authz_cache_size < 1:
            raise OptionsError("authz-cache-size must be >= 1")
        if self.authz_cache_mask_bytes < 0:
            raise OptionsError("authz-cache-mask-bytes must be >= 0")
        from ..engine.compaction import validate_overlay_config

        try:
            # ONE owner for the overlay flag bounds, shared with the
            # engine-host CLI
            validate_overlay_config(self.delta_capacity,
                                    self.compact_threshold)
        except ValueError as e:
            raise OptionsError(str(e)) from None
        if self.device_graph_budget_bytes < 0:
            raise OptionsError("device-graph-budget-bytes must be >= 0 "
                               "(0 disables tiered graph storage)")
        if not (self.caveat_ip_header or "").strip():
            raise OptionsError("caveat-ip-header must not be empty "
                               "(set --caveat-context=false to disable "
                               "request context instead)")
        if bool(self.tls_cert_file) != bool(self.tls_key_file):
            raise OptionsError(
                "tls-cert-file and tls-key-file must be set together")
        if self.tls_client_ca_file and not self.tls_cert_file:
            raise OptionsError(
                "tls-client-ca-file requires tls-cert-file/tls-key-file")
        if self.tls_requestheader_allowed_names and \
                not self.tls_client_ca_file:
            raise OptionsError(
                "tls-requestheader-allowed-names requires "
                "tls-client-ca-file")
        if self.oidc_issuer_url and not self.oidc_client_id:
            raise OptionsError("oidc-issuer-url requires oidc-client-id")
        if not self.oidc_issuer_url and (
                self.oidc_required_claims or any(
                    x is not None for x in (
                        self.oidc_client_id, self.oidc_username_prefix,
                        self.oidc_groups_claim, self.oidc_ca_file))):
            raise OptionsError(
                "oidc-* options require oidc-issuer-url")
        for rc in self.oidc_required_claims:
            if "=" not in rc:
                raise OptionsError(
                    f"oidc-required-claim {rc!r} must be key=value")
        if self.oidc_issuer_url:
            from .oidc import OIDCError, parse_signing_algs

            try:
                parse_signing_algs(self.oidc_signing_algs)
            except OIDCError as e:
                raise OptionsError(f"oidc-signing-algs: {e}") from None
        if not (self.rule_files or self.rule_content):
            raise OptionsError("at least one rule file is required")
        if self.upstream_url and self.kubeconfig:
            raise OptionsError(
                "upstream-url and kubeconfig are mutually exclusive")
        if self.kubeconfig_context and not self.kubeconfig:
            raise OptionsError("kubeconfig-context requires kubeconfig")
        if not self.upstream_url and any((
                self.upstream_token, self.upstream_ca_file,
                self.upstream_client_cert, self.upstream_client_key,
                self.upstream_insecure)):
            raise OptionsError(
                "upstream-token/ca-file/client-cert/client-key/insecure "
                "only apply with upstream-url; kubeconfig and in-cluster "
                "modes carry their own credentials")
        if self.upstream is None and not self.upstream_url \
                and not self.kubeconfig:
            from .kubeconfig import in_cluster_available

            if not in_cluster_available():
                raise OptionsError(
                    "an upstream kube-apiserver is required: pass "
                    "--upstream-url or --kubeconfig, or run in-cluster")

    def complete(self) -> "CompletedConfig":
        self.validate()
        if self.feature_gates:
            from ..utils.features import features

            features.apply_spec(self.feature_gates)
        rule_text = "\n---\n".join(
            [open(f).read() for f in self.rule_files]
            + ([self.rule_content] if self.rule_content else []))
        matcher = MapMatcher.from_yaml(rule_text)
        remote = self._parse_remote()
        if remote is not None or self.shard_map:
            from ..engine.remote import FailoverEngine, RemoteEngine

            ssl_context = None
            if not self.engine_insecure:
                from ..utils.tlsconf import (
                    TLSConfigError,
                    client_ssl_context,
                )

                try:
                    ssl_context = client_ssl_context(
                        self.engine_ca_file, self.engine_skip_verify_ca,
                        self.engine_client_cert_file,
                        self.engine_client_key_file)
                except TLSConfigError as e:
                    raise OptionsError(str(e)) from None
            from ..utils.resilience import RetryBudget

            # ONE budget for the WHOLE engine client stack: every
            # group's RemoteEngine/FailoverEngine and the planner's
            # scatter re-issues draw from the same bucket
            engine_budget = RetryBudget(
                "engine-stack", ratio=self.retry_budget_ratio,
                burst=self.retry_budget_burst)
            client_kw = dict(
                ssl_context=ssl_context,
                server_hostname=self.engine_server_name,
                connect_timeout=self.engine_connect_timeout,
                timeout=self.engine_read_timeout,
                retries=self.engine_retries,
                breaker_failure_threshold=self.breaker_failure_threshold,
                breaker_reset_seconds=self.breaker_reset_seconds,
                retry_budget=engine_budget)
            if self.shard_map:
                # scale-out (scaleout/): one client per engine GROUP
                # (multi-endpoint groups get client-side leader
                # failover), a scatter-gather planner in front, and a
                # durable split-write journal beside the workflow DB
                from ..scaleout import (
                    ShardedEngine,
                    ShardMapError,
                    ShardVectorCache,
                    SplitJournal,
                    load_shard_map,
                )

                try:
                    # validate() parsed this already, but the file can
                    # change between the two reads — the second load
                    # must fail as cleanly as the first
                    smap = load_shard_map(self.shard_map)
                except ShardMapError as e:
                    raise OptionsError(str(e)) from None
                def group_client(eps):
                    if len(eps) == 1:
                        return RemoteEngine(*eps[0],
                                            token=self.engine_token,
                                            **client_kw)
                    return FailoverEngine(list(eps),
                                          token=self.engine_token,
                                          **client_kw)

                groups = [group_client(eps) for eps in smap.groups]
                journal_path = self.shard_journal_path
                if journal_path is None:
                    import os as _osj

                    base = self.workflow_database_path \
                        or DEFAULT_WORKFLOW_DB
                    journal_path = _osj.path.join(
                        _osj.path.dirname(_osj.path.abspath(base)),
                        "scaleout-journal.sqlite")
                frontier_cfg = None
                if self.frontier_exchange:
                    from ..scaleout import FrontierConfig

                    frontier_cfg = FrontierConfig(
                        max_rounds=self.frontier_max_rounds)
                engine = ShardedEngine(
                    smap, groups, journal=SplitJournal(journal_path),
                    cache=(ShardVectorCache() if self.shard_cache
                           else None),
                    retry_budget=engine_budget,
                    frontier=frontier_cfg,
                    # lets a persisted mid-rebalance transition
                    # reconstruct clients for groups the target map
                    # ADDED beyond --shard-map at the next boot
                    client_factory=group_client)
                if self.rebalance_to:
                    from ..scaleout import (
                        RebalanceError,
                        ShardMapError as _SME,
                        load_shard_map as _load_target,
                    )

                    try:
                        # validate() parsed this already, but the file
                        # can change between the two reads — the second
                        # load must fail as cleanly as the first
                        target = _load_target(self.rebalance_to)
                    except _SME as e:
                        raise OptionsError(
                            f"rebalance-to: {e}") from None
                    active = engine._active_transition
                    if active is not None:
                        # a persisted transition already resumed at
                        # recovery; the flag must agree with it
                        if active.new_map.version != target.version:
                            raise OptionsError(
                                "rebalance-to names map version "
                                f"{target.version} but a transition to "
                                f"version {active.new_map.version} is "
                                "already in flight")
                    elif target.version <= engine.map.version:
                        # the move already completed (the journal's
                        # durable "done" record made the target map
                        # authoritative at recovery) — re-running it
                        # against the GC'd sources would route the
                        # moved slices to empty groups
                        import logging as _logging

                        _logging.getLogger("sdbkp.options").info(
                            "rebalance-to v%d already completed; "
                            "serving it (update --shard-map and drop "
                            "the flag)", target.version)
                    else:
                        try:
                            engine.begin_rebalance(target)
                        except RebalanceError as e:
                            raise OptionsError(str(e)) from None
            elif len(remote) == 1:
                engine = RemoteEngine(*remote[0],
                                      token=self.engine_token,
                                      **client_kw)
            else:
                # a replicated engine set: route to the current leader,
                # re-resolve on its death (kill-the-leader failover)
                engine = FailoverEngine(remote, token=self.engine_token,
                                        **client_kw)
        else:
            bootstrap = "\n---\n".join(
                [open(f).read() for f in self.bootstrap_files]
                + ([self.bootstrap_content] if self.bootstrap_content else []))
            mesh = None
            if self.engine_mesh:
                from ..parallel.mesh import mesh_from_spec

                try:
                    mesh = mesh_from_spec(self.engine_mesh,
                                          resolve_device(self.device))
                except ValueError as e:  # the axes vs the cards at hand
                    raise OptionsError(
                        f"engine-mesh {self.engine_mesh!r}: {e}") from None
            engine = Engine(bootstrap=bootstrap or None, device=self.device,
                            delta_capacity=self.delta_capacity,
                            device_graph_budget_bytes=(
                                self.device_graph_budget_bytes or None),
                            mesh=mesh)
            logging.getLogger("sdbkp.options").info(
                "engine on %s", engine.device)
            if self.compact_threshold > 0:
                # background overlay folds + overlay-full write
                # back-pressure (engine/compaction.py); 0 restores the
                # synchronous-recompile fallback on overflow
                engine.enable_compaction(self.compact_threshold)
            if self.data_dir:
                engine.enable_persistence(
                    self.data_dir, wal_fsync=self.wal_fsync,
                    checkpoint_wal_bytes=self.checkpoint_wal_bytes,
                    checkpoint_wal_records=self.checkpoint_wal_records,
                    checkpoint_keep=self.checkpoint_keep)
                # boot crash matrix for a live schema migration killed
                # mid-flight (migration/migrator.py): no persisted cut
                # -> clean abort, cut persisted -> finish the cutover
                engine.recover_schema_migration()
            else:
                engine.load_snapshot_if_exists(self.snapshot_path)
            if self.lookup_batch_window > 0:
                engine.enable_lookup_batching(self.lookup_batch_window)
            if self.authz_cache:
                engine.enable_decision_cache(
                    max_entries=self.authz_cache_size,
                    max_mask_bytes=self.authz_cache_mask_bytes)
        if self.migrate_schema:
            # start the live migration once the engine is fully
            # configured (persistence recovered, caches installed):
            # every engine shape takes it — in-process and sharded via
            # begin_schema_migration, a tcp:// host via the wire op. An
            # incompatible change fails BOOT with the typed reasons;
            # the serving engine never saw any state change.
            from ..models.schema import SchemaError as _SchemaErr

            with open(self.migrate_schema) as f:
                _mig_text = f.read()
            # the bootstrap path auto-appends the workflow definitions
            # (models/bootstrap.py): give the migration target the same
            # treatment, or omitting them from the operator's file
            # would falsely classify as "removed definition"
            import re as _re

            from ..models.bootstrap import WORKFLOW_DEFS as _WF

            _missing = [n for n in ("lock", "workflow", "activity")
                        if not _re.search(
                            rf"definition\s+{n}\b", _mig_text)]
            if _missing:
                _mig_text = "\n".join(
                    [_mig_text] + [_WF[n] for n in _missing])
            try:
                if remote is None:
                    engine.begin_schema_migration(_mig_text)
                else:
                    engine.migrate_begin(_mig_text)
            except _SchemaErr as e:
                raise OptionsError(
                    f"migrate-schema: {e}") from None
        upstream = self.upstream
        if upstream is None:
            from ..utils.resilience import RetryBudget as _RB
            from .kubeconfig import UpstreamConfig

            if self.upstream_url:
                uc = UpstreamConfig(
                    url=self.upstream_url,
                    token=self.upstream_token,
                    ca_file=self.upstream_ca_file,
                    client_cert=self.upstream_client_cert,
                    client_key=self.upstream_client_key,
                    insecure_skip_verify=self.upstream_insecure,
                )
            elif self.kubeconfig:
                from .kubeconfig import load_kubeconfig

                uc = load_kubeconfig(self.kubeconfig,
                                     self.kubeconfig_context)
            else:
                from .kubeconfig import in_cluster_config

                uc = in_cluster_config()
            upstream = HttpUpstream(
                uc.url,
                token=uc.token,
                ca_file=uc.ca_file,
                client_cert=uc.client_cert,
                client_key=uc.client_key,
                insecure_skip_verify=uc.insecure_skip_verify,
                connect_timeout=self.upstream_connect_timeout,
                request_deadline=self.upstream_request_deadline,
                retries=self.upstream_retries,
                breaker_failure_threshold=self.breaker_failure_threshold,
                breaker_reset_seconds=self.breaker_reset_seconds,
                retry_budget=_RB("upstream",
                                 ratio=self.retry_budget_ratio,
                                 burst=self.retry_budget_burst),
            )
        # durable dual-writes live with the durable store: an unset path
        # lands the workflow DB inside --data-dir when one is configured
        wf_db = self.workflow_database_path
        if wf_db is None:
            if self.data_dir:
                import os as _os2

                _os2.makedirs(self.data_dir, exist_ok=True)
                wf_db = _os2.path.join(self.data_dir, "dtx.sqlite")
            else:
                wf_db = DEFAULT_WORKFLOW_DB
        workflow = WorkflowEngine(db_path=wf_db)
        register_workflows(workflow)
        ActivityHandler(engine, upstream).register(workflow)
        discovery_cache = None
        if self.discovery_cache_ttl > 0:
            from ..utils.discovery import DiscoveryCache

            discovery_cache = DiscoveryCache(
                ttl=self.discovery_cache_ttl,
                cache_dir=self.discovery_cache_dir)
        # breakers surface on /readyz with per-dependency reasons; an
        # injected upstream/engine without one simply isn't tracked.
        # A sharded planner contributes one breaker PER GROUP (its own
        # clients'), so /readyz names the degraded group
        engine_breakers = [getattr(engine, "breaker", None)]
        for g in getattr(engine, "groups", ()):
            engine_breakers.append(getattr(g, "breaker", None))
        dep_breakers = tuple(
            b for b in ([getattr(upstream, "breaker", None)]
                        + engine_breakers) if b is not None)
        admission = None
        if self.admission:
            from ..admission import AdmissionController

            admission = AdmissionController(
                initial_concurrency=self.admission_initial_concurrency,
                min_concurrency=self.admission_min_concurrency,
                max_concurrency=self.admission_max_concurrency,
                tenant_rate=self.admission_tenant_rate,
                tenant_burst=self.admission_tenant_burst,
                tenant_depth=self.admission_tenant_queue_depth,
                global_depth=self.admission_queue_depth,
                queue_timeout=self.admission_queue_timeout,
                dependency="admission")
        # observability: the tracer is process-global (the engine and
        # remote client record spans through it); configure from flags
        # here, the ONE place serving configuration lands
        from ..obs import AuditLog
        from ..obs.trace import tracer

        tracer.configure(sample=self.trace_sample,
                         slow_ms=self.trace_slow_ms,
                         ring=self.trace_ring)
        audit = None
        if self.audit_log:
            audit = AuditLog(self.audit_log,
                             allow_rps=self.audit_allow_rps)
        slo_monitor = None
        if self.slo_objectives or self.enable_debug_slo:
            from ..obs.slo import (
                SLOMonitor,
                default_objectives,
                parse_objectives,
            )

            objectives = (parse_objectives(self.slo_objectives)
                          if self.slo_objectives else default_objectives())
            slo_monitor = SLOMonitor(
                objectives,
                windows=[float(w) for w in self.slo_windows.split(",")
                         if w.strip()],
                tick_seconds=self.slo_tick_seconds)
            slo_monitor.start()
        autoscale_controller = None
        if self.autoscale != "off" and self.shard_map:
            from ..autoscale import (
                AutoscaleController,
                AutoscalePolicy,
                PolicyConfig,
                parse_policy,
            )

            policy_cfg = (parse_policy(self.autoscale_policy)
                          if self.autoscale_policy else PolicyConfig())
            autoscale_controller = AutoscaleController(
                engine, AutoscalePolicy(policy_cfg),
                mode=self.autoscale,
                slo_monitor=slo_monitor,
                tick_seconds=self.autoscale_tick_seconds)
            autoscale_controller.start()
        deps = AuthzDeps(
            matcher=matcher, engine=engine, upstream=upstream,
            workflow=workflow, default_lock_mode=self.lock_mode,
            discovery_cache=discovery_cache,
            breakers=dep_breakers,
            admission=admission,
            audit=audit,
            caveat_context_enabled=self.caveat_context,
            caveat_ip_header=self.caveat_ip_header,
        )
        ssl_context = None
        if self.tls_cert_file:
            import ssl

            ssl_context = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ssl_context.load_cert_chain(self.tls_cert_file,
                                        self.tls_key_file)
            if self.tls_client_ca_file:
                ssl_context.load_verify_locations(self.tls_client_ca_file)
                # OPTIONAL, not REQUIRED: cert-less clients still reach
                # health endpoints and get clean 401s on resources
                # (kube-apiserver semantics) instead of handshake failures
                ssl_context.verify_mode = ssl.CERT_OPTIONAL
        token_authenticators = []
        if self.token_auth_file:
            from .authn import TokenFileAuthenticator

            token_authenticators.append(
                TokenFileAuthenticator(self.token_auth_file))
        if self.oidc_issuer_url:
            from .oidc import OIDCAuthenticator, parse_signing_algs

            token_authenticators.append(OIDCAuthenticator(
                issuer_url=self.oidc_issuer_url,
                client_id=self.oidc_client_id,
                username_claim=self.oidc_username_claim,
                username_prefix=self.oidc_username_prefix,
                groups_claim=self.oidc_groups_claim,
                groups_prefix=self.oidc_groups_prefix,
                ca_file=self.oidc_ca_file,
                required_claims=dict(
                    rc.split("=", 1) for rc in self.oidc_required_claims),
                signing_algs=parse_signing_algs(self.oidc_signing_algs),
            ))
        token_authenticator = None
        if len(token_authenticators) == 1:
            token_authenticator = token_authenticators[0]
        elif token_authenticators:
            from .oidc import ChainTokenAuthenticator

            token_authenticator = ChainTokenAuthenticator(
                token_authenticators)
        server = Server(deps, HeaderAuthenticator(),
                        host=self.bind_host, port=self.bind_port,
                        config_dump=(self.debug_dump()
                                     if self.enable_debug_config else None),
                        ssl_context=ssl_context,
                        client_ca_configured=bool(self.tls_client_ca_file),
                        requestheader_allowed_names=tuple(
                            self.tls_requestheader_allowed_names),
                        token_authenticator=token_authenticator,
                        enable_debug_traces=self.enable_debug_traces,
                        slo_monitor=slo_monitor,
                        enable_debug_slo=self.enable_debug_slo,
                        autoscale_controller=autoscale_controller)
        return CompletedConfig(self, engine, workflow, deps, server,
                               slo_monitor, autoscale_controller)

    # fields safe to expose on /debug/config — an ALLOWLIST so a future
    # credential-bearing Options field fails safe (omitted) instead of
    # leaking until someone extends a denylist
    _DUMP_FIELDS = (
        "engine_endpoint", "device", "engine_mesh", "bootstrap_files",
        "rule_files",
        "upstream_url", "upstream_insecure", "kubeconfig",
        "kubeconfig_context", "bind_host", "bind_port",
        "workflow_database_path", "lock_mode", "snapshot_path",
        "data_dir", "wal_fsync", "checkpoint_wal_bytes",
        "checkpoint_wal_records", "checkpoint_keep",
        "authz_cache", "authz_cache_size", "authz_cache_mask_bytes",
        "delta_capacity", "compact_threshold",
        "device_graph_budget_bytes",
        "caveat_context", "caveat_ip_header",
        "shard_map", "shard_journal_path", "shard_cache",
        "rebalance_to", "migrate_schema",
        "upstream_connect_timeout", "upstream_request_deadline",
        "upstream_retries", "engine_connect_timeout", "engine_read_timeout",
        "engine_retries", "breaker_failure_threshold",
        "breaker_reset_seconds",
        "retry_budget_ratio", "retry_budget_burst",
        "admission", "admission_initial_concurrency",
        "admission_min_concurrency", "admission_max_concurrency",
        "admission_tenant_rate", "admission_tenant_burst",
        "admission_tenant_queue_depth", "admission_queue_depth",
        "admission_queue_timeout",
        "trace_sample", "trace_slow_ms", "trace_ring",
        "enable_debug_traces", "audit_log", "audit_allow_rps",
        "slo_objectives", "slo_windows", "slo_tick_seconds",
        "enable_debug_slo",
        "autoscale", "autoscale_policy", "autoscale_tick_seconds",
        "frontier_exchange", "frontier_max_rounds",
    )

    def debug_dump(self) -> dict:
        """Secret-free options dump for /debug/config (the reference
        sanitizes via debugmap struct tags, options.go:50-82)."""
        out = {k: getattr(self, k) for k in self._DUMP_FIELDS}
        for k in ("upstream_token", "engine_token"):
            out[k] = "<redacted>" if getattr(self, k) else None
        return out


@dataclass
class CompletedConfig:
    options: Options
    engine: Engine
    workflow: WorkflowEngine
    deps: AuthzDeps
    server: Server
    slo_monitor: Optional[object] = None
    autoscale_controller: Optional[object] = None

    async def run(self) -> None:
        """Start serving: resume pending dual-writes, listen, serve
        (reference Server.Run errgroup, server.go:164-202)."""
        await self.workflow.resume_pending()
        await self.server.start()


def add_flags(parser: argparse.ArgumentParser) -> None:
    """CLI flags (reference AddFlags, options.go:196-207)."""
    parser.add_argument("--engine-endpoint", default=TPU_ENDPOINT,
                        help="embedded:// | tpu:// (the in-process engine "
                             "on --device) "
                             "| tcp://host:port (remote engine host) | "
                             "tcp://h1:p1,h2:p2,... (a replicated engine "
                             "set: requests follow the leader, with "
                             "automatic client-side failover when it "
                             "dies — see docs/operations.md)")
    parser.add_argument("--engine-token",
                        help="bearer token for tcp:// engine endpoints")
    parser.add_argument("--engine-insecure", action="store_true",
                        help="PLAINTEXT TCP to the engine host (token and "
                             "relationships in the clear); TLS with full "
                             "verification is the default")
    parser.add_argument("--engine-ca-file",
                        help="CA bundle for verifying the engine host's "
                             "certificate (default: system trust store)")
    parser.add_argument("--engine-skip-verify-ca", action="store_true",
                        help="TLS to the engine host without certificate "
                             "verification")
    parser.add_argument("--engine-client-cert-file",
                        help="client certificate for mutual TLS to the "
                             "engine host")
    parser.add_argument("--engine-client-key-file",
                        help="client key for mutual TLS to the engine host")
    parser.add_argument("--engine-server-name",
                        help="expected certificate name when dialing an "
                             "address that is not the cert's name")
    parser.add_argument("--bootstrap", action="append", default=[],
                        help="schema/relationships bootstrap YAML (repeatable)")
    parser.add_argument("--rule-file", action="append", default=[],
                        help="ProxyRule YAML file (repeatable)")
    parser.add_argument("--upstream-url", help="upstream kube-apiserver URL")
    parser.add_argument("--kubeconfig",
                        help="kubeconfig file for the upstream connection "
                             "(alternative to --upstream-url; in-cluster "
                             "config is used when neither is given)")
    parser.add_argument("--kubeconfig-context",
                        help="kubeconfig context (default: current-context)")
    parser.add_argument("--upstream-token", help="bearer token for upstream")
    parser.add_argument("--upstream-ca-file")
    parser.add_argument("--upstream-client-cert")
    parser.add_argument("--upstream-client-key")
    parser.add_argument("--upstream-insecure", action="store_true")
    parser.add_argument("--bind-host", default="127.0.0.1")
    parser.add_argument("--bind-port", type=int, default=8443)
    parser.add_argument("--tls-cert-file",
                        help="serving certificate (enables HTTPS)")
    parser.add_argument("--tls-key-file",
                        help="serving certificate private key")
    parser.add_argument("--tls-client-ca-file",
                        help="CA bundle for client-certificate "
                             "authentication (CN -> user, O -> groups)")
    parser.add_argument("--tls-requestheader-allowed-name",
                        action="append", default=[],
                        dest="tls_requestheader_allowed_names",
                        help="cert CN allowed to assert user identity via "
                             "X-Remote-* headers (repeatable; front "
                             "proxies)")
    parser.add_argument("--token-auth-file",
                        help="kube static token file "
                             "(token,user,uid[,\"g1,g2\"]) for Bearer "
                             "authentication")
    parser.add_argument("--oidc-issuer-url",
                        help="OIDC issuer URL; enables bearer-JWT "
                             "authentication against its JWKS")
    parser.add_argument("--oidc-client-id",
                        help="audience the token must be issued for")
    parser.add_argument("--oidc-username-claim", default="sub")
    parser.add_argument("--oidc-username-prefix",
                        help="prefix for OIDC usernames; '-' disables; "
                             "default '<issuer>#' for non-email claims")
    parser.add_argument("--oidc-groups-claim",
                        help="claim carrying the user's groups")
    parser.add_argument("--oidc-groups-prefix", default="")
    parser.add_argument("--oidc-ca-file",
                        help="CA bundle for the issuer's HTTPS endpoints")
    parser.add_argument("--oidc-signing-algs", default="RS256",
                        help="comma-separated accepted JWS algorithms")
    parser.add_argument("--oidc-required-claim", action="append",
                        default=[], dest="oidc_required_claims",
                        help="key=value a token must carry verbatim "
                             "(repeatable)")
    parser.add_argument("--workflow-database-path", default=None,
                        help="dual-write workflow DB (sqlite). Default: "
                             "<data-dir>/dtx.sqlite when --data-dir is "
                             f"set, else {DEFAULT_WORKFLOW_DB}")
    parser.add_argument("--snapshot-path",
                        help="relationship-store snapshot file: loaded at "
                             "boot if present, saved on graceful shutdown "
                             "(superseded by --data-dir, which also "
                             "survives SIGKILL)")
    parser.add_argument("--data-dir",
                        help="durable persistence directory: write-ahead "
                             "log + snapshot checkpoints; crash recovery "
                             "replays the WAL tail at boot. Unset = "
                             "in-memory store. In-process engines only")
    parser.add_argument("--wal-fsync", default="interval:100",
                        help="WAL fsync policy: always | interval:<ms> | "
                             "off (default interval:100)")
    parser.add_argument("--checkpoint-wal-bytes", type=int,
                        default=64 << 20,
                        help="snapshot-checkpoint the store once this "
                             "many WAL bytes accumulate since the last "
                             "checkpoint")
    parser.add_argument("--checkpoint-wal-records", type=int,
                        default=50_000,
                        help="...or this many WAL records, whichever "
                             "comes first")
    parser.add_argument("--checkpoint-keep", type=int, default=2,
                        help="snapshot generations to retain (the WAL is "
                             "pruned only up to the oldest kept one)")
    parser.add_argument("--lookup-batch-window", type=float, default=0.0,
                        help="seconds to hold a list prefilter for fusing "
                             "concurrent lookups into one device dispatch "
                             "(0 disables)")
    parser.add_argument("--authz-cache", type=parse_bool_flag,
                        nargs="?", const=True, default=True,
                        metavar="BOOL",
                        help="revision-keyed decision cache + "
                             "singleflight on the authorization hot "
                             "path: identical checks/lookups at an "
                             "unchanged store revision serve host-side "
                             "with zero device dispatches (default on; "
                             "--authz-cache=false disables; in-process "
                             "engines only — pass the same flags to a "
                             "tcp:// engine host)")
    parser.add_argument("--authz-cache-size", type=int, default=65536,
                        help="max cached decisions (LRU entries, check "
                             "verdicts and lookup masks combined)")
    parser.add_argument("--authz-cache-mask-bytes", type=int,
                        default=256 << 20,
                        help="resident lookup-mask byte budget; the "
                             "cold end evicts past it")
    parser.add_argument("--caveat-context", type=parse_bool_flag,
                        nargs="?", const=True, default=True,
                        help="forward request caveat context (client IP "
                             "from --caveat-ip-header, user, verb, "
                             "resource) to the engine so conditional "
                             "grants resolve per request; =false makes "
                             "request-dependent caveats fail closed "
                             "(default: true)")
    parser.add_argument("--caveat-ip-header", default="x-forwarded-for",
                        help="trusted header carrying the client IP for "
                             "IP-allowlist caveats (LAST hop of a "
                             "comma-separated chain — the one the "
                             "trusted LB appended; default: "
                             "x-forwarded-for)")
    parser.add_argument("--delta-capacity", type=int, default=4096,
                        help="device-resident delta-overlay slots per "
                             "compiled graph (fixed, so writes never "
                             "reallocate); "
                             "size to the write burst one compaction "
                             "interval must absorb (in-process engines "
                             "only; pass the same flag to a tcp:// "
                             "engine host)")
    parser.add_argument("--compact-threshold", type=float, default=0.75,
                        help="overlay-occupancy fraction that wakes the "
                             "background compactor folding the delta "
                             "tail into a fresh base off the write path; "
                             "a full overlay then SHEDS writes with a "
                             "bounded Retry-After instead of stalling a "
                             "read on a synchronous recompile (0 "
                             "disables compaction and restores the "
                             "synchronous fallback)")
    parser.add_argument("--device-graph-budget-bytes", type=int,
                        default=0,
                        help="tiered graph storage: device byte budget "
                             "for resident dense graph blocks. Hot "
                             "blocks stay on device under this cap; "
                             "cold blocks live in host arenas and "
                             "stream into dispatches on demand "
                             "(engine_tier_* metrics). 0 keeps the "
                             "classic all-resident placement "
                             "(in-process engines only)")
    parser.add_argument("--shard-map",
                        help="scale-out: explicit versioned shard map "
                             "(JSON file path or inline JSON: "
                             '{"version":1,"groups":[["h:p","h:p"],'
                             '["h:p"]]}). Each group is its own engine '
                             "failover set; tuples partition by "
                             "(namespace, resource-type) consistent "
                             "hashing, cluster-scoped tuples replicate "
                             "to every group. Mutually exclusive with a "
                             "tcp:// --engine-endpoint and with --device "
                             "(each group's host owns its device)")
    parser.add_argument("--shard-journal-path",
                        help="durable cross-shard split-write journal "
                             "(sqlite); default: scaleout-journal.sqlite "
                             "beside the workflow DB. A mid-split crash "
                             "replays to completion at the next boot")
    parser.add_argument("--shard-cache", type=parse_bool_flag,
                        nargs="?", const=True, default=False,
                        metavar="BOOL",
                        help="vector-keyed client-side decision cache: "
                             "entries key by the full per-shard revision "
                             "vector (never serving after ANY component "
                             "shard advances) plus a short TTL, and — "
                             "lacking the hosts' compiled-caveat "
                             "knowledge — by the FULL request caveat "
                             "context, so hit rates need stable caller "
                             "attributes (default off; per-group "
                             "host-side caches stay exact and context-"
                             "digested regardless)")
    parser.add_argument("--rebalance-to",
                        help="online shard rebalance: a TARGET shard "
                             "map (same grammar as --shard-map, HIGHER "
                             "version). Boot starts the live tuple "
                             "mover — copy / catch-up / dual-write / "
                             "per-slice cutover / GC — migrating to "
                             "the new placement with no drain; "
                             "progress on /readyz as 'rebalance: "
                             "moving=K copied=J lag=...'")
    parser.add_argument("--migrate-schema",
                        help="live schema migration: a schema-DSL file "
                             "to migrate the serving engine(s) to at "
                             "boot with no downtime — classify / "
                             "dual-compile / journaled backfill / "
                             "atomic cut at a revision (incompatible "
                             "changes refuse with typed reasons before "
                             "any state change); progress on /readyz "
                             "as 'migration: phase=... lag=...' (see "
                             "docs/operations.md 'Live schema "
                             "migration')")
    parser.add_argument("--lock-mode", default=LOCK_MODE_PESSIMISTIC,
                        choices=[LOCK_MODE_PESSIMISTIC, LOCK_MODE_OPTIMISTIC])
    parser.add_argument("--enable-debug-config", action="store_true",
                        help="serve the sanitized options dump on "
                             "/debug/config (off by default)")
    parser.add_argument("--device", default=None,
                        help="torch device of the in-process engine "
                             "(default cuda; a missing card is an error, "
                             "never a fallback — pass cpu to run on the "
                             "CPU explicitly)")
    parser.add_argument("--engine-mesh",
                        help="device mesh for the in-process engine: "
                             "'auto' or 'data=D,graph=G' (with --device "
                             "cpu, that many CPU cells; auto: one)")
    parser.add_argument("--feature-gates",
                        help="comma-separated Name=true|false overrides "
                             "(see utils/features.py for known gates)")
    parser.add_argument("--discovery-cache-ttl", type=float, default=600.0,
                        help="API discovery cache TTL seconds (0 disables)")
    parser.add_argument("--discovery-cache-dir",
                        help="persist the discovery cache here so it "
                             "survives restarts")
    parser.add_argument("--upstream-connect-timeout", type=float,
                        default=5.0,
                        help="per-attempt connect budget to the upstream "
                             "kube-apiserver (seconds)")
    parser.add_argument("--upstream-request-deadline", type=float,
                        default=30.0,
                        help="total per-request deadline to the upstream, "
                             "shared across retries; covers watch "
                             "establishment only, not the stream "
                             "(0 = unlimited)")
    parser.add_argument("--upstream-retries", type=int, default=1,
                        help="transport retries for idempotent upstream "
                             "requests (GET/HEAD) that failed before a "
                             "status line; writes are never retried")
    parser.add_argument("--engine-connect-timeout", type=float,
                        default=10.0,
                        help="per-attempt connect budget to a tcp:// "
                             "engine host (seconds)")
    parser.add_argument("--engine-read-timeout", type=float, default=300.0,
                        help="TOTAL per-call response budget to a tcp:// "
                             "engine host, shared across retries "
                             "(generous: the first query after a "
                             "snapshot refresh pays a graph compile)")
    parser.add_argument("--engine-retries", type=int, default=2,
                        help="transport retries for engine READ ops "
                             "(check/lookup/revision); relationship "
                             "writes are never retried")
    parser.add_argument("--breaker-failure-threshold", type=int, default=5,
                        help="consecutive transport failures that open a "
                             "dependency's circuit breaker (fail-fast "
                             "503s + /readyz unready until it half-opens)")
    parser.add_argument("--breaker-reset-seconds", type=float, default=10.0,
                        help="how long an open circuit waits before "
                             "admitting a half-open probe")
    parser.add_argument("--retry-budget-ratio", type=float, default=0.1,
                        help="layered retry budget: tokens deposited per "
                             "first attempt (each retry anywhere in the "
                             "dependency stack — transport retry, "
                             "failover re-aim, scatter re-issue — "
                             "withdraws one), bounding steady-state "
                             "retry amplification")
    parser.add_argument("--retry-budget-burst", type=float, default=20.0,
                        help="layered retry budget: bucket capacity (the "
                             "transient-blip allowance before retries "
                             "are rationed to the ratio)")
    parser.add_argument("--admission", type=parse_bool_flag, nargs="?",
                        const=True, default=False, metavar="BOOL",
                        help="admission control: cost-classed, per-tenant "
                             "(= authenticated user) fair queueing with "
                             "an adaptive concurrency limit and priority "
                             "load shedding in front of every "
                             "engine-bound request; overload sheds as "
                             "fail-closed 503 + Retry-After instead of "
                             "queueing unboundedly (default off; see "
                             "docs/operations.md 'Admission control & "
                             "overload')")
    parser.add_argument("--admission-initial-concurrency", type=float,
                        default=32.0,
                        help="adaptive limiter's starting weighted-cost "
                             "limit (check=1, bulk-check/write=2, "
                             "lookup/watch-recompute=4 units)")
    parser.add_argument("--admission-min-concurrency", type=float,
                        default=4.0,
                        help="floor the limiter never drops below")
    parser.add_argument("--admission-max-concurrency", type=float,
                        default=512.0,
                        help="ceiling the limiter never probes past")
    parser.add_argument("--admission-tenant-rate", type=float,
                        default=50.0,
                        help="per-tenant fair-share refill (cost "
                             "units/s): how fast a tenant's consumed "
                             "device time is forgiven")
    parser.add_argument("--admission-tenant-burst", type=float,
                        default=100.0,
                        help="per-tenant debt cap (cost units a storm "
                             "is remembered for)")
    parser.add_argument("--admission-tenant-queue-depth", type=int,
                        default=32,
                        help="max queued requests per tenant")
    parser.add_argument("--admission-queue-depth", type=int, default=256,
                        help="global queued-request bound; past it the "
                             "lowest-priority class sheds first (watch "
                             "ticks, then lists, then checks; writes "
                             "last)")
    parser.add_argument("--admission-queue-timeout", type=float,
                        default=1.0,
                        help="max seconds a request may queue before it "
                             "is shed (503 + Retry-After, never a hang)")
    parser.add_argument("--trace-sample", type=float, default=0.1,
                        help="request-trace tail-sampling keep "
                             "probability (error/shed/slow traces are "
                             "always kept; 0 disables tracing and "
                             "/debug/traces entirely)")
    parser.add_argument("--trace-slow-ms", type=float, default=250.0,
                        help="requests at or above this duration are "
                             "always kept by tail sampling and logged "
                             "as slow, with their trace id")
    parser.add_argument("--trace-ring", type=int, default=256,
                        help="recent-trace ring capacity served by "
                             "/debug/traces")
    parser.add_argument("--enable-debug-traces", action="store_true",
                        help="serve the recent-trace ring on "
                             "/debug/traces (authenticated; off by "
                             "default — traces name other subjects' "
                             "request paths and timings)")
    parser.add_argument("--audit-log", default=None,
                        metavar="PATH|stderr",
                        help="decision audit log destination: one JSON "
                             "line per authorization decision (denies "
                             "always, allows rate-capped; see "
                             "docs/operations.md for the line schema). "
                             "Unset = no audit log")
    parser.add_argument("--slo-objectives", default=None,
                        help="declared SLOs as class=latency_ms:target_pct "
                             "(comma list, e.g. "
                             "'check=25:99.9,lookup=100:99'); enables the "
                             "live burn-rate monitor and the slo_* metric "
                             "family. Unset + no --enable-debug-slo = "
                             "monitor off")
    parser.add_argument("--slo-windows", default="60,300,3600",
                        help="burn-rate windows in seconds (comma list)")
    parser.add_argument("--slo-tick-seconds", type=float, default=5.0,
                        help="SLO monitor sampling cadence")
    parser.add_argument("--enable-debug-slo", action="store_true",
                        help="serve the (authenticated) /debug/slo "
                             "objective/burn-rate report; implies the "
                             "monitor with default objectives when "
                             "--slo-objectives is unset")
    parser.add_argument("--audit-allow-rps", type=float, default=10.0,
                        help="rate cap for ALLOW audit lines per second "
                             "(denies are never capped)")
    parser.add_argument("--autoscale", default="off",
                        choices=["off", "dry-run", "apply"],
                        help="SLO-driven autoscaler: dry-run counts and "
                             "surfaces grow/shrink proposals on /readyz; "
                             "apply drives real shard-map transitions "
                             "through the rebalance coordinator. "
                             "Requires --shard-map")
    parser.add_argument("--autoscale-policy", default=None,
                        help="policy knobs as key=value CSV, e.g. "
                             "'max_groups=6,grow_occupancy=0.7' "
                             "(autoscale/policy.py; unset = defaults)")
    parser.add_argument("--autoscale-tick-seconds", type=float,
                        default=15.0,
                        help="autoscaler observe/decide cadence")
    parser.add_argument("--frontier-exchange", action="store_true",
                        help="enable cross-shard frontier-exchange joins "
                             "(scaleout/frontier.py): cross-namespace "
                             "reference types resolve by iterating "
                             "boundary frontiers instead of requiring "
                             "cluster-scoped replication. Requires "
                             "--shard-map; monotone schemas only")
    parser.add_argument("--frontier-max-rounds", type=int, default=8,
                        help="fail-closed round budget per frontier "
                             "exchange (exhaustion under-approximates "
                             "the closure: deny/under-list, never "
                             "over-grant)")


def options_from_args(args: argparse.Namespace) -> Options:
    """Options from parsed flags."""
    return Options(
        engine_endpoint=args.engine_endpoint,
        device=args.device,
        engine_mesh=args.engine_mesh,
        engine_token=args.engine_token,
        engine_insecure=args.engine_insecure,
        engine_ca_file=args.engine_ca_file,
        engine_skip_verify_ca=args.engine_skip_verify_ca,
        engine_client_cert_file=args.engine_client_cert_file,
        engine_client_key_file=args.engine_client_key_file,
        engine_server_name=args.engine_server_name,
        bootstrap_files=args.bootstrap,
        rule_files=args.rule_file,
        upstream_url=args.upstream_url,
        kubeconfig=args.kubeconfig,
        kubeconfig_context=args.kubeconfig_context,
        upstream_token=args.upstream_token,
        upstream_ca_file=args.upstream_ca_file,
        upstream_client_cert=args.upstream_client_cert,
        upstream_client_key=args.upstream_client_key,
        upstream_insecure=args.upstream_insecure,
        bind_host=args.bind_host,
        bind_port=args.bind_port,
        tls_cert_file=args.tls_cert_file,
        tls_key_file=args.tls_key_file,
        tls_client_ca_file=args.tls_client_ca_file,
        tls_requestheader_allowed_names=args.tls_requestheader_allowed_names,
        token_auth_file=args.token_auth_file,
        oidc_issuer_url=args.oidc_issuer_url,
        oidc_client_id=args.oidc_client_id,
        oidc_username_claim=args.oidc_username_claim,
        oidc_username_prefix=args.oidc_username_prefix,
        oidc_groups_claim=args.oidc_groups_claim,
        oidc_groups_prefix=args.oidc_groups_prefix,
        oidc_ca_file=args.oidc_ca_file,
        oidc_signing_algs=args.oidc_signing_algs,
        oidc_required_claims=args.oidc_required_claims,
        workflow_database_path=args.workflow_database_path,
        lock_mode=args.lock_mode,
        snapshot_path=args.snapshot_path,
        data_dir=args.data_dir,
        wal_fsync=args.wal_fsync,
        checkpoint_wal_bytes=args.checkpoint_wal_bytes,
        checkpoint_wal_records=args.checkpoint_wal_records,
        checkpoint_keep=args.checkpoint_keep,
        lookup_batch_window=args.lookup_batch_window,
        authz_cache=args.authz_cache,
        authz_cache_size=args.authz_cache_size,
        authz_cache_mask_bytes=args.authz_cache_mask_bytes,
        delta_capacity=args.delta_capacity,
        compact_threshold=args.compact_threshold,
        device_graph_budget_bytes=args.device_graph_budget_bytes,
        caveat_context=args.caveat_context,
        caveat_ip_header=args.caveat_ip_header,
        migrate_schema=args.migrate_schema,
        shard_map=args.shard_map,
        shard_journal_path=args.shard_journal_path,
        shard_cache=args.shard_cache,
        rebalance_to=args.rebalance_to,
        enable_debug_config=args.enable_debug_config,
        feature_gates=args.feature_gates,
        discovery_cache_ttl=args.discovery_cache_ttl,
        discovery_cache_dir=args.discovery_cache_dir,
        upstream_connect_timeout=args.upstream_connect_timeout,
        upstream_request_deadline=args.upstream_request_deadline,
        upstream_retries=args.upstream_retries,
        engine_connect_timeout=args.engine_connect_timeout,
        engine_read_timeout=args.engine_read_timeout,
        engine_retries=args.engine_retries,
        breaker_failure_threshold=args.breaker_failure_threshold,
        breaker_reset_seconds=args.breaker_reset_seconds,
        retry_budget_ratio=args.retry_budget_ratio,
        retry_budget_burst=args.retry_budget_burst,
        admission=args.admission,
        admission_initial_concurrency=args.admission_initial_concurrency,
        admission_min_concurrency=args.admission_min_concurrency,
        admission_max_concurrency=args.admission_max_concurrency,
        admission_tenant_rate=args.admission_tenant_rate,
        admission_tenant_burst=args.admission_tenant_burst,
        admission_tenant_queue_depth=args.admission_tenant_queue_depth,
        admission_queue_depth=args.admission_queue_depth,
        admission_queue_timeout=args.admission_queue_timeout,
        trace_sample=args.trace_sample,
        trace_slow_ms=args.trace_slow_ms,
        trace_ring=args.trace_ring,
        enable_debug_traces=args.enable_debug_traces,
        audit_log=args.audit_log,
        audit_allow_rps=args.audit_allow_rps,
        slo_objectives=args.slo_objectives,
        slo_windows=args.slo_windows,
        slo_tick_seconds=args.slo_tick_seconds,
        enable_debug_slo=args.enable_debug_slo,
        autoscale=args.autoscale,
        autoscale_policy=args.autoscale_policy,
        autoscale_tick_seconds=args.autoscale_tick_seconds,
        frontier_exchange=args.frontier_exchange,
        frontier_max_rounds=args.frontier_max_rounds,
    )
