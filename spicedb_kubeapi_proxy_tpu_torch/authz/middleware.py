"""The per-request authorization orchestrator.

Mirrors the Go proxy's pkg/authz/authz.go:23-194 (WithAuthorization):

1. build ResolveInput from the authenticated request
2. always-allow API discovery (GET /api, /apis, /openapi, /version —
   authz.go:205-207)
3. match rules on (verb, group, version, resource); none -> 403
4. filter rules by their `if` conditions; none left -> 403
5. run every matching rule's checks as ONE bulk engine query; any
   denial -> 403
6. dispatch:
   - write verbs with an update rule -> durable dual-write workflow
     (≤30s wait), response written from the workflow's KubeResp
   - watch with a prefilter -> filtered watch join
   - list/get with a prefilter -> prefilter overlapped with the upstream
     request, response filtered (lists/tables/single object)
   - list with postfilters -> upstream response recorded and bulk-checked
   - get with postchecks -> checks run after a 2xx upstream response
   - otherwise -> plain reverse proxy
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field
from typing import Optional

from ..dtx.runner import ActivityError, WorkflowEngine, WorkflowTimeout
from ..dtx.workflow import KubeResp, LOCK_MODE_PESSIMISTIC
from ..engine import Engine
from ..engine.remote import EngineInternalError
from ..obs.trace import tracer
from ..proxy.types import ProxyRequest, ProxyResponse, kube_status
from ..utils.metrics import metrics
from ..utils.resilience import DependencyUnavailable
from ..rules.expr import ExprError
from ..rules.input import ResolveInput, UserInfo
from ..rules.matcher import MapMatcher, RequestMeta
from .check import cached_verdict, run_checks
from .filterer import apply_filter
from .lookups import PreFilterError, run_prefilter, single_prefilter
from .postfilter import filter_list_response
from .update import UpdateError, build_workflow_input, single_update_rule
from .watch import filtered_watch

WRITE_VERBS = ("create", "update", "patch", "delete")

ALWAYS_ALLOWED_PREFIXES = ("/api", "/apis", "/openapi", "/version")

WORKFLOW_RESULT_TIMEOUT = 30.0  # reference DefaultWorkflowTimeout

# every fail-closed 503 carries Retry-After in [1, this] seconds: the
# sources (breaker reset windows, admission drain estimates, shard
# partial-shed maxima, overlay fold estimates, leaderless elections)
# each bound their own hint, but the cap holds even if a future source
# forgets — an unbounded Retry-After parks polite clients forever, the
# availability failure mode the chaos invariants treat as fail-open
RETRY_AFTER_CAP_S = 60


@dataclass
class AuthzDeps:
    matcher: MapMatcher
    engine: Engine
    upstream: object  # Upstream callable
    workflow: Optional[WorkflowEngine] = None
    default_lock_mode: str = LOCK_MODE_PESSIMISTIC
    watch_poll_interval: float = 0.05
    # shared watch machinery (one event pump per engine, one allowed-set
    # recompute per (rule, subject) group); created lazily on first watch
    watch_hub: Optional[object] = None
    # TTL/disk cache for the always-allowed discovery paths (reference
    # disk-cached discovery RESTMapper, server.go:228-243); None = every
    # discovery request hits the upstream
    discovery_cache: Optional[object] = None
    # per-dependency circuit breakers (utils/resilience.CircuitBreaker)
    # whose open state makes /readyz report unready with a reason
    breakers: tuple = ()
    # admission controller (admission/controller.py): every engine-bound
    # request acquires a cost-classed, per-tenant fair-queue slot before
    # the check phase; None = unguarded (today's behavior)
    admission: Optional[object] = None
    # decision audit log (obs/audit.py AuditLog): one JSON line per
    # authorization verdict — denies always, allows rate-capped;
    # None = no audit (today's behavior)
    audit: Optional[object] = None
    # request caveat context (caveats/): when enabled, every engine-bound
    # phase carries the caller's attributes (client IP from the trusted
    # header below, user name/groups, verb/resource) so conditional
    # grants — IP allowlists, attribute gates — resolve on-device;
    # missing context fails closed at the engine
    caveat_context_enabled: bool = True
    # the header the proxy trusts for the client IP (set by your LB /
    # ingress; the LAST hop of a comma-separated X-Forwarded-For — the
    # one the trusted proxy appended)
    caveat_ip_header: str = "x-forwarded-for"


def request_caveat_context(info, user, headers: dict,
                           ip_header: str = "x-forwarded-for") -> dict:
    """The request's caveat-context dict: what a caveat expression can
    see about the CALLER. Keys are caveat parameter names (SpiceDB
    passes request context the same way); the engine auto-injects the
    dispatch clock as ``now``. The client IP comes only from the
    configured trusted header — never from unauthenticated ones."""
    ctx: dict = {
        "user": (user.name if user else "") or "",
        "groups": list(user.groups) if user and user.groups else [],
        "verb": info.verb,
        "resource": info.resource,
        "namespace": info.namespace,
        "name": info.name,
    }
    raw = ""
    want = ip_header.lower()
    for k, v in (headers or {}).items():
        if k.lower() == want:
            raw = v
            break
    if raw:
        # LAST hop of a comma-separated chain: standard LBs/ingresses
        # APPEND the address they verified to whatever the client sent,
        # so earlier entries are attacker-controlled — trusting the
        # first hop would let any caller spoof an allowlisted IP with a
        # forged header. (Single-value headers the ingress overwrites,
        # e.g. x-real-ip, are unaffected.) Tolerate a :port suffix.
        hop = raw.split(",")[-1].strip()
        if hop.count(":") == 1 and "." in hop:
            hop = hop.split(":")[0]
        if hop:
            ctx["ip"] = hop
    return ctx


def _audit(deps: AuthzDeps, info, user, *, allow: bool,
           rules=None, reason: str = "",
           cache_hit: Optional[bool] = None) -> None:
    """Write one decision line when auditing is on; never raises into
    the authorization chain (a broken audit sink must not deny or allow
    anything)."""
    a = deps.audit
    if a is None:
        return
    rev = getattr(getattr(deps.engine, "store", None), "revision", None)
    try:
        a.decision(
            allow=allow,
            verb=info.verb,
            resource=info.resource,
            subresource=info.subresource,
            namespace=info.namespace,
            name=info.name,
            subject=(user.name if user else ""),
            groups=(user.groups if user else None),
            rule=(",".join(r.name for r in rules) if rules else None),
            reason=reason,
            cache_hit=cache_hit,
            revision=rev if isinstance(rev, int) else None,
            trace_id=tracer.current_trace_id(),
            stages_us=tracer.stage_micros(),
        )
    except Exception:  # noqa: BLE001 - audit must never break serving
        metrics.counter("audit_write_errors_total").inc()


async def _traced_upstream(deps: AuthzDeps, req: ProxyRequest
                           ) -> ProxyResponse:
    """The ONE upstream call site wrapper: times the kube-apiserver RTT
    as a named child span + histogram and forwards the trace context as
    a W3C ``traceparent`` header so the upstream's own telemetry can
    stitch to ours."""
    t0 = time.perf_counter()
    with tracer.span("upstream") as sp:
        tp = sp.traceparent()
        if tp is not None:
            req.headers = {k: v for k, v in req.headers.items()
                           if k.lower() != "traceparent"}
            req.headers["traceparent"] = tp
        resp = await deps.upstream(req)
        sp.set("status", resp.status)
    metrics.histogram("proxy_upstream_seconds").observe(
        time.perf_counter() - t0)
    return resp


def _always_allowed(req: ProxyRequest) -> bool:
    """API discovery & metadata requests pass through unfiltered
    (authz.go:205-207 allows get on /api, /apis, /openapi/v2)."""
    info = req.request_info
    if info is None:
        return False
    return (not info.is_resource_request
            and info.verb == "get"
            and info.path.startswith(ALWAYS_ALLOWED_PREFIXES))


async def authorize(req: ProxyRequest, deps: AuthzDeps) -> ProxyResponse:
    """The authorization chain, with fail-closed dependency degradation:
    an open circuit breaker, an exhausted deadline, or an engine host
    mid-leader-failover (``NotLeaderError`` / no reachable leader, both
    in the DependencyUnavailable family) — upstream kube or the remote
    GPU engine — maps to a bounded, RETRYABLE kube Status 503 with a
    ``Retry-After`` header. Never a hang (deadlines bound every
    dependency wait) and never a fail-open 200 OR a stale verdict (an
    unanswerable check is a denial-shaped error, mirroring how SpiceDB
    failures surface as retryable statuses in dtx/workflow.py
    kube_conflict_resp; a deposed engine's answers are refused at the
    source by term fencing, parallel/failover.py)."""
    try:
        return await _authorize_inner(req, deps)
    except EngineInternalError as exc:
        # a remote engine host ANSWERED kind="internal" (an exception
        # inside its op handler, including chaos-armed server-side
        # faults). Not a transport failure, so breakers rightly stay
        # closed — but from this request's view the dependency failed:
        # surface the same bounded, RETRYABLE fail-closed 503 as every
        # other dependency failure, not a raw 500 panic (the chaos
        # campaign's never-fail-open invariant requires
        # deny/403/503-with-Retry-After for every injected fault; a
        # 500 with no Retry-After strands polite clients). Scoped to
        # the INTERNAL kind only: auth/proto/frame errors are
        # permanent misconfigurations and must stay loud, not become
        # endlessly-retried "transient" 503s.
        e = DependencyUnavailable("engine-internal", str(exc),
                                  retry_after=1.0)
        tracer.flag("error", str(e))
        return _fail_closed_503(e)
    except DependencyUnavailable as e:
        from ..admission import AdmissionRejected

        # tail sampling always keeps these: a shed (the admission design
        # working) is flagged "shed" — and ONLY shed, so error-trace
        # filters see real failures — while every other fail-closed 503
        # (breaker open, deadline, leaderless engine) flags "error"
        if isinstance(e, AdmissionRejected):
            tracer.flag("shed")
            # sheds never reach a verdict, so the decision audit would
            # otherwise disagree with the trace ring about this request
            # ever existing: emit the rate-capped shed line here, the
            # ONE place every admission rejection funnels through
            if deps.audit is not None:
                try:
                    deps.audit.shed(
                        op_class=e.op_class,
                        tenant=(req.user.name if req.user else ""),
                        verb=(req.request_info.verb
                              if req.request_info else req.method),
                        resource=(req.request_info.resource
                                  if req.request_info else ""),
                        retry_after=e.retry_after,
                        reason=e.reason,
                        trace_id=tracer.current_trace_id())
                except Exception:  # noqa: BLE001 - audit never gates
                    metrics.counter("audit_write_errors_total").inc()
        else:
            tracer.flag("error", str(e))
        return _fail_closed_503(e)


def _fail_closed_503(e: DependencyUnavailable) -> ProxyResponse:
    """The ONE construction of the fail-closed 503: counted per
    dependency, Retry-After clamped to [1, RETRY_AFTER_CAP_S], and
    trace-stamped — every DependencyUnavailable source (and the
    engine-internal wrapper above) funnels through here so a new header
    or a cap change can never miss a branch."""
    metrics.counter("proxy_dependency_unavailable_total",
                    dependency=e.dependency).inc()
    resp = kube_status(
        503, f"dependency {e.dependency} unavailable: {e}",
        "ServiceUnavailable")
    retry_after = e.retry_after if isinstance(
        e.retry_after, (int, float)) else 1.0
    resp.headers["Retry-After"] = str(
        min(RETRY_AFTER_CAP_S, max(1, int(retry_after + 0.5))))
    # these early rejects return BEFORE the root span's normal finish
    # path stamps headers, and some callers (in-memory transports,
    # tests) invoke authorize() without the server's root-span
    # wrapper at all — stamp the trace id HERE so a shed/breaker 503
    # is always followable from the client into /debug/traces
    # (server.handle's setdefault then keeps this value)
    trace_id = tracer.current_trace_id()
    if trace_id is not None:
        resp.headers.setdefault("X-Trace-Id", trace_id)
    return resp


async def _authorize_inner(req: ProxyRequest,
                           deps: AuthzDeps) -> ProxyResponse:
    info = req.request_info
    user = req.user
    if info is None:
        return kube_status(500, "no request info")
    if user is None:
        return kube_status(401, "no user info")

    if _always_allowed(req):
        if deps.discovery_cache is not None:
            return await deps.discovery_cache.serve(req, deps.upstream)
        return await _traced_upstream(deps, req)

    input = ResolveInput.create(info, user, body=req.body or None,
                                headers=req.headers)

    with tracer.span("rule_match") as sp:
        rules = deps.matcher.match(RequestMeta.from_request(info))
        if not rules:
            sp.set("matched", 0)
            _audit(deps, info, user, allow=False,
                   reason="no rule matches the request")
            return kube_status(
                403,
                f"user {user.name!r} cannot {info.verb} {info.resource}",
                "Forbidden")
        try:
            rules = [r for r in rules if r.conditions_pass(input)]
        except ExprError as e:
            return kube_status(500, f"evaluating rule conditions: {e}")
        sp.set("matched", len(rules))
        if not rules:
            _audit(deps, info, user, allow=False,
                   reason="every matching rule's conditions filtered out")
            return kube_status(
                403,
                f"user {user.name!r} cannot {info.verb} {info.resource}",
                "Forbidden")

    # -- request caveat context: the caller attributes conditional grants
    # evaluate against (client IP, user, verb...), extracted ONCE and
    # carried by every engine-bound phase of this request. None when
    # disabled — caveats needing request context then fail closed.
    caveat_ctx = (request_caveat_context(info, user, req.headers,
                                         deps.caveat_ip_header)
                  if deps.caveat_context_enabled else None)

    # -- admission control (admission/): the request is about to touch the
    # engine — acquire a cost-classed slot under the caller's tenant
    # identity FIRST, so one subject's LookupResources storm queues behind
    # its own fair share instead of starving everyone's checks. A shed or
    # timed-out wait raises AdmissionRejected (DependencyUnavailable), and
    # authorize() above turns it into the fail-closed 503 + Retry-After —
    # before any check dispatch, workflow enqueue, or upstream byte.
    if deps.admission is None:
        return await _authorized(req, deps, info, user, input, rules,
                                 caveat_ctx=caveat_ctx)
    from ..admission import classify_request

    with tracer.span("admission_wait") as sp:
        cls = classify_request(info.verb, rules)
        sp.set("class", cls.name)
        # scale-out (scaleout/planner.py): a scatter op touches every
        # shard group, so it is charged once per touched shard — the
        # planner reports the fanout, single-engine deployments have no
        # admission_fanout and stay at 1x
        fanout_of = getattr(deps.engine, "admission_fanout", None)
        if fanout_of is not None:
            fanout = fanout_of(cls)
            if fanout > 1:
                sp.set("shards", fanout)
                cls = cls.scaled(fanout)
        ticket = await deps.admission.acquire_async(
            user.name or "system:anonymous", cls)
    try:
        return await _authorized(req, deps, info, user, input, rules,
                                 ticket, caveat_ctx=caveat_ctx)
    finally:
        # backstop for the paths whose engine work OVERLAPS or FOLLOWS
        # the upstream call (prefilter, postfilter, postchecks): they
        # hold the ticket to here, so their span includes an upstream
        # RTT — the weighted COST accounting is correct (the engine was
        # genuinely busy for part of it) but the duration is not an
        # engine-latency sample, so it must not feed the limiter (one
        # 100ms kube RTT against a ~1ms check baseline would read as
        # massive engine congestion). Engine-only spans released early
        # inside _authorized DO observe; release is idempotent.
        ticket.release(observe=False)


async def _authorized(req: ProxyRequest, deps: AuthzDeps, info, user,
                      input: ResolveInput, rules,
                      ticket=None, caveat_ctx=None) -> ProxyResponse:
    """The engine-bound phases (checks onward). The admission ticket,
    when admission is enabled, is held from the check phase until the
    last engine-bound segment of the request: it is released before
    upstream-dominated tails (a plain proxied read/write, the dual-write
    workflow wait) — holding it there would bill kube-apiserver latency
    to the engine limiter and convert an upstream slowdown into engine
    unavailability. Paths whose engine work OVERLAPS or FOLLOWS the
    upstream call (prefilter, postfilter, postchecks) hold it across."""
    try:
        # non-blocking decision-cache probe first: a full hit answers on
        # the event loop with zero thread handoff (the repeat-heavy
        # serving shape — same rule set, same subject — pays only dict
        # lookups); any miss falls to the to_thread path, which keeps the
        # loop free while the device query's readback is in flight
        # (concurrent requests pipeline their dispatches; the reference
        # fans checks out over goroutines, check.go:77-93)
        with tracer.span("cache_probe") as sp:
            items, verdict = cached_verdict(deps.engine, rules, input,
                                            context=caveat_ctx)
            sp.set("hit", verdict is not None)
        # a fully-cached verdict means this span dispatched NOTHING: its
        # (floor-clamped) duration must not feed the limiter's baseline,
        # or repeat-heavy cache-hit traffic would pin the baseline at the
        # floor and make ordinary device latency read as congestion
        engine_sampled = verdict is None
        if verdict is None:
            with tracer.span("engine_dispatch", items=len(items)):
                verdict = await asyncio.to_thread(
                    run_checks, deps.engine, rules, input, items=items,
                    context=caveat_ctx)
        if not verdict:
            _audit(deps, info, user, allow=False, rules=rules,
                   reason="check denied", cache_hit=not engine_sampled)
            return kube_status(
                403,
                f"user {user.name!r} is not permitted to {info.verb} "
                f"{info.resource} {input.namespaced_name}",
                "Forbidden")
        if not (info.verb == "get" and any(r.post_checks for r in rules)):
            # gets with postchecks aren't decided yet — their audit line
            # is written after the post-upstream checks below
            _audit(deps, info, user, allow=True, rules=rules,
                   reason="checks passed", cache_hit=not engine_sampled)
    except ExprError as e:
        return kube_status(500, f"resolving checks: {e}")

    # -- write path: durable dual-write --------------------------------------
    if info.verb in WRITE_VERBS:
        try:
            update_rule = single_update_rule(rules)
        except UpdateError as e:
            return kube_status(500, str(e))
        if update_rule is not None:
            # fail fast with the 503 + Retry-After family BEFORE durably
            # enqueueing the dual-write when a dependency circuit is
            # hard-open: a BreakerOpen raised inside a workflow activity
            # would be stringified into an ActivityError 502 after
            # burning the workflow's whole retry budget against instant
            # rejections (check_open never consumes the probe slot)
            for b in deps.breakers:
                b.check_open()
            if ticket is not None:
                # the engine-bound part (the admission check) is done;
                # the ≤30s workflow wait is upstream + sqlite time (its
                # own engine writes are gated host-side when remote)
                ticket.release(observe=engine_sampled)
            return await _dual_write(req, deps, update_rule, input)
        if ticket is not None:
            # plain proxied write: no engine work left
            ticket.release(observe=engine_sampled)
        return await _traced_upstream(deps, req)

    # -- watch ----------------------------------------------------------------
    try:
        pf = single_prefilter(rules)
    except PreFilterError as e:
        return kube_status(500, str(e))

    if info.verb == "watch":
        if pf is None:
            if ticket is not None:
                # plain proxied watch: checks are done
                ticket.release(observe=engine_sampled)
            return await _traced_upstream(deps, req)
        if deps.watch_hub is None:
            from .watchhub import WatchHub

            deps.watch_hub = WatchHub(
                deps.engine, poll_interval=deps.watch_poll_interval)
        try:
            upstream_resp = await _traced_upstream(deps, req)
            with tracer.span("watch_join"):
                # establishment only: the trace covers joining the hub
                # and computing the initial allowed set, never the
                # long-lived stream itself
                return await filtered_watch(
                    deps.engine, upstream_resp, pf[1], input,
                    poll_interval=deps.watch_poll_interval,
                    hub=deps.watch_hub)
        except (PreFilterError, ExprError) as e:
            return kube_status(500, f"watch prefilter: {e}")

    # -- read path: prefilter overlap + response filtering --------------------
    post_filters = [p for r in rules for p in r.post_filters]
    # the ONE derivation of which engine-bound tails this request has:
    # the dispatch branches below AND the early-release decision both
    # read these, so a new tail cannot silently escape the admission span
    run_postfilter = bool(post_filters and info.verb == "list")
    run_postchecks = (info.verb == "get"
                      and any(r.post_checks for r in rules))
    prefilter_task = None
    if pf is not None:
        async def _traced_prefilter():
            # ensure_future copies the contextvar context, so the span
            # lands on this request's trace even though the prefilter
            # runs concurrently with the upstream round trip
            with tracer.span("prefilter"):
                return await run_prefilter(deps.engine, pf[1], input,
                                           context=caveat_ctx)

        prefilter_task = asyncio.ensure_future(_traced_prefilter())
    if ticket is not None and prefilter_task is None \
            and not run_postfilter and not run_postchecks:
        # nothing engine-bound overlaps or follows the upstream call:
        # release now so the upstream RTT isn't billed as engine latency
        # (and a fully-cached span isn't billed as an engine sample)
        ticket.release(observe=engine_sampled)
    if run_postfilter:
        # the postfilter resolves rule expressions over each item's JSON
        # object — protobuf list bodies can't feed it, so strip non-JSON
        # ranges from the Accept (keeping JSON ;as=Table form: the
        # postfilter handles Tables). Prefilter paths negotiate protobuf
        # fine (authz/filterer.py).
        from ..proxy.upstream import rewrite_accept

        accept = next((v for k, v in req.headers.items()
                       if k.lower() == "accept"), "")
        req.headers = {k: v for k, v in req.headers.items()
                       if k.lower() != "accept"}
        req.headers["Accept"] = rewrite_accept(accept, watching=False,
                                               json_only=True)
    try:
        resp = await _traced_upstream(deps, req)
    except Exception:
        if prefilter_task:
            prefilter_task.cancel()
        raise
    if prefilter_task is not None:
        try:
            # reference waits ≤10s for the concurrent prefilter
            # (responsefilterer.go:44,196-204)
            allowed = await asyncio.wait_for(prefilter_task, timeout=10.0)
        except asyncio.TimeoutError:
            return kube_status(401, "prefilter timed out")
        except (PreFilterError, ExprError) as e:
            return kube_status(401, f"prefilter: {e}")
        resp = apply_filter(resp, allowed, input)
    if run_postfilter:
        try:
            with tracer.span("postfilter"):
                resp = await asyncio.to_thread(
                    filter_list_response, deps.engine, post_filters,
                    input, resp, caveat_ctx)
        except ExprError as e:
            return kube_status(401, f"postfilter: {e}")

    # -- postchecks (get only; reference shouldRunPostChecks authz.go:211-220)
    if run_postchecks and resp.status >= 300:
        # the deferred audit line (checks passed, allow withheld above)
        # must still be written: the subject WAS allowed through to the
        # upstream, whose error skips the postchecks entirely
        _audit(deps, info, user, allow=True, rules=rules,
               reason=f"checks passed (upstream {resp.status}, "
                      "postchecks skipped)")
    if run_postchecks and resp.status < 300:
        try:
            with tracer.span("postcheck"):
                post_items, post_verdict = cached_verdict(
                    deps.engine, rules, input, post=True,
                    context=caveat_ctx)
                post_cached = post_verdict is not None
                if post_verdict is None:
                    post_verdict = await asyncio.to_thread(
                        run_checks, deps.engine, rules, input, post=True,
                        items=post_items, context=caveat_ctx)
            _audit(deps, info, user, allow=bool(post_verdict),
                   rules=rules,
                   reason=("postchecks passed" if post_verdict
                           else "postcheck denied"),
                   cache_hit=post_cached)
            if not post_verdict:
                return kube_status(
                    403,
                    f"user {user.name!r} is not permitted to {info.verb} "
                    f"{info.resource} {input.namespaced_name}",
                    "Forbidden")
        except ExprError as e:
            return kube_status(500, f"resolving postchecks: {e}")
    return resp


async def _dual_write(req: ProxyRequest, deps: AuthzDeps, rule,
                      input: ResolveInput) -> ProxyResponse:
    """Launch the workflow and wait ≤30s (reference performUpdate/dualWrite,
    update.go:53-195)."""
    if deps.workflow is None:
        return kube_status(500, "no workflow engine configured")
    try:
        wf_input = build_workflow_input(rule, input, req.uri, req.headers)
    except (UpdateError, ExprError) as e:
        return kube_status(500, f"resolving update: {e}")
    mode = rule.locking or deps.default_lock_mode
    with tracer.span("dual_write", mode=mode):
        iid = await deps.workflow.create_instance(mode, wf_input.to_dict())
        try:
            out = await deps.workflow.get_result(
                iid, timeout=WORKFLOW_RESULT_TIMEOUT)
        except WorkflowTimeout:
            return kube_status(504, "dual-write timed out")
        except ActivityError as e:
            return kube_status(502, f"dual-write failed: {e}")
    resp = KubeResp.from_activity(out)
    headers = dict(resp.headers)
    headers["Content-Length"] = str(len(resp.body))
    return ProxyResponse(status=resp.status, headers=headers, body=resp.body)
