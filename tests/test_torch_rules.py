"""The rules engine on both packages: ``tests/test_rules.py`` and
``tests/test_rules_matrix.py``'s cases, each run against the JAX package's
``rules/`` and the port's copy.

Every test below is the JAX suite's, word for word, except the three that
read the Go proxy's own ``deploy/rules.yaml`` (absent from this checkout):
they run on the repo's ``deploy/rules.yaml`` here, with its rule names. The autouse ``pkg``
fixture binds this module's names (``compile_expr``, ``MapMatcher``, ...)
to one package's objects for the duration of a test, so each case runs
once per package with the same inputs and the same expected relationships
(tolerance: exact).
"""

import importlib
import json
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# name -> module (under the package) it is imported from
NAMES = {
    "ExprError": ".rules", "MapMatcher": ".rules", "RequestInfo": ".rules",
    "RequestMeta": ".rules", "ResolveInput": ".rules",
    "RuleValidationError": ".rules", "UserInfo": ".rules",
    "compile_expr": ".rules", "compile_template": ".rules",
    "parse_rule_configs": ".rules", "compile_rule": ".rules.compile",
    "CompileError": ".rules.compile", "RuleConfig": ".rules.proxyrule",
    "parse_request_info": ".proxy.requestinfo",
}


@pytest.fixture(autouse=True, params=["spicedb_kubeapi_proxy_tpu",
                                      "spicedb_kubeapi_proxy_tpu_torch"],
                ids=["jax", "port"])
def pkg(request):
    g = globals()
    for name, mod in NAMES.items():
        g[name] = getattr(importlib.import_module(request.param + mod), name)
    yield request.param


def make_input(verb="get", resource="pods", name="nginx", namespace="default",
               user="alice", groups=(), body=None, api_version="v1",
               api_group=""):
    return ResolveInput.create(
        RequestInfo(verb=verb, api_group=api_group, api_version=api_version,
                    resource=resource, name=name, namespace=namespace,
                    path=f"/api/v1/namespaces/{namespace}/{resource}/{name}"),
        UserInfo(name=user, groups=list(groups)),
        body=body,
        headers={"X-Request-Id": "42"},
    )


# ---------------------------------------------------------------------------
# Expression language
# ---------------------------------------------------------------------------


def ev(src, data=None):
    return compile_expr(src).evaluate(data or {})


def test_expr_basics():
    assert ev("1 + 2") == 3
    assert ev("'a' + 'b'") == "ab"
    assert ev('"x" == "x"')
    assert ev("user.name", {"user": {"name": "alice"}}) == "alice"
    assert ev("'system:masters' in user.groups",
              {"user": {"groups": ["system:masters"]}})
    assert ev("a.b.c", {}) is None  # missing chains to null
    assert ev("a.b.c | 'dflt'", {}) == "dflt"
    assert ev("x ? 'y' : 'n'", {"x": True}) == "y"
    assert ev("if x == 2 { 'two' } else { 'other' }", {"x": 2}) == "two"
    assert ev("!(1 == 2)")
    assert ev("[1,2,3].length()") == 3
    assert ev("'a/b'.split('/')") == ["a", "b"]
    assert ev("'AbC'.lowercase()") == "abc"
    assert ev("'ns1/pod1'.startsWith('ns1')")
    assert ev("7.string()") == "7"
    assert ev("has(a.b)", {"a": {"b": 1}})
    assert not ev("has(a.b)", {})


def test_expr_errors():
    with pytest.raises(ExprError):
        ev("1 + 'a'")
    with pytest.raises(ExprError):
        ev("nosuchfn(1)")
    with pytest.raises(ExprError):
        compile_expr("1 +")
    with pytest.raises(ExprError):
        ev("x.map_each(this)", {"x": "notalist"})
    # non-boolean condition
    with pytest.raises(ExprError):
        compile_expr("'str'").evaluate_bool({})


def test_expr_split_functions():
    # the custom Bloblang env functions (reference env.go)
    assert ev("split_name('ns1/pod1')") == "pod1"
    assert ev("split_namespace('ns1/pod1')") == "ns1"
    assert ev("split_name('cluster-scoped')") == "cluster-scoped"
    assert ev("split_namespace('cluster-scoped')") == ""


def test_expr_lambda_capture_let():
    data = {"namespacedName": "default/dep1",
            "object": {"spec": {"template": {"spec": {"containers": [
                {"name": "server"}, {"name": "sidecar"}]}}}}}
    # the reference's flagship tupleSet expression shape (tupleset_test.go:26)
    out = ev('this.namespacedName.(nsName -> this.object.spec.template.spec'
             '.containers.map_each("deployment:" + nsName '
             '+ "#has-container@container:" + this.name))', data)
    assert out == [
        "deployment:default/dep1#has-container@container:server",
        "deployment:default/dep1#has-container@container:sidecar",
    ]
    # filter variant (tupleset_test.go:64)
    out = ev('this.namespacedName.(nsName -> this.object.spec.template.spec'
             '.containers.filter(this.name != "sidecar")'
             '.map_each("deployment:" + nsName + "#c@container:" + this.name))',
             data)
    assert out == ["deployment:default/dep1#c@container:server"]
    # missing list fallback (tupleset_test.go:116)
    out = ev('(this.object.spec.nope | []).map_each(this.name)', data)
    assert out == []
    # let + $var
    out = ev('let ns = this.namespacedName\n$ns + "!"', data)
    assert out == "default/dep1!"
    # bare var reference
    out = ev('let ns = this.namespacedName\nns + "!"', data)
    assert out == "default/dep1!"


def test_expr_if_else_method_style():
    # service ports shape (tupleset_test.go:81)
    data = {"ports": [{"name": "http", "port": 80}, {"port": 9090}]}
    out = ev('ports.map_each(if this.name != null { this.name } '
             'else { this.port.string() })', data)
    assert out == ["http", "9090"]


def test_template_literal_duality():
    # full-wrap => expression; otherwise literal (reference rules.go:1005-1026)
    assert compile_template("{{user.name}}").evaluate(
        {"user": {"name": "bob"}}) == "bob"
    assert compile_template("literal").evaluate({}) == "literal"
    assert compile_template("$").evaluate({}) == "$"
    assert compile_template("{{}}").evaluate({}) == ""
    assert compile_template("{{split_namespace(resourceId)}}").evaluate(
        {"resourceId": "ns9/p"}) == "ns9"


# ---------------------------------------------------------------------------
# ResolveInput
# ---------------------------------------------------------------------------


def test_resolve_input_namespace_normalization():
    # namespaces resource: namespace field cleared (reference rules.go:331-333)
    i = ResolveInput.create(
        RequestInfo(verb="get", resource="namespaces", name="ns1",
                    namespace="ns1"),
        UserInfo(name="u"))
    assert i.name == "ns1" and i.namespace == "" and i.namespaced_name == "ns1"

    # object metadata preferred over request (create with body)
    body = json.dumps({"metadata": {"name": "frombody", "namespace": "nsb"},
                       "kind": "Pod"}).encode()
    i2 = ResolveInput.create(
        RequestInfo(verb="create", resource="pods", namespace="nsr"),
        UserInfo(name="u"), body=body)
    assert i2.name == "frombody"
    assert i2.namespace == "nsb"
    assert i2.namespaced_name == "nsb/frombody"
    assert i2.object["metadata"]["name"] == "frombody"

    d = i2.template_data()
    assert d["metadata"]["name"] == "frombody"
    assert d["resourceId"] == "nsb/frombody"
    c = i2.condition_data()
    assert c["resourceNamespace"] == "nsb"


# ---------------------------------------------------------------------------
# Rule config parsing + compilation (the repo's deploy/rules.yaml; the
# JAX suite reads the Go proxy's own file, which this checkout lacks)
# ---------------------------------------------------------------------------

DEPLOY_RULES = open(os.path.join(REPO, "deploy", "rules.yaml")).read()


def test_parse_deploy_rules():
    cfgs = parse_rule_configs(DEPLOY_RULES)
    assert len(cfgs) == 8
    byname = {c.name: c for c in cfgs}
    cn = byname["namespace-create"]
    assert cn.spec.locking == "Pessimistic"
    assert cn.spec.update.creates
    assert not cn.spec.update.precondition_does_not_exist
    lw = byname["pod-list-watch"]
    assert lw.spec.pre_filters[0].from_object_id_namespace_expr
    # all of them compile
    for c in cfgs:
        compile_rule(c)


def test_deploy_rule_end_to_end_resolution():
    cfgs = {c.name: compile_rule(c) for c in parse_rule_configs(DEPLOY_RULES)}
    # pod-get check template resolution
    i = make_input(verb="get", resource="pods", name="nginx",
                   namespace="default", user="alice")
    rels = cfgs["pod-get"].checks[0].generate(i)
    assert str(rels[0]) == "pod:default/nginx#view@user:alice"
    # namespace-create update resolution
    i2 = ResolveInput.create(
        RequestInfo(verb="create", resource="namespaces", name="",
                    namespace=""),
        UserInfo(name="admin"),
        body=json.dumps({"metadata": {"name": "newns"}}).encode())
    upd = cfgs["namespace-create"].update
    assert [str(r) for r in upd.creates[0].generate(i2)] == \
        ["namespace:newns#creator@user:admin"]
    # pod-create: two creates from one namespaced body
    i4 = ResolveInput.create(
        RequestInfo(verb="create", resource="pods", namespace="team"),
        UserInfo(name="bob"),
        body=json.dumps({"metadata": {"name": "p"}}).encode())
    assert [str(r) for c in cfgs["pod-create"].update.creates
            for r in c.generate(i4)] == [
        "pod:team/p#namespace@namespace:team", "pod:team/p#creator@user:bob"]
    # prefilter: lookup rel has $ resource id
    pf = cfgs["pod-list-watch"].pre_filters[0]
    i3 = make_input(verb="list", resource="pods", name="", namespace="")
    rel = pf.rel.generate(i3)[0]
    assert rel.resource_id == "$"
    assert rel.subject_id == "alice"
    # name/namespace mapping expressions
    assert pf.name_expr.evaluate({"resourceId": "ns1/p1"}) == "p1"
    assert pf.namespace_expr.evaluate({"resourceId": "ns1/p1"}) == "ns1"


def test_tupleset_rule():
    cfg = parse_rule_configs("""
apiVersion: authzed.com/v1alpha1
kind: ProxyRule
metadata:
  name: deployment-containers
match:
- apiVersion: apps/v1
  resource: deployments
  verbs: ["create"]
update:
  creates:
  - tupleSet: >-
      this.namespacedName.(nsName -> this.object.spec.template.spec.containers.map_each("deployment:" + nsName + "#has-container@container:" + this.name))
""")[0]
    r = compile_rule(cfg)
    body = json.dumps({
        "metadata": {"name": "dep1", "namespace": "default"},
        "spec": {"template": {"spec": {"containers": [
            {"name": "server"}, {"name": "cfg"}]}}},
    }).encode()
    i = ResolveInput.create(
        RequestInfo(verb="create", resource="deployments", namespace="default",
                    api_group="apps", api_version="v1"),
        UserInfo(name="u"), body=body)
    rels = r.update.creates[0].generate(i)
    assert [str(x) for x in rels] == [
        "deployment:default/dep1#has-container@container:server",
        "deployment:default/dep1#has-container@container:cfg",
    ]


def test_if_conditions():
    cfg = parse_rule_configs("""
apiVersion: authzed.com/v1alpha1
kind: ProxyRule
metadata:
  name: cond
match:
- apiVersion: v1
  resource: pods
  verbs: ["get"]
if:
- "request.verb == 'get'"
- "'system:masters' in user.groups"
- "resourceNamespace == 'default'"
check:
- tpl: "pod:{{namespacedName}}#view@user:{{user.name}}"
""")[0]
    r = compile_rule(cfg)
    assert r.conditions_pass(make_input(groups=["system:masters"]))
    assert not r.conditions_pass(make_input(groups=["other"]))
    assert not r.conditions_pass(make_input(groups=["system:masters"],
                                            namespace="kube-system"))


def test_matcher():
    m = MapMatcher.from_yaml(DEPLOY_RULES)
    got = m.match(RequestMeta("get", "", "v1", "pods"))
    assert [r.name for r in got] == ["pod-get"]
    assert m.match(RequestMeta("deletecollection", "", "v1", "pods")) == []
    assert m.match(RequestMeta("get", "apps", "v1", "deployments")) == []
    got = m.match(RequestMeta("watch", "", "v1", "namespaces"))
    assert [r.name for r in got] == ["namespace-list-watch"]


def test_structured_relationship_template():
    cfg = parse_rule_configs("""
apiVersion: authzed.com/v1alpha1
kind: ProxyRule
metadata:
  name: structured
match:
- apiVersion: v1
  resource: pods
  verbs: ["get"]
check:
- resource:
    type: pod
    id: "{{namespacedName}}"
    relation: view
  subject:
    type: group
    id: eng
    relation: member
""")[0]
    r = compile_rule(cfg)
    rel = r.checks[0].generate(make_input())[0]
    assert str(rel) == "pod:default/nginx#view@group:eng#member"
    assert rel.subject_relation == "member"


@pytest.mark.parametrize("yaml_text,msg", [
    ("kind: ProxyRule\napiVersion: authzed.com/v1alpha1\nmetadata: {name: x}\n",
     "match is required"),
    ("""
kind: ProxyRule
apiVersion: authzed.com/v1alpha1
metadata: {name: x}
match:
- apiVersion: v1
  resource: pods
  verbs: ["frobnicate"]
""", "invalid verb"),
    ("""
kind: ProxyRule
apiVersion: authzed.com/v1alpha1
metadata: {name: x}
match:
- apiVersion: v1
  resource: pods
  verbs: ["list"]
postcheck:
- tpl: "a:b#c@d:e"
""", "postcheck is incompatible"),
    ("""
kind: ProxyRule
apiVersion: authzed.com/v1alpha1
metadata: {name: x}
match:
- apiVersion: v1
  resource: pods
  verbs: ["get"]
check:
- tpl: "a:b#c@d:e"
  tupleSet: "['x']"
""", "mutually exclusive"),
    ("""
kind: NotARule
metadata: {name: x}
match:
- apiVersion: v1
  resource: pods
  verbs: ["get"]
""", "unsupported kind"),
])
def test_rule_validation_errors(yaml_text, msg):
    with pytest.raises(RuleValidationError, match=msg):
        parse_rule_configs(yaml_text)


def test_review_regressions_expr():
    # .or() absorbs missing/null receivers
    assert ev('object.metadata.labels["team"].or("unowned")',
              {"object": {"metadata": {"labels": {}}}}) == "unowned"
    assert ev('x.or("d")', {"x": "real"}) == "real"
    # runtime type errors are recoverable ExprErrors, caught by `|`
    assert ev("int(request.name) | 0", {"request": {"name": "abc"}}) == 0
    with pytest.raises(ExprError):
        ev("request.name.length()", {"request": {"name": 5}})


def test_namespace_subresources_requestinfo():
    from spicedb_kubeapi_proxy_tpu.proxy.requestinfo import parse_request_info
    i = parse_request_info("PUT", "/api/v1/namespaces/default/finalize")
    assert (i.resource, i.name, i.subresource, i.namespace) == \
        ("namespaces", "default", "finalize", "")
    i2 = parse_request_info("GET", "/api/v1/namespaces/default/pods")
    assert (i2.resource, i2.namespace, i2.verb) == ("pods", "default", "list")


# -- the matrix suite (tests/test_rules_matrix.py) ------------------------


def _input(verb="create", resource="namespaces", name="dev", ns="",
           user="alice", groups=(), body=None):
    import json as _json

    path = f"/api/v1/{resource}" if not ns else \
        f"/api/v1/namespaces/{ns}/{resource}"
    if verb in ("get", "delete", "update", "patch"):
        path += f"/{name}"
    info = parse_request_info(
        "POST" if verb == "create" else "GET", path, {})
    info.verb = verb
    if body is None and verb == "create":
        # creates resolve the name from the object body, like the reference
        meta = {"name": name}
        if ns:
            meta["namespace"] = ns
        body = {"metadata": meta}
    return ResolveInput.create(
        info, UserInfo(name=user, groups=list(groups)),
        body=(_json.dumps(body).encode() if body is not None else None),
        headers={})


def _rule(yaml_text):
    return compile_rule(parse_rule_configs(yaml_text)[0])


# -- rel-string template parsing (TestParseRelString shape) ------------------

REL_OK = [
    # literal fields
    ("ns:dev#viewer@user:alice", ("ns", "dev", "viewer", "user", "alice", "")),
    # userset subject
    ("ns:dev#viewer@group:eng#member",
     ("ns", "dev", "viewer", "group", "eng", "member")),
    # templates in every position
    ("ns:{{name}}#viewer@user:{{user.name}}",
     ("ns", "dev", "viewer", "user", "alice", "")),
    # slash-joined namespaced name
    ("pod:{{namespacedName}}#creator@user:{{user.name}}",
     None),  # checked separately below
]


@pytest.mark.parametrize("tpl,want", REL_OK[:3])
def test_rel_template_positions(tpl, want):
    rule = _rule(f"""
match: [{{apiVersion: v1, resource: namespaces, verbs: [create]}}]
check: [{{tpl: "{tpl}"}}]
""")
    got = rule.checks[0].generate(_input())[0]
    assert (got.resource_type, got.resource_id, got.resource_relation,
            got.subject_type, got.subject_id, got.subject_relation) == want


def test_rel_template_namespaced_name():
    rule = _rule("""
match: [{apiVersion: v1, resource: pods, verbs: [create]}]
check: [{tpl: "pod:{{namespacedName}}#creator@user:{{user.name}}"}]
""")
    got = rule.checks[0].generate(
        _input(resource="pods", ns="team-a", name="api",
               body={"metadata": {"name": "api", "namespace": "team-a"}}))[0]
    assert got.resource_id == "team-a/api"


@pytest.mark.parametrize("bad", [
    "ns:dev#viewer",          # no subject
    "ns:dev@user:alice",      # no relation
    "#viewer@user:alice",     # no resource
    "ns:dev#viewer@user:alice#a#b",  # double subject relation
])
def test_rel_template_malformed(bad):
    with pytest.raises((CompileError, RuleValidationError)):
        _rule(f"""
match: [{{apiVersion: v1, resource: namespaces, verbs: [create]}}]
check: [{{tpl: "{bad}"}}]
""")


def test_literal_fields_allow_kube_identifier_charsets():
    # service-account subjects carry ':'; label-derived relations carry
    # '.'/'/'; both must flow through literal-field validation (review
    # regression: the structural check must reject only '#'/'@' leaks)
    from spicedb_kubeapi_proxy_tpu.models.tuples import parse_rel_fields
    f = parse_rel_fields(
        "ns:x#admin@user:system:serviceaccount:default:builder")
    assert f["subject_id"] == "system:serviceaccount:default:builder"
    f = parse_rel_fields("pod:t/api#label-app.kubernetes.io/name@user:a")
    assert f["relation"] == "label-app.kubernetes.io/name"


def test_empty_resolved_field_is_an_error():
    rule = _rule("""
match: [{apiVersion: v1, resource: namespaces, verbs: [create]}]
check: [{tpl: "ns:{{object.metadata.labels.missing}}#v@user:{{user.name}}"}]
""")
    with pytest.raises(ExprError, match="empty|null"):
        rule.checks[0].generate(_input(body={"metadata": {"name": "dev"}}))


# -- validation matrix (rule_test.go TestValidation shape) -------------------

@pytest.mark.parametrize("doc,msg", [
    ("match: []\ncheck: [{tpl: 'a:b#c@d:e'}]", "match is required"),
    ("match: [{apiVersion: v1, resource: r}]", "needs verbs"),
    ("match: [{apiVersion: v1, verbs: [get]}]", "needs apiVersion and resource"),
    ("match: [{apiVersion: v1, resource: r, verbs: [frobnicate]}]",
     "invalid verb"),
    ("match: [{apiVersion: v1, resource: r, verbs: [get]}]\n"
     "check: [{tpl: 'a:b#c@d:e', tupleSet: 'x'}]", "mutually exclusive"),
    ("match: [{apiVersion: v1, resource: r, verbs: [get]}]\ncheck: [{}]",
     "is required"),
    ("match: [{apiVersion: v1, resource: r, verbs: [get]}]\n"
     "lock: Sometimes", "invalid lock mode"),
    ("match: [{apiVersion: v1, resource: r, verbs: [list]}]\n"
     "postcheck: [{tpl: 'a:b#c@d:e'}]", "incompatible with verbs"),
    ("match: [{apiVersion: v1, resource: r, verbs: [get]}]\n"
     "prefilter: [{lookupMatchingResources: {tpl: 'a:$#c@d:e'}}]",
     "fromObjectIDNameExpr"),
    ("apiVersion: wrong/v9\n"
     "match: [{apiVersion: v1, resource: r, verbs: [get]}]",
     "unsupported apiVersion"),
])
def test_validation_matrix(doc, msg):
    with pytest.raises(RuleValidationError, match=msg):
        parse_rule_configs(doc)


def test_multi_doc_parse_and_empty_docs():
    docs = parse_rule_configs("""
---
match: [{apiVersion: v1, resource: a, verbs: [get]}]
check: [{tpl: "a:{{name}}#v@user:{{user.name}}"}]
---
# empty doc skipped
---
metadata: {name: second}
match: [{apiVersion: apps/v1, resource: b, verbs: [list]}]
""")
    assert len(docs) == 2
    assert docs[1].name == "second"


# -- matcher (TestMapMatcherMatch shape) -------------------------------------

def test_matcher_group_version_and_verb_dispatch():
    m = MapMatcher.from_yaml("""
metadata: {name: core-get}
match: [{apiVersion: v1, resource: pods, verbs: [get, list]}]
---
metadata: {name: apps}
match: [{apiVersion: apps/v1, resource: deployments, verbs: [get]}]
---
metadata: {name: wide}
match: [{apiVersion: v1, resource: pods, verbs: [get]}]
""")
    get_pods = m.match(RequestMeta("get", "", "v1", "pods"))
    assert sorted(r.name for r in get_pods) == ["core-get", "wide"]
    assert [r.name for r in m.match(RequestMeta("list", "", "v1", "pods"))] \
        == ["core-get"]
    assert [r.name for r in
            m.match(RequestMeta("get", "apps", "v1", "deployments"))] \
        == ["apps"]
    # wrong group/version/verb -> no match
    assert m.match(RequestMeta("get", "apps", "v2", "deployments")) == []
    assert m.match(RequestMeta("delete", "", "v1", "pods")) == []


# -- tupleSets ---------------------------------------------------------------

def test_tupleset_generates_per_label_and_validates_items():
    rule = _rule("""
match: [{apiVersion: v1, resource: pods, verbs: [create]}]
check:
  - tupleSet: >-
      object.metadata.labels.keys().map_each(
        "pod:" + namespacedName + "#label-" + this + "@user:" + user.name)
""")
    body = {"metadata": {"name": "api", "namespace": "t",
                         "labels": {"a": "1", "b": "2"}}}
    rels = rule.checks[0].generate(
        _input(resource="pods", ns="t", name="api", body=body))
    assert sorted(r.resource_relation for r in rels) == ["label-a", "label-b"]

    bad = _rule("""
match: [{apiVersion: v1, resource: pods, verbs: [create]}]
check: [{tupleSet: "['not-a-relationship']"}]
""")
    with pytest.raises(ExprError, match="item 0"):
        bad.checks[0].generate(_input(resource="pods"))

    notalist = _rule("""
match: [{apiVersion: v1, resource: pods, verbs: [create]}]
check: [{tupleSet: "user.name"}]
""")
    with pytest.raises(ExprError, match="list"):
        notalist.checks[0].generate(_input(resource="pods"))


def test_tupleset_rejected_where_single_rel_required():
    with pytest.raises(CompileError, match="not allowed here"):
        _rule("""
match: [{apiVersion: v1, resource: pods, verbs: [delete]}]
update:
  deleteByFilter: [{tupleSet: "['a:b#c@d:e']"}]
""")


# -- if conditions -----------------------------------------------------------

def test_if_conditions_matrix():
    rule = _rule("""
match: [{apiVersion: v1, resource: pods, verbs: [create]}]
if:
  - 'user.name == "alice" || "admins" in user.groups'
  - 'request.verb == "create"'
check: [{tpl: "pod:{{name}}#create@user:{{user.name}}"}]
""")
    assert rule.conditions_pass(_input(resource="pods", user="alice"))
    assert rule.conditions_pass(
        _input(resource="pods", user="bob", groups=("admins",)))
    assert not rule.conditions_pass(_input(resource="pods", user="bob"))


def test_if_condition_non_boolean_rejected():
    rule = _rule("""
match: [{apiVersion: v1, resource: pods, verbs: [create]}]
if: ['user.name']
""")
    with pytest.raises(ExprError, match="bool"):
        rule.conditions_pass(_input(resource="pods"))


# -- structured templates -----------------------------------------------------

def test_input_conversion_matrix():
    """Input → evaluation-data conversion parity with the reference's
    TestConvertToBloblangInput matrix (rules_test.go:1755-2003): user
    extra fields, groups, multi-value headers, the resourceId alias,
    nested object metadata merge, and the empty/missing edge cases."""
    from spicedb_kubeapi_proxy_tpu.rules.input import (
        RequestInfo,
        ResolveInput,
        UserInfo,
    )

    # basic input with user extra fields + multi-value headers
    inp = ResolveInput(
        name="test-pod", namespace="default",
        namespaced_name="default/test-pod",
        request=RequestInfo(verb="create", api_group="v1", api_version="v1",
                            resource="pods", name="test-pod",
                            namespace="default"),
        user=UserInfo(name="test-user", uid="uid123",
                      groups=["group1", "group2"],
                      extra={"department": ["engineering", "security"],
                             "role": ["admin"],
                             "project": ["alpha", "beta", "gamma"]}),
        headers={"Authorization": "Bearer token123",
                 "X-Custom": "value1"},
        object=None, body=None,
    )
    d = inp.template_data()
    assert d["name"] == "test-pod"
    assert d["namespacedName"] == "default/test-pod"
    assert d["resourceId"] == "default/test-pod"  # alias, same value
    assert d["request"]["verb"] == "create"
    assert d["request"]["apiGroup"] == "v1"
    assert d["user"]["uid"] == "uid123"
    assert d["user"]["groups"] == ["group1", "group2"]
    assert d["user"]["extra"]["project"] == ["alpha", "beta", "gamma"]
    assert d["headers"]["Authorization"] == "Bearer token123"
    # CEL-shape: namespace spelled resourceNamespace (rules.go:467-518)
    c = inp.condition_data()
    assert c["resourceNamespace"] == "default"
    assert c["user"]["extra"]["role"] == ["admin"]

    # object metadata with nested structure: metadata hoisted beside object
    inp2 = ResolveInput(
        name="cm", namespace="ns1", namespaced_name="ns1/cm",
        request=RequestInfo(verb="create", resource="configmaps",
                            namespace="ns1"),
        user=UserInfo(name="u"),
        headers={},
        body=None,
        object={"metadata": {"name": "cm",
                             "labels": {"env": "prod", "team": "platform"},
                             "annotations": {"a/b": "c"}},
                "data": {"k": "v"}},
    )
    d2 = inp2.template_data()
    assert d2["metadata"]["labels"]["env"] == "prod"
    assert d2["object"]["data"]["k"] == "v"
    # expressions traverse the merged shape
    from spicedb_kubeapi_proxy_tpu.rules.expr import compile_template
    assert compile_template(
        "{{metadata.labels.team}}").evaluate(d2) == "platform"

    # empty extra/headers and a user with no groups
    inp3 = ResolveInput(
        name="x", namespace="", namespaced_name="x",
        request=RequestInfo(verb="get", resource="namespaces", name="x"),
        user=UserInfo(name="solo", extra={}),
        headers={},
        object=None, body=None,
    )
    d3 = inp3.template_data()
    assert d3["user"]["extra"] == {}
    assert d3["user"]["groups"] == []
    assert d3["headers"] == {}
    assert d3["resourceId"] == "x"  # cluster-scoped: no namespace prefix


def test_structured_template_round_trip():
    rule = _rule("""
match: [{apiVersion: v1, resource: namespaces, verbs: [create]}]
update:
  creates:
    - resource: {type: namespace, id: "{{name}}", relation: creator}
      subject: {type: user, id: "{{user.name}}"}
    - resource: {type: namespace, id: "{{name}}", relation: viewer}
      subject: {type: group, id: devs, relation: member}
""")
    rels = [r.generate(_input())[0] for r in rule.update.creates]
    assert str(rels[0]) == "namespace:dev#creator@user:alice"
    assert str(rels[1]) == "namespace:dev#viewer@group:devs#member"
