"""Rules engine: ProxyRule config, template/expression compiler, matcher.

Mirrors the reference's pkg/config/proxyrule (YAML rule schema) and
pkg/rules (compilation of templates/tupleSets/conditions into runnable
rules keyed by (verb, group, version, resource)). The reference embeds two
third-party expression runtimes — Bloblang for templates/tupleSets and CEL
for `if` conditions; here a single host expression language (expr.py)
covers both surfaces.

A copy of the JAX package's ``rules/`` (it holds no JAX), kept here so the
port imports nothing of that package; "the reference" above is the Go
proxy. It runs in front of the port's engine.
"""

from .expr import ExprError, compile_expr, compile_template  # noqa: F401
from .input import RequestInfo, ResolveInput, UserInfo  # noqa: F401
from .proxyrule import (  # noqa: F401
    Match,
    PreFilterSpec,
    PostFilterSpec,
    RuleConfig,
    RuleSpec,
    RuleValidationError,
    StringOrTemplate,
    UpdateSpec,
    parse_rule_configs,
)
from .compile import (  # noqa: F401
    CompileError,
    PostFilter,
    PreFilter,
    RelExpr,
    ResolvedRel,
    RunnableRule,
    TupleSetExpr,
    UpdateSet,
    compile_rule,
)
from .matcher import MapMatcher, RequestMeta  # noqa: F401
