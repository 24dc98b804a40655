"""Request matcher: (verb, group, version, resource) -> runnable rules.

Mirrors the reference's Matcher/MapMatcher (rules.go:55-117): a hash map
from normalized request meta to the precompiled rules that apply. The
Matcher interface point (a `matcher` attribute the server can swap at
runtime, reference server.go:139-140) is preserved by keeping this a small
class with a `match` method.
"""

from __future__ import annotations

from dataclasses import dataclass

from .compile import RunnableRule, compile_rule
from .input import RequestInfo
from .proxyrule import RuleConfig, parse_rule_configs


@dataclass(frozen=True)
class RequestMeta:
    verb: str
    api_group: str
    api_version: str
    resource: str

    @staticmethod
    def from_request(r: RequestInfo) -> "RequestMeta":
        return RequestMeta(r.verb, r.api_group, r.api_version, r.resource)


def split_group_version(group_version: str) -> tuple[str, str]:
    """'v1' -> ('', 'v1'); 'apps/v1' -> ('apps', 'v1')."""
    if "/" in group_version:
        g, v = group_version.split("/", 1)
        return g, v
    return "", group_version


class MapMatcher:
    def __init__(self, configs: list[RuleConfig]):
        self._rules: dict[RequestMeta, list[RunnableRule]] = {}
        for cfg in configs:
            compiled = compile_rule(cfg)
            for m in cfg.spec.matches:
                group, version = split_group_version(m.group_version)
                for verb in m.verbs:
                    key = RequestMeta(verb, group, version, m.resource)
                    self._rules.setdefault(key, []).append(compiled)

    @staticmethod
    def from_yaml(text: str) -> "MapMatcher":
        return MapMatcher(parse_rule_configs(text))

    def match(self, meta: RequestMeta) -> list[RunnableRule]:
        return self._rules.get(meta, [])
