"""Feature gates: named on/off switches for optional behaviors.

A copy of the JAX package's ``utils/features.py`` registry, with the
gates the port reads:

- ``IncrementalGraphUpdates`` (default on): O(delta) compiled-graph
  updates on write; off forces a full recompile per revision change.
- ``ProtobufNegotiation`` (default on): forward kube-protobuf Accept
  ranges upstream and wire-filter protobuf responses; off rewrites every
  Accept to JSON.
- ``ProtobufWatch`` (default on): let WATCH requests negotiate protobuf
  too (frames pass through filtered and byte-identical); off restores the
  JSON-downgrade rewrite, counted in
  ``proxy_proto_watch_downgrades_total``.

The reference's two kernel gates (``BitKernel``, ``SemiringDenseKernel``)
pick between a Pallas kernel and XLA's plain op; the port's CUDA wrappers
have no such choice on the card, so it does not register them.

Gates are registered with a default, overridable from the CLI
(``--feature-gates Name=true,Other=false``); unknown names are rejected,
so a typo fails boot instead of silently.
"""

from __future__ import annotations

import threading


class FeatureGateError(ValueError):
    pass


class FeatureGates:
    def __init__(self):
        self._lock = threading.Lock()
        self._defaults: dict[str, bool] = {}
        self._overrides: dict[str, bool] = {}

    def register(self, name: str, default: bool) -> None:
        with self._lock:
            self._defaults[name] = default

    def enabled(self, name: str) -> bool:
        with self._lock:
            if name not in self._defaults:
                raise FeatureGateError(f"unknown feature gate {name!r}")
            return self._overrides.get(name, self._defaults[name])

    def set(self, name: str, value: bool) -> None:
        with self._lock:
            if name not in self._defaults:
                raise FeatureGateError(
                    f"unknown feature gate {name!r} "
                    f"(known: {', '.join(sorted(self._defaults))})")
            self._overrides[name] = value

    def validate_spec(self, spec: str) -> list[tuple[str, bool]]:
        """Parse ``Name=true,Other=false`` (CLI form) without applying;
        raises FeatureGateError on syntax errors or unknown names."""
        out = []
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            name, sep, value = part.partition("=")
            if not sep or value.lower() not in ("true", "false"):
                raise FeatureGateError(
                    f"invalid feature gate setting {part!r} "
                    "(expected Name=true|false)")
            name = name.strip()
            with self._lock:
                if name not in self._defaults:
                    raise FeatureGateError(
                        f"unknown feature gate {name!r} "
                        f"(known: {', '.join(sorted(self._defaults))})")
            out.append((name, value.lower() == "true"))
        return out

    def apply_spec(self, spec: str) -> None:
        for name, value in self.validate_spec(spec):
            self.set(name, value)

    def known(self) -> dict[str, bool]:
        with self._lock:
            return {n: self._overrides.get(n, d)
                    for n, d in sorted(self._defaults.items())}

    def reset(self) -> None:
        with self._lock:
            self._overrides.clear()


features = FeatureGates()
features.register("IncrementalGraphUpdates", True)
features.register("ProtobufNegotiation", True)
features.register("ProtobufWatch", True)
