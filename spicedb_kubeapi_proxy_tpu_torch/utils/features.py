"""Feature gates: named on/off switches for optional behaviors.

A copy of the JAX package's ``utils/features.py`` registry, with the one
gate the port's engine reads:

- ``IncrementalGraphUpdates`` (default on): O(delta) compiled-graph
  updates on write; off forces a full recompile per revision change.

Gates are registered with a default and overridden by name with
``set``; unknown names are rejected, so a typo fails loudly instead of
silently. The ``Name=true,Other=false`` spec parsing comes with the
entry point that has a flag to parse.
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

    def reset(self) -> None:
        with self._lock:
            self._overrides.clear()


features = FeatureGates()
features.register("IncrementalGraphUpdates", True)
