"""Engine profiling hooks: kernel builds into the metrics registry.

The counterpart of the JAX package's ``obs/profile.py``. There, XLA's
compile happens inside jax, invisibly to the dispatch path, and a
monitoring listener mirrors each compile event into ``jax_compile_*``.
The port has no XLA: its compile-shaped events are the first-use builds
of its native code, the ``nvcc`` build of each ``csrc/*.cu`` kernel
library (ops/kernels.py) and the ``g++`` build of the host helper
(native/). Each is a one-off cliff of seconds on the first query of a
process, so the listener below counts them into
``engine_kernel_builds_total{source}`` and
``engine_kernel_build_seconds{source}``, and a scrape can attribute a
first-request spike to a build instead of guessing. A build found on
disk already costs nothing and counts nothing.

Graph compiles are counted where they happen (``engine_graph_compiles_
total`` / ``engine_graph_compile_seconds`` in engine/engine.py), not
here.
"""

from __future__ import annotations

import threading

from ..utils.metrics import metrics

_install_lock = threading.Lock()
_installed = False

BUILD_BUCKETS = (0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0,
                 300.0)


def _on_build(source: str, seconds: float) -> None:
    metrics.counter("engine_kernel_builds_total", source=source).inc()
    metrics.histogram("engine_kernel_build_seconds", buckets=BUILD_BUCKETS,
                      source=source).observe(float(seconds))


def install_kernel_build_hook() -> bool:
    """Register the build listener with the kernel and native-helper
    build functions, once per process; True when it is (now or already)
    installed."""
    global _installed
    with _install_lock:
        if _installed:
            return True
        from .. import native
        from ..ops import kernels

        kernels.build_listeners.append(_on_build)
        native.build_listeners.append(_on_build)
        _installed = True
        return True
