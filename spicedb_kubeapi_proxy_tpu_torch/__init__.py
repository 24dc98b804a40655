"""PyTorch/CUDA port of the relationship-graph engine.

The same slot-space reachability fixpoint as ``spicedb_kubeapi_proxy_tpu``
(the JAX package, which stays the reference), run with PyTorch on an
NVIDIA GPU: its two Pallas TPU kernels are hand-written CUDA kernels
(``csrc/bitprop.cu``), everything else is plain tensor code. The layout
mirrors the JAX package (``models/``, ``engine/``, ``ops/``, ``native/``,
``utils/``, and the proxy in front of the engine: ``rules/``, ``authz/``,
``dtx/``, ``proxy/``) so each module's counterpart is easy to find.

This package imports ``torch`` and ``numpy`` and never ``jax`` or any
module of the JAX package. Entry points run on ``cuda`` unless the
caller passes ``device="cpu"`` (see :mod:`.device`).
"""

import os

# Git-ignored directory (at the repository root) that native helpers and
# CUDA kernels are built into at first use.
BUILD_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "build")
