"""Replication across engine hosts: the mirror and leader failover.

The PyTorch port's counterpart of the JAX package's ``parallel/``, with
only what the port has: the leader's mirror (``multihost.py``:
:class:`MirroredEngine`, the follower's replay and catch-up) and the
``--peers`` failover set (``failover.py``). Device meshes
(``make_mesh``, ``ShardedGraph``) and ``init_distributed`` wait for
ROADMAP A.5's second half.
"""

from .failover import (
    FailoverCoordinator,
    FailoverError,
    choose_candidate,
    parse_peers,
)
from .multihost import (
    MUTATION_METHODS,
    LeaderLost,
    MirroredEngine,
    MultiHostError,
    StaleTermError,
    apply_catchup,
    apply_mirror_frame,
    decode_check_items,
    encode_check_items,
    fence_term,
    follower_loop,
    normalize_check_item,
)

__all__ = [
    "FailoverCoordinator", "FailoverError", "LeaderLost",
    "MUTATION_METHODS", "MirroredEngine", "MultiHostError",
    "StaleTermError", "apply_catchup", "apply_mirror_frame",
    "choose_candidate", "decode_check_items", "encode_check_items",
    "fence_term", "follower_loop", "normalize_check_item", "parse_peers",
]
