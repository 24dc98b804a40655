"""Device meshes, multi-host execution and replication.

The PyTorch port's counterpart of the JAX package's ``parallel/``:

- ``mesh.py`` / ``sharded.py``: the ``("data", "graph")`` mesh of cells
  (``make_mesh``) and the sharded fixpoint over it (``ShardedGraph``):
  the ``graph`` axis splits the edge tensors and dense blocks of one
  query, joined by MAX each step; the ``data`` axis splits the batch;
- ``multihost.py``: ``init_distributed`` (the ``torch.distributed``
  world a mesh spanning processes joins over), the leader's mirror
  (:class:`MirroredEngine`) and the follower's replay and catch-up;
- ``failover.py``: the ``--peers`` failover set.
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
    init_distributed,
    normalize_check_item,
    parse_distributed_spec,
)
from .mesh import make_mesh
from .sharded import ShardedGraph

__all__ = [
    "FailoverCoordinator", "FailoverError", "LeaderLost",
    "MUTATION_METHODS", "MirroredEngine", "MultiHostError",
    "StaleTermError", "apply_catchup", "apply_mirror_frame",
    "choose_candidate", "decode_check_items", "encode_check_items",
    "ShardedGraph", "fence_term", "follower_loop", "init_distributed",
    "make_mesh", "normalize_check_item", "parse_distributed_spec",
    "parse_peers",
]
