"""Device side: the reachability fixpoint, its semiring hop and the CUDA
kernels of the two block hops."""

from .reachability import CompiledGraph, compile_graph  # noqa: F401
