"""Tiered graph storage: HBM-hot / host-cold block arenas.

A copy of the JAX package's ``storage/__init__.py`` (the port imports nothing
of that package).

The compiled graph's dense/level blocks are the residency unit. Hot
blocks keep their device arrays under an explicit byte budget
(``--device-graph-budget-bytes``); cold blocks live in host RAM as npz
arenas in the ``persistence/codec.py`` format (or on disk, mmapped, when
a spill directory is configured) and stream onto the device on frontier
demand. ``TierStore`` owns the placement bookkeeping and every
``engine_tier_*`` metric family; ``ColdArena`` owns the cold bytes;
``Prefetcher`` owns the double-buffered stream-in window.
"""

from .arena import ColdArena
from .prefetch import Prefetcher
from .tiers import TierStore

__all__ = ["ColdArena", "Prefetcher", "TierStore"]
