"""Durable persistence for the relationship store.

A copy of the JAX package's ``persistence/__init__.py`` (the port imports nothing
of that package).

Three cooperating pieces (see each module's docstring):

- :mod:`.wal`      — segmented, CRC32-framed write-ahead log of logical
                     store mutations with configurable fsync policy
- :mod:`.snapshot` — background checkpointer: atomic columnar snapshots
                     + WAL pruning behind a retention window
- :mod:`.recovery` — boot-time restore: newest valid snapshot (falling
                     back on corruption) + WAL tail replay with
                     torn-tail truncation and revision-monotonicity
                     enforcement

:class:`.manager.Persistence` is the façade an engine enables with
``--data-dir``; :mod:`.codec` is the shared binary columnar codec (WAL
bulk-load frames, mirror bulk-load frames, follower full-state
catch-up).
"""

from .codec import decode_bulk_cols, encode_bulk_cols
from .manager import Persistence, load_term, store_term
from .recovery import RecoveryError, RecoveryResult, recover
from .snapshot import Checkpointer, list_snapshots, write_snapshot
from .wal import WalError, WriteAheadLog, parse_fsync_policy

__all__ = [
    "Checkpointer",
    "Persistence",
    "RecoveryError",
    "RecoveryResult",
    "WalError",
    "WriteAheadLog",
    "decode_bulk_cols",
    "encode_bulk_cols",
    "list_snapshots",
    "load_term",
    "parse_fsync_policy",
    "recover",
    "store_term",
    "write_snapshot",
]
