"""Zero-downtime live schema migration (a copy of the JAX package's
``migration/``, the port imports nothing of that package).

A schema change made online: diff-classify S -> S', compile the new graph
beside the serving one on the engine's device and under its tier budget,
backfill affected tuples through the journaled write path, and cut at an
unchanged revision with decision-cache and watch continuity. The phase
machine persists before every routing-effect change; ``recover`` resolves
a crashed migration at boot. Records are the reference's format, so a
data dir migrated by either package is resolved by the other.
"""

from .migrator import (  # noqa: F401
    ABORTED,
    BACKFILL,
    COMPILING,
    CUT,
    DONE,
    DUAL,
    FAILED,
    PLANNED,
    SchemaMigrator,
    recover,
    schema_digest,
)
