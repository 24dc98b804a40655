"""Seeded random streams: one for each purpose of a run."""

from __future__ import annotations

import zlib

import numpy as np


def seeded_rng(seed: int, purpose: str) -> np.random.Generator:
    """A generator that depends on the run's seed and what it draws for,
    and on nothing else."""
    return np.random.default_rng([int(seed), zlib.crc32(purpose.encode())])
