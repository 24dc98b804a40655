"""The port's benchmark: one cell, one seed, one run (see README.md)."""
