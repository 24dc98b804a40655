"""The yardstick of the kernels: the card's published peaks and what the
inputs of one launch need to move.

Each count is what the launch's inputs need, from the block's shape and
the live frontier, whatever the kernel's layout: a later kernel that
reads less cannot make the count stale, and one that reads more shows as
a lower share. Each input byte is counted once, each output byte once.
"""

from __future__ import annotations

# NVIDIA H100 SXM (80 GB HBM3), the data sheet's dense rates at 700 W
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15


def bound_s(n_bytes: float, n_ops: float = 0.0) -> float:
    """The least time: the larger of bytes over the memory's rate and
    operations over the int8 peak."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / INT8_OPS_PER_S)


def bit_hop_bytes(n_dst: int, k_words: int, n_b: int, live_words: int) -> int:
    """One push hop over a bit-packed block [n_dst, k_words] (int32
    words, bit s of word w an edge from source 32w + s) for ``n_b``
    frontier rows with ``live_words`` words live in any of them: every
    destination row's live words, the frontier's rows, one output byte a
    (row, destination)."""
    return n_dst * live_words * 4 + n_b * k_words * 4 + n_b * n_dst


def dense_hop_bytes(n_dst: int, n_src: int, batch: int,
                    live_cols: int) -> int:
    """One pull hop over a dense int8 block [n_dst, n_src] for ``batch``
    frontier rows with ``live_cols`` source columns live in any of them:
    those columns of every destination row, the frontier, the output."""
    return n_dst * live_cols + batch * n_src + batch * n_dst


def dense_hop_ops(n_dst: int, batch: int, live_cols: int) -> int:
    """Multiply-adds of the live columns, two operations each."""
    return 2 * batch * n_dst * live_cols
