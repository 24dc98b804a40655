"""Masked boolean-semiring SpMM: the one propagation primitive.

Counterpart of the JAX package's ``ops/semiring.py``. One reachability
hop is ``prop[b, d] = OR_e [dst(e)=d] (V[b, src(e)] AND act(e))`` with
``act(e) = (exp(e) > now) AND cav_ok[cav(e)]`` (the caveat VM's verdict
for the edge's instance row); residual and delta-overlay edges ride a
gather + scatter, dense blocks ride one of two CUDA kernels (ops/bitprop.py):

- **push** — the bit-packed block dual through ``bit_or_matmul``, for
  batches of at most ``BIT_B_MAX`` rows;
- **pull** — the dense int8 block through ``dense_or_matmul``.

The reference picks push or pull per hop with a traced ``lax.cond`` on
the frontier occupancy. PyTorch has no traced branch, so the choice is
made on the host: the fixpoint (ops/reachability._run) reads the
occupancy count in the same device-to-host copy as its convergence flag
and passes the resulting ``use_push`` here. The counting (``is_push``)
and the forced modes follow the reference exactly.
"""

from __future__ import annotations

import os
from contextlib import contextmanager
from typing import Optional

import torch

from . import bitprop

_MODES = ("auto", "push", "pull")
_FORCED: Optional[str] = None


def resolved_mode() -> str:
    """``force_mode()`` override, then ``SDBKP_SEMIRING_MODE``, else auto."""
    if _FORCED is not None:
        return _FORCED
    mode = os.environ.get("SDBKP_SEMIRING_MODE", "auto")
    return mode if mode in _MODES else "auto"


@contextmanager
def force_mode(mode: str):
    """Force push/pull/auto for the duration (bench baseline + tests)."""
    global _FORCED
    if mode not in _MODES:
        raise ValueError(f"unknown semiring mode {mode!r}")
    prev = _FORCED
    _FORCED = mode
    try:
        yield
    finally:
        _FORCED = prev


def crossover_from_occupancy(ewma: Optional[float]) -> float:
    """Frontier-occupancy EWMA -> push/pull crossover: push while the
    per-hop occupancy is <= the result. No signal yet -> 1.0 (always
    push where a bit dual exists); the 0.05 floor keeps seed-only hops
    on push."""
    if ewma is None:
        return 1.0
    return float(min(1.0, max(0.05, 1.0 - ewma)))


def edge_activation(exp_rel: torch.Tensor, now_rel,
                    cav: Optional[torch.Tensor] = None,
                    cav_ok: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The ``(exp > now) AND cav_ok[row]`` edge-activation mask, uint8 per
    edge: expirations are float32 seconds relative to the graph's base
    time, ``cav`` each edge's caveat-instance row and ``cav_ok`` the
    caveat VM's per-row verdict (row 0 always 1). Computed once per
    dispatch."""
    now = torch.tensor(float(now_rel), dtype=torch.float32,
                       device=exp_rel.device)
    act = (exp_rel > now).to(torch.uint8)
    if cav_ok is not None:
        act &= cav_ok[cav]
    return act


def frontier_occupancy(count: int, numel: int) -> float:
    """Occupancy in [0, 1] from the count of set state entries, rounded as
    the reference's float32 mean of the 0/1 state."""
    import numpy as np

    return float(np.float32(count) / np.float32(numel))


def push_differs(blocks, B: int, level: Optional[int] = None) -> bool:
    """Whether push and pull run different code at this level: some
    selected block has a bit dual and the batch fits the bit kernel."""
    return B <= bitprop.BIT_B_MAX and any(
        bits is not None for bm, _, bits in blocks
        if level is None or bm.level == level)


def _scatter_or(prop: torch.Tensor, V: torch.Tensor, src: torch.Tensor,
                dst: torch.Tensor, act: torch.Tensor) -> None:
    """``prop[b, dst[e]] |= V[b, src[e]] & act[e]`` in place. The OR is an
    int32 ``index_add_`` (counts, then > 0), which equals the reference's
    uint8 ``segment_max`` bit for bit; padding edges land in the trash
    slot M with act 0."""
    gathered = (V[:, src] & act).T.to(torch.int32)  # [E, B]
    acc = torch.zeros((prop.shape[1], prop.shape[0]), dtype=torch.int32,
                      device=prop.device)
    acc.index_add_(0, dst, gathered)
    prop |= acc.T.gt(0).to(torch.uint8)


def propagate(block_meta, blocks, blocks_bits, src, dst, act,
              dsrc, ddst, dact, Vflat: torch.Tensor, use_push: bool, *,
              level: Optional[int] = None, mode: str = "auto",
              shard: Optional[tuple] = None):
    """One masked-semiring hop: ``(prop [B, Mp] uint8, is_push 0|1)``.

    ``src``/``dst``/``act`` are this level's residual edge slice (padding
    edges point at the trash slot M with act 0); ``dsrc``/``ddst``/``dact``
    the fixed-capacity delta overlay. Blocks are filtered by ``level``
    (None = all). ``use_push`` is the host-side auto-mode choice (the
    reference's ``occ <= crossover``); ``mode`` forces one branch.

    ``shard``: ``(g_idx, ng)`` when the caller is one cell of a mesh
    (parallel/sharded.py) whose blocks hold only their src-axis chunk
    ``A[:, g_idx*w:(g_idx+1)*w]``, ``w = n_src // ng``: the frontier is
    then that chunk's columns of the state. The join of the cells'
    partial products stays with the caller."""
    B, Mp = Vflat.shape
    prop = torch.zeros((B, Mp), dtype=torch.uint8, device=Vflat.device)
    if src.shape[0]:
        _scatter_or(prop, Vflat, src, dst, act)
    # delta overlay: applied at every level, as the reference does
    _scatter_or(prop, Vflat, dsrc, ddst, dact)

    sel = [(bm, A, Ab) for bm, A, Ab in zip(block_meta, blocks, blocks_bits)
           if level is None or bm.level == level]
    if not sel:
        return prop, 0
    differs = push_differs(sel, B)
    if mode == "push" and differs:
        push = True
    elif mode == "pull" or not differs:
        push = False
    else:
        push = bool(use_push)
    for bm, A, Ab in sel:
        if shard is None:
            f = Vflat[:, bm.src_off:bm.src_off + bm.n_src]
        else:
            g_idx, ng = shard
            w = bm.n_src // ng
            lo = bm.src_off + g_idx * w
            f = Vflat[:, lo:lo + w]
        if push and Ab is not None:
            vb = bitprop.pack_frontier(f, bm.n_src)
            contrib = bitprop.bit_or_matmul(Ab, vb, B)
        else:
            # pull, or a block without a bit dual inside a push pass; the
            # kernel reads the strided slice of the state, no copy
            contrib = bitprop.dense_or_matmul(A, f)
        prop[:, bm.dst_off:bm.dst_off + bm.n_dst] |= contrib
    return prop, int(push)
