"""The two block hops of the masked boolean semiring, as CUDA kernels.

Counterpart of the JAX package's ``ops/bitprop.py``, whose two Pallas TPU
kernels become the hand-written CUDA kernels of ``csrc/bitprop.cu``:

- :func:`bit_or_matmul` — the PUSH hop over a bit-packed block (one bit
  per potential edge): ``out[b, d] = (OR_k A_bits[d, k] & V_bits[b, k])
  != 0`` for the first ``n_b <= BIT_B_MAX`` frontier rows;
- :func:`dense_or_matmul` — the PULL hop over a dense int8 block:
  ``out[b, d] = OR_s f[b, s] & A[d, s]``, as an int8 product > 0.

Each wrapper launches its kernel for CUDA tensors (or raises — nothing
falls back) and runs its plain PyTorch version (``*_plain``) for CPU
tensors, which is what the CPU tests exercise. Each counts its kernel
launches in a plain integer attribute (``bit_or_matmul.launches``).

Packed words are int32 on the torch side (PyTorch's uint32 support is
partial); bit patterns are identical to the reference's uint32 words, so
bit 31 reads as a negative int32.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import kernels

BIT_B_MAX = 8  # batches up to this ride the bit kernel (beyond: pull)
TILE_D = 256
LANES = 128

# Eligibility is the reference's, unchanged: it decides which blocks get a
# bit-packed dual and so how many hops count as push (``push_steps``).
# The VMEM-derived tile budget below is a TPU quantity; a later change
# re-derives eligibility for the card's shared memory and registers.
MIN_DST = 32
MIN_SRC = 32
VMEM_BUDGET = 12 * 1024 * 1024

# the reference's dense-kernel shape rules (its MXU tile, int8 sublane
# padding and VMEM-bounded batch); the CUDA kernel takes any batch and
# any n_src % 16 == 0, so these only feed hop_bytes' accounting
MXU_TILE = 128
SUBLANE = 32
DENSE_B_MAX = 4096


def _k_pad(n_src: int) -> int:
    return -(-((n_src + 31) // 32) // LANES) * LANES


def _vmem_bytes(tile_d: int, k: int) -> int:
    return (2 * tile_d + BIT_B_MAX) * k * 4 + 3 * tile_d * LANES * 4


def _pick_tile_for_k(n_dst: int, k: int):
    for t in (TILE_D, 128, 64, 32):
        if n_dst % t == 0 and _vmem_bytes(t, k) <= VMEM_BUDGET:
            return t
    return None


def pick_tile(n_dst: int, n_src: int):
    """The reference's dst tile (None = no bit-packed dual)."""
    return _pick_tile_for_k(n_dst, _k_pad(n_src))


def eligible(n_dst: int, n_src: int) -> bool:
    """Whether a block gets a bit-packed dual (the push path)."""
    return (n_dst % MIN_DST == 0 and n_src % MIN_SRC == 0
            and pick_tile(n_dst, n_src) is not None)


def dense_eligible(n_dst: int, n_src: int, batch: int) -> bool:
    """The reference's Pallas dense-kernel eligibility (hop_bytes only)."""
    if n_dst % MXU_TILE or n_src % MXU_TILE or batch > DENSE_B_MAX:
        return False
    b32 = -(-batch // SUBLANE) * SUBLANE
    return (2 * MXU_TILE * MXU_TILE + 5 * b32 * MXU_TILE) <= VMEM_BUDGET


def pack_block_host(dst_local: np.ndarray, src_local: np.ndarray,
                    n_dst: int, n_src: int) -> np.ndarray:
    """Edges -> uint32 bit matrix [n_dst, K_pad]; bit w of word k set means
    an edge from src ``32k + w``. K padded to the 128-word lane width."""
    bits = np.zeros((n_dst, _k_pad(n_src)), dtype=np.uint32)
    word = np.asarray(src_local) // 32
    bit = (np.asarray(src_local) % 32).astype(np.uint32)
    np.bitwise_or.at(bits, (np.asarray(dst_local), word),
                     np.uint32(1) << bit)
    return bits


def pack_block(dst_local: torch.Tensor, src_local: torch.Tensor,
               n_dst: int, n_src: int) -> torch.Tensor:
    """Device twin of :func:`pack_block_host`: int32 [n_dst, K_pad] with
    the same bit patterns. Duplicate edges are dropped first, so the bits
    of one word are distinct and their sum is their OR."""
    dev = dst_local.device
    k_pad = _k_pad(n_src)
    cells = torch.unique(dst_local.to(torch.int64) * n_src
                         + src_local.to(torch.int64))
    d, s = cells // n_src, cells % n_src
    words = torch.zeros(n_dst * k_pad, dtype=torch.int64, device=dev)
    words.index_add_(0, d * k_pad + s // 32,
                     torch.ones_like(s) << (s % 32))
    return (words - ((words >> 31) << 32)).to(torch.int32).view(
        n_dst, k_pad)


_SHIFTS: dict = {}


def pack_frontier(frontier: torch.Tensor, n_src: int) -> torch.Tensor:
    """uint8 frontier [B, n_src] -> packed int32 [BIT_B_MAX, K_pad] (B rows
    used). Kept as torch ops, not fused into the kernel: a shift and a
    sum over the 32-bit word axis, O(B * n_src) next to the hop's
    O(n_dst * K) stream."""
    b = frontier.shape[0]
    k0 = n_src // 32
    dev = frontier.device
    shifts = _SHIFTS.get(dev)
    if shifts is None:
        # 1 << 31 wraps to INT32_MIN: the same bit pattern as uint32
        shifts = _SHIFTS[dev] = (
            torch.ones(32, dtype=torch.int64, device=dev)
            << torch.arange(32, device=dev)).to(torch.int32)
    words = (frontier.reshape(b, k0, 32).to(torch.int64)
             * shifts.to(torch.int64)).sum(dim=2)
    out = torch.zeros((BIT_B_MAX, _k_pad(n_src)), dtype=torch.int32,
                      device=dev)
    # int64 sums of distinct powers of two < 2**32: wrap into int32 bits
    out[:b, :k0] = (words - ((words >> 31) << 32)).to(torch.int32)
    return out


# The bit kernel's block-uniform path choice, decided here and only here:
# a block takes the sparse path (only the live words of each row are
# loaded) when at most this many frontier words are live: K / 16, so the
# live words touch at most half of a row's K / 8 32-byte sectors, and no
# more than the kernel's shared live-word list holds (kBitSparseCap in
# csrc/bitprop.cu, which refuses a larger count). A dual under
# BIT_SPARSE_MIN_BYTES always streams: there the whole stream costs about
# what the live-word compaction and scattered reads do, and at K / 16 live
# words the sparse path loses (PERF.md: by 26-29% on 4-8 MiB duals), while
# from 16 MiB on it wins at every live count up to the limit. PERF.md's
# density sweep and mid-size dual readings justify both numbers.
BIT_SPARSE_DIV = 16
BIT_SPARSE_CAP = 64
BIT_SPARSE_MIN_BYTES = 1 << 24
# the dense kernel's live-column grain: one k32 step of the int8 MMA
DENSE_TILE_BYTES = 32


def bit_sparse_max_live(n_dst: int, k: int) -> int:
    """Most live frontier words for which the bit kernel reads only them
    on an [n_dst, k] dual; -1 when it always streams whole rows."""
    if n_dst * k * 4 < BIT_SPARSE_MIN_BYTES:
        return -1
    return min(BIT_SPARSE_CAP, k // BIT_SPARSE_DIV)


def _bind(lib) -> None:
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.bitprop_bit_or_matmul.restype = ctypes.c_int
    lib.bitprop_bit_or_matmul.argtypes = [p, p, p, i64, i64, ctypes.c_int,
                                          ctypes.c_int, p]
    lib.bitprop_dense_or_matmul.restype = ctypes.c_int
    lib.bitprop_dense_or_matmul.argtypes = [p, p, i64, p, p, i64, i64, i64,
                                            p]


def _lib():
    return kernels.load("bitprop", _bind)


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _require(t: torch.Tensor, name: str, dtype, ndim: int,
             dev: torch.device, rows: bool = False) -> None:
    """Type, device and layout checks before a launch. ``rows=True``
    accepts a row-strided 2-d view (unit column stride, a row stride that
    is a multiple of 16 bytes), as the dense kernel's frontier may be."""
    if t.dtype != dtype or t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim}-d {dtype}, got "
                         f"{t.dim()}-d {t.dtype}")
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if rows:  # a single row's stride is never used
        if t.shape[1] > 1 and t.stride(1) != 1:
            raise ValueError(f"{name} must have unit column stride")
        if t.shape[0] > 1 and (t.stride(0) * t.element_size()) % 16:
            raise ValueError(f"{name}'s row stride {t.stride(0)} is not a "
                             f"multiple of 16 bytes")
    elif not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned (the kernels "
                         f"load int4 vectors)")


def bit_or_matmul_plain(a_bits: torch.Tensor, v_bits: torch.Tensor,
                        n_b: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`bit_or_matmul`."""
    out = torch.empty((n_b, a_bits.shape[0]), dtype=torch.uint8,
                      device=a_bits.device)
    for b in range(n_b):
        out[b] = (a_bits & v_bits[b]).ne(0).any(dim=1)
    return out


def bit_or_matmul(a_bits: torch.Tensor, v_bits: torch.Tensor,
                  n_b: int) -> torch.Tensor:
    """(AND, OR) contraction: ``a_bits`` [n_dst, K] int32, ``v_bits``
    [BIT_B_MAX, K] int32 -> reached [n_b, n_dst] uint8 (the semiring's
    [B, n_dst] layout; the reference returns its transpose)."""
    if not 1 <= n_b <= BIT_B_MAX:
        raise ValueError(f"n_b={n_b} outside 1..{BIT_B_MAX}")
    if a_bits.device.type != "cuda":
        return bit_or_matmul_plain(a_bits, v_bits, n_b)
    dev = a_bits.device
    _require(a_bits, "a_bits", torch.int32, 2, dev)
    _require(v_bits, "v_bits", torch.int32, 2, dev)
    n_dst, k = a_bits.shape
    if k % 4 or v_bits.shape != (BIT_B_MAX, k):
        raise ValueError(f"a_bits K={k} must be a multiple of 4 and v_bits "
                         f"[{BIT_B_MAX}, {k}], got {tuple(v_bits.shape)}")
    out = torch.empty((n_b, n_dst), dtype=torch.uint8, device=dev)
    err = _lib().bitprop_bit_or_matmul(
        a_bits.data_ptr(), v_bits.data_ptr(), out.data_ptr(), n_dst, k, n_b,
        bit_sparse_max_live(n_dst, k), _stream(dev))
    kernels.check(err, "bit_or_matmul launch")
    bit_or_matmul.launches += 1
    return out


bit_or_matmul.launches = 0

# rows of A per plain-version step: bounds the float32 copy of A
_PLAIN_ROWS_BYTES = 1 << 30


def dense_or_matmul_plain(A: torch.Tensor,
                          frontier: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`dense_or_matmul` (the frontier may
    be a strided view). A float32 product is exact here: every term is 0
    or 1, so a sum is > 0 exactly when a term is, whatever the rounding of
    the accumulation."""
    n_dst, n_src = A.shape
    f = frontier.to(torch.float32)
    out = torch.empty((frontier.shape[0], n_dst), dtype=torch.uint8,
                      device=A.device)
    step = max(1, _PLAIN_ROWS_BYTES // max(4 * n_src, 1))
    for d0 in range(0, n_dst, step):
        a = A[d0:d0 + step].to(torch.float32)
        out[:, d0:d0 + step] = (f @ a.T).gt(0)
    return out


def dense_or_matmul(A: torch.Tensor, frontier: torch.Tensor) -> torch.Tensor:
    """Masked boolean-semiring block hop: ``A`` [n_dst, n_src] int8,
    ``frontier`` [B, n_src] uint8 -> reached [B, n_dst] uint8. Any B. The
    frontier may be a row-strided view (the fixpoint passes its slice of
    the state); on the card its row stride must be a multiple of 16
    bytes."""
    if A.device.type != "cuda":
        return dense_or_matmul_plain(A, frontier)
    dev = A.device
    _require(A, "A", torch.int8, 2, dev)
    _require(frontier, "frontier", torch.uint8, 2, dev, rows=True)
    n_dst, n_src = A.shape
    batch = frontier.shape[0]
    if n_src % 16 or frontier.shape[1] != n_src:
        raise ValueError(f"n_src={n_src} must be a multiple of 16 and match "
                         f"the frontier's {frontier.shape[1]}")
    out = torch.empty((batch, n_dst), dtype=torch.uint8, device=dev)
    # per call, never shared: the live count and column list the kernel's
    # pre-pass writes on this stream
    scratch = torch.empty(1 + -(-n_src // DENSE_TILE_BYTES),
                          dtype=torch.int32, device=dev)
    err = _lib().bitprop_dense_or_matmul(
        A.data_ptr(), frontier.data_ptr(),
        frontier.stride(0) if batch > 1 else n_src,
        out.data_ptr(), scratch.data_ptr(), n_dst, n_src, batch,
        _stream(dev))
    kernels.check(err, "dense_or_matmul launch")
    dense_or_matmul.launches += 1
    return out


dense_or_matmul.launches = 0


def reset_launch_counts() -> None:
    bit_or_matmul.launches = 0
    dense_or_matmul.launches = 0


def dense_hop_reference(A: np.ndarray, frontier: np.ndarray) -> np.ndarray:
    """Pure-numpy oracle of one dense block hop (tests)."""
    return ((frontier.astype(np.int64) @ A.astype(np.int64).T) > 0
            ).astype(np.uint8)


def bit_hop_reference(a_bits: np.ndarray, frontier: np.ndarray) -> np.ndarray:
    """Pure-numpy oracle of one packed hop (tests): ``a_bits`` [n_dst, K]
    uint32, ``frontier`` [n_src, n_b] -> [n_dst, n_b] uint8."""
    n_dst, k = a_bits.shape
    n_src, n_b = frontier.shape
    out = np.zeros((n_dst, n_b), dtype=np.uint8)
    for b in range(n_b):
        idx = np.flatnonzero(frontier[:, b])
        words = idx // 32
        bits = np.uint32(1) << (idx % 32).astype(np.uint32)
        v = np.zeros(k, dtype=np.uint32)
        np.bitwise_or.at(v, words, bits)
        out[:, b] = ((a_bits & v[None, :]).any(axis=1)).astype(np.uint8)
    return out
