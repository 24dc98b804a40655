"""PyTorch port, ops/bitprop.py: both block hops' plain versions (what the
wrappers run for CPU tensors) against the JAX Pallas kernels in
interpreter mode and the numpy oracles, plus the packers and the
eligibility rules. Every output is boolean, so every comparison is exact.
The CUDA kernels themselves are held against the plain versions on the
card (``cuda`` marker; chip_smoke.py does the same at full size)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spicedb_kubeapi_proxy_tpu.ops import bitprop as jbit
from spicedb_kubeapi_proxy_tpu_torch.ops import bitprop as tbit
from spicedb_kubeapi_proxy_tpu_torch.ops import reachability as treach


def _block(rng, n_dst, n_src, n_edges):
    return (rng.integers(n_dst, size=n_edges).astype(np.int32),
            rng.integers(n_src, size=n_edges).astype(np.int32))


def _as_i32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


@pytest.mark.parametrize("n_dst,n_src", [(32, 32), (288, 96), (64, 4096)])
def test_packers_match_reference(n_dst, n_src):
    rng = np.random.default_rng(n_dst * 7 + n_src)
    dst, src = _block(rng, n_dst, n_src, 3 * n_dst)
    want = jbit.pack_block_host(dst, src, n_dst, n_src)
    np.testing.assert_array_equal(
        tbit.pack_block_host(dst, src, n_dst, n_src), want)
    # the device twin (duplicate edges included) gives the same bits
    got = tbit.pack_block(torch.from_numpy(np.concatenate([dst, dst[:5]])),
                          torch.from_numpy(np.concatenate([src, src[:5]])),
                          n_dst, n_src)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    for b in (1, 3, 8):
        f = (rng.random((b, n_src)) < 0.2).astype(np.uint8)
        f[0, n_src - 1] = 1  # bit 31 of the last word: a negative int32
        ref = np.asarray(jbit.pack_frontier(jnp.asarray(f), n_src))
        np.testing.assert_array_equal(
            tbit.pack_frontier(torch.from_numpy(f), n_src).numpy().view(
                np.uint32), ref)


@pytest.mark.parametrize("n_dst,n_src,n_b,density", [
    (32, 32, 1, 0.1), (256, 128, 3, 0.1), (512, 1024, 8, 0.1),
    (288, 96, 2, 0.1), (96, 256, 5, 0.0), (64, 128, 7, 0.3),
    (128, 64, 4, 0.05), (32, 160, 6, 0.2),
])
def test_bit_or_matmul_plain_matches_pallas(monkeypatch, n_dst, n_src, n_b,
                                            density):
    monkeypatch.setenv("SDBKP_BITPROP", "interpret")
    rng = np.random.default_rng(n_dst + n_src + n_b)
    dst, src = _block(rng, n_dst, n_src, 4 * n_dst)
    a_bits = jbit.pack_block_host(dst, src, n_dst, n_src)
    frontier = (rng.random((n_b, n_src)) < density).astype(np.uint8)
    want = np.asarray(jbit.bit_or_matmul(
        jnp.asarray(a_bits), jbit.pack_frontier(jnp.asarray(frontier),
                                                n_src), n_b))
    np.testing.assert_array_equal(
        want, jbit.bit_hop_reference(a_bits, frontier.T.copy()))
    vb = tbit.pack_frontier(torch.from_numpy(frontier), n_src)
    got = tbit.bit_or_matmul(_as_i32(a_bits), vb, n_b).numpy()
    np.testing.assert_array_equal(got, want.T)  # port writes [n_b, n_dst]
    np.testing.assert_array_equal(
        tbit.bit_hop_reference(a_bits, frontier.T.copy()), want)
    if density == 0.0:
        assert not got.any()


@pytest.mark.parametrize("n_dst,n_src,batch,density", [
    (128, 128, 1, 0.1), (256, 128, 5, 0.1), (128, 256, 32, 0.1),
    (384, 128, 33, 0.1), (128, 128, 17, 0.0), (256, 384, 70, 0.02),
])
def test_dense_or_matmul_plain_matches_pallas(monkeypatch, n_dst, n_src,
                                              batch, density):
    monkeypatch.setenv("SDBKP_SEMIRING", "interpret")
    rng = np.random.default_rng(n_dst + n_src + batch)
    A = (rng.random((n_dst, n_src)) < 0.05).astype(np.int8)
    frontier = (rng.random((batch, n_src)) < density).astype(np.uint8)
    want = np.asarray(jbit.dense_or_matmul(jnp.asarray(A),
                                           jnp.asarray(frontier)))
    np.testing.assert_array_equal(want,
                                  jbit.dense_hop_reference(A, frontier))
    got = tbit.dense_or_matmul(torch.from_numpy(A),
                               torch.from_numpy(frontier)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tbit.dense_hop_reference(A, frontier),
                                  want)


def test_dense_plain_chunks_rows(monkeypatch):
    """The plain version's row chunking (bounded float32 copies of A)
    changes nothing."""
    monkeypatch.setattr(tbit, "_PLAIN_ROWS_BYTES", 4 * 256 * 40)
    rng = np.random.default_rng(5)
    A = (rng.random((300, 256)) < 0.05).astype(np.int8)
    f = (rng.random((9, 256)) < 0.1).astype(np.uint8)
    np.testing.assert_array_equal(
        tbit.dense_or_matmul(torch.from_numpy(A),
                             torch.from_numpy(f)).numpy(),
        jbit.dense_hop_reference(A, f))


@pytest.mark.parametrize("n_dst", [32, 96, 256, 512, 131072])
@pytest.mark.parametrize("n_src", [32, 128, 4096, 16384, 10_000_000 - 32])
def test_eligibility_matches_reference(n_dst, n_src):
    assert tbit.pick_tile(n_dst, n_src) == jbit.pick_tile(n_dst, n_src)
    assert tbit.eligible(n_dst, n_src) == jbit.eligible(n_dst, n_src)
    for b in (1, 33, 4096, 4097):
        assert tbit.dense_eligible(n_dst, n_src, b) == \
            jbit.dense_eligible(n_dst, n_src, b)


def test_wrappers_validate_batch():
    a = torch.zeros((32, 128), dtype=torch.int32)
    v = torch.zeros((8, 128), dtype=torch.int32)
    with pytest.raises(ValueError):
        tbit.bit_or_matmul(a, v, 9)
    with pytest.raises(ValueError):
        tbit.bit_or_matmul(a, v, 0)


def _bit_frontier(n_b, n_src, words, bit=None):
    """A uint8 [n_b, n_src] frontier lighting exactly ``words`` (row i %
    n_b gets word i), each with one bit: ``bit`` or a per-word one."""
    f = np.zeros((n_b, n_src), dtype=np.uint8)
    for i, w in enumerate(words):
        f[i % n_b, 32 * w + (bit if bit is not None else (7 * i + 3) % 31)] = 1
    return f


# (n_dst, n_src, n_b, live words): the shapes the bit kernel's sparse and
# dense paths specialise on; n_src 4096 packs into K=128 words, so the
# sparse path takes at most K / 16 = 8 live words
_SPARSE_BIT_CASES = {
    "all_zero": (64, 4096, 1, []),
    "bit31_single_word": (64, 4096, 1, [77]),
    "at_threshold": (96, 4096, 1, [0, 3, 9, 40, 41, 90, 100, 124]),
    "past_threshold": (96, 4096, 2, [0, 3, 9, 40, 41, 90, 100, 124, 126]),
    "disjoint_rows_n_b8_sparse": (64, 4096, 8,
                                  [5, 17, 33, 60, 61, 62, 99, 127]),
    "disjoint_rows_n_b8_dense": (64, 4096, 8, list(range(0, 128, 8))),
}


@pytest.mark.parametrize("case", sorted(_SPARSE_BIT_CASES))
def test_bit_plain_matches_pallas_at_sparse_shapes(monkeypatch, case):
    monkeypatch.setenv("SDBKP_BITPROP", "interpret")
    n_dst, n_src, n_b, words = _SPARSE_BIT_CASES[case]
    rng = np.random.default_rng(len(words) + n_b)
    dst, src = _block(rng, n_dst, n_src, 40 * n_dst)
    # every live word is reached by some row, so hits are not vacuous
    dst = np.concatenate([dst, np.arange(len(words), dtype=np.int32)])
    src = np.concatenate([src, 32 * np.asarray(words, dtype=np.int32)
                          + (7 * np.arange(len(words)) + 3) % 31])
    a_bits = jbit.pack_block_host(dst, src, n_dst, n_src)
    frontier = _bit_frontier(n_b, n_src, words,
                             31 if case.startswith("bit31") else None)
    want = np.asarray(jbit.bit_or_matmul(
        jnp.asarray(a_bits), jbit.pack_frontier(jnp.asarray(frontier),
                                                n_src), n_b))
    np.testing.assert_array_equal(
        want, jbit.bit_hop_reference(a_bits, frontier.T.copy()))
    vb = tbit.pack_frontier(torch.from_numpy(frontier), n_src)
    live = int((vb[:n_b] != 0).any(dim=0).sum())
    assert live == len(set(words))
    limit = tbit.bit_sparse_max_live(1 << 16, vb.shape[1])
    assert (live <= limit) == (not case.endswith(("past_threshold",
                                                  "_dense")))
    if case.startswith("bit31"):
        assert int(vb[0, 77]) == -2 ** 31  # bit 31: a negative int32
    got = tbit.bit_or_matmul(_as_i32(a_bits), vb, n_b).numpy()
    np.testing.assert_array_equal(got, want.T)
    assert got.any() == bool(words)


@pytest.mark.parametrize("n_dst,k,want", [
    (1 << 16, 128, 8), (131072, 512, 32), (1 << 16, 1024, 64),
    (1 << 16, 4096, 64), (1 << 20, 8, 0),
    (4064, 128, -1), (2048, 512, -1), (8192, 512, 32), (8191, 512, -1),
    (40_000, 128, 8), (32_768, 128, 8), (32_767, 128, -1)])
def test_bit_sparse_threshold(n_dst, k, want):
    """K / 16 live words at most, capped by the kernel's list; a dual under
    BIT_SPARSE_MIN_BYTES always streams whole rows (-1)."""
    assert tbit.bit_sparse_max_live(n_dst, k) == want


def _disjoint_dense_frontier(batch, n_src, cols):
    """Row i % batch lights 32-byte column cols[i] (one byte each), so no
    two rows share a column."""
    f = np.zeros((batch, n_src), dtype=np.uint8)
    for i, c in enumerate(cols):
        f[i % batch, 32 * c + (5 * i) % 32] = 1
    return f


# (n_dst, n_src, batch, live 32-byte columns); None = every column
_SPARSE_DENSE_CASES = {
    "all_zero": (128, 256, 16, []),
    "one_column": (256, 256, 5, [3]),
    "disjoint_rows_b16": (256, 1024, 16, list(range(1, 32, 2))),
    "all_live": (128, 256, 16, None),
    "b64_one_hot": (128, 2048, 64, list(range(0, 64))),
}


@pytest.mark.parametrize("case", sorted(_SPARSE_DENSE_CASES))
def test_dense_plain_matches_pallas_at_sparse_shapes(monkeypatch, case):
    monkeypatch.setenv("SDBKP_SEMIRING", "interpret")
    n_dst, n_src, batch, cols = _SPARSE_DENSE_CASES[case]
    rng = np.random.default_rng(n_dst + batch)
    A = (rng.random((n_dst, n_src)) < 0.05).astype(np.int8)
    if cols is None:
        frontier = (rng.random((batch, n_src)) < 0.5).astype(np.uint8)
    else:
        frontier = _disjoint_dense_frontier(batch, n_src, cols)
    want = np.asarray(jbit.dense_or_matmul(jnp.asarray(A),
                                           jnp.asarray(frontier)))
    np.testing.assert_array_equal(want,
                                  jbit.dense_hop_reference(A, frontier))
    got = tbit.dense_or_matmul(torch.from_numpy(A),
                               torch.from_numpy(frontier)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.any() == (cols is None or bool(cols))


@pytest.mark.parametrize("n_src,batch", [(144, 16), (16, 3), (400, 9)])
def test_dense_plain_ragged_n_src(n_src, batch):
    """n_src a multiple of 16 but not of 32: the last 32-byte column is a
    half column. The Pallas kernel takes only multiples of 128, so the
    reference here is the JAX package's numpy oracle."""
    rng = np.random.default_rng(n_src)
    A = (rng.random((200, n_src)) < 0.1).astype(np.int8)
    f = (rng.random((batch, n_src)) < 0.05).astype(np.uint8)
    f[0, n_src - 1] = 1  # a bit in the half column
    got = tbit.dense_or_matmul(torch.from_numpy(A),
                               torch.from_numpy(f)).numpy()
    np.testing.assert_array_equal(got, jbit.dense_hop_reference(A, f))


@pytest.mark.parametrize("off", [0, 128, 384])
def test_dense_strided_frontier_matches_copy(off):
    """A row-strided slice of the state (what semiring.propagate passes)
    gives the same result as its contiguous copy."""
    rng = np.random.default_rng(off)
    n_src, Mp = 256, 1024
    A = torch.from_numpy((rng.random((160, n_src)) < 0.05).astype(np.int8))
    V = torch.from_numpy((rng.random((7, Mp)) < 0.03).astype(np.uint8))
    f = V[:, off:off + n_src]
    assert not f.is_contiguous() and f.stride(0) == Mp
    got = tbit.dense_or_matmul(A, f)
    np.testing.assert_array_equal(got.numpy(),
                                  tbit.dense_or_matmul(A, f.contiguous())
                                  .numpy())
    np.testing.assert_array_equal(got.numpy(), jbit.dense_hop_reference(
        A.numpy(), f.numpy()))


@pytest.mark.parametrize("rows,width,cols,ok", [
    (4, 1024, slice(128, 384), True),     # state slice: stride 1024 B
    (4, 272, slice(0, 256), True),        # stride 272 B = 17 x 16
    (4, 264, slice(0, 256), False),       # stride 264 B: rows misaligned
    (4, 512, slice(0, 512, 2), False),    # column stride 2
    (1, 264, slice(0, 256), True),        # one row: its stride is unused
])
def test_frontier_layout_checks(rows, width, cols, ok):
    """The dense kernel's frontier checks: row-strided views pass when the
    row stride is a multiple of 16 bytes and columns are unit-strided."""
    f = torch.zeros((rows, width), dtype=torch.uint8)[:, cols]
    if ok:
        tbit._require(f, "frontier", torch.uint8, 2, f.device, rows=True)
    else:
        with pytest.raises(ValueError):
            tbit._require(f, "frontier", torch.uint8, 2, f.device,
                          rows=True)


@pytest.mark.cuda
def test_cuda_kernels_match_plain():
    """On the card: each kernel byte-equal to its plain version (including
    the sparse shapes the kernels specialise on), launch counts move only
    on kernel launches, and bad inputs raise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    for n_dst, n_src, n_b in ((288, 96, 3), (1024, 4096, 8), (32, 32, 1)):
        dst, src = _block(rng, n_dst, n_src, 4 * n_dst)
        a = _as_i32(tbit.pack_block_host(dst, src, n_dst, n_src)).to(dev)
        f = torch.from_numpy(
            (rng.random((n_b, n_src)) < 0.1).astype(np.uint8)).to(dev)
        vb = tbit.pack_frontier(f, n_src)
        before = tbit.bit_or_matmul.launches
        got = tbit.bit_or_matmul(a, vb, n_b)
        assert tbit.bit_or_matmul.launches == before + 1
        assert torch.equal(got, tbit.bit_or_matmul_plain(a, vb, n_b))
    for case, (n_dst, n_src, n_b, words) in _SPARSE_BIT_CASES.items():
        for rows in (n_dst, 40_000):  # whole rows only, and a big dual
            dst, src = _block(rng, rows, n_src, 40 * rows)
            a = _as_i32(tbit.pack_block_host(dst, src, rows, n_src)).to(dev)
            vb = tbit.pack_frontier(torch.from_numpy(_bit_frontier(
                n_b, n_src, words, 31 if case.startswith("bit31") else None
            )).to(dev), n_src)
            assert torch.equal(tbit.bit_or_matmul(a, vb, n_b),
                               tbit.bit_or_matmul_plain(a, vb, n_b)), case
    # the entry point refuses a live-word limit past its shared list
    out = torch.empty((n_b, a.shape[0]), dtype=torch.uint8, device=dev)
    assert tbit._lib().bitprop_bit_or_matmul(
        a.data_ptr(), vb.data_ptr(), out.data_ptr(), a.shape[0], a.shape[1],
        n_b, tbit.BIT_SPARSE_CAP + 1, tbit._stream(dev)) != 0
    for n_dst, n_src, b in ((384, 128, 33), (1024, 2048, 64), (128, 16, 1),
                            (300, 144, 16), (1000, 4016, 70)):
        A = torch.from_numpy(
            (rng.random((n_dst, n_src)) < 0.05).astype(np.int8)).to(dev)
        f = torch.from_numpy(
            (rng.random((b, n_src)) < 0.1).astype(np.uint8)).to(dev)
        got = tbit.dense_or_matmul(A, f)
        torch.cuda.synchronize()
        assert torch.equal(got, tbit.dense_or_matmul_plain(A, f))
    for case, (n_dst, n_src, b, cols) in _SPARSE_DENSE_CASES.items():
        A = torch.from_numpy(
            (rng.random((n_dst, n_src)) < 0.05).astype(np.int8)).to(dev)
        f = (torch.from_numpy((rng.random((b, n_src)) < 0.5).astype(
            np.uint8)) if cols is None else
            torch.from_numpy(_disjoint_dense_frontier(b, n_src, cols))).to(dev)
        assert torch.equal(tbit.dense_or_matmul(A, f),
                           tbit.dense_or_matmul_plain(A, f)), case
    # a strided state slice launches as is and equals its contiguous copy
    V = torch.from_numpy((rng.random((16, 4096)) < 0.01).astype(
        np.uint8)).to(dev)
    A = torch.from_numpy((rng.random((640, 1024)) < 0.05).astype(
        np.int8)).to(dev)
    view = V[:, 1024:2048]
    before = tbit.dense_or_matmul.launches
    got = tbit.dense_or_matmul(A, view)
    assert tbit.dense_or_matmul.launches == before + 1
    assert torch.equal(got, tbit.dense_or_matmul(A, view.contiguous()))
    assert torch.equal(got, tbit.dense_or_matmul_plain(A, view))
    with pytest.raises(ValueError):
        tbit.dense_or_matmul(A.to(torch.int32), view)
    # a row stride that is not a multiple of 16 bytes raises
    odd = torch.zeros((16, 1032), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError, match="multiple of 16"):
        tbit.dense_or_matmul(A, odd[:, :1024])
    # a view that is not 16-byte aligned cannot feed int4 loads
    wide = torch.zeros((1, 2 * A.shape[1]), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError, match="aligned"):
        tbit.dense_or_matmul(A, wide[:, 1:1 + A.shape[1]])
    # a dual patched in place on the card, as the write path patches it:
    # killed cells sharing packed words (one at bit 31), then the bit
    # kernel on the patched dual against a fresh pack of the live cells
    n_dst, n_src = 1024, 4096
    dst, src = _block(rng, n_dst, n_src, 40 * n_dst)
    dst = np.concatenate([dst, [7, 7, 9]])
    src = np.concatenate([src, [31, 5, 63]])
    a = _as_i32(tbit.pack_block_host(dst, src, n_dst, n_src)).to(dev)
    kill = np.unique(np.stack([dst, src], 1), axis=0)
    kill = np.concatenate([kill[::7], [[7, 31], [7, 5], [9, 63]]])
    treach._clear_bits(a, kill[:, 0], kill[:, 1],
                       lambda x, dt: torch.as_tensor(np.asarray(x)).to(
                           device=dev, dtype=dt))
    cells = set(zip(dst.tolist(), src.tolist())) - set(
        zip(kill[:, 0].tolist(), kill[:, 1].tolist()))
    live = np.array(sorted(cells))
    fresh = _as_i32(tbit.pack_block_host(live[:, 0], live[:, 1], n_dst,
                                         n_src)).to(dev)
    assert torch.equal(a, fresh)
    f = torch.from_numpy((rng.random((4, n_src)) < 0.02).astype(
        np.uint8)).to(dev)
    f[:, [5, 31, 63]] = 1
    vb = tbit.pack_frontier(f, n_src)
    assert torch.equal(tbit.bit_or_matmul(a, vb, 4),
                       tbit.bit_or_matmul_plain(fresh, vb, 4))
