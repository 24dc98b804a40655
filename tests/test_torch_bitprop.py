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


@pytest.mark.cuda
def test_cuda_kernels_match_plain():
    """On the card: each kernel byte-equal to its plain version, launch
    counts move only on kernel launches, and bad inputs raise."""
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
    for n_dst, n_src, b in ((384, 128, 33), (1024, 2048, 64), (128, 16, 1)):
        A = torch.from_numpy(
            (rng.random((n_dst, n_src)) < 0.05).astype(np.int8)).to(dev)
        f = torch.from_numpy(
            (rng.random((b, n_src)) < 0.1).astype(np.uint8)).to(dev)
        got = tbit.dense_or_matmul(A, f)
        torch.cuda.synchronize()
        assert torch.equal(got, tbit.dense_or_matmul_plain(A, f))
    with pytest.raises(ValueError):
        tbit.dense_or_matmul(A.to(torch.int32), f)
    # a contiguous view that is not 16-byte aligned cannot feed int4 loads
    wide = torch.zeros((1, 2 * A.shape[1]), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError, match="aligned"):
        tbit.dense_or_matmul(A, wide[:, 1:1 + A.shape[1]])
