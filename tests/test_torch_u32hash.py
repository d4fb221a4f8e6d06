"""The port's 32-bit hashing (numpy copy and torch half) against the JAX
package's numpy original, bit for bit."""
import numpy as np
import pytest
import torch

from kmer_mapper_tpu.ops import u32hash as ref
from kmer_mapper_tpu_torch.ops import u32hash as port

EDGE = np.array(
    [0, 1, 0x7FFFFFFF, 0x80000000, 0x80000001, 0xFFFFFFFE, 0xFFFFFFFF], np.uint32
)


def _words(seed, n=4096):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << 32, n, dtype=np.int64).astype(np.uint32)
    x[: len(EDGE)] = EDGE
    x[len(EDGE) : len(EDGE) + 512] |= np.uint32(0x80000000)  # top bit set
    return x


def _t(x):
    return torch.from_numpy(x.astype(np.int64))


@pytest.mark.parametrize("seed", [0, 13, 26, 2**32 - 1])
def test_feistel_mix_torch_matches_numpy(seed):
    lo, hi = _words(seed % 1000), _words(seed % 1000 + 1)
    exp_lo, exp_hi = ref.feistel_mix(lo, hi, seed=seed)
    got_lo, got_hi = port.feistel_mix_torch(_t(lo), _t(hi), seed)
    np.testing.assert_array_equal(got_lo.numpy(), exp_lo.astype(np.int64))
    np.testing.assert_array_equal(got_hi.numpy(), exp_hi.astype(np.int64))
    np_lo, np_hi = port.feistel_mix(lo, hi, seed=seed)
    np.testing.assert_array_equal(np_lo, exp_lo)
    np.testing.assert_array_equal(np_hi, exp_hi)


@pytest.mark.parametrize("n", [7, 100, 5000])  # both numpy paths (size > 1024)
def test_fmix32_matches(n):
    x = _words(n, n) if n >= len(EDGE) else EDGE
    expect = ref.fmix32(x)
    np.testing.assert_array_equal(port.fmix32(x), expect)
    np.testing.assert_array_equal(
        port.fmix32_torch(_t(x)).numpy(), expect.astype(np.int64)
    )


def test_all_ones_sentinel_and_edges_exact():
    got = port.fmix32_torch(_t(EDGE)).numpy()
    np.testing.assert_array_equal(got, ref.fmix32(EDGE).astype(np.int64))
    assert got.min() >= 0 and got.max() <= 0xFFFFFFFF
    # the all-ones pair survives the int32 bit-pattern round trip exactly
    ones = torch.tensor([0xFFFFFFFF, 0x80000000, 0, 5], dtype=torch.int64)
    bits = port.to_int32_bits(ones)
    assert bits.dtype == torch.int32 and bits.tolist() == [-1, -(2**31), 0, 5]
    np.testing.assert_array_equal(port.from_int32_bits(bits).numpy(), ones.numpy())


@pytest.mark.parametrize("n_buckets", [1, 2, 4, 128, 1 << 10, 1 << 20, 1 << 29])
def test_bucket_from_mlo_torch_matches_numpy(n_buckets):
    m_lo = _words(n_buckets % 97)
    assert port.bucket_shift(n_buckets) == ref.bucket_shift(n_buckets)
    expect = ref.bucket_from_mlo(m_lo, n_buckets)
    np.testing.assert_array_equal(port.bucket_from_mlo(m_lo, n_buckets), expect)
    got = port.bucket_from_mlo_torch(_t(m_lo), n_buckets).numpy()
    np.testing.assert_array_equal(got, expect.astype(np.int64))
    assert got.max() < n_buckets


def test_split_u64_matches():
    rng = np.random.default_rng(5)
    k = rng.integers(0, 1 << 62, 1000, dtype=np.uint64)
    k[:2] = [0, (1 << 64) - 1]
    for a, b in zip(port.split_u64(k), ref.split_u64(k)):
        np.testing.assert_array_equal(a, b)
