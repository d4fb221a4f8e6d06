"""The port's torch hashing (plane hash + mix, rolling hash, revcomp, window
mask, host packing) against the JAX functions and the numpy oracle."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmer_mapper_tpu import oracle as ref_oracle
from kmer_mapper_tpu.io import readers as ref_readers
from kmer_mapper_tpu.ops import encode as ref_encode
from kmer_mapper_tpu.ops import hashing as ref_hashing
from kmer_mapper_tpu.ops.u32hash import join_u64, split_u64
from kmer_mapper_tpu_torch.io import readers
from kmer_mapper_tpu_torch.ops import encode, hashing
from kmer_mapper_tpu_torch.ops.stream_probe import INVALID_WORD

MASK = np.uint64(0xFFFFFFFF)


def _t(x):
    """uint32 numpy words -> int64-held torch words."""
    return torch.from_numpy(np.asarray(x).astype(np.int64))


def _strided(reads, L, k, buf=1 << 12):
    flat = "".join(reads)
    chunk = readers.SequenceChunk(
        np.frombuffer(flat.encode(), np.uint8).copy(),
        np.arange(len(reads), dtype=np.int64) * L,
    )
    (packed, _, _, n_reads, _, strided), = readers.pack_for_device(
        iter([chunk]), buf, 256, k, read_len=L
    )
    assert strided
    return packed, n_reads


def _pairs(lo, hi):
    return np.sort((np.asarray(lo, np.uint64) << np.uint64(32)) | np.asarray(hi, np.uint64))


@pytest.mark.parametrize("revcomp", [False, True])
@pytest.mark.parametrize("L", [31, 51, 151])
@pytest.mark.parametrize("k", [16, 21, 31])
def test_plane_hash_mixed_matches_jax(k, L, revcomp):
    rng = np.random.default_rng(k * 1000 + L)
    n_reads = 20  # fewer than the buffer's rows: the rest must be invalid
    reads = ["".join(rng.choice(list("ACGTN"), L)) for _ in range(n_reads)]
    packed, nr = _strided(reads, L, k)
    seed = 13
    m_lo, m_hi = hashing.plane_hash_mixed(_t(packed), k, L, nr, seed, revcomp=revcomp)
    j_lo, j_hi = ref_hashing.plane_hash_mixed(
        jnp.asarray(packed), k, L, jnp.int32(nr), seed, pad_to=128, revcomp=revcomp
    )
    got = _pairs(m_lo.numpy(), m_hi.numpy())
    expect = _pairs(np.asarray(j_lo), np.asarray(j_hi))
    invalid = (np.uint64(INVALID_WORD) << np.uint64(32)) | np.uint64(INVALID_WORD)
    n_valid = n_reads * (L - k + 1) * (2 if revcomp else 1)
    # the same multiset of valid words; the JAX tail pad is all-ones too
    np.testing.assert_array_equal(got[:n_valid], expect[:n_valid])
    assert (got[n_valid:] == invalid).all() and (expect[n_valid:] == invalid).all()
    rows = len(packed) // (hashing.read_stride(L) // 16)
    assert len(got) == rows * (L - k + 1) * (2 if revcomp else 1)


@pytest.mark.parametrize("k", [1, 4, 15, 16, 17, 31])
def test_rolling_kmer_hash_packed_matches(k):
    rng = np.random.default_rng(k + 200)
    n = 512
    codes = rng.integers(0, 4, n).astype(np.uint8)
    packed, _ = encode.host_encode_pack(
        np.frombuffer("".join("ACGT"[c] for c in codes).encode(), np.uint8),
        n // 16 + 2,
    )
    lo, hi = hashing.rolling_kmer_hash_packed(_t(packed), k)
    j_lo, j_hi = ref_hashing.rolling_kmer_hash_packed(jnp.asarray(packed), k)
    np.testing.assert_array_equal(lo.numpy(), np.asarray(j_lo).astype(np.int64))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(j_hi).astype(np.int64))
    got = join_u64(lo.numpy().astype(np.uint32), hi.numpy().astype(np.uint32))
    expect = ref_oracle.kmer_hashes(codes, k)
    np.testing.assert_array_equal(got[: len(expect)], expect)


@pytest.mark.parametrize("k", [1, 4, 16, 17, 31])
def test_revcomp_lo_hi_matches(k):
    rng = np.random.default_rng(k + 300)
    kmers = rng.integers(0, 1 << (2 * k), 500, dtype=np.uint64)
    lo, hi = split_u64(kmers)
    rlo, rhi = hashing.revcomp_lo_hi(_t(lo), _t(hi), k)
    j_lo, j_hi = ref_hashing.revcomp_lo_hi(jnp.asarray(lo), jnp.asarray(hi), k)
    np.testing.assert_array_equal(rlo.numpy(), np.asarray(j_lo).astype(np.int64))
    np.testing.assert_array_equal(rhi.numpy(), np.asarray(j_hi).astype(np.int64))
    got = join_u64(rlo.numpy().astype(np.uint32), rhi.numpy().astype(np.uint32))
    np.testing.assert_array_equal(got, ref_oracle.revcomp_hash(kmers, k))


def test_window_mask_matches_jax():
    rng = np.random.default_rng(9)
    k, buf = 7, 256
    lengths = rng.integers(1, 30, 12)
    n_bases = int(lengths.sum())
    starts = np.zeros(32, dtype=np.int64)
    starts[: len(lengths)] = np.cumsum(lengths) - lengths
    starts[len(lengths) :] = n_bases  # chunk_step's padding
    got = hashing.window_mask(torch.from_numpy(starts), n_bases, k, buf).numpy()
    expect = ref_hashing.window_mask(
        jnp.asarray(starts.astype(np.int32)), jnp.int32(n_bases), k, buf
    )
    np.testing.assert_array_equal(got, np.asarray(expect))
    # the padding contract: entries at buf + k or beyond are dropped
    starts_big = np.where(np.arange(32) < len(lengths), starts, buf + k)
    got_big = hashing.window_mask(torch.from_numpy(starts_big), n_bases, k, buf)
    np.testing.assert_array_equal(got_big.numpy(), got)
    assert got.sum() == sum(max(0, ln - k + 1) for ln in lengths)


def test_host_packing_matches_jax():
    rng = np.random.default_rng(10)
    bases = np.frombuffer("".join(rng.choice(list("ACGTNx"), 1000)).encode(), np.uint8)
    packed, n_invalid = encode.host_encode_pack(bases, 70)
    expect, expect_invalid = ref_encode.host_encode_pack(bases, 70)
    np.testing.assert_array_equal(packed, expect)
    assert n_invalid == expect_invalid > 0
    assert hashing.read_stride(151) == ref_hashing.read_stride(151) == 160
    # restride of a continuous buffer equals the JAX numpy restride
    L = 37
    reads = ["".join(rng.choice(list("ACGT"), L)) for _ in range(30)]
    chunk = readers.SequenceChunk(
        np.frombuffer("".join(reads).encode(), np.uint8).copy(),
        np.arange(30, dtype=np.int64) * L,
    )
    (cont, *_), = readers.pack_for_device(iter([chunk]), 1 << 11, 64, 21)
    rows = readers.strided_rows(1 << 11, L)
    np.testing.assert_array_equal(
        readers.restride_packed(cont, 30, L, rows),
        ref_readers.restride_packed(cont, 30, L, rows),
    )
