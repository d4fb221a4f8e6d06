"""The hash-key twins against the JAX package's hashing, mix and window
mask, bit for bit (sorted int64 keys, exact), on the hazard cases of
``ops/hash_keys_cases.py``; ``KmerMapper.map_chunk`` on both steps against
the oracle's node counts; and the hashing leftovers (``rolling_kmer_hash``,
``rolling_revcomp_hash``, ``mix64``, ``bucket_of``) against their JAX
originals. The kernels themselves are held to these twins in
``tests/test_torch_hash_kernels.py`` (jax-free, ``cuda`` marker)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmer_mapper_tpu import oracle as ref_oracle
from kmer_mapper_tpu.index import layout as ref_layout
from kmer_mapper_tpu.models import mapper as ref_mapper
from kmer_mapper_tpu.models.mapper import MapperConfig as JaxConfig
from kmer_mapper_tpu.ops import hashing as ref_hashing
from kmer_mapper_tpu.ops import u32hash as ref_u32
from kmer_mapper_tpu_torch import oracle
from kmer_mapper_tpu_torch.index import kmer_index
from kmer_mapper_tpu_torch.io import readers
from kmer_mapper_tpu_torch.models.mapper import KmerMapper, MapperConfig
from kmer_mapper_tpu_torch.ops import hash_keys_cases, hashing, u32hash

WRAP_SEED = hash_keys_cases.SEEDS[1]
INVALID = np.uint32(0xFFFFFFFF)


def _keys(m_lo, m_hi) -> np.ndarray:
    """Sorted int64 sort keys of the valid (not all-ones) mixed pairs."""
    m_lo, m_hi = np.asarray(m_lo, np.uint32), np.asarray(m_hi, np.uint32)
    keep = ~((m_lo == INVALID) & (m_hi == INVALID))
    keys = (((m_lo[keep] ^ np.uint32(0x80000000)).astype(np.uint64) << np.uint64(32))
            | m_hi[keep].astype(np.uint64))
    return np.sort(keys.view(np.int64))


def _jax_plane(packed, k, L, n_reads, seed, revcomp):
    m_lo, m_hi = ref_hashing.plane_hash_mixed(
        jnp.asarray(packed), k, L, jnp.int32(n_reads), seed, pad_to=128, revcomp=revcomp)
    return _keys(m_lo, m_hi)


def _jax_ragged(packed, lengths, n_bases, k, seed, revcomp):
    """The JAX chunk_step's hashing (models/mapper.py:107-147): rolling hash
    of every base, window mask from the lengths' exclusive prefix sum, the
    reverse complements, the mix; invalid windows dropped."""
    buf = (len(packed) - 2) * 16
    lo, hi = ref_hashing.rolling_kmer_hash_packed(jnp.asarray(packed), k)
    lengths = jnp.asarray(lengths).astype(jnp.int32)
    valid = ref_hashing.window_mask(jnp.cumsum(lengths) - lengths, jnp.int32(n_bases), k, buf)
    if revcomp:
        rlo, rhi = ref_hashing.revcomp_lo_hi(lo, hi, k)
        lo, hi = jnp.concatenate([lo, rlo]), jnp.concatenate([hi, rhi])
        valid = jnp.concatenate([valid, valid])
    m_lo, m_hi = ref_u32.feistel_mix(lo, hi, seed=seed, xp=jnp)
    valid = np.asarray(valid)
    return _keys(np.asarray(m_lo)[valid], np.asarray(m_hi)[valid])


@pytest.mark.parametrize("seed", hash_keys_cases.SEEDS)
@pytest.mark.parametrize("revcomp", [False, True])
@pytest.mark.parametrize("k,L", hash_keys_cases.plane_configs())
def test_plane_twin_matches_jax(k, L, revcomp, seed):
    """n_reads of 0, 1, rows - 1 and rows at seed 0; the partly and the
    fully read buffer at the wrapping seed (the rows past n_reads hold
    reads, which JAX marks invalid and the twin never hashes)."""
    packed, rows = hash_keys_cases.plane_buffer(k, L)
    n_reads = {0, 1, rows - 1, rows} if seed == 0 else {rows - 1, rows}
    words = torch.from_numpy(packed.view(np.int32))
    for m in sorted(n_reads):
        got = hashing.plane_hash_keys(words, k, L, m, seed, revcomp)
        assert got.numel() == m * (L - k + 1) * (2 if revcomp else 1)
        np.testing.assert_array_equal(np.sort(got.numpy()),
                                      _jax_plane(packed, k, L, m, seed, revcomp))


@pytest.mark.parametrize("revcomp", [False, True])
@pytest.mark.parametrize("name,k", hash_keys_cases.ragged_configs())
def test_ragged_twin_matches_jax(name, k, revcomp):
    for packed, lengths, n_bases, _, _ in hash_keys_cases.ragged_buffers(name, k):
        words = torch.from_numpy(packed.view(np.int32))
        lens = torch.from_numpy(lengths.astype(np.int32))
        for seed in hash_keys_cases.SEEDS:
            got, _ = hashing.ragged_hash_keys(words, lens, n_bases, k, seed, revcomp)
            np.testing.assert_array_equal(
                np.sort(got.numpy()), _jax_ragged(packed, lengths, n_bases, k, seed, revcomp))


def _jax_n_valid(packed, lengths, n_bases, k, revcomp):
    """The n_valid that JAX's ``chunk_step`` returns (its gather probe, on a
    small table of its own) for this buffer."""
    table = ref_layout.build_table(np.arange(1, 200, dtype=np.uint64) * 7919, n_buckets=64)
    config = JaxConfig(k=k, buf=(len(packed) - 2) * 16, max_reads=len(lengths),
                       revcomp=revcomp, probe="gather")
    counts = jnp.zeros(table.n_slots, dtype=jnp.uint32)
    _, n_valid = ref_mapper.chunk_step(
        jnp.asarray(table.key_lo), jnp.asarray(table.key_hi), counts, jnp.asarray(packed),
        jnp.asarray(lengths), jnp.int32(n_bases), config=config, max_probe=table.max_probe,
        seed=table.seed)
    return int(n_valid)


@pytest.mark.parametrize("revcomp", [False, True])
@pytest.mark.parametrize("name,k", hash_keys_cases.ragged_configs())
def test_ragged_count_matches_jax_chunk_step_n_valid(name, k, revcomp):
    """The ragged step's count (keys, valid windows): the offsets' twin's,
    and the wrapper's, == (n_valid, n_valid) x (2 with revcomp, 1) of JAX's
    ``chunk_step`` on the same buffer."""
    for packed, lengths, n_bases, _, _ in hash_keys_cases.ragged_buffers(name, k):
        n_valid = _jax_n_valid(packed, lengths, n_bases, k, revcomp)
        expect = [n_valid * (2 if revcomp else 1), n_valid]
        lens = torch.from_numpy(lengths.astype(np.int32))
        assert hashing.ragged_offsets(lens, n_bases, k, revcomp)[2].tolist() == expect
        _, count = hashing.ragged_hash_keys(torch.from_numpy(packed.view(np.int32)), lens,
                                            n_bases, k, 3, revcomp)
        assert count.tolist() == expect


def _reads(rng, lengths, alphabet="ACGTN"):
    return ["".join(rng.choice(list(alphabet), n)) for n in lengths]


@pytest.mark.parametrize("revcomp", [False, True])
@pytest.mark.parametrize("step", ["plane", "ragged"])
def test_map_chunk_matches_oracle(step, revcomp):
    """Both chunk steps on the CPU, through the packer's buffers (the last
    one partly filled), give the oracle's node counts; the hash twins ran."""
    rng = np.random.default_rng(40 + revcomp)
    k, L = 21, 61
    lengths = np.full(90, L) if step == "plane" else rng.integers(0, 120, 90)
    reads = _reads(rng, lengths)
    codes = oracle.encode_bytes(np.frombuffer("".join(reads).encode(), np.uint8))
    kmers = oracle.kmer_hashes_ragged(codes, lengths, k)
    if revcomp:
        kmers = np.concatenate([kmers, oracle.revcomp_hash(kmers, k)])
    entries = np.concatenate([kmers[::4], rng.integers(0, 1 << 42, 200, dtype=np.uint64)])
    arrays = oracle.build_kmer_index(entries, rng.integers(0, 50, len(entries)), 4099)
    config = MapperConfig(k=k, buf=1024, max_reads=32, revcomp=revcomp,
                          read_len=L if step == "plane" else 0)
    mapper = KmerMapper(kmer_index.KmerIndex.from_arrays(arrays), config, "cpu")
    chunk = readers.SequenceChunk(np.frombuffer("".join(reads).encode(), np.uint8).copy(),
                                  np.cumsum(lengths) - lengths)
    twin = f"{step}_hash_keys_reference"
    before = dict(hashing.launch_counts)
    n_chunks = 0
    for packed, lens, n_bases, n_reads, n_invalid, *strided in readers.pack_for_device(
            iter([chunk]), config.buf, config.max_reads, k, read_len=config.read_len):
        assert bool(strided and strided[0]) == (step == "plane")
        mapper.map_chunk(packed, lens, n_bases, n_invalid, strided=step == "plane")
        n_chunks += 1
    assert n_chunks > 1
    assert hashing.launch_counts[twin] == before[twin] + n_chunks
    assert hashing.launch_counts[f"{step}_hash_keys"] == before[f"{step}_hash_keys"]
    np.testing.assert_array_equal(mapper.node_counts(), oracle.map_kmers_to_index(arrays, kmers))
    assert mapper.n_kmers_mapped == len(kmers) // (2 if revcomp else 1)


def _codes_t(codes):
    return torch.from_numpy(codes.astype(np.int64))


@pytest.mark.parametrize("k", [1, 4, 16, 17, 31])
def test_rolling_kmer_hash_matches_jax(k):
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4, 300).astype(np.uint8)
    padded = np.concatenate([codes, np.zeros(k, dtype=np.uint8)]).astype(np.uint32)
    lo, hi = hashing.rolling_kmer_hash(_codes_t(padded), k)
    j_lo, j_hi = ref_hashing.rolling_kmer_hash(jnp.asarray(padded), k)
    np.testing.assert_array_equal(lo.numpy(), np.asarray(j_lo).astype(np.int64))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(j_hi).astype(np.int64))
    got = ref_u32.join_u64(lo.numpy().astype(np.uint32), hi.numpy().astype(np.uint32))
    expect = ref_oracle.kmer_hashes(codes, k)
    np.testing.assert_array_equal(got[: len(expect)], expect)


@pytest.mark.parametrize("k", [2, 16, 31])
def test_rolling_revcomp_hash_matches_jax(k):
    rng = np.random.default_rng(k + 50)
    codes = rng.integers(0, 4, 200).astype(np.uint8)
    padded = np.concatenate([codes, np.zeros(k, dtype=np.uint8)]).astype(np.uint32)
    lo, hi = hashing.rolling_revcomp_hash(_codes_t(padded), k)
    j_lo, j_hi = ref_hashing.rolling_revcomp_hash(jnp.asarray(padded), k)
    np.testing.assert_array_equal(lo.numpy(), np.asarray(j_lo).astype(np.int64))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(j_hi).astype(np.int64))
    got = ref_u32.join_u64(lo.numpy().astype(np.uint32), hi.numpy().astype(np.uint32))
    expect = ref_oracle.revcomp_hash(ref_oracle.kmer_hashes(codes, k), k)
    np.testing.assert_array_equal(got[: len(expect)], expect)


@pytest.mark.parametrize("seed", [0, 7, WRAP_SEED])
def test_mix64_matches_jax(seed):
    rng = np.random.default_rng(0)
    lo, hi = ref_u32.split_u64(rng.integers(0, 1 << 62, 1000, dtype=np.uint64))
    expect = ref_u32.mix64(lo, hi, seed=seed, xp=np)
    np.testing.assert_array_equal(
        np.asarray(ref_u32.mix64(jnp.asarray(lo), jnp.asarray(hi), seed=seed, xp=jnp)), expect)
    np.testing.assert_array_equal(u32hash.mix64(lo, hi, seed), expect)
    got = u32hash.mix64_torch(_codes_t(lo), _codes_t(hi), seed)
    np.testing.assert_array_equal(got.numpy(), expect.astype(np.int64))


@pytest.mark.parametrize("n_buckets", [1, 2, 1 << 10])
def test_bucket_of_matches_jax(n_buckets):
    """bucket_of equals the JAX original and the high bits of the mixed low
    word, and spreads clustered kmers (test_device_ops.py's check)."""
    kmers = np.arange(1 << 14, dtype=np.uint64) | (np.uint64(0x2AB) << np.uint64(40))
    lo, hi = ref_u32.split_u64(kmers)
    expect = ref_u32.bucket_of(lo, hi, n_buckets, seed=0)
    np.testing.assert_array_equal(
        np.asarray(ref_u32.bucket_of(jnp.asarray(lo), jnp.asarray(hi), n_buckets, xp=jnp)),
        expect)
    np.testing.assert_array_equal(u32hash.bucket_of(lo, hi, n_buckets), expect)
    got = u32hash.bucket_of_torch(_codes_t(lo), _codes_t(hi), n_buckets)
    np.testing.assert_array_equal(got.numpy(), expect.astype(np.int64))
    m_lo, _ = u32hash.feistel_mix(lo, hi)
    np.testing.assert_array_equal(expect, u32hash.bucket_from_mlo(m_lo, n_buckets))
    counts = np.bincount(expect.astype(np.int64), minlength=n_buckets)
    assert counts.max() < 16 * (len(kmers) / n_buckets)
