"""The port's KmerMapper (strided plane step and ragged step) against the JAX
KmerMapper and the numpy oracle; count state carried between the packages."""
import dataclasses

import numpy as np
import pytest

from kmer_mapper_tpu import oracle as ref_oracle
from kmer_mapper_tpu.index import kmer_index as ref_ki
from kmer_mapper_tpu.models import mapper as ref_mapper
from kmer_mapper_tpu_torch.index import kmer_index as ki
from kmer_mapper_tpu_torch.io import readers
from kmer_mapper_tpu_torch.models.mapper import KmerMapper, MapperConfig, state_from_jax
from kmer_mapper_tpu_torch.ops import stream_probe


def _reads(rng, n, L, alphabet="ACGTN"):
    if isinstance(L, int):
        L = [L] * n
    return ["".join(rng.choice(list(alphabet), ln)) for ln in L]


def _pack(reads, config, read_len=0):
    flat = "".join(reads)
    starts = np.cumsum([0] + [len(r) for r in reads[:-1]]).astype(np.int64)
    chunk = readers.SequenceChunk(np.frombuffer(flat.encode(), np.uint8).copy(), starts)
    return list(readers.pack_for_device(
        iter([chunk]), config.buf, config.max_reads, config.k, read_len=read_len
    ))


def _kmers(reads, k, revcomp=False):
    codes = [ref_oracle.encode_string(r.upper().replace("N", "A")) for r in reads]
    h = ref_oracle.kmer_hashes_ragged(
        np.concatenate(codes), np.array([len(c) for c in codes]), k
    )
    return np.concatenate([h, ref_oracle.revcomp_hash(h, k)]) if revcomp else h


def _indexes(rng, reads, k, n_nodes=60, n_random=64):
    """(oracle arrays, port KmerIndex, JAX TpuKmerIndex) of the same entries."""
    kmers = _kmers(reads, k, revcomp=True)
    mask = np.uint64(4**k - 1)
    entries = np.concatenate([
        kmers[:: max(1, len(kmers) // 80)],
        rng.integers(0, 1 << 62, n_random, dtype=np.uint64) & mask,
    ])
    nodes = rng.integers(0, n_nodes, len(entries)).astype(np.int32)
    arrays = ref_oracle.build_kmer_index(entries, nodes, 997)
    return arrays, ki.KmerIndex.from_arrays(arrays), ref_ki.TpuKmerIndex.from_arrays(arrays)


def _jax_config(config, **kw):
    return ref_mapper.MapperConfig(
        k=config.k, buf=config.buf, max_reads=config.max_reads,
        revcomp=config.revcomp, read_len=config.read_len,
        probe="stream", interpret=True, stream_cap=128, **kw,
    )


@pytest.mark.parametrize("revcomp", [False, True])
def test_strided_chunks_match_jax_and_oracle(revcomp):
    rng = np.random.default_rng(1 + revcomp)
    L, k = 51, 31
    reads = _reads(rng, 150, L)
    arrays, index, ref_index = _indexes(rng, reads, k)
    config = MapperConfig(k=k, buf=1 << 12, max_reads=256, revcomp=revcomp, read_len=L)
    mapper = KmerMapper(index, config, "cpu")
    ref = ref_mapper.KmerMapper(ref_index, _jax_config(config))
    chunks = _pack(reads, config, read_len=L)
    assert len(chunks) > 1
    for packed, lengths, nb, _, ninv, strided in chunks:
        assert strided
        mapper.map_chunk(packed, lengths, nb, ninv, strided=True)
        ref.map_chunk(packed, lengths, nb, ninv, strided=True)
    np.testing.assert_array_equal(mapper.slot_counts(), ref.slot_counts())
    np.testing.assert_array_equal(
        mapper.node_counts(),
        ref_oracle.map_kmers_to_index(arrays, _kmers(reads, k, revcomp)),
    )
    assert mapper.n_kmers_mapped == ref.n_kmers_mapped == len(reads) * (L - k + 1)


@pytest.mark.parametrize("revcomp", [False, True])
def test_ragged_chunks_match_jax_and_oracle(revcomp):
    rng = np.random.default_rng(7 + revcomp)
    k = 9
    reads = _reads(rng, 80, list(rng.integers(6, 50, 80)), "ACGT")
    arrays, index, ref_index = _indexes(rng, reads, k, n_nodes=70)
    config = MapperConfig(k=k, buf=8192, max_reads=256, revcomp=revcomp)
    mapper = KmerMapper(index, config, "cpu")
    ref = ref_mapper.KmerMapper(ref_index, _jax_config(config))
    for packed, lengths, nb, _, ninv in _pack(reads, config):
        mapper.map_chunk(packed, lengths, nb, ninv)
        ref.map_chunk(packed, lengths, nb, ninv)
    np.testing.assert_array_equal(mapper.slot_counts(), ref.slot_counts())
    np.testing.assert_array_equal(
        mapper.node_counts(),
        ref_oracle.map_kmers_to_index(arrays, _kmers(reads, k, revcomp)),
    )
    assert mapper.n_kmers_mapped == ref.n_kmers_mapped == len(_kmers(reads, k))


def test_fixed_read_len_mapper_takes_ragged_chunks():
    rng = np.random.default_rng(12)
    k, L = 9, 31
    uniform = _reads(rng, 20, L, "ACGT")
    ragged = _reads(rng, 20, list(rng.integers(12, 60, 20)), "ACGT")
    arrays, index, _ = _indexes(rng, uniform + ragged, k, n_nodes=50)
    config = MapperConfig(k=k, buf=4096, max_reads=128, read_len=L)
    mapper = KmerMapper(index, config, "cpu")
    (packed, lengths, nb, _, ninv, strided), = _pack(uniform, config, read_len=L)
    assert strided
    mapper.map_chunk(packed, lengths, nb, ninv, strided=True)
    (packed, lengths, nb, _, ninv, strided), = _pack(ragged, config, read_len=L)
    assert not strided
    mapper.map_chunk(packed, lengths, nb, ninv)
    expect = ref_oracle.map_kmers_to_index(arrays, _kmers(uniform + ragged, k))
    np.testing.assert_array_equal(mapper.node_counts(), expect)
    assert mapper.n_kmers_mapped == len(_kmers(uniform + ragged, k))
    mapper.reset_counts()
    assert mapper.n_kmers_mapped == 0 and not mapper.slot_counts().any()


@pytest.mark.parametrize("group", [1, 2])
def test_state_from_jax_device_counts(group):
    rng = np.random.default_rng(20)
    L, k = 51, 31
    reads = _reads(rng, 60, L)
    _, index, ref_index = _indexes(rng, reads, k, n_random=2000)  # 4 chain blocks
    config = MapperConfig(k=k, buf=1 << 12, max_reads=256, read_len=L)
    ref = ref_mapper.KmerMapper(ref_index, _jax_config(config, group=group))
    mapper = KmerMapper(index, config, "cpu")
    for packed, lengths, nb, _, ninv, _ in _pack(reads, config, read_len=L):
        ref.map_chunk(packed, lengths, nb, ninv, strided=True)
        mapper.map_chunk(packed, lengths, nb, ninv, strided=True)
    gpb = ref._gpb
    assert gpb == 128 * group
    carried = state_from_jax(np.asarray(ref.counts), index.table.n_buckets, gpb)
    np.testing.assert_array_equal(carried, ref.slot_counts())
    np.testing.assert_array_equal(carried, mapper.slot_counts())
    # and back: the port's slot order -> the JAX mapper's plane order
    np.testing.assert_array_equal(
        stream_probe.slot_to_plane(mapper.slot_counts(), index.table.n_buckets, gpb),
        np.asarray(ref.counts),
    )


def test_checkpoints_cross_packages(tmp_path):
    rng = np.random.default_rng(30)
    L, k = 51, 31
    reads = _reads(rng, 120, L)
    _, index, ref_index = _indexes(rng, reads, k)
    config = MapperConfig(k=k, buf=1 << 11, max_reads=256, read_len=L)
    chunks = _pack(reads, config, read_len=L)
    assert len(chunks) >= 3
    first, rest = chunks[:1], chunks[1:]
    # the JAX gather mapper takes continuous buffers of the same reads
    ref_cfg = ref_mapper.MapperConfig(k=k, buf=config.buf, max_reads=config.max_reads)
    cont = _pack(reads, config)

    full = KmerMapper(index, config, "cpu")
    for packed, lengths, nb, _, ninv, _ in chunks:
        full.map_chunk(packed, lengths, nb, ninv, strided=True)

    # written by the JAX package, resumed by the port
    ref = ref_mapper.KmerMapper(ref_index, ref_cfg)
    for packed, lengths, nb, _, ninv in cont[:1]:
        ref.map_chunk(packed, lengths, nb, ninv)
    ref.save_state(tmp_path / "jax.npz")
    resumed = KmerMapper(index, config, "cpu")
    resumed.load_state(tmp_path / "jax.npz")
    for packed, lengths, nb, _, ninv, _ in rest:
        resumed.map_chunk(packed, lengths, nb, ninv, strided=True)
    np.testing.assert_array_equal(resumed.slot_counts(), full.slot_counts())
    assert resumed.n_kmers_mapped == full.n_kmers_mapped

    # written by the port, resumed by the JAX package
    port = KmerMapper(index, config, "cpu")
    for packed, lengths, nb, _, ninv, _ in first:
        port.map_chunk(packed, lengths, nb, ninv, strided=True)
    port.save_state(tmp_path / "torch.npz")
    ref2 = ref_mapper.KmerMapper(ref_index, ref_cfg)
    ref2.load_state(tmp_path / "torch.npz")
    for packed, lengths, nb, _, ninv in cont[1:]:
        ref2.map_chunk(packed, lengths, nb, ninv)
    np.testing.assert_array_equal(ref2.slot_counts(), full.slot_counts())
    assert ref2.n_kmers_mapped == full.n_kmers_mapped


def test_config_and_input_validation(tmp_path):
    with pytest.raises(ValueError):
        MapperConfig(k=32)
    with pytest.raises(ValueError):
        MapperConfig(buf=1000)
    with pytest.raises(ValueError):
        MapperConfig(k=31, read_len=20)
    rng = np.random.default_rng(40)
    reads = _reads(rng, 10, 40)
    _, index, _ = _indexes(rng, reads, 21)
    config = MapperConfig(k=21, buf=1 << 11, max_reads=64)
    mapper = KmerMapper(index, config, "cpu")
    (packed, lengths, nb, _, _), = _pack(reads, config)
    with pytest.raises(ValueError, match="read_len"):
        mapper.map_chunk(packed, lengths, nb, strided=True)
    with pytest.raises(TypeError):
        mapper.map_chunk(packed.astype(np.int64), lengths, nb)
    np.savez(tmp_path / "bad.npz", counts=np.zeros(3, np.uint32), n_kmers=0, n_invalid=0)
    with pytest.raises(ValueError, match="slot counts"):
        mapper.load_state(tmp_path / "bad.npz")
    assert dataclasses.replace(config, revcomp=True).revcomp
