"""The port's multi-device mapping (``kmer_mapper_tpu_torch/parallel``) on
grids of repeated CPU devices: node counts == the numpy oracle == the JAX
package's ``ShardedKmerMapper`` (its default gather config on the 8 forced
host devices of ``tests/conftest.py``) on the same inputs, bit for bit.
Mirrors ``tests/test_sharded.py``; its TPU-workaround cases (paged
schedules, multi-stream, group widening) have no counterpart here."""
import numpy as np
import pytest
import torch

from kmer_mapper_tpu import oracle as jax_oracle
from kmer_mapper_tpu.index import kmer_index as jax_ki
from kmer_mapper_tpu.models.mapper import MapperConfig as JaxConfig
from kmer_mapper_tpu.parallel import ShardedKmerMapper as JaxSharded
from kmer_mapper_tpu.parallel import batch_packed_chunks as jax_batches
from kmer_mapper_tpu.parallel import make_mesh as jax_mesh
from kmer_mapper_tpu_torch import oracle
from kmer_mapper_tpu_torch.index import kmer_index as ki
from kmer_mapper_tpu_torch.index import layout
from kmer_mapper_tpu_torch.io import readers
from kmer_mapper_tpu_torch.models.mapper import MapperConfig
from kmer_mapper_tpu_torch.ops import finalize, hashing, probe, stream_probe
from kmer_mapper_tpu_torch.parallel import (
    INDEX_AXIS, ShardedKmerMapper, batch_packed_chunks, make_mesh,
)

CPU8 = [torch.device("cpu")] * 8


def _setup(rng, k, n_reads=200):
    reads = ["".join(rng.choice(list("ACGT"), rng.integers(20, 80))) for _ in range(n_reads)]
    read_kmers = _kmers(reads, k)
    mask = np.uint64(4**k - 1)
    entry_kmers = np.concatenate(
        [rng.choice(read_kmers, 300), rng.integers(0, 1 << 62, 100, dtype=np.uint64) & mask]
    )
    nodes = rng.integers(0, 150, len(entry_kmers)).astype(np.int32)
    arrays = oracle.build_kmer_index(entry_kmers, nodes, 1999)
    return reads, arrays, oracle.map_kmers_to_index(arrays, read_kmers)


def _kmers(reads, k):
    codes = [oracle.encode_string(r) for r in reads]
    return oracle.kmer_hashes_ragged(np.concatenate(codes), np.array([len(c) for c in codes]), k)


def _chunks_from_reads(reads, buf, max_reads, k):
    flat = "".join(reads)
    chunk = readers.SequenceChunk(
        bases=np.frombuffer(flat.encode(), dtype=np.uint8),
        read_starts=np.cumsum([0] + [len(r) for r in reads[:-1]]).astype(np.int64),
    )
    return readers.pack_for_device(iter([chunk]), buf, max_reads, k)


def _run(mapper, reads, config):
    packed = _chunks_from_reads(reads, config.buf, config.max_reads, config.k)
    for batch in batch_packed_chunks(packed, mapper.n_data, config.packed_words,
                                     config.max_reads):
        mapper.map_batch(*batch)


def _jax(index, reads, shape, k, buf=1024, max_reads=64, revcomp=False, hashes=()):
    """The JAX package's sharded node counts on the same index and reads."""
    d, x = shape
    config = JaxConfig(k=k, buf=buf, max_reads=max_reads, revcomp=revcomp)
    mapper = JaxSharded(_jax_index(index), config, jax_mesh(n_devices=d * x, index_parallel=x))
    for batch in hashes:
        mapper.map_hashes(batch)
    if reads:
        packed = _chunks_from_reads(reads, buf, max_reads, k)
        for batch in jax_batches(packed, mapper.n_data, config.packed_words, max_reads):
            mapper.map_batch(*batch)
    return mapper.node_counts()


def _jax_index(index: ki.KmerIndex):
    """The port's index as the JAX package's (the same table and entries)."""
    return jax_ki.TpuKmerIndex(
        table=index.table, entry_slot=index.entry_slot, entry_node=index.entry_node,
        entry_frequency=index.entry_frequency, max_node_id=index.max_node_id,
        n_unique=index.n_unique,
    )


def _index_with_buckets(arrays, n_buckets):
    unique = np.unique(arrays.kmers)
    table = layout.build_table(unique, n_buckets=n_buckets)
    return ki.KmerIndex(
        table=table, entry_slot=layout.query_table(table, arrays.kmers).astype(np.int32),
        entry_node=arrays.nodes, entry_frequency=arrays.frequencies,
        max_node_id=arrays.max_node_id(), n_unique=len(unique),
    )


def _mapper(index, config, shape):
    d, x = shape
    return ShardedKmerMapper(index, config, make_mesh(n_devices=d * x, index_parallel=x,
                                                      devices=CPU8))


@pytest.mark.parametrize("shape", [(8, 1), (4, 2), (2, 4), (1, 8)])
def test_sharded_mapping_matches_oracle_and_jax(shape):
    d, x = shape
    rng = np.random.default_rng(d * 10 + x)
    k = 9
    reads, arrays, expect = _setup(rng, k)
    config = MapperConfig(k=k, buf=1024, max_reads=64)
    index = ki.KmerIndex.from_arrays(arrays)
    mapper = _mapper(index, config, shape)
    _run(mapper, reads, config)
    got = mapper.node_counts()
    np.testing.assert_array_equal(got, expect)
    np.testing.assert_array_equal(got, _jax(index, reads, shape, k))
    assert mapper.n_kmers_mapped == sum(max(0, len(r) - k + 1) for r in reads)


def test_sharded_revcomp_and_frequency():
    rng = np.random.default_rng(42)
    k = 7
    reads = ["".join(rng.choice(list("ACGT"), 40)) for _ in range(50)]
    fwd = _kmers(reads, k)
    entry_kmers = rng.choice(np.concatenate([fwd, oracle.revcomp_hash(fwd, k)]), 150)
    nodes = rng.integers(0, 60, len(entry_kmers)).astype(np.int32)
    freqs = rng.choice([1, 1001], len(entry_kmers), p=[0.9, 0.1]).astype(np.uint16)
    arrays = oracle.build_kmer_index(entry_kmers, nodes, 499, frequencies=freqs)
    expect = oracle.map_kmers_to_index(arrays, np.concatenate([fwd, oracle.revcomp_hash(fwd, k)]))
    config = MapperConfig(k=k, buf=512, max_reads=32, revcomp=True)
    index = ki.KmerIndex.from_arrays(arrays)
    mapper = _mapper(index, config, (4, 2))
    _run(mapper, reads, config)
    got = mapper.node_counts()
    np.testing.assert_array_equal(got, expect)
    np.testing.assert_array_equal(got, _jax(index, reads, (4, 2), k, buf=512, max_reads=32,
                                            revcomp=True))
    assert (freqs > 1000).any() and got.sum() > 0


def test_sharded_probe_chained_high_load():
    """A high-load table (long chains) in 8 sub-block index shards: every
    key counts exactly once, on the gather route with the rows masked."""
    rng = np.random.default_rng(3)
    keys = np.unique(rng.integers(0, 1 << 62, 2048, dtype=np.uint64))
    n_buckets = layout._next_pow2(int(np.ceil(len(keys) / layout.BUCKET_KEYS / 0.85)))
    table = layout.build_table(keys, n_buckets=n_buckets)
    index = ki.KmerIndex(
        table=table, entry_slot=layout.query_table(table, keys).astype(np.int32),
        entry_node=np.arange(len(keys), dtype=np.int32),
        entry_frequency=np.ones(len(keys), dtype=np.uint16),
        max_node_id=len(keys) - 1, n_unique=len(keys),
    )
    assert table.max_probe > 1 and table.n_buckets // 8 < layout.CHAIN_BLOCK
    k = 31
    config = MapperConfig(k=k, buf=256, max_reads=16)
    mapper = _mapper(index, config, (1, 8))
    assert mapper.route == "gather"
    reads = ["".join(oracle.ALPHABET[(int(key) >> (2 * i)) & 3] for i in range(k))
             for key in keys]
    _run(mapper, reads, config)
    np.testing.assert_array_equal(mapper.node_counts(), 1)
    np.testing.assert_array_equal(_jax(index, reads, (1, 8), k, buf=256, max_reads=16), 1)


@pytest.mark.parametrize("revcomp", [False, True])
def test_sharded_stream_route_matches_oracle(revcomp):
    """Index shards of whole chain blocks take the stream route (the block
    partition over the whole table, the count over the shard's windows,
    shard 1 with a bucket base of 128): == the oracle == JAX."""
    rng = np.random.default_rng(77)
    k = 9
    reads, arrays, _ = _setup(rng, k, n_reads=100)
    index = _index_with_buckets(arrays, 2 * layout.CHAIN_BLOCK)
    config = MapperConfig(k=k, buf=1024, max_reads=64, revcomp=revcomp)
    mapper = _mapper(index, config, (2, 2))
    assert mapper.route == "stream" and mapper.nb_local == layout.CHAIN_BLOCK
    before = dict(stream_probe.launch_counts)
    _run(mapper, reads, config)
    assert (stream_probe.launch_counts["stream_count_reference"]
            > before["stream_count_reference"])
    fwd = _kmers(reads, k)
    queries = np.concatenate([fwd, oracle.revcomp_hash(fwd, k)]) if revcomp else fwd
    got = mapper.node_counts()
    np.testing.assert_array_equal(got, oracle.map_kmers_to_index(arrays, queries))
    np.testing.assert_array_equal(got, _jax(index, reads, (2, 2), k, revcomp=revcomp))


def _fixed_reads(rng, k, L, n):
    reads = ["".join(rng.choice(list("ACGT"), L)) for _ in range(n)]
    read_kmers = _kmers(reads, k)
    entry_kmers = np.concatenate(
        [rng.choice(read_kmers, 200), rng.integers(0, 1 << (2 * k), 100, dtype=np.uint64)]
    )
    nodes = rng.integers(0, 150, len(entry_kmers)).astype(np.int32)
    return reads, oracle.build_kmer_index(entry_kmers, nodes, 1999)


def test_sharded_fixed_read_len_plane_path():
    """Fixed-length reads take the plane step (host restride, the plane
    hash), == the oracle == JAX; a batch with an off-length read takes the
    ragged step with the same counts."""
    rng = np.random.default_rng(91)
    k, L = 9, 37
    reads, arrays = _fixed_reads(rng, k, L, 120)
    index = _index_with_buckets(arrays, 2 * layout.CHAIN_BLOCK)
    config = MapperConfig(k=k, buf=1024, max_reads=64, read_len=L)
    mapper = _mapper(index, config, (2, 2))
    before = dict(hashing.launch_counts)
    _run(mapper, reads, config)
    assert hashing.launch_counts["plane_hash_keys_reference"] > before["plane_hash_keys_reference"]
    assert hashing.launch_counts["ragged_hash_keys_reference"] == before["ragged_hash_keys_reference"]
    got = mapper.node_counts()
    np.testing.assert_array_equal(got, oracle.map_kmers_to_index(arrays, _kmers(reads, k)))
    np.testing.assert_array_equal(got, _jax(index, reads, (2, 2), k))
    assert mapper.n_kmers_mapped == len(reads) * (L - k + 1)

    mixed = reads[:40] + ["ACGT" * 12] + reads[40:]
    mapper = _mapper(index, config, (2, 2))
    before = dict(hashing.launch_counts)
    _run(mapper, mixed, config)
    assert hashing.launch_counts["ragged_hash_keys_reference"] > before["ragged_hash_keys_reference"]
    np.testing.assert_array_equal(mapper.node_counts(),
                                  oracle.map_kmers_to_index(arrays, _kmers(mixed, k)))


def test_sharded_plane_revcomp():
    rng = np.random.default_rng(92)
    k, L = 7, 33
    reads = ["".join(rng.choice(list("ACGT"), L)) for _ in range(60)]
    fwd = _kmers(reads, k)
    entry_kmers = rng.choice(np.concatenate([fwd, oracle.revcomp_hash(fwd, k)]), 150)
    arrays = oracle.build_kmer_index(entry_kmers, rng.integers(0, 60, 150).astype(np.int32), 499)
    index = _index_with_buckets(arrays, 2 * layout.CHAIN_BLOCK)
    config = MapperConfig(k=k, buf=1024, max_reads=64, read_len=L, revcomp=True)
    mapper = _mapper(index, config, (4, 2))
    _run(mapper, reads, config)
    got = mapper.node_counts()
    queries = np.concatenate([fwd, oracle.revcomp_hash(fwd, k)])
    np.testing.assert_array_equal(got, oracle.map_kmers_to_index(arrays, queries))
    np.testing.assert_array_equal(got, _jax(index, reads, (4, 2), k, revcomp=True))


@pytest.mark.parametrize("shape", [(4, 2), (2, 4)])
def test_sharded_ragged_batches(shape):
    """Many ragged chunks (reads of 1 to 90 bases, empty ones too) in
    batches whose last one is short, padded with empty rows: == the oracle
    == JAX, every data row's windows counted once."""
    rng = np.random.default_rng(sum(shape))
    k = 11
    reads = ["".join(rng.choice(list("ACGT"), rng.integers(0, 90))) for _ in range(300)]
    read_kmers = _kmers(reads, k)
    arrays = oracle.build_kmer_index(
        rng.choice(read_kmers, 400), rng.integers(0, 80, 400).astype(np.int32), 1999)
    index = _index_with_buckets(arrays, 4 * layout.CHAIN_BLOCK)
    config = MapperConfig(k=k, buf=512, max_reads=32)
    n_chunks = len(list(_chunks_from_reads(reads, config.buf, config.max_reads, k)))
    assert n_chunks % shape[0]
    mapper = _mapper(index, config, shape)
    _run(mapper, reads, config)
    got = mapper.node_counts()
    np.testing.assert_array_equal(got, oracle.map_kmers_to_index(arrays, read_kmers))
    np.testing.assert_array_equal(got, _jax(index, reads, shape, k, buf=512, max_reads=32))
    assert mapper.n_kmers_mapped == len(read_kmers)


def test_sharded_n_kmers_mapped_sums_device_counts():
    """The ragged step hands each data row's valid windows on as a count
    tensor (no read-back): the stats hold tensors, n_kmers_mapped sums them
    (== JAX's count) and an int from map_hashes; a -1 count (a ragged
    chunk whose device lengths did not tile its buffer) raises at every
    read-back until the state is reloaded."""
    rng = np.random.default_rng(31)
    reads, arrays, expect = _setup(rng, 9)
    index = _index_with_buckets(arrays, 2 * layout.CHAIN_BLOCK)
    config = MapperConfig(k=9, buf=1024, max_reads=64)
    mapper = _mapper(index, config, (2, 2))
    _run(mapper, reads, config)
    assert mapper._stats and all(isinstance(s, torch.Tensor) for s in mapper._stats)
    mapper.map_hashes(np.arange(5, dtype=np.uint64))
    assert mapper.n_kmers_mapped == sum(max(0, len(r) - 9 + 1) for r in reads) + 5
    assert not mapper._stats
    np.testing.assert_array_equal(mapper.node_counts(), expect)
    mapper._stats.append(torch.tensor([3, -1], dtype=torch.int32)[1])
    for read in (lambda: mapper.n_kmers_mapped, mapper.node_counts, mapper.slot_counts,
                 lambda: mapper.n_kmers_mapped):
        with pytest.raises(ValueError, match="did not tile"):
            read()


def test_sharded_checks_host_lengths_before_the_upload():
    """Host lengths that do not tile the chunk raise in map_chunks, before
    anything is hashed."""
    rng = np.random.default_rng(32)
    reads, arrays, _ = _setup(rng, 9)
    config = MapperConfig(k=9, buf=1024, max_reads=64)
    mapper = _mapper(_index_with_buckets(arrays, 2 * layout.CHAIN_BLOCK), config, (1, 2))
    packed, lengths, n_bases, n_reads, _ = next(iter(
        _chunks_from_reads(reads, config.buf, config.max_reads, 9)))
    before = dict(hashing.launch_counts)
    with pytest.raises(ValueError, match="add up to"):
        mapper.map_chunks([(packed, lengths[:n_reads], n_bases + 1, 0, False)])
    assert hashing.launch_counts == before


@pytest.mark.parametrize("shape,n_buckets", [((4, 2), None), ((2, 4), 4 * layout.CHAIN_BLOCK),
                                             ((1, 8), 8 * layout.CHAIN_BLOCK)])
def test_sharded_map_hashes_matches_oracle(shape, n_buckets):
    """map_hashes on a sharded index (the batch over the data rows, each
    index shard counting its own keys through the gather probe), with
    duplicates, misses and an awkward length; then chunks on top."""
    d, x = shape
    rng = np.random.default_rng(100 * d + x)
    k = 11
    reads, arrays, _ = _setup(rng, k)
    read_kmers = _kmers(reads, k)
    batch = np.concatenate([rng.choice(read_kmers, 700),
                            rng.integers(0, 1 << 62, 311, dtype=np.uint64)])
    index = (ki.KmerIndex.from_arrays(arrays) if n_buckets is None
             else _index_with_buckets(arrays, n_buckets))
    config = MapperConfig(k=k, buf=1024, max_reads=64)
    mapper = _mapper(index, config, shape)
    before = dict(probe.launch_counts)
    mapper.map_hashes(batch)
    mapper.map_hashes(batch[:37])
    assert probe.launch_counts["probe_count_reference"] - before["probe_count_reference"] == 2 * d * x
    want = oracle.map_kmers_to_index(arrays, np.concatenate([batch, batch[:37]]))
    got = mapper.node_counts()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _jax(index, (), shape, k, hashes=(batch, batch[:37])))
    assert mapper.n_kmers_mapped == len(batch) + 37

    _run(mapper, reads, config)
    np.testing.assert_array_equal(mapper.node_counts(),
                                  want + oracle.map_kmers_to_index(arrays, read_kmers))


def test_sharded_save_load_state_round_trip(tmp_path):
    """Checkpoint mid-run, resume on a fresh mapper: the uninterrupted
    counts; another grid's shape is refused."""
    rng = np.random.default_rng(77)
    k = 9
    reads, arrays, expect = _setup(rng, k)
    config = MapperConfig(k=k, buf=1024, max_reads=64)
    index = ki.KmerIndex.from_arrays(arrays)
    half = len(reads) // 2
    mapper = _mapper(index, config, (2, 2))
    _run(mapper, reads[:half], config)
    ckpt = tmp_path / "state.npz"
    mapper.save_state(ckpt)
    resumed = _mapper(index, config, (2, 2))
    resumed.load_state(ckpt)
    assert resumed.n_kmers_mapped == mapper.n_kmers_mapped
    _run(resumed, reads[half:], config)
    np.testing.assert_array_equal(resumed.node_counts(), expect)
    with pytest.raises(ValueError, match="does not match"):
        _mapper(index, config, (4, 2)).load_state(ckpt)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_sharded_checkpoint_between_packages(tmp_path, direction):
    """A sharded checkpoint of one package loads into the other's sharded
    mapper on the same grid with equal node counts and totals."""
    rng = np.random.default_rng(5)
    k = 9
    reads, arrays, expect = _setup(rng, k)
    index = ki.KmerIndex.from_arrays(arrays)
    half = len(reads) // 2
    ckpt = tmp_path / "state.npz"
    jax_config = JaxConfig(k=k, buf=1024, max_reads=64)
    config = MapperConfig(k=k, buf=1024, max_reads=64)

    def jax_mapper():
        return JaxSharded(_jax_index(index), jax_config, jax_mesh(n_devices=4, index_parallel=2))

    if direction == "jax_to_port":
        first = jax_mapper()
        for batch in jax_batches(_chunks_from_reads(reads[:half], 1024, 64, k), 2,
                                 jax_config.packed_words, 64):
            first.map_batch(*batch)
        second = _mapper(index, config, (2, 2))
    else:
        first = _mapper(index, config, (2, 2))
        _run(first, reads[:half], config)
        second = jax_mapper()
    first.save_state(ckpt)
    second.load_state(ckpt)
    assert second.n_kmers_mapped == first.n_kmers_mapped
    np.testing.assert_array_equal(second.node_counts(), first.node_counts())
    if direction == "jax_to_port":
        _run(second, reads[half:], config)
        np.testing.assert_array_equal(second.node_counts(), expect)


def test_sharded_node_counts_run_the_finalize_per_index_shard():
    """node_counts runs the finalize (its twin on the CPU) once per index
    shard, over that shard's entries, and leaves the count shards as they
    were: a second call gives the same vector."""
    rng = np.random.default_rng(8)
    reads, arrays, expect = _setup(rng, 9)
    config = MapperConfig(k=9, buf=1024, max_reads=64)
    index = _index_with_buckets(arrays, 4 * layout.CHAIN_BLOCK)
    mapper = _mapper(index, config, (2, 4))
    _run(mapper, reads, config)
    before = finalize.launch_counts["finalize_reference"]
    np.testing.assert_array_equal(mapper.node_counts(), expect)
    assert finalize.launch_counts["finalize_reference"] == before + 4
    np.testing.assert_array_equal(mapper.node_counts(), expect)
    shards = [index.shard_entries(x, 4) for x in range(4)]
    assert sum(len(s[0]) for s in shards) == len(index.entry_slot)
    assert all((s[0] >= 0).all() and (s[0] < index.table.n_slots // 4).all() for s in shards)


def test_entry_arrays_are_uploaded_by_the_first_node_counts_and_kept_by_the_mapper():
    """The finalize's entry arrays are uploaded by the first node_counts, a
    triple an index shard (its ``shard_entries``, sorted by slot), and held
    by the mapper, so they are freed with it; the index holds no tensors."""
    rng = np.random.default_rng(9)
    reads, arrays, expect = _setup(rng, 9)
    config = MapperConfig(k=9, buf=1024, max_reads=64)
    index = _index_with_buckets(arrays, 2 * layout.CHAIN_BLOCK)
    mapper = _mapper(index, config, (1, 2))
    assert mapper._entries == {}
    _run(mapper, reads, config)
    np.testing.assert_array_equal(mapper.node_counts(), expect)
    kept = dict(mapper._entries)
    assert sorted(kept) == [0, 1]
    for x, triple in kept.items():
        entries = index.shard_entries(x, 2)
        order = np.argsort(entries[0], kind="stable")
        for got, want in zip(triple, entries):
            np.testing.assert_array_equal(got.numpy(), want[order])
    np.testing.assert_array_equal(mapper.node_counts(), expect)
    assert all(mapper._entries[x] is kept[x] for x in kept)
    assert not any(isinstance(v, (torch.Tensor, dict)) for v in vars(index).values())


def test_make_mesh_grid_and_refusals():
    mesh = make_mesh(n_devices=6, index_parallel=3, devices=CPU8)
    assert mesh.shape == {"data": 2, INDEX_AXIS: 3} and mesh.size == 6
    assert all(dev == torch.device("cpu") for row in mesh.devices for dev in row)
    with pytest.raises(ValueError, match="index_parallel=3"):
        make_mesh(n_devices=4, index_parallel=3, devices=CPU8)
    with pytest.raises(ValueError, match="9 devices asked for, 8 given"):
        make_mesh(n_devices=9, devices=CPU8)
    if torch.cuda.device_count() == 0:
        with pytest.raises(ValueError, match=r"device_count\(\) is 0"):
            make_mesh(n_devices=2)


def test_chunk_upload_is_shared_by_the_cells_of_a_device():
    """Data row 0's two index shards on one device: both count the chunk,
    the shard tables are the column's and the data rows share them."""
    rng = np.random.default_rng(11)
    reads, arrays, expect = _setup(rng, 9, n_reads=50)
    config = MapperConfig(k=9, buf=4096, max_reads=128)
    index = _index_with_buckets(arrays, 2 * layout.CHAIN_BLOCK)
    mapper = _mapper(index, config, (2, 2))
    assert mapper.cells[0][0].key_lo is mapper.cells[1][0].key_lo
    assert mapper.cells[0][0].key_lo is not mapper.cells[0][1].key_lo
    _run(mapper, reads, config)
    np.testing.assert_array_equal(mapper.node_counts(), expect)
    rows = mapper.slot_counts()
    assert rows.shape == (2, index.table.n_slots) and rows[1].sum() == 0  # one chunk: row 0
