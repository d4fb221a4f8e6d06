"""The port's library surface (``compat``, ``KmerMapper.map_hashes`` /
``in_index`` / ``kmer_counts``, the drop-in module paths) against the JAX
package's and the numpy oracle, on the CPU: mirrors ``tests/test_compat.py``,
``tests/test_mapper_api.py`` and the pre-hashed tests of
``tests/test_device_ops.py``. Every comparison is exact."""
import dataclasses
import logging

import numpy as np
import pytest
import torch

from kmer_mapper_tpu import compat as ref_compat
from kmer_mapper_tpu import oracle as ref_oracle
from kmer_mapper_tpu.index import kmer_index as ref_ki
from kmer_mapper_tpu.models.mapper import KmerMapper as RefMapper
from kmer_mapper_tpu.models.mapper import MapperConfig as RefConfig
from kmer_mapper_tpu_torch import compat, gpu_counter, mapper, oracle
from kmer_mapper_tpu_torch.index import kmer_index as ki
from kmer_mapper_tpu_torch.models.mapper import KmerMapper, MapperConfig
from kmer_mapper_tpu_torch.ops import probe, stream_probe, u32hash

CPU = dict(device="cpu")


def _index(rng):
    kmers = rng.integers(0, 1 << 62, 300, dtype=np.uint64)
    kmers = np.concatenate([kmers, kmers[:40]])
    nodes = rng.integers(0, 90, len(kmers)).astype(np.int32)
    freqs = rng.choice([1, 1001], len(kmers), p=[0.95, 0.05]).astype(np.uint16)
    return oracle.build_kmer_index(kmers, nodes, 1009, frequencies=freqs)


def _ref(arrays):
    """The same index as the JAX package's own arrays type."""
    return ref_oracle.KmerIndexArrays(**dataclasses.asdict(arrays))


def _counts():
    return {**probe.launch_counts, **stream_probe.launch_counts}


def test_map_kmers_to_graph_index_parity():
    rng = np.random.default_rng(0)
    arrays = _index(rng)
    queries = np.concatenate(
        [rng.choice(arrays.kmers, 500), rng.integers(0, 1 << 62, 100, dtype=np.uint64)]
    )
    for max_frequency in (1000, 2000):  # entries of frequency 1001 count at 2000 only
        got = compat.map_kmers_to_graph_index(
            arrays, arrays.max_node_id(), queries, max_frequency, **CPU)
        np.testing.assert_array_equal(
            got, oracle.map_kmers_to_index(arrays, queries, max_frequency=max_frequency))
        np.testing.assert_array_equal(got, ref_compat.map_kmers_to_graph_index(
            _ref(arrays), arrays.max_node_id(), queries, max_frequency))


def test_map_kmers_max_node_id_padding_and_truncation(caplog):
    rng = np.random.default_rng(1)
    arrays = _index(rng)
    queries = rng.choice(arrays.kmers, 100)
    expect = oracle.map_kmers_to_index(arrays, queries)
    got = compat.map_kmers_to_graph_index(arrays, 500, queries, **CPU)
    assert got.shape == (501,)
    np.testing.assert_array_equal(got[: len(expect)], expect)
    assert not got[len(expect):].any()
    np.testing.assert_array_equal(got, ref_compat.map_kmers_to_graph_index(_ref(arrays), 500, queries))
    with caplog.at_level(logging.WARNING):
        cut = compat.map_kmers_to_graph_index(arrays, 40, queries, **CPU)
    assert "max_node_id=40 drops counts" in caplog.text
    np.testing.assert_array_equal(cut, expect[:41])
    np.testing.assert_array_equal(cut, ref_compat.map_kmers_to_graph_index(_ref(arrays), 40, queries))


def test_in_graph_index_parity():
    rng = np.random.default_rng(2)
    arrays = _index(rng)
    queries = np.concatenate(
        [arrays.kmers[:50], rng.integers(0, 1 << 62, 50, dtype=np.uint64)]
    )
    got = compat.in_graph_index(arrays, queries, **CPU)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, oracle.in_index(arrays, queries))
    np.testing.assert_array_equal(got, ref_compat.in_graph_index(_ref(arrays), queries))
    # membership ignores the frequency filter: entries of frequency 1001 are in
    rare = arrays.kmers[arrays.frequencies > 1000]
    assert len(rare) and compat.in_graph_index(arrays, rare, 1, **CPU).all()


def test_tpu_counter_gpu_path_parity():
    """The reference GpuCounter toy case (reference tests/test_gpucounter.py:40-48)."""
    kmers = np.array([1, 2, 3, 3], dtype=np.uint64)
    nodes = np.array([10, 11, 12, 12], dtype=np.int32)
    counter = gpu_counter.GpuCounter.from_kmers_and_nodes(kmers, nodes, k=3, **CPU)
    counter.initialize_cuda(0)
    counter.count(np.array([1, 1, 1, 2, 3, 1, 3], dtype=np.uint64))
    got = counter.get_node_counts(min_nodes=20)
    expect = np.zeros(20, dtype=np.uint32)
    expect[10], expect[11], expect[12] = 4, 1, 4
    np.testing.assert_array_equal(got, expect)
    ref = ref_compat.TpuCounter.from_kmers_and_nodes(kmers, nodes, k=3)
    ref.count(np.array([1, 1, 1, 2, 3, 1, 3], dtype=np.uint64))
    np.testing.assert_array_equal(got, ref.get_node_counts(min_nodes=20))


@pytest.mark.parametrize("revcomps", [False, True])
def test_tpu_counter_matches_numpy_path(revcomps):
    rng = np.random.default_rng(5)
    k = 21
    entry_kmers = rng.integers(0, 1 << (2 * k), 600, dtype=np.uint64)
    entry_kmers = np.concatenate([entry_kmers, entry_kmers[:80]])
    nodes = rng.integers(0, 150, len(entry_kmers)).astype(np.int32)
    queries = np.concatenate([rng.choice(entry_kmers, 3000),
                              oracle.revcomp_hash(rng.choice(entry_kmers, 500), k),
                              rng.integers(0, 1 << (2 * k), 500, dtype=np.uint64)])
    counter = compat.TpuCounter.from_kmers_and_nodes(entry_kmers, nodes, k, **CPU)
    counter.count(queries, count_revcomps=revcomps)
    counter.count(queries[:700])  # batches accumulate
    got = counter.get_node_counts()
    counted = np.concatenate([queries, queries[:700]]
                             + ([oracle.revcomp_hash(queries, k)] if revcomps else []))
    unique = np.unique(entry_kmers)
    expect = oracle.node_counts_from_kmer_counts(
        entry_kmers, nodes, unique, oracle.count_unique_kmers(unique, counted))
    np.testing.assert_array_equal(got, expect)
    ref = ref_compat.TpuCounter.from_kmers_and_nodes(entry_kmers, nodes, k)
    ref.count(queries, count_revcomps=revcomps)
    ref.count(queries[:700])
    np.testing.assert_array_equal(got, ref.get_node_counts())


def test_tpu_counter_revcomps():
    k = 4
    fwd = ref_oracle.kmer_hashes(ref_oracle.encode_string("AAAC"), k)  # revcomp GTTT
    kmers = np.concatenate([fwd, oracle.revcomp_hash(fwd, k)])
    counter = compat.TpuCounter.from_kmers_and_nodes(kmers, np.array([1, 2], np.int32), k, **CPU)
    counter.count(fwd, count_revcomps=True)
    np.testing.assert_array_equal(counter.get_node_counts(), [0, 1, 1])


def test_repeated_calls_reuse_cached_index_and_mapper():
    """KAGE calls per batch with the same index object (``mapper.pyx:19``):
    the second call reuses the table on the device, and results do not
    depend on the calls before."""
    rng = np.random.default_rng(21)
    keys = np.unique(rng.integers(0, 1 << 62, 400, dtype=np.uint64))
    nodes = rng.integers(0, 60, len(keys)).astype(np.int32)
    arrays = oracle.build_kmer_index(keys, nodes, 701)
    q1 = rng.choice(keys, 150)
    q2 = np.concatenate([rng.choice(keys, 80), rng.integers(0, 1 << 62, 70, dtype=np.uint64)])

    index = compat._as_index(arrays)
    m = compat._shared_mapper(index, **CPU)
    key_lo = m.key_lo
    c1 = compat.map_kmers_to_graph_index(arrays, int(nodes.max()), q1, **CPU)
    c2 = compat.map_kmers_to_graph_index(arrays, int(nodes.max()), q2, **CPU)
    c1_again = compat.map_kmers_to_graph_index(arrays, int(nodes.max()), q1, **CPU)
    assert compat._as_index(arrays) is index  # no rebuild
    assert compat._shared_mapper(index, **CPU) is m and m.key_lo is key_lo  # no upload
    np.testing.assert_array_equal(c1, c1_again)  # counts reset between calls
    np.testing.assert_array_equal(
        c2, oracle.map_kmers_to_index(arrays, q2, max_node_id=int(nodes.max())))
    # a dropped index object leaves the id() cache
    del index, m
    n_cached = len(compat._obj_cache)
    del arrays
    assert len(compat._obj_cache) == n_cached - 1


def test_path_cache(tmp_path):
    rng = np.random.default_rng(24)
    arrays = _index(rng)
    ki.save_reference_npz(tmp_path / "i.npz", arrays)
    queries = rng.choice(arrays.kmers, 200)
    got = compat.map_kmers_to_graph_index(str(tmp_path / "i.npz"), None, queries, **CPU)
    assert compat._as_index(str(tmp_path / "i.npz")) is compat._path_cache[str(tmp_path / "i.npz")]
    np.testing.assert_array_equal(got, oracle.map_kmers_to_index(arrays, queries))


def test_mapper_reset_counts():
    rng = np.random.default_rng(22)
    keys = np.unique(rng.integers(0, 1 << 62, 200, dtype=np.uint64))
    index = ki.KmerIndex.from_counter_keys(keys)
    m = KmerMapper(index, MapperConfig(k=31), "cpu")
    m.map_hashes(keys[:50])
    assert m.n_kmers_mapped == 50
    assert m.slot_counts().sum() == 50
    m.reset_counts()
    assert m.n_kmers_mapped == 0 and m.slot_counts().sum() == 0
    m.map_hashes(keys[:7])
    assert m.slot_counts().sum() == 7


def test_shared_mapper_cached_per_k_and_device():
    rng = np.random.default_rng(23)
    keys = np.unique(rng.integers(0, 1 << 42, 300, dtype=np.uint64))
    index = ki.KmerIndex.from_counter_keys(keys)
    m31 = compat._shared_mapper(index, 31, **CPU)
    m21 = compat._shared_mapper(index, 21, **CPU)
    assert m31 is not m21
    assert compat._shared_mapper(index, 31, **CPU) is m31
    assert compat._shared_mapper(index, 21, device=torch.device("cpu")) is m21
    assert set(index._compat_mappers) == {(31, torch.device("cpu")), (21, torch.device("cpu"))}


def test_no_gpu_needs_device_cpu(monkeypatch):
    """The reference's calls name no device: here they default to cuda and,
    with no GPU, raise and name device="cpu" instead of picking the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rng = np.random.default_rng(25)
    arrays = _index(rng)
    q = rng.choice(arrays.kmers, 10)
    for call in (lambda: compat.map_kmers_to_graph_index(arrays, None, q),
                 lambda: compat.in_graph_index(arrays, q),
                 lambda: mapper.map_kmers_to_graph_index(arrays, kmers=q),
                 lambda: mapper.in_graph_index_no_memory_maps(arrays, q),
                 lambda: gpu_counter.GpuCounter.from_kmers_and_nodes(arrays.kmers, arrays.nodes, 31)):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()
    assert compat.map_kmers_to_graph_index(arrays, None, q, **CPU).sum() > 0


def test_drop_in_module_paths():
    assert mapper.map_kmers_to_graph_index is compat.map_kmers_to_graph_index
    assert mapper.in_graph_index_no_memory_maps is compat.in_graph_index
    assert gpu_counter.GpuCounter is compat.TpuCounter
    import kmer_mapper_tpu_torch as pkg

    for name in ("load_index", "KmerIndex", "KmerMapper", "MapperConfig", "oracle",
                 "map_kmers_to_graph_index", "in_graph_index", "TpuCounter"):
        assert name in pkg.__all__ and hasattr(pkg, name)


def _mapper_pair(rng, n=400):
    entry_kmers = rng.integers(0, 1 << 62, n, dtype=np.uint64)
    entry_kmers = np.concatenate([entry_kmers, entry_kmers[:50]])
    nodes = rng.integers(0, 100, len(entry_kmers)).astype(np.int32)
    arrays = oracle.build_kmer_index(entry_kmers, nodes, 2003)
    return (arrays, KmerMapper(ki.KmerIndex.from_arrays(arrays), MapperConfig(k=31), "cpu"),
            RefMapper(ref_ki.TpuKmerIndex.from_arrays(arrays), RefConfig(k=31, buf=256, max_reads=16)))


def test_in_index_matches_oracle():
    rng = np.random.default_rng(0)
    arrays, m, ref = _mapper_pair(rng)
    queries = np.concatenate(
        [rng.choice(arrays.kmers, 300), rng.integers(0, 1 << 62, 200, dtype=np.uint64)]
    )
    before = _counts()
    got = m.in_index(queries)
    assert _counts()["probe_slots_reference"] == before["probe_slots_reference"] + 1
    np.testing.assert_array_equal(got, oracle.in_index(arrays, queries))
    np.testing.assert_array_equal(got, ref.in_index(queries))
    assert m.in_index(np.zeros(0, np.uint64)).shape == (0,)


def test_save_load_state_roundtrip(tmp_path):
    rng = np.random.default_rng(1)
    arrays, m, _ = _mapper_pair(rng)
    q1, q2 = rng.choice(arrays.kmers, 500), rng.choice(arrays.kmers, 700)
    m.map_hashes(q1)
    m.save_state(tmp_path / "state.npz")
    resumed = KmerMapper(m.index, MapperConfig(k=31), "cpu")
    resumed.load_state(tmp_path / "state.npz")
    resumed.map_hashes(q2)
    full = KmerMapper(m.index, MapperConfig(k=31), "cpu")
    full.map_hashes(np.concatenate([q1, q2]))
    np.testing.assert_array_equal(resumed.node_counts(), full.node_counts())
    assert resumed.n_kmers_mapped == full.n_kmers_mapped == 1200


def test_map_hashes_counter_parity():
    rng = np.random.default_rng(7)
    keys = np.unique(rng.integers(0, 1 << 62, 500, dtype=np.uint64))
    queries = np.concatenate(
        [rng.choice(keys, 2000), rng.integers(0, 1 << 62, 300, dtype=np.uint64)]
    )
    m = KmerMapper(ki.KmerIndex.from_counter_keys(keys), MapperConfig(k=31), "cpu")
    m.map_hashes(queries)
    got_kmers, got_counts = m.kmer_counts()
    np.testing.assert_array_equal(got_counts, oracle.count_unique_kmers(got_kmers, queries))
    ref = RefMapper(ref_ki.TpuKmerIndex.from_counter_keys(keys), RefConfig(k=31, buf=256, max_reads=16))
    ref.map_hashes(queries)
    ref_kmers, ref_counts = ref.kmer_counts()
    np.testing.assert_array_equal(got_kmers, ref_kmers)
    np.testing.assert_array_equal(got_counts, ref_counts)


def test_map_hashes_stream_route_matches_gather():
    """map_hashes takes the gather probe for every batch, as the JAX package
    does off the TPU; the stream route (sort + stream count), which the
    file path keeps, counts the same batch identically, as the JAX mapper
    and the oracle do."""
    rng = np.random.default_rng(31)
    keys = np.unique(rng.integers(0, 1 << 62, 3000, dtype=np.uint64))
    index = ki.KmerIndex.from_counter_keys(keys)
    hashes = np.concatenate(
        [rng.choice(keys, 1500), rng.integers(0, 1 << 62, 548, dtype=np.uint64)]
    )
    gather = KmerMapper(index, MapperConfig(k=31), "cpu")
    before = _counts()
    gather.map_hashes(hashes)
    after = _counts()
    assert after["probe_count_reference"] == before["probe_count_reference"] + 1
    assert after["stream_count_reference"] == before["stream_count_reference"]
    stream = torch.zeros_like(gather.counts)
    lo, hi = (torch.from_numpy(w.astype(np.int64)) for w in u32hash.split_u64(hashes))
    stream_probe.stream_probe_count(gather.key_lo, gather.key_hi, stream, lo, hi,
                                    torch.ones(len(hashes), dtype=torch.bool),
                                    index.table.seed, gather.block_probe)
    assert _counts()["stream_count_reference"] == after["stream_count_reference"] + 1
    assert torch.equal(stream, gather.counts)
    assert gather.n_kmers_mapped == len(hashes)
    ref = RefMapper(ref_ki.TpuKmerIndex.from_counter_keys(keys), RefConfig(k=31, buf=256, max_reads=16))
    ref.map_hashes(hashes)
    np.testing.assert_array_equal(gather.slot_counts(), ref.slot_counts())
    _, counts = gather.kmer_counts()
    assert counts.sum() == 1500


def test_map_hashes_routes_by_size_and_splits_large_batches(monkeypatch):
    """A 2**17 batch, which the stream route took before, and every piece of
    a batch past HASH_PIECE launch probe_count and never stream_count; the
    counts equal the JAX mapper's and the oracle's, and in_index's pieces
    the oracle's membership."""
    rng = np.random.default_rng(32)
    arrays = _index(rng)
    index = ki.KmerIndex.from_arrays(arrays)
    hashes = np.concatenate([rng.choice(arrays.kmers, (1 << 17) - 5000),
                             rng.integers(0, 1 << 62, 5000, dtype=np.uint64)])
    expect = oracle.map_kmers_to_index(arrays, hashes)
    ref = RefMapper(ref_ki.TpuKmerIndex.from_arrays(arrays), RefConfig(k=31, buf=256, max_reads=16))
    ref.map_hashes(hashes)
    m = KmerMapper(index, MapperConfig(k=31), "cpu")
    before = _counts()
    m.map_hashes(hashes)
    after = _counts()
    assert after["probe_count_reference"] == before["probe_count_reference"] + 1
    assert after["stream_count_reference"] == before["stream_count_reference"]
    np.testing.assert_array_equal(m.node_counts(), expect)
    np.testing.assert_array_equal(m.slot_counts(), ref.slot_counts())
    monkeypatch.setattr(KmerMapper, "HASH_PIECE", 50_000)
    pieces = KmerMapper(index, MapperConfig(k=31), "cpu")
    pieces.map_hashes(hashes)  # pieces of 50000, 50000 and 31072
    final = _counts()
    assert final["probe_count_reference"] == after["probe_count_reference"] + 3
    assert final["stream_count_reference"] == after["stream_count_reference"]
    np.testing.assert_array_equal(pieces.node_counts(), expect)
    np.testing.assert_array_equal(pieces.slot_counts(), ref.slot_counts())
    assert pieces.n_kmers_mapped == len(hashes)
    np.testing.assert_array_equal(pieces.in_index(hashes), oracle.in_index(arrays, hashes))
    assert _counts()["probe_slots_reference"] == final["probe_slots_reference"] + 3
    np.testing.assert_array_equal(pieces.in_index(hashes), ref.in_index(hashes))


def test_hash_pieces_hold_the_raw_bits():
    """The pieces are the hashes' uint64 bits as int64, no host split: a
    hash with bit 63 set is a negative int64."""
    rng = np.random.default_rng(33)
    keys = np.unique(rng.integers(0, 1 << 62, 200, dtype=np.uint64)) | np.uint64(1 << 63)
    m = KmerMapper(ki.KmerIndex.from_counter_keys(keys), MapperConfig(k=31), "cpu")
    m.HASH_PIECE = 64
    pieces = list(m._hash_pieces(keys))
    assert [p.shape[0] for p in pieces] == [64, 64, 64, len(keys) - 192]
    assert all(p.dtype == torch.int64 and p.device == m.device for p in pieces)
    np.testing.assert_array_equal(torch.cat(pieces).numpy().view(np.uint64), keys)
    assert (torch.cat(pieces) < 0).all()
    m.map_hashes(keys)
    _, counts = m.kmer_counts()
    assert counts.sum() == len(keys)
    assert m.in_index(keys).all()


def test_oracle_copies_match():
    rng = np.random.default_rng(9)
    arrays = _index(rng)
    queries = np.concatenate([rng.choice(arrays.kmers, 400),
                              rng.integers(0, 1 << 62, 200, dtype=np.uint64)])
    np.testing.assert_array_equal(oracle.in_index(arrays, queries),
                                  ref_oracle.in_index(arrays, queries))
    unique = np.unique(arrays.kmers)
    got = oracle.count_unique_kmers(unique, queries)
    np.testing.assert_array_equal(got, ref_oracle.count_unique_kmers(unique, queries))
    for kw in (dict(), dict(entry_frequencies=arrays.frequencies, max_frequency=1000)):
        np.testing.assert_array_equal(
            oracle.node_counts_from_kmer_counts(arrays.kmers, arrays.nodes, unique, got,
                                                min_nodes=120, **kw),
            ref_oracle.node_counts_from_kmer_counts(arrays.kmers, arrays.nodes, unique, got,
                                                    min_nodes=120, **kw),
        )
    # with the frequency filter the factorized path equals the CPU probe
    np.testing.assert_array_equal(
        oracle.node_counts_from_kmer_counts(
            arrays.kmers, arrays.nodes, unique, got, min_nodes=arrays.max_node_id(),
            entry_frequencies=arrays.frequencies, max_frequency=1000),
        oracle.map_kmers_to_index(arrays, queries),
    )
