"""The node-count finalize kernel and the shard ranges of the count and
gather kernels, against their plain twins, and the sharded mapper on one
card. Jax-free, so it also runs on the GPU machine, which has no jax:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_finalize_kernels.py

Tests of the CUDA kernels themselves carry the ``cuda`` marker and skip
where PyTorch sees no GPU."""
import contextlib
import types

import numpy as np
import pytest
import torch

from kmer_mapper_tpu_torch import native, oracle
from kmer_mapper_tpu_torch.index import kmer_index as ki
from kmer_mapper_tpu_torch.index import layout
from kmer_mapper_tpu_torch.models.mapper import KmerMapper, MapperConfig
from kmer_mapper_tpu_torch.ops import (
    block_partition, finalize, finalize_cases, probe, stream_probe,
)
from kmer_mapper_tpu_torch.ops.u32hash import bucket_shift
from kmer_mapper_tpu_torch.parallel import ShardedKmerMapper, make_mesh

CASES = finalize_cases.cases()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _u32(t):
    return t.cpu().numpy().view(np.uint32)


@pytest.mark.parametrize("name", list(CASES))
def test_twin_matches_numpy(name):
    case = CASES[name]
    before = dict(finalize.launch_counts)
    got = finalize.finalize(*case.inputs("cpu"))
    np.testing.assert_array_equal(_u32(got), case.expected())
    assert got.dtype == torch.int32 and got.shape == (case.n_nodes,)
    assert finalize.launch_counts == {**before, "finalize_reference":
                                      before["finalize_reference"] + 1}


@pytest.mark.parametrize("order", ["shuffled", "slot"])
@pytest.mark.parametrize("name", list(CASES))
def test_twin_in_any_entry_order_matches_numpy(name, order):
    case = CASES[name].ordered(order, seed=3)
    got = finalize.finalize(*case.inputs("cpu"))
    np.testing.assert_array_equal(_u32(got), CASES[name].expected())


def test_one_slot_case_wraps_and_groups_nodes():
    """``one_slot``: every entry gathers one count near 2**32, nodes repeat
    within a warp's 32 entries, and most node sums wrap."""
    case = CASES["one_slot"]
    assert len(np.unique(case.slot)) == 1 and case.n_nodes == 10_000
    per_node = np.bincount(case.node, minlength=case.n_nodes)
    assert (per_node >= 2).mean() > 0.5
    assert any(len(np.unique(case.node[i:i + 32])) < 32 for i in range(0, len(case.node), 32))
    wraps = per_node.astype(np.uint64) * np.uint64(case.counts[case.slot[0]]) >= 1 << 32
    assert wraps.mean() > 0.5
    np.testing.assert_array_equal(case.expected(), (per_node.astype(np.uint64) * np.uint64(
        case.counts[case.slot[0]]) & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def test_entries_upload_in_slot_order():
    """``KmerIndex.device_entries`` uploads each shard's entries
    (``shard_entries``, in entry order) sorted by slot, stably (equal slots
    keep the index's order), every entry once over the shards; the
    finalize over them == the host ``node_counts``."""
    rng = np.random.default_rng(12)
    kmers = np.unique(rng.integers(0, 1 << 50, 3000, dtype=np.uint64))
    entries = np.concatenate([kmers, rng.choice(kmers, 2000)])
    arrays = oracle.build_kmer_index(entries, rng.integers(0, 500, len(entries)), 1031)
    index = ki.KmerIndex.from_arrays(arrays)
    counts = rng.integers(0, 3, index.table.n_slots).astype(np.uint32)
    for n_shards in (1, 2, 4):
        total = 0
        for x in range(n_shards):
            slot, node, freq = index.shard_entries(x, n_shards)
            order = np.argsort(slot, kind="stable")
            dev = index.device_entries("cpu", (x, n_shards))
            assert all(t.dtype == torch.int32 and t.is_contiguous() for t in dev)
            for got, want in zip(dev, (slot, node, freq)):
                np.testing.assert_array_equal(got.numpy(), want[order])
            total += len(slot)
        assert total == len(index.entry_slot)
    out = finalize.finalize(torch.from_numpy(counts.view(np.int32)), *index.device_entries("cpu"),
                            1000, index.max_node_id + 1)
    np.testing.assert_array_equal(_u32(out), index.node_counts(counts))


def _stand_in(monkeypatch, rc):
    """The launch path without a GPU, up to a stand-in library."""
    calls = []
    lib = types.SimpleNamespace(
        node_counts_launch=lambda *a: calls.append(a) or rc,
        stream_count_launch=lambda *a: calls.append(a) or rc,
        gather_probe_launch=lambda *a: calls.append(a) or rc,
        kmt_error_string=lambda rc: b"invalid argument")
    monkeypatch.setattr(native, "library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.Tensor, "device", property(lambda t: torch.device("cuda", 0)))
    return calls


def test_finalize_launch_glue_on_a_stand_in(monkeypatch):
    """On a CUDA tensor the wrapper passes n, the clamped bound and the
    device to the library and counts the launch; no entries launch
    nothing; a failed launch raises and counts nothing."""
    args = CASES["random"].inputs("cpu")
    empty = CASES["no_entries"].inputs("cpu")
    calls = _stand_in(monkeypatch, 0)
    before = dict(finalize.launch_counts)
    out = finalize.finalize(*args[:4], 10**9, args[5])
    assert out.shape == (args[5],) and not out.any()
    ((*_, n, bound, _, device, stream),) = calls
    assert (n, bound, device, stream) == (args[1].shape[0], 1 << 16, 0, 0)
    finalize.finalize(*empty)
    assert len(calls) == 1
    assert finalize.launch_counts == {**before, "node_counts": before["node_counts"] + 1}
    calls = _stand_in(monkeypatch, 1)
    with pytest.raises(RuntimeError, match="node_counts kernel launch failed: invalid"):
        finalize.finalize(*args)
    assert finalize.launch_counts["node_counts"] == before["node_counts"] + 1


def test_finalize_refuses_what_the_kernel_does_not_take():
    counts, slot, node, freq, max_frequency, n_nodes = CASES["random"].inputs("cpu")
    with pytest.raises(ValueError, match="entry_node is torch.int64"):
        finalize.finalize(counts, slot, node.long(), freq, max_frequency, n_nodes)
    with pytest.raises(ValueError, match="entry_frequency is torch.int32"):
        finalize.finalize(counts, slot, node, freq[:-1], max_frequency, n_nodes)
    with pytest.raises(ValueError, match="n_nodes=0"):
        finalize.finalize(counts, slot, node, freq, max_frequency, 0)
    with pytest.raises(ValueError, match="not contiguous"):
        finalize.finalize(counts, slot[::2], node[::2], freq[::2], max_frequency, n_nodes)


def _sharded_table(n_buckets: int = 4 * layout.CHAIN_BLOCK, seed: int = 2):
    """A chained table, queries (hits, misses, repeats) and the whole
    table's counts."""
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.integers(0, 1 << 62, int(n_buckets * 8 * 0.85), dtype=np.uint64))
    table = layout.build_table(keys, n_buckets=n_buckets)
    queries = np.concatenate([rng.choice(keys, 6000), keys[:40].repeat(5),
                              rng.integers(0, 1 << 62, 2000, dtype=np.uint64)])
    return table, queries


def _words(table, rows=slice(None)):
    return tuple(torch.from_numpy(np.ascontiguousarray(w[rows]).view(np.int32))
                 for w in (table.key_lo, table.key_hi))


def _stream_shard_counts(table, queries, n_shards, device, fn):
    """Each shard's counts by ``fn`` (stream_count or its twin) on the
    partition of the whole table, concatenated."""
    n = table.n_buckets
    nb, bpb = n // n_shards, min(layout.CHAIN_BLOCK, n)
    lo, hi = (torch.from_numpy(w.astype(np.int64)).to(device)
              for w in (queries & np.uint64(0xFFFFFFFF), queries >> np.uint64(32)))
    keys = stream_probe.mixed_keys(lo, hi, torch.ones_like(lo, dtype=torch.bool), table.seed)
    grouped, off = block_partition.block_partition_reference(keys, n, bpb)
    bp = torch.from_numpy(table.block_max_probe()).to(device)
    out = []
    for x in range(n_shards):
        key_lo, key_hi = (w.to(device) for w in _words(table, slice(x * nb, (x + 1) * nb)))
        counts = torch.zeros(nb * 8, dtype=torch.int32, device=device)
        first = x * nb // bpb
        last = first + nb // bpb
        fn(key_lo, key_hi, counts, grouped, off[first : last + 1].contiguous(),
           bp[first:last].contiguous(), bucket_shift(n), bpb, x * nb, n)
        out.append(_u32(counts))
    return np.concatenate(out)


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_stream_count_twin_over_shards_equals_the_whole_table(n_shards):
    table, queries = _sharded_table()
    got = _stream_shard_counts(table, queries, n_shards, "cpu", stream_probe.stream_count)
    slots = layout.query_table(table, queries)
    np.testing.assert_array_equal(got, np.bincount(slots[slots >= 0], minlength=table.n_slots))


@pytest.mark.parametrize("n_shards", [1, 2, 4, 8, 16])
def test_gather_twin_over_shards_equals_the_whole_table(n_shards):
    """Counts and slots of every shard (sub-block ones too, 32 buckets a
    shard at 16): the counts concatenate to the whole table's, and each
    query's slot is found in the shard that holds it, -1 in the others."""
    table, queries = _sharded_table()
    n, nb = table.n_buckets, table.n_buckets // n_shards
    q = torch.from_numpy(queries.view(np.int64))
    bp = torch.from_numpy(table.block_max_probe())
    whole = layout.query_table(table, queries)
    counts = []
    found = np.full(len(queries), -1)
    for x in range(n_shards):
        key_lo, key_hi = _words(table, slice(x * nb, (x + 1) * nb))
        c = probe.probe_count(key_lo, key_hi, torch.zeros(nb * 8, dtype=torch.int32), q,
                              table.max_probe, table.seed, block_probe=bp, row_offset=x * nb,
                              n_buckets_global=n)
        counts.append(_u32(c))
        s = probe.probe_slots(key_lo, key_hi, q, table.max_probe, table.seed, block_probe=bp,
                              row_offset=x * nb, n_buckets_global=n).numpy()
        mine = (whole >= x * nb * 8) & (whole < (x + 1) * nb * 8)
        np.testing.assert_array_equal(s[mine], whole[mine] - x * nb * 8)
        assert (s[~mine] == -1).all()
        found[mine] = whole[mine]
    np.testing.assert_array_equal(np.concatenate(counts),
                                  np.bincount(whole[whole >= 0], minlength=table.n_slots))
    np.testing.assert_array_equal(found, whole)


def test_shard_ranges_are_checked():
    table, _ = _sharded_table()
    key_lo, key_hi = _words(table, slice(0, 128))
    q = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError, match=r"rows \[512, 640\) are not in a table of 512"):
        probe.probe_slots(key_lo, key_hi, q, 2, 0, row_offset=512, n_buckets_global=512)
    counts = torch.zeros(128 * 8, dtype=torch.int32)
    off = torch.zeros(2, dtype=torch.int32)
    bp = torch.ones(1, dtype=torch.int32)
    for base in (64, 512):
        with pytest.raises(ValueError, match="are not whole chain blocks"):
            stream_probe.stream_count(key_lo, key_hi, counts, q, off, bp, bucket_shift(512),
                                      128, base, 512)


def test_shard_launch_glue_on_a_stand_in(monkeypatch):
    """The shard's range reaches the kernels: stream_count's bucket base
    after bpb, the gather probe's row offset and row count after its mode
    and the whole table's bucket count in place of the rows'."""
    table, queries = _sharded_table()
    key_lo, key_hi = _words(table, slice(128, 256))
    counts = torch.zeros(128 * 8, dtype=torch.int32)
    off = torch.zeros(2, dtype=torch.int32)
    bp = torch.ones(4, dtype=torch.int32)
    q = torch.from_numpy(queries[:5].view(np.int64))
    calls = _stand_in(monkeypatch, 0)
    stream_probe.stream_count(key_lo, key_hi, counts, q, off, bp[:1], bucket_shift(512), 128,
                              128, 512)
    probe.probe_count(key_lo, key_hi, counts, q, 2, 7, block_probe=bp, row_offset=128,
                      n_buckets_global=512)
    assert calls[0][6:10] == (1, bucket_shift(512), 128, 128)
    assert calls[1][7:15] == (5, 512, 4, 2, 7, 0, 128, 128)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
def test_finalize_kernel_matches_twin(name, cuda_device):
    case = CASES[name]
    before = finalize.launch_counts["node_counts"]
    got = finalize.finalize(*case.inputs(cuda_device))
    torch.cuda.synchronize()
    assert finalize.launch_counts["node_counts"] == before + (name != "no_entries")
    np.testing.assert_array_equal(_u32(got), _u32(finalize.finalize(*case.inputs("cpu"))))
    np.testing.assert_array_equal(_u32(got), case.expected())


@pytest.mark.cuda
@pytest.mark.parametrize("order", ["shuffled", "slot"])
@pytest.mark.parametrize("name", list(CASES))
def test_finalize_kernel_in_any_entry_order_matches_twin(name, order, cuda_device):
    """The kernel on the entries shuffled and sorted by slot == its twin ==
    numpy, bit for bit (the warp's node groups and their wrapping sums)."""
    case = CASES[name].ordered(order, seed=5)
    got = finalize.finalize(*case.inputs(cuda_device))
    np.testing.assert_array_equal(_u32(got), _u32(finalize.finalize(*case.inputs("cpu"))))
    np.testing.assert_array_equal(_u32(got), case.expected())


@pytest.mark.cuda
@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_stream_count_kernel_over_shards_matches_twin(n_shards, cuda_device):
    table, queries = _sharded_table()
    got = _stream_shard_counts(table, queries, n_shards, cuda_device, stream_probe.stream_count)
    twin = _stream_shard_counts(
        table, queries, n_shards, cuda_device,
        lambda *args: stream_probe.stream_count_reference(*args[:9]))
    np.testing.assert_array_equal(got, twin)


@pytest.mark.cuda
@pytest.mark.parametrize("n_shards", [2, 16])
def test_gather_kernel_over_shards_matches_twin(n_shards, cuda_device):
    table, queries = _sharded_table()
    n, nb = table.n_buckets, table.n_buckets // n_shards
    q = torch.from_numpy(queries.view(np.int64)).to(cuda_device)
    bp = torch.from_numpy(table.block_max_probe()).to(cuda_device)
    for x in range(n_shards):
        key_lo, key_hi = (w.to(cuda_device) for w in _words(table, slice(x * nb, (x + 1) * nb)))
        shard = dict(block_probe=bp, row_offset=x * nb, n_buckets_global=n)
        args = (key_lo, key_hi, q, table.max_probe, table.seed)
        np.testing.assert_array_equal(probe.probe_slots(*args, **shard).cpu().numpy(),
                                      probe.probe_slots_reference(*args, **shard).cpu().numpy())
        counts = torch.zeros(nb * 8, dtype=torch.int32, device=cuda_device)
        twin = counts.clone()
        probe.probe_count(key_lo, key_hi, counts, q, table.max_probe, table.seed, **shard)
        probe.probe_count_reference(key_lo, key_hi, twin, q, table.max_probe, table.seed,
                                    **shard)
        assert torch.equal(counts, twin)


def _small_index():
    rng = np.random.default_rng(4)
    reads = ["".join(rng.choice(list("ACGT"), 151)) for _ in range(400)]
    codes = [oracle.encode_string(r) for r in reads]
    kmers = oracle.kmer_hashes_ragged(np.concatenate(codes), np.array([151] * 400), 31)
    entries = np.concatenate([rng.choice(kmers, 5000), rng.integers(0, 1 << 62, 5000,
                                                                    dtype=np.uint64)])
    arrays = oracle.build_kmer_index(entries, rng.integers(0, 900, 10_000).astype(np.int32),
                                     20_011)
    return reads, kmers, arrays


@pytest.mark.cuda
def test_mapper_node_counts_run_the_kernel(cuda_device):
    """On CUDA, KmerMapper.node_counts is the finalize kernel on the device
    counts (no twin, no host bincount), == the oracle; the entry arrays are
    uploaded by the first call and kept by the mapper."""
    _, kmers, arrays = _small_index()
    mapper = KmerMapper(ki.KmerIndex.from_arrays(arrays), MapperConfig(k=31), cuda_device)
    assert mapper._entries is None
    mapper.map_hashes(kmers)
    before = dict(finalize.launch_counts)
    got = mapper.node_counts()
    assert finalize.launch_counts == {**before, "node_counts": before["node_counts"] + 1}
    np.testing.assert_array_equal(got, oracle.map_kmers_to_index(arrays, kmers))
    kept = mapper._entries
    assert all(t.device == mapper.device for t in kept)
    np.testing.assert_array_equal(mapper.node_counts(), got)
    assert mapper._entries is kept


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (1, 4)])
def test_sharded_grid_on_one_card(shape, cuda_device):
    """A grid of cells on one card: counts == the single-device mapper's,
    the shards' stream counts and finalizes launched."""
    reads, kmers, arrays = _small_index()
    index = ki.KmerIndex.from_arrays(arrays)
    d, x = shape
    config = MapperConfig(k=31, buf=1 << 14, max_reads=512)
    mapper = ShardedKmerMapper(index, config, make_mesh(n_devices=d * x, index_parallel=x,
                                                        devices=[cuda_device] * (d * x)))
    before = dict(stream_probe.launch_counts), dict(finalize.launch_counts)
    from kmer_mapper_tpu_torch.io import readers

    chunk = readers.SequenceChunk(np.frombuffer("".join(reads).encode(), np.uint8),
                                  np.arange(400, dtype=np.int64) * 151)
    chunks = [(p, ln[:nr], nb, inv, False) for p, ln, nb, nr, inv in
              readers.pack_for_device(iter([chunk]), config.buf, config.max_reads, 31)]
    for i in range(0, len(chunks), d):
        mapper.map_chunks(chunks[i : i + d])
    got = mapper.node_counts()
    assert stream_probe.launch_counts["stream_count"] - before[0]["stream_count"] == len(chunks) * x
    assert finalize.launch_counts["node_counts"] - before[1]["node_counts"] == x
    np.testing.assert_array_equal(got, oracle.map_kmers_to_index(arrays, kmers))
    assert mapper.n_kmers_mapped == len(kmers)
