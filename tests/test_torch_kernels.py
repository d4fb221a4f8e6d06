"""The stream-count kernel and its plain twin against the host oracle on
every hazard case of the kernel's contract, plus the wrapper's argument
checks and the sort-key order. Jax-free, so it also runs on the GPU
machine, which has no jax:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

Tests of the CUDA kernel itself carry the ``cuda`` marker and skip where
PyTorch sees no GPU."""
import contextlib
import types

import numpy as np
import pytest
import torch

from kmer_mapper_tpu_torch import native
from kmer_mapper_tpu_torch.index import layout
from kmer_mapper_tpu_torch.ops import block_partition, stream_count_cases, stream_probe
from kmer_mapper_tpu_torch.ops.u32hash import bucket_shift, split_u64, to_int32_bits

CASES = {c.name: c for c in stream_count_cases.cases()}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _u32(t):
    return t.cpu().numpy().view(np.uint32)


@pytest.mark.parametrize("name", list(CASES))
def test_twin_matches_oracle(name):
    case = CASES[name]
    before = dict(stream_probe.launch_counts)
    got = stream_probe.stream_count(*case.inputs("cpu"))
    np.testing.assert_array_equal(_u32(got), case.expected())
    # on a CPU tensor the wrapper runs the twin and never counts a launch
    assert stream_probe.launch_counts["stream_count"] == before["stream_count"]
    assert (stream_probe.launch_counts["stream_count_reference"]
            == before["stream_count_reference"] + 1)


def test_huge_table_case_logic_on_small_table():
    """The slot-past-2**31 case's construction, at a size the CPU holds."""
    args, (slots, reps) = stream_count_cases.huge_table_inputs("cpu", 1 << 12)
    counts = stream_probe.stream_count(*args)
    got = _u32(counts)
    np.testing.assert_array_equal(got[slots], reps)
    assert got.sum() == reps.sum()
    hit, values = stream_count_cases.nonzero_counts(counts, row=1000)
    np.testing.assert_array_equal(hit, slots)
    np.testing.assert_array_equal(values, reps)


def test_sort_key_orders_as_unsigned_pairs():
    rng = np.random.default_rng(5)
    m_lo = rng.integers(0, 1 << 32, 3000, dtype=np.int64)
    m_hi = rng.integers(0, 1 << 32, 3000, dtype=np.int64)
    m_lo[:1000] |= 1 << 31  # top bit set: would sort first as signed words
    m_lo[1000:1100] = m_lo[0]  # ties on m_lo order by m_hi
    m_lo[-5:] = m_hi[-5:] = 0xFFFFFFFF  # the invalid pair
    m_lo[-6], m_hi[-6] = 0, 0
    keys = stream_probe.sort_mixed(torch.from_numpy(m_lo), torch.from_numpy(m_hi))
    order = np.lexsort((m_hi, m_lo))
    lo, hi = stream_probe.split_key(keys)
    np.testing.assert_array_equal(lo.numpy(), m_lo[order])
    np.testing.assert_array_equal(hi.numpy(), m_hi[order])
    assert keys[-1] == torch.iinfo(torch.int64).max  # invalid sorts last


def test_stream_count_checks_its_arguments():
    args = list(CASES["table_64_buckets"].inputs("cpu"))
    bad = {
        0: args[0].to(torch.int64),  # key_lo dtype
        2: args[2][:-1],  # counts length
        3: args[3].to(torch.int32),  # sort keys dtype
        4: args[4][:-1],  # offsets length
        6: args[6] + 1,  # shift
        7: args[7] // 2,  # block size
    }
    for i, value in bad.items():
        with pytest.raises(ValueError):
            stream_probe.stream_count(*args[:i], value, *args[i + 1 :])
    with pytest.raises(ValueError, match="contiguous"):
        stream_probe.stream_count(
            args[0].t().contiguous().t(), *args[1:]
        )
    meta = [a.to("meta") if isinstance(a, torch.Tensor) else a for a in args]
    with pytest.raises(ValueError, match="no kernel"):
        stream_probe.stream_count(*meta)


def _query_words(case):
    """int64-held mixed (m_lo, m_hi) of a case's valid queries."""
    lo, hi = (torch.from_numpy(w.astype(np.int64)) for w in split_u64(case.queries))
    m_lo, m_hi = stream_probe.split_key(
        stream_probe.mixed_keys(lo, hi, torch.ones(len(lo), dtype=torch.bool), case.table.seed))
    valid = torch.from_numpy(case.valid)
    return m_lo[valid], m_hi[valid]


def _unordered(case, seed: int = 0):
    """The case's valid query keys in a random order, grouped by the
    partition twin: windows in no sorted order, as the main path has them."""
    keys = stream_probe.sort_key(*_query_words(case))
    keys = keys[torch.from_numpy(np.random.default_rng(seed).permutation(len(keys)))]
    t = case.table
    return block_partition.block_partition_reference(keys, t.n_buckets, min(128, t.n_buckets))


@pytest.mark.parametrize("name", list(CASES))
def test_fingerprint_rule(name):
    """The count kernel's fingerprints: 0 exactly at empty slots, 1..15 for a
    key; the SWAR lane test finds exactly the lanes whose fingerprint equals
    the query's; every lane that holds a query's key is among them."""
    case = CASES[name]
    key_lo, key_hi = case.inputs("cpu")[:2]
    words = stream_probe.bucket_fingerprints(key_lo, key_hi)
    assert int(words.max()) < 1 << 32
    nibbles = (words[:, None] >> (4 * torch.arange(8))) & 15
    lo, hi = key_lo.long() & 0xFFFFFFFF, key_hi.long() & 0xFFFFFFFF
    empty = (lo == stream_probe.INVALID_WORD) & (hi == stream_probe.INVALID_WORD)
    assert torch.equal(nibbles == stream_probe.EMPTY_FINGERPRINT, empty)
    m_lo, m_hi = _query_words(case)
    mine = stream_probe.fingerprint(m_hi)
    assert bool(((mine >= 1) & (mine <= 15)).all())
    n_buckets = case.table.n_buckets
    bpb = min(128, n_buckets)
    home = m_lo >> bucket_shift(n_buckets) if n_buckets > 1 else torch.zeros_like(m_lo)
    for p in range(int(case.table.block_max_probe().max(initial=1))):
        b = home // bpb * bpb + ((home % bpb + p) & (bpb - 1))
        lanes = stream_probe.fingerprint_lanes(words[b], m_hi)
        assert torch.equal(lanes, nibbles[b] == mine[:, None])
        assert not bool(((lo[b] == m_lo[:, None]) & (hi[b] == m_hi[:, None]) & ~lanes).any())


def fingerprint_count(key_lo, key_hi, counts, keys, off, block_probe, shift, bpb):
    """The kernel's walk through the fingerprints in plain torch: as
    ``stream_count_reference``, but a lane's words are compared only where
    ``fingerprint_lanes`` lets them through."""
    words = stream_probe.bucket_fingerprints(key_lo, key_hi)
    off64 = off.long()
    block = torch.repeat_interleave(torch.arange(block_probe.shape[0]), off64[1:] - off64[:-1])
    m_lo, m_hi = stream_probe.split_key(keys[int(off64[0]):int(off64[-1])])
    live = ~((m_lo == stream_probe.INVALID_WORD) & (m_hi == stream_probe.INVALID_WORD))
    local = (m_lo >> shift if shift < 32 else torch.zeros_like(m_lo)) - block * bpb
    live &= (local >= 0) & (local < bpb)
    rounds = block_probe.long().clamp(max=bpb)[block]
    lo, hi = key_lo.long() & 0xFFFFFFFF, key_hi.long() & 0xFFFFFFFF
    hits = torch.zeros(counts.numel(), dtype=torch.int64)
    for p in range(min(int(block_probe.max()), bpb)):
        sel = torch.nonzero(live & (p < rounds)).squeeze(1)
        b = block[sel] * bpb + ((local[sel] + p) & (bpb - 1))
        lanes = stream_probe.fingerprint_lanes(words[b], m_hi[sel])
        match = lanes & (lo[b] == m_lo[sel, None]) & (hi[b] == m_hi[sel, None])
        row, lane = torch.nonzero(match, as_tuple=True)
        hits += torch.bincount(b[row] * 8 + lane, minlength=counts.numel())
    total = (counts.long() & 0xFFFFFFFF) + hits
    return to_int32_bits(total & 0xFFFFFFFF)


@pytest.mark.parametrize("name", list(CASES))
def test_fingerprint_count_on_unordered_windows_matches_oracle(name):
    """The fingerprint walk and the twin, on the queries in a random order
    grouped by the partition twin, == the oracle."""
    case = CASES[name]
    key_lo, key_hi, counts, _, _, block_probe, shift, bpb = case.inputs("cpu")
    keys, off = _unordered(case)
    got = fingerprint_count(key_lo, key_hi, counts, keys, off, block_probe, shift, bpb)
    np.testing.assert_array_equal(_u32(got), case.expected())
    twin = stream_probe.stream_count(key_lo, key_hi, counts, keys, off, block_probe, shift, bpb)
    np.testing.assert_array_equal(_u32(twin), case.expected())


def test_fingerprint_case_holds_collisions():
    """In ``fingerprint_collisions`` some queried keys share their bucket's
    fingerprint with a key that is never queried (two lanes let through, one
    matches), and misses share one with a stored key (a lane let through,
    none matches); the table has empty slots."""
    case = CASES["fingerprint_collisions"]
    key_lo, key_hi = case.inputs("cpu")[:2]
    words = stream_probe.bucket_fingerprints(key_lo, key_hi)
    m_lo, m_hi = _query_words(case)
    home = m_lo >> bucket_shift(case.table.n_buckets)
    lanes = stream_probe.fingerprint_lanes(words[home], m_hi)
    lo, hi = key_lo.long() & 0xFFFFFFFF, key_hi.long() & 0xFFFFFFFF
    match = (lo[home] == m_lo[:, None]) & (hi[home] == m_hi[:, None])
    assert int(((lanes.sum(1) >= 2) & (match.sum(1) == 1)).sum()) >= 5
    assert int(((lanes.sum(1) >= 1) & (match.sum(1) == 0)).sum()) >= 50
    assert bool((words >> 28 == stream_probe.EMPTY_FINGERPRINT).any())  # lane 7 empty


def test_launch_glue_on_a_stand_in(monkeypatch):
    """On a CUDA tensor the wrapper passes its arguments to the library,
    counts each launch under ``stream_count``, and a failed launch raises
    and counts nothing."""
    calls = []
    lib = types.SimpleNamespace(
        stream_count_launch=lambda *a: calls.append(a[6:9]) or 0,
        kmt_error_string=lambda rc: b"invalid argument")
    monkeypatch.setattr(native, "library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: types.SimpleNamespace(cuda_stream=0))
    args = CASES["chained_table"].inputs("cpu")
    monkeypatch.setattr(torch.Tensor, "device", property(lambda t: torch.device("cuda", 0)))
    before = dict(stream_probe.launch_counts)
    stream_probe.stream_count(*args)
    assert calls == [(args[5].shape[0], args[6], args[7])]
    assert stream_probe.launch_counts == {**before, "stream_count": before["stream_count"] + 1}
    lib.stream_count_launch = lambda *a: 1
    with pytest.raises(RuntimeError, match="stream_count kernel launch failed: invalid"):
        stream_probe.stream_count(*args)
    assert stream_probe.launch_counts["stream_count"] == before["stream_count"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
def test_kernel_on_unordered_windows_matches_twin(name, cuda_device):
    """The count kernel, on the queries in a random order grouped by the
    partition, == the twin == the oracle."""
    case = CASES[name]
    key_lo, key_hi, counts, _, _, block_probe, shift, bpb = case.inputs(cuda_device)
    keys, off = (t.to(cuda_device) for t in _unordered(case))
    got = stream_probe.stream_count(key_lo, key_hi, counts.clone(), keys, off, block_probe,
                                    shift, bpb)
    twin = stream_probe.stream_count_reference(key_lo, key_hi, counts.clone(), keys, off,
                                               block_probe, shift, bpb)
    np.testing.assert_array_equal(_u32(got), _u32(twin))
    np.testing.assert_array_equal(_u32(got), case.expected())


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
def test_kernel_matches_twin(name, cuda_device):
    case = CASES[name]
    before = stream_probe.launch_counts["stream_count"]
    got = stream_probe.stream_count(*case.inputs(cuda_device))
    torch.cuda.synchronize()
    assert stream_probe.launch_counts["stream_count"] == before + 1
    twin = stream_probe.stream_count_reference(*case.inputs(cuda_device))
    np.testing.assert_array_equal(_u32(got), _u32(twin))
    np.testing.assert_array_equal(_u32(got), case.expected())


@pytest.mark.cuda
def test_kernel_slots_past_2_31(cuda_device):
    if torch.cuda.get_device_properties(cuda_device).total_memory < 60 << 30:
        pytest.skip("the 2**29-bucket table needs 48 GiB of device memory")
    args, (slots, reps) = stream_count_cases.huge_table_inputs(cuda_device)
    counts = stream_probe.stream_count(*args)
    hit, values = stream_count_cases.nonzero_counts(counts)
    np.testing.assert_array_equal(hit, slots)
    np.testing.assert_array_equal(values, reps)
    assert slots.max() >= 1 << 31


@pytest.mark.cuda
@pytest.mark.parametrize("workers", [1, 4])
@pytest.mark.parametrize("kind", ["fixed_fastq", "ragged_fasta_gz", "fixed_revcomp"])
def test_map_file_on_cuda_matches_oracle(kind, workers, cuda_device, tmp_path):
    """The file path on the GPU: the plane step, the ragged step and
    revcomp all reach the kernel and give the oracle's node counts, with
    one framing worker and with four (a file this small stays one region;
    buffers staged in page-locked host memory either way)."""
    got, want = _map_file_case(kind, workers, cuda_device, tmp_path)
    np.testing.assert_array_equal(got, want)


def _map_file_case(kind, workers, device, tmp_path):
    """Node counts of ``pipeline.map_file`` on ``device`` for one file kind,
    and the oracle's."""
    import gzip

    from kmer_mapper_tpu_torch import oracle, pipeline
    from kmer_mapper_tpu_torch.index import kmer_index

    rng = np.random.default_rng(len(kind))
    k, revcomp = 31, kind == "fixed_revcomp"
    lengths = rng.integers(20, 300, 3000) if kind == "ragged_fasta_gz" else np.full(3000, 151)
    reads = ["".join(rng.choice(list("ACGTN"), n)) for n in lengths]
    if kind == "ragged_fasta_gz":
        path = tmp_path / "reads.fa.gz"
        with gzip.open(path, "wt") as f:
            f.write("".join(f">r{i}\n{s}\n" for i, s in enumerate(reads)))
    else:
        path = tmp_path / "reads.fq"
        path.write_text("".join(f"@r{i}\n{s}\n+\n{'I' * len(s)}\n" for i, s in enumerate(reads)))
    codes = oracle.encode_bytes(np.frombuffer("".join(reads).encode(), np.uint8))
    kmers = oracle.kmer_hashes_ragged(codes, lengths, k)
    if revcomp:
        kmers = np.concatenate([kmers, oracle.revcomp_hash(kmers, k)])
    entries = np.concatenate([kmers[::50], rng.integers(0, 1 << 62, 5000, dtype=np.uint64)])
    arrays = oracle.build_kmer_index(entries, rng.integers(0, 900, len(entries)), 20011)
    kmer_index.save_reference_npz(tmp_path / "index.npz", arrays)
    before = stream_probe.launch_counts["stream_count"]
    got = pipeline.map_file(
        str(tmp_path / "index.npz"), str(path), device=device, k=k,
        map_reverse_complements=revcomp, reader_workers=workers,
    )
    assert stream_probe.launch_counts["stream_count"] > before
    return got, oracle.map_kmers_to_index(arrays, kmers)


def _two_devices():
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")


@pytest.mark.cuda
def test_pinned_ring_event_waits_on_the_mappers_device():
    """With another device current, the event a host buffer goes back to
    the ring with (the mapper's ``upload_done``) follows the mapper's copy
    stream: the copy into a device slot that a held-up chunk still reads
    waits for it, and the event is pending until then. One recorded on the
    idle current device would complete at once and let the producer
    overwrite a buffer whose upload is still queued."""
    from kmer_mapper_tpu_torch import oracle, pipeline
    from kmer_mapper_tpu_torch.index import kmer_index
    from kmer_mapper_tpu_torch.models.mapper import KmerMapper, MapperConfig

    _two_devices()
    mapper_device = torch.device("cuda", 1)
    rng = np.random.default_rng(3)
    arrays = oracle.build_kmer_index(rng.integers(0, 1 << 62, 500, dtype=np.uint64),
                                     rng.integers(0, 50, 500), 1021)
    config = MapperConfig(k=31, buf=1024, max_reads=32)
    words = torch.from_numpy(rng.integers(0, 1 << 32, config.packed_words, dtype=np.uint64)
                             .astype(np.uint32).view(np.int32)).pin_memory()
    lens = torch.full((8,), 128, dtype=torch.int32).pin_memory()
    with torch.cuda.device(0):
        mapper = KmerMapper(kmer_index.KmerIndex.from_arrays(arrays), config, mapper_device)
        ring = pipeline.PinnedRing(1, 1024, n_lengths=16)
        buf, _ = ring._free.get()
        with torch.cuda.device(mapper_device):
            torch.cuda._sleep(1 << 30)  # about half a second of the mapper's stream
        for _ in range(3):  # the third chunk's copy waits for the first's hash
            mapper.map_chunk(words, lens, 1024)
        ring.release(buf, mapper.upload_done)
        _, event = ring._free.get()
        assert event is mapper.upload_done
        assert not event.query()
        event.synchronize()
        assert event.query()
        assert mapper.n_kmers_mapped == 3 * 8 * (128 - 30)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["fixed_fastq", "ragged_fasta_gz"])
def test_map_file_on_a_device_that_is_not_current(kind, tmp_path):
    _two_devices()
    with torch.cuda.device(0):
        got, want = _map_file_case(kind, 1, torch.device("cuda", 1), tmp_path)
    np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("index_parallel", [1, 2])
def test_sharded_ragged_chunks_over_two_cards(index_parallel):
    """Ragged chunks on a grid whose data rows lie on two cards: each row's
    valid-window count stays on its own card, and n_kmers_mapped,
    node_counts and slot_counts read them back == one card's mapper and
    the oracle."""
    from kmer_mapper_tpu_torch import oracle
    from kmer_mapper_tpu_torch.index import kmer_index
    from kmer_mapper_tpu_torch.io import readers
    from kmer_mapper_tpu_torch.models.mapper import KmerMapper, MapperConfig
    from kmer_mapper_tpu_torch.parallel import (
        ShardedKmerMapper, batch_packed_chunks, make_mesh,
    )

    _two_devices()
    rng = np.random.default_rng(17)
    k = 15
    lengths = rng.integers(20, 200, 400)
    reads = "".join(rng.choice(list("ACGT"), int(lengths.sum())))
    codes = oracle.encode_bytes(np.frombuffer(reads.encode(), np.uint8))
    kmers = oracle.kmer_hashes_ragged(codes, lengths, k)
    entries = np.concatenate([kmers[::20], rng.integers(0, 1 << 30, 500, dtype=np.uint64)])
    arrays = oracle.build_kmer_index(entries, rng.integers(0, 300, len(entries)), 4099)
    index = kmer_index.KmerIndex.from_arrays(arrays)
    config = MapperConfig(k=k, buf=4096, max_reads=64)

    def packed():
        chunk = readers.SequenceChunk(
            bases=np.frombuffer(reads.encode(), dtype=np.uint8),
            read_starts=np.concatenate([[0], np.cumsum(lengths[:-1])]).astype(np.int64))
        return readers.pack_for_device(iter([chunk]), config.buf, config.max_reads, k)

    cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
    mesh = make_mesh(index_parallel=index_parallel,
                     devices=[card for card in cards for _ in range(index_parallel)])
    sharded = ShardedKmerMapper(index, config, mesh)
    single = KmerMapper(index, config, cards[0])
    n_batches = 0
    for batch in batch_packed_chunks(packed(), 2, config.packed_words, config.max_reads):
        sharded.map_batch(*batch)
        n_batches += 1
    for words, lens, n_bases, n_reads, _ in packed():
        single.map_chunk(words, lens[:n_reads], n_bases)
    assert n_batches > 1
    assert {s.device for s in sharded._stats} == set(cards)
    assert sharded.n_kmers_mapped == single.n_kmers_mapped == len(kmers)
    want = oracle.map_kmers_to_index(arrays, kmers)
    np.testing.assert_array_equal(single.node_counts(), want)
    np.testing.assert_array_equal(sharded.node_counts(), want)
    np.testing.assert_array_equal(sharded.slot_counts().sum(0, dtype=np.uint32),
                                  single.counts.cpu().numpy().view(np.uint32))


def test_pinned_ring_records_on_the_mappers_stream(monkeypatch):
    """A buffer goes back to the ring with the event the mapper recorded on
    its copy stream after the chunk's copies (``upload_done``), on the
    mapper's device whatever the thread's current device is; the ring
    records no event of its own (no card needed: the CUDA calls are stood
    in for)."""
    from kmer_mapper_tpu_torch import pipeline
    from kmer_mapper_tpu_torch.models.mapper import StagingSlots

    recorded = []

    class Stream:
        def __init__(self, device=None):
            self.device = device

        def wait_event(self, event):
            pass

    class Event:
        def record(self, stream=None):
            recorded.append(stream)

    monkeypatch.setattr(torch.cuda, "Stream", Stream)
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: Stream(device))
    monkeypatch.setattr(torch.cuda, "stream", lambda stream: contextlib.nullcontext())
    slots = StagingSlots(torch.device("cpu"), 16, 16)
    copy_stream = slots.stream
    slots.copy(torch.zeros(16, dtype=torch.int32), "packed")
    assert recorded[-1] is copy_stream  # the copy's event, last
    n_recorded = len(recorded)
    ring = pipeline.PinnedRing(0, 16, n_lengths=16)
    ring.release(torch.zeros(16, dtype=torch.int32), slots.copied)
    assert len(recorded) == n_recorded
    assert ring._free.get()[1] is slots.copied
    slots = StagingSlots(torch.device("cuda", 1), 16, 16)
    assert slots.stream.device == torch.device("cuda", 1)


def test_pinned_ring_stages_ragged_lengths(monkeypatch):
    """The ring stages the lengths of a ragged buffer's ``n_reads`` reads as
    int32 beside its words, in a lengths buffer it pins when a slot first
    takes a ragged buffer (a strided buffer's step never reads the lengths,
    so they stay as they are and pin nothing), and hands a slot out again
    only after waiting on the event it came back with, the mapper's where
    its last chunk's copies end (no card needed: page-locked memory and the
    CUDA event are stood in for)."""
    from kmer_mapper_tpu_torch import pipeline

    empty = torch.empty
    monkeypatch.setattr(torch, "empty",
                        lambda *a, pin_memory=False, **kw: empty(*a, **kw))
    waits = []

    class Event:
        def synchronize(self):
            waits.append(self)

    ring = pipeline.PinnedRing(1, 64, n_lengths=16)
    rng = np.random.default_rng(0)
    lengths = rng.integers(0, 100, 16).astype(np.uint16)
    chunks = [
        (rng.integers(0, 1 << 32, 64, dtype=np.uint64).astype(np.uint32), lengths.copy(), 120,
         8, 0, True),
        (rng.integers(0, 1 << 32, 40, dtype=np.uint64).astype(np.uint32), lengths, 700, 9, 2,
         False),
    ]
    staged = ring.staged(iter(chunks))
    slot, (words, lens, *rest) = next(staged)
    np.testing.assert_array_equal(words.numpy().view(np.uint32), chunks[0][0])
    assert lens is chunks[0][1] and rest == [120, 8, 0, True]
    assert slot[1] is None and not waits  # no lengths pinned for a strided buffer
    copied = Event()
    ring.release(slot, copied)
    slot2, (words2, lens2, *rest2) = next(staged)
    assert slot2 is slot and waits == [copied]  # the one slot came back after its event
    assert words2.dtype == lens2.dtype == torch.int32
    np.testing.assert_array_equal(words2.numpy().view(np.uint32), chunks[1][0])
    np.testing.assert_array_equal(lens2.numpy(), lengths[:9].astype(np.int32))
    assert slot[1].shape == (16,)
    assert words2.data_ptr() == slot[0].data_ptr() and lens2.data_ptr() == slot[1].data_ptr()
    assert rest2 == [700, 9, 2, False]
