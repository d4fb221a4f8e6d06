"""The mapper's staging of page-locked chunks: on CUDA each chunk's words
(and a ragged chunk's lengths) are copied on the mapper's copy stream into
one of two device slots, taken in turn, while the mapper's stream runs the
previous chunk's kernels (``models/mapper.py:StagingSlots``);
``pipeline.PinnedRing`` rewrites a host buffer only once the copies that
read it have ended (``KmerMapper.upload_done``). Jax-free, so it also runs
on the GPU machine:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_staging.py

The CPU tests stand in for the CUDA streams and events; the tests of the
overlap itself carry the ``cuda`` marker and skip where PyTorch sees no
GPU."""
import contextlib

import numpy as np
import pytest
import torch

from kmer_mapper_tpu_torch import oracle, pipeline
from kmer_mapper_tpu_torch.index import kmer_index
from kmer_mapper_tpu_torch.io import readers
from kmer_mapper_tpu_torch.models import mapper as mapper_mod
from kmer_mapper_tpu_torch.ops import hashing, stream_probe

K = 31
READ_LEN = 151
BUF = 4096  # bases a chunk: 27 reads of READ_LEN

#: (strided, revcomp) of each step's case
STEPS = {"plane": (True, False), "plane_revcomp": (True, True),
         "ragged": (False, False), "ragged_revcomp": (False, True)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the copy stream and the kernels have no CPU mode)")
    return torch.device("cuda")


def _chunks(strided: bool, revcomp: bool, n_chunks: int, seed: int = 5):
    """A small index, its config, ``n_chunks`` distinct packed chunks
    (``pack_for_device``'s tuples, the lengths cut to the chunk's reads) and
    the node counts the oracle gives for all of them."""
    rng = np.random.default_rng(seed)
    lengths = (np.full(BUF // READ_LEN * n_chunks, READ_LEN) if strided
               else rng.integers(40, 200, BUF // 100 * n_chunks))  # 120 bp on average
    codes = rng.integers(0, 4, int(lengths.sum()))
    kmers = oracle.kmer_hashes_ragged(codes, lengths, K)
    if revcomp:
        kmers = np.concatenate([kmers, oracle.revcomp_hash(kmers, K)])
    entries = np.concatenate([kmers[::7], rng.integers(0, 1 << 62, 2000, dtype=np.uint64)])
    arrays = oracle.build_kmer_index(entries, rng.integers(0, 500, len(entries)), 4099)
    config = mapper_mod.MapperConfig(k=K, buf=BUF, max_reads=64, revcomp=revcomp,
                                     read_len=READ_LEN if strided else 0)
    chunk = readers.SequenceChunk(np.frombuffer(b"ACGT", np.uint8)[codes],
                                  np.cumsum(lengths) - lengths)
    packed = []
    for out in readers.pack_for_device(iter([chunk]), config.buf, config.max_reads, K,
                                       read_len=config.read_len):
        words, lens, n_bases, n_reads = out[:4]
        packed.append((words, lens[:n_reads], n_bases, strided and out[5]))
    assert len(packed) >= n_chunks and all(c[3] == strided for c in packed)
    return (kmer_index.KmerIndex.from_arrays(arrays), config, packed,
            oracle.map_kmers_to_index(arrays, kmers), len(kmers) // (2 if revcomp else 1))


class _Stream:
    def __init__(self, name, log):
        self.name, self.log = name, log

    def wait_event(self, event):
        self.log.append(("wait", self.name, event))


@pytest.fixture
def stand_ins(monkeypatch):
    """CUDA's streams and events stood in for: every record and wait goes
    into the returned log, as (what, stream, event)."""
    log = []

    class Event:
        def record(self, stream=None):
            log.append(("record", stream.name, self))

    main = _Stream("main", log)
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: _Stream("copy", log))
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: main)
    monkeypatch.setattr(torch.cuda, "stream", lambda stream: contextlib.nullcontext())
    return log


def test_staging_slots_take_turns(stand_ins):
    """Chunks take the two slots in turn; each slot is allocated once, on
    first use (a lengths slot only when a chunk stages lengths); the copy
    stream waits on the slot's "free" event before it writes, the mapper's
    stream on the copy's event before it reads, and the slot's "free"
    event is recorded on the mapper's stream when the chunk has passed."""
    slots = mapper_mod.StagingSlots(torch.device("cpu"), 8, 4)
    ptrs, want = [], []
    for i in range(5):
        words = torch.arange(i, i + 6 + i % 2, dtype=torch.int32)
        got = slots.copy(words, "packed")
        assert slots.slot == i % 2
        assert torch.equal(got, words) and slots._slots["lengths"] == [None, None]
        ptrs.append(got.data_ptr())
        free = slots._free[i % 2]
        want.append(("wait", "copy", free))
        if i < 2:  # a new slot: the copy waits for the mapper's queued work
            ready = stand_ins[len(want)][2]
            want += [("record", "main", ready), ("wait", "copy", ready)]
        slots.passed()
        assert slots.slot is None
        want += [("record", "copy", slots.copied), ("wait", "main", slots.copied),
                 ("record", "main", free)]
    assert ptrs[0] == ptrs[2] == ptrs[4] != ptrs[1] == ptrs[3]
    assert stand_ins == want
    # a ragged chunk: its words and lengths in slot 1, two copies, one wait
    # for the slot and one for the new lengths slot
    del stand_ins[:]
    slots.copy(torch.zeros(8, dtype=torch.int32), "packed")
    words_copied = slots.copied
    lengths = slots.copy(torch.tensor([3, 1, 4], dtype=torch.int32), "lengths")
    assert slots.slot == 1 and lengths.tolist() == [3, 1, 4]
    assert slots._slots["lengths"][0] is None and slots._slots["lengths"][1].shape == (4,)
    ready = stand_ins[3][2]
    assert stand_ins == [("wait", "copy", slots._free[1]), ("record", "copy", words_copied),
                         ("wait", "main", words_copied), ("record", "main", ready),
                         ("wait", "copy", ready), ("record", "copy", slots.copied),
                         ("wait", "main", slots.copied)]
    assert slots.copied is not words_copied and ready not in (words_copied, slots.copied)


@pytest.mark.parametrize("what,n", [("packed", 9), ("lengths", 5)])
def test_staging_slots_refuse_a_chunk_past_the_config(stand_ins, what, n):
    slots = mapper_mod.StagingSlots(torch.device("cpu"), 8, 4)
    with pytest.raises(ValueError, match="past the staging slot"):
        slots.copy(torch.zeros(n, dtype=torch.int32), what)


@pytest.mark.parametrize("read_len", [0, 31, 100, 151, 250])
@pytest.mark.parametrize("buf", [4096, 1 << 16, 128 << 20])
def test_max_words_holds_every_chunk_of_the_config(buf, read_len):
    """The slots' words: the packer's largest buffer for the config, in
    either layout."""
    config = mapper_mod.MapperConfig(k=K, buf=buf, max_reads=1024, read_len=read_len)
    want = buf // 16 + 2
    if read_len:
        want = max(want, readers.strided_rows(buf, read_len) * (hashing.read_stride(read_len)
                                                                // 16))
    assert config.max_words == want
    if buf == 4096:
        rng = np.random.default_rng(buf + read_len)
        reads = rng.integers(0, 4, 8 * buf)
        lengths = np.full(8 * buf // max(read_len, 64), max(read_len, 64))
        chunk = readers.SequenceChunk(np.frombuffer(b"ACGT", np.uint8)[reads[:lengths.sum()]],
                                      np.cumsum(lengths) - lengths)
        words = [out[0].shape[0] for out in readers.pack_for_device(
            iter([chunk]), buf, 1024, K, read_len=read_len)]
        assert len(words) > 1 and max(words) <= config.max_words


@pytest.mark.parametrize("step", list(STEPS))
def test_map_chunk_frees_the_slot_after_the_hash_and_before_the_count(stand_ins, monkeypatch,
                                                                      step):
    """A mapper whose chunks are staged (the CUDA path, with CPU slots and
    the streams stood in for): the chunk's copies come first, its slot is
    marked free on the mapper's stream after the hash-key kernel, the last
    reader of the slot, and before the partition and count; ``upload_done``
    is the chunk's last copy; the counts are the oracle's."""
    strided, revcomp = STEPS[step]
    index, config, packed, want, n_windows = _chunks(strided, revcomp, 4)
    mapper = mapper_mod.KmerMapper(index, config, "cpu")
    mapper._staging = mapper_mod.StagingSlots(torch.device("cpu"), config.max_words,
                                              config.max_reads)
    monkeypatch.setattr(torch.Tensor, "is_pinned", lambda self: True)
    for module, name in ((hashing, "plane_hash_keys"), (hashing, "ragged_hash_keys"),
                         (stream_probe, "stream_probe_count_keys")):
        def logged(*args, _f=getattr(module, name), _name=name, **kw):
            stand_ins.append(("call", _name, None))
            return _f(*args, **kw)

        monkeypatch.setattr(module, name, logged)
    hash_name = "plane_hash_keys" if strided else "ragged_hash_keys"
    for i, (words, lens, n_bases, strided_) in enumerate(packed):
        del stand_ins[:]
        mapper.map_chunk(torch.from_numpy(words.view(np.int32)),
                         torch.from_numpy(lens.astype(np.int32)), n_bases, strided=strided_)
        free = mapper._staging._free[i % 2]
        # a slot's first use: the copy waits for the mapper's queued work
        new_slot = [("record", "main"), ("wait", "copy")] if i < 2 else []
        copy = [("record", "copy"), ("wait", "main")]
        staged = new_slot + copy if strided else new_slot + copy + new_slot + copy
        assert [e[:2] for e in stand_ins] == (
            [("wait", "copy")] + staged
            + [("call", hash_name), ("record", "main"), ("call", "stream_probe_count_keys")])
        assert stand_ins[0][2] is free and stand_ins[-2][2] is free
        assert mapper.upload_done is [e[2] for e in stand_ins if e[:2] == ("record", "copy")][-1]
    assert mapper.n_kmers_mapped == n_windows
    np.testing.assert_array_equal(mapper.node_counts(), want)


@pytest.mark.parametrize("step", list(STEPS))
def test_cpu_mapper_makes_no_stream_and_no_slot(monkeypatch, step):
    """On the CPU the mapper makes no stream, event or slot, and maps host
    words and lengths (numpy or CPU tensors) as before."""
    def no_cuda(*args, **kwargs):
        raise AssertionError("a CPU mapper touched CUDA")

    monkeypatch.setattr(torch.cuda, "Stream", no_cuda)
    monkeypatch.setattr(torch.cuda, "Event", no_cuda)
    strided, revcomp = STEPS[step]
    index, config, packed, want, n_windows = _chunks(strided, revcomp, 3)
    mapper = mapper_mod.KmerMapper(index, config, "cpu")
    assert mapper._staging is None
    for i, (words, lens, n_bases, strided_) in enumerate(packed):
        if i % 2:
            words, lens = torch.from_numpy(words.view(np.int32)), torch.from_numpy(
                lens.astype(np.int32))
        mapper.map_chunk(words, lens, n_bases, strided=strided_)
        assert mapper.upload_done is None
    assert mapper.n_kmers_mapped == n_windows
    np.testing.assert_array_equal(mapper.node_counts(), want)


def _reads_file(tmp_path, kind: str, n_reads: int = 1500, seed: int = 9):
    """A FASTQ of ``n_reads`` reads (151 bp, or 40-250 bp for ``ragged``)
    with N bases, its index and the oracle's node counts (both strands'
    hashes under ``revcomp``)."""
    rng = np.random.default_rng(seed)
    lengths = (rng.integers(40, 250, n_reads) if kind.startswith("ragged")
               else np.full(n_reads, READ_LEN))
    reads = ["".join(rng.choice(list("ACGTN"), n, p=[0.24] * 4 + [0.04])) for n in lengths]
    path = tmp_path / "reads.fq"
    path.write_text("".join(f"@r{i}\n{s}\n+\n{'I' * len(s)}\n" for i, s in enumerate(reads)))
    codes = oracle.encode_bytes(np.frombuffer("".join(reads).encode(), np.uint8))
    kmers = oracle.kmer_hashes_ragged(codes, lengths, K)
    if kind.endswith("revcomp"):
        kmers = np.concatenate([kmers, oracle.revcomp_hash(kmers, K)])
    entries = np.concatenate([kmers[::40], rng.integers(0, 1 << 62, 3000, dtype=np.uint64)])
    arrays = oracle.build_kmer_index(entries, rng.integers(0, 700, len(entries)), 20011)
    kmer_index.save_reference_npz(tmp_path / "index.npz", arrays)
    return path, tmp_path / "index.npz", oracle.map_kmers_to_index(arrays, kmers)


@pytest.mark.parametrize("kind", ["fixed", "fixed_revcomp", "ragged", "ragged_revcomp"])
def test_map_file_on_the_cpu_stages_nothing(kind, tmp_path, monkeypatch):
    """map_file on the CPU: several buffers, no ring, no stream, and the
    oracle's node counts."""
    def no_cuda(*args, **kwargs):
        raise AssertionError("map_file on the CPU touched CUDA")

    monkeypatch.setattr(torch.cuda, "Stream", no_cuda)
    monkeypatch.setattr(torch.cuda, "Event", no_cuda)
    monkeypatch.setattr(pipeline, "PinnedRing", no_cuda)
    calls = []
    map_chunk = mapper_mod.KmerMapper.map_chunk

    def counted(self, *args, **kwargs):
        calls.append(kwargs.get("strided"))
        return map_chunk(self, *args, **kwargs)

    monkeypatch.setattr(mapper_mod.KmerMapper, "map_chunk", counted)
    path, index_path, want = _reads_file(tmp_path, kind)
    got = pipeline.map_file(str(index_path), str(path), device="cpu", k=K,
                            chunk_size=1 << 16, queue_depth=1,
                            map_reverse_complements=kind.endswith("revcomp"))
    assert len(calls) >= 3
    assert all(calls) if kind.startswith("fixed") else not any(calls)
    np.testing.assert_array_equal(got, want)


def _pinned(words, lens):
    return (torch.from_numpy(words.view(np.int32)).pin_memory(),
            torch.from_numpy(lens.astype(np.int32)).pin_memory())


@pytest.mark.cuda
@pytest.mark.parametrize("step", list(STEPS))
def test_back_to_back_pinned_chunks_equal_one_at_a_time(cuda_device, step):
    """Distinct page-locked chunks mapped back to back, the mapper's stream
    held up before each so that a copy that did not wait for its slot would
    overwrite words a hash kernel has yet to read, give the node counts and
    k-mers of the same chunks mapped one at a time with a synchronize
    between calls, and the oracle's."""
    strided, revcomp = STEPS[step]
    index, config, packed, want, n_windows = _chunks(strided, revcomp, 5)
    pinned = [_pinned(words, lens) for words, lens, _, _ in packed]
    together = mapper_mod.KmerMapper(index, config, cuda_device)
    apart = mapper_mod.KmerMapper(index, config, cuda_device)
    for (words, lens), (_, _, n_bases, strided_) in zip(pinned, packed):
        torch.cuda._sleep(1 << 22)
        together.map_chunk(words, lens, n_bases, strided=strided_)
    for (words, lens), (_, _, n_bases, strided_) in zip(pinned, packed):
        apart.map_chunk(words, lens, n_bases, strided=strided_)
        torch.cuda.synchronize()
    assert together.n_kmers_mapped == apart.n_kmers_mapped == n_windows
    np.testing.assert_array_equal(together.node_counts(), apart.node_counts())
    np.testing.assert_array_equal(together.node_counts(), want)
    assert together._staging.copied.query()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["fixed", "fixed_revcomp", "ragged", "ragged_revcomp"])
def test_map_file_through_the_ring_at_queue_depth_1(kind, cuda_device, tmp_path, monkeypatch):
    """map_file with a queue depth of 1 (three host buffers in the ring)
    over more buffers than the ring and the device slots hold, the mapper's
    stream held up before each chunk so that the copies lag the host: a
    host buffer rewritten before its copy ended would change the counts.
    Equal to the oracle."""
    monkeypatch.setattr(pipeline, "CUDA_BUF", 1 << 16)
    calls = []
    map_chunk = mapper_mod.KmerMapper.map_chunk

    def held_up(self, *args, **kwargs):
        calls.append(kwargs.get("strided"))
        torch.cuda._sleep(1 << 22)
        return map_chunk(self, *args, **kwargs)

    monkeypatch.setattr(mapper_mod.KmerMapper, "map_chunk", held_up)
    path, index_path, want = _reads_file(tmp_path, kind, n_reads=3000)
    got = pipeline.map_file(str(index_path), str(path), device=cuda_device, k=K,
                            queue_depth=1, map_reverse_complements=kind.endswith("revcomp"))
    assert len(calls) > 3
    assert all(calls) if kind.startswith("fixed") else not any(calls)
    np.testing.assert_array_equal(got, want)
