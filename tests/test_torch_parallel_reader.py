"""The port's byte-region-parallel framing (``io/parallel_reader.py``) against
the JAX package's: the same regions on the same files, every record framed
exactly once, and ``map_file(reader_workers>1)`` equal to the sequential run
and to the oracle (the cases of ``tests/test_parallel_reader.py``).

``map_file`` splits a file into regions of at least two bytes per base of
its buffer; with ``chunk_size`` at most ``CPU_BUF_FLOOR`` the CPU buffer is
``CPU_BUF_FLOOR`` bases, so the files that must split here hold at least
``MIN_REGION`` bytes per worker."""
import logging
import os
import threading

import numpy as np
import pytest

from kmer_mapper_tpu.io import parallel_reader as ref_parallel
from kmer_mapper_tpu_torch import oracle, pipeline
from kmer_mapper_tpu_torch.index import kmer_index
from kmer_mapper_tpu_torch.io import native, parallel_reader, readers


MIN_REGION = 2 * pipeline.CPU_BUF_FLOOR  # map_file's regions at a small chunk_size


def _reads(rng, n, lo=20, hi=90):
    return ["".join(rng.choice(list("ACGT"), rng.integers(lo, hi))) for _ in range(n)]


def _fixed_reads(rng, n, length):
    letters = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, (n, length))]
    return [row.tobytes().decode() for row in letters]


def _splits(path, fmt, n):
    """map_file's regions of ``path`` with ``n`` workers and a small chunk_size."""
    return len(parallel_reader.split_regions(path, fmt, n, min_region=MIN_REGION))


def _figures(caplog):
    """The figures of the latest map_file, off its timing record."""
    return [r.figures for r in caplog.records if hasattr(r, "figures")][-1]


def _write_fasta(path, reads, multiline=False):
    out = []
    for i, s in enumerate(reads):
        body = "\n".join(s[j : j + 17] for j in range(0, len(s), 17)) if multiline else s
        out.append(f">read{i} desc\n{body}\n")
    path.write_text("".join(out))
    return str(path)


def _write_fastq(path, reads, rng):
    """Quality lines that start with '@' or '+' (the splitter's trap)."""
    out = []
    for i, s in enumerate(reads):
        qual = rng.choice(["@", "+", "I"]) + "I" * (len(s) - 1)
        out.append(f"@q{i} xx\n{s}\n+\n{qual}\n")
    path.write_text("".join(out))
    return str(path)


def _region_reads(path, fmt, region):
    stream = parallel_reader.RangeReader(path, *region)
    try:
        return [
            chunk.bases[s : s + n].tobytes().decode()
            for chunk in readers.read_chunks(stream, fmt=fmt, min_chunk_size=512)
            for s, n in zip(chunk.read_starts, chunk.read_lengths)
        ]
    finally:
        stream.close()


def _check_regions(path, fmt, reads, n, **kw):
    regions = parallel_reader.split_regions(path, fmt, n, **kw)
    assert regions == ref_parallel.split_regions(path, fmt, n, **kw)
    assert regions[0][0] == 0 and regions[-1][1] == os.path.getsize(path)
    for (a, b), (c, _) in zip(regions, regions[1:]):
        assert b == c and a < b
    assert [r for region in regions for r in _region_reads(path, fmt, region)] == reads
    return regions


@pytest.mark.parametrize("fmt,multiline", [("fasta", False), ("fasta", True), ("fastq", False)])
@pytest.mark.parametrize("n", [2, 3, 7])
def test_split_regions_match_jax(tmp_path, fmt, multiline, n):
    rng = np.random.default_rng(3)
    reads = _reads(rng, 400)
    if fmt == "fasta":
        path = _write_fasta(tmp_path / "r.fa", reads, multiline)
    else:
        path = _write_fastq(tmp_path / "r.fq", reads, rng)
    assert len(_check_regions(path, fmt, reads, n, min_region=256)) == n


@pytest.mark.parametrize("n", [2, 5, 11])
def test_split_regions_fastq_boundary_in_quality(tmp_path, n):
    """Boundaries that land in quality lines beginning with '@' move on to
    true record headers."""
    rng = np.random.default_rng(5)
    reads = _reads(rng, 300, lo=40, hi=41)
    path = tmp_path / "r.fq"
    path.write_text("".join(f"@q{i}\n{s}\n+\n@" + "I" * 39 + "\n" for i, s in enumerate(reads)))
    _check_regions(str(path), "fastq", reads, n, min_region=128)


def _index(rng, reads, k):
    codes = oracle.encode_bytes(np.frombuffer("".join(reads).encode(), np.uint8))
    read_kmers = oracle.kmer_hashes_ragged(codes, np.array([len(r) for r in reads]), k)
    entry = np.concatenate(
        [rng.choice(read_kmers, 120), rng.integers(0, 1 << 62, 40, dtype=np.uint64)])
    arrays = oracle.build_kmer_index(
        entry, rng.integers(0, 60, len(entry)).astype(np.int32), 997)
    return kmer_index.KmerIndex.from_arrays(arrays), oracle.map_kmers_to_index(
        arrays, read_kmers)


@pytest.mark.parametrize("no_native", [False, True])
@pytest.mark.parametrize("workers", [3, 4])
def test_parallel_map_file_counts_equal(tmp_path, monkeypatch, no_native, workers):
    """reader_workers > 1 gives the sequential run's counts and the oracle's,
    through the native loader and through the numpy framer."""
    if no_native:
        monkeypatch.setenv("KMT_NO_NATIVE", "1")
    rng = np.random.default_rng(21)
    reads = _reads(rng, 8000)  # ~580 KB
    index, want = _index(rng, reads, 9)
    path = _write_fasta(tmp_path / "r.fa", reads)
    assert _splits(path, "fasta", workers) == workers
    before = native.frame_counts["buffers"]
    seq = pipeline.map_file(index, path, device="cpu", k=9, chunk_size=1 << 13)
    par = pipeline.map_file(index, path, device="cpu", k=9, chunk_size=1 << 13,
                            reader_workers=workers)
    assert (native.frame_counts["buffers"] > before) == (not no_native)
    np.testing.assert_array_equal(seq, want)
    np.testing.assert_array_equal(par, want)


def test_parallel_map_file_fastq_adversarial(tmp_path, monkeypatch):
    monkeypatch.setattr(parallel_reader, "_PROBE", 256)
    rng = np.random.default_rng(33)
    reads = _fixed_reads(rng, 9500, 30)  # ~700 KB
    index, want = _index(rng, reads, 7)
    path = _write_fastq(tmp_path / "r.fq", reads, rng)
    assert _splits(path, "fastq", 5) == 5
    par = pipeline.map_file(index, path, device="cpu", k=7, chunk_size=1 << 12,
                            reader_workers=5)
    np.testing.assert_array_equal(par, want)


def test_parallel_single_region_fallbacks(tmp_path):
    """A tiny file takes one region; gzipped input stays sequential."""
    import gzip

    rng = np.random.default_rng(8)
    reads = _reads(rng, 5)
    path = _write_fasta(tmp_path / "tiny.fa", reads)
    assert parallel_reader.split_regions(path, "fasta", 8) == [(0, os.path.getsize(path))]
    index, want = _index(rng, reads, 7)
    got = pipeline.map_file(index, path, device="cpu", k=7, reader_workers=8)
    np.testing.assert_array_equal(got, want)
    gz = tmp_path / "tiny.fa.gz"
    gz.write_bytes(gzip.compress(open(path, "rb").read()))
    got = pipeline.map_file(index, str(gz), device="cpu", k=7, reader_workers=8)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("no_native", [False, True])
def test_worker_error_propagates(tmp_path, monkeypatch, no_native):
    """A malformed record inside one region reaches the caller as the
    framer's error."""
    if no_native:
        monkeypatch.setenv("KMT_NO_NATIVE", "1")
    monkeypatch.setattr(parallel_reader, "_PROBE", 256)
    rng = np.random.default_rng(44)
    reads = _fixed_reads(rng, 8000, 30)  # ~570 KB
    records = [f"@q{i}\n{s}\n+\n{'I' * len(s)}\n" for i, s in enumerate(reads)]
    records[6000] = records[6000].replace("\n+\n", "\nX\n")  # in the last region
    path = tmp_path / "bad.fq"
    path.write_text("".join(records))
    assert _splits(str(path), "fastq", 4) == 4
    index, _ = _index(rng, reads, 7)
    with pytest.raises(ValueError, match="separator"):
        pipeline.map_file(index, str(path), device="cpu", k=7, reader_workers=4)


def test_giant_record_merges_regions(tmp_path, monkeypatch):
    """Targets inside a record far longer than the probe bound merge into the
    previous region; every base still maps once."""
    for module in (parallel_reader, ref_parallel):
        monkeypatch.setattr(module, "_PROBE", 256)
        monkeypatch.setattr(module, "_PROBE_BOUND", 1024)
    rng = np.random.default_rng(55)
    small = _fixed_reads(rng, 12_000, 50)  # ~700 KB around a 400 KB record
    giant = _fixed_reads(rng, 1, 400_000)[0]
    reads = small[:6000] + [giant] + small[6000:]
    path = tmp_path / "genome.fa"
    path.write_text("".join(f">r{i}\n{s}\n" for i, s in enumerate(reads)))
    regions = _check_regions(str(path), "fasta", reads, 8, min_region=512)
    assert 1 < len(regions) < 8
    assert 1 < _splits(str(path), "fasta", 8) < 8
    index, want = _index(rng, reads, 9)
    par = pipeline.map_file(index, str(path), device="cpu", k=9, chunk_size=1 << 12,
                            reader_workers=8)
    np.testing.assert_array_equal(par, want)


def test_parallel_iterator_stops_workers_when_closed(tmp_path):
    """Closing the iterator early stops every worker thread."""
    import threading
    import time

    def region_iter(region):
        for i in range(10_000):
            yield region, i

    path = tmp_path / "r.fa"
    path.write_text("".join(f">r{i}\n{'ACGT' * 20}\n" for i in range(400)))
    before = threading.active_count()
    it = parallel_reader.parallel_packed_iterator(
        str(path), "fasta", region_iter, 4, min_region=256)
    assert len({next(it)[0] for _ in range(50)}) >= 1
    it.close()
    deadline = time.monotonic() + 10
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before


def test_many_workers_stress(tmp_path, caplog):
    """Many framing workers with a short thread switch interval: every
    buffer is counted once by the native loader's counter and mapped once
    (a lost update or a lost buffer breaks one of the equalities)."""
    import sys

    caplog.set_level(logging.INFO, logger=pipeline.__name__)
    rng = np.random.default_rng(66)
    reads = _fixed_reads(rng, 34_000, 30)  # ~2.6 MB
    index, want = _index(rng, reads, 9)
    path = _write_fastq(tmp_path / "r.fq", reads, rng)
    workers = 19
    assert _splits(path, "fastq", workers) == workers
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        before = native.frame_counts["buffers"]
        got = pipeline.map_file(index, path, device="cpu", k=9, chunk_size=1 << 12,
                                reader_workers=workers)
    finally:
        sys.setswitchinterval(interval)
    np.testing.assert_array_equal(got, want)
    if native.available():
        assert native.frame_counts["buffers"] - before == _figures(caplog)["chunks"] >= workers


def test_file_of_one_buffer_stays_one_region(tmp_path, caplog):
    """A region holds at least two bytes per buffer base: a file of about one
    buffer maps as one buffer whatever -t says, since every region's partly
    filled last buffer costs a device step; a file of eight regions' bytes
    maps as eight buffers, one a region."""
    caplog.set_level(logging.INFO, logger=pipeline.__name__)
    rng = np.random.default_rng(77)
    reads = _fixed_reads(rng, 11_500, 40)
    index, want = _index(rng, reads[:700], 9)
    small = _write_fastq(tmp_path / "small.fq", reads[:700], rng)  # ~66 KB, 28 K bases
    got = pipeline.map_file(index, small, device="cpu", k=9, chunk_size=1 << 12,
                            reader_workers=8)
    np.testing.assert_array_equal(got, want)
    assert _figures(caplog)["chunks"] == 1
    index, want = _index(rng, reads, 9)
    path = _write_fastq(tmp_path / "r.fq", reads, rng)  # ~1.09 MB, < 64 K bases a region
    assert _splits(path, "fastq", 8) == 8
    got = pipeline.map_file(index, path, device="cpu", k=9, chunk_size=1 << 12,
                            reader_workers=8)
    np.testing.assert_array_equal(got, want)
    assert _figures(caplog)["chunks"] == 8


class _Interrupt(BaseException):
    """Not an Exception: a producer that forwarded only Exceptions would die
    without a word and leave its consumer waiting forever."""


def _interrupted():
    yield "first"
    raise _Interrupt


def _drain(iterator):
    """Consume ``iterator`` on a thread; return what it raised (or None), or
    fail the test if it is still waiting after ten seconds."""
    raised = []

    def run():
        try:
            for _ in iterator:
                pass
            raised.append(None)
        except BaseException as exc:
            raised.append(exc)

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    thread.join(10)
    assert raised, "the consumer is still waiting for a producer that died"
    return raised[0]


class _InterruptedStream:
    def read(self, n):
        raise _Interrupt

    def close(self):
        pass


@pytest.mark.parametrize("producer", ["prefetch", "parallel_packed_iterator", "threaded_reader"])
def test_producer_base_exception_reaches_the_consumer(tmp_path, producer):
    if producer == "prefetch":
        iterator = pipeline.prefetch(_interrupted(), depth=2)
    elif producer == "parallel_packed_iterator":
        path = _write_fasta(tmp_path / "r.fa", _reads(np.random.default_rng(9), 400))
        iterator = parallel_reader.parallel_packed_iterator(
            path, "fasta", lambda region: _interrupted(), 4, min_region=256)
    else:
        stream = readers._ThreadedReader(_InterruptedStream())
        iterator = iter(lambda: stream.read(16), b"")
    assert isinstance(_drain(iterator), _Interrupt)
