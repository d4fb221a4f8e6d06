"""The port's native C++ loader against the JAX package's native loader and
the port's numpy framer + packer: the same bytes give bit-identical buffers
(the cases of ``tests/test_native_loader.py``), the library is built under
``kmer_mapper_tpu_torch/_build/``, and a failed build warns and leaves the
numpy framer in charge."""
import gzip
import io
import logging

import numpy as np
import pytest

from kmer_mapper_tpu.io import native as ref_native
from kmer_mapper_tpu_torch import oracle, pipeline
from kmer_mapper_tpu_torch.index import kmer_index
from kmer_mapper_tpu_torch.io import native, readers


@pytest.fixture(autouse=True)
def _both_native_loaders():
    if not ref_native.available():
        pytest.skip("the JAX package's native loader is unavailable (no g++)")
    assert native.available(), "the port's native loader did not build"


def _random_reads(rng, n, lo=10, hi=120, alphabet="ACGT"):
    return ["".join(rng.choice(list(alphabet), rng.integers(lo, hi))) for _ in range(n)]


def _fastq(reads, qual="F"):
    return "".join(f"@r{i} c\n{s}\n+\n{qual * len(s)}\n" for i, s in enumerate(reads)).encode()


def _fasta_wrapped(reads, width=60):
    return "".join(
        f">r{i}\n" + "\n".join(s[j : j + width] for j in range(0, len(s), width)) + "\n"
        for i, s in enumerate(reads)
    ).encode()


def _uniform(rng, n, L, alphabet="ACGT"):
    return ["".join(rng.choice(list(alphabet), L)) for _ in range(n)]


def _mixed_lengths():
    reads = _uniform(np.random.default_rng(12), 120, 41)
    reads[30] = reads[30][:-3]  # short read
    reads[77] = reads[77] + "ACGT"  # long read
    return _fastq(reads)


def _at_capacity():
    rng = np.random.default_rng(13)
    return _fastq(_uniform(rng, 8, 32) + _uniform(rng, 1, 37) + _uniform(rng, 3, 32))


def _zero_length(fmt):
    rng = np.random.default_rng(16)
    reads = _uniform(rng, 4, 32) + [""] + _uniform(rng, 2, 32)
    if fmt == "fasta":
        return "".join(f">r{i}\n{s}\n" for i, s in enumerate(reads)).encode()
    return _fastq(reads)


def _long_fastq(seed, tail):
    seq = "".join(np.random.default_rng(seed).choice(list("ACGT"), 2000))
    return f"@a\n{seq}\n+\n{'I' * 2000}\n@b\n{tail}\n+\n{'I' * len(tail)}\n".encode()


# name -> (bytes, fmt, max_bases, max_reads, k, block_bytes, read_len)
CASES = {
    **{f"fastq_random_block{b}": (
        _fastq(_random_reads(np.random.default_rng(0), 150)), "fastq", 1024, 64, 31, b, 0)
       for b in (64, 300, 1 << 16)},
    **{f"fasta_multiline_block{b}": (
        _fasta_wrapped(_random_reads(np.random.default_rng(1), 100, lo=5, hi=200)),
        "fasta", 1024, 64, 31, b, 0) for b in (64, 511, 1 << 16)},
    "fasta_crlf_no_trailing_newline": (
        b">a\r\nACGT\r\nTTAA\r\n>b\r\nGGCC", "fasta", 256, 16, 5, 32, 0),
    "n_and_invalid_bases": (b">a\nACGTNNXACGT\n", "fasta", 256, 16, 5, 64, 0),
    "long_read_split": (
        f">chr\n{''.join(np.random.default_rng(2).choice(list('ACGT'), 3000))}\n".encode(),
        "fasta", 512, 64, 31, 200, 0),
    "fastq_lowercase_short": (
        b"@a\nacgtn\n+\n!!!!!\n@b\nAC\n+\n!!\n@c\nggttaacc\n+zz\n!!!!!!!!\n",
        "fastq", 128, 8, 3, 16, 0),
    "fastq_long_read_resume": (_long_fastq(6, "ACGTACGTACGT"), "fastq", 256, 64, 21, 128, 0),
    **{f"strided_uniform_block{b}": (
        _fastq(_uniform(np.random.default_rng(10), 200, 37, "ACGTN")),
        "fastq", 1024, 64, 31, b, 37) for b in (64, 300, 1 << 16)},
    "strided_fasta_wrapped": (
        _fasta_wrapped(_uniform(np.random.default_rng(11), 80, 100)),
        "fasta", 1 << 12, 64, 31, 200, 100),
    **{f"strided_mixed_block{b}": (_mixed_lengths(), "fastq", 512, 64, 31, b, 41)
       for b in (128, 1 << 16)},
    "strided_at_capacity": (_at_capacity(), "fastq", 8 * 32, 64, 31, 1 << 16, 32),
    "strided_long_record_split": (_long_fastq(14, "ACGT" * 8), "fastq", 256, 64, 21, 128, 32),
    "strided_read_len_too_long": (
        _fastq(_uniform(np.random.default_rng(15), 20, 40)), "fastq", 1024, 64, 31, 1 << 16,
        2048),
    "zero_length_at_full_buffer": (_zero_length("fastq"), "fastq", 1 << 12, 4, 31, 1 << 16, 0),
    "zero_length_at_full_buffer_strided": (
        _zero_length("fastq"), "fastq", 1 << 12, 4, 31, 1 << 16, 32),
    "zero_length_at_full_buffer_fasta": (
        _zero_length("fasta"), "fasta", 1 << 12, 4, 31, 1 << 16, 0),
}


def _port_native(data, fmt, mb, mr, k, block, rl):
    return list(native.pack_stream_native(io.BytesIO(data), fmt, mb, mr, k, block, read_len=rl))


def _jax_native(data, fmt, mb, mr, k, block, rl):
    return list(ref_native.pack_stream_native(
        io.BytesIO(data), fmt, mb, mr, k, block, read_len=rl))


def _port_numpy(data, fmt, mb, mr, k, block, rl):
    if rl and not k <= rl <= min(65535, mb):
        rl = 0  # the native loaders pack such a stream continuously
    chunks = readers.read_chunks(io.BytesIO(data), fmt=fmt, min_chunk_size=block)
    return list(readers.pack_for_device(chunks, mb, mr, k, read_len=rl))


def _assert_same(a, b):
    assert len(a) == len(b), (len(a), len(b))
    for x, y in zip(a, b):
        assert len(x) == len(y)
        np.testing.assert_array_equal(x[0], y[0])
        np.testing.assert_array_equal(x[1], y[1])
        assert x[0].dtype == y[0].dtype and x[1].dtype == y[1].dtype
        assert tuple(x[2:]) == tuple(y[2:])


@pytest.mark.parametrize("case", list(CASES))
def test_native_matches_jax_native_and_numpy(case):
    args = CASES[case]
    got = _port_native(*args)
    assert got
    _assert_same(got, _jax_native(*args))
    _assert_same(got, _port_numpy(*args))
    flags = [t[5] for t in got] if len(got[0]) == 6 else []
    if case.startswith("strided_uniform") or case == "strided_fasta_wrapped":
        assert all(flags)
    if case.startswith("strided_mixed"):
        assert any(flags) and not all(flags)
    if case == "strided_at_capacity":
        assert flags[:2] == [True, False] and got[0][3] == 8
    if case.startswith("zero_length"):
        assert len(got) == 2 and got[1][1][0] == 0  # the empty read opens buffer 2
    if case == "n_and_invalid_bases":
        assert got[0][4] == 1  # X is invalid; N counts as A


@pytest.mark.parametrize("data,match", [
    (b"@a\nACGT\n+\n!!!!\n@b\nACG\n", "truncated FASTQ"),
    (b"xa\nACGT\n+\n!!!!\n", "header"),
    (b"@a\nACGT\nx\n!!!!\n", "separator"),
])
def test_malformed_fastq_raises_like_jax(data, match):
    for loader in (_port_native, _jax_native, _port_numpy):
        with pytest.raises(ValueError, match=match):
            loader(data, "fastq", 128, 8, 3, 16, 0)


def test_gzip_stream_matches_numpy(tmp_path):
    reads = _random_reads(np.random.default_rng(3), 200)
    text = _fastq(reads, "I")
    path = tmp_path / "r.fq.gz"
    path.write_bytes(gzip.compress(text))
    got = list(native.pack_stream_native(
        readers.open_bytes(str(path)), "fastq", 2048, 128, 31, 1024))
    _assert_same(got, _port_numpy(text, "fastq", 2048, 128, 31, 1024, 0))


def test_restride_native_matches_numpy():
    rng = np.random.default_rng(7)
    L, n = 45, 30
    flat = np.frombuffer(
        "".join(_uniform(rng, n, L)).encode(), dtype=np.uint8)
    chunk = readers.SequenceChunk(flat, np.arange(n, dtype=np.int64) * L)
    (cont, _, nb, nr, _), = readers.pack_for_device(iter([chunk]), 2048, 64, 31)
    rows = readers.strided_rows(2048, L)
    (direct, *_), = readers.pack_for_device(iter([chunk]), 2048, 64, 31, read_len=L)
    np.testing.assert_array_equal(native.restride_native(cont, nr, L, rows), direct)
    np.testing.assert_array_equal(
        native.restride_native(cont, nr, L, rows),
        ref_native.restride_native(cont, nr, L, rows))
    with pytest.raises(ValueError, match="too short"):
        native.restride_native(cont[:10], nr, L, rows)


def test_library_built_under_build_dir():
    path = native.library_path()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert native.BUILD_DIR.name == "_build" and native.BUILD_DIR.parent.name == (
        "kmer_mapper_tpu_torch")
    assert path.name.startswith("kmer_host-") and path.suffix == ".so"
    assert native._cpu_tag() in path.name  # never loaded on another CPU model
    # nothing built beside a source
    assert not list(native.SOURCE.parent.glob("*.so"))
    assert not list((native.BUILD_DIR.parent / "io").glob("*.so"))


def test_failed_build_warns_and_numpy_frames(tmp_path, monkeypatch, caplog):
    """A source that does not compile: the loader logs a WARNING naming the
    numpy framer and the compiler's error, and the pipeline maps with the
    numpy framer, giving the oracle's counts."""
    bad = tmp_path / "kmer_host.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    with caplog.at_level(logging.WARNING, logger=native.__name__):
        assert not native.available()
    warning = [r for r in caplog.records if r.levelno == logging.WARNING]
    assert warning and "numpy framer" in warning[0].getMessage()
    assert "error" in warning[0].getMessage()
    assert not list((tmp_path / "_build").glob("*"))  # no partial library left

    rng = np.random.default_rng(4)
    reads = _uniform(rng, 60, 50)
    (tmp_path / "r.fq").write_bytes(_fastq(reads))
    codes = oracle.encode_bytes(np.frombuffer("".join(reads).encode(), np.uint8))
    kmers = oracle.kmer_hashes_ragged(codes, np.full(60, 50), 21)
    arrays = oracle.build_kmer_index(kmers[::4], rng.integers(0, 20, len(kmers[::4])), 257)
    before = dict(native.frame_counts)
    got = pipeline.map_file(kmer_index.KmerIndex.from_arrays(arrays), str(tmp_path / "r.fq"),
                            device="cpu", k=21)
    assert native.frame_counts == before  # the native loader framed nothing
    np.testing.assert_array_equal(got, oracle.map_kmers_to_index(arrays, kmers))


@pytest.mark.parametrize("fmt", ["fasta", "fastq"])
def test_map_file_native_vs_numpy_vs_oracle(tmp_path, monkeypatch, fmt):
    """map_file gives the same node counts through either loader, equal to
    the oracle's; the native run frames through the native loader."""
    rng = np.random.default_rng(5)
    k = 7
    reads = _random_reads(rng, 100, alphabet="ACGTN")
    codes = [oracle.encode_bytes(np.frombuffer(r.replace("N", "A").encode(), np.uint8))
             for r in reads]
    read_kmers = oracle.kmer_hashes_ragged(
        np.concatenate(codes), np.array([len(c) for c in codes]), k)
    arrays = oracle.build_kmer_index(
        rng.choice(read_kmers, 200), rng.integers(0, 60, 200).astype(np.int32), 997)
    path = tmp_path / ("reads.fa" if fmt == "fasta" else "reads.fq")
    path.write_bytes(_fasta_wrapped(reads, 50) if fmt == "fasta" else _fastq(reads))
    index = kmer_index.KmerIndex.from_arrays(arrays)
    before = native.frame_counts["buffers"]
    native_counts = pipeline.map_file(index, str(path), device="cpu", k=k, chunk_size=1 << 14)
    assert native.frame_counts["buffers"] > before
    monkeypatch.setenv("KMT_NO_NATIVE", "1")
    assert not native.available()
    numpy_counts = pipeline.map_file(index, str(path), device="cpu", k=k, chunk_size=1 << 14)
    np.testing.assert_array_equal(native_counts, numpy_counts)
    np.testing.assert_array_equal(native_counts, oracle.map_kmers_to_index(arrays, read_kmers))
