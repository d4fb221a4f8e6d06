"""The rest of the port's ``map`` surface against the JAX package's and the
numpy oracle, on the CPU: ``--strict-bases``, ``--profile-dir``, ``-t``,
``-d``, ``-g``, ``-s``; ``map_sequences``; the drop-in functions ``map_bnp``,
``map_cpu`` and ``map_gpu``; ``util``, ``encodings``, ``tools`` and
``utils``. Every comparison is exact."""
import argparse
import glob
import gzip
import json
import logging
import types

import numpy as np
import pytest
import torch

from kmer_mapper_tpu import cli as ref_cli
from kmer_mapper_tpu import command_line_interface as ref_cli_functions
from kmer_mapper_tpu import encodings as ref_encodings
from kmer_mapper_tpu import pipeline as ref_pipeline
from kmer_mapper_tpu import tools as ref_tools
from kmer_mapper_tpu import util as ref_util
from kmer_mapper_tpu.index import kmer_index as ref_ki
from kmer_mapper_tpu_torch import cli, command_line_interface, encodings, oracle, pipeline
from kmer_mapper_tpu_torch import tools, util
from kmer_mapper_tpu_torch.index import kmer_index
from kmer_mapper_tpu_torch.utils import timing


def _reads(rng, n, length, alphabet="ACGT"):
    return ["".join(rng.choice(list(alphabet), length)) for _ in range(n)]


def _fixture(tmp_path, rng, reads, k):
    """reads.fq and index.npz of the reads; returns their paths, the index
    arrays and the reads' k-mer hashes (N counted as A)."""
    fq = tmp_path / "reads.fq"
    fq.write_text("".join(f"@r{i}\n{s}\n+\n{'I' * len(s)}\n" for i, s in enumerate(reads)))
    kmers = util.get_kmer_hashes_from_chunk_sequence([r.replace("N", "A") for r in reads], k)
    entries = np.concatenate([kmers[::3], rng.integers(0, 1 << (2 * k), 100, dtype=np.uint64)])
    arrays = oracle.build_kmer_index(
        entries, rng.integers(0, 200, len(entries)).astype(np.int32), 2053)
    kmer_index.save_reference_npz(tmp_path / "index.npz", arrays)
    return str(fq), str(tmp_path / "index.npz"), arrays, kmers


@pytest.fixture
def root_log_level():
    level = logging.getLogger().level
    yield
    logging.getLogger().setLevel(level)


@pytest.mark.parametrize("bad", ["X", "N"])
def test_strict_bases(tmp_path, bad):
    """--strict-bases raises on a non-ACGTN base, as the JAX CLI does, and
    maps N (as A) like any base."""
    rng = np.random.default_rng(1)
    reads = _reads(rng, 40, 45)
    reads[7] = reads[7][:20] + bad + reads[7][21:]
    fq, index, arrays, _ = _fixture(tmp_path, rng, [r.replace("X", "A") for r in reads], 21)
    fq_path = tmp_path / "strict.fq"
    fq_path.write_text("".join(f"@r{i}\n{s}\n+\n{'I' * 45}\n" for i, s in enumerate(reads)))
    args = ["map", "-i", index, "-f", str(fq_path), "-k", "21", "--strict-bases"]
    if bad == "X":
        with pytest.raises(ValueError, match="--strict-bases"):
            cli.main(args + ["-o", str(tmp_path / "port"), "--device", "cpu"])
        with pytest.raises(ValueError, match="--strict-bases"):
            ref_cli.main(args + ["-o", str(tmp_path / "ref")])
        # without the flag the base maps as A, with a warning
        cli.main(args[:-1] + ["-o", str(tmp_path / "port"), "--device", "cpu"])
    else:
        cli.main(args + ["-o", str(tmp_path / "port"), "--device", "cpu"])
    ref_cli.main(args[:-1] + ["-o", str(tmp_path / "ref")])
    got = np.load(tmp_path / "port.npy")
    np.testing.assert_array_equal(got, np.load(tmp_path / "ref.npy"))
    kmers = util.get_kmer_hashes_from_chunk_sequence(
        [r.replace("X", "A").replace("N", "A") for r in reads], 21)
    np.testing.assert_array_equal(got, oracle.map_kmers_to_index(arrays, kmers))


def test_profile_dir_writes_a_trace(tmp_path, caplog):
    caplog.set_level(logging.INFO, logger=pipeline.__name__)
    rng = np.random.default_rng(2)
    reads = _reads(rng, 2500, 60)  # three CPU buffers
    fq, index, arrays, kmers = _fixture(tmp_path, rng, reads, 25)
    trace_dir = tmp_path / "trace"
    cli.main(["map", "-i", index, "-f", fq, "-k", "25", "-o", str(tmp_path / "out"),
              "--device", "cpu", "--profile-dir", str(trace_dir), "-c", "4096"])
    np.testing.assert_array_equal(np.load(tmp_path / "out.npy"),
                                  oracle.map_kmers_to_index(arrays, kmers))
    files = glob.glob(str(trace_dir / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    steps = [e for e in events if e.get("cat") == "user_annotation"
             and e.get("name") == "map_chunk"]
    chunks = [r.figures["chunks"] for r in caplog.records if hasattr(r, "figures")]
    assert chunks and len(steps) == chunks[-1] >= 2


def test_threads_debug_and_ignored_gpu_flags(tmp_path, root_log_level):
    """-t, -d, -g and -s are accepted; -t sets the framing workers; the
    counts equal the JAX CLI's with the same flags and the oracle's."""
    rng = np.random.default_rng(3)
    reads = _reads(rng, 500, 51, "ACGTN")
    fq, index, arrays, kmers = _fixture(tmp_path, rng, reads, 25)
    flags = ["-t", "3", "-d", "true", "-g", "true", "-s", "1000", "-c", "2048"]
    args = ["map", "-i", index, "-f", fq, "-k", "25", *flags]
    cli.main(args + ["-o", str(tmp_path / "port"), "--device", "cpu"])
    assert logging.getLogger().level == logging.DEBUG
    ref_cli.main(args + ["-o", str(tmp_path / "ref")])
    got = np.load(tmp_path / "port.npy")
    np.testing.assert_array_equal(got, np.load(tmp_path / "ref.npy"))
    np.testing.assert_array_equal(got, oracle.map_kmers_to_index(arrays, kmers))


def test_threads_set_workers_and_queue_depth(tmp_path, monkeypatch):
    seen = {}

    def fake_map_file(index, reads, **kw):
        seen.update(kw)
        return np.zeros(3, np.uint32)

    monkeypatch.setattr(pipeline, "map_file", fake_map_file)
    monkeypatch.setattr("os.cpu_count", lambda: 6)
    base = ["map", "-i", "x.npz", "-f", "r.fq", "-o", str(tmp_path / "o"), "--device", "cpu"]
    for t, workers, depth in (("1", 1, 2), ("4", 4, 4), ("16", 6, 16), ("40", 6, 16)):
        cli.main(base + ["-t", t])
        assert (seen["reader_workers"], seen["queue_depth"]) == (workers, depth)
    cli.main(base)  # the default -t 16
    assert (seen["reader_workers"], seen["queue_depth"]) == (6, 16)
    assert seen["strict_bases"] is False and seen["profile_dir"] is None


@pytest.mark.parametrize("revcomp", [False, True])
def test_map_sequences(tmp_path, revcomp):
    rng = np.random.default_rng(4)
    seqs = _reads(rng, 30, 70) + ["ACGT" * 5, "ACGTNACGTA" * 4]
    _, index, arrays, _ = _fixture(tmp_path, rng, seqs, 15)
    got = pipeline.map_sequences(index, seqs, k=15, device="cpu", revcomp=revcomp)
    ref = ref_pipeline.map_sequences(ref_ki.load_index(index), seqs, k=15, revcomp=revcomp)
    np.testing.assert_array_equal(got, ref)
    kmers = util.get_kmer_hashes_from_chunk_sequence([s.replace("N", "A") for s in seqs], 15)
    if revcomp:
        kmers = np.concatenate([kmers, oracle.revcomp_hash(kmers, 15)])
    np.testing.assert_array_equal(got, oracle.map_kmers_to_index(arrays, kmers))
    with pytest.raises(TypeError):
        pipeline.map_sequences(index, seqs, k=15)  # the device is not optional


def test_map_bnp(tmp_path):
    rng = np.random.default_rng(5)
    reads = _reads(rng, 200, 55)
    fq, index, arrays, kmers = _fixture(tmp_path, rng, reads, 21)
    expect = oracle.map_kmers_to_index(arrays, kmers)
    args = argparse.Namespace(kmer_index=index, index_bundle=None, reads=fq, kmer_size=21,
                              chunk_size=4096, max_hits_per_kmer=1000,
                              map_reverse_complements=False, output_file=None)
    got = command_line_interface.map_bnp(args, device="cpu")
    np.testing.assert_array_equal(got, expect)
    np.testing.assert_array_equal(got, ref_cli_functions.map_bnp(args))
    # an in-memory index, and an output file
    mem = argparse.Namespace(**{**vars(args), "kmer_index": arrays,
                                "output_file": str(tmp_path / "bnp")})
    assert command_line_interface.map_bnp(mem, device="cpu") is None
    np.testing.assert_array_equal(np.load(tmp_path / "bnp.npy"), expect)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            command_line_interface.map_bnp(args)  # cuda by default


def test_map_cpu(tmp_path):
    rng = np.random.default_rng(6)
    reads = _reads(rng, 50, 40, "ACGTN")
    _, index, arrays, _ = _fixture(tmp_path, rng, reads, 17)
    lengths = np.array([len(r) for r in reads])
    pair = (np.frombuffer("".join(reads).encode(), np.uint8), lengths)
    kmers = util.get_kmer_hashes_from_chunk_sequence([r.replace("N", "A") for r in reads], 17)
    expect = oracle.map_kmers_to_index(arrays, kmers)
    for chunk in (reads, pair):
        for args in ({"kmer_size": 17}, argparse.Namespace(kmer_size=17)):
            got = command_line_interface.map_cpu(args, index, chunk, device="cpu")
            np.testing.assert_array_equal(got, expect)
            np.testing.assert_array_equal(got, ref_cli_functions.map_cpu(args, index, chunk))


@pytest.mark.parametrize("revcomp", [False, True])
def test_map_gpu(tmp_path, revcomp):
    """The counter loop, over an index resolved from a path and over a
    counter-index-like object with ``_kmers`` / ``_nodes``."""
    rng = np.random.default_rng(7)
    reads = _reads(rng, 60, 50)
    _, index, arrays, _ = _fixture(tmp_path, rng, reads, 19)
    chunks = [reads[:30], types.SimpleNamespace(sequence=reads[30:])]
    counter_like = types.SimpleNamespace(_kmers=arrays.kmers, _nodes=arrays.nodes)
    for idx in (index, counter_like):
        got = command_line_interface.map_gpu(idx, chunks, 19,
                                             map_reverse_complements=revcomp, device="cpu")
        ref = ref_cli_functions.map_gpu(idx, chunks, 19, map_reverse_complements=revcomp)
        np.testing.assert_array_equal(got, ref)
    kmers = util.get_kmer_hashes_from_chunk_sequence(reads, 19)
    if revcomp:
        kmers = np.concatenate([kmers, oracle.revcomp_hash(kmers, 19)])
    unique = np.unique(arrays.kmers)
    expect = oracle.node_counts_from_kmer_counts(
        arrays.kmers, arrays.nodes, unique, oracle.count_unique_kmers(unique, kmers))
    n = min(len(got), len(expect))
    np.testing.assert_array_equal(got[:n], expect[:n])
    assert not got[n:].any() and not expect[n:].any()


def test_util(tmp_path, monkeypatch):
    rng = np.random.default_rng(8)
    reads = _reads(rng, 20, 33) + [b"ACGTACGTACGTACGTACGT"]
    for k in (5, 31):
        np.testing.assert_array_equal(util.get_kmer_hashes_from_chunk_sequence(reads, k),
                                      ref_util.get_kmer_hashes_from_chunk_sequence(reads, k))
    payload = b">a\nACGT\n" * 1000
    (tmp_path / "r.fa.gz").write_bytes(gzip.compress(payload))
    for module in (util, ref_util):
        stream = module.open_file(str(tmp_path / "r.fa.gz"))
        assert stream.read(1 << 20) == payload
        stream.close()
    _, index, arrays, _ = _fixture(tmp_path, rng, [r if isinstance(r, str) else r.decode()
                                                  for r in reads], 11)
    for args in (argparse.Namespace(kmer_index=arrays, index_bundle=None),
                 argparse.Namespace(kmer_index=index, index_bundle="ignored"),
                 argparse.Namespace(kmer_index=None, index_bundle=index)):
        got = util._get_kmer_index_from_args(args)
        assert isinstance(got, kmer_index.KmerIndex) and got.max_node_id == int(
            arrays.nodes.max())
    with pytest.raises(SystemExit):
        util._get_kmer_index_from_args(argparse.Namespace(kmer_index=None, index_bundle=None))


def test_encodings_match_jax():
    rng = np.random.default_rng(9)
    seq = rng.choice(np.frombuffer(b"ACGTacgt", np.uint8), 400)
    for cls in ("ACTGTwoBitEncoding", "SimpleEncoding"):
        port, ref = getattr(encodings, cls), getattr(ref_encodings, cls)
        packed = port.from_bytes(seq)
        np.testing.assert_array_equal(packed, ref.from_bytes(seq))
        np.testing.assert_array_equal(port.to_bytes(packed), ref.to_bytes(packed))
        assert port.to_string(packed) == ref.to_string(packed)
        np.testing.assert_array_equal(port.complement(packed), ref.complement(packed))
        np.testing.assert_array_equal(port.from_string("ACGTTGCA"), ref.from_string("ACGTTGCA"))
    words = rng.integers(0, 1 << 62, 50, dtype=np.uint64)
    np.testing.assert_array_equal(encodings.twobit_swap(words), ref_encodings.twobit_swap(words))
    assert encodings.BaseEncoding.to_string(encodings.BaseEncoding.from_string("ACGT")) == "ACGT"


def test_tools_match_jax(tmp_path):
    rng = np.random.default_rng(10)
    reads = _reads(rng, 50, 30)
    path = tmp_path / "r.fa"
    path.write_text("".join(f">r{i}\n{s}\n" for i, s in enumerate(reads)))
    assert list(tools.read_fasta(str(path))) == list(ref_tools.read_fasta(str(path)))
    n = tools.shuffle_fasta(str(path), str(tmp_path / "port.fa"), seed=3)
    assert n == ref_tools.shuffle_fasta(str(path), str(tmp_path / "ref.fa"), seed=3) == 50
    assert (tmp_path / "port.fa").read_text() == (tmp_path / "ref.fa").read_text()
    array = rng.integers(0, 5, (4, 6))
    np.testing.assert_array_equal(tools.remap_array(array, [0, 1, 2, 3, 4], [9, 8, 7, 6, 5]),
                                  ref_tools.remap_array(array, [0, 1, 2, 3, 4], [9, 8, 7, 6, 5]))


def test_timing(caplog):
    with caplog.at_level(logging.INFO, logger=timing.__name__):
        with timing.span("a step", logging.INFO):
            pass
        assert timing.log_memory_usage_now("here") > 0
    assert "a step took" in caplog.text and "Memory usage (here)" in caplog.text
