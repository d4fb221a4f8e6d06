"""The port's stage spans (``utils/profiling.py``) on the CPU: none is made
without a profiler; with one, a ``map_chunk`` holds its stages in order
inside the caller's region and its counts do not change; the ``map`` CLI's
trace holds a ``map_chunk`` region a chunk and a ``kmt.feed_wait`` region a
wait on the feed."""
import glob
import json
import logging

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile, record_function

from kmer_mapper_tpu_torch import cli, oracle, pipeline, util
from kmer_mapper_tpu_torch.index import kmer_index
from kmer_mapper_tpu_torch.io import readers
from kmer_mapper_tpu_torch.models.mapper import KmerMapper, MapperConfig
from kmer_mapper_tpu_torch.utils import profiling

K, READ_LEN = 31, 51
CONFIG = MapperConfig(k=K, buf=1 << 13, max_reads=256, read_len=READ_LEN)
CALLER = "caller"


def _chunk(strided: bool):
    """(oracle arrays, index, the one packed chunk of 100 reads, their
    k-mers): reads of READ_LEN bases (the plane step) or of 40-60 (the
    ragged step)."""
    rng = np.random.default_rng(7 + strided)
    lengths = [READ_LEN] * 100 if strided else rng.integers(40, 61, 100).tolist()
    reads = ["".join(rng.choice(list("ACGT"), n)) for n in lengths]
    kmers = util.get_kmer_hashes_from_chunk_sequence(reads, K)
    entries = np.concatenate([kmers[::5], rng.integers(0, 1 << 62, 50, dtype=np.uint64)
                              & np.uint64(4**K - 1)])
    arrays = oracle.build_kmer_index(entries, rng.integers(0, 40, len(entries)).astype(np.int32),
                                     997)
    flat = np.frombuffer("".join(reads).encode(), np.uint8).copy()
    starts = np.cumsum([0] + lengths[:-1]).astype(np.int64)
    chunks = list(readers.pack_for_device(iter([readers.SequenceChunk(flat, starts)]),
                                          CONFIG.buf, CONFIG.max_reads, K, read_len=READ_LEN))
    assert len(chunks) == 1 and chunks[0][5] == strided
    return arrays, kmer_index.KmerIndex.from_arrays(arrays), chunks[0], kmers


def _map(index, chunk) -> KmerMapper:
    packed, lengths, n_bases, _, n_invalid, strided = chunk
    mapper = KmerMapper(index, CONFIG, "cpu")
    mapper.map_chunk(packed, lengths, n_bases, n_invalid, strided=strided)
    return mapper


def _regions(path) -> list[tuple[str, float, float]]:
    """(name, start, end) of the trace's ``user_annotation`` regions, by start."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sorted(((e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"),
                  key=lambda r: r[1])


@pytest.mark.parametrize("strided", [True, False], ids=["plane", "ragged"])
def test_no_span_is_made_without_a_profiler(strided, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) made with no profiler recording")

    monkeypatch.setattr(profiling, "record_function", refuse)
    assert profiling.span(profiling.HASH) is profiling.span(profiling.COUNT)
    arrays, index, chunk, kmers = _chunk(strided)
    np.testing.assert_array_equal(_map(index, chunk).node_counts(),
                                  oracle.map_kmers_to_index(arrays, kmers))


@pytest.mark.parametrize("strided", [True, False], ids=["plane", "ragged"])
def test_a_step_holds_its_stages_in_order_inside_the_callers_region(strided, tmp_path):
    _, index, chunk, _ = _chunk(strided)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(CALLER):
            _map(index, chunk)
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    regions = _regions(tmp_path / "trace.json")
    (_, start, end), = [r for r in regions if r[0] == CALLER]
    stages = [r for r in regions if r[0].startswith("kmt.")]
    uploads = [profiling.UPLOAD] * (1 if strided else 2)
    assert [name for name, _, _ in stages] == uploads + [profiling.HASH, profiling.PARTITION,
                                                         profiling.COUNT]
    assert all(start <= a and b <= end for _, a, b in stages)
    assert all(b <= a_next for (_, _, b), (_, a_next, _) in zip(stages, stages[1:]))


@pytest.mark.parametrize("strided", [True, False], ids=["plane", "ragged"])
def test_the_profiler_changes_no_count(strided):
    arrays, index, chunk, kmers = _chunk(strided)
    with profile(activities=[ProfilerActivity.CPU]):
        traced = _map(index, chunk)
    np.testing.assert_array_equal(traced.node_counts(), _map(index, chunk).node_counts())
    np.testing.assert_array_equal(traced.node_counts(),
                                  oracle.map_kmers_to_index(arrays, kmers))
    assert traced.n_kmers_mapped == len(kmers)


def test_the_cli_trace_has_a_region_a_chunk_and_a_wait_a_feed_read(tmp_path, caplog):
    caplog.set_level(logging.INFO, logger=pipeline.__name__)
    rng = np.random.default_rng(3)
    reads = ["".join(rng.choice(list("ACGT"), 60)) for _ in range(2500)]  # three CPU buffers
    fq = tmp_path / "reads.fq"
    fq.write_text("".join(f"@r{i}\n{s}\n+\n{'I' * len(s)}\n" for i, s in enumerate(reads)))
    kmers = util.get_kmer_hashes_from_chunk_sequence(reads, 25)
    arrays = oracle.build_kmer_index(kmers[::3], np.arange(len(kmers[::3]), dtype=np.int32) % 90,
                                     2053)
    kmer_index.save_reference_npz(tmp_path / "index.npz", arrays)
    cli.main(["map", "-i", str(tmp_path / "index.npz"), "-f", str(fq), "-k", "25",
              "-o", str(tmp_path / "out"), "--device", "cpu",
              "--profile-dir", str(tmp_path / "trace"), "-c", "4096"])
    np.testing.assert_array_equal(np.load(tmp_path / "out.npy"),
                                  oracle.map_kmers_to_index(arrays, kmers))
    path, = glob.glob(str(tmp_path / "trace" / "*.pt.trace.json"))
    regions = _regions(path)
    chunks = [r.figures["chunks"] for r in caplog.records if hasattr(r, "figures")][-1]
    steps = [r for r in regions if r[0] == profiling.MAP_CHUNK]
    waits = [r for r in regions if r[0] == profiling.FEED_WAIT]
    assert chunks >= 2 and len(steps) == chunks and len(waits) == chunks + 1
    # each step follows a wait, and its stages lie inside it
    assert all(w[2] <= s[1] for w, s in zip(waits, steps))
    for name in (profiling.UPLOAD, profiling.HASH, profiling.PARTITION, profiling.COUNT):
        inside = [sum(s[1] <= r[1] and r[2] <= s[2] for r in regions if r[0] == name)
                  for s in steps]
        assert inside == [1] * chunks, name
